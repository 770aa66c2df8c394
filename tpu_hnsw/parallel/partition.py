"""Partitioned HNSW — the fork's defining capability.

The reference repo is a pgvector fork focused on *HNSW partitioning*
(SURVEY.md §1.2 L8; BASELINE.json:5,10,11): sharding one
logical index into per-partition sub-indexes with routed queries and a
global top-k merge. Here that is first-class:

- **hash partitioning** (config D): round-robin/hash assignment, queries
  fan out to every partition;
- **centroid partitioning** (config E): device k-means centroids
  (:mod:`.kmeans`, the IVFFlat-lineage router), vectors live with their
  nearest centroid, queries visit only the ``route_k`` nearest partitions;
- **merge**: per-partition top-k lists reduced by
  :func:`tpu_hnsw.ops.topk.kway_merge_topk` — on a device mesh the lists
  ride an ``all_gather`` between devices (``jax.shard_map``), the
  replacement of the reference's single-node shared-memory parallelism
  (SURVEY.md §2.3).

Two execution modes:

- *host-loop* (default, any device count): sub-indexes searched in
  sequence, merged on host — config D's one-chip many-partition mode;
- *mesh* (``sharded()``): sub-index state stacked along a leading
  partition axis, sharded over a ``Mesh``, one search per device under
  ``shard_map`` + collective merge — config E's multi-device mode.
"""

from __future__ import annotations

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpu_hnsw.config import HnswConfig, Metric, validate_ef_search
from tpu_hnsw.index import graph as G
from tpu_hnsw.index.hnsw import HnswIndex
from tpu_hnsw.index.search import _search_layer_body, _descend_body
from tpu_hnsw.ops import distance as D
from tpu_hnsw.ops import topk as T
from tpu_hnsw.parallel import kmeans as KM


def _dup_mask_np(ids: np.ndarray) -> np.ndarray:
    """[Q, w] bool: True where ids[q, j] repeats an EARLIER column —
    host-side twin of ops.topk.mask_duplicate_ids (replica dedup)."""
    w = ids.shape[1]
    eq = ids[:, :, None] == ids[:, None, :]
    earlier = np.tril(np.ones((w, w), bool), -1)
    return (eq & earlier[None] & (ids[:, :, None] >= 0)).any(-1)


def _stage_sharded(per_part: list, mesh: Mesh, axis: str) -> jax.Array:
    """Stack per-partition arrays into one array sharded over ``mesh``
    along a leading partition axis. Each device's partitions are stacked
    ON that device (partition i lives on mesh device i // local_p), so no
    card ever holds more than its own shards — stacking everything on one
    device first would put every shard's bytes on that card."""
    devs = list(mesh.devices.reshape(-1))
    local_p = len(per_part) // len(devs)
    locs = [
        jnp.stack([jax.device_put(a, dv)
                   for a in per_part[i * local_p:(i + 1) * local_p]])
        for i, dv in enumerate(devs)
    ]
    return jax.make_array_from_single_device_arrays(
        (len(per_part), *locs[0].shape[1:]),
        NamedSharding(mesh, P(axis)), locs)


class HashRouter:
    """Round-robin/hash assignment; queries broadcast to all partitions."""

    kind = "hash"

    def __init__(self, n_partitions: int):
        self.p = n_partitions

    def assign(self, data: np.ndarray, ids: np.ndarray) -> np.ndarray:
        return (ids % self.p).astype(np.int32)

    def route(self, queries: np.ndarray, route_k: int) -> np.ndarray:
        q = queries.shape[0]
        return np.tile(np.arange(self.p, dtype=np.int32), (q, 1))


class CentroidRouter:
    """k-means centroid assignment; queries visit the route_k nearest
    partitions (the IVFFlat ``probes`` analogue, upstream
    ``pgvector:src/ivfscan.c``)."""

    kind = "centroid"

    def __init__(self, n_partitions: int, centroids: np.ndarray | None = None):
        self.p = n_partitions
        self.centroids = centroids

    def fit(self, data: np.ndarray, seed: int = 0, iters: int = 10) -> np.ndarray:
        self.centroids, assign = KM.kmeans(data, self.p, iters=iters, seed=seed)
        return assign

    def assign(self, data: np.ndarray, ids: np.ndarray) -> np.ndarray:
        if self.centroids is None:
            return self.fit(data)
        c = jnp.asarray(self.centroids)
        x = jnp.asarray(data, jnp.float32)
        sc = D.pairwise_scores(x, c, Metric.L2)
        return np.asarray(jnp.argmin(sc, axis=1), np.int32)

    def route(self, queries: np.ndarray, route_k: int) -> np.ndarray:
        sc = D.pairwise_scores(
            jnp.asarray(queries, jnp.float32), jnp.asarray(self.centroids), Metric.L2
        )
        k = min(route_k or self.p, self.p)
        _, idx = T.topk_smallest(sc, k)
        return np.asarray(idx, np.int32)


class PartitionedHnswIndex:
    """P per-partition HNSW sub-indexes behind one logical index."""

    def __init__(
        self,
        config: HnswConfig,
        n_partitions: int,
        router: str = "hash",
        capacity: int | None = None,
        route_k: int = 0,  # 0 = search all partitions
        engine: str = "graph",  # per-partition index: "graph" (HnswIndex)
        # or "block" (BlockHnswIndex — the flagship serving engine; config
        # D's 10M-on-one-chip shape wants blocked level 0 per shard)
        block_size: int = 256,
        # Multi-assign boundary mitigation (centroid router only): the
        # ``multi_assign_frac`` fraction of rows with the SMALLEST gap
        # between their nearest and 2nd-nearest partition centroids is
        # ALSO stored in that 2nd partition — the IVF classic for the
        # routed-recall cliff (VERDICT r3 #4: route_k=2 recall 0.52
        # without it). A fraction budget, not a distance threshold: at
        # high dim, distance ratios concentrate near 1 (measured at 512d:
        # any ratio threshold grabs ~nothing or ~everything), while the
        # gap RANKING stays informative. Costs the replica fraction in
        # memory; merges dedup replica ids exactly (identical distances).
        multi_assign_frac: float = 0.0,
    ):
        if engine not in ("graph", "block"):
            raise ValueError("engine must be graph|block")
        self.cfg = config
        self.p = n_partitions
        self.route_k = route_k
        self.engine = engine
        self.block_size = block_size
        self.router = (
            HashRouter(n_partitions) if router == "hash" else CentroidRouter(n_partitions)
        )
        self.parts: list[HnswIndex] = []
        self.capacity = capacity
        self.multi_assign_frac = float(multi_assign_frac)
        # global id -> (secondary partition, local id there), -1 = none
        self._replica_part = np.zeros(0, np.int32)
        self._replica_local = np.zeros(0, np.int32)
        self.has_replicas = False
        # global id -> (partition, local id)
        self._part_of = np.zeros(0, np.int32)
        self._local_of = np.zeros(0, np.int32)
        self.n = 0
        # set by ShardedBlockSearcher.release_parts_device_state(): the
        # per-shard device arrays were dropped in favor of the stacked
        # serving state, so per-shard search/DML must fail loudly
        self._released = False

    def _check_live(self, op: str) -> None:
        if self._released:
            raise RuntimeError(
                f"PartitionedHnswIndex.{op}: per-shard device state was "
                "released (release_parts_device_state) in favor of the "
                "stacked ShardedBlockSearcher; use the searcher, or "
                "rebuild/reload the partitioned index for per-shard "
                "search and DML")

    def _part_rows(self, p: int) -> int:
        """Searchable rows in partition p (block engine: packed + tail)."""
        sub = self.parts[p]
        return sub.n + (getattr(sub, "tail_live", 0) if self.engine == "block"
                        else 0)

    # ----------------------------------------------------------------- build
    def build(self, data, mesh: Mesh | None = None) -> "PartitionedHnswIndex":
        """Build all partitions. With ``mesh`` given (or ``mesh="auto"``),
        shards build CONCURRENTLY — one per device — via the shard_map
        wave step (:mod:`.mesh_build`, SURVEY §1.3 L6 per-core shard
        build); otherwise shards build in sequence on the default device.
        """
        data = np.asarray(data, np.float32)
        n = data.shape[0]
        ids = np.arange(n)
        if isinstance(self.router, CentroidRouter) and self.router.centroids is None:
            assign = self.router.fit(data, seed=self.cfg.seed)
        else:
            assign = self.router.assign(data, ids)
        self._part_of = assign.copy()
        self._local_of = np.zeros(n, np.int32)
        self.parts = []
        if mesh == "auto":
            ndev = len(jax.devices())
            mesh = (
                jax.make_mesh((self.p,), ("shard",))
                if self.p <= ndev and self.p > 1 else None
            )
        replica = np.full(n, -1, np.int32)
        if (self.multi_assign_frac > 0
                and isinstance(self.router, CentroidRouter) and self.p > 1):
            cj = jnp.asarray(np.asarray(self.router.centroids, np.float32))
            second = np.zeros(n, np.int32)
            gap = np.zeros(n, np.float32)
            for s0 in range(0, n, 262144):
                xb = jnp.asarray(data[s0:s0 + 262144])
                sc = np.array(D.pairwise_scores(xb, cj, Metric.L2))
                rows = np.arange(sc.shape[0])
                a = assign[s0:s0 + 262144]
                d1 = sc[rows, a].copy()
                sc[rows, a] = np.inf
                s2 = sc.argmin(axis=1)
                second[s0:s0 + 262144] = s2
                gap[s0:s0 + 262144] = sc[rows, s2] - d1
            budget = int(min(self.multi_assign_frac, 1.0) * n)
            if budget:
                border = np.argpartition(gap, budget - 1)[:budget]
                replica[border] = second[border]
        self._replica_part = replica
        self._replica_local = np.full(n, -1, np.int32)
        self.has_replicas = bool((replica >= 0).any())
        part_rows = []
        for p in range(self.p):
            rows = np.where(assign == p)[0]
            self._local_of[rows] = np.arange(len(rows), dtype=np.int32)
            rep_rows = np.where(replica == p)[0]
            if rep_rows.size:
                self._replica_local[rep_rows] = (
                    len(rows) + np.arange(len(rep_rows))).astype(np.int32)
                rows = np.concatenate([rows, rep_rows])
            part_rows.append(rows)
        if self.engine == "block":
            from tpu_hnsw.index.block import BlockHnswIndex

            # blocked shards (host-loop serving; the mesh-stacked search
            # path is graph-engine only)
            for p, rows in enumerate(part_rows):
                sub = BlockHnswIndex(self.cfg, block_size=self.block_size)
                sub._global_ids = rows.astype(np.int32)
                if len(rows):
                    sub.build(data[rows])
                self.parts.append(sub)
            self.n = n
            return self
        if mesh is not None:
            from tpu_hnsw.parallel.mesh_build import build_partitions_mesh

            # the mesh path preps rows itself? No: HnswIndex._prep applies
            # normalization/validation — apply it here once
            prepped = HnswIndex(self.cfg)._prep(data)
            self.parts = build_partitions_mesh(
                self.cfg, [prepped[r] for r in part_rows], mesh
            )
            for p, rows in enumerate(part_rows):
                self.parts[p]._global_ids = rows.astype(np.int32)
        else:
            for p, rows in enumerate(part_rows):
                # size each shard for its actual load (+20% insert
                # headroom); centroid partitions can be heavily skewed
                per_cap = max(64, int(1.2 * len(rows)) + 64)
                sub = HnswIndex(self.cfg, capacity=per_cap)
                sub._global_ids = rows.astype(np.int32)  # local -> global
                if len(rows):
                    sub.build(data[rows])
                else:
                    # zero-row partition (k-means empty cluster / n < p):
                    # give it an empty graph so sharded()._assemble can
                    # stack it (ADVICE r1: sub.graph was None)
                    sub._ensure_graph(0)
                self.parts.append(sub)
        self.n = n
        return self

    # ---------------------------------------------------------------- search
    def search(self, queries, k: int = 10, ef_search: int = 40,
               route_k: int | None = None, descent_ef: int | None = None):
        """Routed per-partition search + global k-way top-k merge
        (host-loop mode). ``descent_ef`` (graph engine only) widens the
        per-shard upper-level descent beam — bulk-built shards have
        pure-kNN level-0 adjacency, so the default single-seed descent
        can strand whole basins (the recall ceiling measured in
        benchmarks/graph_tuning.json)."""
        self._check_live("search")
        validate_ef_search(max(ef_search, k))
        queries = np.asarray(queries, np.float32)
        route_k = self.route_k if route_k is None else route_k
        routes = self.router.route(queries, route_k)  # [Q, R]
        nq = queries.shape[0]
        r = routes.shape[1]
        sub_kw = {} if self.engine == "block" else {"descent_ef": descent_ef}
        all_d = np.full((nq, self.p, k), np.inf, np.float32)
        all_i = np.full((nq, self.p, k), -1, np.int64)
        for p in range(self.p):
            mask = (routes == p).any(axis=1)
            if not mask.any() or self._part_rows(p) == 0:
                continue
            d, ids = self.parts[p].search(queries[mask], k=k,
                                          ef_search=ef_search, **sub_kw)
            glob = np.where(ids >= 0, self.parts[p]._global_ids[np.clip(ids, 0, None)], -1)
            all_d[mask, p, :] = np.where(ids >= 0, d, np.inf)
            all_i[mask, p, :] = glob
        flat_d = all_d.reshape(nq, -1)
        flat_i = all_i.reshape(nq, -1)
        if self.has_replicas:
            flat_d = np.where(_dup_mask_np(flat_i), np.inf, flat_d)
        order = np.argsort(flat_d, axis=1)[:, :k]
        d_out = np.take_along_axis(flat_d, order, axis=1)
        i_out = np.take_along_axis(flat_i, order, axis=1)
        if self.has_replicas:
            i_out = np.where(np.isfinite(d_out), i_out, -1)
        return d_out, i_out

    def search_device(self, queries, k: int = 10, ef_search: int = 40,
                      probes: int | None = None,
                      descent_ef: int | None = None):
        """Device-side fan-out + merge for one-chip many-partition serving
        (config D: 8 hash partitions on one chip). Every partition is
        searched as back-to-back async dispatches and the k-way top-k
        merge happens ON DEVICE, so a batch costs one query upload and one
        result download regardless of P (the host-loop :meth:`search`
        pays a host round-trip per partition).

        Searches ALL partitions (exact for hash routing; for centroid
        routing this is the exhaustive upper bound — use :meth:`search`
        for routed subsets). Returns (distances, ids) device arrays;
        distances are operator units, which are ascending-comparable
        across partitions for every metric, so the merge is a plain
        top-k."""
        self._check_live("search_device")
        ds, gs = [], []
        for p, sub in enumerate(self.parts):
            if self._part_rows(p) == 0:
                continue
            kw = ({"probes": probes} if self.engine == "block"
                  else {"descent_ef": descent_ef})
            d, i = sub.search_device(queries, k=k, ef_search=ef_search, **kw)
            # device-resident id map, uploaded ONCE per shard instead of
            # once per batch
            gid = getattr(sub, "_global_ids_dev", None)
            if gid is None:
                gid = jnp.asarray(sub._global_ids.astype(np.int32))
                sub._global_ids_dev = gid
            gi = jnp.where(
                i >= 0, jnp.take(gid, jnp.clip(i, 0, None), mode="clip"), -1
            )
            ds.append(d)
            gs.append(gi)
        alld = jnp.concatenate(ds, axis=1)
        alli = jnp.concatenate(gs, axis=1)
        if self.has_replicas:
            alld = T.mask_duplicate_ids(alld, alli)
        vals, sel = T.topk_smallest(alld, k)
        ids = jnp.take_along_axis(alli, sel, axis=1)
        return vals, jnp.where(jnp.isfinite(vals), ids, -1)

    def search_iterative(self, queries, k: int = 10, ef_search: int = 40,
                         predicate=None, route_k: int | None = None,
                         max_route_k: int = 0):
        """Iterative scan across partitions (upstream iterative-scan
        analogue at the partition level, VERDICT r2 #8): when a filter
        rejects results, RESUME by widening BOTH the route set
        (``route_k`` doubles along the router's stable partition ranking)
        and the per-partition depth (``fetch`` doubles — a selective
        filter pushes the nearest *passing* rows below any fixed
        unfiltered rank, so breadth alone cannot recover them). Pending
        queries re-search their routed partitions at the deeper fetch
        each round; geometric doubling bounds total rework at ~2x the
        final round, the same bound the graph engine's
        ``search_resume`` re-expansion carries (index/hnsw.py).

        A filtered query is finalized only when its k passing results
        survive one further widening (the k-th passing distance
        routinely exceeds the next-ranked centroid distances, so the
        first satisfying round still misses nearer passing rows).
        Unfiltered scans keep single-round plain-search semantics.

        ``predicate(ids) -> bool mask`` runs host-side over global ids.
        Returns (distances, ids) with -1/inf padding when fewer than k
        pass."""
        self._check_live("search_iterative")
        validate_ef_search(max(ef_search, k))
        queries = np.asarray(queries, np.float32)
        nq = queries.shape[0]
        max_route_k = max_route_k or self.p
        max_route_k = min(max_route_k, self.p)
        r = route_k if route_k is not None else (self.route_k or 1)
        r = max(1, min(r, max_route_k))
        # full stable partition ranking per query (hash: all partitions)
        routes_full = self.router.route(queries, self.p)  # [Q, <=P]
        fetch = k if predicate is None else min(max(4 * k, 2 * k), 1000)
        max_fetch = min(1000, max(fetch,
                                  max(self._part_rows(p) for p in range(self.p))))
        out_d = np.full((nq, k), np.inf, np.float32)
        out_i = np.full((nq, k), -1, np.int64)
        done = np.zeros(nq, bool)
        confirmed = np.zeros(nq, bool)
        while True:
            acc_d = np.full((nq, self.p, fetch), np.inf, np.float32)
            acc_i = np.full((nq, self.p, fetch), -1, np.int64)
            cur_routes = routes_full[:, :r]  # [Q, r]
            for p in range(self.p):
                mask = (cur_routes == p).any(axis=1) & ~done
                if not mask.any() or self._part_rows(p) == 0:
                    continue
                kk = min(fetch, self._part_rows(p))
                d, ids = self.parts[p].search(
                    queries[mask], k=kk, ef_search=max(ef_search, kk)
                )
                glob = np.where(
                    ids >= 0,
                    self.parts[p]._global_ids[np.clip(ids, 0, None)], -1,
                )
                acc_d[mask, p, :kk] = np.where(ids >= 0, d, np.inf)
                acc_i[mask, p, :kk] = glob
            flat_d = acc_d.reshape(nq, -1)
            flat_i = acc_i.reshape(nq, -1)
            order = np.argsort(flat_d, axis=1)
            sd = np.take_along_axis(flat_d, order, axis=1)
            si = np.take_along_axis(flat_i, order, axis=1)
            mask = predicate(si) if predicate is not None else si >= 0
            mask &= si >= 0
            if self.has_replicas:
                mask &= ~_dup_mask_np(si)
            exhausted = (r >= min(max_route_k, routes_full.shape[1])
                         and fetch >= max_fetch)
            for qi in range(nq):
                if done[qi]:
                    continue
                good = np.where(mask[qi])[0][:k]
                if len(good) >= k and not exhausted and not confirmed[qi] \
                        and predicate is not None:
                    confirmed[qi] = True  # widen once more, then finalize
                    continue
                if len(good) >= k or exhausted:
                    out_d[qi, : len(good)] = sd[qi, good]
                    out_i[qi, : len(good)] = si[qi, good]
                    done[qi] = True
            if done.all() or exhausted:
                break
            r = min(2 * r, max_route_k)
            if predicate is not None:
                fetch = min(2 * fetch, max_fetch)
        return out_d, out_i

    # ------------------------------------------------------------------- dml
    def add(self, data) -> np.ndarray:
        """INSERT analogue for the partitioned index (upstream inserts into
        a partitioned table land in one partition's index): each row routes
        to its owning partition — hash: by global id; centroid: nearest
        centroid, the same rule as build — and is inserted into that
        sub-index (graph engine: wave insert; block engine: spill tail).
        Returns global ids."""
        self._check_live("add")
        if not self.parts:
            raise ValueError("build() the partitioned index before add()")
        data = np.asarray(data, np.float32)
        if data.ndim == 1:
            data = data[None, :]
        count = data.shape[0]
        gids = self.n + np.arange(count, dtype=np.int32)
        assign = np.asarray(self.router.assign(data, gids), np.int32)
        self._part_of = np.concatenate([self._part_of, assign])
        self._local_of = np.concatenate(
            [self._local_of, np.zeros(count, np.int32)]
        )
        for p in range(self.p):
            rows = np.where(assign == p)[0]
            if not rows.size:
                continue
            sub = self.parts[p]
            loc = np.asarray(sub.add(data[rows]), np.int64)
            # extend the local->global map (block-engine local ids can
            # reuse the id-space high-water mark after delete+compact, so
            # this is a grow-and-assign, not a pure append)
            gmap = np.asarray(sub._global_ids, np.int32)
            need = int(loc.max()) + 1
            if need > len(gmap):
                gmap = np.concatenate(
                    [gmap, np.full(need - len(gmap), -1, np.int32)]
                )
            gmap[loc] = gids[rows]
            sub._global_ids = gmap
            sub.__dict__.pop("_global_ids_dev", None)  # device copy is stale
            self._local_of[gids[rows]] = loc.astype(np.int32)
        self.n += count
        return gids

    def delete(self, ids) -> None:
        """DELETE analogue: tombstone global ids in their owning
        partitions (repair/reclaim at :meth:`compact`)."""
        self._check_live("delete")
        ids = np.asarray(ids, np.int64).reshape(-1)
        ids = ids[(ids >= 0) & (ids < len(self._part_of))]
        if not ids.size:
            return
        owners = self._part_of[ids]
        for p in np.unique(owners):
            self.parts[p].delete(self._local_of[ids[owners == p]])
            self.parts[p].__dict__.pop("_global_ids_dev", None)
        if self.has_replicas and len(self._replica_part):
            rid = ids[ids < len(self._replica_part)]
            rown = self._replica_part[rid]
            for p in np.unique(rown[rown >= 0]):
                self.parts[p].delete(self._replica_local[rid[rown == p]])
                self.parts[p].__dict__.pop("_global_ids_dev", None)

    def compact(self) -> None:
        """VACUUM analogue: repair (graph engine) / re-pack (block engine)
        every partition that has tombstones or spill-tail rows. Sub-index
        compaction preserves local ids, so the global-id maps stay valid.
        Fully-deleted partitions are left as-is (their tombstones mask
        every result) — there is no live row to re-anchor a repair on."""
        self._check_live("compact")
        for sub in self.parts:
            if self.engine == "block":
                live = sub.n + getattr(sub, "tail_live", 0)
                dead = (sub.n_total - sub.n) + (sub.tail_n - sub.tail_live)
                if live > 0 and (dead > 0 or sub.tail_n > 0):
                    sub.compact()
            else:
                if sub.n == 0 or sub.graph is None:
                    continue
                deleted = np.asarray(sub.graph.deleted[: sub.n])
                if deleted.any() and not deleted.all():
                    sub.compact()
            sub.__dict__.pop("_global_ids_dev", None)

    # ------------------------------------------------------------------ mesh
    def sharded(self, mesh: Mesh | None = None):
        """Mesh-parallel searcher: sub-index state stacked along a leading
        partition axis, sharded over the mesh, one search per device under
        ``shard_map`` + collective top-k merge (config E's mode). Returns a
        :class:`ShardedHnswSearcher` (graph engine) or
        :class:`ShardedBlockSearcher` (block engine)."""
        if self.engine == "block":
            return ShardedBlockSearcher(self, mesh)
        return ShardedHnswSearcher(self, mesh)

    # ----------------------------------------------------------- persistence
    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        for p, sub in enumerate(self.parts):
            sub.save(os.path.join(path, f"part{p}"))
            np.save(os.path.join(path, f"part{p}", "global_ids.npy"), sub._global_ids)
        meta = {
            "p": self.p,
            "router": self.router.kind,
            "route_k": self.route_k,
            "n": self.n,
            "engine": self.engine,
            "block_size": self.block_size,
            "multi_assign_frac": self.multi_assign_frac,
            "has_replicas": self.has_replicas,
        }
        with open(os.path.join(path, "partitioned.json"), "w") as f:
            json.dump(meta, f)
        np.savez(
            os.path.join(path, "router.npz"),
            centroids=(
                self.router.centroids
                if isinstance(self.router, CentroidRouter)
                else np.zeros(0)
            ),
            part_of=self._part_of,
            local_of=self._local_of,
            replica_part=self._replica_part,
            replica_local=self._replica_local,
        )

    @classmethod
    def load(cls, path: str) -> "PartitionedHnswIndex":
        with open(os.path.join(path, "partitioned.json")) as f:
            meta = json.load(f)
        engine = meta.get("engine", "graph")
        if engine == "block":
            from tpu_hnsw.index.block import BlockHnswIndex as Sub
        else:
            Sub = HnswIndex
        sub0 = Sub.load(os.path.join(path, "part0"))
        idx = cls(sub0.cfg, meta["p"], router=meta["router"],
                  route_k=meta["route_k"], engine=engine,
                  block_size=meta.get("block_size", 256))
        z = np.load(os.path.join(path, "router.npz"))
        if meta["router"] == "centroid":
            idx.router.centroids = z["centroids"]
        idx._part_of, idx._local_of = z["part_of"], z["local_of"]
        if "replica_part" in z:
            idx._replica_part = z["replica_part"]
            idx._replica_local = z["replica_local"]
        idx.multi_assign_frac = float(meta.get("multi_assign_frac", 0.0))
        idx.has_replicas = bool(meta.get("has_replicas", False))
        idx.n = meta["n"]
        idx.parts = []
        for p in range(meta["p"]):
            sub = Sub.load(os.path.join(path, f"part{p}"))
            sub._global_ids = np.load(os.path.join(path, f"part{p}", "global_ids.npy"))
            idx.parts.append(sub)
        return idx


class ShardedHnswSearcher:
    """Mesh-parallel partitioned search: one partition per device,
    ``shard_map`` + ``all_gather`` top-k merge (config E).

    Stacks every sub-index's device state along a leading partition axis
    and shards that axis over the mesh; queries are replicated. Each
    device runs the standard descent + level-0 beam on its local shard,
    maps local ids to global, then the per-shard top-k lists are
    all-gathered and reduced to the global top-k on every device.
    """

    AXIS = "shard"

    def __init__(self, parent: PartitionedHnswIndex, mesh: Mesh | None = None):
        self.parent = parent
        p = parent.p
        if mesh is None:
            ndev = min(p, len(jax.devices()))
            if p % ndev != 0:
                ndev = 1
            mesh = jax.make_mesh((ndev,), (self.AXIS,))
        if p % mesh.shape[self.AXIS] != 0:
            raise ValueError(
                f"n_partitions={p} must be a multiple of mesh size "
                f"{mesh.shape[self.AXIS]}"
            )
        self.mesh = mesh
        self._assemble()

    def _assemble(self):
        parts = self.parent.parts
        cap = max(sub.graph.cap for sub in parts)
        cap_u = max(sub.graph.cap_upper for sub in parts)
        cfg = self.parent.cfg

        def pad_graph(sub: HnswIndex) -> tuple:
            g = sub.graph
            pc = cap - g.cap
            pu = cap_u - g.cap_upper

            def pad_rows(a, extra, fill):
                if extra == 0:
                    return a
                return jnp.concatenate(
                    [a, jnp.full((extra, *a.shape[1:]), fill, a.dtype)], axis=0
                )

            # re-point sentinels from old cap to new cap
            nbr0 = jnp.where(g.neighbors0 == g.cap, cap, g.neighbors0)
            upn = jnp.where(g.upper_nbrs == g.cap, cap, g.upper_nbrs)
            ups = jnp.where(g.upper_slot == g.cap_upper, cap_u, g.upper_slot)
            gid = jnp.asarray(
                np.pad(sub._global_ids, (0, cap + 1 - len(sub._global_ids)),
                       constant_values=-1)
            )
            return (
                pad_rows(g.vectors, pc, 0),
                pad_rows(g.vectors_sq, pc, 0),
                pad_rows(nbr0, pc, cap),
                pad_rows(upn, pu, cap),
                pad_rows(ups, pc, cap_u),
                pad_rows(g.levels, pc, 0),
                pad_rows(g.deleted, pc, False),
                gid,
            )

        stacked = [pad_graph(s) for s in parts]
        arrays = [
            _stage_sharded([s[i] for s in stacked], self.mesh, self.AXIS)
            for i in range(8)
        ]
        shardings = NamedSharding(self.mesh, P(self.AXIS))
        (self.vectors, self.vectors_sq, self.nbr0, self.upn, self.ups,
         self.levels, self.deleted, self.gids) = arrays
        self.entries = jax.device_put(
            # clamp -1 (empty partition) to 0: its results are masked to
            # -1/inf downstream via the -1-padded global-id table anyway
            jnp.asarray([max(s.entry, 0) for s in parts], jnp.int32), shardings
        )
        self.entry_levels = jax.device_put(
            jnp.asarray([max(s.entry_level, 0) for s in parts], jnp.int32), shardings
        )
        if isinstance(self.parent.router, CentroidRouter):
            self.centroids = jnp.asarray(self.parent.router.centroids)
        else:
            self.centroids = None
        self._fn_cache = {}

    def _make_fn(self, k: int, ef: int, expand: int, max_steps: int,
                 route_k: int, merge: str = "all_gather",
                 descent_ef: int = 1):
        cfg = self.parent.cfg
        metric = cfg.metric
        p = self.parent.p
        mesh_n = self.mesh.shape[self.AXIS]
        local_p = p // mesh_n
        axis = self.AXIS
        dedup = getattr(self.parent, "has_replicas", False)

        def shard_body(vectors, vectors_sq, nbr0, upn, ups, levels, deleted,
                       gids, entries, entry_levels, queries, routes):
            # per-device: loop over its local partitions (usually 1)
            outs_d, outs_i = [], []
            my = jax.lax.axis_index(axis)
            for lp in range(local_p):
                g = G.HnswGraph(
                    vectors=vectors[lp], vectors_sq=vectors_sq[lp],
                    neighbors0=nbr0[lp], upper_nbrs=upn[lp],
                    upper_slot=ups[lp], levels=levels[lp], deleted=deleted[lp],
                )
                q = queries.astype(g.vectors.dtype)
                seeds = _descend_body(g, q, entries[lp], entry_levels[lp], 0,
                                      metric, descent_ef=descent_ef)
                pool_d, pool_i = _search_layer_body(
                    g, q, seeds, 0, level0=True, ef=ef, expand=expand,
                    max_steps=max_steps, metric=metric, skip_deleted=True,
                    mask_deleted_results=True,
                )
                d, i = pool_d[:, :k], pool_i[:, :k]
                glob = jnp.take(gids[lp], i, mode="clip")
                # routed-query masking: partitions not selected for a query
                # contribute +inf
                pid = my * local_p + lp
                selected = jnp.any(routes == pid, axis=1)  # [Q]
                d = jnp.where(selected[:, None], d, jnp.inf)
                glob = jnp.where(selected[:, None] & (i != g.cap), glob, -1)
                d = jnp.where(glob < 0, jnp.inf, d)
                outs_d.append(d)
                outs_i.append(glob)
            d = jnp.stack(outs_d, axis=1).reshape(queries.shape[0], local_p * k)
            i = jnp.stack(outs_i, axis=1).reshape(queries.shape[0], local_p * k)
            # global top-k merge across devices (all_gather or ppermute ring —
            # identical results; see parallel/collectives.py for the
            # bandwidth/latency trade)
            from tpu_hnsw.parallel import collectives as C

            if merge == "ring":
                return C.ring_merge_topk(d, i, k, axis, dedup=dedup)
            return C.gather_merge_topk(d, i, k, axis, dedup=dedup)

        spec_sh = P(self.AXIS)
        spec_rep = P()
        fn = jax.shard_map(
            shard_body,
            mesh=self.mesh,
            in_specs=(spec_sh,) * 10 + (spec_rep, spec_rep),
            out_specs=(spec_rep, spec_rep),
            check_vma=False,
        )
        return jax.jit(fn)

    def search(self, queries, k: int = 10, ef_search: int = 40,
               route_k: int | None = None, expand: int = 1,
               merge: str = "all_gather", descent_ef: int = 1):
        cfg = self.parent.cfg
        queries = np.asarray(queries, np.float32)
        route_k = self.parent.route_k if route_k is None else route_k
        # route with RAW queries: the router's centroids were fit on raw
        # data (build/assign), so routing must see the same geometry.
        # Routing normalized queries against raw-space centroids made the
        # route_k<P selection norm-driven — measured recall 0.62 vs 0.95
        # host-loop at route_k=2 on config-E-shaped data (the r3 config-E
        # "routing cliff" was THIS, not boundary physics).
        routes = self.parent.router.route(queries, route_k)
        if cfg.metric.needs_normalized:
            n = np.linalg.norm(queries, axis=1, keepdims=True)
            queries = queries / np.maximum(n, 1e-12)
        ef = max(ef_search, k)
        key = (k, ef, expand, routes.shape[1], merge, descent_ef)
        if key not in self._fn_cache:
            self._fn_cache[key] = self._make_fn(k, ef, expand, 2 * ef + 16,
                                                route_k, merge,
                                                descent_ef=descent_ef)
        fn = self._fn_cache[key]
        d, i = fn(self.vectors, self.vectors_sq, self.nbr0, self.upn, self.ups,
                  self.levels, self.deleted, self.gids, self.entries,
                  self.entry_levels, jnp.asarray(queries), jnp.asarray(routes))
        d = np.asarray(D.score_to_distance(d, cfg.metric))
        return d, np.asarray(i)


class ShardedBlockSearcher:
    """Mesh-parallel partitioned search over BLOCK-engine shards — the
    flagship serving engine at config-E scale (BASELINE.json:11, SURVEY
    §1.3 L8): per-shard cluster-blocked stores stacked along a leading
    partition axis and sharded over the mesh; each device routes queries
    to its shard's top-``probes`` blocks by exact centroid scan, expands
    them with the fused bf16-scan + exact-rerank program, maps local row
    ids to global, and the per-shard top-k lists are merged across devices
    (``all_gather`` or ``ppermute`` ring — parallel/collectives.py).

    The graph engine cannot fit config E's memory budget
    (~3.3kB/element vs the block engine's ~1.1kB at 512d); this class is
    what lets the one engine that fits ride ``shard_map``.

    Shards must have empty spill tails (``compact()`` folds them in);
    tails are per-shard mutable state that has no place in a replicated
    serving program.
    """

    AXIS = "shard"

    def __init__(self, parent: PartitionedHnswIndex, mesh: Mesh | None = None):
        from tpu_hnsw.index.block import BlockHnswIndex  # noqa: F401

        self.parent = parent
        p = parent.p
        if mesh is None:
            ndev = min(p, len(jax.devices()))
            if p % ndev != 0:
                ndev = 1
            mesh = jax.make_mesh((ndev,), (self.AXIS,))
        if p % mesh.shape[self.AXIS] != 0:
            raise ValueError(
                f"n_partitions={p} must be a multiple of mesh size "
                f"{mesh.shape[self.AXIS]}"
            )
        self.mesh = mesh
        self._assemble()

    def _assemble(self):
        parts = self.parent.parts
        for i, sub in enumerate(parts):
            if getattr(sub, "tail_n", 0):
                raise ValueError(
                    f"partition {i} has {sub.tail_n} un-compacted tail rows;"
                    " run compact() on every shard before sharding"
                )
        ref = next((s for s in parts if s.n_blocks), None)
        if ref is None:
            raise ValueError("every partition is empty")
        S = ref.block_size
        d = self.parent.cfg.dim
        dp = ref.blocks_score.shape[2]
        b_max = max(max(s.n_blocks for s in parts), 1)
        self.two_stage = bool(ref.two_stage)
        self.rerank_width = int(ref.rerank_width)
        dt = ref.blocks.dtype

        score_dt = ref.blocks_score.dtype
        # int8 scoring copies carry per-block dequant scales; shards all
        # share the env-selected dtype, so presence on ref decides
        self._has_scale = ref.score_scale is not None

        def pad_shard(sub) -> tuple:
            B = sub.n_blocks
            if B == 0:  # empty partition: one all-dead block
                return (
                    jnp.zeros((b_max, S, d), dt),
                    jnp.zeros((b_max, S, dp), score_dt),
                    jnp.zeros((b_max, S), jnp.float32),
                    jnp.full((b_max, S), -1, jnp.int32),
                    jnp.zeros((b_max, d), dt),
                    jnp.zeros((b_max,), jnp.float32),
                    jnp.ones((b_max,), jnp.float32),
                )
            pb = b_max - B

            def pad0(a, fill=0):
                if pb == 0:
                    return a
                return jnp.concatenate(
                    [a, jnp.full((pb, *a.shape[1:]), fill, a.dtype)], axis=0
                )

            # local slot ids -> GLOBAL ids, so the merged output needs no
            # per-shard remap (dead/pad slots stay -1)
            bi = np.asarray(sub.block_ids)
            gmap = np.asarray(sub._global_ids, np.int32)
            bg = np.where(bi >= 0, gmap[np.clip(bi, 0, None)], -1).astype(
                np.int32
            )
            return (
                pad0(sub.blocks),
                pad0(sub.blocks_score),
                pad0(sub.blocks_sq),
                pad0(jnp.asarray(bg), fill=-1),
                pad0(sub.centroids),
                pad0(sub.centroids_sq),
                pad0(sub.score_scale, fill=1.0)
                if sub.score_scale is not None
                else jnp.ones((b_max,), jnp.float32),
            )

        # bf16 storage with lane-aligned d: the per-shard scoring copy
        # ALIASES the blocks (_make_score_copy); stacking it separately
        # would double the dominant component (12.8GB at a 12.5M x 512d
        # config-E shard) — keep the alias in stacked form too
        alias_score = all(
            (s.blocks_score is s.blocks) for s in parts if s.n_blocks
        )
        stacked = [pad_shard(s) for s in parts]
        idxs = [0, 2, 3, 4, 5, 6] if alias_score else list(range(7))
        sh = NamedSharding(self.mesh, P(self.AXIS))
        out: dict[int, jax.Array] = {}
        for i in idxs:
            out[i] = _stage_sharded([s[i] for s in stacked], self.mesh,
                                    self.AXIS)
        if alias_score:
            out[1] = out[0]
        (self.blocks, self.blocks_score, self.blocks_sq, self.block_gids,
         self.centroids, self.centroids_sq, self.score_scales) = (
            out[i] for i in range(7))
        self._unstacked = None
        self.n_blocks = jax.device_put(
            jnp.asarray([s.n_blocks for s in parts], jnp.int32), sh
        )
        self._max_blocks = max(s.n_blocks for s in parts)
        self._fn_cache = {}
        # device-side routing state (see _routes_device): hash routes are
        # a per-batch-shape constant; centroid routes are one tiny jitted
        # top-k over the router's centroid table
        self._hash_routes_cache = {}
        self._router_centroids_dev = None
        self._route_dev_fns = {}

    @classmethod
    def from_saved(cls, path: str, mesh: Mesh | None = None,
                   chunk_bytes: int = 1 << 27) -> "ShardedBlockSearcher":
        """Build the stacked serving state STRAIGHT FROM DISK with
        bounded device memory — the production serving-load path.

        The in-memory route (``PartitionedHnswIndex.load(path).sharded()``)
        materializes every shard's device arrays AND the stacked copies
        before the per-shard state can be released — a ~2x HBM peak that
        makes a 12.5M x 512d bf16 config-E chip shard (~12.8GB serving)
        unloadable on a card whose memory holds one copy but not two.
        This path allocates the stacked
        arrays once, then streams each saved shard's blocks from disk in
        ``chunk_bytes`` host slabs; a donating device program installs
        each slab and computes its derived state (squared norms, int8
        scoring copy + scales or bf16 alias, centroids) in the same
        pass, so peak device memory = final serving bytes + one slab.

        The returned searcher's parent is a metadata-only skeleton
        (``_released`` from the start): serving, ``probes_for_ef``,
        ``stats`` and device-side routing work; per-shard search/DML
        need a full ``PartitionedHnswIndex.load``.
        """
        from tpu_hnsw.config import HnswConfig
        from tpu_hnsw.index.block import BlockHnswIndex

        with open(os.path.join(path, "partitioned.json")) as f:
            meta = json.load(f)
        if meta["engine"] != "block":
            raise ValueError("from_saved serves block-engine shards only")
        p = int(meta["p"])
        rz = np.load(os.path.join(path, "router.npz"))

        part_meta = []
        for i in range(p):
            with open(os.path.join(path, f"part{i}", "meta.json")) as f:
                part_meta.append(json.load(f))
        c = dict(part_meta[0]["config"])
        c["metric"] = Metric(c["metric"])
        cfg = HnswConfig(**c)
        S = int(part_meta[0]["block_size"])
        d = cfg.dim
        b_max = max(max(int(m["n_blocks"]) for m in part_meta), 1)
        dt = jnp.bfloat16 if cfg.dtype == "bfloat16" else jnp.float32
        score_dt = os.environ.get("TPU_HNSW_SCORE_DTYPE", "int8")
        dp = ((d + 127) // 128) * 128
        alias_score = (score_dt == "bf16" and dt == jnp.bfloat16 and dp == d)
        quant = not alias_score and score_dt == "int8"

        # slab geometry: pad the stacked B axis to a slab multiple so a
        # short final slab never overhangs (dynamic_update_slice CLAMPS
        # start indices — an overhanging slab would rewrite good rows
        # with its padding). Padded rows carry gid -1 and are masked by
        # n_blocks in routing.
        cb = max(1, min(chunk_bytes // max(S * d * 4, 1), b_max))
        b_pad = ((b_max + cb - 1) // cb) * cb

        # ---- parent skeleton (metadata only; marked released) ----
        parent = PartitionedHnswIndex(
            cfg, p, router=meta["router"], route_k=meta.get("route_k", 0),
            engine="block", block_size=S)
        if isinstance(parent.router, CentroidRouter):
            parent.router.centroids = rz["centroids"]
        parent.n = int(meta["n"])
        parent.multi_assign_frac = float(
            meta.get("multi_assign_frac", 0.0))
        parent.has_replicas = bool(meta.get("has_replicas", False))
        for i, m in enumerate(part_meta):
            stub = BlockHnswIndex(cfg, block_size=S)
            stub.n = int(m["n"])
            stub.n_total = int(m["n_total"])
            stub.n_blocks = int(m["n_blocks"])
            gid_p = os.path.join(path, f"part{i}", "global_ids.npy")
            stub._global_ids = (np.load(gid_p) if os.path.exists(gid_p)
                                else np.arange(stub.n_total, dtype=np.int32))
            parent.parts.append(stub)
        parent._released = True

        self = cls.__new__(cls)
        self.parent = parent
        if mesh is None:
            ndev = min(p, len(jax.devices()))
            if p % ndev != 0:
                ndev = 1
            mesh = jax.make_mesh((ndev,), (cls.AXIS,))
        if p % mesh.shape[cls.AXIS] != 0:
            raise ValueError(
                f"n_partitions={p} must be a multiple of mesh size "
                f"{mesh.shape[cls.AXIS]}")
        self.mesh = mesh
        sh = NamedSharding(mesh, P(cls.AXIS))
        devs = list(mesh.devices.reshape(-1))
        ndev = len(devs)
        local_p = p // ndev
        # a stacked table past 2^31 ELEMENTS (int32 linear indices; a
        # 12.5M x 512d bf16 table is 6.7e9) has failed to compile. On a
        # 1-device mesh keep the state as PER-PARTITION arrays (each
        # under the limit) served by the unstacked fused program (same
        # one-dispatch fan-out). Whether the GPU still needs this split
        # is ROADMAP 3.9.
        unstacked = ndev == 1 and (
            p * b_pad * S * d >= (1 << 31)
            or os.environ.get("TPU_HNSW_UNSTACKED") == "1")

        # per-DEVICE local targets, stream-installed with donation, then
        # stitched into the global sharded arrays ZERO-COPY via
        # jax.make_array_from_single_device_arrays (a cross-sharding
        # dynamic_update_slice is not expressible; per-device locals are)
        def zeros_on(dev, shape, dtype):
            return jax.device_put(jnp.zeros(shape, dtype), dev)

        def mk_targets(dv, lp_count):
            return {
                "blocks": zeros_on(dv, (lp_count, b_pad, S, d), dt),
                "sq": zeros_on(dv, (lp_count, b_pad, S), jnp.float32),
                "cents": zeros_on(dv, (lp_count, b_pad, d), jnp.float32),
                **({"scores": zeros_on(dv, (lp_count, b_pad, S, dp),
                                       jnp.int8),
                    "scales": zeros_on(dv, (lp_count, b_pad), jnp.float32)}
                   if quant else {}),
            }

        if unstacked:
            # one [1, b_pad, ...] target PER PARTITION (slicing a big
            # stacked array afterwards would copy it and double HBM)
            per_part = [mk_targets(devs[0], 1) for _ in range(p)]
            loc = None
        else:
            loc = {dv: mk_targets(dv, local_p) for dv in devs}

        def _derive(slab, live):
            sf = jnp.where(live[:, :, None], slab.astype(jnp.float32), 0.0)
            sq = jnp.sum(sf * sf, axis=-1)
            counts = jnp.maximum(live.sum(axis=1).astype(jnp.float32), 1.0)
            cent = jnp.sum(sf, axis=1) / counts[:, None]
            return sf, sq, cent

        @functools.partial(jax.jit, donate_argnums=(0, 1, 2))
        def install_plain(blocks, blocks_sq, cents, slab, live, pi, off):
            sf, sq, cent = _derive(slab, live)
            return (
                jax.lax.dynamic_update_slice(
                    blocks, sf.astype(dt)[None], (pi, off, 0, 0)),
                jax.lax.dynamic_update_slice(blocks_sq, sq[None],
                                             (pi, off, 0)),
                jax.lax.dynamic_update_slice(cents, cent[None],
                                             (pi, off, 0)),
            )

        @functools.partial(jax.jit, donate_argnums=(0, 1, 2, 3, 4))
        def install_quant(blocks, blocks_sq, cents, scores, scales, slab,
                          live, pi, off):
            sf, sq, cent = _derive(slab, live)
            absmax = jnp.max(jnp.abs(sf), axis=(1, 2))
            scl = jnp.maximum(absmax, 1e-30) / 127.0
            qk = jnp.clip(jnp.round(sf / scl[:, None, None]),
                          -127, 127).astype(jnp.int8)
            if dp != d:
                qk = jnp.pad(qk, ((0, 0), (0, 0), (0, dp - d)))
            return (
                jax.lax.dynamic_update_slice(
                    blocks, sf.astype(dt)[None], (pi, off, 0, 0)),
                jax.lax.dynamic_update_slice(blocks_sq, sq[None],
                                             (pi, off, 0)),
                jax.lax.dynamic_update_slice(cents, cent[None],
                                             (pi, off, 0)),
                jax.lax.dynamic_update_slice(scores, qk[None],
                                             (pi, off, 0, 0)),
                jax.lax.dynamic_update_slice(scales, scl[None], (pi, off)),
            )

        bg_host = np.full((p, b_pad, S), -1, np.int32)
        for i in range(p):
            dv = devs[i // local_p]
            li = per_part[i] if unstacked else loc[dv]
            pi_local = jnp.int32(0 if unstacked else i % local_p)
            z = np.load(os.path.join(path, f"part{i}", "blocks.npz"))
            bb = part_meta[i].get("blocks_bin")
            if bb is not None:
                # r5+ layout: raw-binary blob (native writer) — memmap
                # it so host memory stays one slab, never the full shard
                raw = np.memmap(
                    os.path.join(path, f"part{i}", "blocks.bin"),
                    dtype=np.dtype(bb["dtype"]), mode="r",
                    shape=tuple(bb["shape"]))
            else:  # pre-r5: blocks member inside the npz
                raw = z["blocks"]
            bids_host = z["block_ids"]
            gmap = parent.parts[i]._global_ids.astype(np.int32)
            B_i = raw.shape[0]
            if B_i:
                bg_host[i, :B_i] = np.where(
                    bids_host >= 0, gmap[np.clip(bids_host, 0, None)], -1)
            for s0 in range(0, B_i, cb):
                nb = min(cb, B_i - s0)
                slab_h = raw[s0:s0 + nb]
                live_h = bids_host[s0:s0 + nb] >= 0
                if nb < cb:  # pad: static slab shape -> one compile
                    slab_h = np.concatenate(
                        [slab_h, np.zeros((cb - nb, S, d), slab_h.dtype)])
                    live_h = np.concatenate(
                        [live_h, np.zeros((cb - nb, S), bool)])
                slab = jax.device_put(slab_h, dv)
                if slab.dtype == jnp.uint16:
                    slab = slab.view(jnp.bfloat16)
                live = jax.device_put(live_h, dv)
                if quant:
                    (li["blocks"], li["sq"], li["cents"], li["scores"],
                     li["scales"]) = install_quant(
                        li["blocks"], li["sq"], li["cents"], li["scores"],
                        li["scales"], slab, live, pi_local, jnp.int32(s0))
                else:
                    li["blocks"], li["sq"], li["cents"] = install_plain(
                        li["blocks"], li["sq"], li["cents"], slab, live,
                        pi_local, jnp.int32(s0))

        # centroids: store cast to the block dtype, norms from f32 (the
        # same split _install_blocks uses, so results match in-memory)
        cast = jax.jit(lambda a: a.astype(dt))
        sqsum = jax.jit(lambda a: jnp.sum(a * a, axis=-1))
        for li in (per_part if unstacked else [loc[dv] for dv in devs]):
            li["cents_dt"] = cast(li["cents"])
            li["c_sq"] = sqsum(li["cents"])
            del li["cents"]

        if unstacked:
            self._unstacked = []
            for lp in range(p):
                li = per_part[lp]
                # NOTE: in bf16-alias mode "scores" is OMITTED (not a
                # second pytree leaf of the same buffer) — the serving
                # body falls back to ent["blocks"]; one device buffer is
                # never passed as two execute operands
                ent = {
                    "blocks": li["blocks"],       # [1, b_pad, S, d]
                    "sq": li["sq"],
                    "cents": li["cents_dt"],
                    "c_sq": li["c_sq"],
                    "gids": jax.device_put(bg_host[lp:lp + 1], devs[0]),
                    "nb": jnp.int32(int(part_meta[lp]["n_blocks"])),
                    "scales": li.get("scales"),
                }
                if "scores" in li:
                    ent["scores"] = li["scores"]
                self._unstacked.append(ent)
            jax.block_until_ready([e["blocks"] for e in self._unstacked])
            self.blocks = self.blocks_score = self.blocks_sq = None
            self.block_gids = self.centroids = self.centroids_sq = None
            self.score_scales = None
            self.n_blocks = None
            self._has_scale = quant
            self._max_blocks = b_max
            self.two_stage = True
            self.rerank_width = BlockHnswIndex(cfg,
                                               block_size=S).rerank_width
            self._fn_cache = {}
            self._hash_routes_cache = {}
            self._router_centroids_dev = None
            self._route_dev_fns = {}
            return self
        self._unstacked = None
        jax.block_until_ready([loc[dv]["blocks"] for dv in devs])

        def stitch(name, shape, dtype):
            return jax.make_array_from_single_device_arrays(
                (p, *shape),
                NamedSharding(mesh, P(cls.AXIS)),
                [loc[dv][name] for dv in devs],
            )

        self.blocks = stitch("blocks", (b_pad, S, d), dt)
        self.blocks_sq = stitch("sq", (b_pad, S), jnp.float32)
        self.centroids = stitch("cents_dt", (b_pad, d), dt)
        self.centroids_sq = stitch("c_sq", (b_pad,), jnp.float32)
        if quant:
            self.blocks_score = stitch("scores", (b_pad, S, dp), jnp.int8)
            self.score_scales = stitch("scales", (b_pad,), jnp.float32)
            self._has_scale = True
        else:
            # bf16 storage, lane-aligned: the scoring copy IS the blocks
            self.blocks_score = self.blocks
            self.score_scales = jax.device_put(
                np.ones((p, b_pad), np.float32), sh)
            self._has_scale = False
        self.block_gids = jax.device_put(bg_host, sh)
        self.n_blocks = jax.device_put(
            jnp.asarray([int(m["n_blocks"]) for m in part_meta], jnp.int32),
            sh)
        self._max_blocks = b_max
        self.two_stage = True
        self.rerank_width = BlockHnswIndex(cfg, block_size=S).rerank_width
        self._fn_cache = {}
        self._hash_routes_cache = {}
        self._router_centroids_dev = None
        self._route_dev_fns = {}
        return self

    def release_parts_device_state(self) -> None:
        """Drop the per-shard device arrays once the stacked serving state
        exists — they are the same bytes twice. One-chip many-partition
        serving (config D: 10M rows as 8 stacked shards) cannot afford
        both copies in HBM. The parent index keeps its host-side metadata
        (global-id maps, counts); its per-shard ``search``/DML entry
        points raise a clear error afterwards (``_released`` flag) until
        the shards are rebuilt or reloaded — ADVICE r3 found the silent
        AttributeError/TypeError this used to produce."""
        for sub in self.parent.parts:
            for name in ("blocks", "blocks_score", "blocks_sq", "block_ids",
                         "centroids", "centroids_sq", "score_scale",
                         "_flat_exact", "tail", "tail_sq", "tail_ids"):
                if hasattr(sub, name):
                    setattr(sub, name, None)
        self.parent._released = True

    def _routes_device(self, qj, route_k):
        """[Q, R] int32 route table computed WITHOUT leaving the device.

        The host-side router path costs a query download plus a routes
        upload per batch, a host round trip inside every search. Hash
        routing does not
        depend on query values (every partition is selected), so it is a
        cached per-shape constant; centroid routing is one [Q, P] matmul
        + top-k, jitted and cached per (Q, route_k)."""
        p = self.parent.p
        router = self.parent.router
        if isinstance(router, CentroidRouter):
            r = min(route_k or p, p)
            if self._router_centroids_dev is None:
                self._router_centroids_dev = jnp.asarray(
                    np.asarray(router.centroids, np.float32))
            key = (qj.shape[0], r)
            fn = self._route_dev_fns.get(key)
            if fn is None:
                def route_fn(q, cents):
                    sc = D.pairwise_scores(q, cents, Metric.L2)
                    return T.topk_smallest(sc, r)[1].astype(jnp.int32)

                fn = jax.jit(route_fn)
                self._route_dev_fns[key] = fn
            return fn(qj, self._router_centroids_dev)
        key = (qj.shape[0], p)
        routes = self._hash_routes_cache.get(key)
        if routes is None:
            routes = jax.block_until_ready(jnp.tile(
                jnp.arange(p, dtype=jnp.int32), (qj.shape[0], 1)))
            self._hash_routes_cache[key] = routes
        return routes

    def probes_for_ef(self, ef_search: int) -> int:
        """Per-shard probe count for an ef (same ROWS_PER_EF-budget
        mapping as the host-loop engine; clamping to each shard's
        n_blocks happens on device via padded-block masking)."""
        import math as _math

        ref = next(s for s in self.parent.parts if s.n_blocks)
        p = _math.ceil(ref.ROWS_PER_EF * ef_search / ref.block_size)
        p += int((ref.block_slack - 1) * p + 0.5)
        # host-cached max (an eager device reduce would sync every call)
        return max(1, min(p, self._max_blocks))

    def _make_fn(self, k: int, probes: int, rerank: int, route_width: int,
                 merge: str):
        from tpu_hnsw.index.block import (
            BlockHnswIndex,
            _expand_blocks_2stage_body,
            _expand_blocks_body,
            _route_exact_body,
            _scan_all_body,
        )
        from tpu_hnsw.parallel import collectives as C

        cfg = self.parent.cfg
        metric = cfg.metric
        p = self.parent.p
        local_p = p // self.mesh.shape[self.AXIS]
        axis = self.AXIS
        two_stage = self.two_stage
        has_scale = self._has_scale
        dedup = getattr(self.parent, "has_replicas", False)
        # exhaustive probes on big shards stream each shard once, as
        # BlockHnswIndex.search_device does: the per-query gather would
        # materialize Q x shard bytes
        exhaustive = BlockHnswIndex.exhaustive(probes, self._max_blocks)

        def shard_body(blocks, blocks_score, blocks_sq, bgids, cents, c_sq,
                       nb, scales, queries, routes):
            my = jax.lax.axis_index(axis)
            q = queries.astype(jnp.float32)
            q_sq = D.squared_norms(q)
            outs_d, outs_i = [], []
            for lp in range(local_p):
                if exhaustive:
                    with jax.named_scope("scan_all"):
                        sc, ids = _scan_all_body(
                            blocks[lp], blocks_score[lp], blocks_sq[lp],
                            bgids[lp], has_scale, q, k=k, rerank=rerank,
                            metric=metric,
                        )
                else:
                    with jax.named_scope("route"):
                        bids = _route_exact_body(
                            cents[lp], c_sq[lp], q, q_sq, nb[lp], p=probes,
                            metric=metric,
                        )
                    with jax.named_scope("expand"):
                        if two_stage:
                            sc, ids = _expand_blocks_2stage_body(
                                blocks_score[lp], blocks_sq[lp], bgids[lp],
                                blocks[lp].reshape(-1, blocks.shape[-1]),
                                q, q_sq, bids, k=k, rerank=rerank,
                                metric=metric,
                                score_scale=(scales[lp] if has_scale
                                             else None),
                            )
                        else:
                            sc, ids = _expand_blocks_body(
                                blocks[lp], blocks_sq[lp], bgids[lp], q,
                                q_sq, bids, k=k, metric=metric,
                            )
                # routed-query masking: a partition not selected for a
                # query contributes +inf/-1
                pid = my * local_p + lp
                selected = jnp.any(routes == pid, axis=1)
                sc = jnp.where(selected[:, None] & (ids >= 0), sc, jnp.inf)
                ids = jnp.where(jnp.isfinite(sc), ids, -1)
                outs_d.append(sc)
                outs_i.append(ids)
            dloc = jnp.concatenate(outs_d, axis=1)
            iloc = jnp.concatenate(outs_i, axis=1)
            with jax.named_scope("ici_merge"):
                if merge == "ring":
                    return C.ring_merge_topk(dloc, iloc, k, axis,
                                             dedup=dedup)
                return C.gather_merge_topk(dloc, iloc, k, axis, dedup=dedup)

        spec_sh = P(self.AXIS)
        spec_rep = P()
        fn = jax.shard_map(
            shard_body,
            mesh=self.mesh,
            in_specs=(spec_sh,) * 8 + (spec_rep, spec_rep),
            out_specs=(spec_rep, spec_rep),
            check_vma=False,
        )
        return jax.jit(fn)

    def _make_fn_unstacked(self, k: int, probes: int, rerank: int,
                           route_width: int):
        """Fused one-dispatch fan-out over PER-PARTITION arrays — the
        1-device serving program for tables past XLA's 2^31-element
        single-buffer limit (see from_saved). Same math as the stacked
        shard_map body; the "merge" is a local concat+top-k (one
        device holds every partition)."""
        from tpu_hnsw.index.block import (
            _expand_blocks_2stage_body,
            _route_exact_body,
        )

        cfg = self.parent.cfg
        metric = cfg.metric
        d = cfg.dim
        dedup = getattr(self.parent, "has_replicas", False)

        def body(parts, queries, routes):
            q = queries.astype(jnp.float32)
            q_sq = D.squared_norms(q)
            outs_d, outs_i = [], []
            for pid, ent in enumerate(parts):
                bids = _route_exact_body(
                    ent["cents"][0], ent["c_sq"][0], q, q_sq, ent["nb"],
                    p=probes, metric=metric)
                score_src = ent.get("scores", ent["blocks"])
                sc, ids = _expand_blocks_2stage_body(
                    score_src[0], ent["sq"][0], ent["gids"][0],
                    ent["blocks"][0].reshape(-1, d), q, q_sq, bids,
                    k=k, rerank=rerank, metric=metric,
                    score_scale=(None if ent["scales"] is None
                                 else ent["scales"][0]))
                selected = jnp.any(routes == pid, axis=1)
                sc = jnp.where(selected[:, None] & (ids >= 0), sc, jnp.inf)
                ids = jnp.where(jnp.isfinite(sc), ids, -1)
                outs_d.append(sc)
                outs_i.append(ids)
            dloc = jnp.concatenate(outs_d, axis=1)
            iloc = jnp.concatenate(outs_i, axis=1)
            if dedup:
                dloc = T.mask_duplicate_ids(dloc, iloc)
            vals, sel = T.topk_smallest(dloc, k)
            ids = jnp.take_along_axis(iloc, sel, axis=1)
            return vals, jnp.where(jnp.isfinite(vals), ids, -1)

        return jax.jit(body)

    def search_device(self, queries, k: int = 10, ef_search: int = 40,
                      probes: int | None = None, route_k: int | None = None,
                      merge: str = "all_gather"):
        """Async mesh search. Returns (scores, global ids) device arrays
        (raw score units; missing ids are -1)."""
        validate_ef_search(max(ef_search, 1))
        cfg = self.parent.cfg
        if probes is None:
            probes = self.probes_for_ef(max(ef_search, k))
        route_k = self.parent.route_k if route_k is None else route_k
        if isinstance(queries, jax.Array) and queries.ndim == 2:
            # device-resident serving batch: routing stays on device too
            # (a host round-trip per batch costs more than the search).
            # Route with the RAW queries — the router's centroids live in
            # raw space (see ShardedHnswSearcher.search for the measured
            # recall cliff this prevents); normalize only for scoring.
            qraw = queries.astype(jnp.float32)
            routes = self._routes_device(qraw, route_k)
            qj = (D.l2_normalize(qraw) if cfg.metric.needs_normalized
                  else qraw)
        else:
            qh = np.asarray(queries, np.float32)
            routes = jnp.asarray(self.parent.router.route(qh, route_k))
            if cfg.metric.needs_normalized:
                nrm = np.linalg.norm(qh, axis=1, keepdims=True)
                qh = qh / np.maximum(nrm, 1e-12)
            qj = jnp.asarray(qh)
        if getattr(self, "_unstacked", None) is not None:
            key = ("u", k, probes, routes.shape[1])
            if key not in self._fn_cache:
                self._fn_cache[key] = self._make_fn_unstacked(
                    k, probes, max(self.rerank_width, k), routes.shape[1])
            return self._fn_cache[key](self._unstacked, qj, routes)
        key = (k, probes, routes.shape[1], merge)
        if key not in self._fn_cache:
            self._fn_cache[key] = self._make_fn(
                k, probes, max(self.rerank_width, k), routes.shape[1], merge
            )
        fn = self._fn_cache[key]
        return fn(self.blocks, self.blocks_score, self.blocks_sq,
                  self.block_gids, self.centroids, self.centroids_sq,
                  self.n_blocks, self.score_scales, qj, routes)

    def search(self, queries, k: int = 10, ef_search: int = 40,
               probes: int | None = None, route_k: int | None = None,
               merge: str = "all_gather"):
        """Routed mesh search + collective merge. Returns (distances in operator
        units, global ids) numpy arrays."""
        sc, ids = self.search_device(queries, k=k, ef_search=ef_search,
                                     probes=probes, route_k=route_k,
                                     merge=merge)
        d = np.asarray(D.score_to_distance(sc, self.parent.cfg.metric))
        return d, np.asarray(ids)

    def stats(self) -> dict:
        if getattr(self, "_unstacked", None) is not None:
            comp = {}
            for ent in self._unstacked:
                for nm, key2 in (("blocks", "blocks"), ("blocks_score",
                                 "scores"), ("blocks_sq", "sq"),
                                 ("block_gids", "gids"),
                                 ("centroids", "cents"),
                                 ("centroids_sq", "c_sq")):
                    a = ent.get(key2)
                    nb = 0 if a is None else a.nbytes
                    comp[nm] = comp.get(nm, 0) + nb
        else:
            comp = {
                name: getattr(self, name).nbytes
                for name in ("blocks", "blocks_score", "blocks_sq",
                             "block_gids", "centroids", "centroids_sq")
            }
            if self.blocks_score is self.blocks:  # bf16 alias: one buffer
                comp["blocks_score"] = 0
        total = sum(comp.values())
        n = self.parent.n
        return {
            "n": n,
            "partitions": self.parent.p,
            "mesh_devices": self.mesh.shape[self.AXIS],
            "memory_bytes": comp,
            "memory_total_bytes": total,
            "bytes_per_element": round(total / max(n, 1), 1),
            "bytes_per_element_per_device": round(
                total / self.mesh.shape[self.AXIS] / max(
                    n / self.parent.p, 1), 1
            ),
        }
