"""HnswIndex — the index access-method API.

The Python surface replacing the reference's AM callbacks (upstream
``pgvector:src/hnsw.c`` handler: ``hnswbuild`` -> :meth:`HnswIndex.build`,
``hnswinsert`` -> :meth:`HnswIndex.add`, ``hnswgettuple``/``hnswscan`` ->
:meth:`HnswIndex.search`, ``hnswbulkdelete`` -> :meth:`HnswIndex.delete`,
metapage -> the host-side scalars here; SURVEY.md §1.3 L5).

All device state lives in an :class:`~tpu_hnsw.index.graph.HnswGraph`;
this class holds host scalars (count, entry point, PRNG) and drives the
jit-compiled wave/search steps.
"""

from __future__ import annotations

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np

from tpu_hnsw.config import HnswConfig, Metric, validate_ef_search
from tpu_hnsw.index import build as B
from tpu_hnsw.index import graph as G
from tpu_hnsw.index import search as SE
from tpu_hnsw.ops import distance as D

import functools


@functools.partial(jax.jit, static_argnames=("cap", "size"))
def _upper_ids_jit(levels, cap: int, size: int):
    """ids of level>=1 elements, sentinel-padded to ``size`` (sorted
    ascending; the dense-scan routing subset — see search.py::scan_seeds)."""
    return jnp.nonzero(levels[:cap] >= 1, size=size,
                       fill_value=cap)[0].astype(jnp.int32)


class HnswIndex:
    def __init__(self, config: HnswConfig, capacity: int | None = None):
        self.cfg = config
        self.capacity = int(capacity or config.max_elements or 0)
        self.graph: G.HnswGraph | None = None
        self.n = 0
        self.n_upper = 0
        self.entry = -1
        self.entry_level = -1
        self._rng = np.random.default_rng(config.seed)
        self._levels_host: list[int] = []

    # ------------------------------------------------------------------ util
    @property
    def size(self) -> int:
        return self.n

    def stats(self) -> dict:
        """Index observability (EXPLAIN/pg_stat analogue, SURVEY.md §5):
        memory per component, bytes/element, degree and level stats."""
        g = self.graph
        if g is None:
            return {"n": 0}
        comp = {
            "vectors": g.vectors.nbytes,
            "vectors_sq": g.vectors_sq.nbytes,
            "neighbors0": g.neighbors0.nbytes,
            "upper_nbrs": g.upper_nbrs.nbytes,
            "upper_slot": g.upper_slot.nbytes,
            "levels": g.levels.nbytes,
            "deleted": g.deleted.nbytes,
        }
        total = sum(comp.values())
        nbr0 = np.asarray(g.neighbors0[: self.n])
        deg = (nbr0 != g.sentinel).sum(1)
        levels = np.asarray(g.levels[: self.n])
        return {
            "n": self.n,
            "capacity": self.capacity,
            "dim": self.cfg.dim,
            "dtype": self.cfg.dtype,
            "entry": self.entry,
            "entry_level": self.entry_level,
            "n_deleted": int(np.asarray(g.deleted[: self.n]).sum()),
            "memory_bytes": comp,
            "memory_total_bytes": total,
            "bytes_per_element": round(total / max(self.n, 1), 1),
            "degree_mean": float(deg.mean()) if self.n else 0.0,
            "degree_min": int(deg.min()) if self.n else 0,
            "level_counts": np.bincount(levels).tolist() if self.n else [],
        }

    def _ensure_graph(self, needed: int):
        if self.graph is None:
            if self.capacity == 0:
                self.capacity = max(needed, 1024)
            self.graph = G.init_graph(self.cfg, self.capacity)
        if self.n + needed > self.capacity:
            # upstream INSERTs never fail on index capacity (Postgres
            # appends pages); flat arrays grow geometrically instead. An
            # explicit ``max_elements`` reloption stays a hard cap.
            hard = int(self.cfg.max_elements or 0)
            if hard and self.n + needed > hard:
                raise ValueError(
                    f"index max_elements {hard} exceeded "
                    f"(have {self.n}, adding {needed})"
                )
            self.grow(max(2 * self.capacity, self.n + needed))

    def grow(self, new_capacity: int) -> None:
        """Re-allocate device arrays for a larger capacity (the page-append
        analogue of upstream index growth). All live rows, adjacency, and
        tombstones are preserved; sentinel ids — which equal the old
        capacity by the trash-row convention (index/graph.py) — are
        re-pointed to the new capacity."""
        new_capacity = int(new_capacity)
        if self.graph is None:
            self.capacity = max(self.capacity, new_capacity)
            return
        g = self.graph
        old_cap, old_cap_u = g.cap, g.cap_upper
        if new_capacity <= old_cap:
            return
        fresh = G.init_graph(self.cfg, new_capacity)
        sent_new = jnp.int32(new_capacity)
        nbr0 = jnp.where(g.neighbors0 == old_cap, sent_new, g.neighbors0)
        upn = jnp.where(g.upper_nbrs == old_cap, sent_new, g.upper_nbrs)
        ups = jnp.where(
            g.upper_slot == old_cap_u, jnp.int32(fresh.cap_upper), g.upper_slot
        )
        self.graph = fresh._replace(
            vectors=fresh.vectors.at[:old_cap].set(g.vectors[:old_cap]),
            vectors_sq=fresh.vectors_sq.at[:old_cap].set(g.vectors_sq[:old_cap]),
            neighbors0=fresh.neighbors0.at[:old_cap].set(nbr0[:old_cap]),
            upper_nbrs=fresh.upper_nbrs.at[:old_cap_u].set(upn[:old_cap_u]),
            upper_slot=fresh.upper_slot.at[:old_cap].set(ups[:old_cap]),
            levels=fresh.levels.at[:old_cap].set(g.levels[:old_cap]),
            deleted=fresh.deleted.at[:old_cap].set(g.deleted[:old_cap]),
        )
        self.capacity = new_capacity

    def _draw_levels(self, count: int) -> np.ndarray:
        """Geometric level assignment, upstream HnswInitElement:
        level = floor(-ln(U) * ml)."""
        u = np.maximum(self._rng.random(count), 1e-12)
        lv = np.minimum(
            (-np.log(u) * self.cfg.ml).astype(np.int64), self.cfg.max_level
        )
        return lv.astype(np.int32)

    def _prep(self, data) -> np.ndarray:
        x = np.asarray(data, dtype=np.float32)
        if x.ndim == 1:
            x = x[None, :]
        if x.shape[1] != self.cfg.dim:
            # upstream: "expected N dimensions, not M"
            raise ValueError(
                f"expected {self.cfg.dim} dimensions, not {x.shape[1]}"
            )
        if not np.isfinite(x).all():
            # upstream vector_in rejects NaN and infinity values
            raise ValueError("NaN or infinity values are not allowed")
        if self.cfg.metric.needs_normalized:
            n = np.linalg.norm(x, axis=1, keepdims=True)
            x = x / np.maximum(n, 1e-12)
        return x

    # ----------------------------------------------------------------- build
    # datasets at least this large use the dense bulk path by default
    BULK_THRESHOLD = 20_000

    def build(self, data, mode: str = "auto") -> "HnswIndex":
        """CREATE INDEX analogue: build over a dataset.

        mode: "auto" (bulk cluster build for large initial loads, waves
        otherwise), "bulk", or "wave". Both modes produce a graph with the
        same structure/invariants; bulk is the matmul-bound fast path
        (see index/build_cluster.py), waves are the incremental
        pgvector-faithful path.
        """
        device_in = isinstance(data, jax.Array) and data.ndim == 2
        # device-resident inputs take the bulk path without a host
        # round-trip (validated/normalized on device in build_bulk);
        # the wave path below needs host numpy and pulls them back
        x = data if device_in else self._prep(data)
        if self.capacity == 0 and self.graph is None:
            self.capacity = max(self.cfg.max_elements, x.shape[0])
        if mode not in ("auto", "bulk", "wave"):
            raise ValueError("mode must be auto|bulk|wave")
        if mode == "bulk" and self.cfg.metric is Metric.L1:
            # the bulk path's candidate generation is k-means clustering
            # (L2/IP geometry); L1 (vector_l1_ops) builds via waves, whose
            # beam search + SelectNeighbors score natively in L1
            raise ValueError("bulk build does not support Metric.L1; "
                             "use mode='wave'")
        use_bulk = mode == "bulk" or (
            mode == "auto" and self.n == 0 and x.shape[0] >= self.BULK_THRESHOLD
            and self.cfg.metric is not Metric.L1
        )
        if use_bulk:
            from tpu_hnsw.index.build_cluster import build_bulk

            build_bulk(self, x)
        else:
            if device_in:
                x = self._prep(np.asarray(x))
            self.add(x, _pre=False)
        return self

    def add(self, data, _pre: bool = True, levels: np.ndarray | None = None,
            progress=None, checkpoint_every: int = 0,
            checkpoint_path: str | None = None) -> np.ndarray:
        """Insert vectors (hnswinsert analogue, batched). Returns ids.

        ``levels`` overrides the geometric draw (tests / deterministic
        replay only). ``progress(done, total)`` is invoked after each wave
        (the pg_stat_progress_create_index analogue). With
        ``checkpoint_every=K`` and a path, the index is snapshotted every K
        waves — wave-granular resumable builds (the flat-array layout makes
        the crash-restart-from-scratch limitation of upstream CREATE INDEX
        unnecessary; SURVEY.md §5 checkpoint/resume)."""
        x = self._prep(data) if _pre else np.asarray(data, np.float32)
        count = x.shape[0]
        self._ensure_graph(count)
        if levels is None:
            levels = self._draw_levels(count)
        else:
            levels = np.asarray(levels, np.int32)
        ids_out = np.empty(count, dtype=np.int32)

        pos = 0
        # bootstrap: the very first element becomes the entry point with no
        # search (upstream: first inserted tuple initializes the metapage)
        if self.entry < 0:
            ids_out[0] = self.n
            self._insert_first(x[0], int(levels[0]))
            pos = 1

        while pos < count:
            # wave ramp: a wave never exceeds the current graph size, so
            # early elements see a reasonably dense graph
            wave = min(self.cfg.wave_size, max(1, self.n), count - pos)
            ids_out[pos : pos + wave] = self.n + np.arange(wave, dtype=np.int32)
            self._insert_wave(x[pos : pos + wave], levels[pos : pos + wave])
            pos += wave
            if progress is not None:
                progress(pos, count)
            if checkpoint_every and checkpoint_path:
                self._waves_since_ckpt = getattr(self, "_waves_since_ckpt", 0) + 1
                if self._waves_since_ckpt >= checkpoint_every:
                    self.save(checkpoint_path)
                    self._waves_since_ckpt = 0
        return ids_out

    def _insert_first(self, vec: np.ndarray, level: int):
        g = self.graph
        nid = self.n
        slot = self.n_upper if level >= 1 else g.cap_upper
        if level >= 1:
            self.n_upper += 1
        g = B._set_wave(
            g,
            jnp.asarray([nid], jnp.int32),
            jnp.asarray(vec[None, :]),
            jnp.asarray([level], jnp.int32),
            jnp.asarray([slot], jnp.int32),
        )
        self.graph = g
        self.entry, self.entry_level = nid, level
        self.n += 1
        self._levels_host.append(level)

    def _insert_wave(self, x: np.ndarray, levels: np.ndarray) -> None:
        bsz = x.shape[0]
        # every wave pads to ONE static bucket so a whole build compiles a
        # single set of kernels (ramp waves waste some compute, but a
        # compile costs far more than a padded wave)
        bpad = B.next_pow2(self.cfg.wave_size)
        order = np.argsort(-levels, kind="stable")  # sort wave by level desc
        x_sorted = x[order]
        lv_sorted = levels[order]
        ids = np.full(bpad, self.graph.sentinel, np.int32)
        # each input row keeps its natural id (n + row); the wave is a
        # level-sorted VIEW, so ids here are the permuted row ids
        ids[:bsz] = self.n + order.astype(np.int32)
        lv = np.zeros(bpad, np.int32)
        lv[:bsz] = lv_sorted
        slots = np.full(bpad, self.graph.cap_upper, np.int32)
        n_up = int((lv_sorted >= 1).sum())
        if self.n_upper + n_up > self.graph.cap_upper:
            raise RuntimeError("upper-level table overflow; increase capacity")
        slots[:n_up] = self.n_upper + np.arange(n_up, dtype=np.int32)
        self.n_upper += n_up

        vecs = np.zeros((bpad, x.shape[1]), np.float32)
        vecs[:bsz] = x_sorted
        self.graph = B.insert_wave(
            self.graph,
            self.cfg,
            jnp.asarray(vecs),
            ids,
            lv,
            slots,
            bsz,
            self.entry,
            self.entry_level,
        )
        self._levels_host.extend(int(l) for l in levels)
        self.n += bsz
        wave_max = int(lv_sorted[0])
        if wave_max > self.entry_level:
            self.entry = int(ids[0])
            self.entry_level = wave_max

    # ---------------------------------------------------------------- search
    # auto route picks the dense upper-subset scan at/above this n_upper:
    # small graphs keep upstream's greedy descent (the oracle-parity path;
    # at test scale both are fast), big serving graphs take the dense
    # matmul scan (one [Q, n_upper] product instead of a serial chain of
    # gathers per level)
    ROUTE_SCAN_MIN_UPPER = 4096

    def _upper_ids_dev(self):
        """Sentinel-padded device array of level>=1 element ids, cached
        per graph epoch (every mutation replaces ``self.graph``, so object
        identity is the epoch key)."""
        cache = getattr(self, "_route_cache", None)
        if cache is not None and cache[0] is self.graph:
            return cache[1]
        upad = max(-(-self.n_upper // 256) * 256, 256)
        ids = _upper_ids_jit(self.graph.levels, self.graph.cap, upad)
        self._route_cache = (self.graph, ids)
        return ids

    def _resolve_route(self, route: str) -> jax.Array | None:
        """None -> greedy descent; device id array -> dense-scan routing."""
        if route not in ("auto", "scan", "descent"):
            raise ValueError("route must be auto, scan, or descent")
        if route == "descent" or self.cfg.metric is Metric.L1 \
                or self.n_upper == 0:
            return None
        if route == "auto" and self.n_upper < self.ROUTE_SCAN_MIN_UPPER:
            return None
        return self._upper_ids_dev()

    def _entry_scalars(self):
        """Device-resident (entry, entry_level) scalars, cached until the
        entry point changes: two eager jnp.int32() transfers per
        search_device call would sit in every batch's critical path."""
        key = (self.entry, self.entry_level)
        if getattr(self, "_entry_cache_key", None) != key:
            self._entry_cache_key = key
            self._entry_dev = (
                jnp.int32(max(self.entry, 0)),
                jnp.int32(max(self.entry_level, 0)),
            )
        return self._entry_dev

    def _filter_device(self, filter_mask) -> jax.Array:
        """Device [cap+1] bool mask from a per-id filter (True = row
        passes). Accepts a bool mask of length >= n, an id list, or an
        already-shaped device array (returned as-is; cache it caller-side
        for repeated filtered scans)."""
        cap = self.graph.cap
        if isinstance(filter_mask, jax.Array) and filter_mask.shape == (
                cap + 1,):
            return filter_mask
        m = np.asarray(filter_mask)
        full = np.zeros(cap + 1, bool)
        if m.dtype == bool:
            ln = min(len(m.reshape(-1)), cap)
            full[:ln] = m.reshape(-1)[:ln]
        else:  # id list
            ids = m.reshape(-1).astype(np.int64)
            ids = ids[(ids >= 0) & (ids < cap)]
            full[ids] = True
        return jnp.asarray(full)

    def search_device(self, queries, k: int = 10, ef_search: int = 40,
                      expand: int | None = None,
                      descent_ef: int | None = None,
                      max_steps: int = 0, route: str = "auto",
                      filter_mask=None):
        """Device-resident search: dispatches asynchronously and returns
        (distances, ids) as device arrays (operator units; sentinel id for
        missing). Use for pipelined serving — no host sync per call.

        ``filter_mask`` enables the device-side filtered scan (upstream's
        executor-filter analogue, VERDICT r3 #5): a bool mask / id list of
        rows allowed in the results, fused into the beam's fresh mask (see
        index/search.py). Selective filters need a wider ``ef_search`` to
        find k passing rows — see ``search_iterative`` for automatic
        widening.

        ``expand``/``descent_ef`` override the config's
        ``expand_per_step``/``descent_ef`` per call (serving knobs, like
        ef_search — wider expand trades distance evals for fewer lockstep
        steps). ``route`` picks the upper-level routing: "descent" =
        upstream's greedy pointer-chase (ef=descent_ef), "scan" = dense
        matmul scan of the level>=1 subset (exhaustive routing — see
        index/search.py::scan_seeds), "auto" =
        scan for big graphs, descent for small ones (and always for L1,
        which has no matmul form)."""
        validate_ef_search(ef_search)
        if self.graph is None or self.n == 0:
            raise ValueError("index is empty")
        if isinstance(queries, jax.Array) and queries.ndim == 2:
            # device-resident queries: skip the host round-trip;
            # finite/dim validation is the caller's job here
            if queries.shape[1] != self.cfg.dim:
                raise ValueError(
                    f"expected {self.cfg.dim} dimensions, not "
                    f"{queries.shape[1]}"
                )
            q = queries.astype(jnp.float32)
            if self.cfg.metric.needs_normalized:
                q = D.l2_normalize(q)
            nq = q.shape[0]
            qpad = B.next_pow2(nq)
            if qpad != nq:
                q = jnp.pad(q, ((0, qpad - nq), (0, 0)))
        else:
            q = self._prep(queries)
            nq = q.shape[0]
            qpad = B.next_pow2(nq)
            if qpad != nq:
                q = np.concatenate(
                    [q, np.zeros((qpad - nq, q.shape[1]), q.dtype)]
                )
        entry_dev, entry_level_dev = self._entry_scalars()
        scores, ids = SE.search(
            self.graph,
            jnp.asarray(q),
            entry=entry_dev,
            entry_level=entry_level_dev,
            k=k,
            ef_search=max(ef_search, k),
            metric=self.cfg.metric,
            expand=self.cfg.expand_per_step if expand is None else expand,
            descent_ef=(self.cfg.descent_ef if descent_ef is None
                        else descent_ef),
            max_steps=max_steps,
            upper_ids=self._resolve_route(route),
            allowed=(None if filter_mask is None
                     else self._filter_device(filter_mask)),
        )
        return D.score_to_distance(scores[:nq], self.cfg.metric), ids[:nq]

    def search(
        self,
        queries,
        k: int = 10,
        ef_search: int = 40,
        return_distances: bool = True,
        expand: int | None = None,
        descent_ef: int | None = None,
        max_steps: int = 0,
        route: str = "auto",
        filter_mask=None,
    ):
        """ORDER BY distance LIMIT k analogue (hnswscan GetScanItems).

        Returns (distances [Q, k] in operator units, ids [Q, k]); missing
        results carry id -1 and distance +inf.
        """
        dists, ids = self.search_device(queries, k=k, ef_search=ef_search,
                                        expand=expand, descent_ef=descent_ef,
                                        max_steps=max_steps, route=route,
                                        filter_mask=filter_mask)
        dists, ids = jax.device_get((dists, ids))
        ids = np.where(ids == self.graph.sentinel, -1, ids)
        if not return_distances:
            return ids
        return np.asarray(dists), ids

    def search_with_stats(self, queries, k: int = 10, ef_search: int = 40,
                          route: str = "auto"):
        """Search + per-query observability counters (SURVEY §5 metrics:
        hops/query, distance-evals/query — the EXPLAIN ANALYZE buffer-hits
        analogue). Returns (distances, ids, stats dict)."""
        validate_ef_search(ef_search)
        if self.graph is None or self.n == 0:
            raise ValueError("index is empty")
        q = self._prep(queries)
        nq = q.shape[0]
        qpad = B.next_pow2(nq)
        if qpad != nq:
            q = np.concatenate([q, np.zeros((qpad - nq, q.shape[1]), q.dtype)])
        entry_dev, entry_level_dev = self._entry_scalars()
        scores, ids, hops, evals = SE.search(
            self.graph,
            jnp.asarray(q),
            entry=entry_dev,
            entry_level=entry_level_dev,
            k=k,
            ef_search=max(ef_search, k),
            metric=self.cfg.metric,
            expand=self.cfg.expand_per_step,
            descent_ef=self.cfg.descent_ef,
            with_counters=True,
            upper_ids=self._resolve_route(route),
        )
        dists = D.score_to_distance(scores[:nq], self.cfg.metric)
        dists, ids, hops, evals = jax.device_get((dists, ids[:nq],
                                                  hops[:nq], evals[:nq]))
        ids = np.where(ids == self.graph.sentinel, -1, ids)
        stats = {
            "hops_per_query_mean": float(np.mean(hops)),
            "hops_per_query_max": int(np.max(hops)),
            "dist_evals_per_query_mean": float(np.mean(evals)),
            "dist_evals_per_query_max": int(np.max(evals)),
        }
        return np.asarray(dists), np.asarray(ids), stats

    # ---------------------------------------------------------------- delete
    def delete(self, ids) -> None:
        """Tombstone elements (hnswbulkdelete analogue; repair at compact)."""
        ids = np.asarray(ids, dtype=np.int32).reshape(-1)
        g = self.graph
        self.graph = g._replace(deleted=g.deleted.at[ids].set(True, mode="drop"))

    def compact(self) -> int:
        """Graph repair after deletes — the VACUUM analogue (upstream
        ``pgvector:src/hnswvacuum.c``): restore the entry point if it died,
        then re-find neighbors for every element whose list references a
        deleted element, as batched repair waves (search skips tombstones).

        Tombstoned rows stay allocated (flat arrays have no page
        reclamation); a save/load round-trip of live vectors into a fresh
        index reclaims space. Returns the number of repaired neighbor
        lists summed over all levels (a node repaired at two levels
        counts twice, mirroring upstream's per-list repair loop).
        """
        from tpu_hnsw.index import select as SEL
        from tpu_hnsw.index.search import descend_seeds, search_layer

        g = self.graph
        sent = g.sentinel
        deleted = np.asarray(g.deleted[: self.n])
        if not deleted.any():
            return 0
        levels = np.asarray(g.levels[: self.n])
        live = np.where(~deleted)[0]
        if live.size == 0:
            raise ValueError("cannot compact an index with every element deleted")
        # entry repair (upstream RepairGraphEntryPoint)
        if deleted[self.entry]:
            j = live[levels[live].argmax()]
            self.entry, self.entry_level = int(j), int(levels[j])

        del_ext = np.append(deleted, False)  # sentinel row never "deleted"
        repaired = 0
        E = self.cfg.build_expand_per_step
        for lc in range(self.entry_level, -1, -1):
            if lc == 0:
                adj = np.asarray(g.neighbors0[: self.n])
                nodes = np.arange(self.n)
            else:
                slots_all = np.asarray(g.upper_slot[: self.n])
                nodes = np.where((levels >= lc) & ~deleted)[0]
                adj = np.asarray(g.upper_nbrs[:, lc - 1, :])[slots_all[nodes]]
            safe = np.where(adj == sent, self.n, adj)
            affected_rows = (del_ext[safe].any(axis=1)) & (
                ~deleted[nodes] if lc == 0 else np.ones(len(nodes), bool)
            )
            targets = nodes[affected_rows] if lc > 0 else np.where(affected_rows)[0]
            if targets.size == 0:
                continue
            repaired += int(targets.size)
            bpad = B.next_pow2(len(targets))
            ids_pad = np.full(bpad, sent, np.int32)
            ids_pad[: len(targets)] = targets
            qv = np.zeros((bpad, self.cfg.dim), np.float32)
            qv[: len(targets)] = np.asarray(g.vectors[targets], np.float32)
            qj = jnp.asarray(qv).astype(g.vectors.dtype)
            # Route through the upper levels first (upstream repair re-runs
            # HnswFindElementNeighbors, which descends from the entry):
            # level-0-only search from the global entry basin-fails on
            # clustered data (measured pool quality 0.06 vs 0.97 seeded).
            seeds = descend_seeds(
                g, qj, jnp.int32(self.entry), jnp.int32(self.entry_level),
                jnp.int32(lc), metric=self.cfg.metric,
                descent_ef=self.cfg.descent_ef,
            )
            pool_d, pool_i = search_layer(
                g, qj, seeds, jnp.int32(lc), level0=(lc == 0),
                ef=self.cfg.ef_construction, expand=E, metric=self.cfg.metric,
            )
            # drop self-hits and invalid rows
            idsj = jnp.asarray(ids_pad)
            pool_i = jnp.where(pool_i == idsj[:, None], sent, pool_i)
            pool_d = jnp.where(pool_i == sent, jnp.inf, pool_d)
            pool_d, pool_i = B._mask_pool(
                pool_d, pool_i, jnp.int32(len(targets)), sent
            )
            # Union the SURVIVING old neighbors into the candidate pool: an
            # efc search pool is pure near-neighbors, and selecting only
            # from it replaces the diversity edges accumulated during
            # construction with a kNN list — measured to cost ~0.12
            # recall@10 after a 10%-delete repair of a clustered corpus.
            # With the old live edges as candidates the pruning heuristic
            # can keep the navigable ones (upstream keeps them implicitly:
            # its repair pool seeds from the old neighbors).
            old_nbrs = np.full((bpad, adj.shape[1]), sent, np.int32)
            old_rows = adj[affected_rows]
            old_nbrs[: len(targets)] = np.where(
                del_ext[np.where(old_rows == sent, self.n, old_rows)],
                sent, old_rows,
            )
            oj = jnp.asarray(old_nbrs)
            oj = jnp.where(oj == idsj[:, None], sent, oj)
            ov, ov_sq = G.gather_vectors(g, oj)
            od = D.batched_scores(
                qj, ov, self.cfg.metric, vecs_sq=ov_sq,
                q_sq=D.squared_norms(qj),
            )
            od = jnp.where(oj == sent, jnp.inf, od)
            pool_i = jnp.concatenate([pool_i, oj], axis=1)
            pool_d = jnp.concatenate([pool_d, od], axis=1)
            lm = self.cfg.layer_m(lc)
            sel_ids, sel_dists = SEL.select_neighbors(
                g, pool_i, pool_d, lm=lm, metric=self.cfg.metric
            )
            slots_pad = np.full(bpad, g.cap_upper, np.int32)
            if lc > 0:
                slots_pad[: len(targets)] = np.asarray(g.upper_slot[targets])
            g = B._write_own_lists(
                g, idsj, jnp.asarray(slots_pad), sel_ids, jnp.int32(lc),
                level0=(lc == 0),
            )
            t, u, d = B._sorted_updates(sel_ids, sel_dists, idsj)
            g = B._reciprocal_update(
                g, t, u, d, jnp.int32(lc), level0=(lc == 0), lm=lm,
                metric=self.cfg.metric,
            )
        self.graph = g
        return repaired

    def vacuum_full(self) -> np.ndarray:
        """Reclaim tombstoned capacity (upstream vacuum page reclamation,
        ``hnswvacuumcleanup``): run :meth:`compact` to repair adjacency,
        then squash live rows into fresh arrays so the freed slots are
        available to :meth:`add` again.

        Element ids are renumbered; returns the old->new id map
        (int64 [old_n], -1 for deleted rows) — the TID-remap analogue.
        """
        self.compact()
        g = self.graph
        sent_old = g.sentinel
        n_old = self.n
        deleted = np.asarray(g.deleted[:n_old])
        live = np.where(~deleted)[0]
        if live.size == 0:
            raise ValueError("cannot vacuum an index with every element deleted")
        n_new = int(live.size)
        idmap = np.full(n_old, -1, np.int64)
        idmap[live] = np.arange(n_new)

        fresh = G.init_graph(self.cfg, self.capacity)
        sent_new = fresh.sentinel
        # old-id -> new-id table covering the sentinel row; repaired lists
        # should not reference deleted rows, but map them to the sentinel
        # anyway (defense in depth)
        remap = np.full(sent_old + 1, sent_new, np.int32)
        remap[live] = np.arange(n_new, dtype=np.int32)

        vecs = np.asarray(g.vectors[live], np.float32)
        levels = np.asarray(g.levels[:n_old])[live]
        nbr0 = remap[np.asarray(g.neighbors0[:n_old])[live]]

        has_upper = levels >= 1
        n_up = int(has_upper.sum())
        new_slots = np.full(n_new, fresh.cap_upper, np.int32)
        new_slots[has_upper] = np.arange(n_up, dtype=np.int32)
        old_slots = np.asarray(g.upper_slot[:n_old])[live][has_upper]
        upper_rows = remap[np.asarray(g.upper_nbrs)[old_slots]]  # [n_up, L, m]

        vj = jnp.asarray(vecs).astype(fresh.vectors.dtype)
        self.graph = fresh._replace(
            vectors=fresh.vectors.at[:n_new].set(vj),
            vectors_sq=fresh.vectors_sq.at[:n_new].set(
                jnp.sum(vj.astype(jnp.float32) ** 2, axis=-1)
            ),
            neighbors0=fresh.neighbors0.at[:n_new].set(jnp.asarray(nbr0)),
            upper_nbrs=fresh.upper_nbrs.at[:n_up].set(jnp.asarray(upper_rows)),
            upper_slot=fresh.upper_slot.at[:n_new].set(jnp.asarray(new_slots)),
            levels=fresh.levels.at[:n_new].set(jnp.asarray(levels)),
        )
        self.n = n_new
        self.n_upper = n_up
        self.entry = int(idmap[self.entry])
        self._levels_host = [int(l) for l in levels]
        return idmap

    # ------------------------------------------------------- iterative scan
    def search_iterative(
        self,
        queries,
        k: int = 10,
        ef_search: int = 40,
        predicate=None,
        max_scan_tuples: int = 20000,
    ):
        """Iterative scan (upstream v0.8 ``hnsw.iterative_scan`` +
        ``hnsw.max_scan_tuples``): when a filter rejects results, RESUME
        the search with a widened candidate pool until k predicate-passing
        results are found or the per-query scan budget is exhausted. The
        pool and dedup history carry over; each widening re-opens the
        frontier (expanded flags reset) so the beam can push past the old
        ef horizon, which re-expands up to one pool's worth of nodes —
        bounded ~2x rework per widening, not a restart.

        ``max_scan_tuples`` bounds the tuples *visited* per query,
        counted as distance evaluations (the buffer-read analogue of
        upstream's tuple count; re-scores after a widening count against
        the budget too) — budgets beyond 1000 are honored; the 1..1000
        GUC range applies only to the user-facing ``ef_search``.

        ``predicate(ids) -> bool mask`` runs host-side (the executor-filter
        analogue). Returns (distances, ids) with -1/inf padding when fewer
        than k survive.

        Ordering: results come from the final sorted candidate pool, so
        they are ascending-by-distance — upstream's ``strict_order``
        semantics. ``relaxed_order`` exists upstream because its executor
        streams tuples batch-by-batch and a resume may surface a closer
        tuple after a farther one was already emitted; this API returns
        one final top-k per query, so there is no weaker ordering to
        offer (no knob needed).
        """
        from tpu_hnsw.index.search import search_resumable_start, search_resume

        validate_ef_search(ef_search)
        q = self._prep(queries)
        nq = q.shape[0]
        qpad = B.next_pow2(nq)
        if qpad != nq:
            q = np.concatenate([q, np.zeros((qpad - nq, q.shape[1]), q.dtype)])
        qj = jnp.asarray(q)
        g = self.graph
        sent = g.sentinel

        ef = max(ef_search, k)
        # pool width is the scan frontier; it never needs to exceed the
        # scan budget or the corpus
        ef_cap = int(max(min(max_scan_tuples, self.n), ef))
        pool_d, pool_i, state = search_resumable_start(
            g, qj, jnp.int32(self.entry), jnp.int32(self.entry_level),
            ef=ef, expand=self.cfg.expand_per_step, metric=self.cfg.metric,
            descent_ef=self.cfg.descent_ef,
        )

        out_d = np.full((nq, k), np.inf, np.float32)
        out_i = np.full((nq, k), -1, np.int64)
        done = np.zeros(nq, bool)
        while True:
            d_host = np.asarray(D.score_to_distance(pool_d, self.cfg.metric))
            ids = np.asarray(pool_i)
            ids = np.where(ids == sent, -1, ids)[:nq]
            d_host = d_host[:nq]
            mask = predicate(ids) if predicate is not None else ids >= 0
            mask &= ids >= 0
            evals = np.asarray(state[5])[:nq]
            exhausted = evals >= max_scan_tuples
            for qi in range(nq):
                if done[qi]:
                    continue
                good = np.where(mask[qi])[0][:k]
                if len(good) >= k or exhausted[qi] or ef >= ef_cap:
                    out_d[qi, : len(good)] = d_host[qi, good]
                    out_i[qi, : len(good)] = ids[qi, good]
                    done[qi] = True
            if done.all() or ef >= ef_cap:
                # flush any queries cut off by the global ef cap
                for qi in np.where(~done)[0]:
                    good = np.where(mask[qi])[0][:k]
                    out_d[qi, : len(good)] = d_host[qi, good]
                    out_i[qi, : len(good)] = ids[qi, good]
                break
            ef = min(2 * ef, ef_cap)
            pool_d, pool_i, state = search_resume(
                g, qj, state, ef=ef, expand=self.cfg.expand_per_step,
                metric=self.cfg.metric,
            )
        return out_d, out_i

    # ----------------------------------------------------------- persistence
    def save(self, path: str) -> None:
        """Persist full index state (the WAL/page-flush analogue is a single
        explicit snapshot: SURVEY.md §5 checkpoint/resume)."""
        os.makedirs(path, exist_ok=True)
        g = self.graph
        if self.cfg.dtype == "bfloat16":
            # persist natively: bf16 bits as uint16 (numpy has no bf16) —
            # halfvec storage parity means the checkpoint is half-size too
            vectors = np.asarray(jax.device_get(g.vectors)).view(np.uint16)
        else:
            vectors = np.asarray(g.vectors, dtype=np.float32)
        np.savez(
            os.path.join(path, "graph.npz"),
            vectors=vectors,
            neighbors0=np.asarray(g.neighbors0),
            upper_nbrs=np.asarray(g.upper_nbrs),
            upper_slot=np.asarray(g.upper_slot),
            levels=np.asarray(g.levels),
            deleted=np.asarray(g.deleted),
        )
        import dataclasses

        meta = {
            "config": {
                **dataclasses.asdict(self.cfg),
                "metric": self.cfg.metric.value,
            },
            "n": self.n,
            "n_upper": self.n_upper,
            "entry": self.entry,
            "entry_level": self.entry_level,
            "capacity": self.capacity,
        }
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)

    @classmethod
    def load(cls, path: str) -> "HnswIndex":
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        c = dict(meta["config"])
        c["metric"] = Metric(c["metric"])
        cfg = HnswConfig(**c)
        idx = cls(cfg, capacity=meta["capacity"])
        z = np.load(os.path.join(path, "graph.npz"))
        dtype = jnp.bfloat16 if cfg.dtype == "bfloat16" else jnp.float32
        raw = z["vectors"]
        if raw.dtype == np.uint16:  # natively-persisted bf16 bits
            vectors = jnp.asarray(raw).view(jnp.bfloat16)
        else:
            vectors = jnp.asarray(raw, dtype=dtype)
        idx.graph = G.HnswGraph(
            vectors=vectors,
            vectors_sq=D.squared_norms(vectors),
            neighbors0=jnp.asarray(z["neighbors0"]),
            upper_nbrs=jnp.asarray(z["upper_nbrs"]),
            upper_slot=jnp.asarray(z["upper_slot"]),
            levels=jnp.asarray(z["levels"]),
            deleted=jnp.asarray(z["deleted"]),
        )
        idx.n = meta["n"]
        idx.n_upper = meta["n_upper"]
        idx.entry = meta["entry"]
        idx.entry_level = meta["entry_level"]
        return idx
