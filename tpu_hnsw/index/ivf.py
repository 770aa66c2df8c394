"""IVFFlat index — the reference's second index access method.

Behavioral equivalent of upstream ``pgvector:src/ivf*.c``: k-means list
centroids (``ivfflat.lists``, default 100), vectors stored per-list,
probe-based scan (``ivfflat.probes``, default 1) with exact distances
inside probed lists. Storage is a padded ``[lists, maxlen, d]`` block
tensor so a probe is one contiguous block gather + one distance matmul
per query batch — no per-tuple page reads.
"""

from __future__ import annotations

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np

from tpu_hnsw.config import Metric
from tpu_hnsw.ops import distance as D
from tpu_hnsw.ops import topk as T
from tpu_hnsw.parallel import kmeans as KM

IVF_DEFAULT_LISTS = 100  # upstream ivfflat default
IVF_DEFAULT_PROBES = 1


def _high_water(ids_np: np.ndarray) -> np.ndarray:
    """Per-list append cursor recovered from the highest LIVE slot + 1.

    Slots above the last live one are tombstoned-or-never-used; reusing
    them cannot clobber a live row."""
    live = ids_np >= 0
    rev_first = live[:, ::-1].argmax(axis=1)  # 0 when no live in the list
    return np.where(
        live.any(axis=1), ids_np.shape[1] - rev_first, 0
    ).astype(np.int64)


@functools.partial(jax.jit, static_argnames=("k", "probes", "metric"))
def _probe_search(
    vecs_by_list,  # [L, M, d]
    ids_by_list,  # [L, M] int32 global ids, -1 padding
    centroids,  # [L, d]
    q,  # [Q, d]
    k: int,
    probes: int,
    metric: Metric,
):
    Q = q.shape[0]
    c_sc = D.pairwise_scores(q, centroids, Metric.L2)
    _, top_lists = T.topk_smallest(c_sc, probes)  # [Q, probes]
    best_d = jnp.full((Q, k), jnp.inf)
    best_i = jnp.full((Q, k), -1, jnp.int32)

    def body(p, carry):
        best_d, best_i = carry
        lists_p = top_lists[:, p]  # [Q]
        block = jnp.take(vecs_by_list, lists_p, axis=0)  # [Q, M, d]
        ids = jnp.take(ids_by_list, lists_p, axis=0)  # [Q, M]
        sc = D.batched_scores(q, block, metric)
        sc = jnp.where(ids < 0, jnp.inf, sc)
        d2 = jnp.concatenate([best_d, sc], axis=1)
        i2 = jnp.concatenate([best_i, ids], axis=1)
        vals, sel = T.topk_smallest(d2, k)
        return vals, jnp.take_along_axis(i2, sel, axis=1)

    best_d, best_i = jax.lax.fori_loop(0, probes, body, (best_d, best_i))
    return best_d, best_i


class IvfFlatIndex:
    """CREATE INDEX ... USING ivfflat analogue."""

    def __init__(
        self,
        dim: int,
        metric: Metric = Metric.L2,
        lists: int = IVF_DEFAULT_LISTS,
        seed: int = 0,
        dtype: str = "float32",
    ):
        if lists < 1 or lists > 32768:
            raise ValueError("lists must be in [1, 32768]")  # upstream range
        if dtype not in ("float32", "bfloat16"):
            # halfvec IVFFlat parity (upstream indexes halfvec columns
            # with ivfflat too; bf16 is this package's halfvec storage)
            raise ValueError("dtype must be float32 or bfloat16")
        self.dim = dim
        self.metric = metric
        self.lists = lists
        self.seed = seed
        self.dtype = dtype
        self._jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
        self.centroids: np.ndarray | None = None
        self.vecs_by_list = None  # [L, M, d]
        self.ids_by_list = None  # [L, M]
        self.n = 0        # live rows
        self.n_total = 0  # ids ever issued (monotone id space)
        # per-list append cursor (high-water mark). delete() tombstones
        # slots WITHOUT moving this back: computing insertion slots from
        # the live count instead silently overwrote live rows after a
        # mid-list delete (ADVICE r2 #1).
        self._cursor: np.ndarray | None = None
        # device-resident centroid table, invalidated on mutation: an
        # eager jnp.asarray per call would put a host->device transfer
        # in front of every probe-scan dispatch
        self._cdev = None

    def _centroids_device(self):
        if self._cdev is None:
            self._cdev = jnp.asarray(self.centroids)
        return self._cdev

    def build(self, data) -> "IvfFlatIndex":
        data = np.asarray(data, np.float32)
        if data.shape[1] != self.dim:
            raise ValueError(f"expected {self.dim} dimensions, not {data.shape[1]}")
        if self.metric.needs_normalized:
            data = data / np.maximum(
                np.linalg.norm(data, axis=1, keepdims=True), 1e-12
            )
        n = data.shape[0]
        # upstream: kmeans over a sample (50 * lists cap), then assign all
        self.centroids, assign = KM.kmeans(
            data, self.lists, iters=10, seed=self.seed, sample=max(10000, 50 * self.lists)
        )
        self._cdev = None
        counts = np.bincount(assign, minlength=self.lists)
        maxlen = max(8, int(counts.max()))
        # pad to a lane-friendly multiple
        maxlen = ((maxlen + 127) // 128) * 128
        vecs = np.zeros((self.lists, maxlen, self.dim), np.float32)
        ids = np.full((self.lists, maxlen), -1, np.int32)
        # vectorized packing (a per-row python loop here bites at 10M+):
        # stable-sort rows by list, then each row's slot is its rank
        # within its list's contiguous run
        order = np.argsort(assign, kind="stable")
        a_s = assign[order]
        slot = np.arange(n) - np.searchsorted(a_s, a_s)
        vecs[a_s, slot] = data[order]
        ids[a_s, slot] = order.astype(np.int32)
        self.vecs_by_list = jnp.asarray(vecs, dtype=self._jdt)
        self.ids_by_list = jnp.asarray(ids)
        self.n = n
        self.n_total = n
        self._cursor = counts.astype(np.int64)
        return self

    def add(self, data) -> np.ndarray:
        """Insert vectors into their nearest lists (``ivfinsert`` analogue:
        upstream appends the tuple to the closest centroid's list; lists
        grow as needed). Returns the new global ids."""
        if self.centroids is None:
            raise ValueError("build the index before add()")
        data = np.asarray(data, np.float32)
        if data.ndim == 1:
            data = data[None]
        if data.shape[1] != self.dim:
            raise ValueError(f"expected {self.dim} dimensions, not {data.shape[1]}")
        if self.metric.needs_normalized:
            data = data / np.maximum(
                np.linalg.norm(data, axis=1, keepdims=True), 1e-12
            )
        c = self._centroids_device()
        assign = np.asarray(
            jnp.argmin(D.pairwise_scores(jnp.asarray(data), c, Metric.L2), axis=1),
            np.int64,
        )
        # np.asarray over a device array is a read-only view; copy before scatter
        ids_np = np.array(self.ids_by_list)
        vecs_np = np.array(self.vecs_by_list)
        if self._cursor is None:  # index loaded from an older snapshot:
            # recover each list's high-water mark from the highest live
            # slot (every slot above it is dead and safe to overwrite)
            self._cursor = _high_water(ids_np)
        counts = self._cursor
        add_counts = np.bincount(assign, minlength=self.lists)
        need = int((counts + add_counts).max())
        maxlen = ids_np.shape[1]
        if need > maxlen:
            grow = ((need + 127) // 128) * 128 - maxlen
            vecs_np = np.pad(vecs_np, ((0, 0), (0, grow), (0, 0)))
            ids_np = np.pad(ids_np, ((0, 0), (0, grow)), constant_values=-1)
        new_ids = np.arange(self.n_total, self.n_total + len(data), dtype=np.int32)
        order = np.argsort(assign, kind="stable")
        a_s = assign[order]
        slot = counts[a_s] + (np.arange(len(data)) - np.searchsorted(a_s, a_s))
        vecs_np[a_s, slot] = data[order]
        ids_np[a_s, slot] = new_ids[order]
        self.vecs_by_list = jnp.asarray(vecs_np, dtype=self._jdt)
        self.ids_by_list = jnp.asarray(ids_np)
        self._cursor = counts + add_counts
        self.n += len(data)
        self.n_total += len(data)
        return new_ids

    def delete(self, ids) -> None:
        """Tombstone rows (``ivfvacuum``/bulkdelete analogue): their slots
        stop scoring; the storage is reclaimed on the next build()."""
        ids = np.asarray(ids).reshape(-1)
        ids_np = np.asarray(self.ids_by_list)
        kill = np.isin(ids_np, ids) & (ids_np >= 0)
        self.n -= int(kill.sum())
        self.ids_by_list = jnp.asarray(np.where(kill, -1, ids_np))

    def search(self, queries, k: int = 10, probes: int = IVF_DEFAULT_PROBES):
        if self.centroids is None:
            raise ValueError("index is empty")
        probes = max(1, min(probes, self.lists))
        q = np.asarray(queries, np.float32)
        if q.ndim == 1:
            q = q[None]
        if self.metric.needs_normalized:
            q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
        d, i = _probe_search(
            self.vecs_by_list,
            self.ids_by_list,
            self._centroids_device(),
            jnp.asarray(q),
            k,
            probes,
            self.metric,
        )
        return (
            np.asarray(D.score_to_distance(d, self.metric)),
            np.asarray(i),
        )

    def search_device(self, queries, k: int = 10, ef_search: int = 0,
                      probes: int = IVF_DEFAULT_PROBES):
        """Device-resident probe scan: ``queries`` is a jax array already
        on device; returns device arrays without syncing, so a serving
        loop can pipeline batches (the ``measure_qps`` contract).
        ``ef_search`` is accepted-and-ignored for harness uniformity —
        the IVF scan width is ``probes`` (upstream ``ivfflat.probes``)."""
        if self.centroids is None:
            raise ValueError("index is empty")
        del ef_search
        probes = max(1, min(probes, self.lists))
        q = queries
        if self.metric.needs_normalized:
            q = q / jnp.maximum(
                jnp.linalg.norm(q, axis=1, keepdims=True), 1e-12)
        d, i = _probe_search(
            self.vecs_by_list, self.ids_by_list, self._centroids_device(),
            q, k, probes, self.metric,
        )
        return D.score_to_distance(d, self.metric), i

    def search_iterative(self, queries, k: int = 10,
                         probes: int = IVF_DEFAULT_PROBES, predicate=None,
                         max_probes: int = 0):
        """Iterative probes (upstream v0.8 ``ivfflat.iterative_scan``):
        when a filter rejects results, re-scan with doubled probes until k
        passing results or ``max_probes`` (default: all lists) is reached.
        ``predicate(ids) -> bool mask`` runs host-side."""
        max_probes = max_probes or self.lists
        q = np.asarray(queries, np.float32)
        if q.ndim == 1:
            q = q[None]
        nq = q.shape[0]
        out_d = np.full((nq, k), np.inf, np.float32)
        out_i = np.full((nq, k), -1, np.int64)
        done = np.zeros(nq, bool)
        p = max(1, probes)
        while True:
            # fetch widens with the probe count so a selective filter can
            # still find k passers among the fetched rows
            fetch = k if predicate is None else min(max(4 * k, 8 * p), 1000)
            d, ids = self.search(q, k=fetch, probes=p)
            mask = predicate(ids) if predicate is not None else ids >= 0
            mask &= ids >= 0
            for qi in range(nq):
                if done[qi]:
                    continue
                good = np.where(mask[qi])[0][:k]
                if len(good) >= k or p >= max_probes:
                    out_d[qi, : len(good)] = d[qi, good]
                    out_i[qi, : len(good)] = ids[qi, good]
                    done[qi] = True
            if done.all() or p >= max_probes:
                break
            p = min(2 * p, max_probes, self.lists)
        return out_d, out_i

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        vecs = np.asarray(self.vecs_by_list)
        if self.dtype == "bfloat16":
            # persist natively: bf16 bits as uint16 (numpy has no bf16) —
            # same convention as the graph engine (index/hnsw.py)
            vecs = vecs.view(np.uint16)
        np.savez(
            os.path.join(path, "ivf.npz"),
            centroids=self.centroids,
            vecs=vecs,
            ids=np.asarray(self.ids_by_list),
        )
        with open(os.path.join(path, "ivf.json"), "w") as f:
            json.dump(
                {"dim": self.dim, "metric": self.metric.value,
                 "lists": self.lists, "seed": self.seed, "n": self.n,
                 "n_total": self.n_total, "dtype": self.dtype}, f
            )

    @classmethod
    def load(cls, path: str) -> "IvfFlatIndex":
        with open(os.path.join(path, "ivf.json")) as f:
            m = json.load(f)
        idx = cls(m["dim"], Metric(m["metric"]), m["lists"], m["seed"],
                  dtype=m.get("dtype", "float32"))
        z = np.load(os.path.join(path, "ivf.npz"))
        idx.centroids = z["centroids"]
        raw = z["vecs"]
        if raw.dtype == np.uint16:  # natively-persisted bf16 bits
            idx.vecs_by_list = jnp.asarray(raw).view(jnp.bfloat16)
        else:
            idx.vecs_by_list = jnp.asarray(raw, dtype=idx._jdt)
        idx.ids_by_list = jnp.asarray(z["ids"])
        idx.n = m["n"]
        idx.n_total = m.get("n_total", m["n"])
        idx._cursor = _high_water(z["ids"])
        return idx
