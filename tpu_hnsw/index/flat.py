"""Exact (brute-force) KNN — the ground-truth oracle and fallback index.

The reference's oracle is a sequential scan with the same operator
(pgvector TAP recall tests compare HNSW results against
``ORDER BY embedding <-> q LIMIT k`` with ``enable_indexscan=off``);
this module is the device equivalent: a *streamed* matmul-distance scan
+ top-k ("K Nearest Neighbor Search at Peak FLOP/s", PAPERS.md),
jit-compiled.

Shape of the scan:

- the table is padded once to a block multiple and streamed through
  matmuls as ``lax.scan`` blocks (sequential device-memory reads);
- per-block top-k uses ``lax.approx_min_k`` in the default path (on the
  GPU and CPU it lowers to JAX's exact fallback, ROADMAP 1.4), exact
  ``top_k`` + ``Precision.HIGHEST`` in oracle mode;
- the default path re-ranks the surviving candidates with exact f32
  arithmetic, so results are exact-grade at fast-scan throughput.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from tpu_hnsw.config import Metric
from tpu_hnsw.ops import distance as D
from tpu_hnsw.ops import topk as T


@functools.partial(
    jax.jit, static_argnames=("metric", "k", "precision", "approx")
)
def _stream_search(q, xs, xs_sq, valid, k: int, metric: Metric, precision,
                   approx: bool):
    """Streamed block scan. xs: [nb, blk, d]; xs_sq/valid: [nb, blk].
    Returns (scores [Q, k], global ids [Q, k])."""
    nq = q.shape[0]
    blk = xs.shape[1]
    q_sq = D.squared_norms(q)
    kk = min(k, blk)
    qx = q.astype(xs.dtype)

    def body(carry, inp):
        best_d, best_i, off = carry
        xb, xb_sq, vb = inp
        if metric is Metric.L1:
            # ``<+>`` has no matmul form: Q x blk x d elementwise reduce on
            # the VPU (XLA fuses the |q - x| sum without materializing the
            # 3-d intermediate). Exact scans are the L1 serving path; the
            # graph engine's L1 beam search pays the same VPU form.
            sc = jnp.sum(
                jnp.abs(qx.astype(jnp.float32)[:, None, :]
                        - xb.astype(jnp.float32)[None, :, :]), axis=-1)
        else:
            dots = jax.lax.dot_general(
                qx, xb.T, (((1,), (0,)), ((), ())),
                preferred_element_type=jnp.float32, precision=precision,
            )
            if metric is Metric.L2:
                sc = jnp.maximum(
                    q_sq[:, None] + xb_sq[None, :] - 2.0 * dots, 0.0)
            else:
                sc = -dots
        sc = jnp.where(vb[None, :], sc, T.INF)
        if approx:
            tv, ti = jax.lax.approx_min_k(sc, kk)
        else:
            neg, ti = jax.lax.top_k(-sc, kk)
            tv = -neg
        ids = off + ti
        d2 = jnp.concatenate([best_d, tv], axis=1)
        i2 = jnp.concatenate([best_i, ids], axis=1)
        vals, sel = T.topk_smallest(d2, k)
        return (vals, jnp.take_along_axis(i2, sel, axis=1), off + blk), None

    best_d = jnp.full((nq, k), T.INF)
    best_i = jnp.full((nq, k), -1, dtype=jnp.int32)
    (best_d, best_i, _), _ = jax.lax.scan(
        body, (best_d, best_i, jnp.int32(0)), (xs, xs_sq, valid)
    )
    return best_d, best_i


@functools.partial(jax.jit, static_argnames=("metric", "k"))
def _stream_search_int8(q, xs8, xs_sq, scales, valid, k: int,
                        metric: Metric):
    """Streamed int8 scan: a QUARTER of the f32 scan's device-memory
    bytes (the block engine's stage-1 trick applied to the
    flat table; per-ROW symmetric scales keep the quantization error in
    the cross term only — exact norms ride along in f32). Candidates
    feed the exact f32 rerank, same as the bf16-grade default path.

    xs8: [nb, blk, dp] int8 (lane-padded); scales: [nb, blk] f32
    per-row dequant; xs_sq: [nb, blk] exact f32 squared norms.
    """
    nq = q.shape[0]
    blk = xs8.shape[1]
    dp = xs8.shape[2]
    q_sq = D.squared_norms(q)
    qp = jnp.pad(q, ((0, 0), (0, dp - q.shape[1]))) if dp != q.shape[1] else q
    q_amax = jnp.maximum(jnp.max(jnp.abs(qp), axis=1), 1e-30)
    q_scl = q_amax / 127.0
    q8 = jnp.clip(jnp.round(qp / q_scl[:, None]), -127, 127).astype(jnp.int8)
    kk = min(k, blk)

    def body(carry, inp):
        best_d, best_i, off = carry
        xb8, xb_sq, scl, vb = inp
        dots_i = jax.lax.dot_general(
            q8, xb8.T, (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32,
        )
        dots = dots_i.astype(jnp.float32) * (q_scl[:, None] * scl[None, :])
        if metric is Metric.L2:
            sc = jnp.maximum(q_sq[:, None] + xb_sq[None, :] - 2.0 * dots, 0.0)
        else:
            sc = -dots
        sc = jnp.where(vb[None, :], sc, T.INF)
        tv, ti = jax.lax.approx_min_k(sc, kk)
        ids = off + ti
        d2 = jnp.concatenate([best_d, tv], axis=1)
        i2 = jnp.concatenate([best_i, ids], axis=1)
        vals, sel = T.topk_smallest(d2, k)
        return (vals, jnp.take_along_axis(i2, sel, axis=1), off + blk), None

    best_d = jnp.full((nq, k), T.INF)
    best_i = jnp.full((nq, k), -1, dtype=jnp.int32)
    (best_d, best_i, _), _ = jax.lax.scan(
        body, (best_d, best_i, jnp.int32(0)), (xs8, xs_sq, scales, valid)
    )
    return best_d, best_i


@functools.partial(jax.jit, static_argnames=("metric", "k", "n"))
def _rerank(q, x, cand_ids, metric: Metric, k: int, n: int):
    """Exact f32 re-scoring of candidate ids [Q, C] -> top-k.

    ids outside [0, n) are masked to +inf: approx_min_k in the fast path
    can emit padded-row candidates (id >= n); clipping them into the table
    would rescore a real row to a finite distance and displace a true
    neighbor (ADVICE r1).
    """
    bad = (cand_ids < 0) | (cand_ids >= n)
    v = jnp.take(x, jnp.clip(cand_ids, 0, n - 1), axis=0)
    sc = D.batched_scores(q, v, metric)
    sc = jnp.where(bad, T.INF, sc)
    vals, sel = T.topk_smallest(sc, k)
    ids = jnp.where(
        jnp.isfinite(vals), jnp.take_along_axis(cand_ids, sel, axis=1), -1
    )
    return vals, ids


class FlatIndex:
    """Exact KNN over an HBM-resident vector table."""

    BLOCK = 131072

    def __init__(self, vectors, metric: Metric = Metric.L2, dtype=None,
                 scan_dtype: str = "default"):
        """``scan_dtype="int8"`` adds a quantized scoring copy for the
        streamed scan (a quarter of the bytes; candidates still rerank
        exact f32). Its speed on the H100 is not measured yet (ROADMAP
        3.7). L1 has no matmul form and ignores it.
        """
        vectors = jnp.asarray(vectors)
        if dtype is not None:
            vectors = vectors.astype(dtype)
        if metric.needs_normalized:
            vectors = D.l2_normalize(vectors)
        self.metric = metric
        if scan_dtype not in ("default", "int8"):
            raise ValueError("scan_dtype must be default|int8")
        self.scan_dtype = "default" if metric is Metric.L1 else scan_dtype
        self.n = int(vectors.shape[0])
        self.dim = int(vectors.shape[1])
        blk = min(self.BLOCK, 1 << (max(self.n - 1, 1)).bit_length())
        pad = (-self.n) % blk
        self._blk = blk
        # ONE HBM copy: the padded block view is the storage; the flat
        # unpadded table is a free reshape of it (ADVICE r1 flagged the
        # 2x HBM footprint of keeping both at 10M scale).
        vp = (
            jnp.concatenate(
                [vectors, jnp.zeros((pad, vectors.shape[1]), vectors.dtype)]
            )
            if pad
            else vectors
        )
        self._xs = vp.reshape(-1, blk, vectors.shape[1])
        self._xs_sq = D.squared_norms(self._xs)
        self._valid = (
            jax.lax.broadcasted_iota(
                jnp.int32, (self._xs.shape[0], blk), 0
            ) * blk
            + jax.lax.broadcasted_iota(jnp.int32, (self._xs.shape[0], blk), 1)
        ) < self.n
        self.vectors_sq = self._xs_sq.reshape(-1)[: self.n]
        self._xs8 = self._scales = None
        if self.scan_dtype == "int8":
            dp = ((self.dim + 127) // 128) * 128

            @jax.jit
            def _quant_block(xb):  # per-block: bounds the f32 temps
                xf = xb.astype(jnp.float32)
                amax = jnp.maximum(jnp.max(jnp.abs(xf), axis=1), 1e-30)
                scl = amax / 127.0
                q8 = jnp.clip(jnp.round(xf / scl[:, None]),
                              -127, 127).astype(jnp.int8)
                if dp != xb.shape[1]:
                    q8 = jnp.pad(q8, ((0, 0), (0, dp - xb.shape[1])))
                return q8, scl

            qs, scls = zip(*[_quant_block(self._xs[i])
                             for i in range(self._xs.shape[0])])
            self._xs8 = jnp.stack(qs)
            self._scales = jnp.stack(scls)  # [nb, blk] per-row dequant

    @property
    def vectors(self):
        """Unpadded [n, d] view (reshape of the block storage — no copy
        until sliced; exports/tests only, not the hot path)."""
        return self._xs.reshape(-1, self.dim)[: self.n]

    @property
    def _flat_padded(self):
        """[n_padded, d] zero-copy reshape used as the rerank gather source."""
        return self._xs.reshape(-1, self.dim)

    @property
    def size(self) -> int:
        return self.n

    def search_device(self, queries, k: int = 10, ef_search: int = 0,
                      exact=None):
        """Async device-resident exact search (pipelined serving path);
        ``ef_search`` accepted for API uniformity and ignored."""
        q = jnp.asarray(queries, dtype=jnp.float32)
        if q.ndim == 1:
            q = q[None]
        if self.metric.needs_normalized:
            q = D.l2_normalize(q)
        k_req, k = k, min(k, self.n)  # k may exceed the table (upstream
        # LIMIT > rows just returns fewer); pad the tail below
        if exact:
            scores, ids = _stream_search(
                q, self._xs, self._xs_sq, self._valid, k, self.metric,
                jax.lax.Precision.HIGHEST, False,
            )
        else:
            cand = min(max(4 * k, k), self.n)
            if self._xs8 is not None:
                _, cand_ids = _stream_search_int8(
                    q, self._xs8, self._xs_sq, self._scales, self._valid,
                    cand, self.metric,
                )
            else:
                # DEFAULT precision: an f32 table scans in TF32 on the
                # GPU's tensor cores; the exact f32 rerank below restores
                # the final order
                _, cand_ids = _stream_search(
                    q, self._xs, self._xs_sq, self._valid, cand, self.metric,
                    jax.lax.Precision.DEFAULT, True,
                )
            scores, ids = _rerank(
                q, self._flat_padded, cand_ids, self.metric, k, self.n
            )
        if k < k_req:
            scores = jnp.pad(scores, ((0, 0), (0, k_req - k)),
                             constant_values=jnp.inf)
            ids = jnp.pad(ids, ((0, 0), (0, k_req - k)), constant_values=-1)
        return D.score_to_distance(scores, self.metric), ids

    def search(self, queries, k: int = 10, block: int = 0, exact=None):
        """Returns (distances [Q,k] in pgvector operator units, ids [Q,k]).

        ``exact=None`` (auto): fast bf16-grade scan + exact re-rank —
        exact results in practice at streamed-scan throughput.
        ``exact=True``: full Precision.HIGHEST scan (the test oracle).
        """
        d, i = self.search_device(queries, k=k, exact=exact)
        d, i = jax.device_get((d, i))
        return np.asarray(d), np.asarray(i)
