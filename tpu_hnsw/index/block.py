"""BlockHnswIndex — HNSW with a cluster-blocked level 0 (the flagship
serving engine).

Why this exists: the classical HNSW hot loop is a chain of *random row
gathers* (one ~512B vector row per candidate), each far below the
transfer size at which device memory streams at full bandwidth, and
each step of the beam waits on the last. The reference never faces
this: Postgres page reads are 8KB and CPU caches hide the rest
(upstream ``pgvector:src/hnswscan.c`` per-hop buffer reads).

The fix here keeps the HNSW *structure* but changes the unit of level 0
from "one vector" to "one block of S spatially-clustered vectors stored
contiguously in device memory":

- vectors are k-means clustered and packed into ``[B, S, d]`` blocks
  (B = ceil(n/S)); a block is the gather granularity (S*d*4 ~ 128KB, so
  block gathers stream near device-memory bandwidth);
- the *upper levels* are a genuine HNSW graph (level assignment,
  SelectNeighbors pruning, beam search — :class:`HnswIndex`) built over
  the B block centroids;
- a query descends the centroid graph to its top-``probes`` blocks
  (for small B an exact centroid scan — equivalent to running the beam
  with ef=B — is cheaper and is used automatically), then expands those
  blocks *densely* as a matmul: contiguous gather + fused distance matmul
  + top-k. Every byte read is a candidate scored.

This is the "IVF-hybrid level 0" design from docs/ARCHITECTURE.md §6:
the per-hop pointer chase of ``HnswSearchLayer`` becomes one batched
block expansion, and the beam's candidate pool becomes the top-k over
all expanded rows.

Deletes tombstone rows in place (vacuum analogue); inserts go to a
flat-scanned spill tail (the analogue of upstream's unindexed-pending
semantics for IVF-style layouts) and are folded into blocks at
``compact()`` (re-cluster).
"""

from __future__ import annotations

import functools
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np

from tpu_hnsw.config import HnswConfig, Metric, validate_ef_search
from tpu_hnsw.index.hnsw import HnswIndex
from tpu_hnsw.io import native as N
from tpu_hnsw.ops import distance as D
from tpu_hnsw.ops import topk as T
from tpu_hnsw.parallel import kmeans as KM

INF = jnp.float32(jnp.inf)


def _pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << (x - 1).bit_length()


@functools.partial(jax.jit, static_argnames=("dt",))
def _gather_mask_blocks(xj, safe, valid, *, dt):
    # fused gather+mask+cast: as separate eager ops the take output, the
    # masked product, and the cast each materialize corpus-sized buffers
    # (3x peak — OOM at config-E shard scale)
    g = jnp.take(xj, safe, axis=0).astype(dt)
    return g * valid.astype(dt)


@jax.jit
def _blocks_sq_of(blocks):
    # single fused reduce: no full f32 materialization
    return jnp.sum(jnp.square(blocks.astype(jnp.float32)), axis=-1)


@jax.jit
def _blocks_rowsum_of(blocks):
    return blocks.astype(jnp.float32).sum(axis=1)


@jax.jit
def _normalize_keep_dtype(x):
    # fused: eager astype(f32) -> normalize materializes TWO full f32
    # copies of the corpus (OOM at config-E shard scale); inside one jit
    # the chain fuses per-tile and only the same-dtype output allocates
    xf = x.astype(jnp.float32)
    n = jnp.sqrt(jnp.sum(xf * xf, axis=-1, keepdims=True))
    return (xf / jnp.maximum(n, 1e-12)).astype(x.dtype)


@jax.jit
def _all_finite(x):
    # fused reduce: the eager isfinite->all chain materializes a full
    # mask (and an astype copy) — at config-E shard scale that alone
    # exhausted HBM
    return jnp.isfinite(x.astype(jnp.float32)).all()


# ---------------------------------------------------------------------------
# jitted kernels (static shapes; one compile per (Q, p, k) bucket)
# ---------------------------------------------------------------------------


def _expand_blocks_body(blocks, blocks_sq, block_ids, q, q_sq, bids, *,
                        k: int, metric: Metric, allowed=None):
    """Score every row of each query's selected blocks, return top-k.

    blocks [B, S, d] (storage dtype), blocks_sq [B, S] f32,
    block_ids [B, S] int32 (-1 = dead/pad), q [Q, d] f32, bids [Q, p].
    Returns (scores [Q, k] f32 ascending, ids [Q, k] int32, -1 padded).

    The gather is *contiguous per block* (S*d elements per index), so it
    streams at HBM speed; scoring is one fused batched matmul.
    """
    Q, p = bids.shape
    S = blocks.shape[1]
    g = jnp.take(blocks, bids, axis=0)        # [Q, p, S, d]
    gsq = jnp.take(blocks_sq, bids, axis=0)   # [Q, p, S]
    ids = jnp.take(block_ids, bids, axis=0)   # [Q, p, S]
    # f32 storage: HIGHEST keeps f32-grade scores (DEFAULT runs f32 in
    # TF32 on the GPU's tensor cores and flips near-ties vs the exact
    # oracle); bf16 storage is already rounded, so DEFAULT costs nothing.
    prec = (jax.lax.Precision.DEFAULT if blocks.dtype == jnp.bfloat16
            else jax.lax.Precision.HIGHEST)
    dots = jnp.einsum(
        "qpsd,qd->qps", g, q.astype(blocks.dtype),
        preferred_element_type=jnp.float32, precision=prec,
    )
    if metric is Metric.L2:
        sc = jnp.maximum(q_sq[:, None, None] + gsq - 2.0 * dots, 0.0)
    else:  # IP / COSINE (pre-normalized)
        sc = -dots
    if allowed is not None:
        # device-side filtered scan (VERDICT r3 #5): disallowed slots
        # never survive, the same mechanism as dead/pad rows
        sc = jnp.where(jnp.take(allowed, bids, axis=0), sc, INF)
    flat_sc = jnp.where(ids < 0, INF, sc).reshape(Q, p * S)
    flat_ids = ids.reshape(Q, p * S)
    vals, sel = T.topk_smallest_fast(flat_sc, k)
    out_ids = jnp.where(
        jnp.isfinite(vals), jnp.take_along_axis(flat_ids, sel, axis=1), -1
    )
    return vals, out_ids


_expand_blocks = jax.jit(
    _expand_blocks_body, static_argnames=("k", "metric")
)


def _expand_blocks_2stage_body(blocks_score, blocks_sq, block_ids, flat_exact,
                               q, q_sq, bids, *, k: int, rerank: int,
                               metric: Metric, score_scale=None,
                               allowed=None):
    """Two-stage block expansion: bf16/int8 scan + exact rerank.

    Stage 1 scores the selected blocks from a reduced-precision copy
    (bf16 = HALF the HBM traffic of the f32 scan; int8 with
    ``score_scale`` = a QUARTER — the scan is
    bandwidth-bound, so bytes are QPS) and keeps the best ``rerank``
    rows per query by approximate top-k. Stage 2 re-scores only those
    rows from the exact storage (``flat_exact`` [B*S, d], a free reshape
    of the f32 blocks) and returns the exact-grade top-k — the same
    scan-then-rerank shape as FlatIndex's default path (flat.py),
    applied per probed block set.

    blocks_score [B, S, d] bf16 or int8; bids [Q, p] block ids per
    query; score_scale [B] per-block dequant factors (int8 only).
    """
    Q, p = bids.shape
    S = blocks_score.shape[1]
    dp = blocks_score.shape[2]
    qp = q
    if dp != q.shape[1]:  # scoring copy is lane-padded (zeros: dots keep)
        qp = jnp.pad(q, ((0, 0), (0, dp - q.shape[1])))
    g = jnp.take(blocks_score, bids, axis=0)  # [Q, p, S, dp]
    gsq = jnp.take(blocks_sq, bids, axis=0)
    ids = jnp.take(block_ids, bids, axis=0)
    if score_scale is not None:
        # symmetric per-query quantization of q onto the int8 path;
        # dots dequantize by (q scale x per-block scale)
        q_amax = jnp.maximum(jnp.max(jnp.abs(qp), axis=1), 1e-30)  # [Q]
        q_scl = q_amax / 127.0
        q8 = jnp.clip(
            jnp.round(qp / q_scl[:, None]), -127, 127
        ).astype(jnp.int8)
        dots_i = jnp.einsum(
            "qpsd,qd->qps", g, q8, preferred_element_type=jnp.int32
        )
        b_scl = jnp.take(score_scale, bids, axis=0)  # [Q, p]
        dots = dots_i.astype(jnp.float32) * (
            q_scl[:, None, None] * b_scl[:, :, None]
        )
    else:
        dots = jnp.einsum(
            "qpsd,qd->qps", g, qp.astype(blocks_score.dtype),
            preferred_element_type=jnp.float32,
        )
    if metric is Metric.L2:
        sc = jnp.maximum(q_sq[:, None, None] + gsq - 2.0 * dots, 0.0)
    else:
        sc = -dots
    if allowed is not None:
        # filtered scan: mask stage 1 so survivors are allowed rows; the
        # short-fill guard below re-masks stage 2 (when fewer than r
        # allowed rows exist, top-r still returns disallowed positions)
        sc = jnp.where(jnp.take(allowed, bids, axis=0), sc, INF)
    flat_sc = jnp.where(ids < 0, INF, sc).reshape(Q, p * S)
    r = min(rerank, p * S)
    _, sel = T.topk_smallest_fast(flat_sc, r)          # [Q, r] positions
    # positions -> storage slots (block*S + s) -> exact rows
    blk = jnp.take_along_axis(bids, sel // S, axis=1)  # [Q, r]
    slots = blk * S + sel % S
    cand_ids = jnp.take_along_axis(ids.reshape(Q, p * S), sel, axis=1)
    v = jnp.take(flat_exact, slots, axis=0)            # [Q, r, d]
    dots2 = jnp.einsum(
        "qrd,qd->qr", v.astype(jnp.float32), q,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    if metric is Metric.L2:
        vsq = jnp.sum(v.astype(jnp.float32) ** 2, axis=-1)
        sc2 = jnp.maximum(q_sq[:, None] + vsq - 2.0 * dots2, 0.0)
    else:
        sc2 = -dots2
    sc2 = jnp.where(cand_ids < 0, INF, sc2)
    if allowed is not None:
        al1 = jnp.take_along_axis(
            jnp.take(allowed, bids, axis=0).reshape(Q, p * S), sel, axis=1)
        sc2 = jnp.where(al1, sc2, INF)
    vals, sel2 = T.topk_smallest(sc2, k)
    out_ids = jnp.where(
        jnp.isfinite(vals), jnp.take_along_axis(cand_ids, sel2, axis=1), -1
    )
    return vals, out_ids


_expand_blocks_2stage = jax.jit(
    _expand_blocks_2stage_body, static_argnames=("k", "rerank", "metric")
)


@functools.partial(
    jax.jit,
    static_argnames=("k", "probes", "rerank", "metric", "two_stage",
                     "to_distance"),
)
def _serve_exact(blocks, blocks_score, blocks_sq, block_ids, centroids,
                 c_sq, n_blocks, q, score_scale=None, allowed=None, *,
                 k: int, probes: int,
                 rerank: int, metric: Metric, two_stage: bool,
                 to_distance: bool = False):
    """The whole exact-routing serving step as ONE compiled program:
    query norms -> centroid routing -> block expansion (+rerank).

    One dispatch per batch instead of four-to-six: per-dispatch host
    latency would otherwise leave the device idle between stages.
    """
    q = q.astype(jnp.float32)
    q_sq = D.squared_norms(q)
    with jax.named_scope("route"):
        bids = _route_exact_body(centroids, c_sq, q, q_sq, n_blocks,
                                 p=probes, metric=metric)
    with jax.named_scope("expand"):
        if two_stage:
            sc, ids = _expand_blocks_2stage_body(
                blocks_score, blocks_sq, block_ids,
                blocks.reshape(-1, blocks.shape[-1]), q, q_sq, bids,
                k=k, rerank=rerank, metric=metric, score_scale=score_scale,
                allowed=allowed,
            )
        else:
            sc, ids = _expand_blocks_body(
                blocks, blocks_sq, block_ids, q, q_sq, bids, k=k,
                metric=metric, allowed=allowed,
            )
    if to_distance:
        # operator units computed in-program: an eager conversion after
        # the dispatch would add one more dispatch per batch
        sc = D.score_to_distance(sc, metric)
    return sc, ids


def _route_exact_body(centroids, c_sq, q, q_sq, n_blocks, *, p: int,
                      metric: Metric):
    """Exact top-p blocks per query: one [Q, B] matmul + top_k.

    Semantically the ef=B degenerate case of the centroid-graph beam
    search — exact routing, used when B is small enough that the scan is
    cheaper than traversal. ``n_blocks`` masks padded centroid rows.
    """
    dots = jax.lax.dot_general(
        q.astype(centroids.dtype), centroids.T, (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    if metric is Metric.L2:
        sc = q_sq[:, None] + c_sq[None, :] - 2.0 * dots
    else:
        sc = -dots
    cols = jax.lax.broadcasted_iota(jnp.int32, sc.shape, 1)
    sc = jnp.where(cols < n_blocks, sc, INF)
    _, bids = T.topk_smallest_fast(sc, p)
    return bids


_route_exact = jax.jit(
    _route_exact_body, static_argnames=("p", "metric")
)


@functools.partial(jax.jit, static_argnames=("p", "metric"))
def _route_exact_sorted(centroids, c_sq, q, q_sq, n_blocks, *, p: int,
                        metric: Metric):
    """Exact FULLY-SORTED top-p block ranking (lax.top_k, no approx).

    Prefix-consistent: the first j columns at any p equal the ranking at
    p=j, so iterative scans can expand incremental column slices without
    re-scanning blocks (approx_min_k does not guarantee this)."""
    dots = jax.lax.dot_general(
        q.astype(centroids.dtype), centroids.T, (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    if metric is Metric.L2:
        sc = q_sq[:, None] + c_sq[None, :] - 2.0 * dots
    else:
        sc = -dots
    cols = jax.lax.broadcasted_iota(jnp.int32, sc.shape, 1)
    sc = jnp.where(cols < n_blocks, sc, INF)
    _, bids = T.topk_smallest(sc, p)
    return bids


@functools.partial(jax.jit, static_argnames=("k", "metric"))
def _scan_tail(tail, tail_sq, tail_ids, q, q_sq, allowed_tail=None, *,
               k: int, metric: Metric):
    """Exact scan of the spill tail [T, d] (T is small)."""
    dots = jax.lax.dot_general(
        q.astype(tail.dtype), tail.T, (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    if metric is Metric.L2:
        sc = jnp.maximum(q_sq[:, None] + tail_sq[None, :] - 2.0 * dots, 0.0)
    else:
        sc = -dots
    sc = jnp.where((tail_ids < 0)[None, :], INF, sc)
    if allowed_tail is not None:
        sc = jnp.where(allowed_tail[None, :], sc, INF)
    kk = min(k, tail.shape[0])
    vals, sel = T.topk_smallest(sc, kk)
    ids = jnp.where(jnp.isfinite(vals), jnp.take(tail_ids, sel), -1)
    if kk < k:
        vals = jnp.pad(vals, ((0, 0), (0, k - kk)), constant_values=jnp.inf)
        ids = jnp.pad(ids, ((0, 0), (0, k - kk)), constant_values=-1)
    return vals, ids


def _scan_all_body(blocks, blocks_score, blocks_sq, block_ids,
                   quantized: bool, qj, *, k: int, rerank: int,
                   metric: Metric, allowed_slots=None):
    """Exhaustive exact scan over a blocked store, streamed: the scoring
    copy (or, for an int8 copy whose per-block scales the flat streamer
    does not know, the exact blocks) is scanned once for ALL queries,
    candidates are re-scored exactly, and slot positions map to ids
    through ``block_ids``. The per-query gather expansion would read
    Q x corpus bytes instead. Returns raw scores and ids ([Q, k])."""
    from tpu_hnsw.index import flat as FL

    d = blocks.shape[-1]
    scan_src = blocks if quantized else blocks_score
    dp = scan_src.shape[2]
    qp = qj if dp == qj.shape[1] else jnp.pad(
        qj, ((0, 0), (0, dp - qj.shape[1]))
    )
    cand = max(4 * k, rerank)
    valid = block_ids >= 0
    if allowed_slots is not None:
        valid = valid & allowed_slots
    # DEFAULT precision: an f32 scan runs in TF32 on the GPU's tensor
    # cores; the exact f32 rerank below restores the final order
    _, pos = FL._stream_search(
        qp, scan_src, blocks_sq, valid,
        cand, metric, jax.lax.Precision.DEFAULT, True,
    )
    flat_ids = block_ids.reshape(-1)
    bad = pos < 0
    v = jnp.take(blocks.reshape(-1, d), jnp.clip(pos, 0, None), axis=0,
                 mode="clip")
    sc2 = D.batched_scores(qj, v.astype(jnp.float32), metric)
    sc2 = jnp.where(bad, INF, sc2)
    vals, sel = T.topk_smallest(sc2, k)
    cand_ids = jnp.take(flat_ids, jnp.clip(pos, 0, None), mode="clip")
    cand_ids = jnp.where(bad, -1, cand_ids)
    ids = jnp.take_along_axis(cand_ids, sel, axis=1)
    return vals, jnp.where(jnp.isfinite(vals), ids, -1)


# ---------------------------------------------------------------------------
# balanced block assignment
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("t",))
def _top_blocks_chunk(x, x_sq, cents, c_sq, *, t: int):
    """Top-t nearest block centroids per row (L2): [chunk, t] ids+dists."""
    dots = jax.lax.dot_general(
        x, cents.T, (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    sc = x_sq[:, None] + c_sq[None, :] - 2.0 * dots
    return T.topk_smallest_fast(sc, t)


@functools.partial(jax.jit, static_argnames=("t",))
def _top_blocks_chunk_masked(x, x_sq, cents, c_sq, full, *, t: int):
    """_top_blocks_chunk over only blocks with free capacity (``full``
    bool [B] masks exhausted blocks to +inf) — the retry pass."""
    dots = jax.lax.dot_general(
        x, cents.T, (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    sc = x_sq[:, None] + c_sq[None, :] - 2.0 * dots
    sc = jnp.where(full[None, :], INF, sc)
    return T.topk_smallest_fast(sc, t)


@functools.partial(jax.jit, static_argnames=("B",), donate_argnums=(2, 3))
def _assign_rounds_device(cand_i, cand_d, assign, free, *, B: int):
    """Device-side capacity-greedy rounds (same semantics as the host
    C++ greedy in cpp/io_native.cpp: round r ranks each block's round-r
    proposals by distance and accepts up to remaining capacity, ties
    arbitrary).

    Why on device: the native greedy is host time that varies with host
    load, and the candidate matrix would otherwise travel to the host.
    Here the per-round rank-within-block is a lexicographic device sort
    (block, dist) + searchsorted, and nothing leaves device memory.
    """
    n, t = cand_i.shape
    iota = jnp.arange(n, dtype=jnp.int32)
    for r in range(t):  # t is static (<= 8): unrolled rounds
        unas = assign < 0
        ok_cand = unas & jnp.isfinite(cand_d[:, r])
        blk = jnp.where(ok_cand, cand_i[:, r].astype(jnp.int32), B)
        dist = jnp.where(ok_cand, cand_d[:, r].astype(jnp.float32), INF)
        sb, _, rows = jax.lax.sort((blk, dist, iota), num_keys=2)
        starts = jnp.searchsorted(sb, jnp.arange(B, dtype=jnp.int32))
        sbc = jnp.clip(sb, 0, B - 1)
        rank = iota - starts[sbc].astype(jnp.int32)
        acc = (sb < B) & (rank < free[sbc])
        # accepted rows move -1 -> block id; .max never regresses an
        # already-assigned row (each row is proposed at most once/round)
        assign = assign.at[rows].max(jnp.where(acc, sb, -1))
        free = free - jax.ops.segment_sum(
            acc.astype(jnp.int32), sbc, num_segments=B
        )
    return assign, free


@functools.partial(jax.jit, static_argnames=("B",))
def _leftover_fill_device(assign, free, *, B: int):
    """Distance-agnostic fill of rows whose every candidate block filled
    (the host path's ``slots = repeat(arange(B), free)`` in device form:
    pending-rank -> first block whose cumulative free covers it)."""
    unas = assign < 0
    pr = jnp.cumsum(unas.astype(jnp.int32)) - 1
    cumfree = jnp.cumsum(free)
    blk = jnp.searchsorted(cumfree, pr, side="right").astype(jnp.int32)
    can = unas & (pr < cumfree[B - 1])
    return jnp.where(can, jnp.clip(blk, 0, B - 1), assign)


@functools.partial(jax.jit, static_argnames=("S", "B"))
def _pack_block_ids_device(assign, *, S: int, B: int):
    """[n] block assignment -> [B, S] member-id table, on device (the
    np.argsort/scatter pack without the 4B*B*S host round-trip)."""
    n = assign.shape[0]
    order = jnp.argsort(assign)
    a_sorted = jnp.take(assign, order)
    starts = jnp.searchsorted(a_sorted, jnp.arange(B, dtype=a_sorted.dtype))
    pos = jnp.arange(n, dtype=jnp.int32) - starts[
        jnp.clip(a_sorted, 0, B - 1)
    ].astype(jnp.int32)
    ok = (a_sorted >= 0) & (pos >= 0) & (pos < S)
    idx = jnp.where(ok, a_sorted.astype(jnp.int32) * S + pos, B * S)
    flat = jnp.full((B * S + 1,), -1, jnp.int32)  # last slot = dump
    flat = flat.at[idx].set(order.astype(jnp.int32))
    return flat[: B * S].reshape(B, S)


def _balanced_assign_device(xj: jax.Array, centroids, S: int, B: int,
                            t: int = 8) -> tuple[jax.Array, dict]:
    """:func:`_balanced_assign` with every stage on device: top-t scoring
    (chunked matmuls), greedy rounds, two retry passes against
    still-open blocks, leftover fill. Only two *scalar* counters are
    fetched (retried/leftover rows, stats parity with the host path);
    the [n, t] candidate matrix and the assignment never leave the
    device.
    """
    import time as _time

    t0 = _time.perf_counter()
    n = xj.shape[0]
    d_orig = xj.shape[1]
    dp = ((d_orig + 127) // 128) * 128
    cj = jnp.asarray(centroids, jnp.float32)
    if dp != d_orig:  # lane-pad the matmul operands (see host path)
        xj = jnp.pad(xj, ((0, 0), (0, dp - d_orig)))
        cj = jnp.pad(cj, ((0, 0), (0, dp - d_orig)))
    c_sq = jnp.sum(cj * cj, axis=-1)
    step = min(1 << 17, max(4096, _pow2((1 << 29) // max(B, 1))))
    tt = min(t, B)

    def score_all(full):
        ds, is_ = [], []
        for s in range(0, n, step):
            xb = xj[s : s + step].astype(jnp.float32)
            xsq = jnp.sum(xb * xb, axis=-1)
            if full is None:
                d_, i_ = _top_blocks_chunk(xb, xsq, cj, c_sq, t=tt)
            else:
                d_, i_ = _top_blocks_chunk_masked(xb, xsq, cj, c_sq, full,
                                                  t=tt)
            ds.append(d_)
            is_.append(i_)
        return jnp.concatenate(ds), jnp.concatenate(is_)

    cand_d, cand_i = score_all(None)
    jax.block_until_ready(cand_d)
    t1 = _time.perf_counter()
    assign = jnp.full((n,), -1, jnp.int32)
    free = jnp.full((B,), S, jnp.int32)
    assign, free = _assign_rounds_device(cand_i, cand_d, assign, free, B=B)
    retried = int(jnp.sum(assign < 0))  # scalar fetch (stats + loop exit)
    left = retried
    for _retry in range(3):  # host-path parity: 3 rounds leave ~none
        if left == 0:
            break
        # retry: re-rank pending rows against only still-open blocks.
        # Scoring runs over all rows (static shapes; assigned rows are
        # masked inside the rounds) — a full [n, B] matmul is cheaper
        # than a dynamic-shape recompile.
        rd, ri = score_all(free <= 0)
        assign, free = _assign_rounds_device(ri, rd, assign, free, B=B)
        left = int(jnp.sum(assign < 0))
    if left:
        assign = _leftover_fill_device(assign, free, B=B)
    jax.block_until_ready(assign)
    stats = {
        "assign_topk_s": round(t1 - t0, 3),
        "assign_greedy_s": round(_time.perf_counter() - t1, 3),
        "assign_retried_rows": retried,
        "assign_leftover_rows": left,
        "assign_mode": "device",
    }
    return assign, stats




def _make_score_copy(
    blocks: jax.Array,
) -> tuple[jax.Array, jax.Array | None]:
    """LANE-PADDED scoring copy of the blocks: bf16 (default) or int8
    (``TPU_HNSW_SCORE_DTYPE=int8``). Returns ``(copy, scale)``; scale is
    None for bf16 and the per-block dequant factor ``[B]`` for int8.

    bf16 halves stage-1 scan traffic (the exact top-k is restored by the
    rerank stage); int8 halves it AGAIN, with
    per-block symmetric quantization (x8 = round(x / scale_b),
    scale_b = max|block| / 127) so the error scales with each block's
    own range — the exact-norm L2 form then only carries the error in
    the cross term. Padding d to a multiple of 128 lanes keeps the block
    gather tile-aligned (whether the GPU needs it is an open question,
    ROADMAP 1.5). Zero padding changes neither dots nor norms. When
    storage is already bf16 lane-aligned the bf16 copy aliases the
    blocks.
    """
    B, S, d = blocks.shape
    dp = ((d + 127) // 128) * 128
    # int8 default: per-block scales + exact rerank measured
    # recall-identical to bf16 (0.9763 at 1M/probes=8) at half the copy
    # bytes; TPU_HNSW_SCORE_DTYPE=bf16 reverts
    if os.environ.get("TPU_HNSW_SCORE_DTYPE", "int8") == "int8":
        bf = blocks.astype(jnp.float32)
        absmax = jnp.max(jnp.abs(bf), axis=(1, 2))  # [B]
        scale = jnp.maximum(absmax, 1e-30) / 127.0
        q = jnp.clip(
            jnp.round(bf / scale[:, None, None]), -127, 127
        ).astype(jnp.int8)
        if dp != d:
            q = jnp.pad(q, ((0, 0), (0, 0), (0, dp - d)))
        return q, scale
    if blocks.dtype == jnp.bfloat16 and dp == d:
        return blocks, None
    out = blocks.astype(jnp.bfloat16)
    if dp != d:
        out = jnp.pad(out, ((0, 0), (0, 0), (0, dp - d)))
    return out, None


def _greedy_rounds(cand_i: np.ndarray, cand_d: np.ndarray, B: int,
                   assign: np.ndarray, free: np.ndarray,
                   row_ids: np.ndarray) -> np.ndarray:
    """Capacity-greedy rounds over top-t candidates; mutates assign/free.

    ``row_ids`` maps candidate rows to global rows. Returns the global
    rows still unassigned after all t rounds. Uses the native C++ pass
    (cpp/io_native.cpp balanced_assign_greedy — the numpy lexsort rounds
    are the 10M-scale build's host bottleneck) with a pure-numpy
    fallback.
    """
    from tpu_hnsw.io import native as NI

    sub = np.full(len(row_ids), -1, np.int64)
    got = NI.balanced_assign_greedy_native(
        np.ascontiguousarray(cand_i, np.int32),
        # NaN (invalid input caught by build's deferred finite check)
        # would break std::sort's strict weak ordering — map to +inf
        np.ascontiguousarray(np.nan_to_num(cand_d, nan=np.inf), np.float32),
        B, sub, free,
    )
    if got is not None:
        done = sub >= 0
        assign[row_ids[done]] = sub[done]
        return row_ids[~done]
    pending = np.arange(len(row_ids))
    for r in range(cand_i.shape[1]):
        if pending.size == 0:
            break
        blk = cand_i[pending, r].astype(np.int64)
        dist = cand_d[pending, r]
        order = np.lexsort((dist, blk))
        blk_s = blk[order]
        # rank of each point within its block group this round
        first = np.searchsorted(blk_s, blk_s)
        rank = np.arange(len(blk_s)) - first
        take = rank < free[blk_s]
        assign[row_ids[pending[order[take]]]] = blk_s[take]
        np.subtract.at(free, blk_s[take], 1)
        # (free can transiently over-count for blocks hit by few points;
        # rank<free uses the pre-round value, which is exact because each
        # point appears once per round)
        pending = pending[order[~take]]
    return row_ids[pending]


def _balanced_assign(x: np.ndarray, centroids: np.ndarray, S: int,
                     B: int, t: int = 8,
                     xj: jax.Array | None = None
                     ) -> tuple[np.ndarray, dict]:
    """Assign each row to a block of capacity S, preferring near blocks.

    Greedy rounds over each point's top-t centroid choices: round r takes,
    for every block, its closest still-unassigned r-th-choice points up to
    remaining capacity (ties to distance). Leftovers (capacity exhausted
    at all t choices) fill blocks with free slots in distance-agnostic
    order — rare when B*S has slack over n.

    Returns (block id per row [n], stage-timing stats). Host-side but
    fully vectorized (argsort rounds); the top-t candidate matrix comes
    from device matmuls.
    """
    import time as _time

    t0 = _time.perf_counter()
    if xj is None:
        xj = jnp.asarray(x)
    n = xj.shape[0]
    d_orig = xj.shape[1]
    dp = ((d_orig + 127) // 128) * 128
    if dp != d_orig:
        # lane-pad the top-k matmul operands (4-6x on misaligned dims)
        xj = jnp.pad(xj, ((0, 0), (0, dp - d_orig)))
        centroids = np.pad(centroids, ((0, 0), (0, dp - d_orig)))
    cj = jnp.asarray(centroids)
    c_sq = jnp.sum(cj * cj, axis=-1)
    # chunk size bounds the [step, B] score intermediate to ~2GB so huge
    # block counts (graph-routing scale, B > 100k) still fit HBM
    step = min(1 << 17, max(4096, _pow2((1 << 29) // max(B, 1))))
    small_ids = B <= 65535  # ids travel to the host as uint16
    devs = []
    for s in range(0, n, step):
        # per-chunk f32 view: bf16 storage stays bf16 at rest; the
        # distance matmul needs matching dtypes and f32-grade norms
        xb = xj[s : s + step].astype(jnp.float32)
        d, i = _top_blocks_chunk(
            xb, jnp.sum(xb * xb, -1), cj, c_sq, t=min(t, B)
        )
        # f16 dists / uint16 ids: 32MB instead of 48MB at 1M x t=8 to
        # the host; ordering survives (greedy rounds only compare
        # distances within one block group). Dispatch EVERYTHING
        # before fetching anything: per-chunk np.asarray serialized
        # device compute behind each host fetch.
        devs.append((d.astype(jnp.float16),
                     i.astype(jnp.uint16) if small_ids else i))
    cand_d = np.concatenate([np.asarray(d) for d, _ in devs])   # [n, t]
    cand_i = np.concatenate([np.asarray(i) for _, i in devs]).astype(np.int32)
    t1 = _time.perf_counter()
    assign = np.full(n, -1, np.int64)
    free = np.full(B, S, np.int64)
    pending = _greedy_rounds(cand_i, cand_d, B, assign, free, np.arange(n))
    t_native0 = _time.perf_counter() - t1  # first native pass, no device IO
    # retry pass: rows whose top-t blocks all filled re-rank against only
    # the blocks that still have capacity (one masked matmul over pending
    # rows — measured ~10% of 1M rows leftover without it, each a
    # probe-independent recall miss); then the same greedy rounds.
    retried = int(pending.size)
    for _retry in range(3):  # free blocks fill during a retry round too;
        # loop until placed (measured: one round left 31k of 1M unplaced,
        # three leave ~none) — each leftover is a probe-independent miss
        if pending.size == 0 or not (free > 0).any():
            break
        full = jnp.asarray(free <= 0)
        m = int(pending.size)
        # pow2-pad the pending gather: ragged chunk shapes would compile a
        # fresh program per retry round
        mp = _pow2(m)
        pj = jnp.asarray(np.pad(pending, (0, mp - m)))
        rdevs = []
        for sidx in range(0, mp, step):
            xb = jnp.take(xj, pj[sidx : sidx + step], axis=0).astype(
                jnp.float32
            )
            d, i = _top_blocks_chunk_masked(
                xb, jnp.sum(xb * xb, -1), cj, c_sq, full, t=min(t, B)
            )
            rdevs.append((d.astype(jnp.float16),
                          i.astype(jnp.uint16) if small_ids else i))
        pending = _greedy_rounds(
            np.concatenate(
                [np.asarray(i) for _, i in rdevs]
            )[:m].astype(np.int32),
            np.concatenate([np.asarray(d) for d, _ in rdevs])[:m],
            B, assign, free, pending,
        )
    leftovers = int(pending.size)
    if pending.size:
        slots = np.repeat(np.arange(B), free)  # leftover capacity, in order
        assign[pending] = slots[: pending.size]
    stats = {
        "assign_topk_s": round(t1 - t0, 3),
        "assign_greedy_s": round(_time.perf_counter() - t1, 3),
        # sub-split so a slow record run explains itself: native_s is the
        # pure host C++ greedy (no device IO); the remainder of greedy_s
        # is retry-round device dispatch + host fetches
        "assign_greedy_native_s": round(t_native0, 3),
        "assign_retried_rows": retried,
        # rows that exhausted even the retry pass and were placed
        # distance-agnostically — each is a probe-independent recall miss
        "assign_leftover_rows": leftovers,
    }
    return assign, stats


class BlockHnswIndex:
    """HNSW index with cluster-blocked level 0 (see module docstring).

    config.m / ef_construction apply to the centroid graph (the upper
    levels); ``block_size`` is the level-0 granularity. ``routing``:
    "exact" (centroid scan), "graph" (HNSW beam over centroids), or
    "auto" (exact while B <= exact_routing_max, else graph).
    """

    EXACT_ROUTING_MAX = 65536
    # above this block count, probes >= n_blocks streams the whole
    # store once instead of per-query gather expansion
    EXHAUSTIVE_SCAN_MIN_BLOCKS = 2048

    @classmethod
    def exhaustive(cls, probes: int, n_blocks: int) -> bool:
        """Whether a search probing ``probes`` of ``n_blocks`` blocks
        streams the whole store once for all queries; the host loop and
        the sharded program both ask here, so they pick the same one."""
        return probes >= n_blocks and n_blocks > cls.EXHAUSTIVE_SCAN_MIN_BLOCKS

    def __init__(
        self,
        config: HnswConfig,
        block_size: int = 256,
        routing: str = "auto",
        block_slack: float = 1.05,
    ):
        if routing not in ("auto", "exact", "graph"):
            raise ValueError("routing must be auto|exact|graph")
        if config.metric not in (Metric.L2, Metric.IP, Metric.COSINE):
            raise ValueError(f"{config.metric} unsupported by BlockHnswIndex")
        self.cfg = config
        self.block_size = int(block_size)
        self.routing = routing
        # two-stage scan (bf16 score + exact rerank) for f32 storage;
        # rerank_width rows per query survive stage 1
        self.two_stage = True
        self.rerank_width = 40
        # packing slack (see _pack): at exact capacity the balanced
        # packer strands rows in arbitrary leftover blocks — a probe-
        # independent recall floor. Raise for sharply clustered corpora
        # where cluster mass >> block capacity forces cross-cluster
        # spill (config-E geometry: the r5 shard experiment measured
        # the spill fraction as the recall ceiling).
        self.block_slack = float(block_slack)
        self.n = 0            # live rows (excl. deleted)
        self.n_total = 0      # rows ever placed (incl. deleted, excl. tail)
        self.n_blocks = 0
        # device state
        self.blocks = None        # [B_pad, S, d] storage dtype
        self.blocks_sq = None     # [B_pad, S] f32
        self.block_ids = None     # [B_pad, S] int32, -1 = dead/pad
        self.score_scale = None   # [B] f32 per-block dequant (int8 copy)
        self.centroids = None     # [B_pad, d] storage dtype
        self.centroids_sq = None  # [B_pad] f32
        self.centroid_index: HnswIndex | None = None
        # host state
        self._slot_of = None      # np [n_ids] -> flat slot (block*S + s), -1 if in tail
        # spill tail (inserts since last compact)
        self.tail_n = 0       # high-water mark (next free tail slot)
        self.tail_live = 0    # live (non-tombstoned) tail rows
        self._tail_cap = 0
        self.tail = None          # [T_pad, d]
        self.tail_sq = None
        self.tail_ids = None      # [T_pad] int32, -1 pad

    # ------------------------------------------------------------------ util
    @property
    def size(self) -> int:
        return self.n + self.tail_live

    @property
    def dtype(self):
        return jnp.bfloat16 if self.cfg.dtype == "bfloat16" else jnp.float32

    def _prep(self, data) -> np.ndarray:
        x = np.asarray(data, dtype=np.float32)
        if x.ndim == 1:
            x = x[None, :]
        if x.shape[1] != self.cfg.dim:
            raise ValueError(
                f"expected {self.cfg.dim} dimensions, not {x.shape[1]}"
            )
        if not np.isfinite(x).all():
            raise ValueError("NaN or infinity values are not allowed")
        if self.cfg.metric.needs_normalized:
            nrm = np.linalg.norm(x, axis=1, keepdims=True)
            x = x / np.maximum(nrm, 1e-12)
        return x

    def _use_graph_routing(self) -> bool:
        if self.routing == "graph":
            return True
        if self.routing == "exact":
            return False
        return self.n_blocks > self.EXACT_ROUTING_MAX

    #: stage-1 candidate rows per unit of ef_search. Anchored so the
    #: default S=256 reproduces the tuned ceil(ef/4)-blocks mapping
    #: (64*ef/256 blocks); at other block sizes the same ROWS-per-ef
    #: budget holds instead of silently scanning a different corpus
    #: fraction (VERDICT r3 weak #7).
    ROWS_PER_EF = 64

    def probes_for_ef(self, ef_search: int) -> int:
        """Map the ef_search GUC onto a block-probe count.

        ef_search bounds the classical level-0 candidate pool; with
        blocked level 0 the pool is ``probes`` whole blocks. The mapping
        targets ``ROWS_PER_EF`` scanned rows per unit of ef — a
        per-index computation from the actual block size, so an ef sweep
        covers the same corpus fraction at any S. The ``block_slack``
        factor keeps coverage constant under slack (slack adds blocks
        without adding rows).
        """
        p = math.ceil(self.ROWS_PER_EF * ef_search / self.block_size)
        p += int((self.block_slack - 1) * p + 0.5)  # slack compensation
        return max(1, min(p, self.n_blocks))

    # ----------------------------------------------------------------- build
    def build(self, data, kmeans_iters: int = 10,
              device_data: jax.Array | None = None) -> "BlockHnswIndex":
        """CREATE INDEX analogue. k-means + pack + centroid-graph build.

        ``device_data`` (optional, [n, d] on device) skips the host
        round-trip when the caller already holds device-resident vectors.

        Per-stage wall times land in ``self.build_stats`` (the
        pg_stat_progress_create_index phase breakdown analogue — SURVEY
        §5 build progress; the stage split steers build-throughput work).
        """
        import time as _time

        t0 = _time.perf_counter()
        if device_data is not None or isinstance(data, jax.Array):
            # fully device-resident build: validation/normalization run on
            # device and NOTHING round-trips the base through the host
            # (production ingest is accelerator-resident embeddings)
            xj = device_data if device_data is not None else data
            if xj.ndim != 2 or xj.shape[1] != self.cfg.dim:
                raise ValueError(
                    f"expected {self.cfg.dim} dimensions, not "
                    f"{xj.shape[-1] if xj.ndim else 0}"
                )
            # bf16-storage builds stay in bf16 end-to-end: a whole-array
            # f32 cast of a config-E shard (25M x 512d) is 51GB — most of
            # one card's memory. Per-chunk compute still runs f32.
            xj = xj.astype(
                self.dtype if self.dtype == jnp.bfloat16 else jnp.float32
            )
            # dispatched now, CHECKED at the end of build: a bool() sync
            # here serializes the pipeline behind whatever is in the
            # device queue
            finite = _all_finite(xj)
            if self.cfg.metric.needs_normalized:
                xj = _normalize_keep_dtype(xj)
            x = None
            n = int(xj.shape[0])
            pipe_stats = {}
        else:
            x = self._prep(data)
            n = x.shape[0]
            finite = None
            xj, pre_cents, pipe_stats = self._upload_pipelined(
                x, kmeans_iters)
        t1 = _time.perf_counter()
        if n == 0:
            # CREATE INDEX on an empty table succeeds upstream; the
            # __init__ state is a valid empty index (adds spill to the
            # tail; the first compact() packs them into blocks)
            self.build_stats = {
                "prep_s": round(t1 - t0, 3), "cluster_pack_s": 0.0,
                "install_s": 0.0, "device_resident_input": x is None,
                "total_s": round(t1 - t0, 3), "vectors_per_sec": 0.0,
            }
            return self
        bids = self._pack(x, kmeans_iters, xj=xj, n=n,
                          centroids=(pre_cents if x is not None else None))
        t2 = _time.perf_counter()
        self._install_blocks(x, bids, n, xj=xj)
        jax.block_until_ready(self.blocks)
        if finite is not None and not bool(finite):
            raise ValueError("NaN or infinity values are not allowed")
        t3 = _time.perf_counter()
        self.build_stats = {
            "prep_s": round(t1 - t0, 3),
            "cluster_pack_s": round(t2 - t1, 3),
            "install_s": round(t3 - t2, 3),
            **getattr(self, "_pack_stats", {}),
            **getattr(self, "_install_stats", {}),
            **pipe_stats,
            "device_resident_input": x is None,
            "total_s": round(t3 - t0, 3),
            "vectors_per_sec": round(n / max(t3 - t0, 1e-9), 1),
        }
        return self

    #: host inputs at least this many bytes take the pipelined upload
    PIPELINE_UPLOAD_MIN_BYTES = 1 << 26  # 64 MB

    def _upload_pipelined(self, x: np.ndarray, kmeans_iters: int):
        """Chunked host->device upload overlapped with k-means
        (VERDICT r3 #6: the r3 host-input build serialized one blocking
        512MB jnp.asarray BEFORE any device work, so the link and the
        k-means compute never overlapped).

        Order of operations is the overlap: (1) the k-means SAMPLE is
        device_put first, (2) the corpus chunks are enqueued as async
        device_puts, (3) k-means compute on the sample dispatches
        immediately — it depends only on the first transfer, so the
        centroid iterations run WHILE the remaining chunks stream in,
        (4) the chunks concatenate on device (one device-memory pass) for
        the assignment stage. Returns (xj, centroids, stage stats);
        centroids is None for corpora below the pipeline threshold or
        single-block builds."""
        import math as _math
        import time as _time

        n = x.shape[0]
        S = self.block_size
        B = max(1, _math.ceil(n * self.block_slack / S))
        if n * x.shape[1] * 4 < self.PIPELINE_UPLOAD_MIN_BYTES or B == 1:
            return jnp.asarray(x), None, {}
        t0 = _time.perf_counter()
        samp_n = min(n, max(65536, 32 * B))
        rng = np.random.default_rng(self.cfg.seed)
        sample_host = (x[rng.choice(n, samp_n, replace=False)]
                       if samp_n < n else x)
        sample_dev = jax.device_put(sample_host)
        ch = max(1, (1 << 25) // max(x.shape[1] * 4, 1))  # ~32MB chunks
        parts = [jax.device_put(x[s0:s0 + ch]) for s0 in range(0, n, ch)]
        t1 = _time.perf_counter()
        centroids, _ = KM.kmeans(
            sample_dev, B, iters=kmeans_iters, seed=self.cfg.seed,
            sample=None, balance=True, assign_full=False,
        )
        t2 = _time.perf_counter()
        xj = jnp.concatenate(parts, axis=0) if len(parts) > 1 else parts[0]
        jax.block_until_ready(xj)
        t3 = _time.perf_counter()
        return xj, jnp.asarray(centroids), {
            "upload_enqueue_s": round(t1 - t0, 3),
            "kmeans_overlapped_s": round(t2 - t1, 3),
            "upload_drain_s": round(t3 - t2, 3),
            "pipelined_upload": True,
        }

    def _pack(self, x: np.ndarray | None, kmeans_iters: int = 10,
              xj: jax.Array | None = None,
              n: int | None = None,
              centroids: jax.Array | None = None) -> np.ndarray:
        """Cluster + capacity-balanced packing: [B, S] global ids (-1 pad).

        k-means proposes B centroids; :func:`_balanced_assign` places every
        row in a near block under the exact-S capacity, which keeps blocks
        spatially pure (the chop-a-sorted-stream alternative mixes cluster
        boundaries into blocks and measurably costs recall/probe).
        """
        import time as _time

        if n is None:
            n = x.shape[0]
        S = self.block_size
        # ~5% block slack: at exact capacity (B = ceil(n/S)) the balanced
        # packer has almost no free slots, so thousands of rows land in
        # arbitrary leftover blocks — a probe-independent recall floor
        # (measured: recall plateaued at ~0.975 on 1.18M regardless of
        # probes). The slack costs 5% memory/fill and removes the floor.
        B = max(1, math.ceil(n * self.block_slack / S))
        tk = _time.perf_counter()
        assign_stats = {}
        if B == 1:
            assign = np.zeros(n, np.int64)
            ta = tk
        else:
            if centroids is None:
                centroids, _ = KM.kmeans(
                    xj if x is None else x, B, iters=kmeans_iters,
                    seed=self.cfg.seed,
                    sample=min(n, max(65536, 32 * B)), balance=True,
                    assign_full=False,
                )
            ta = _time.perf_counter()
            if os.environ.get("TPU_HNSW_ASSIGN", "device") == "device":
                # device path (default): nothing leaves the device; the
                # host path (TPU_HNSW_ASSIGN=host, native C++ greedy) is
                # kept as the parity oracle
                if xj is None:
                    xj = jnp.asarray(x)
                assign_dev, assign_stats = _balanced_assign_device(
                    xj, centroids, S, B
                )
                tb = _time.perf_counter()
                self._pack_stats = {
                    "kmeans_s": round(ta - tk, 3),
                    "balanced_assign_s": round(tb - ta, 3),
                    **assign_stats,
                }
                return _pack_block_ids_device(assign_dev, S=S, B=B)
            assign, assign_stats = _balanced_assign(x, centroids, S, B, xj=xj)
        tb = _time.perf_counter()
        self._pack_stats = {
            "kmeans_s": round(ta - tk, 3),
            "balanced_assign_s": round(tb - ta, 3),
            **assign_stats,
        }
        order = np.argsort(assign, kind="stable")
        a_sorted = assign[order]
        first = np.searchsorted(a_sorted, np.arange(B))
        pos_within = np.arange(n) - first[a_sorted]
        block_ids = np.full((B, S), -1, np.int32)
        block_ids[a_sorted, pos_within] = order.astype(np.int32)
        return block_ids

    def _install_blocks(self, x: np.ndarray, block_ids: np.ndarray, n: int,
                        xj: jax.Array | None = None):
        """Device-install packed blocks + recomputed centroids + graph.

        x: [n, d] host f32 (already prepped); block_ids: [B, S] int32
        with -1 padding.
        """
        S = self.block_size
        B = block_ids.shape[0]
        if xj is None:
            xj = jnp.asarray(x)
        on_device = isinstance(block_ids, jax.Array)
        xp = jnp if on_device else np  # device-pack path: no host fetch
        safe = xp.where(block_ids < 0, 0, block_ids)
        valid = jnp.asarray((block_ids >= 0).reshape(-1, 1))
        # storage-dtype blocks FIRST, centroids from those: load() recomputes
        # centroids from the persisted blocks, so deriving them from the
        # same (possibly bf16-rounded) values keeps save/load bit-identical
        blocks = _gather_mask_blocks(
            xj, jnp.asarray(safe.reshape(-1)), valid, dt=self.dtype
        ).reshape(B, S, -1)
        # ---- recomputed per-block centroids (mean of live rows)
        counts = jnp.maximum(
            valid.reshape(B, S).astype(jnp.float32).sum(axis=1), 1.0
        )
        cents = _blocks_rowsum_of(blocks) / counts[:, None]
        self.blocks = blocks
        self.blocks_sq = _blocks_sq_of(blocks)
        self.blocks_score, self.score_scale = _make_score_copy(blocks)
        self.block_ids = jnp.asarray(block_ids)
        self.centroids = cents.astype(self.dtype)
        self.centroids_sq = jnp.sum(cents * cents, axis=-1)
        self.n_blocks = B
        # device-resident copy: an eager jnp.int32() per search_device
        # call would be one more host->device transfer per batch
        self._n_blocks_dev = jnp.int32(B)
        self.n = n
        self.n_total = n
        if on_device:
            # id->slot map built LAZILY (_ensure_slot): it exists only
            # for delete/add/save, and materializing it here would pull
            # B*S*4 bytes back to the host on every build
            self._slot_of = None
        else:
            slot = np.full(int(block_ids.max()) + 1 if n else 0, -1,
                           np.int64)
            flat = block_ids.reshape(-1)
            live = flat >= 0
            slot[flat[live]] = np.arange(B * S, dtype=np.int64)[live]
            self._slot_of = slot
        # ---- 3. upper levels: HNSW graph over block centroids — built
        # LAZILY (only graph routing traverses it; exact routing at
        # B <= EXACT_ROUTING_MAX never does, and building it is a sizable
        # share of a 1M build)
        self.centroid_index = None
        self._install_stats = {}
        if self._use_graph_routing():
            self._ensure_centroid_graph()
        self._reset_tail()

    def _ensure_centroid_graph(self) -> HnswIndex:
        """Build (once) the true HNSW graph over block centroids.

        Raw metric distances between centroids behave like the element
        metric (mean of cluster members), so the graph uses the same cfg
        but skips re-normalization (a centroid of normalized vectors is
        not unit-norm; the routing only needs the *ordering*, which IP
        gives).
        """
        if self.centroid_index is not None:
            return self.centroid_index
        import time as _time

        ccfg = HnswConfig(
            dim=self.cfg.dim,
            metric=(Metric.IP if self.cfg.metric is Metric.COSINE
                    else self.cfg.metric),
            m=self.cfg.m,
            ef_construction=self.cfg.ef_construction,
            dtype=self.cfg.dtype,
            wave_size=self.cfg.wave_size,
            descent_ef=self.cfg.descent_ef,
            seed=self.cfg.seed,
        )
        tg = _time.perf_counter()
        self.centroid_index = HnswIndex(ccfg, capacity=self.n_blocks)
        self.centroid_index.build(
            np.asarray(self.centroids, np.float32)[: self.n_blocks]
        )
        self._install_stats = {
            "centroid_graph_s": round(_time.perf_counter() - tg, 3),
        }
        return self.centroid_index

    def _reset_tail(self):
        self.tail_n = 0  # high-water mark (next free tail slot)
        self.tail_live = 0  # live (non-tombstoned) tail rows
        self._tail_cap = 0
        self.tail = None
        self.tail_sq = None
        self.tail_ids = None

    # ---------------------------------------------------------------- search
    def _route(self, x_host, qj, q_sq, probes: int, ef_route: int):
        if self._use_graph_routing():
            # HNSW beam over the centroid graph: ids are block indices
            self._ensure_centroid_graph()
            _, bids = self.centroid_index.search_device(
                x_host, k=probes,
                ef_search=min(max(ef_route, probes), 1000),
            )
            sent = self.centroid_index.graph.sentinel
            # a sentinel (missing) route entry repeats block 0: scoring a
            # block twice is harmless (duplicate candidates lose top-k ties)
            return jnp.where(bids == sent, 0, bids).astype(jnp.int32)
        return _route_exact(
            self.centroids, self.centroids_sq, qj, q_sq,
            self._n_blocks_dev, p=probes, metric=self.cfg.metric,
        )

    def _filter_device(self, filter_mask):
        """(allowed_slots [B, S], allowed_tail [T_pad] | None) device
        masks from a per-id filter (bool mask of length >= id space, or an
        id list). Cached by mask object identity so a serving loop passing
        the same mask per batch pays the conversion once (VERDICT r3 #5:
        the filter must not cost a host round-trip per batch)."""
        cache = getattr(self, "_filter_cache", None)
        key = (id(filter_mask), self.n_total, self.tail_n)
        if cache is not None and cache[0] == key:
            return cache[1], cache[2]
        self._ensure_slot()
        hi = max(len(self._slot_of) if self._slot_of is not None else 0, 1)
        m = np.asarray(filter_mask)
        full = np.zeros(hi, bool)
        if m.dtype == bool:
            ln = min(m.reshape(-1).shape[0], hi)
            full[:ln] = m.reshape(-1)[:ln]
        else:
            ids = m.reshape(-1).astype(np.int64)
            ids = ids[(ids >= 0) & (ids < hi)]
            full[ids] = True
        mdev = jnp.asarray(full)
        slots = jax.jit(
            lambda mk, bi: jnp.take(mk, jnp.clip(bi, 0), axis=0) & (bi >= 0)
        )(mdev, self.block_ids)
        tailm = None
        if self.tail_n and self.tail_ids is not None:
            tailm = jax.jit(
                lambda mk, ti: jnp.take(mk, jnp.clip(ti, 0)) & (ti >= 0)
            )(mdev, self.tail_ids)
        self._filter_cache = (key, slots, tailm)
        return slots, tailm

    def search_device(self, queries, k: int = 10, ef_search: int = 40,
                      probes: int | None = None, filter_mask=None):
        """Async device-resident search. Returns (distances, ids) device
        arrays in pgvector operator units; missing ids are -1.

        ``filter_mask`` (bool mask / id list over element ids) runs the
        filtered scan ON DEVICE: disallowed rows are masked in the
        expansion kernels like dead rows (see _expand_blocks_2stage_body),
        so filtering costs one fused mask gather instead of host-side
        post-filtering. Selective filters want wider ``probes``/``ef`` —
        see search_iterative for automatic widening."""
        validate_ef_search(max(ef_search, 1))
        if self.n_blocks == 0 and not self.tail_n:
            raise ValueError("index is empty")
        if probes is None:
            probes = self.probes_for_ef(max(ef_search, k))
        probes = max(1, min(probes, max(self.n_blocks, 1)))
        if isinstance(queries, jax.Array) and queries.ndim == 2:
            # device-resident queries: no host round-trip (serving batches
            # slice a resident device array). Validation (finite, dims) is the
            # caller's job on this path.
            if queries.shape[1] != self.cfg.dim:
                raise ValueError(
                    f"expected {self.cfg.dim} dimensions, not "
                    f"{queries.shape[1]}"
                )
            qj = queries.astype(jnp.float32)
            if self.cfg.metric.needs_normalized:
                qj = D.l2_normalize(qj)
            nq = qj.shape[0]
            qpad = _pow2(nq)
            if qpad != nq:
                qj = jnp.pad(qj, ((0, qpad - nq), (0, 0)))
            x = qj  # graph routing consumes device arrays too
        else:
            x = self._prep(queries)
            nq = x.shape[0]
            qpad = _pow2(nq)
            if qpad != nq:
                x = np.concatenate(
                    [x, np.zeros((qpad - nq, x.shape[1]), x.dtype)]
                )
            qj = jnp.asarray(x)
        allowed_slots = allowed_tail = None
        if filter_mask is not None:
            allowed_slots, allowed_tail = self._filter_device(filter_mask)
        if self.n_blocks == 0:
            # packed store empty (e.g. fully compacted away, or every row
            # arrived via the spill tail): serve from the tail alone
            q_sq = D.squared_norms(qj)
            sc, ids = _scan_tail(
                self.tail, self.tail_sq, self.tail_ids, qj, q_sq,
                allowed_tail, k=k, metric=self.cfg.metric,
            )
            return D.score_to_distance(sc[:nq], self.cfg.metric), ids[:nq]
        if self.exhaustive(probes, self.n_blocks):
            # exhaustive probes on a big store: STREAM the whole blocked
            # table once for ALL queries (FlatIndex's scan over the
            # [B, S, dp] layout) — the per-query gather expansion would
            # read Q x corpus bytes (compiled a TB-sized intermediate at
            # config-E shard scale)
            sc, ids = self._scan_all(qj, k, allowed_slots=allowed_slots)
            q_sq = None
        elif not self._use_graph_routing():
            # fused single-dispatch serving program (norms+route+expand)
            no_tail = not self.tail_n
            sc, ids = _serve_exact(
                self.blocks, self.blocks_score, self.blocks_sq,
                self.block_ids, self.centroids, self.centroids_sq,
                self._n_blocks_dev, qj, self.score_scale, allowed_slots,
                k=k, probes=probes, rerank=max(self.rerank_width, k),
                metric=self.cfg.metric, two_stage=self.two_stage,
                to_distance=no_tail,
            )
            if no_tail:  # distances computed in-program: zero extra ops
                return sc[:nq], ids[:nq]
            q_sq = None
        else:
            q_sq = D.squared_norms(qj)
            bids = self._route(x, qj, q_sq, probes,
                               ef_route=max(ef_search, probes))
            if self.two_stage:
                sc, ids = _expand_blocks_2stage(
                    self.blocks_score, self.blocks_sq, self.block_ids,
                    self.blocks.reshape(-1, self.cfg.dim), qj, q_sq, bids,
                    k=k, rerank=max(self.rerank_width, k),
                    metric=self.cfg.metric, score_scale=self.score_scale,
                    allowed=allowed_slots,
                )
            else:
                sc, ids = _expand_blocks(
                    self.blocks, self.blocks_sq, self.block_ids, qj, q_sq,
                    bids, k=k, metric=self.cfg.metric, allowed=allowed_slots,
                )
        if self.tail_n:
            if q_sq is None:
                q_sq = D.squared_norms(qj)
            t_sc, t_ids = _scan_tail(
                self.tail, self.tail_sq, self.tail_ids, qj, q_sq,
                allowed_tail, k=k, metric=self.cfg.metric,
            )
            sc, sel = T.topk_smallest(jnp.concatenate([sc, t_sc], axis=1), k)
            ids = jnp.take_along_axis(
                jnp.concatenate([ids, t_ids], axis=1), sel, axis=1
            )
        return D.score_to_distance(sc[:nq], self.cfg.metric), ids[:nq]

    def _scan_all(self, qj, k: int, allowed_slots=None):
        """Exhaustive exact scan over the blocked store (see
        :func:`_scan_all_body`). Raw scores out; caller converts/merges."""
        return _scan_all_body(
            self.blocks, self.blocks_score, self.blocks_sq, self.block_ids,
            self.score_scale is not None, qj, k=k,
            rerank=self.rerank_width, metric=self.cfg.metric,
            allowed_slots=allowed_slots)

    def search(self, queries, k: int = 10, ef_search: int = 40,
               probes: int | None = None, return_distances: bool = True,
               filter_mask=None):
        d, i = self.search_device(queries, k=k, ef_search=ef_search,
                                  probes=probes, filter_mask=filter_mask)
        d, i = jax.device_get((d, i))
        if not return_distances:
            return np.asarray(i)
        return np.asarray(d), np.asarray(i)

    def search_iterative(self, queries, k: int = 10, ef_search: int = 40,
                         predicate=None, max_probes: int = 0):
        """Iterative scan for the blocked engine (upstream v0.8
        ``hnsw.iterative_scan`` analogue, VERDICT r2 #8): when a filter
        rejects results, RESUME by widening the probe set. Routing uses
        an exact (fully sorted) centroid ranking, which is
        prefix-consistent, so each widening expands ONLY the blocks
        ranked ``[p_prev, p)`` — every block is scanned at most once and
        scanned candidates accumulate across widenings (a resume, not a
        restart).

        Unfiltered widening is a pure resume. Filtered widening is NOT:
        a selective filter pushes the nearest passing rows below any
        fixed unfiltered extraction rank, so each filtered round
        re-expands the FULL probed prefix ``[0, p)`` at a doubled
        retained width ``W`` (the same deeper-re-search rule as the
        partitioned variant, parallel/partition.py — geometric doubling
        bounds total rework at ~2x the final round), and a query
        finalizes only when its k passing results survive one further
        widening.

        ``predicate(ids) -> bool mask`` runs host-side; ``max_probes``
        (default: all blocks) bounds the scan. Returns (distances, ids)
        with -1/inf padding when fewer than k pass."""
        validate_ef_search(max(ef_search, 1))
        if self.n_blocks == 0:
            raise ValueError("index is empty")
        max_probes = max_probes or self.n_blocks
        max_probes = min(max_probes, self.n_blocks)
        x = self._prep(queries)
        nq = x.shape[0]
        qpad = _pow2(nq)
        if qpad != nq:
            x = np.concatenate([x, np.zeros((qpad - nq, x.shape[1]), x.dtype)])
        qj = jnp.asarray(x)
        q_sq = D.squared_norms(qj)
        W = max(4 * k, self.rerank_width)
        # exact sorted routing once at the widest useful width: the
        # [p_prev, p) column slices below are then exactly "the next
        # blocks in routing order"
        bids_full = _route_exact_sorted(
            self.centroids, self.centroids_sq, qj, q_sq, self._n_blocks_dev,
            p=max_probes, metric=self.cfg.metric,
        )
        tail_d = np.zeros((nq, 0), np.float32)
        tail_i = np.zeros((nq, 0), np.int64)
        if self.tail_n:  # spill tail scanned once, up front
            t_sc, t_ids = _scan_tail(
                self.tail, self.tail_sq, self.tail_ids, qj, q_sq,
                k=min(W, self.tail.shape[0]), metric=self.cfg.metric,
            )
            tail_d = np.asarray(t_sc)[:nq].astype(np.float32)
            tail_i = np.asarray(t_ids)[:nq].astype(np.int64)
        acc_d, acc_i = tail_d, tail_i
        filtered = predicate is not None
        out_d = np.full((nq, k), np.inf, np.float32)
        out_i = np.full((nq, k), -1, np.int64)
        done = np.zeros(nq, bool)
        # filtered queries need one confirmation widening before they
        # finalize (see loop below)
        confirm = np.zeros(nq, bool)
        p_prev, p = 0, min(self.probes_for_ef(max(ef_search, k)), max_probes)
        while True:
            # filtered rounds re-expand the whole probed prefix at the
            # current (doubled) width; unfiltered rounds resume
            lo = 0 if filtered else p_prev
            bids_new = jax.lax.slice_in_dim(bids_full, lo, p, axis=1)
            kk = min(W, (p - lo) * self.block_size)
            if self.two_stage:
                sc, ids = _expand_blocks_2stage(
                    self.blocks_score, self.blocks_sq, self.block_ids,
                    self.blocks.reshape(-1, self.cfg.dim), qj, q_sq,
                    bids_new, k=kk, rerank=max(self.rerank_width, kk),
                    metric=self.cfg.metric, score_scale=self.score_scale,
                )
            else:
                sc, ids = _expand_blocks(
                    self.blocks, self.blocks_sq, self.block_ids, qj, q_sq,
                    bids_new, k=kk, metric=self.cfg.metric,
                )
            if filtered:  # fresh accumulator: prefix re-expanded in full
                acc_d, acc_i = tail_d, tail_i
            acc_d = np.concatenate([acc_d, np.asarray(sc)[:nq]], axis=1)
            acc_i = np.concatenate(
                [acc_i, np.asarray(ids)[:nq].astype(np.int64)], axis=1
            )
            order = np.argsort(acc_d, axis=1, kind="stable")
            acc_d = np.take_along_axis(acc_d, order, axis=1)
            acc_i = np.take_along_axis(acc_i, order, axis=1)
            mask = predicate(acc_i) if predicate is not None else acc_i >= 0
            mask &= acc_i >= 0
            for qi in range(nq):
                if done[qi]:
                    continue
                good = np.where(mask[qi])[0][:k]
                satisfied = len(good) >= k
                # A filtered query is finalized only when its k passing
                # results survive one further widening (same rule as the
                # partitioned variant, parallel/partition.py): the k-th
                # passing distance routinely exceeds the next-ranked
                # centroid distances, so the first satisfying round
                # still misses nearer passing rows in unprobed blocks.
                final = p >= max_probes or (
                    satisfied and (predicate is None or confirm[qi])
                )
                if final:
                    out_d[qi, : len(good)] = acc_d[qi, good]
                    out_i[qi, : len(good)] = acc_i[qi, good]
                    done[qi] = True
                elif satisfied:
                    confirm[qi] = True
            if done.all() or p >= max_probes:
                break
            p_prev, p = p, min(2 * p, max_probes)
            if predicate is not None:
                # deepen the per-round retained width with the widened
                # probe count: a selective filter pushes the nearest
                # passing rows below any fixed unfiltered rank
                W = min(2 * W, max_probes * self.block_size)
        out_d = D.score_to_distance(jnp.asarray(out_d), self.cfg.metric)
        out_d = np.where(out_i >= 0, np.asarray(out_d), np.inf)
        return out_d, out_i

    # ------------------------------------------------------------ add/delete
    def _ensure_slot(self) -> None:
        """Materialize the host id->slot map if the device-side pack
        deferred it (one block_ids fetch; only delete/add/save need the
        map, never the build or serving paths)."""
        if self._slot_of is not None or self.block_ids is None:
            return
        block_ids = np.asarray(self.block_ids)
        flat = block_ids.reshape(-1)
        live = flat >= 0
        n_ids = int(flat[live].max()) + 1 if live.any() else 0
        hi = n_ids
        t_ids = None
        if self.tail_n:
            t_ids = np.asarray(self.tail_ids[: self.tail_n])
            t_ids = t_ids[t_ids >= 0]
            if t_ids.size:
                hi = max(hi, int(t_ids.max()) + 1)
        slot = np.full(hi, -1, np.int64)
        slot[flat[live]] = np.arange(flat.size, dtype=np.int64)[live]
        if t_ids is not None and t_ids.size:
            slot[t_ids] = -2  # in tail
        self._slot_of = slot

    def add(self, data) -> np.ndarray:
        """Insert vectors into the spill tail (hnswinsert analogue for the
        blocked layout; fold into blocks with :meth:`compact`)."""
        x = self._prep(data)
        count = x.shape[0]
        ids = np.arange(self.n_total + self.tail_n,
                        self.n_total + self.tail_n + count, dtype=np.int32)
        need = self.tail_n + count
        if need > self._tail_cap:
            new_cap = _pow2(max(need, 1024))
            nt = np.zeros((new_cap, self.cfg.dim), np.float32)
            nid = np.full(new_cap, -1, np.int32)
            if self.tail_n:
                nt[: self.tail_n] = np.asarray(self.tail[: self.tail_n],
                                               np.float32)
                nid[: self.tail_n] = np.asarray(self.tail_ids[: self.tail_n])
            self._tail_cap = new_cap
            self.tail = jnp.asarray(nt).astype(self.dtype)
            self.tail_sq = D.squared_norms(self.tail)
            self.tail_ids = jnp.asarray(nid)
        self.tail = self.tail.at[self.tail_n : need].set(
            jnp.asarray(x).astype(self.dtype)
        )
        self.tail_sq = D.squared_norms(self.tail)
        self.tail_ids = self.tail_ids.at[self.tail_n : need].set(
            jnp.asarray(ids)
        )
        self.tail_n = need
        self.tail_live += count
        self._ensure_slot()  # device-pack deferral: rebuild before writes
        if self._slot_of is None or len(self._slot_of) < ids[-1] + 1:
            grown = np.full(ids[-1] + 1, -1, np.int64)
            if self._slot_of is not None:
                grown[: len(self._slot_of)] = self._slot_of
            self._slot_of = grown
        self._slot_of[ids] = -2  # in tail
        return ids

    def delete(self, ids) -> None:
        """Tombstone rows (hnswbulkdelete analogue): id slots become -1 and
        their vectors never score again (masked at expand time)."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        self._ensure_slot()  # device-pack deferral
        if self._slot_of is None:  # nothing built or added yet
            return
        ids = ids[(ids >= 0) & (ids < len(self._slot_of))]
        slots = self._slot_of[ids]
        blk_slots = slots[slots >= 0]
        if blk_slots.size:
            S = self.block_size
            self.block_ids = self.block_ids.at[
                jnp.asarray(blk_slots // S), jnp.asarray(blk_slots % S)
            ].set(-1)
            self.n -= int(blk_slots.size)
        in_tail = ids[slots == -2]
        if in_tail.size and self.tail_n:
            t_ids = np.asarray(self.tail_ids)
            kill = np.isin(t_ids, in_tail)
            self.tail_ids = jnp.asarray(np.where(kill, -1, t_ids))
            self.tail_live -= int(kill.sum())
        self._slot_of[ids] = -1

    def compact(self) -> None:
        """Re-cluster blocks + tail into a fresh packed layout (vacuum +
        page-reclamation analogue): dead rows are dropped, tail rows are
        placed into blocks, centroids and the centroid graph are rebuilt."""
        live_ids, live_vecs = self._export_live()
        if live_ids.size == 0:
            raise ValueError("cannot compact an index with every row deleted")
        # rebuild preserving original global ids
        x_by_id = np.zeros((int(live_ids.max()) + 1, self.cfg.dim), np.float32)
        x_by_id[live_ids] = live_vecs
        block_ids = self._pack(live_vecs, kmeans_iters=5)
        # _pack indexes into live_vecs rows; map back to global ids
        block_ids = np.where(
            block_ids >= 0, live_ids[np.clip(block_ids, 0, None)], -1
        ).astype(np.int32)
        self._install_blocks(x_by_id, block_ids, live_ids.size)
        self.n_total = int(live_ids.max()) + 1  # keep id-space monotone

    def _export_live(self) -> tuple[np.ndarray, np.ndarray]:
        """(global ids, vectors f32) of all live rows (blocks + tail)."""
        bi = np.asarray(self.block_ids).reshape(-1)
        bv = np.asarray(self.blocks, np.float32).reshape(-1, self.cfg.dim)
        live = bi >= 0
        ids = [bi[live]]
        vecs = [bv[live]]
        if self.tail_n:
            ti = np.asarray(self.tail_ids)
            tv = np.asarray(self.tail, np.float32)
            tl = ti >= 0
            ids.append(ti[tl])
            vecs.append(tv[tl])
        return np.concatenate(ids), np.concatenate(vecs)

    # ----------------------------------------------------------------- stats
    def stats(self) -> dict:
        comp = {}
        for name in ("blocks", "blocks_sq", "blocks_score", "block_ids",
                     "centroids", "centroids_sq"):
            a = getattr(self, name, None)
            if a is not None and not (
                name == "blocks_score" and a is self.blocks
            ):
                comp[name] = a.nbytes
        if self.centroid_index is not None and self.centroid_index.graph:
            comp["centroid_graph"] = self.centroid_index.stats()[
                "memory_total_bytes"
            ]
        total = sum(comp.values())
        return {
            "n": self.n,
            "tail_n": self.tail_n,
            "n_blocks": self.n_blocks,
            "block_size": self.block_size,
            "dim": self.cfg.dim,
            "dtype": self.cfg.dtype,
            "routing": "graph" if self._use_graph_routing() else "exact",
            "memory_bytes": comp,
            "memory_total_bytes": total,
            "bytes_per_element": round(total / max(self.size, 1), 1),
            "fill_factor": round(
                self.n / max(self.n_blocks * self.block_size, 1), 4
            ),
            **(
                {"build_stats": self.build_stats}
                if getattr(self, "build_stats", None)
                else {}
            ),
        }

    # ----------------------------------------------------------- persistence
    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        self._ensure_slot()  # device-pack deferral: persist a real map
        blocks = np.asarray(self.blocks)
        if blocks.dtype != np.float32:  # bf16: persist natively as uint16
            blocks = blocks.view(np.uint16)
        # the multi-GB blocks array goes through the native mmap blob
        # writer (cpp/io_native.cpp via io/native.py) — np.savez was the
        # serialization bottleneck at config-E scale; raw-binary +
        # shape/dtype in meta also lets from_saved stream slabs with
        # np.memmap instead of materializing the whole member
        N.blob_write(os.path.join(path, "blocks.bin"), blocks)
        np.savez(
            os.path.join(path, "blocks.npz"),
            block_ids=np.asarray(self.block_ids),
            slot_of=self._slot_of if self._slot_of is not None
            else np.zeros(0, np.int64),
        )
        import dataclasses

        meta = {
            "config": {**dataclasses.asdict(self.cfg),
                       "metric": self.cfg.metric.value},
            "block_size": self.block_size,
            "routing": self.routing,
            "n": self.n,
            "n_total": self.n_total,
            "n_blocks": self.n_blocks,
            "blocks_bin": {"dtype": str(blocks.dtype),
                           "shape": list(blocks.shape)},
        }
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)
        if self.centroid_index is not None:  # lazily built; may not exist
            self.centroid_index.save(os.path.join(path, "centroid_graph"))
        if self.tail_n:
            np.savez(
                os.path.join(path, "tail.npz"),
                tail=np.asarray(self.tail, np.float32),
                tail_ids=np.asarray(self.tail_ids),
                tail_n=self.tail_n,
            )

    @classmethod
    def load(cls, path: str) -> "BlockHnswIndex":
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        c = dict(meta["config"])
        c["metric"] = Metric(c["metric"])
        cfg = HnswConfig(**c)
        idx = cls(cfg, block_size=meta["block_size"], routing=meta["routing"])
        z = np.load(os.path.join(path, "blocks.npz"))
        bb = meta.get("blocks_bin")
        if bb is not None:
            raw = N.blob_read(os.path.join(path, "blocks.bin"),
                              tuple(bb["shape"]), np.dtype(bb["dtype"]))
        else:  # pre-r5 save layout: blocks inside the npz
            raw = z["blocks"]
        if raw.dtype == np.uint16:
            blocks = jnp.asarray(raw).view(jnp.bfloat16)
        else:
            blocks = jnp.asarray(raw).astype(idx.dtype)
        idx.blocks = blocks
        idx.blocks_sq = _blocks_sq_of(blocks)
        idx.blocks_score, idx.score_scale = _make_score_copy(blocks)
        idx.block_ids = jnp.asarray(z["block_ids"])
        idx._slot_of = z["slot_of"]
        cents = _blocks_rowsum_of(blocks) / jnp.maximum(
            (idx.block_ids >= 0).sum(axis=1).astype(jnp.float32), 1.0
        )[:, None]
        idx.centroids = cents.astype(idx.dtype)
        idx.centroids_sq = jnp.sum(cents * cents, axis=-1)
        idx.n = meta["n"]
        idx.n_total = meta["n_total"]
        idx.n_blocks = meta["n_blocks"]
        idx._n_blocks_dev = jnp.int32(idx.n_blocks)
        cg = os.path.join(path, "centroid_graph")
        idx.centroid_index = HnswIndex.load(cg) if os.path.exists(cg) else None
        idx._reset_tail()
        tp = os.path.join(path, "tail.npz")
        if os.path.exists(tp):
            t = np.load(tp)
            idx._tail_cap = t["tail"].shape[0]
            idx.tail = jnp.asarray(t["tail"]).astype(idx.dtype)
            idx.tail_sq = D.squared_norms(idx.tail)
            idx.tail_ids = jnp.asarray(t["tail_ids"])
            idx.tail_n = int(t["tail_n"])
            idx.tail_live = int((t["tail_ids"] >= 0).sum())
        return idx
