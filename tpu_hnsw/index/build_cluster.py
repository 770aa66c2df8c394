"""Bulk HNSW construction via clustering — the matmul-bound build path.

The incremental wave build (:mod:`.build`) is bound by random row
gathers and a serial chain of beam searches. This module builds the
same graph *structure* a different, dense way:

1. k-means partitions the dataset into overlapping clusters (each element
   joins its ``overlap`` nearest centroids), so candidate generation
   becomes *dense per-cluster bf16 distance matmuls* plus
   ``approx_min_k`` — no graph traversal, no random row gathers;
2. per-element neighbor selection applies the same pgvector
   ``SelectNeighbors`` pruning heuristic (:mod:`.select`) over the cluster
   candidates, with exact f32 re-scoring of candidate distances;
3. reciprocal edges are restored by a fully parallel symmetrization pass
   (lex-sort all directed edges by target, scatter into per-target
   incoming slots, one final selection) — no serialized conflict scan;
4. upper levels use exact blockwise top-k over the (geometrically
   shrinking) level subsets, with the same selection heuristic.

Every stage is device-resident (host code only orchestrates static
shapes): intermediates never leave device memory, chunks are
fixed-shape (one compile per stage), and the only transfers are the
input vectors in and a few scalars out.

The result loads into the standard :class:`HnswIndex`; search, insert
(incremental waves), delete, compact and persistence work unchanged. Use
for initial bulk loads (the populated-table ``CREATE INDEX`` case, which
upstream also special-cases with its in-memory parallel build,
``pgvector:src/hnswbuild.c``); use waves for trickle inserts.
"""

from __future__ import annotations

import functools
import os
import math

import jax
import jax.numpy as jnp
import numpy as np

from tpu_hnsw.config import HnswConfig, Metric
from tpu_hnsw.index import graph as G
from tpu_hnsw.index import select as S
from tpu_hnsw.ops import distance as D
from tpu_hnsw.ops import topk as T
from tpu_hnsw.parallel import kmeans as KM

INF = jnp.float32(jnp.inf)


def _pad_pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << (x - 1).bit_length()


# --------------------------------------------------------------------------
# stage kernels (jitted once per static shape)
# --------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("k_cand", "metric"))
def _cluster_batch(vectors, mem, sentinel, *, k_cand: int, metric: Metric):
    """Top-k_cand in-cluster candidate ids for a batch of clusters
    [B, CS] -> [B, CS, k_cand] (bf16 matmul + approx_min_k)."""
    B, CS = mem.shape
    vecs = G.gather_rows(vectors, mem).astype(jnp.bfloat16)
    dots = jnp.einsum("bid,bjd->bij", vecs, vecs, preferred_element_type=jnp.float32)
    if metric is Metric.L2:
        vf = vecs.astype(jnp.float32)
        sq = jnp.sum(vf * vf, axis=-1)
        sc = jnp.maximum(sq[:, :, None] + sq[:, None, :] - 2 * dots, 0.0)
    else:
        sc = -dots
    valid = mem != sentinel
    sc = jnp.where(valid[:, None, :], sc, INF)
    sc = jnp.where(jnp.eye(CS, dtype=bool)[None], INF, sc)
    vals, idx = jax.lax.approx_min_k(sc.reshape(-1, CS), k_cand)
    vals = vals.reshape(B, CS, k_cand)
    idx = idx.reshape(B, CS, k_cand)
    ids = jnp.take_along_axis(
        jnp.broadcast_to(mem[:, None, :], (B, CS, CS)), idx, axis=2
    )
    return jnp.where(jnp.isfinite(vals), ids, sentinel)


@functools.partial(jax.jit, static_argnames=("overlap",))
def _route_chunk(xb, cj, *, overlap: int):
    """Nearest-``overlap`` centroid ids for one vector chunk (device)."""
    sc = D.pairwise_scores(xb, cj, Metric.L2)
    _, t = T.topk_smallest(sc, overlap)
    return t


@functools.partial(jax.jit, static_argnames=("L", "cs_cap", "overlap"))
def _pack_members_device(top_c, n_real, sentinel, *, L: int, cs_cap: int,
                         overlap: int):
    """Pack per-cluster member lists ON DEVICE: top_c [n, overlap]
    (each row's nearest ``overlap`` centroid ids) -> members [L, cs_cap]
    int32, sentinel padded.

    The r4 host version (numpy argsort + fancy-index stores over 1M
    rows) was 40s of the 43.4s kmeans_route_pack stage at 1M; this is
    the same run-length scatter as :func:`_union_per_element`, one
    jitted program, nothing leaving HBM. Rows past ``n_real`` (pad) and
    overflowing slots scatter into drop buckets.
    """
    n = top_c.shape[0]
    ids = jnp.arange(n, dtype=jnp.int32)
    rows_live = ids < n_real
    members = jnp.full((L + 1, cs_cap), sentinel, jnp.int32)
    cur = jnp.zeros((L + 1,), jnp.int32)
    for o in range(overlap):
        a = jnp.where(rows_live, top_c[:, o].astype(jnp.int32), L)
        order = jnp.argsort(a, stable=True)
        a_s = a[order]
        first = jnp.concatenate([jnp.ones((1,), bool), a_s[1:] != a_s[:-1]])
        run_start = jax.lax.cummax(jnp.where(first, ids, 0))
        occ = ids - run_start
        dst = cur[a_s] + occ
        ok = (dst < cs_cap) & (a_s < L)
        members = members.at[
            jnp.where(ok, a_s, L), jnp.where(ok, dst, 0)
        ].set(jnp.where(ok, ids[order], sentinel), mode="drop")
        cur = (members != sentinel).sum(axis=1).astype(jnp.int32)
    return members[:L]


@functools.partial(jax.jit, static_argnames=("n_bucket", "overlap"))
def _union_per_element(members, cand, sentinel, *, n_bucket: int, overlap: int):
    """Union each element's candidate rows from its clusters:
    members [L, CS], cand [L, CS, K] -> [n_bucket, overlap*K].

    ``n_bucket`` is a pow2 bound >= the true element count so differently-
    sized builds (e.g. per-partition shards) share one compiled program;
    the caller slices the live rows."""
    K = cand.shape[2]
    flat_m = members.reshape(-1)
    flat_c = cand.reshape(-1, K)
    order = jnp.argsort(flat_m)  # sentinels sort to the end
    m_s = flat_m[order]
    c_s = flat_c[order]
    first = jnp.concatenate([jnp.ones((1,), bool), m_s[1:] != m_s[:-1]])
    idx = jax.lax.broadcasted_iota(jnp.int32, (m_s.shape[0], 1), 0).squeeze(-1)
    run_start = jax.lax.cummax(jnp.where(first, idx, 0))
    occ = idx - run_start
    ok = (m_s != sentinel) & (occ < overlap)
    out = jnp.full((n_bucket + 1, overlap, K), sentinel, jnp.int32)
    out = out.at[jnp.where(ok, m_s, n_bucket), jnp.where(ok, occ, 0)].set(
        jnp.where(ok[:, None], c_s, sentinel), mode="drop"
    )
    return out[:n_bucket].reshape(n_bucket, overlap * K)


@functools.partial(jax.jit, static_argnames=("metric",))
def _rescore_chunk(g: G.HnswGraph, b_ids, c_ids, *, metric: Metric):
    """Exact f32 base->candidate distances for one fixed-shape chunk."""
    bv, _ = G.gather_vectors(g, b_ids)
    cv, _ = G.gather_vectors(g, c_ids)
    sc = D.batched_scores(bv.astype(jnp.float32), cv, metric)
    bad = (c_ids == g.sentinel) | (c_ids == b_ids[:, None])
    return jnp.where(bad, INF, sc)


@functools.partial(jax.jit, static_argnames=("lm", "metric", "trim"))
def _select_chunk(g: G.HnswGraph, ci, cd, *, lm: int, metric: Metric, trim: int):
    if trim and ci.shape[1] > trim:
        vals, sel = T.topk_smallest(cd, trim)
        ci = jnp.take_along_axis(ci, sel, axis=1)
        cd = vals
    return S.select_neighbors.__wrapped__(g, ci, cd, lm=lm, metric=metric)


@functools.partial(jax.jit, static_argnames=("incoming_r", "cap"))
def _incoming(prelim_ids, prelim_d, nid, sentinel, *, incoming_r: int, cap: int):
    """Scatter every directed edge (u -> t) into t's incoming slots.

    NOTE: the (target, distance) ordering must be a two-pass lexsort. A
    composite ``(t << 32) | float_bits(d)`` single-sort key was tried in
    r5 and silently broke under JAX's default x64-disabled mode (int64
    degrades to int32, the shift vanishes, edges get ranked by distance
    globally instead of per target) — measured as a 2.3-point recall
    regression at 1M before being bisected back to this function. The
    lexsort is also not actually slower in the real build (the random-
    graph microbench that motivated the key overstated its share)."""
    t = prelim_ids.reshape(-1)
    u = jnp.broadcast_to(nid[:, None], prelim_ids.shape).reshape(-1)
    d = prelim_d.reshape(-1)
    order = jnp.lexsort((d, t))
    t, u, d = t[order], u[order], d[order]
    first = jnp.concatenate([jnp.ones((1,), bool), t[1:] != t[:-1]])
    idx = jax.lax.broadcasted_iota(jnp.int32, (t.shape[0], 1), 0).squeeze(-1)
    run_start = jax.lax.cummax(jnp.where(first, idx, 0))
    rank = idx - run_start
    inc_ids = jnp.full((cap + 1, incoming_r), sentinel, jnp.int32)
    inc_d = jnp.full((cap + 1, incoming_r), jnp.inf, jnp.float32)
    ok = (t != sentinel) & (rank < incoming_r)
    safe_rank = jnp.where(rank < incoming_r, rank, 0)
    inc_ids = inc_ids.at[jnp.where(ok, t, cap), safe_rank].set(
        jnp.where(ok, u, sentinel), mode="drop"
    )
    inc_d = inc_d.at[jnp.where(ok, t, cap), safe_rank].set(
        jnp.where(ok, d, jnp.inf), mode="drop"
    )
    return inc_ids, inc_d


@functools.partial(jax.jit, static_argnames=("lm", "metric"))
def _final_select_chunk(g: G.HnswGraph, pi, pd, rows, inc_ids, inc_d,
                        *, lm: int, metric: Metric):
    ci = jnp.concatenate([pi, jnp.take(inc_ids, rows, axis=0, mode="clip")], axis=1)
    cd = jnp.concatenate([pd, jnp.take(inc_d, rows, axis=0, mode="clip")], axis=1)
    si, _ = S.select_neighbors.__wrapped__(g, ci, cd, lm=lm, metric=metric)
    return si


@functools.partial(jax.jit, static_argnames=("k", "metric", "xblock"))
def _subset_topk(g: G.HnswGraph, q_ids, x_ids, *, k: int, metric: Metric,
                 xblock: int):
    """Exact top-k of q_ids among x_ids (both global id arrays, sentinel-
    padded; self-hits excluded)."""
    sent = g.sentinel
    qv, _ = G.gather_vectors(g, q_ids)
    qf = qv.astype(jnp.float32)
    xv, _ = G.gather_vectors(g, x_ids)
    xf = xv.astype(jnp.float32)
    nb = x_ids.shape[0] // xblock
    best_d = jnp.full((q_ids.shape[0], k), INF)
    best_i = jnp.full((q_ids.shape[0], k), sent, jnp.int32)

    def body(b, carry):
        best_d, best_i = carry
        xb = jax.lax.dynamic_slice_in_dim(xf, b * xblock, xblock, axis=0)
        ib = jax.lax.dynamic_slice_in_dim(x_ids, b * xblock, xblock, axis=0)
        dots = qf @ xb.T
        if metric is Metric.L2:
            qs = jnp.sum(qf * qf, -1)
            xs = jnp.sum(xb * xb, -1)
            sc = jnp.maximum(qs[:, None] + xs[None, :] - 2 * dots, 0.0)
        else:
            sc = -dots
        sc = jnp.where((ib == sent)[None, :], INF, sc)
        sc = jnp.where(ib[None, :] == q_ids[:, None], INF, sc)
        kk = min(k, xblock)
        vals, pos = jax.lax.top_k(-sc, kk)
        nbr = jnp.take(ib, pos)
        d2 = jnp.concatenate([best_d, -vals], axis=1)
        i2 = jnp.concatenate([best_i, nbr], axis=1)
        v3, sel = T.topk_smallest(d2, k)
        return v3, jnp.take_along_axis(i2, sel, axis=1)

    best_d, best_i = jax.lax.fori_loop(0, nb, body, (best_d, best_i))
    # a block with fewer than k finite rows surfaces INF-scored ids —
    # mask them to sentinel so selection can never keep a phantom edge
    return best_d, jnp.where(jnp.isfinite(best_d), best_i, sent)


# --------------------------------------------------------------------------
# host orchestration (static shapes only; data stays on device)
# --------------------------------------------------------------------------


def _pad_rows(a, m_pad, fill):
    if a.shape[0] == m_pad:
        return a
    pad_shape = (m_pad - a.shape[0], *a.shape[1:])
    return jnp.concatenate([a, jnp.full(pad_shape, fill, a.dtype)], axis=0)


@functools.partial(jax.jit, static_argnames=("r2",))
def _non_candidates(g: G.HnswGraph, node_ids, *, r2: int):
    """Neighbor-of-neighbor candidate ids for an NN-descent refinement
    round: [ch] -> [ch, deg + deg*r2]."""
    nb = jnp.take(g.neighbors0, node_ids, axis=0, mode="clip")  # [ch, deg]
    nb = jnp.where((node_ids == g.sentinel)[:, None], g.sentinel, nb)
    nb2 = jnp.take(g.neighbors0, nb, axis=0, mode="clip")[:, :, :r2]
    nb2 = jnp.where((nb == g.sentinel)[:, :, None], g.sentinel, nb2)
    return jnp.concatenate([nb, nb2.reshape(nb.shape[0], -1)], axis=1)


def build_bulk(index, data, cluster_size: int = 1024, overlap: int = 2,
               kmeans_iters: int = 5, refine_rounds: int = 0) -> None:
    """Bulk-build an empty HnswIndex from ``data`` (dense matmul path).

    Records a per-stage wall-clock breakdown in ``index.build_stats``
    (the pg_stat_progress_create_index phases analogue, and the
    instrument VERDICT r3 #3 asked for: block builds had one, graph
    builds had a single scalar)."""
    import time as _time

    cfg: HnswConfig = index.cfg
    metric = cfg.metric
    if index.n != 0:
        raise ValueError("build_bulk requires an empty index")

    stages: dict[str, float] = {}
    _t = [_time.perf_counter()]

    def _mark(name: str, *sync):
        if sync:
            jax.block_until_ready(sync)
        now = _time.perf_counter()
        stages[name] = round(stages.get(name, 0.0) + now - _t[0], 3)
        _t[0] = now

    finite = None
    if isinstance(data, jax.Array) and data.ndim == 2:
        # device-resident ingest (production shape: embeddings produced
        # on the same accelerator) — validation/normalization run on
        # device, nothing round-trips the host link
        if data.shape[1] != cfg.dim:
            raise ValueError(
                f"expected {cfg.dim} dimensions, not {data.shape[1]}")
        x = data.astype(jnp.float32)
        from tpu_hnsw.index.block import _all_finite, _normalize_keep_dtype

        finite = _all_finite(x)  # dispatched now, checked at the end
        if cfg.metric.needs_normalized:
            x = _normalize_keep_dtype(x)
    else:
        x = index._prep(data)
    n = x.shape[0]
    index._ensure_graph(n)
    g = index.graph
    sent = g.sentinel
    _mark("prep_alloc")

    levels = index._draw_levels(n)
    ids = np.arange(n, dtype=np.int32)
    slots = np.full(n, g.cap_upper, np.int32)
    upper_rows = np.where(levels >= 1)[0]
    if index.n_upper + len(upper_rows) > g.cap_upper:
        raise RuntimeError("upper-level table overflow; increase capacity")
    slots[upper_rows] = index.n_upper + np.arange(len(upper_rows), dtype=np.int32)
    index.n_upper += len(upper_rows)

    from tpu_hnsw.index import build as B

    for s in range(0, n, 262144):
        e = min(n, s + 262144)
        g = B._set_wave(
            g,
            jnp.asarray(ids[s:e]),
            jnp.asarray(x[s:e]),
            jnp.asarray(levels[s:e]),
            jnp.asarray(slots[s:e]),
        )
    index.graph = g
    _mark("upload_vectors", g.vectors)

    # ---- level 0 candidates via overlapping clusters
    L = max(1, math.ceil(n / cluster_size))
    if L <= overlap:
        cs_pad = _pad_pow2(n)
        members_j = jnp.concatenate(
            [jnp.arange(n, dtype=jnp.int32),
             jnp.full((cs_pad - n,), sent, jnp.int32)]
        )[None, :]
        overlap_eff = 1
    else:
        overlap_eff = overlap
        # k-means on the (already device-resident) vectors — g.vectors
        # was populated by the upload scatter above, so routing never
        # re-reads the input
        vecs_n = g.vectors[:n]
        centroids, _ = KM.kmeans(
            vecs_n, L, iters=kmeans_iters, seed=cfg.seed,
            sample=min(n, 65536), balance=False, assign_full=False,
        )
        # top-`overlap` centroid routing, blockwise ([n, L] would not
        # fit), results staying on device
        cj = jnp.asarray(centroids)
        blk = 131072
        n_pad_route = ((n + blk - 1) // blk) * blk
        vr = _pad_rows(vecs_n, n_pad_route, 0.0)
        parts = []
        for s in range(0, n_pad_route, blk):
            xb = jax.lax.dynamic_slice_in_dim(vr, s, blk, axis=0)
            parts.append(_route_chunk(xb, cj, overlap=overlap))
        top_c = jnp.concatenate(parts, axis=0)  # [n_pad_route, overlap]
        cs_cap = _pad_pow2(4 * cluster_size)
        members_j = _pack_members_device(
            top_c, jnp.int32(n), jnp.int32(sent),
            L=L, cs_cap=cs_cap, overlap=overlap,
        )
    _mark("kmeans_route_pack", members_j)

    CS = members_j.shape[1]
    k_cand = int(min(cfg.ef_construction, CS - 1))
    bc = max(1, (1 << 28) // (CS * CS * 4))
    Lp = members_j.shape[0]
    members_pad = _pad_rows(members_j, ((Lp + bc - 1) // bc) * bc, sent)
    cand_parts = []
    for s in range(0, members_pad.shape[0], bc):
        mem = jax.lax.dynamic_slice_in_dim(members_pad, s, bc, axis=0)
        cand_parts.append(
            _cluster_batch(g.vectors, mem, jnp.int32(sent),
                           k_cand=k_cand, metric=metric)
        )
    cand = jnp.concatenate(cand_parts, axis=0)[:Lp]
    _mark("cluster_candidates", cand)

    n_bucket = _pad_pow2(n)
    all_ci = _union_per_element(
        members_j, cand, jnp.int32(sent), n_bucket=n_bucket,
        overlap=overlap_eff,
    )
    _mark("union_candidates", all_ci)

    # exact re-score (fixed-shape chunks on device). Chunk size trades
    # peak HBM ([chunk, C, d] f32 gathers, ~2.1GB at 32768 x 128 x 128)
    # against the SERIAL cost of the selection heuristic: select's
    # greedy scan is a fori_loop of C tiny steps, so total build time
    # carries (n/chunk) * C sequential kernel launches — r5 measured
    # link_l0 10.0s + nn_descent_refine 14.8s at 1M with chunk=8192,
    # dominated by exactly these steps; 4x the chunk cuts them ~4x.
    chunk = min(int(os.environ.get("TPU_HNSW_BUILD_CHUNK", 32768)), n_bucket)
    n_pad = ((n + chunk - 1) // chunk) * chunk
    ci_p = all_ci[:n_pad] if n_pad <= n_bucket else _pad_rows(all_ci, n_pad, sent)
    # rows >= n of the union output are junk scattered by sentinel members;
    # overwrite with sentinel so padded rows stay inert
    if n_pad > n:
        rows = jax.lax.broadcasted_iota(jnp.int32, (n_pad, 1), 0)
        ci_p = jnp.where(rows < n, ci_p, sent)
    nid_p = _pad_rows(jnp.arange(n, dtype=jnp.int32), n_pad, sent)
    cd_parts = []
    for s in range(0, n_pad, chunk):
        b = jax.lax.dynamic_slice_in_dim(nid_p, s, chunk, axis=0)
        c = jax.lax.dynamic_slice_in_dim(ci_p, s, chunk, axis=0)
        cd_parts.append(_rescore_chunk(g, b, c, metric=metric))
    cd_p = jnp.concatenate(cd_parts, axis=0)
    _mark("rescore_l0", cd_p)

    def link(node_ids_pad, ci_pad, cd_pad, m_pad, lm, trim):
        pre_i, pre_d = [], []
        for s in range(0, m_pad, chunk):
            a = jax.lax.dynamic_slice_in_dim(ci_pad, s, chunk, axis=0)
            b = jax.lax.dynamic_slice_in_dim(cd_pad, s, chunk, axis=0)
            si, sd = _select_chunk(g, a, b, lm=lm, metric=metric, trim=trim)
            pre_i.append(si)
            pre_d.append(sd)
        pi = jnp.concatenate(pre_i, axis=0)
        pd = jnp.concatenate(pre_d, axis=0)
        inc_ids, inc_d = _incoming(
            pi, pd, node_ids_pad, jnp.int32(sent), incoming_r=32, cap=g.cap
        )
        outs = []
        for s in range(0, m_pad, chunk):
            a = jax.lax.dynamic_slice_in_dim(pi, s, chunk, axis=0)
            b = jax.lax.dynamic_slice_in_dim(pd, s, chunk, axis=0)
            r = jax.lax.dynamic_slice_in_dim(node_ids_pad, s, chunk, axis=0)
            outs.append(
                _final_select_chunk(g, a, b, r, inc_ids, inc_d, lm=lm,
                                    metric=metric)
            )
        return jnp.concatenate(outs, axis=0)

    def write_level0(final0):
        nonlocal g
        padw = g.neighbors0.shape[1] - cfg.m0
        if padw:
            final0 = jnp.concatenate(
                [final0, jnp.full((n_pad, padw), sent, jnp.int32)], axis=1
            )
        g = g._replace(
            neighbors0=g.neighbors0.at[nid_p].set(final0, mode="drop")
        )
        index.graph = g

    write_level0(link(nid_p, ci_p, cd_p, n_pad, cfg.m0, cfg.ef_construction))
    _mark("link_l0", g.neighbors0)

    # NN-descent refinement: candidates = neighbors ∪ neighbors-of-
    # neighbors, rescored exactly, re-selected + re-symmetrized.
    # Default 0 since r5: measured at 1M x 128 (seed 42, 4 operating
    # points, correct lexsort symmetrization) one round costs 15.2s of
    # a 38.2s device-resident build and buys ≤0.05 recall points
    # (refine1 0.9691/0.9912 vs refine0 0.9686/0.9910 at the two bench
    # ladder anchors) — the overlap-2 cluster candidates plus the
    # incoming-edge symmetrization already saturate what the refine
    # round was added for in r3. Kept as an opt-in knob.
    for _ in range(refine_rounds):
        ref_ci_parts, ref_cd_parts = [], []
        for s in range(0, n_pad, chunk):
            b = jax.lax.dynamic_slice_in_dim(nid_p, s, chunk, axis=0)
            c = _non_candidates(g, b, r2=8)
            ref_ci_parts.append(c)
            ref_cd_parts.append(_rescore_chunk(g, b, c, metric=metric))
        rci = jnp.concatenate(ref_ci_parts, axis=0)
        rcd = jnp.concatenate(ref_cd_parts, axis=0)
        write_level0(link(nid_p, rci, rcd, n_pad, cfg.m0, cfg.ef_construction))
    _mark("nn_descent_refine", g.neighbors0)

    # ---- upper levels: exact subset top-k + link.
    # All levels whose subset fits SMALL_BUCKET share ONE padded shape
    # family (and one static k), so a build compiles the four level
    # programs once instead of once per level (per-level shapes made
    # compilation the top upper_levels cost at 1M). Level 1 (~n/m
    # elements) keeps its own pow2 family; levels >= 2 are all tiny.
    SMALL_BUCKET = 4096
    for lc in range(1, int(levels.max()) + 1):
        subset = np.where(levels >= lc)[0].astype(np.int32)
        if len(subset) <= 1:
            continue
        M = len(subset)
        bucket = max(_pad_pow2(M), min(SMALL_BUCKET, _pad_pow2(n)))
        chunk_u = min(8192, bucket)
        m_pad = ((M + chunk_u - 1) // chunk_u) * chunk_u
        x_pad = bucket
        xblock = min(16384, x_pad)
        sub_j = _pad_rows(jnp.asarray(subset), max(m_pad, x_pad), sent)
        k_up = int(min(cfg.ef_construction, bucket - 1))
        nbr_parts, d_parts = [], []
        for s in range(0, m_pad, chunk_u):
            q_ids = jax.lax.dynamic_slice_in_dim(sub_j, s, chunk_u, axis=0)
            dd, ii = _subset_topk(
                g, q_ids, sub_j[:x_pad], k=k_up, metric=metric, xblock=xblock
            )
            nbr_parts.append(ii)
            d_parts.append(dd)
        nbr = jnp.concatenate(nbr_parts, axis=0)
        dists = jnp.concatenate(d_parts, axis=0)

        def link_u(node_ids_pad, ci_pad, cd_pad, m_pad_, lm, trim, ch):
            pre_i, pre_d = [], []
            for s in range(0, m_pad_, ch):
                a = jax.lax.dynamic_slice_in_dim(ci_pad, s, ch, axis=0)
                b = jax.lax.dynamic_slice_in_dim(cd_pad, s, ch, axis=0)
                si, sd = _select_chunk(g, a, b, lm=lm, metric=metric, trim=trim)
                pre_i.append(si)
                pre_d.append(sd)
            pi = jnp.concatenate(pre_i, axis=0)
            pd = jnp.concatenate(pre_d, axis=0)
            inc_ids, inc_d = _incoming(
                pi, pd, node_ids_pad, jnp.int32(sent), incoming_r=32, cap=g.cap
            )
            outs = []
            for s in range(0, m_pad_, ch):
                a = jax.lax.dynamic_slice_in_dim(pi, s, ch, axis=0)
                b = jax.lax.dynamic_slice_in_dim(pd, s, ch, axis=0)
                r = jax.lax.dynamic_slice_in_dim(node_ids_pad, s, ch, axis=0)
                outs.append(
                    _final_select_chunk(g, a, b, r, inc_ids, inc_d, lm=lm,
                                        metric=metric)
                )
            return jnp.concatenate(outs, axis=0)

        finalu = link_u(sub_j[:m_pad], nbr, dists, m_pad, cfg.m, 0, chunk_u)
        padw = g.upper_nbrs.shape[2] - cfg.m
        if padw:
            finalu = jnp.concatenate(
                [finalu, jnp.full((m_pad, padw), sent, jnp.int32)], axis=1
            )
        slot_j = _pad_rows(jnp.asarray(slots[subset]), m_pad, g.cap_upper)
        g = g._replace(
            upper_nbrs=g.upper_nbrs.at[slot_j, lc - 1].set(finalu, mode="drop")
        )
        index.graph = g

    _mark("upper_levels", g.upper_nbrs)

    if finite is not None and not bool(finite):
        # upstream vector_in rejects NaN and infinity values
        raise ValueError("NaN or infinity values are not allowed")
    index.n = n
    index._levels_host.extend(int(l) for l in levels)
    top = int(levels.max())
    index.entry = int(np.where(levels == top)[0][0])
    index.entry_level = top
    stages["total"] = round(sum(v for k, v in stages.items()), 3)
    stages["vectors_per_sec"] = round(n / max(stages["total"], 1e-9), 1)
    index.build_stats = {"mode": "bulk", "n": n, "cluster_size": cluster_size,
                         "overlap": overlap, "refine_rounds": refine_rounds,
                         "stages": stages}
