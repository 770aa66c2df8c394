"""Vectorized neighbor-selection heuristic.

Batched reimplementation of the reference's ``SelectNeighbors`` (upstream
``pgvector:src/hnswutils.c``; Malkov & Yashunin Algorithm 4 with
extend_candidates=false, keep_pruned_connections=true): scanning candidates
in ascending distance-to-base order, keep a candidate iff it is closer to
the base than to every already-kept one; then fill remaining slots with the
closest pruned candidates.

The batched formulation: the inter-candidate distances are one batched
matmul ``[B, C, C]``, and the inherently sequential greedy scan is a
``fori_loop`` over the C candidate slots doing O(B*C) vector work per
step — C is ef_construction (64), so the scan is tiny next to the matmul.

Semantics note (matches the numpy oracle ``ref_impl.select_neighbors``):
a candidate is rejected only when some kept candidate is *strictly* closer
to it than the base is, and when fewer than ``lm`` candidates exist in
total the result degenerates to "keep everything", which also makes this
one function implement ``HnswUpdateConnection``'s append-if-room /
re-select-if-full behavior.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from tpu_hnsw.config import Metric
from tpu_hnsw.index import graph as G
from tpu_hnsw.ops import distance as D

INF = jnp.float32(jnp.inf)


def pairwise_cand_scores(
    vecs: jax.Array, vecs_sq: jax.Array, metric: Metric
) -> jax.Array:
    """Inter-candidate scores [B, C, C] from gathered vectors [B, C, d]."""
    if metric is Metric.L1:
        # vector_l1_ops: elementwise [B, C, C, d] reduce — C is bounded by
        # ef_construction-scale candidate sets, so the fused abs-sum stays
        # cheap relative to the search that produced the candidates.
        vf = vecs.astype(jnp.float32)
        return jnp.sum(jnp.abs(vf[:, :, None, :] - vf[:, None, :, :]), axis=-1)
    dots = jnp.einsum(
        "bid,bjd->bij", vecs, vecs, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    if metric is Metric.L2:
        return jnp.maximum(
            vecs_sq[:, :, None] + vecs_sq[:, None, :] - 2.0 * dots, 0.0
        )
    return -dots


@functools.partial(jax.jit, static_argnames=("lm", "metric"))
def select_neighbors(
    g: G.HnswGraph,
    cand_ids: jax.Array,
    cand_dists: jax.Array,
    *,
    lm: int,
    metric: Metric,
) -> tuple[jax.Array, jax.Array]:
    """Select up to ``lm`` neighbors per row.

    cand_ids/cand_dists: [B, C], dist = score to the base element,
    sentinel ids must carry +inf dists. Candidates need NOT be pre-sorted.
    Returns (sel_ids [B, lm], sel_dists [B, lm]) dense-prefix, sentinel
    padded.
    """
    sent = g.sentinel
    B, C = cand_ids.shape

    # sort by distance ascending (sentinels to the end)
    order = jnp.argsort(jnp.where(cand_ids == sent, INF, cand_dists), axis=1)
    cand_ids = jnp.take_along_axis(cand_ids, order, axis=1)
    cand_dists = jnp.take_along_axis(cand_dists, order, axis=1)
    # dedup: candidate sets assembled from several sources (search pool,
    # intra-wave links, existing edges) may overlap — keep first occurrence
    dup = jnp.any(
        (cand_ids[:, :, None] == cand_ids[:, None, :])
        & (
            jax.lax.broadcasted_iota(jnp.int32, (1, C, C), 2)
            < jax.lax.broadcasted_iota(jnp.int32, (1, C, C), 1)
        ),
        axis=2,
    )
    cand_ids = jnp.where(dup, sent, cand_ids)
    cand_dists = jnp.where(dup, INF, cand_dists)
    valid = cand_ids != sent

    vecs, vecs_sq = G.gather_vectors(g, cand_ids)
    cc = pairwise_cand_scores(vecs, vecs_sq, metric)  # [B, C, C]

    selected0 = jnp.zeros((B, C), dtype=jnp.bool_)
    min_to_sel0 = jnp.full((B, C), INF)
    count0 = jnp.zeros((B,), dtype=jnp.int32)

    def step(i, carry):
        selected, min_to_sel, count = carry
        di = jax.lax.dynamic_index_in_dim(cand_dists, i, axis=1, keepdims=False)
        vi = jax.lax.dynamic_index_in_dim(valid, i, axis=1, keepdims=False)
        mts_i = jax.lax.dynamic_index_in_dim(min_to_sel, i, axis=1, keepdims=False)
        keep = vi & (count < lm) & (di <= mts_i)
        selected = selected.at[:, i].set(keep)
        count = count + keep.astype(jnp.int32)
        cc_i = jax.lax.dynamic_index_in_dim(cc, i, axis=2, keepdims=False)
        min_to_sel = jnp.where(
            keep[:, None], jnp.minimum(min_to_sel, cc_i), min_to_sel
        )
        return selected, min_to_sel, count

    selected, _, count = jax.lax.fori_loop(0, C, step, (selected0, min_to_sel0, count0))

    # keep-pruned fill: final order = kept (by distance) then pruned (by
    # distance); scatter each candidate to its output slot.
    pruned = valid & ~selected
    sel_rank = jnp.cumsum(selected, axis=1) - 1
    pr_rank = count[:, None] + jnp.cumsum(pruned, axis=1) - 1
    pos = jnp.where(selected, sel_rank, jnp.where(pruned, pr_rank, C))
    rows = jax.lax.broadcasted_iota(jnp.int32, (B, C), 0)
    out_ids = jnp.full((B, C + 1), sent, dtype=jnp.int32)
    out_dists = jnp.full((B, C + 1), INF)
    out_ids = out_ids.at[rows, pos].set(cand_ids, mode="drop")
    out_dists = out_dists.at[rows, pos].set(cand_dists, mode="drop")
    if C + 1 < lm:  # fewer candidates than slots: pad to the full width
        out_ids = jnp.pad(out_ids, ((0, 0), (0, lm - C - 1)), constant_values=sent)
        out_dists = jnp.pad(out_dists, ((0, 0), (0, lm - C - 1)), constant_values=INF)
    return out_ids[:, :lm], out_dists[:, :lm]
