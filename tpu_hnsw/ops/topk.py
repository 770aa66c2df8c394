"""Top-k selection and k-way merge utilities.

The candidate-heap of the reference's ``HnswSearchLayer`` (upstream
``pgvector:src/hnswutils.c``, pairingheap of HnswSearchCandidates) becomes
sorted fixed-width buffers maintained with ``lax.top_k``/``sort`` — the
compiler-friendly batched analogue (no pointer heaps, static shapes).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

INF = jnp.float32(jnp.inf)


def topk_smallest(scores: jax.Array, k: int) -> tuple[jax.Array, jax.Array]:
    """Smallest-k along the last axis. Returns (values, indices)."""
    neg, idx = jax.lax.top_k(-scores, k)
    return -neg, idx


def topk_smallest_fast(
    scores: jax.Array, k: int, recall_target: float = 0.99
) -> tuple[jax.Array, jax.Array]:
    """Smallest-k for WIDE rows via ``lax.approx_min_k`` (the selection
    primitive of "K Nearest Neighbor Search at Peak FLOP/s", PAPERS.md).
    On the GPU it lowers to JAX's exact fallback (ROADMAP 1.4 asks what
    that costs against ``lax.top_k``). The approximation, where it
    applies, can only drop order-statistics ties near rank k
    (recall_target bounds it); values returned are exact. Narrow rows
    keep the exact path — at <=256 lanes a sort is cheap and exactness
    is free.
    """
    width = scores.shape[-1]
    if width <= 256 or k >= width:
        return topk_smallest(scores, k)
    return jax.lax.approx_min_k(scores, k, recall_target=recall_target)


def merge_pools(
    dists_a: jax.Array,
    ids_a: jax.Array,
    flags_a: jax.Array,
    dists_b: jax.Array,
    ids_b: jax.Array,
    flags_b: jax.Array,
    k: int,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Merge two (dist, id, flag) pools along the last axis, keep best k.

    Used to fold freshly scored neighbors into the beam-search candidate
    pool. Entries with dist=+inf are padding. Ties broken arbitrarily.
    """
    d = jnp.concatenate([dists_a, dists_b], axis=-1)
    i = jnp.concatenate([ids_a, ids_b], axis=-1)
    f = jnp.concatenate([flags_a, flags_b], axis=-1)
    vals, sel = topk_smallest(d, k)
    return (
        vals,
        jnp.take_along_axis(i, sel, axis=-1),
        jnp.take_along_axis(f, sel, axis=-1),
    )


def kway_merge_topk(
    dists: jax.Array, ids: jax.Array, k: int
) -> tuple[jax.Array, jax.Array]:
    """Merge per-partition top-k lists into a global top-k.

    dists/ids: ``[..., P, K]`` (P partitions) -> ``[..., k]``.  This is the
    partitioned-search merge op (SURVEY.md §5 "the one comm-adjacent kernel");
    after an ``all_gather`` of per-shard top-k it reduces to a single
    ``top_k`` over P*K lanes.
    """
    flat_d = dists.reshape(*dists.shape[:-2], -1)
    flat_i = ids.reshape(*ids.shape[:-2], -1)
    vals, sel = topk_smallest(flat_d, k)
    return vals, jnp.take_along_axis(flat_i, sel, axis=-1)


def mask_duplicate_ids(d: jax.Array, i: jax.Array) -> jax.Array:
    """Mask (to +inf) every entry whose id already appeared in an earlier
    column of the same row — the merge-dedup for multi-assigned replicas
    (parallel/partition.py): a border vector stored in two partitions
    reaches the merge twice with IDENTICAL distance, so dropping either
    copy is exact. d/i: [Q, w]; w is small (P*k), the [Q, w, w] compare
    is trivial."""
    w = i.shape[1]
    eq = (i[:, :, None] == i[:, None, :]) & (i[:, :, None] >= 0)
    earlier = (
        jax.lax.broadcasted_iota(jnp.int32, (1, w, w), 2)
        < jax.lax.broadcasted_iota(jnp.int32, (1, w, w), 1)
    )
    dup = jnp.any(eq & earlier, axis=-1)
    return jnp.where(dup, jnp.inf, d)
