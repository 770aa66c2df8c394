"""Device k-means — the centroid machinery.

The reference's IVFFlat k-means (upstream ``pgvector:src/ivfkmeans.c``:
sampled k-means++ seeding + Elkan-accelerated Lloyd iterations, used for
``ivfflat.lists`` centroids) reformulated as matmuls: assignment is one
blockwise [N, K] distance matmul per iteration, update is a segment-sum.
Used here as the centroid router for partitioned indexes
(BASELINE.json:11) and as the core of the IVFFlat index type.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from tpu_hnsw.config import Metric
from tpu_hnsw.ops import distance as D


@functools.partial(jax.jit, static_argnames=("k",))
def _assign(x, x_sq, centroids, k):
    """Nearest centroid per row (L2)."""
    c_sq = D.squared_norms(centroids)
    scores = (
        x_sq[:, None]
        + c_sq[None, :]
        - 2.0
        * jax.lax.dot_general(
            x, centroids.T, (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
    )
    return jnp.argmin(scores, axis=1).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("k",))
def _update(x, assign, k):
    """Mean of each cluster (segment sum / count)."""
    sums = jax.ops.segment_sum(x.astype(jnp.float32), assign, num_segments=k)
    counts = jax.ops.segment_sum(
        jnp.ones((x.shape[0],), jnp.float32), assign, num_segments=k
    )
    return sums / jnp.maximum(counts, 1.0)[:, None], counts


@functools.partial(jax.jit, static_argnames=("k", "iters"))
def _lloyd(x, x_sq, centroids, k: int, iters: int):
    """``iters`` Lloyd iterations as ONE device program (fori_loop).

    Per-iteration host round-trips (two dispatches + a counts fetch per
    iter) would serialize the device behind the host; a fused segment
    runs them back to back.
    Empty clusters keep their previous centroid inside the segment
    (host-side refill happens between segments)."""

    def body(_, carry):
        c, _ = carry
        a = _assign(x, x_sq, c, k)
        c2, counts = _update(x, a, k)
        c2 = jnp.where(counts[:, None] < 1.0, c, c2)
        return c2, counts

    return jax.lax.fori_loop(
        0, iters, body, (centroids, jnp.ones((k,), jnp.float32))
    )


def kmeans(
    data: np.ndarray,
    k: int,
    iters: int = 10,
    seed: int = 0,
    sample: int | None = 262144,
    balance: bool = True,
    assign_full: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    """Lloyd's k-means with random-sample init (the device stand-in for
    pgvector's sampled k-means++; iterations dominate quality at these k).

    Returns (centroids [k, d] f32, assignment [N] int32). ``balance``
    re-seeds empty clusters from the largest cluster's points, mirroring
    IVFFlat's split of empty lists.

    ``data`` may be a DEVICE array: sampling/indexing then run as device
    gathers and nothing round-trips through the host (the device-resident
    build path).
    """
    on_device = isinstance(data, jax.Array)
    if not on_device:
        data = np.asarray(data, np.float32)
    n = data.shape[0]
    rng = np.random.default_rng(seed)
    train = data
    if sample is not None and n > sample:
        train = data[rng.choice(n, sample, replace=False)]
    x = jnp.asarray(train, jnp.float32) if not on_device else (
        train.astype(jnp.float32)
    )
    d_orig = x.shape[1]
    dp = ((d_orig + 127) // 128) * 128
    if dp != d_orig:
        # lane-pad the iteration operands to a multiple of 128 (tile-
        # aligned matmuls); zero columns change neither distances,
        # argmin, nor the update means
        x = jnp.pad(x, ((0, 0), (0, dp - d_orig)))
    x_sq = D.squared_norms(x)
    centroids = x[rng.choice(x.shape[0], k, replace=False)]
    # Fixed-shape refill pool for empty clusters, materialized on host
    # ONCE: refilling with a device gather of len(empty) rows compiles a
    # fresh program per distinct empty-count (varying shapes).
    refill_pool = None
    # Lloyd iterations run in fused SEGMENTS (one dispatch each, see
    # _lloyd); empty-cluster refill happens on host between segments.
    if balance and iters >= 3:
        segments = [iters - 2 * (iters // 3)] + [iters // 3] * 2
    else:
        segments = [iters] if iters else []
    for seg in segments:
        centroids, counts = _lloyd(x, x_sq, centroids, k, seg)
        if balance:
            counts_np = np.asarray(counts)
            empty = np.where(counts_np < 1)[0]
            if len(empty):
                if refill_pool is None:
                    pool_n = min(x.shape[0], max(1024, k))
                    refill_pool = np.asarray(
                        x[jnp.asarray(rng.choice(x.shape[0], pool_n,
                                                 replace=False))]
                    )
                cn = np.array(centroids)
                cn[empty] = refill_pool[
                    rng.choice(len(refill_pool), len(empty))
                ]
                centroids = jnp.asarray(cn)
    if not assign_full:
        return np.asarray(centroids)[:, :d_orig], np.zeros(0, np.int32)
    # final assignment over the full dataset, blockwise
    full = jnp.asarray(data, jnp.float32) if not on_device else (
        data.astype(jnp.float32)
    )
    if dp != d_orig:
        full = jnp.pad(full, ((0, 0), (0, dp - d_orig)))
    full_sq = D.squared_norms(full)
    out = []
    step = 1 << 18
    for s in range(0, n, step):
        out.append(np.asarray(_assign(full[s : s + step], full_sq[s : s + step], centroids, k)))
    return (np.asarray(centroids)[:, :d_orig],
            np.concatenate(out) if out else np.zeros(0, np.int32))
