"""Distance primitives (XLA path).

The batched replacement for the reference's per-dtype SIMD distance
loops with runtime CPU dispatch (upstream ``pgvector:src/halfutils.c``,
``bitutils.c``, inner loops of ``vector.c``): here "dispatch" is XLA
specializing one traced program per dtype/shape, and the wide inner loop is
a matmul.

Internally the engine works with a *score* in which smaller is always
better:

- L2      -> squared L2 distance (monotone in ``<->``)
- IP      -> negative inner product (exactly pgvector's ``<#>``)
- COSINE  -> negative inner product over pre-normalized vectors
             (monotone in cosine distance ``<=>``)

User-facing distances are recovered with :func:`score_to_distance`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tpu_hnsw.config import Metric


def _dot(a: jax.Array, b_t: jax.Array) -> jax.Array:
    """Matmul with f32 accumulation AND full-precision inputs.

    At DEFAULT precision an f32 matmul runs in TF32 on the GPU's tensor
    cores (about three decimal digits); the L2 matmul form |q|^2+|x|^2-2qx
    then loses the low bits exactly where nearest-neighbor ordering is
    decided (catastrophic cancellation for near pairs).
    Precision.HIGHEST runs true f32.
    """
    return jax.lax.dot_general(
        a,
        b_t,
        dimension_numbers=(((a.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )


def squared_norms(x: jax.Array) -> jax.Array:
    xf = x.astype(jnp.float32)
    return jnp.sum(xf * xf, axis=-1)


def pairwise_scores(
    q: jax.Array,
    x: jax.Array,
    metric: Metric,
    x_sq: jax.Array | None = None,
) -> jax.Array:
    """Scores of every query against every point: ``[Q, N]``.

    L2 uses the ``|q|^2 + |x|^2 - 2 q.x`` matmul form ("K Nearest
    Neighbor Search at Peak FLOP/s", PAPERS.md); IP/cosine are a plain
    negated matmul.
    """
    dots = _dot(q, x.T)  # [Q, N] f32
    if metric is Metric.L2:
        if x_sq is None:
            x_sq = squared_norms(x)
        q_sq = squared_norms(q)
        return jnp.maximum(q_sq[:, None] + x_sq[None, :] - 2.0 * dots, 0.0)
    elif metric in (Metric.IP, Metric.COSINE):
        return -dots
    elif metric is Metric.L1:
        # No matmul form; used only by the flat (exact) index.
        qf = q.astype(jnp.float32)
        xf = x.astype(jnp.float32)
        return jnp.sum(jnp.abs(qf[:, None, :] - xf[None, :, :]), axis=-1)
    raise ValueError(f"unsupported metric {metric}")


def batched_scores(
    q: jax.Array,
    vecs: jax.Array,
    metric: Metric,
    vecs_sq: jax.Array | None = None,
    q_sq: jax.Array | None = None,
) -> jax.Array:
    """Scores of each query against its own gathered block.

    q: ``[Q, d]``, vecs: ``[Q, K, d]`` -> ``[Q, K]``.  This is the inner
    distance step of beam search — a batched mat-vec, which cannot fill a
    matrix unit anyway, so it is computed **elementwise in f32**: exact
    distances (no bf16 input rounding, no |a|^2+|b|^2-2ab cancellation) at
    the same bandwidth cost. ``vecs_sq``/``q_sq`` are accepted for API
    compatibility and unused.
    """
    qf = q.astype(jnp.float32)[:, None, :]
    vf = vecs.astype(jnp.float32)
    if metric is Metric.L2:
        d = qf - vf
        return jnp.sum(d * d, axis=-1)
    if metric is Metric.L1:
        # ``<+>`` (vector_l1_ops): no matmul form exists, but this path is
        # elementwise VPU work anyway, so L1 costs the same as L2 here.
        return jnp.sum(jnp.abs(qf - vf), axis=-1)
    return -jnp.sum(qf * vf, axis=-1)


def score_to_distance(score: jax.Array, metric: Metric) -> jax.Array:
    """Map internal scores back to pgvector operator semantics.

    L2 -> ``<->`` (euclidean), IP -> ``<#>`` (negative inner product,
    already the score), COSINE -> ``<=>`` (1 - cos; assumes normalized
    vectors so score = -cos).
    """
    if metric is Metric.L2:
        return jnp.sqrt(jnp.maximum(score, 0.0))
    if metric is Metric.COSINE:
        return 1.0 + score
    return score


def l2_normalize(x: jax.Array, eps: float = 1e-12) -> jax.Array:
    """pgvector ``l2_normalize``; cosine indexes store normalized vectors.

    Upstream pgvector's cosine opclass normalizes on the fly inside the
    distance; storing normalized vectors gives identical ordering while
    keeping the hot kernel a pure matmul.
    """
    xf = x.astype(jnp.float32)
    n = jnp.sqrt(jnp.sum(xf * xf, axis=-1, keepdims=True))
    return (xf / jnp.maximum(n, eps)).astype(x.dtype)
