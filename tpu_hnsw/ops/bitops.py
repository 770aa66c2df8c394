"""Binary-vector support: packing, hamming and jaccard distance.

The reference's ``bit`` type distances (upstream ``pgvector:src/bitvec.c``
``hamming_distance``/``jaccard_distance``, with AVX512-VPOPCNTDQ dispatch
in ``bitutils.c``): bitpacked uint32 lanes with XOR/AND +
``lax.population_count`` (one instruction per word on the GPU), batched
as [Q, N] matrices for the flat scan path.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def pack_bits(bits: np.ndarray) -> np.ndarray:
    """[..., nbits] of {0,1} -> [..., ceil(nbits/32)] uint32 lanes (bit b
    of word j is element 32j + b)."""
    bits = np.asarray(bits).astype(bool)
    pad = (-bits.shape[-1]) % 32
    if pad:
        bits = np.concatenate(
            [bits, np.zeros((*bits.shape[:-1], pad), bool)], axis=-1
        )
    packed = np.packbits(bits, axis=-1, bitorder="little")
    return np.ascontiguousarray(packed).view("<u4").astype(np.uint32)


def popcount(x: jax.Array) -> jax.Array:
    """Per-lane popcount of uint32 words, as int32."""
    return jax.lax.population_count(x.astype(jnp.uint32)).astype(jnp.int32)


def hamming_distance(a: jax.Array, b: jax.Array) -> jax.Array:
    """``<~>`` over packed uint32 lanes (last axis)."""
    return jnp.sum(popcount(jnp.bitwise_xor(a, b)), axis=-1)


def jaccard_distance(a: jax.Array, b: jax.Array) -> jax.Array:
    """``<%>`` = 1 - |a&b| / |a|b|; 0 when both empty (upstream: NaN->0?
    upstream returns NaN for empty; we follow upstream and emit NaN)."""
    inter = jnp.sum(popcount(jnp.bitwise_and(a, b)), axis=-1)
    union = jnp.sum(popcount(jnp.bitwise_or(a, b)), axis=-1)
    return 1.0 - inter / union


@jax.jit
def pairwise_hamming(q: jax.Array, x: jax.Array) -> jax.Array:
    """[Q, W] x [N, W] -> [Q, N] hamming distances (flat scan / rerank).

    Jitted so XLA fuses XOR -> popcount -> sum into one reduction and the
    [Q, N, W] intermediate is never materialized."""
    return jnp.sum(
        popcount(jnp.bitwise_xor(q[:, None, :], x[None, :, :])), axis=-1
    )


def use_hamming_kernel(platform: str) -> bool:
    """The Pallas hamming kernel serves the GPU, where it measured faster
    end to end than XLA's fused reduction (PERF.md); every other backend
    takes :func:`pairwise_hamming`."""
    return platform == "gpu"


@functools.partial(jax.jit, static_argnames=("k", "metric", "kernel"))
def _flat_topk(q, x, *, k: int, metric: str, kernel: bool):
    if metric == "hamming":
        if kernel:
            from tpu_hnsw.ops.pallas_hamming import hamming_scan

            d = hamming_scan(q, x).astype(jnp.float32)
        else:
            d = pairwise_hamming(q, x).astype(jnp.float32)
    else:
        inter = jnp.sum(
            popcount(jnp.bitwise_and(q[:, None, :], x[None, :, :])), axis=-1)
        union = jnp.sum(
            popcount(jnp.bitwise_or(q[:, None, :], x[None, :, :])), axis=-1)
        d = 1.0 - inter / jnp.maximum(union, 1)
    vals, idx = jax.lax.top_k(-d, k)
    return -vals, idx


class BinaryFlatIndex:
    """Exact binary KNN over packed vectors — hamming (``bit_hamming_ops``)
    or jaccard (``bit_jaccard_ops``); pairs with vector_ops.binary_quantize
    for binary-quantized rerank pipelines."""

    def __init__(self, packed: np.ndarray, metric: str = "hamming"):
        if metric not in ("hamming", "jaccard"):
            raise ValueError("metric must be hamming or jaccard")
        self.metric = metric
        self.packed = jnp.asarray(packed, dtype=jnp.uint32)

    @classmethod
    def from_bits(cls, bits: np.ndarray, metric: str = "hamming") -> "BinaryFlatIndex":
        return cls(pack_bits(bits), metric=metric)

    def search(self, q_packed, k: int = 10):
        q = jnp.asarray(q_packed, dtype=jnp.uint32)
        platform = next(iter(self.packed.devices())).platform
        d, i = _flat_topk(q, self.packed, k=k, metric=self.metric,
                          kernel=use_hamming_kernel(platform))
        return np.asarray(d), np.asarray(i)
