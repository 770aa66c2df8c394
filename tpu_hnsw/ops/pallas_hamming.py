"""Pallas kernel (Triton route): blocked hamming-distance scan over
packed bits.

The reference dispatches AVX512-VPOPCNTDQ popcount loops at load time
(upstream ``pgvector:src/bitutils.c``). One program here scores a
``[TQ, BLK]`` tile of (query, row) pairs: it walks the W packed words,
XORs one query word against one row word across the tile, counts bits
with ``population_count`` and accumulates, so the ``[Q, N, W]`` XOR
tensor never exists and each row word is read once per query tile.

Inputs are passed word-major (``[W, Q]`` and ``[W, N]``) so every word
load is contiguous, and as int32: Triton's popcount takes signed words,
and the bit pattern is what is counted.

``BinaryFlatIndex`` uses it on the GPU (``bitops.use_hamming_kernel``):
at 256 queries x 1M rows x 1024 bits on an H100 (700 W) the scan takes
3.1 ms against 13.8 ms for XLA's fused XOR-popcount reduction, which
re-reads the table per query; ``chip_smoke.py`` phase F times both on
every run. Tests run it with ``interpret=True``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton


def _kernel(qt_ref, xt_ref, out_ref):
    """qt_ref [W, TQ] int32, xt_ref [W, BLK] int32 -> out_ref [TQ, BLK]."""
    acc = jnp.zeros(out_ref.shape, jnp.int32)
    for w in range(qt_ref.shape[0]):  # W is static and small: unrolled
        q = qt_ref[w, :]
        x = xt_ref[w, :]
        acc += jax.lax.population_count(q[:, None] ^ x[None, :])
    out_ref[...] = acc


def _pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << (x - 1).bit_length()


@functools.partial(jax.jit, static_argnames=("tq", "blk", "interpret"))
def hamming_scan(q_packed, x_packed, *, tq: int = 32, blk: int = 128,
                 interpret: bool = False):
    """All-pairs hamming distances ``[Q, N]`` int32 over packed uint32
    words ``[Q, W]`` x ``[N, W]``. Pads Q, N and W (zero words add no
    bits) to the tile shapes, which Triton wants as powers of two."""
    Q, W = q_packed.shape
    N = x_packed.shape[0]
    tq = min(tq, _pow2(Q))
    blk = min(blk, _pow2(N))
    wp = _pow2(W)
    qp, np_ = -Q % tq, -N % blk
    as_i32 = functools.partial(jax.lax.bitcast_convert_type,
                               new_dtype=jnp.int32)
    qt = jnp.pad(as_i32(q_packed), ((0, qp), (0, wp - W))).T
    xt = jnp.pad(as_i32(x_packed), ((0, np_), (0, wp - W))).T
    out = pl.pallas_call(
        _kernel,
        grid=((Q + qp) // tq, (N + np_) // blk),
        in_specs=[
            pl.BlockSpec((wp, tq), lambda i, j: (0, i)),
            pl.BlockSpec((wp, blk), lambda i, j: (0, j)),
        ],
        out_specs=pl.BlockSpec((tq, blk), lambda i, j: (i, j)),
        out_shape=jax.ShapeDtypeStruct((Q + qp, N + np_), jnp.int32),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=4, num_stages=2),
        interpret=interpret,
        name="hamming_scan",
    )(qt, xt)
    return out[:Q, :N]
