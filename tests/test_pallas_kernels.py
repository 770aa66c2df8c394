"""Hamming scan against a numpy popcount oracle: the XLA path behind
BinaryFlatIndex and the Pallas kernel (interpret mode on CPU), at shapes
that need padding of the query tile, the row tile and the word count."""

import numpy as np
import jax.numpy as jnp
import pytest

from tpu_hnsw.ops import bitops as BO
from tpu_hnsw.ops.pallas_hamming import hamming_scan


@pytest.mark.parametrize("nq,n,bits", [(1, 100, 64), (17, 513, 1000),
                                       (130, 4099, 1024)])
def test_pallas_hamming_matches_xla(nq, n, bits):
    rng = np.random.default_rng(nq)
    bq = rng.integers(0, 2, size=(nq, bits))
    bx = rng.integers(0, 2, size=(n, bits))
    want = (bq[:, None, :] != bx[None, :, :]).sum(-1)
    qp, xp = BO.pack_bits(bq), BO.pack_bits(bx)

    np.testing.assert_array_equal(
        np.asarray(BO.pairwise_hamming(jnp.asarray(qp), jnp.asarray(xp))),
        want)
    np.testing.assert_array_equal(
        np.asarray(hamming_scan(jnp.asarray(qp), jnp.asarray(xp),
                                interpret=True)), want)
    k = 10
    d, i = BO.BinaryFlatIndex(xp).search(qp, k=k)
    np.testing.assert_array_equal(d, np.sort(want, axis=1)[:, :k])
    np.testing.assert_array_equal(np.take_along_axis(want, i, axis=1), d)


@pytest.mark.parametrize("platform,kernel", [("gpu", True), ("cpu", False)])
def test_hamming_kernel_choice(platform, kernel):
    """The kernel is chosen for the GPU only; everywhere else the XLA
    reduction runs (the kernel's interpret mode is for tests)."""
    assert BO.use_hamming_kernel(platform) is kernel
