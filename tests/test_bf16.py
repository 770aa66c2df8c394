"""bf16 (halfvec-parity) end-to-end: build, search, persist (VERDICT r1
item 5 / BASELINE config E prerequisite).

The reference's halfvec is fp16 storage with full-precision-ish distance
(upstream ``pgvector:src/halfvec.c`` + halfutils SIMD); the analogue
is bf16 storage with f32 accumulation (SURVEY §2.2 halfvec row).
"""

import os

import numpy as np

from tpu_hnsw import BlockHnswIndex, FlatIndex, HnswConfig, HnswIndex, Metric
from tpu_hnsw.io.datasets import synthetic_clustered
from tpu_hnsw.utils.recall import recall_at_k


def _data(n=4096, d=32, nq=64, seed=11):
    return synthetic_clustered(n, d, n_queries=nq, seed=seed)


def test_hnsw_bf16_build_search_recall():
    base, queries = _data()
    cfg = HnswConfig(dim=32, m=8, ef_construction=48, dtype="bfloat16",
                     wave_size=256, seed=2)
    idx = HnswIndex(cfg, capacity=len(base)).build(base)
    gt = FlatIndex(base, Metric.L2).search(queries, k=10, exact=True)[1]
    _, ids = idx.search(queries, k=10, ef_search=80)
    r = recall_at_k(ids, gt, 10)
    assert r >= 0.9, r  # bf16 storage costs a little recall vs exact gt
    # memory parity: vector table is half the f32 size
    assert idx.graph.vectors.dtype.name == "bfloat16"
    st = idx.stats()
    assert st["memory_bytes"]["vectors"] == idx.graph.vectors.size * 2


def test_hnsw_bf16_save_load_native(tmp_path):
    base, queries = _data(n=2048)
    cfg = HnswConfig(dim=32, m=8, ef_construction=48, dtype="bfloat16",
                     wave_size=256, seed=2)
    idx = HnswIndex(cfg, capacity=len(base)).build(base)
    d0, i0 = idx.search(queries, k=10, ef_search=64)
    p16 = str(tmp_path / "bf16")
    idx.save(p16)
    idx2 = HnswIndex.load(p16)
    d1, i1 = idx2.search(queries, k=10, ef_search=64)
    np.testing.assert_array_equal(i0, i1)  # bit-identical round trip
    np.testing.assert_allclose(d0, d1, rtol=1e-6)
    # checkpoint stores bf16 natively: vector payload is half of f32's
    cfg32 = HnswConfig(dim=32, m=8, ef_construction=48, wave_size=256, seed=2)
    idx32 = HnswIndex(cfg32, capacity=len(base)).build(base)
    p32 = str(tmp_path / "f32")
    idx32.save(p32)
    z16 = np.load(os.path.join(p16, "graph.npz"))
    z32 = np.load(os.path.join(p32, "graph.npz"))
    assert z16["vectors"].dtype == np.uint16
    assert z16["vectors"].nbytes * 2 == z32["vectors"].nbytes


def test_hnsw_bf16_add_delete_compact():
    base, queries = _data(n=2048)
    cfg = HnswConfig(dim=32, m=8, ef_construction=48, dtype="bfloat16",
                     wave_size=256, seed=2)
    idx = HnswIndex(cfg, capacity=4096).build(base[:1536])
    idx.add(base[1536:])
    gt = FlatIndex(base, Metric.L2).search(queries, k=10, exact=True)[1]
    _, ids = idx.search(queries, k=10, ef_search=80)
    assert recall_at_k(ids, gt, 10) >= 0.9
    idx.delete(np.arange(64))
    idx.compact()
    _, ids = idx.search(queries, k=5, ef_search=64)
    assert not np.isin(ids, np.arange(64)).any()


def test_block_bf16_bench_shape():
    """The config-E serving shape in miniature: 512-d bf16 blocked index."""
    base, queries = synthetic_clustered(4096, 512, n_queries=32, seed=5)
    cfg = HnswConfig(dim=512, m=8, ef_construction=32, dtype="bfloat16")
    idx = BlockHnswIndex(cfg, block_size=64).build(base)
    gt = FlatIndex(base, Metric.L2).search(queries, k=10, exact=True)[1]
    _, ids = idx.search(queries, k=10, probes=16)
    assert recall_at_k(ids, gt, 10) >= 0.9
    st = idx.stats()
    assert st["memory_bytes"]["blocks"] == idx.blocks.size * 2
