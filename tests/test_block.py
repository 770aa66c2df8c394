"""BlockHnswIndex (cluster-blocked level 0) — correctness tests.

Strategy mirrors the reference's recall TAP tests (SURVEY.md §4): exact
brute-force oracle via FlatIndex, recall thresholds on clustered data,
plus exactness when every block is probed (probes=B degenerates to a
full exact scan, the enable_indexscan=off analogue).
"""

import numpy as np
import pytest

from tpu_hnsw import FlatIndex, HnswConfig, Metric
from tpu_hnsw.index.block import BlockHnswIndex
from tpu_hnsw.io.datasets import synthetic_clustered
from tpu_hnsw.utils.recall import recall_at_k


def _data(n=4096, d=32, nq=64, seed=0):
    return synthetic_clustered(n, d, n_queries=nq, seed=seed)


def test_all_probes_matches_exact_oracle():
    base, queries = _data()
    cfg = HnswConfig(dim=32, m=8, ef_construction=32, seed=1)
    idx = BlockHnswIndex(cfg, block_size=64).build(base)
    gt = FlatIndex(base, Metric.L2).search(queries, k=10, exact=True)[1]
    _, ids = idx.search(queries, k=10, probes=idx.n_blocks)
    assert recall_at_k(ids, gt, 10) == 1.0


def test_recall_at_modest_probes():
    base, queries = _data(n=8192)
    cfg = HnswConfig(dim=32, m=8, ef_construction=32, seed=1)
    idx = BlockHnswIndex(cfg, block_size=64).build(base)
    gt = FlatIndex(base, Metric.L2).search(queries, k=10, exact=True)[1]
    # 16 of 128 blocks probed
    _, ids = idx.search(queries, k=10, probes=16)
    assert recall_at_k(ids, gt, 10) >= 0.95


def test_graph_routing_matches_exact_routing_recall():
    base, queries = _data(n=8192)
    cfg = HnswConfig(dim=32, m=8, ef_construction=32, seed=1)
    idx = BlockHnswIndex(cfg, block_size=64, routing="graph").build(base)
    gt = FlatIndex(base, Metric.L2).search(queries, k=10, exact=True)[1]
    _, ids = idx.search(queries, k=10, probes=16, ef_search=64)
    r_graph = recall_at_k(ids, gt, 10)
    idx.routing = "exact"
    _, ids = idx.search(queries, k=10, probes=16)
    r_exact = recall_at_k(ids, gt, 10)
    assert r_graph >= r_exact - 0.03  # beam routing ~ exact routing
    assert r_graph >= 0.9


def test_cosine_metric():
    base, queries = _data(n=4096)
    cfg = HnswConfig(dim=32, m=8, ef_construction=32, metric=Metric.COSINE)
    idx = BlockHnswIndex(cfg, block_size=64).build(base)
    gt = FlatIndex(base, Metric.COSINE).search(queries, k=10, exact=True)[1]
    _, ids = idx.search(queries, k=10, probes=16)
    assert recall_at_k(ids, gt, 10) >= 0.9
    # distances are pgvector <=> units (1 - cos in [0, 2])
    d, _ = idx.search(queries[:4], k=5, probes=idx.n_blocks)
    assert (d >= -1e-5).all() and (d <= 2 + 1e-5).all()


def test_ip_metric():
    base, queries = _data(n=4096)
    cfg = HnswConfig(dim=32, m=8, ef_construction=32, metric=Metric.IP)
    idx = BlockHnswIndex(cfg, block_size=64).build(base)
    gt = FlatIndex(base, Metric.IP).search(queries, k=10, exact=True)[1]
    # a third of the blocks probed: recall must be solidly high without
    # being brittle to packing jitter from block_slack
    _, ids = idx.search(queries, k=10, probes=24)
    assert recall_at_k(ids, gt, 10) >= 0.9


def test_bf16_storage_recall_and_memory():
    base, queries = _data(n=4096)
    cfg32 = HnswConfig(dim=32, m=8, ef_construction=32)
    cfg16 = HnswConfig(dim=32, m=8, ef_construction=32, dtype="bfloat16")
    i32 = BlockHnswIndex(cfg32, block_size=64).build(base)
    i16 = BlockHnswIndex(cfg16, block_size=64).build(base)
    gt = FlatIndex(base, Metric.L2).search(queries, k=10, exact=True)[1]
    _, ids = i16.search(queries, k=10, probes=16)
    assert recall_at_k(ids, gt, 10) >= 0.9
    assert i16.stats()["memory_bytes"]["blocks"] * 2 == (
        i32.stats()["memory_bytes"]["blocks"]
    )


def test_delete_tombstones():
    base, queries = _data(n=2048)
    cfg = HnswConfig(dim=32, m=8, ef_construction=32)
    idx = BlockHnswIndex(cfg, block_size=64).build(base)
    _, ids0 = idx.search(queries, k=5, probes=idx.n_blocks)
    victims = np.unique(ids0[ids0 >= 0])[:50]
    idx.delete(victims)
    assert idx.size == 2048 - len(victims)
    _, ids1 = idx.search(queries, k=5, probes=idx.n_blocks)
    assert not np.isin(ids1[ids1 >= 0], victims).any()


def test_add_tail_and_compact():
    base, queries = _data(n=2048)
    cfg = HnswConfig(dim=32, m=8, ef_construction=32, seed=3)
    idx = BlockHnswIndex(cfg, block_size=64).build(base[:1536])
    new_ids = idx.add(base[1536:])
    assert idx.size == 2048
    assert (new_ids == np.arange(1536, 2048)).all()
    gt = FlatIndex(base, Metric.L2).search(queries, k=10, exact=True)[1]
    _, ids = idx.search(queries, k=10, probes=idx.n_blocks)
    assert recall_at_k(ids, gt, 10) == 1.0  # tail scanned exactly
    # compact folds the tail into blocks; ids keep meaning
    idx.compact()
    assert idx.tail_n == 0 and idx.size == 2048
    _, ids2 = idx.search(queries, k=10, probes=idx.n_blocks)
    assert recall_at_k(ids2, gt, 10) == 1.0


def test_delete_then_compact_reclaims():
    base, _ = _data(n=2048)
    cfg = HnswConfig(dim=32, m=8, ef_construction=32)
    idx = BlockHnswIndex(cfg, block_size=64).build(base)
    idx.delete(np.arange(0, 1024))
    idx.compact()
    assert idx.size == 1024
    # reclaimed: block count shrinks to fit live rows
    assert idx.n_blocks <= (1024 + 63) // 64 + 1
    q = base[1500:1504]
    _, ids = idx.search(q, k=1, probes=idx.n_blocks)
    assert (ids[:, 0] == np.arange(1500, 1504)).all()


def test_save_load_roundtrip(tmp_path):
    base, queries = _data(n=2048)
    cfg = HnswConfig(dim=32, m=8, ef_construction=32, dtype="bfloat16")
    idx = BlockHnswIndex(cfg, block_size=64).build(base)
    idx.add(np.random.default_rng(0).normal(size=(10, 32)).astype(np.float32))
    d0, i0 = idx.search(queries, k=10, probes=8)
    p = str(tmp_path / "blockidx")
    idx.save(p)
    idx2 = BlockHnswIndex.load(p)
    d1, i1 = idx2.search(queries, k=10, probes=8)
    np.testing.assert_array_equal(i0, i1)
    np.testing.assert_allclose(d0, d1, rtol=1e-6)
    assert idx2.size == idx.size


def test_dim_mismatch_and_nan_rejected():
    base, _ = _data(n=512)
    cfg = HnswConfig(dim=32, m=8, ef_construction=32)
    idx = BlockHnswIndex(cfg, block_size=64).build(base)
    with pytest.raises(ValueError, match="expected 32 dimensions"):
        idx.search(np.zeros((2, 16), np.float32), k=3)
    bad = base[:4].copy()
    bad[0, 0] = np.nan
    with pytest.raises(ValueError, match="NaN or infinity"):
        idx.add(bad)


def test_probes_for_ef_mapping():
    base, _ = _data(n=4096)
    cfg = HnswConfig(dim=32, m=8, ef_construction=32)
    idx = BlockHnswIndex(cfg, block_size=64).build(base)
    # ROWS_PER_EF rows of stage-1 candidates per unit of ef, computed
    # from the index's OWN block size (r4: ceil(ef/4) was tuned to S=256
    # and silently scanned 4x less corpus at S=64), scaled by block_slack
    # so coverage per ef is constant under slack
    want = -(-idx.ROWS_PER_EF * 40 // 64)  # 40 blocks at S=64
    want += int((idx.block_slack - 1) * want + 0.5)
    assert idx.probes_for_ef(40) == want
    assert idx.probes_for_ef(1) == 1 + int(
        (idx.block_slack - 1) * 1 + 0.5)
    assert idx.probes_for_ef(10**6) == idx.n_blocks
    # S=256 reproduces the round-3 tuned mapping exactly: ceil(ef/4)
    idx256 = BlockHnswIndex(cfg, block_size=256).build(base)
    p = -(-40 // 4)
    assert idx256.probes_for_ef(40) == p + int(
        (idx256.block_slack - 1) * p + 0.5)


def test_device_resident_build_matches_host_build():
    """build(jax.Array) never round-trips the base through the host and
    produces the same index as the host-input build (same seed/kmeans)."""
    import jax.numpy as jnp

    base, queries = synthetic_clustered(3000, 16, n_queries=20, seed=4)
    cfg = HnswConfig(dim=16, m=8, ef_construction=32, seed=9)
    a = BlockHnswIndex(cfg, block_size=64).build(base)
    b = BlockHnswIndex(cfg, block_size=64).build(jnp.asarray(base))
    assert b.build_stats["device_resident_input"] is True
    assert a.build_stats["device_resident_input"] is False
    np.testing.assert_array_equal(
        np.asarray(a.block_ids), np.asarray(b.block_ids)
    )
    _, ia = a.search(queries, k=5, ef_search=40)
    _, ib = b.search(queries, k=5, ef_search=40)
    np.testing.assert_array_equal(np.asarray(ia), np.asarray(ib))
    with pytest.raises(ValueError):
        BlockHnswIndex(cfg, block_size=64).build(
            jnp.asarray(np.full((10, 16), np.nan, np.float32))
        )


def test_exhaustive_scan_path_matches_gather_path(monkeypatch):
    """probes >= n_blocks on large stores streams the whole table once
    (the per-query gather would read Q x corpus); results must match the
    gather expansion exactly."""
    base, queries = _data(n=4096)
    cfg = HnswConfig(dim=32, m=8, ef_construction=32, seed=1)
    idx = BlockHnswIndex(cfg, block_size=64).build(base)
    assert not idx.exhaustive(idx.n_blocks, idx.n_blocks)
    _, ids_gather = idx.search(queries, k=10, probes=idx.n_blocks)
    # force the streamed path
    monkeypatch.setattr(BlockHnswIndex, "EXHAUSTIVE_SCAN_MIN_BLOCKS", 1)
    assert idx.exhaustive(idx.n_blocks, idx.n_blocks)
    _, ids_scan = idx.search(queries, k=10, probes=idx.n_blocks)
    np.testing.assert_array_equal(ids_gather, ids_scan)


def test_device_assign_parity_with_host(monkeypatch):
    """The device-side balanced assignment (default) must satisfy the
    same invariants as the host C++ greedy (TPU_HNSW_ASSIGN=host, the
    parity oracle): every row placed exactly once, capacity respected,
    and full-probe search stays exact."""
    base, queries = _data(n=4096)
    cfg = HnswConfig(dim=32, m=8, ef_construction=32, seed=1)

    monkeypatch.setenv("TPU_HNSW_ASSIGN", "host")
    h = BlockHnswIndex(cfg, block_size=64).build(base)
    monkeypatch.setenv("TPU_HNSW_ASSIGN", "device")
    d = BlockHnswIndex(cfg, block_size=64).build(base)

    bid = np.asarray(d.block_ids)
    live = bid[bid >= 0]
    assert live.size == 4096 and np.unique(live).size == 4096
    assert ((bid >= 0).sum(axis=1) <= d.block_size).all()
    assert d.build_stats.get("assign_leftover_rows", 0) == 0

    gt = FlatIndex(base, Metric.L2).search(queries, k=10, exact=True)[1]
    _, di = d.search(queries, k=10, probes=d.n_blocks)
    assert recall_at_k(di, gt, 10) == 1.0
    # routed recall parity with the host-packed index at equal probes
    _, hp = h.search(queries, k=10, probes=8)
    _, dp = d.search(queries, k=10, probes=8)
    rh, rd = recall_at_k(hp, gt, 10), recall_at_k(dp, gt, 10)
    assert rd >= rh - 0.03, (rd, rh)


def test_device_assign_lazy_slot_delete_add_save(tmp_path, monkeypatch):
    """The device pack defers the host id->slot map; delete/add/save must
    materialize it transparently (_ensure_slot)."""
    monkeypatch.setenv("TPU_HNSW_ASSIGN", "device")
    base, queries = _data(n=2048)
    cfg = HnswConfig(dim=32, m=8, ef_construction=32, seed=2)
    idx = BlockHnswIndex(cfg, block_size=64).build(base)
    assert idx._slot_of is None  # deferred

    gt = FlatIndex(base, Metric.L2).search(queries, k=5, exact=True)[1]
    victim = int(gt[0, 0])
    idx.delete([victim])
    _, ids = idx.search(queries[:1], k=5, probes=idx.n_blocks)
    assert victim not in ids[0]
    assert idx.n == 2047

    new_ids = idx.add(base[:3])
    assert len(new_ids) == 3 and idx.tail_live == 3

    idx.save(str(tmp_path / "blk"))
    idx2 = BlockHnswIndex.load(str(tmp_path / "blk"))
    _, i1 = idx.search(queries, k=5, probes=8)
    _, i2 = idx2.search(queries, k=5, probes=8)
    np.testing.assert_array_equal(i1, i2)


def test_int8_score_copy_recall_parity(monkeypatch):
    """TPU_HNSW_SCORE_DTYPE=int8: per-block symmetric quantization of the
    stage-1 scan. Exact rerank restores precision, so routed recall must
    match the bf16 copy within noise."""
    base, queries = _data(n=4096)
    cfg = HnswConfig(dim=32, m=8, ef_construction=32, seed=1)
    monkeypatch.setenv("TPU_HNSW_SCORE_DTYPE", "bf16")
    b16 = BlockHnswIndex(cfg, block_size=64).build(base)
    assert b16.score_scale is None
    monkeypatch.setenv("TPU_HNSW_SCORE_DTYPE", "int8")
    i8 = BlockHnswIndex(cfg, block_size=64).build(base)
    assert i8.score_scale is not None and i8.blocks_score.dtype == "int8"

    gt = FlatIndex(base, Metric.L2).search(queries, k=10, exact=True)[1]
    _, ids16 = b16.search(queries, k=10, probes=8)
    _, ids8 = i8.search(queries, k=10, probes=8)
    r16 = recall_at_k(ids16, gt, 10)
    r8 = recall_at_k(ids8, gt, 10)
    assert r8 >= r16 - 0.02, (r8, r16)
    # full-probe scan stays exact through the rerank
    _, full8 = i8.search(queries, k=10, probes=i8.n_blocks)
    assert recall_at_k(full8, gt, 10) >= 0.99
    # returned distances are exact-grade (stage 2 re-scores from f32)
    d8, i8ids = i8.search(queries[:4], k=5, probes=8)
    gt_d, _ = FlatIndex(base, Metric.L2).search(queries[:4], k=5, exact=True)
    for qi in range(4):
        got = i8ids[qi, 0]
        true = float(np.sqrt(((base[got] - queries[qi]) ** 2).sum()))
        assert abs(d8[qi, 0] - true) < 1e-3


def test_pipelined_host_upload_path_matches_default():
    """Force the pipelined-upload build path (normally >=64MB inputs) and
    pin it to the plain path's results: same packing inputs -> identical
    serving behavior (VERDICT r3 #6)."""
    import numpy as np
    from tpu_hnsw import BlockHnswIndex, HnswConfig
    from tpu_hnsw.io.datasets import synthetic_clustered

    base, queries = synthetic_clustered(4000, 16, n_queries=16, seed=9)
    a = BlockHnswIndex(HnswConfig(dim=16, seed=1), block_size=64)
    a.build(base)
    b = BlockHnswIndex(HnswConfig(dim=16, seed=1), block_size=64)
    old = BlockHnswIndex.PIPELINE_UPLOAD_MIN_BYTES
    BlockHnswIndex.PIPELINE_UPLOAD_MIN_BYTES = 1
    try:
        b.build(base)
    finally:
        BlockHnswIndex.PIPELINE_UPLOAD_MIN_BYTES = old
    assert b.build_stats.get("pipelined_upload") is True
    assert "kmeans_overlapped_s" in b.build_stats
    da, ia = a.search(queries, k=10, ef_search=64)
    db, ib = b.search(queries, k=10, ef_search=64)
    # same seed + same data: k-means on the full-sample (4000 <= sample
    # cap) is identical, so the packs and results match exactly
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_allclose(da, db, rtol=1e-5, atol=1e-6)
