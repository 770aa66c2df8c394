"""Partitioned sub-indexes, routing, and the global top-k merge —
multi-device behavior tested on the virtual 8-core CPU mesh (SURVEY.md §4:
the analogue of upstream's throwaway-local-cluster TAP strategy)."""

import numpy as np
import pytest

import jax

from tpu_hnsw.config import HnswConfig, Metric
from tpu_hnsw.index.flat import FlatIndex
from tpu_hnsw.parallel.kmeans import kmeans
from tpu_hnsw.parallel.partition import (
    CentroidRouter,
    HashRouter,
    PartitionedHnswIndex,
)
from tpu_hnsw.io.datasets import synthetic_clustered
from tpu_hnsw.utils.recall import recall_at_k


CFG = dict(dim=12, m=8, ef_construction=32, wave_size=128, seed=3)


@pytest.fixture(scope="module")
def data():
    base, queries = synthetic_clustered(4000, 12, n_queries=40, seed=23)
    flat = FlatIndex(base, Metric.L2)
    _, gt = flat.search(queries, k=10)
    return base, queries, gt


def test_kmeans_partitions_balanced(data):
    base, _, _ = data
    centroids, assign = kmeans(base, 8, iters=8, seed=0)
    assert centroids.shape == (8, 12)
    counts = np.bincount(assign, minlength=8)
    assert counts.min() > 0
    # each point is nearest its own centroid vs a random other
    d_own = ((base - centroids[assign]) ** 2).sum(1)
    d_other = ((base - centroids[(assign + 1) % 8]) ** 2).sum(1)
    assert (d_own <= d_other + 1e-4).mean() > 0.99


def test_hash_partitioned_recall_and_merge(data):
    base, queries, gt = data
    idx = PartitionedHnswIndex(HnswConfig(**CFG), n_partitions=8, router="hash")
    idx.build(base)
    d, ids = idx.search(queries, k=10, ef_search=64)
    assert recall_at_k(ids, gt, 10) >= 0.9
    assert np.all(np.diff(d, axis=1) >= -1e-5)  # merged stream is sorted


def test_partitioned_exhaustive_equals_brute_force(data):
    """ef = partition size ⇒ per-shard exhaustive ⇒ merge must equal the
    global exact top-k (the merge-correctness property, SURVEY.md §4)."""
    base, queries, gt = data
    idx = PartitionedHnswIndex(
        HnswConfig(**CFG), n_partitions=8, router="hash"
    )
    idx.build(base[:800])
    flat = FlatIndex(base[:800], Metric.L2)
    _, gt800 = flat.search(queries, k=5)
    _, ids = idx.search(queries, k=5, ef_search=600)
    assert recall_at_k(ids, gt800, 5) == 1.0


def test_centroid_routing_tradeoff(data):
    base, queries, gt = data
    idx = PartitionedHnswIndex(
        HnswConfig(**CFG), n_partitions=8, router="centroid"
    )
    idx.build(base)
    _, ids_all = idx.search(queries, k=10, ef_search=64, route_k=8)
    _, ids_2 = idx.search(queries, k=10, ef_search=64, route_k=2)
    r_all = recall_at_k(ids_all, gt, 10)
    r_2 = recall_at_k(ids_2, gt, 10)
    assert r_all >= 0.9
    # clustered data: top-2-of-8 routing retains most recall
    assert r_2 >= 0.75
    assert r_all >= r_2 - 1e-9


def test_sharded_search_matches_host_loop(data):
    base, queries, gt = data
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    idx = PartitionedHnswIndex(HnswConfig(**CFG), n_partitions=8, router="hash")
    idx.build(base)
    d_host, i_host = idx.search(queries, k=10, ef_search=64)
    sharded = idx.sharded()
    d_mesh, i_mesh = sharded.search(queries, k=10, ef_search=64)
    assert recall_at_k(i_mesh, gt, 10) >= 0.9
    # same sub-graphs, same ef ⇒ identical result sets
    same = sum(
        set(a.tolist()) == set(b.tolist()) for a, b in zip(i_host, i_mesh)
    )
    assert same >= int(0.95 * len(i_host))


def test_partitioned_save_load(tmp_path, data):
    base, queries, _ = data
    idx = PartitionedHnswIndex(
        HnswConfig(**CFG), n_partitions=4, router="centroid"
    )
    idx.build(base[:1000])
    d1, i1 = idx.search(queries, k=5, ef_search=40)
    idx.save(str(tmp_path / "pidx"))
    idx2 = PartitionedHnswIndex.load(str(tmp_path / "pidx"))
    d2, i2 = idx2.search(queries, k=5, ef_search=40)
    assert (i1 == i2).all()


def test_block_engine_partitions_device_merge(data):
    """engine='block' partitions (config D shape: hash-partitioned blocked
    shards on one chip) + the device-side fan-out merge: results must
    match the exact oracle at exhaustive probes, through save/load."""
    base, queries, gt = data
    cfg = HnswConfig(**CFG)
    pidx = PartitionedHnswIndex(
        cfg, n_partitions=4, router="hash", engine="block", block_size=64
    )
    pidx.build(base)
    d, ids = pidx.search_device(queries, k=10, ef_search=64,
                                probes=pidx.parts[0].n_blocks)
    ids = np.asarray(ids)
    assert recall_at_k(ids, gt, 10) >= 0.999  # exhaustive probes = exact
    # distances ascending per row, global ids in range
    d = np.asarray(d)
    assert (np.diff(d, axis=1) >= -1e-5).all()
    assert ids.max() < len(base) and (ids >= 0).all()
    # host-loop path agrees at the same operating point
    _, ids2 = pidx.search(queries, k=10, ef_search=64)
    assert recall_at_k(np.asarray(ids2), gt, 10) >= 0.9
    # save/load round-trip keeps the engine and results
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        pidx.save(td)
        re = PartitionedHnswIndex.load(td)
        assert re.engine == "block"
        _, ids3 = re.search_device(queries, k=10, ef_search=64,
                                   probes=re.parts[0].n_blocks)
        np.testing.assert_array_equal(ids, np.asarray(ids3))


def test_ring_merge_matches_all_gather(data):
    """ppermute ring merge == all_gather merge, bit-identical (the
    alternative ICI collective, SURVEY §5 comm backend)."""
    base, queries, gt = data
    cfg = HnswConfig(**CFG)
    pidx = PartitionedHnswIndex(cfg, n_partitions=8, router="hash")
    pidx.build(base)
    sharded = pidx.sharded()
    d_ag, i_ag = sharded.search(queries, k=10, ef_search=64)
    d_rg, i_rg = sharded.search(queries, k=10, ef_search=64, merge="ring")
    np.testing.assert_array_equal(i_ag, i_rg)
    np.testing.assert_allclose(d_ag, d_rg, rtol=1e-6)
    assert recall_at_k(i_rg, gt, 10) >= 0.9


def test_hierarchical_merge_2d_mesh(data):
    """Two-level (intra-slice ICI, cross-slice DCN) merge on a 2x4
    virtual mesh equals the flat global top-k — the multi-slice config-E
    program structure."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from tpu_hnsw.parallel.collectives import (
        gather_merge_topk,
        hierarchical_merge_topk,
    )

    base, queries, gt = data
    k = 10
    rng = np.random.default_rng(5)
    # 8 shards of synthetic per-shard top-k candidate lists
    d_parts = rng.random((8, len(queries), k)).astype(np.float32)
    i_parts = rng.integers(0, 4000, size=(8, len(queries), k)).astype(np.int32)
    mesh = jax.make_mesh((2, 4), ("slice", "chip"))

    def body(d, i):
        return hierarchical_merge_topk(d[0], i[0], k, "chip", "slice")

    fn = jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(("slice", "chip")), P(("slice", "chip"))),
        out_specs=(P(), P()),
        check_vma=False,
    ))
    d_out, i_out = fn(jnp.asarray(d_parts), jnp.asarray(i_parts))
    # flat oracle: global top-k over all shards
    flat_d = d_parts.transpose(1, 0, 2).reshape(len(queries), -1)
    flat_i = i_parts.transpose(1, 0, 2).reshape(len(queries), -1)
    order = np.argsort(flat_d, axis=1)[:, :k]
    np.testing.assert_allclose(
        np.asarray(d_out), np.take_along_axis(flat_d, order, axis=1),
        rtol=1e-6,
    )
    np.testing.assert_array_equal(
        np.asarray(i_out), np.take_along_axis(flat_i, order, axis=1)
    )


def test_sharded_block_matches_host_loop(data):
    """Config E composition (VERDICT r2 #1): BLOCK-engine shards under
    shard_map + ICI all_gather merge must match the host-loop block
    search on the same shards at the same operating point."""
    base, queries, gt = data
    cfg = HnswConfig(**CFG)
    pidx = PartitionedHnswIndex(
        cfg, n_partitions=8, router="centroid", engine="block", block_size=64
    )
    pidx.build(base)
    sh = pidx.sharded()
    probes = max(s.n_blocks for s in pidx.parts)
    # exhaustive probes + all-partition routing: mesh == device fan-out
    d_host, i_host = pidx.search_device(queries, k=10, ef_search=64,
                                        probes=probes)
    d_mesh, i_mesh = sh.search(queries, k=10, probes=probes, route_k=8)
    i_host = np.asarray(i_host)
    same = sum(
        set(a.tolist()) == set(b.tolist()) for a, b in zip(i_host, i_mesh)
    )
    assert same >= int(0.95 * len(i_host)), f"only {same} rows match"
    assert recall_at_k(i_mesh, gt, 10) >= 0.999  # exhaustive = exact-grade
    # distances in operator units, ascending
    assert (np.diff(d_mesh, axis=1) >= -1e-5).all()
    # routed subset (route_k=2) trades recall monotonically
    _, i_r2 = sh.search(queries, k=10, ef_search=64, route_k=2)
    r2 = recall_at_k(i_r2, gt, 10)
    assert 0.5 < r2 <= recall_at_k(i_mesh, gt, 10) + 1e-9
    # ring merge identical to all_gather
    d_rg, i_rg = sh.search(queries, k=10, probes=probes, route_k=8,
                           merge="ring")
    np.testing.assert_array_equal(i_mesh, i_rg)
    # stats reports mesh memory
    st = sh.stats()
    assert st["n"] == len(base) and st["memory_total_bytes"] > 0


def test_sharded_block_single_device_multi_partition(data):
    """Config D's serving shape: MANY partitions on ONE device. A 1-device
    mesh makes local_p = P, so the whole fan-out + merge compiles into a
    single program (vs P host-loop dispatches per batch). Must match the
    host-loop fan-out and the 8-device mesh exactly at exhaustive probes,
    and device-resident batches must route on device (no host round
    trip) with identical results."""
    import jax.numpy as jnp

    base, queries, gt = data
    cfg = HnswConfig(**CFG)
    pidx = PartitionedHnswIndex(
        cfg, n_partitions=4, router="hash", engine="block", block_size=64
    )
    pidx.build(base)
    sh1 = pidx.sharded(jax.make_mesh((1,), ("shard",)))
    probes = max(s.n_blocks for s in pidx.parts)
    d_host, i_host = pidx.search_device(queries, k=10, ef_search=64,
                                        probes=probes)
    i_host = np.asarray(i_host)
    d_one, i_one = sh1.search(queries, k=10, probes=probes, route_k=4)
    same = sum(
        set(a.tolist()) == set(b.tolist()) for a, b in zip(i_host, i_one)
    )
    assert same >= int(0.95 * len(i_host)), f"only {same} rows match"
    assert recall_at_k(i_one, gt, 10) >= 0.999
    # device-resident batch: same results through the device-routing path
    d_dev, i_dev = sh1.search_device(jnp.asarray(queries), k=10,
                                     probes=probes, route_k=4)
    np.testing.assert_array_equal(np.asarray(i_dev), i_one)
    # centroid router: device routing == host routing on a routed subset
    cidx = PartitionedHnswIndex(
        cfg, n_partitions=4, router="centroid", engine="block", block_size=64
    )
    cidx.build(base)
    shc = cidx.sharded(jax.make_mesh((1,), ("shard",)))
    _, i_h = shc.search(queries, k=10, ef_search=64, route_k=2)
    _, i_d = shc.search_device(jnp.asarray(queries), k=10, ef_search=64,
                               route_k=2)
    np.testing.assert_array_equal(np.asarray(i_d), i_h)
    # releasing the per-shard device copies keeps the stacked searcher alive
    sh1.release_parts_device_state()
    _, i_after = sh1.search(queries, k=10, probes=probes, route_k=4)
    np.testing.assert_array_equal(i_after, i_one)


def test_sharded_block_exhaustive_scan_stages_per_device(data, monkeypatch):
    """Exhaustive probes on shards past EXHAUSTIVE_SCAN_MIN_BLOCKS stream
    each shard once on both paths (the per-query gather would materialize
    Q x shard bytes) and agree exactly; sharded() stages each partition
    on its own mesh device, never all of them on one."""
    from tpu_hnsw.index.block import BlockHnswIndex

    monkeypatch.setattr(BlockHnswIndex, "EXHAUSTIVE_SCAN_MIN_BLOCKS", 4)
    base, queries, gt = data
    pidx = PartitionedHnswIndex(
        HnswConfig(**CFG), n_partitions=4, router="hash", engine="block",
        block_size=64,
    ).build(base)
    mesh = jax.make_mesh((4,), ("shard",))
    sh = pidx.sharded(mesh)
    probes = max(s.n_blocks for s in pidx.parts)
    assert probes > BlockHnswIndex.EXHAUSTIVE_SCAN_MIN_BLOCKS
    _, i_host = pidx.search_device(queries, k=10, probes=probes)
    _, i_mesh = sh.search(queries, k=10, probes=probes, route_k=4)
    for a, b in zip(np.asarray(i_host), i_mesh):
        assert set(a.tolist()) == set(b.tolist())
    assert recall_at_k(i_mesh, gt, 10) >= 0.999
    devs = list(mesh.devices.reshape(-1))
    for arr in (sh.blocks, sh.blocks_score, sh.block_gids, sh.centroids):
        for shard in arr.addressable_shards:
            i = devs.index(shard.device)
            assert shard.index[0] == slice(i, i + 1, None)
            assert shard.data.shape[0] == 1


def test_sharded_block_refuses_uncompacted_tail(data):
    base, _, _ = data
    cfg = HnswConfig(**CFG)
    pidx = PartitionedHnswIndex(
        cfg, n_partitions=4, router="hash", engine="block", block_size=64
    )
    pidx.build(base[:1000])
    pidx.parts[0].add(base[1000:1004])
    with pytest.raises(ValueError, match="tail"):
        pidx.sharded()


def test_routing_uses_raw_queries_for_cosine():
    """Route-before-normalize regression (round 4): the router's
    centroids live in raw space, so the mesh searchers must route with
    RAW queries and normalize only for scoring. Routing normalized
    queries against raw centroids measured recall 0.62 vs 0.95 at
    route_k=2 on config-E-shaped data (the r3 'routing cliff')."""
    import jax

    from tpu_hnsw import FlatIndex
    from tpu_hnsw.io.datasets import synthetic_clustered

    base, queries = synthetic_clustered(6000, 64, n_queries=32, seed=29)
    cfg = HnswConfig(dim=64, metric=Metric.COSINE, dtype="bfloat16", seed=0)
    pidx = PartitionedHnswIndex(cfg, n_partitions=4, router="centroid",
                                engine="block", block_size=64)
    pidx.build(base)
    mesh = jax.make_mesh((4,), ("shard",))
    sh = pidx.sharded(mesh)
    _, hi = pidx.search(queries, k=10, ef_search=64, route_k=2)
    _, mi = sh.search(queries, k=10, ef_search=64, route_k=2)
    gt = FlatIndex(base, Metric.COSINE).search(queries, k=10)[1]

    def rec(ids):
        return np.mean([len(set(ids[r].tolist()) & set(gt[r].tolist())) / 10
                        for r in range(len(ids))])

    # the mesh path must not trail the host loop (same router, same shards)
    assert rec(np.asarray(mi)) >= rec(np.asarray(hi)) - 0.03
