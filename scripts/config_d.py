#!/usr/bin/env python
"""Config D artifact — DEEP-10M-shaped run (BASELINE.md:22).

10M x 96-d inner-product, 8-way HASH-partitioned on ONE chip: verifies
routed query + global top-k merge correctness at scale and measures QPS.
Partitions are BlockHnswIndex shards served through ShardedBlockSearcher
on a 1-DEVICE mesh: local_p = 8, so the whole fan-out (route -> expand
-> rerank per partition) plus the global top-k merge compiles into ONE
program and a batch costs one dispatch instead of the host-loop
fan-out's 8 dispatches plus per-batch host routing. Equivalence of the
two paths is pinned by
tests/test_partition.py::test_sharded_block_single_device_multi_partition.

Memory check: 10M x 96 f32 blocks = 3.84 GB + int8 scoring copy; the
stacked serving state duplicates the per-shard arrays, so the shard
copies are RELEASED after assembly (release_parts_device_state) —
peak ~10.4 GB during assembly, ~5.2 GB steady (recorded in the artifact
from live device stats).

Writes benchmarks/config_d.json.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    n = int(os.environ.get("TPU_HNSW_D_N", 10_000_000))
    dim = 96
    n_parts = 8
    n_queries = int(os.environ.get("TPU_HNSW_D_Q", 8192))

    import jax
    from tpu_hnsw import FlatIndex, HnswConfig, Metric
    from tpu_hnsw.parallel.partition import PartitionedHnswIndex
    from tpu_hnsw.io.datasets import synthetic_clustered
    from tpu_hnsw.utils.evalharness import measure_qps
    from tpu_hnsw.utils.recall import recall_at_k

    base, queries = synthetic_clustered(n, dim, n_queries=n_queries, seed=13)
    # DEEP's 96-d vectors are PCA-projected near-unit-norm; IP over raw
    # gaussian mixtures is pathological for ANY clustered/partitioned
    # layout (top-IP results concentrate in global high-norm outliers).
    # Normalize rows so the synthetic stand-in matches DEEP's geometry.
    base /= np.maximum(np.linalg.norm(base, axis=1, keepdims=True), 1e-12)
    queries /= np.maximum(
        np.linalg.norm(queries, axis=1, keepdims=True), 1e-12
    )

    # merge correctness: partitioned top-k must equal the unpartitioned
    # exact top-k for exhaustive per-partition search (the config-D
    # "global top-k merge correctness" requirement) — checked via recall
    # against the exact oracle over the FULL table. Oracle FIRST, then
    # freed: 10M x 96 f32 is 3.84GB, and oracle + 8 block shards
    # (f32 + scoring copy) need not share the device's memory.
    oracle = FlatIndex(base, Metric.IP)
    gt = oracle.search(queries, k=10, exact=True)[1]
    # the brute-force floor the index must beat: the
    # planner's seqscan alternative at this exact shape, fetch-timed on
    # the same harness, recorded IN the artifact next to the sweep
    fst = {}
    flat_qps, fids = measure_qps(oracle, queries, 10, 0, pipeline=2,
                                 stats_out=fst)
    scan_floor = {
        "qps": round(float(flat_qps), 1),
        "recall_at_10": round(float(recall_at_k(fids, gt, 10)), 4),
        "qps_cv": fst.get("qps_cv"),
        "what": "FlatIndex streamed scan + exact rerank over all 10M "
                "rows on device (the hnswcostestimate seqscan plan)",
    }
    print({"scan_floor": scan_floor}, flush=True)
    del oracle
    import gc

    gc.collect()

    cfg = HnswConfig(dim=dim, metric=Metric.IP, m=16, ef_construction=64,
                     seed=0)
    t0 = time.perf_counter()
    pidx = PartitionedHnswIndex(cfg, n_partitions=n_parts, router="hash",
                                engine="block", block_size=256)
    pidx.build(base)
    build_s = time.perf_counter() - t0

    # one-device mesh: the 8-partition fan-out + merge as ONE program
    sh = pidx.sharded(jax.make_mesh((1,), ("shard",)))
    sh.release_parts_device_state()  # drop the duplicate shard copies

    rows = []
    for ef in (16, 32, 64, 128):
        probes = sh.probes_for_ef(ef)
        # Bigger query chunks amortize per-dispatch fixed cost. Bound the
        # chunk by the [chunk, 8*probes, S, dp] int8 gather intermediate.
        pp_total = probes * n_parts
        per_q = pp_total * 256 * 128  # intermediate bytes per query
        # ~8.5GB of gather intermediate budget; on OOM the except path
        # below halves back.
        chunk = 512
        while chunk * 2 <= min(8192, 8_500_000_000 // per_q):
            chunk *= 2
        while chunk > 512:
            try:
                st = {}
                qps, ids = measure_qps(sh, queries, 10, ef, probes=probes,
                                       pipeline=max(1, n_queries // chunk),
                                       stats_out=st)
                break
            except Exception as e:
                print(f"chunk {chunk} failed ({str(e)[:120]}); halving",
                      flush=True)
                chunk //= 2
        else:
            st = {}
            qps, ids = measure_qps(sh, queries, 10, ef, probes=probes,
                                   pipeline=max(1, n_queries // chunk),
                                   stats_out=st)
        if (st.get("qps_cv") or 0) > 0.10:
            # re-measure with double-length windows until the <=10%
            # reproducibility bar holds
            st = {}
            qps, ids = measure_qps(sh, queries, 10, ef, probes=probes,
                                   pipeline=max(1, n_queries // chunk),
                                   stats_out=st,
                                   repeats=16, min_window_s=1.0)
        rows.append({
            "ef_search": ef,
            "probes_per_partition": probes,
            "chunk": chunk,
            "recall_at_10": round(float(recall_at_k(ids, gt, 10)), 4),
            "qps": round(float(qps), 1),
            "qps_cv": st.get("qps_cv"),
        })
        print(rows[-1], flush=True)

    mem = {}
    try:
        ms = jax.devices()[0].memory_stats() or {}
        mem = {k: ms[k] for k in ("bytes_in_use", "bytes_limit") if k in ms}
    except Exception:
        pass

    out = {
        "config": "D (DEEP-10M shape)",
        "dataset": "synthetic-clustered",
        "n": n, "dim": dim, "metric": "ip",
        "partitions": n_parts, "router": "hash",
        "engine": "hnsw-block", "block_size": 256,
        "serving": "ShardedBlockSearcher on a 1-device mesh (local_p=8: "
        "fan-out + merge in ONE program per batch)",
        "build_s": round(build_s, 1),
        "build_vectors_per_sec": round(n / build_s, 1),
        "device_memory": mem,
        "serving_memory": sh.stats(),
        "scan_floor": scan_floor,
        "sweep": rows,
    }
    os.makedirs("benchmarks", exist_ok=True)
    with open("benchmarks/config_d.json", "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items() if k != "sweep"}))


if __name__ == "__main__":
    main()
