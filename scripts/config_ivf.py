"""IVFFlat serving numbers — the reference's second index AM, measured.

Upstream sizing guidance (pgvector README): lists ~ rows/1000 for up to
1M rows, probed with ``ivfflat.probes``. This measures the IVFFlat engine
(`index/ivf.py`: padded [lists, maxlen, d] block tensor; a probe is one
contiguous block gather + one matmul) at the config-B shape with the
standard probes sweep, so the IVF AM carries a measured recall/QPS curve
like every other engine.

Writes benchmarks/ivfflat.json.
Run: python scripts/config_ivf.py
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    n = int(os.environ.get("TPU_HNSW_N", 1_000_000))
    dim = 128
    lists = int(os.environ.get("TPU_HNSW_LISTS", max(100, n // 1000)))
    n_queries = 4096

    from tpu_hnsw import FlatIndex, IvfFlatIndex, Metric
    from tpu_hnsw.io.datasets import synthetic_clustered
    from tpu_hnsw.utils.evalharness import measure_qps
    from tpu_hnsw.utils.recall import recall_at_k

    base, queries = synthetic_clustered(n, dim, n_queries=n_queries, seed=42)

    t0 = time.perf_counter()
    idx = IvfFlatIndex(dim, Metric.L2, lists=lists).build(base)
    build_s = time.perf_counter() - t0
    print(f"build {build_s:.1f}s lists={lists}", flush=True)

    gt = FlatIndex(base, Metric.L2).search(queries, k=10)[1]

    rows = []
    for probes in (1, 2, 4, 8, 16, 32):
        st = {}
        qps, ids = measure_qps(idx, queries, 10, 0, pipeline=4,
                               stats_out=st, probes=probes)
        r = recall_at_k(ids, gt, 10)
        row = {"probes": probes,
               "recall_at_10": round(float(r), 4),
               "qps": round(float(qps), 1),
               "qps_cv": st.get("qps_cv")}
        rows.append(row)
        print(row, flush=True)

    out = {
        "config": f"IVFFlat {n}x{dim} L2, lists={lists} (rows/1000 per "
                  "upstream guidance), probes sweep",
        "n": n, "dim": dim, "lists": lists,
        "build_s": round(build_s, 1),
        "dataset": "synthetic-clustered",
        "sweep": rows,
    }
    os.makedirs("benchmarks", exist_ok=True)
    with open("benchmarks/ivfflat.json", "w") as f:
        json.dump(out, f, indent=1)
    print("wrote benchmarks/ivfflat.json", flush=True)


if __name__ == "__main__":
    main()
