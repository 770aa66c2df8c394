#!/usr/bin/env python
"""Config E per-shard capacity proof on REAL hardware (BASELINE.md:23).

Config E is LAION-100M 512-d bf16, centroid-partitioned across devices.
This script builds and serves a 12.5M x 512d bf16 blocked shard on one
device, proving the per-device memory fit and measuring shard-local QPS
(the multi-device merge is checked by `chip_smoke.py --four-cards` and
on the virtual mesh by scripts/config_e.py).

Data is GENERATED ON DEVICE (jax PRNG): production config-E ingest is
accelerator-resident embeddings, and a 25.6GB host corpus would put the
upload inside the build.

Writes benchmarks/config_e_shard.json.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    # 4M demo rows: BUILDING holds corpus + gather + packed blocks
    # (~3x the corpus bytes in the eager install path); SERVING needs
    # only the packed index, so the 12.5M/chip fit is projected from
    # measured bytes/element below (production builds stream the corpus
    # in slabs or build at partial occupancy and add() the rest).
    n = int(os.environ.get("TPU_HNSW_E_SHARD_N", 4_000_000))
    dim = 512
    n_queries = 1024

    import jax
    import jax.numpy as jnp
    from tpu_hnsw import BlockHnswIndex, HnswConfig, Metric
    from tpu_hnsw.utils.evalharness import measure_qps
    from tpu_hnsw.utils.recall import recall_at_k

    # clustered synthetic, generated on device in slabs: cluster centers
    # + gaussian noise, L2-normalized (LAION embeddings are unit-norm)
    k0 = jax.random.PRNGKey(0)
    n_clusters = 4096
    centers = jax.random.normal(k0, (n_clusters, dim), jnp.float32)

    def gen_slab(centers, key, count):
        ka, kb = jax.random.split(key)
        which = jax.random.randint(ka, (count,), 0, n_clusters)
        x = centers[which] + 0.3 * jax.random.normal(
            kb, (count, dim), jnp.float32
        )
        x = x / jnp.linalg.norm(x, axis=1, keepdims=True)
        # bf16 INSIDE the jit: an eager astype would keep f32 slabs alive
        # alongside their bf16 copies (3x the corpus at peak)
        return x.astype(jnp.bfloat16)

    # centers passed as an ARG: a closure would bake an 8MB constant into
    # every compiled program
    gen_slab = jax.jit(gen_slab, static_argnums=(2,))

    slab = 500_000  # n/8: bounded peak while assembling the bf16 store
    parts = []
    for i in range(n // slab):
        parts.append(gen_slab(centers, jax.random.PRNGKey(i + 1), slab))
    base_dev = jnp.concatenate(parts)  # [n, dim] bf16 on device (12.8GB)
    del parts
    jax.block_until_ready(base_dev)
    queries = np.asarray(
        gen_slab(centers, jax.random.PRNGKey(777), n_queries)
    ).astype(np.float32)

    cfg = HnswConfig(dim=dim, metric=Metric.COSINE, m=16, ef_construction=64,
                     dtype="bfloat16", seed=0)
    t0 = time.perf_counter()
    idx = BlockHnswIndex(cfg, block_size=256).build(base_dev)
    jax.block_until_ready(idx.blocks)
    build_s = time.perf_counter() - t0
    del base_dev

    mem = {}
    try:
        ms = jax.devices()[0].memory_stats() or {}
        mem = {kk: ms[kk] for kk in ("bytes_in_use", "bytes_limit",
                                     "peak_bytes_in_use") if kk in ms}
    except Exception:
        pass

    # shard-local recall oracle: exhaustive probes over a query subset
    _, gt = idx.search(queries[:256], k=10, probes=idx.n_blocks)
    rows = []
    for ef in (32, 64, 128):
        probes = idx.probes_for_ef(ef)
        st = {}
        qps, ids = measure_qps(idx, queries, 10, ef, probes=probes,
                               pipeline=2, stats_out=st)
        rows.append({
            "ef_search": ef,
            "probes": probes,
            "recall_at_10_vs_exhaustive": round(
                float(recall_at_k(ids[:256], np.asarray(gt), 10)), 4
            ),
            "qps": round(float(qps), 1),
            "qps_cv": st.get("qps_cv"),
        })
        print(rows[-1], flush=True)

    out = {
        "config": "E per-shard (LAION-100M / 8 = 12.5M x 512d bf16)",
        "n": n, "dim": dim, "metric": "cosine", "dtype": "bfloat16",
        "engine": "hnsw-block", "block_size": 256,
        "n_blocks": idx.n_blocks,
        "build_s_device_resident": round(build_s, 1),
        "build_vectors_per_sec": round(n / build_s, 1),
        "build_stages": getattr(idx, "build_stats", {}),
        "index_stats": {k: v for k, v in idx.stats().items()
                        if k in ("memory_total_bytes", "bytes_per_element",
                                 "fill_factor")},
        "per_chip_12_5m_projection_gb": round(
            idx.stats()["bytes_per_element"] * 12_500_000 / 2**30, 2
        ),
        "fits_12_5m_serving": bool(
            idx.stats()["bytes_per_element"] * 12_500_000 < 15.5 * 2**30
        ),
        "device_memory": mem,
        "sweep": rows,
    }
    os.makedirs("benchmarks", exist_ok=True)
    with open("benchmarks/config_e_shard.json", "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items() if k != "sweep"}))


if __name__ == "__main__":
    main()
