#!/usr/bin/env python
"""Config E mechanism demo — LAION-100M shape (BASELINE.md:23), scaled.

Config E is 100M x 512-d bf16, CENTROID-partitioned across devices
(all_gather merge). This script demonstrates the full mechanism on the
virtual 8-device CPU mesh (the same shard_map/all_gather program a
multi-GPU host runs — SURVEY §4 multi-device-without-a-cluster) at a
scaled-down corpus, and records the per-card memory arithmetic for the
real 100M deployment on four H100s from live bytes/element.

The shards are BLOCK-engine (``BlockHnswIndex``) — the engine that fits
config E's memory budget (~1.1kB/elem at 512d bf16 vs the graph
engine's ~3.3kB, scripts/config_e_shard.py) — served by
``ShardedBlockSearcher`` (shard_map + all_gather merge). The demo
cross-checks the mesh program against the host-loop fan-out on the same
shards.

Run: JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
     python scripts/config_e.py
(or let it force the CPU mesh itself, like tests/conftest.py).

Writes benchmarks/config_e_mesh_demo.json.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# force the 8-device CPU mesh BEFORE first backend use
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)
import jax

if jax.config.jax_platforms != "cpu":
    try:
        jax.config.update("jax_platforms", "cpu")
    except RuntimeError:
        pass

import numpy as np


def main():
    n = int(os.environ.get("TPU_HNSW_E_N", 100_000))
    dim = 512
    n_parts = 8
    n_queries = 256
    block_size = 64  # scaled with the demo corpus (real E uses 256)

    from tpu_hnsw import FlatIndex, HnswConfig, Metric
    from tpu_hnsw.parallel.partition import PartitionedHnswIndex
    from tpu_hnsw.io.datasets import synthetic_clustered
    from tpu_hnsw.utils.recall import recall_at_k

    assert jax.devices()[0].platform == "cpu" and len(jax.devices()) >= 8
    mesh = jax.make_mesh((n_parts,), ("shard",))

    base, queries = synthetic_clustered(n, dim, n_queries=n_queries, seed=29)
    cfg = HnswConfig(dim=dim, metric=Metric.COSINE, m=16, ef_construction=64,
                     dtype="bfloat16", wave_size=1024, seed=0)

    t0 = time.perf_counter()
    pidx = PartitionedHnswIndex(cfg, n_partitions=n_parts, router="centroid",
                                engine="block", block_size=block_size)
    pidx.build(base)
    build_s = time.perf_counter() - t0

    flat = FlatIndex(base, Metric.COSINE)
    _, gt = flat.search(queries, k=10)

    sharded = pidx.sharded(mesh)  # ShardedBlockSearcher: shard_map + merge
    max_probes = max(s.n_blocks for s in pidx.parts)

    # mesh program == host-loop fan-out on the same shards (exhaustive)
    _, i_mesh = sharded.search(queries, k=10, probes=max_probes,
                               route_k=n_parts)
    _, i_host = pidx.search_device(queries, k=10, probes=max_probes)
    i_host = np.asarray(i_host)
    match_rows = int(sum(
        set(a.tolist()) == set(b.tolist()) for a, b in zip(i_host, i_mesh)
    ))

    rows = []
    for route_k in (2, 4, 8):
        for ef in (64, 128, 256):
            t0 = time.perf_counter()
            _, ids = sharded.search(queries, k=10, ef_search=ef,
                                    route_k=route_k)
            dt = time.perf_counter() - t0
            rows.append({
                "route_k": route_k,
                "ef_search": ef,
                "probes": sharded.probes_for_ef(ef),
                "recall_at_10": round(
                    float(recall_at_k(np.asarray(ids), gt, 10)), 4),
                "wall_s": round(dt, 3),
            })
            print(rows[-1], flush=True)

    # per-card memory arithmetic for the REAL config E from live stats:
    # demo-scale per-shard bytes (small-n padding inflates it) plus the
    # 4M-row shard measurement (scripts/config_e_shard.py: 1087.9)
    per_elem_demo = float(np.mean([
        p.stats()["memory_total_bytes"] / max(p.n, 1)
        for p in pidx.parts if p.n
    ]))
    per_elem_at_scale = 1087.9  # measured, 4M x 512d bf16 shard
    cards, card_gib = 4, 80  # four H100 80GB; JAX takes 3/4 of each
    rows_per_card_100m = 100_000_000 // cards
    mesh_stats = sharded.stats()
    out = {
        "config": "E (LAION-100M shape) — block-engine shards on virtual "
                  "8-dev mesh (shard_map + all_gather merge)",
        "dataset": "synthetic-clustered",
        "n": n, "dim": dim, "metric": "cosine", "dtype": "bfloat16",
        "partitions": n_parts, "router": "centroid",
        "engine": "hnsw-block", "block_size": block_size,
        "mesh": "8-device virtual CPU (shard_map + all_gather merge)",
        "build_s": round(build_s, 1),
        "mesh_matches_host_loop_rows": match_rows,
        "mesh_match_total_rows": int(n_queries),
        "route_sweep": rows,
        "mesh_stats": mesh_stats,
        "bytes_per_element_demo_scale": round(per_elem_demo, 1),
        "bytes_per_element_at_scale": per_elem_at_scale,
        "bytes_per_element_at_scale_source":
            "scripts/config_e_shard.py (4M x 512d bf16 shard)",
        "per_card_100m_projection_gib": round(
            per_elem_at_scale * rows_per_card_100m / 2**30, 2
        ),
        "card_memory_gib": card_gib,
        "fits_100m_on_4_cards": bool(
            per_elem_at_scale * rows_per_card_100m < 0.75 * card_gib * 2**30
        ),
    }
    os.makedirs("benchmarks", exist_ok=True)
    with open("benchmarks/config_e_mesh_demo.json", "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items() if k != "route_sweep"}))


if __name__ == "__main__":
    main()
