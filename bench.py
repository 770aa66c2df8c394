#!/usr/bin/env python
"""Headline benchmark — prints ONE JSON line for the driver.

Headline metric: QPS per device at recall@10 >= 0.95 on SIFT1M-class
data (128-d L2, m=16, ef_construction=64). Build throughput is reported
in "extra".

The measured engine is the HNSW index itself — the flagship
BlockHnswIndex (HNSW routing graph over cluster-blocked level 0; see
tpu_hnsw/index/block.py for why classical per-row level 0 cannot run at
device-memory speed). The classical graph-traversal engine (HnswIndex,
batched beam search) and the flat exact scan (the seqscan analogue) are
reported in "extra" every round and never carry the headline.

Real SIFT files are used when present under $TPU_HNSW_DATA; otherwise a
synthetic stand-in of the same shape is generated (this environment has
no network access): $TPU_HNSW_BENCH_DATASET=clustered (default; Gaussian
mixture, the SIFT-like case) or =uniform (the hard-mode control with no
cluster structure — see scripts/uniform_control.py). Size via
$TPU_HNSW_BENCH_N (default 1,000,000 = config B shape, BASELINE.md).

Measurement protocol: fixed-duration timing windows, async dispatch
pipeline, >=10 windows, median reported, coefficient of variation in
"extra" (<=10% reproducibility bar). Builds get the same treatment:
several measured builds after a warmup build, median reported with the
full run list.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np


def main():
    n = int(os.environ.get("TPU_HNSW_BENCH_N", 1_000_000))
    dim = int(os.environ.get("TPU_HNSW_BENCH_D", 128))
    n_queries = int(os.environ.get("TPU_HNSW_BENCH_Q", 4096))
    block_size = int(os.environ.get("TPU_HNSW_BLOCK_SIZE", 256))
    target_recall = float(os.environ.get("TPU_HNSW_TARGET_RECALL", 0.95))
    dtype = os.environ.get("TPU_HNSW_BENCH_DTYPE", "float32")
    synth = os.environ.get("TPU_HNSW_BENCH_DATASET", "clustered")
    with_graph = os.environ.get("TPU_HNSW_BENCH_GRAPH", "1") != "0"

    from tpu_hnsw import (BlockHnswIndex, FlatIndex, HnswConfig, HnswIndex,
                          Metric)
    from tpu_hnsw.io.datasets import (load_or_synthesize, synthetic_clustered,
                                      synthetic_uniform)
    from tpu_hnsw.utils.evalharness import measure_qps
    from tpu_hnsw.utils.recall import recall_at_k

    data_dir = os.environ.get("TPU_HNSW_DATA")
    # Named real-data hook: TPU_HNSW_BENCH_DATASET may be a
    # BASELINE.json config name; the expected files under $TPU_HNSW_DATA
    # are <name>_base.fvecs / <name>_query.fvecs / <name>_groundtruth.ivecs
    # (see io/datasets.load_or_synthesize). With the files present, every
    # number below regenerates on real data with one env var; without
    # them, an equivalently-shaped synthetic stand-in is used.
    if synth in ("sift10k", "sift1m", "glove100", "deep10m"):
        base, queries, _ = load_or_synthesize(synth, data_dir)
        n, dim = base.shape
        queries = queries[:n_queries]
        n_queries = len(queries)
        real = bool(data_dir) and os.path.exists(
            os.path.join(data_dir, f"{synth}_base.fvecs"))
        dataset = synth if real else f"{synth}-synthetic-standin"
    elif data_dir and n >= 1_000_000:
        base, queries, _ = load_or_synthesize("sift1m", data_dir)
        base, queries = base[:n], queries[:n_queries]
        dataset = "sift1m"
    elif synth == "uniform":
        base, queries = synthetic_uniform(n, dim, n_queries=n_queries, seed=42)
        dataset = "synthetic-uniform"
    else:
        base, queries = synthetic_clustered(n, dim, n_queries=n_queries,
                                            seed=42)
        dataset = "synthetic-clustered"

    import jax
    import jax.numpy as jnp

    cfg = HnswConfig(dim=dim, m=16, ef_construction=64, seed=0, dtype=dtype)

    # build once at the SAME n to pay XLA compilation (program shapes
    # depend on n, so a smaller warmup would not warm them), then measure
    # several builds per input mode and report the median
    def drain_build(bx):
        jax.block_until_ready(bx.blocks)
        np.asarray(bx.blocks_sq[0])

    t0 = time.perf_counter()
    widx = BlockHnswIndex(cfg, block_size=block_size).build(base)
    drain_build(widx)
    t_warm = time.perf_counter() - t0
    block_bytes_per_elem = widx.stats()["bytes_per_element"]
    del widx

    def timed_build(inp):
        t0 = time.perf_counter()
        bx = BlockHnswIndex(cfg, block_size=block_size).build(inp)
        drain_build(bx)
        return time.perf_counter() - t0, dict(bx.build_stats), bx

    # several measured builds per input mode, median reported: host-side
    # stages (greedy pack, result fetch) share the host's cores and vary
    def median_build(inp, runs=3):
        times, stages_list, keep = [], [], None
        for _ in range(runs):
            t, st, bx = timed_build(inp)
            times.append(t)
            stages_list.append(st)
            if keep is None or t <= min(times[:-1], default=t):
                keep = bx  # fastest build serves the QPS phase
            else:
                del bx
        med = float(np.median(times))
        stages = stages_list[int(np.argsort(times)[len(times) // 2])]
        stages["build_runs_s"] = [round(t, 2) for t in sorted(times)]
        return med, stages, keep

    # host-input builds (pay the host->device upload)
    med_host, host_stages, idx = median_build(base)
    build_vps = n / med_host

    # device-resident builds: ingest is accelerator-resident embeddings
    # (the production shape — embedding models run on the same devices).
    # FIVE runs: this is the headline build figure; a median of 5
    # rejects two bad draws.
    xdev = jax.block_until_ready(jnp.asarray(base))
    med_dev, dev_stages, bx = median_build(xdev, runs=5)
    del bx
    build_vps_dev = n / med_dev
    del xdev

    oracle = FlatIndex(base, Metric.L2)
    gt = oracle.search(queries, k=10, exact=True)[1]

    # operating-point search on the FULL measured query set (selecting on
    # a subset lets recall drift between selection and measurement);
    # pow2 probes keep the compile count bounded
    probe_grid = [p for p in (4, 8, 16, 32, 64, 128) if p <= idx.n_blocks]
    chosen, chosen_recall = probe_grid[-1], 0.0
    for p in probe_grid:
        _, ids = idx.search(queries, k=10, probes=p)
        r = recall_at_k(ids, gt, 10)
        if r >= target_recall:
            chosen, chosen_recall = p, r
            break
        chosen_recall = r
    mstats = {}
    # one full-width chunk per dispatch (pipeline=1): per-dispatch fixed
    # costs amortize over the whole query set
    hnsw_qps, ids = measure_qps(
        idx, queries, 10, 4 * chosen, probes=chosen, pipeline=1,
        stats_out=mstats
    )
    hnsw_recall = recall_at_k(ids, gt, 10)

    # device-side filtered scan (target: filtered QPS within 2x of
    # unfiltered at a selective predicate): 10% of ids pass; recall
    # graded against the exact filtered oracle
    fmask = np.random.default_rng(17).random(n) < 0.10
    allowed_ids = np.where(fmask)[0]
    fsub = FlatIndex(base[allowed_ids], Metric.L2)
    fgt_local = fsub.search(queries, k=10, exact=True)[1]
    fgt = np.where(fgt_local >= 0,
                   allowed_ids[np.clip(fgt_local, 0, None)], -1)
    del fsub
    fstats = {}
    filt_qps, fids = measure_qps(
        idx, queries, 10, 8 * chosen, probes=2 * chosen, pipeline=1,
        stats_out=fstats, filter_mask=fmask)
    filt_recall = recall_at_k(fids, fgt, 10)
    filtered_extra = {
        "filtered_qps": round(float(filt_qps), 1),
        "filtered_recall": round(float(filt_recall), 4),
        "filtered_selectivity": 0.10,
        "filtered_vs_unfiltered": round(float(filt_qps / hnsw_qps), 3),
        "filtered_measurement": fstats,
    }

    # the classical graph-traversal engine (the pgvector-faithful beam
    # search; BASELINE.json names it the core) — measured every run so it
    # cannot regress silently
    graph_extra = {}
    if with_graph:
        def g_timed_build(inp):
            t0 = time.perf_counter()
            gi = HnswIndex(cfg).build(inp)
            jax.block_until_ready(gi.graph.neighbors0)
            np.asarray(gi.graph.levels[:1])  # drain: real fetch
            return time.perf_counter() - t0, gi

        # same protocol as the block engine above: one warmup build pays
        # XLA compilation (the bulk path spans ~15 programs), then the
        # median of three post-warmup DEVICE-RESIDENT builds is the
        # headline build figure (same ingest mode as the block engine's),
        # with one host-input build reported alongside
        g_warm_s, gidx = g_timed_build(base)
        del gidx
        g_host_s, gidx = g_timed_build(base)
        g_host_stages = getattr(gidx, "build_stats", {}).get("stages", {})
        xgdev = jax.block_until_ready(jnp.asarray(base))
        g_runs = []
        for _ in range(3):
            del gidx
            t, gidx = g_timed_build(xgdev)
            g_runs.append(t)
        del xgdev
        g_build_s = float(np.median(g_runs))
        g_build_stages = getattr(gidx, "build_stats", {}).get("stages", {})
        g_build_stages = {**g_build_stages,
                          "warmup_build_s": round(g_warm_s, 1),
                          "build_runs_s": [round(t, 2) for t in g_runs],
                          "build_input": "device-resident",
                          "host_input_build_s": round(g_host_s, 1),
                          "host_input_stages": g_host_stages}
        # operating points, cheapest first: (descent_ef/seeds, ef_search,
        # expand, max_steps) along the (seeds, steps) frontier. Under
        # route=auto the 1M graph routes by dense upper-level scan, where
        # seeds are the top-N nearest upper elements and the level-0 beam
        # needs only ~4-7 gather steps (each step is Q*expand*2m random
        # row gathers, THE cost); small graphs keep the upstream-faithful
        # greedy descent where descent_ef is the beam.
        # Bulk-built graphs have pure-kNN level-0 adjacency, so
        # single-seed ef=1 descent strands basins (recall ceiling 0.75
        # measured in r3) — every point carries a multi-seed router.
        # max_steps=0 = run to convergence (the lockstep tail).
        ladder = [(16, 16, 3, 4), (24, 16, 3, 4), (16, 16, 3, 5),
                  (16, 16, 4, 4), (24, 16, 2, 5), (8, 16, 4, 5),
                  (8, 24, 4, 6), (8, 24, 4, 7), (8, 40, 4, 9),
                  (8, 64, 4, 0), (8, 128, 1, 0), (8, 200, 1, 0)]
        g_dce, g_ef, g_exp, g_steps, g_recall = *ladder[-1], 0.0
        # no selection margin: the selection pass and the measured pass
        # run the SAME deterministic program on the SAME query set in
        # the same process, so the recall reported below is exactly the
        # recall gated here (only QPS carries run-to-run noise).
        for dce, ef, exp, ms in ladder:
            _, g_ids = gidx.search(queries, k=10, ef_search=ef,
                                   expand=exp, descent_ef=dce,
                                   max_steps=ms)
            g_recall = recall_at_k(g_ids, gt, 10)
            if g_recall >= target_recall:
                g_dce, g_ef, g_exp, g_steps = dce, ef, exp, ms
                break
        g_stats = {}
        g_qps, g_ids = measure_qps(gidx, queries, 10, g_ef, pipeline=1,
                                   stats_out=g_stats, expand=g_exp,
                                   descent_ef=g_dce, max_steps=g_steps)
        graph_extra = {
            "hnsw_graph_qps": round(float(g_qps), 1),
            "hnsw_graph_recall": round(
                float(recall_at_k(g_ids, gt, 10)), 4),
            "hnsw_graph_ef": g_ef,
            "hnsw_graph_descent_ef": g_dce,
            "hnsw_graph_expand": g_exp,
            "hnsw_graph_max_steps": g_steps,
            "hnsw_graph_build_s": round(g_build_s, 1),
            "hnsw_graph_build_stages": g_build_stages,
            "hnsw_graph_bytes_per_element": gidx.stats()[
                "bytes_per_element"],
            "hnsw_graph_measurement": g_stats,
        }
        del gidx

    # the seqscan path (pgvector's planner picks a sequential scan when it
    # beats the index; hnswcostestimate analogue) — reported, never headline
    flat_stats = {}
    flat_qps, flat_ids = measure_qps(oracle, queries, 10, 0, pipeline=1,
                                     stats_out=flat_stats)
    flat_recall = recall_at_k(flat_ids, gt, 10)

    result = {
        "metric": f"qps_per_chip_at_recall10>={target_recall}",
        "value": round(float(hnsw_qps), 1),
        "unit": "qps",
        "vs_baseline": round(float(hnsw_qps) / 50_000.0, 4),
        "extra": {
            "n": n,
            "dim": dim,
            "dtype": dtype,
            "index": "hnsw-block",
            "recall_at_10": round(float(hnsw_recall), 4),
            "probes": chosen,
            "n_blocks": idx.n_blocks,
            "block_size": block_size,
            "recall_target_met": bool(hnsw_recall >= target_recall),
            "measurement": mstats,
            "block_bytes_per_element": block_bytes_per_elem,
            **filtered_extra,
            **graph_extra,
            "flat_qps": round(float(flat_qps), 1),
            "flat_recall": round(float(flat_recall), 4),
            "flat_measurement": flat_stats,
            "build_vectors_per_sec": round(build_vps_dev, 1),
            "build_vs_baseline": round(build_vps_dev / 100_000.0, 4),
            "build_input": "device-resident (accelerator-produced "
            "embeddings; the host-input figure below pays the "
            "host->device upload); median of 5 post-warmup builds, "
            "spread in build_stages.build_runs_s",
            "build_stages": dev_stages,
            "build_vectors_per_sec_host_input": round(build_vps, 1),
            "build_stages_host_input": host_stages,
            "warmup_s": round(t_warm, 1),
            "dataset": dataset,
        },
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
