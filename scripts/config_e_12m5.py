#!/usr/bin/env python
"""Config E shard at 12.5M x 512d bf16 SERVED end-to-end on one device
through the bounded-memory production load path.

The script builds the shard in two halves next to their corpora and
avoids the in-memory sharded() assembly, which would double the serving
bytes. So it does what a production loader does:

1. builds TWO 6.25M half-shards sequentially from device-generated
   slabs (each build's peak fits), computing the EXHAUSTIVE exact
   ground truth for the benchmark queries against each half while it is
   resident (merged later: true 12.5M oracle, no extra memory);
2. saves each half to disk and frees it;
3. streams both halves straight into stacked serving form with
   ``ShardedBlockSearcher.from_saved`` (bounded-memory load: serving
   bytes + one slab; bf16 scoring aliases the blocks) on a 1-device
   mesh — 12.5M rows served through the config-E serving class on one
   chip;
4. measures recall@10 (vs the true oracle) / QPS over a probe sweep and
   records live device memory.

Writes benchmarks/config_e_12m5.json.
"""

import json
import os
import shutil
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("TPU_HNSW_SCORE_DTYPE", "bf16")  # alias: no 2nd copy

import numpy as np


def main():
    n_total = int(os.environ.get("TPU_HNSW_E12_N", 12_500_000))
    n_parts = 4
    n_shard = n_total // n_parts
    dim = 512
    n_queries = 512
    work = os.environ.get("TPU_HNSW_E12_DIR", "/tmp/e12m5_idx")
    S_BLK = int(os.environ.get("TPU_HNSW_E12_S", 128))
    E_SLACK = float(os.environ.get("TPU_HNSW_E12_SLACK", "1.10"))

    import jax
    import jax.numpy as jnp
    from tpu_hnsw import BlockHnswIndex, HnswConfig, Metric
    from tpu_hnsw.parallel.partition import ShardedBlockSearcher
    from tpu_hnsw.utils.evalharness import measure_qps
    from tpu_hnsw.utils.recall import recall_at_k

    cfg = HnswConfig(dim=dim, metric=Metric.COSINE, m=16, ef_construction=64,
                     dtype="bfloat16", seed=0)

    # clustered synthetic generated ON DEVICE in slabs (LAION-like
    # unit-norm rows; a 25.6GB host corpus would put the upload inside
    # the build)
    n_clusters = 8192
    k0 = jax.random.PRNGKey(0)
    centers = jax.random.normal(k0, (n_clusters, dim), jnp.float32)

    SLAB = 312_500  # n_shard divides exactly: no concat-then-slice copy

    @jax.jit
    def gen_slab(centers, key, base_idx):
        ks = jax.random.split(key, 3)
        a = jax.random.randint(ks[0], (SLAB,), 0, n_clusters)
        x = centers[a] * 4.0 + jax.random.normal(ks[1], (SLAB, dim))
        x = x / jnp.maximum(jnp.linalg.norm(x, axis=1, keepdims=True), 1e-12)
        return x.astype(jnp.bfloat16)

    def gen_corpus(n, seed0):
        assert n % SLAB == 0
        slabs = [gen_slab(centers, jax.random.PRNGKey(seed0 + i), i * SLAB)
                 for i in range(n // SLAB)]
        # donating concat: slabs are freed as they fold into the output,
        # so peak = 2x corpus, not 3x (the [:n] slice copy OOMed at 6.25M)
        cat = jax.jit(lambda *xs: jnp.concatenate(xs, axis=0),
                      donate_argnums=tuple(range(len(slabs))))
        return jax.block_until_ready(cat(*slabs))

    # queries: perturbed corpus points from shard 0's generator
    qk = jax.random.PRNGKey(999)
    qx = gen_slab(centers, jax.random.PRNGKey(1000), 0)[:n_queries]
    qx = qx.astype(jnp.float32) + 0.05 * jax.random.normal(
        qk, (n_queries, dim))
    qx = qx / jnp.maximum(jnp.linalg.norm(qx, axis=1, keepdims=True), 1e-12)
    queries = jax.block_until_ready(qx.astype(jnp.float32))
    qhost = np.asarray(queries)

    reuse = (os.environ.get("TPU_HNSW_E12_REUSE") == "1"
             and os.path.exists(os.path.join(work, "gt.npy"))
             and os.path.exists(os.path.join(work, "partitioned.json")))
    if not reuse and os.path.exists(work):
        shutil.rmtree(work)
    os.makedirs(work, exist_ok=True)

    gt_parts_d, gt_parts_i = [], []
    build_stats = []
    for p in range(0 if reuse else n_parts):
        t0 = time.perf_counter()
        corpus = gen_corpus(n_shard, seed0=1 + p * 1000)
        t_gen = time.perf_counter() - t0
        # r5 recall-ceiling fix (measured on a 3.125M shard, streamed
        # exact oracle): the S=256 packing spilled ~21% of rows of this
        # sharply clustered corpus into far blocks whose centroids rank
        # in the hundreds for the right queries — a probe-independent
        # recall plateau at ~0.92. S=128 matches block granularity to
        # cluster mass (retried 648k -> 433k with slack 1.10) and the
        # plateau moves to 0.952@16 probes / 0.965@64 (rerank 128).
        idx = BlockHnswIndex(cfg, block_size=S_BLK, block_slack=E_SLACK)
        t0 = time.perf_counter()
        idx.build(corpus)
        t_build = time.perf_counter() - t0
        del corpus
        # exhaustive exact oracle for this shard while it is resident:
        # a direct streamed f32-accumulation scan over the stored
        # blocks (the serve program at probes=n_blocks OOMs at S=128
        # block counts; this scan is also what the 3.125M shard
        # experiments validated the recall numbers against)
        t0 = time.perf_counter()
        CH = 1024
        padb = (-idx.blocks.shape[0]) % CH
        blocks_p = jnp.pad(idx.blocks, ((0, padb), (0, 0), (0, 0)))
        ids_p = jnp.pad(idx.block_ids, ((0, padb), (0, 0)),
                        constant_values=-1)
        qn = jnp.asarray(qhost)
        qn = qn / jnp.maximum(jnp.linalg.norm(qn, axis=1, keepdims=True),
                              1e-12)

        @jax.jit
        def _oracle_slab(qj, slab, sids, best_d, best_i):
            sc = -(qj @ slab.astype(jnp.float32).T)
            sc = jnp.where((sids >= 0)[None], sc, jnp.inf)
            d2 = jnp.concatenate([best_d, sc], 1)
            i2 = jnp.concatenate(
                [best_i, jnp.broadcast_to(sids[None], sc.shape)], 1)
            vals, sel = jax.lax.top_k(-d2, 10)
            return -vals, jnp.take_along_axis(i2, sel, 1)

        bd = jnp.full((len(qhost), 10), jnp.inf)
        bi = jnp.full((len(qhost), 10), -1, jnp.int32)
        for b0 in range(0, blocks_p.shape[0], CH):
            slab = jax.lax.dynamic_slice_in_dim(
                blocks_p, b0, CH, 0).reshape(-1, dim)
            sids = jax.lax.dynamic_slice_in_dim(
                ids_p, b0, CH, 0).reshape(-1)
            bd, bi = _oracle_slab(qn, slab, sids, bd, bi)
        d, i = np.asarray(bd), np.asarray(bi)
        del blocks_p, ids_p
        gt_parts_d.append(d)
        gt_parts_i.append(np.where(i >= 0, i + p * n_shard, -1))
        t_oracle = time.perf_counter() - t0
        t0 = time.perf_counter()
        idx.save(os.path.join(work, f"part{p}"))
        np.save(os.path.join(work, f"part{p}", "global_ids.npy"),
                (np.arange(idx.n_total, dtype=np.int32) + p * n_shard))
        t_save = time.perf_counter() - t0
        build_stats.append({
            "gen_s": round(t_gen, 1), "build_s": round(t_build, 1),
            "oracle_scan_s": round(t_oracle, 1), "save_s": round(t_save, 1),
            "n_blocks": idx.n_blocks,
            "build_stages": idx.build_stats,
        })
        print(f"shard {p}: {build_stats[-1]}", flush=True)
        del idx

    if reuse:
        gt = np.load(os.path.join(work, "gt.npy"))
        if os.path.exists(os.path.join(work, "build_stats.json")):
            with open(os.path.join(work, "build_stats.json")) as f:
                build_stats = json.load(f)
    else:
        # merge the shards' exhaustive results -> true 12.5M oracle
        gd = np.concatenate(gt_parts_d, axis=1)
        gi = np.concatenate(gt_parts_i, axis=1)
        order = np.argsort(gd, axis=1)[:, :10]
        gt = np.take_along_axis(gi, order, axis=1)
        np.save(os.path.join(work, "gt.npy"), gt)
        np.save(os.path.join(work, "queries.npy"), qhost)
        with open(os.path.join(work, "build_stats.json"), "w") as f:
            json.dump(build_stats, f)

        # partitioned-index metadata for from_saved
        with open(os.path.join(work, "partitioned.json"), "w") as f:
            json.dump({"p": n_parts, "router": "hash", "route_k": 0,
                       "n": n_total, "engine": "block",
                       "block_size": S_BLK},
                      f)
        np.savez(os.path.join(work, "router.npz"), centroids=np.zeros(0),
                 part_of=np.zeros(0, np.int32),
                 local_of=np.zeros(0, np.int32))
    if reuse:
        qhost = np.load(os.path.join(work, "queries.npy"))

    t0 = time.perf_counter()
    sh = ShardedBlockSearcher.from_saved(
        work, jax.make_mesh((1,), ("shard",)))
    load_s = time.perf_counter() - t0
    # stage-1 survivor pool per shard: 40 was the plateau's second cause
    # (near-tie bf16 scores at 512d; 128 measured +0.6-0.9 recall pts)
    sh.rerank_width = 128
    assert sh.blocks_score is sh.blocks, "bf16 scoring must alias"

    mem = {}
    try:
        ms = jax.devices()[0].memory_stats() or {}
        mem = {kk: ms[kk] for kk in ("bytes_in_use", "bytes_limit")
               if kk in ms}
    except Exception:
        pass

    rows = []
    for ef in (16, 32, 64):
        probes = sh.probes_for_ef(ef)
        per_q = probes * n_parts * S_BLK * 512 * 2  # bf16 gather bytes/q
        # chunk budget: serving state is ~14.4GB of 16 at slack 1.10, so
        # the gather intermediate budget is what HBM headroom allows;
        # OOM falls back by halving (r5)
        chunk = 64
        while chunk * 2 <= min(512, 1_500_000_000 // per_q):
            chunk *= 2
        row = None
        while chunk >= 32:
            try:
                st = {}
                qps, ids = measure_qps(sh, qhost, 10, ef, probes=probes,
                                       pipeline=max(1, len(qhost) // chunk),
                                       stats_out=st)
                if (st.get("qps_cv") or 0) > 0.10:
                    # re-measure with longer windows until the <=10%
                    # reproducibility bar holds (r5: first pass read
                    # CV 0.15-0.19 at the small chunk sizes)
                    st = {}
                    qps, ids = measure_qps(
                        sh, qhost, 10, ef, probes=probes,
                        pipeline=max(1, len(qhost) // chunk),
                        stats_out=st, repeats=16, min_window_s=1.0)
                row = {
                    "ef_search": ef, "probes_per_shard": probes,
                    "chunk": chunk,
                    "recall_at_10": round(
                        float(recall_at_k(ids, gt, 10)), 4),
                    "qps": round(float(qps), 1),
                    "qps_cv": st.get("qps_cv"),
                }
                break
            except Exception as e:
                print(f"chunk {chunk} failed ({str(e)[:120]}); halving",
                      flush=True)
                chunk //= 2
        rows.append(row or {"ef_search": ef, "probes_per_shard": probes,
                            "error": "all chunk sizes failed"})
        print(rows[-1], flush=True)

    io_note = {
        "what": "save/load times include the device<->host copies; the "
                "native mmap blob writer replaces np.savez for the "
                "multi-GB blocks array",
    }
    out = {
        "config": "E chip shard at FULL scale: 12.5M x 512d bf16 served "
                  "on one chip via ShardedBlockSearcher.from_saved",
        "dataset": "synthetic-clustered (device-generated, unit-norm)",
        "n": n_total, "dim": dim, "metric": "cosine", "dtype": "bfloat16",
        "parts_on_chip": n_parts,
        "serving_load_s": round(load_s, 1),
        "io_note": io_note,
        "serving_memory": sh.stats(),
        "device_memory": mem,
        "build_per_shard": build_stats,
        "sweep": rows,
    }
    os.makedirs("benchmarks", exist_ok=True)
    with open("benchmarks/config_e_12m5.json", "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({kk: v for kk, v in out.items()
                      if kk not in ("sweep", "build_per_shard")}))


if __name__ == "__main__":
    main()
