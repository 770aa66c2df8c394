#!/usr/bin/env python
"""Smoke test of the index-and-query path on one NVIDIA GPU.

Drives the main path once through the public entry points at deployment
scale, on synthetic data made from fixed seeds, and checks every result
against the repo's plain references:

  A  BlockHnswIndex at SIFT1M shape (1M x 128 f32, L2): build, probe
     ladder to recall@10 >= 0.95, exact oracle vs a numpy float64 oracle,
     save/load round trip through the native blob IO
  B  the same index scored from its int8 and its bf16 copy
  C  HnswIndex (graph engine) bulk build + operating-point ladder
  D  FlatIndex default (approximate-candidate) scan vs the exact scan
  E  PartitionedHnswIndex at DEEP-10M shape (10M x 96, IP), 8 hash
     partitions: host-loop fan-out vs sharded() on a one-device mesh
  F  BinaryFlatIndex hamming over 1M packed 1024-bit rows vs numpy, and
     the Pallas kernel vs the XLA reduction on every pair, both timed
  G  planner.calibrate() on the card

Run from the repo root:

    python chip_smoke.py               # phases A-G, one card
    python chip_smoke.py --four-cards  # only the four-card sharded path

It exits non-zero before any work when JAX finds no GPU, and a failing
phase ends the run non-zero. The last line of standard output is one
JSON object ``{"ok": true, "device": {...}}``; nothing else is printed
after it.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# phase shapes: the published widths of each source, at the scale one
# card holds (ANN-Benchmarks sift-128-euclidean; big-ann DEEP-10M;
# config E's 512-d bf16 cosine shards)
SIZES = {
    "A_n": 1_000_000, "A_q": 4096,
    "E_n": 10_000_000, "E_q": 256,
    "F_n": 1_000_000, "F_bits": 1024, "F_q": 256, "F_sub": 10_000,
    "four_n_per_card": 2_500_000, "four_min_per_card": 2_000_000,
    "four_q": 256,
}
PROBE_LADDER = (4, 8, 16, 32, 64, 128)  # bench.py's block-engine ladder
# bench.py's graph-engine ladder: (descent_ef, ef_search, expand, max_steps)
GRAPH_LADDER = ((16, 16, 3, 4), (24, 16, 3, 4), (16, 16, 3, 5),
                (16, 16, 4, 4), (24, 16, 2, 5), (8, 16, 4, 5),
                (8, 24, 4, 6), (8, 24, 4, 7), (8, 40, 4, 9),
                (8, 64, 4, 0), (8, 128, 1, 0), (8, 200, 1, 0))
TARGET = 0.95


def check(cond: bool, msg: str) -> None:
    """Fail the run (an ``assert`` would vanish under ``python -O``)."""
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


@contextlib.contextmanager
def phase(name: str):
    print(f"[{name}] start", flush=True)
    t0 = time.perf_counter()
    yield
    gc.collect()
    print(f"[{name}] ok wall_s={time.perf_counter() - t0:.1f}", flush=True)


def say(name: str, **kv) -> None:
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def _walk_probes(idx, queries, gt, ladder=PROBE_LADDER):
    """First probe count of the ladder reaching TARGET recall@10."""
    from tpu_hnsw.utils.recall import recall_at_k

    seen = []
    for p in ladder:
        if p > idx.n_blocks:
            break
        _, ids = idx.search(queries, k=10, probes=p)
        r = recall_at_k(ids, gt, 10)
        seen.append((p, round(r, 4)))
        if r >= TARGET:
            return p, r, ids, seen
    raise RuntimeError(f"probe ladder never reached {TARGET}: {seen}")


def phase_block(n: int, nq: int, tmp: str) -> dict:
    """A. Block engine at SIFT1M shape; returns state phases B-D reuse."""
    import jax

    from tpu_hnsw import BlockHnswIndex, FlatIndex, HnswConfig, Metric
    from tpu_hnsw.io import native
    from tpu_hnsw.io.datasets import synthetic_clustered

    base, queries = synthetic_clustered(n, 128, n_queries=nq, seed=42)
    cfg = HnswConfig(dim=128, m=16, ef_construction=64, seed=0)
    t0 = time.perf_counter()
    idx = BlockHnswIndex(cfg, block_size=256).build(base)
    jax.block_until_ready(idx.blocks)
    build_s = time.perf_counter() - t0
    say("A", n=n, d=128, n_blocks=idx.n_blocks, build_s=f"{build_s:.2f}",
        build_vec_per_s=f"{n / build_s:.0f}")

    # Exact oracle: Precision.HIGHEST is true f32 arithmetic on this card
    # (no TF32 rounding of the operands).
    oracle = FlatIndex(base, Metric.L2)
    gt_d, gt = oracle.search(queries, k=10, exact=True)

    # oracle vs numpy float64 on 64 queries. The scan computes
    # |q|^2 + |x|^2 - 2 q.x, whose f32 rounding is relative to the norms
    # it cancels, not to the (small) distance, so the tolerance is 1e-5
    # of |q|^2 + |x|^2 per pair; ids must match except where the true
    # squared distances tie within that tolerance.
    m = min(64, nq)
    qm = queries[:m]
    full64 = (
        (qm.astype(np.float64) ** 2).sum(1)[:, None]
        + (base.astype(np.float64) ** 2).sum(1)[None, :]
        - 2.0 * qm.astype(np.float64) @ base.astype(np.float64).T)
    true_ids = np.argsort(full64, axis=1)[:, :10]
    true_s = np.take_along_axis(full64, true_ids, axis=1)
    got_ids = gt[:m]
    got_s64 = np.take_along_axis(full64, got_ids, axis=1)
    scale = ((qm.astype(np.float64) ** 2).sum(1)[:, None]
             + (base[got_ids].astype(np.float64) ** 2).sum(-1))
    tol = 1e-5 * scale
    d32_err = np.abs(gt_d[:m].astype(np.float64) ** 2 - got_s64)
    check((d32_err <= tol).all(),
          f"oracle distance off by {float((d32_err / scale).max()):.2e} "
          "of the norm scale")
    same = got_ids == true_ids
    tie_ok = np.abs(got_s64 - true_s) <= tol
    check((same | tie_ok).all(), "oracle ids differ beyond ties")
    rel = np.abs(gt_d[:m] - np.sqrt(np.maximum(got_s64, 0))) / np.maximum(
        np.sqrt(np.maximum(got_s64, 0)), 1e-30)
    say("A", oracle_vs_f64_queries=m,
        max_err_over_norm_scale=f"{float((d32_err / scale).max()):.2e}",
        max_rel_err_distance=f"{float(rel.max()):.2e}",
        ids_equal=f"{int(same.sum())}/{same.size}",
        ties=int((~same).sum()))
    del full64

    probes, recall, ids, seen = _walk_probes(idx, queries, gt)
    say("A", probe_ladder=seen, probes=probes, recall_at_10=f"{recall:.4f}")

    lib = native.load()
    check(lib is not None, f"native IO did not build: {native.LOAD_ERROR}")
    say("A", native_io=native._lib_path())
    path = os.path.join(tmp, "block")
    idx.save(path)
    idx2 = BlockHnswIndex.load(path)
    _, ids2 = idx2.search(queries, k=10, probes=probes)
    check(np.array_equal(ids, ids2), "save/load changed the results")
    say("A", save_load="identical ids")
    del idx2, oracle
    return {"base": base, "queries": queries, "gt": gt, "idx": idx,
            "probes": probes, "recall": recall, "saved": path, "cfg": cfg}


def phase_score_dtype(st: dict) -> None:
    """B. The same index scored from its int8 (default) and bf16 copies."""
    from tpu_hnsw import BlockHnswIndex
    from tpu_hnsw.utils.evalharness import measure_qps
    from tpu_hnsw.utils.recall import recall_at_k

    queries, gt, probes = st["queries"], st["gt"], st["probes"]
    out = {}
    for dtype in ("int8", "bf16"):
        prev = os.environ.get("TPU_HNSW_SCORE_DTYPE")
        os.environ["TPU_HNSW_SCORE_DTYPE"] = dtype
        try:
            idx = BlockHnswIndex.load(st["saved"])
        finally:
            if prev is None:
                os.environ.pop("TPU_HNSW_SCORE_DTYPE")
            else:
                os.environ["TPU_HNSW_SCORE_DTYPE"] = prev
        check(str(idx.blocks_score.dtype) == ("int8" if dtype == "int8"
                                              else "bfloat16"),
              f"scoring copy is {idx.blocks_score.dtype}, wanted {dtype}")
        ms = {}
        qps, ids = measure_qps(idx, queries, 10, 0, probes=probes,
                               pipeline=1, stats_out=ms)
        r = recall_at_k(ids, gt, 10)
        out[dtype] = r
        say("B", score_dtype=dtype, probes=probes, recall_at_10=f"{r:.4f}",
            qps=f"{qps:.1f}", ms_per_batch=f"{1e3 * len(queries) / qps:.3f}",
            batch=len(queries), qps_cv=ms.get("qps_cv"))
        del idx
    gap = abs(out["int8"] - out["bf16"])
    check(gap <= 0.005, f"int8 vs bf16 recall gap {gap:.4f} > 0.005")
    say("B", recall_gap=f"{gap:.4f}")


def phase_graph(st: dict) -> None:
    """C. Graph engine bulk build + bench.py's operating-point ladder."""
    import jax

    from tpu_hnsw import HnswIndex
    from tpu_hnsw.utils.recall import recall_at_k

    base, queries, gt = st["base"], st["queries"], st["gt"]
    t0 = time.perf_counter()
    gidx = HnswIndex(st["cfg"]).build(base)
    jax.block_until_ready(gidx.graph.neighbors0)
    say("C", n=len(base), build_s=f"{time.perf_counter() - t0:.2f}")
    seen = []
    for dce, ef, exp, ms in GRAPH_LADDER:
        _, ids = gidx.search(queries, k=10, ef_search=ef, expand=exp,
                             descent_ef=dce, max_steps=ms)
        r = recall_at_k(ids, gt, 10)
        seen.append(((dce, ef, exp, ms), round(r, 4)))
        if r >= TARGET:
            say("C", ladder=seen, point=(dce, ef, exp, ms),
                recall_at_10=f"{r:.4f}")
            return
    raise RuntimeError(f"graph ladder never reached {TARGET}: {seen}")


def phase_flat(st: dict) -> None:
    """D. FlatIndex default path against the exact path."""
    from tpu_hnsw import FlatIndex, Metric
    from tpu_hnsw.utils.recall import recall_at_k

    flat = FlatIndex(st["base"], Metric.L2)
    _, ids = flat.search(st["queries"], k=10)
    r = recall_at_k(ids, st["gt"], 10)
    check(r >= 0.99, f"flat default-path recall {r:.4f} < 0.99")
    say("D", recall_at_10=f"{r:.4f}",
        note="lax.approx_min_k runs JAX's exact fallback on this backend "
             "(jax/_src/lax/ann.py)")


def phase_partitioned(n: int, nq: int) -> None:
    """E. Config D (DEEP-10M shape) on one card: 8 hash partitions."""
    import jax

    from tpu_hnsw import FlatIndex, HnswConfig, Metric, PartitionedHnswIndex
    from tpu_hnsw.io.datasets import synthetic_clustered
    from tpu_hnsw.utils.recall import recall_at_k

    base, queries = synthetic_clustered(n, 96, n_queries=nq, seed=13)
    # DEEP's vectors are near-unit-norm; IP over raw Gaussian mixtures
    # ranks global high-norm outliers first
    base /= np.maximum(np.linalg.norm(base, axis=1, keepdims=True), 1e-12)
    queries /= np.maximum(np.linalg.norm(queries, axis=1, keepdims=True),
                          1e-12)
    oracle = FlatIndex(base, Metric.IP)
    gt = oracle.search(queries, k=10, exact=True)[1]
    del oracle
    gc.collect()

    cfg = HnswConfig(dim=96, metric=Metric.IP, m=16, ef_construction=64,
                     seed=0)
    t0 = time.perf_counter()
    pidx = PartitionedHnswIndex(cfg, n_partitions=8, router="hash",
                                engine="block", block_size=256).build(base)
    build_s = time.perf_counter() - t0
    del base
    say("E", n=n, d=96, partitions=8, build_s=f"{build_s:.2f}",
        cut="none" if n == SIZES["E_n"] else f"n={n} of 10000000")
    seen = []
    for p in PROBE_LADDER:
        hd, hi = (np.asarray(a) for a in
                  pidx.search_device(queries, k=10, probes=p))
        r = recall_at_k(hi, gt, 10)
        seen.append((p, round(r, 4)))
        if r >= TARGET:
            break
    check(r >= TARGET, f"partitioned recall never reached {TARGET}: {seen}")
    sh = pidx.sharded(jax.make_mesh((1,), ("shard",)))
    sd, si = sh.search(queries, k=10, probes=p)
    agree = _agree(hd, hi, sd, si)
    say("E", probe_ladder=seen, probes=p, recall_at_10=f"{r:.4f}",
        sharded_recall_at_10=f"{recall_at_k(si, gt, 10):.4f}",
        rows_identical=f"{agree}/{len(hi)}")


def _agree(hd, hi, sd, si) -> int:
    """Host-loop vs sharded results agree: per row the id sets are equal,
    or the distances are equal and only tied ids differ. Returns the
    number of rows whose id sets are identical."""
    same = np.array([set(a.tolist()) == set(b.tolist())
                     for a, b in zip(hi, si)])
    close = np.isclose(np.sort(hd, 1), np.sort(sd, 1), rtol=1e-5,
                       atol=1e-6).all(1)
    check((same | close).all(),
          f"sharded != host-loop on {int((~(same | close)).sum())} rows")
    return int(same.sum())


_POP16 = np.array([bin(v).count("1") for v in range(1 << 16)], np.int64)


def _np_popcount(x: np.ndarray) -> np.ndarray:
    """Bits set in each uint32 word (16-bit lookup table)."""
    return _POP16[x & 0xFFFF] + _POP16[x >> 16]


def phase_binary(n: int, bits: int, nq: int, sub: int) -> None:
    """F. Hamming scan over packed binary-quantized embeddings."""
    import jax.numpy as jnp

    from tpu_hnsw import BinaryFlatIndex
    from tpu_hnsw.io.datasets import synthetic_clustered
    from tpu_hnsw.ops.bitops import _flat_topk, pack_bits, pairwise_hamming
    from tpu_hnsw.ops.pallas_hamming import hamming_scan

    base, queries = synthetic_clustered(n, bits, n_queries=nq, seed=7)
    xp = pack_bits(base > 0)
    qp = pack_bits(queries > 0)
    del base, queries
    t0 = time.perf_counter()
    d, i = BinaryFlatIndex(xp).search(qp, k=10)
    say("F", n=n, bits=bits, queries=nq,
        search_s=f"{time.perf_counter() - t0:.3f}")
    # every returned distance is the exact popcount of its (query, row)
    want = _np_popcount(qp[:, None, :] ^ xp[i]).sum(-1)
    check(np.array_equal(d, want.astype(d.dtype)),
          "returned hamming distances are not exact")
    check((np.diff(d, axis=1) >= 0).all(), "results not ascending")
    # the k smallest over a subset equal the numpy oracle's, exactly
    ds, _ = BinaryFlatIndex(xp[:sub]).search(qp, k=10)
    full = _np_popcount(qp[:, None, :] ^ xp[None, :sub, :]).sum(-1)
    check(np.array_equal(ds, np.sort(full, 1)[:, :10].astype(ds.dtype)),
          "subset top-10 distances differ from the numpy oracle")
    # the kernel as compiled for the card against the XLA reduction, on
    # every (query, row) pair of the full table
    qd, xd = jnp.asarray(qp), jnp.asarray(xp)
    check(bool(jnp.array_equal(hamming_scan(qd, xd),
                               pairwise_hamming(qd, xd))),
          "Pallas hamming kernel differs from the XLA reference")
    say("F", exact_pairs=want.size, subset_rows=sub,
        subset_oracle="equal (integers, exact)",
        kernel_vs_xla=f"equal on {nq}x{n} pairs")

    # the kernel decision, repeated by every run: the scan alone, and the
    # search program BinaryFlatIndex.search runs (scan, top-k, fetch)
    def scan(kernel):
        f = hamming_scan if kernel else pairwise_hamming
        return lambda: f(qd, xd).block_until_ready()

    def search(kernel):
        return lambda: [np.asarray(a) for a in _flat_topk(
            jnp.asarray(qp), xd, k=10, metric="hamming", kernel=kernel)]

    order = (False, True, True, False)
    say("F", order="xla,kernel,kernel,xla",
        scan_ms=[_median_ms(scan(kern)) for kern in order],
        search_ms=[_median_ms(search(kern)) for kern in order])


def _median_ms(fn, reps: int = 10) -> float:
    """Median wall milliseconds of ``fn()`` after one warm-up call."""
    fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return round(1e3 * float(np.median(ts)), 3)


def phase_planner() -> None:
    """G. Planner constants measured on the card."""
    import dataclasses

    from tpu_hnsw.planner import calibrate

    hw = calibrate()
    say("G", **{k: f"{v:.6g}" for k, v in dataclasses.asdict(hw).items()})


def _bytes_in_use(dev) -> int:
    stats = dev.memory_stats()
    check(bool(stats), f"{dev} reports no memory stats")
    return int(stats["bytes_in_use"])


def phase_four_cards(n_per: int, min_per: int, nq: int) -> None:
    """Config E widths on four cards: 512-d bf16 cosine, centroid router,
    block engine, one partition per card; sharded() vs the host loop at
    full probes, and each card's memory against its share."""
    import jax

    from tpu_hnsw import HnswConfig, Metric, PartitionedHnswIndex
    from tpu_hnsw.io.datasets import synthetic_clustered

    ndev = len(jax.devices())
    check(ndev == 4, f"--four-cards needs 4 devices, JAX has {ndev}")
    n = 4 * n_per
    base, queries = synthetic_clustered(n, 512, n_queries=nq, seed=29)
    cfg = HnswConfig(dim=512, metric=Metric.COSINE, m=16, ef_construction=64,
                     dtype="bfloat16", seed=0)
    t0 = time.perf_counter()
    pidx = PartitionedHnswIndex(cfg, n_partitions=4, router="centroid",
                                engine="block", block_size=256).build(base)
    del base
    rows = [p.n for p in pidx.parts]
    say("4", n=n, d=512, dtype="bfloat16", rows_per_card=rows,
        build_s=f"{time.perf_counter() - t0:.2f}",
        cut="config E holds 25000000 rows per card")
    check(min(rows) >= min_per, f"a card holds fewer than {min_per} rows")
    full = max(s.n_blocks for s in pidx.parts)
    hd, hi = pidx.search_device(queries, k=10, probes=full)
    hd, hi = np.asarray(hd), np.asarray(hi)
    sh = pidx.sharded(jax.make_mesh((4,), ("shard",)))
    sh.release_parts_device_state()
    gc.collect()
    sd, si = sh.search(queries, k=10, probes=full, route_k=4)
    agree = _agree(hd, hi, sd, si)
    check(agree == len(hi), f"id sets differ on {len(hi) - agree} rows")
    share = sh.stats()["memory_total_bytes"] / 4
    used = [_bytes_in_use(d) for d in jax.devices()]
    say("4", probes=full, rows_identical=f"{agree}/{len(hi)}",
        share_bytes=int(share), bytes_in_use=used,
        max_over_share=f"{max(used) / share:.3f}")
    check(max(used) <= 1.5 * share, "a card holds more than 1.5x its share")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card sharded phase")
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {dev.platform}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import tpu_hnsw  # noqa: F401  (sets the compile cache)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    print(f"jax {jax.__version__}; devices {len(jax.devices())} x "
          f"{dev.device_kind}", flush=True)
    print(f"compile cache: {jax.config.jax_compilation_cache_dir}",
          flush=True)

    if args.four_cards:
        with phase("4 sharded"):
            phase_four_cards(SIZES["four_n_per_card"],
                             SIZES["four_min_per_card"], SIZES["four_q"])
    else:
        tmp = tempfile.mkdtemp(prefix=".chip_smoke_", dir=REPO)
        try:
            with phase("A block"):
                st = phase_block(SIZES["A_n"], SIZES["A_q"], tmp)
            with phase("B score dtype"):
                phase_score_dtype(st)
            with phase("C graph"):
                phase_graph(st)
            with phase("D flat"):
                phase_flat(st)
            del st
            gc.collect()
            with phase("E partitioned"):
                phase_partitioned(SIZES["E_n"], SIZES["E_q"])
            with phase("F binary"):
                phase_binary(SIZES["F_n"], SIZES["F_bits"], SIZES["F_q"],
                             SIZES["F_sub"])
            with phase("G planner"):
                phase_planner()
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
