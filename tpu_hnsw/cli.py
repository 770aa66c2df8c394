"""Command-line interface.

The reference's "CLI" is psql + SQL DDL (SURVEY.md §1.2 L7:
``CREATE INDEX ... USING hnsw``, ``SET hnsw.ef_search``, ORDER-BY
queries); the equivalents here are subcommands:

    tpu-hnsw build  --input base.fvecs --out idx/ [--m 16] [--efc 64] ...
    tpu-hnsw search --index idx/ --queries q.fvecs --k 10 --ef 40
    tpu-hnsw eval   --index idx/ --queries q.fvecs [--gt gt.ivecs]
    tpu-hnsw bench  [--n 100000 --dim 128]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _load_vectors(path: str) -> np.ndarray:
    from tpu_hnsw.io import datasets as DS

    if path.endswith(".fvecs"):
        return DS.read_fvecs(path)
    if path.endswith(".bvecs"):
        return DS.read_bvecs(path)
    if path.endswith(".npy"):
        return np.load(path)
    raise SystemExit(f"unsupported vector file: {path} (use .fvecs/.bvecs/.npy)")


def cmd_build(args):
    from tpu_hnsw import BlockHnswIndex, HnswConfig, HnswIndex, Metric
    from tpu_hnsw.parallel.partition import PartitionedHnswIndex

    data = _load_vectors(args.input)
    cfg = HnswConfig(
        dim=data.shape[1],
        metric=Metric(args.metric),
        m=args.m,
        ef_construction=args.efc,
        wave_size=args.wave_size,
        dtype=args.dtype,
        seed=args.seed,
        build_expand_per_step=args.build_expand,
    )
    t0 = time.perf_counter()
    if args.partitions > 1:
        idx = PartitionedHnswIndex(
            cfg, n_partitions=args.partitions, router=args.router,
            engine=args.type, block_size=args.block_size,
        )
        # graph engine: shard-parallel build when the mesh has enough
        # devices; block engine builds its shards back-to-back on device
        idx.build(data, mesh="auto" if args.type == "graph" else None)
    elif args.type == "block":
        idx = BlockHnswIndex(cfg, block_size=args.block_size)
        idx.build(data)
    else:
        idx = HnswIndex(cfg, capacity=len(data))
        idx.build(data)
    dt = time.perf_counter() - t0
    idx.save(args.out)
    print(
        json.dumps(
            {
                "built": len(data),
                "seconds": round(dt, 2),
                "vectors_per_sec": round(len(data) / dt, 1),
                "out": args.out,
            }
        )
    )


def _load_index(path: str):
    import os

    from tpu_hnsw.index.block import BlockHnswIndex
    from tpu_hnsw.index.hnsw import HnswIndex
    from tpu_hnsw.parallel.partition import PartitionedHnswIndex

    if os.path.exists(os.path.join(path, "partitioned.json")):
        return PartitionedHnswIndex.load(path)
    if os.path.exists(os.path.join(path, "blocks.npz")):
        return BlockHnswIndex.load(path)
    return HnswIndex.load(path)


def cmd_search(args):
    idx = _load_index(args.index)
    q = _load_vectors(args.queries)
    if args.limit:
        q = q[: args.limit]
    t0 = time.perf_counter()
    dists, ids = idx.search(q, k=args.k, ef_search=args.ef)
    dt = time.perf_counter() - t0
    for row_d, row_i in zip(dists[: args.print_rows], ids[: args.print_rows]):
        print(" ".join(f"{i}:{d:.4f}" for d, i in zip(row_d, row_i)))
    print(
        json.dumps({"queries": len(q), "seconds": round(dt, 3),
                    "qps": round(len(q) / dt, 1)}),
        file=sys.stderr,
    )


def cmd_eval(args):
    from tpu_hnsw.config import Metric
    from tpu_hnsw.io import datasets as DS
    from tpu_hnsw.utils import evalharness as E
    from tpu_hnsw.utils.recall import recall_at_k

    idx = _load_index(args.index)
    q = _load_vectors(args.queries)
    if args.limit:
        q = q[: args.limit]
    if args.gt:
        gt = DS.read_ivecs(args.gt)[: len(q), : args.k]
    else:
        cfg = idx.cfg
        if hasattr(idx, "_export_live"):  # BlockHnswIndex
            live_ids, base = idx._export_live()
            gt = live_ids[E.ground_truth(base, q, args.k, cfg.metric)]
        elif hasattr(idx, "graph"):
            base = np.asarray(idx.graph.vectors[: idx.n]).astype(np.float32)
            gt = E.ground_truth(base, q, args.k, cfg.metric)
        else:
            # partitioned: ground truth over the concatenated shard tables
            # yields concat positions; search() returns ORIGINAL global
            # ids — map positions back through the shard id tables or the
            # reported recall is meaningless (ADVICE r1)
            bases, globs = [], []
            for part in idx.parts:
                if hasattr(part, "_export_live"):  # block-engine shard
                    lids, lvecs = part._export_live()
                    bases.append(lvecs)
                    globs.append(part._global_ids[lids])
                else:
                    bases.append(
                        np.asarray(part.graph.vectors[: part.n], np.float32)
                    )
                    globs.append(part._global_ids[: part.n])
            base = np.concatenate(bases).astype(np.float32)
            glob = np.concatenate(globs).astype(np.int64)
            gt = glob[E.ground_truth(base, q, args.k, cfg.metric)]
    rows = E.sweep(idx, q, gt, k=args.k)
    for r in rows:
        print(json.dumps(r))


def cmd_bench(args):
    import os

    if args.n:
        os.environ["TPU_HNSW_BENCH_N"] = str(args.n)
    if args.dim:
        os.environ["TPU_HNSW_BENCH_D"] = str(args.dim)
    if getattr(args, "dataset", None):
        os.environ["TPU_HNSW_BENCH_DATASET"] = args.dataset
    if getattr(args, "data_dir", None):
        os.environ["TPU_HNSW_DATA"] = args.data_dir
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "bench", os.path.join(os.path.dirname(__file__), "..", "bench.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main()


def main(argv=None):
    p = argparse.ArgumentParser(prog="tpu-hnsw", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("build", help="build an index (CREATE INDEX analogue)")
    b.add_argument("--input", required=True)
    b.add_argument("--out", required=True)
    b.add_argument("--metric", default="l2", choices=["l2", "ip", "cosine"])
    b.add_argument("--m", type=int, default=16)
    b.add_argument("--efc", type=int, default=64)
    b.add_argument("--wave-size", type=int, default=2048)
    b.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    b.add_argument("--seed", type=int, default=0)
    b.add_argument("--build-expand", type=int, default=4)
    b.add_argument("--partitions", type=int, default=1)
    b.add_argument("--router", default="hash", choices=["hash", "centroid"])
    b.add_argument(
        "--type", default="graph", choices=["graph", "block"],
        help="graph = classical HNSW; block = HNSW routing graph over "
        "cluster-blocked level 0 (the flagship serving engine)",
    )
    b.add_argument("--block-size", type=int, default=256)
    b.set_defaults(fn=cmd_build)

    s = sub.add_parser("search", help="query an index (ORDER BY ... LIMIT k)")
    s.add_argument("--index", required=True)
    s.add_argument("--queries", required=True)
    s.add_argument("--k", type=int, default=10)
    s.add_argument("--ef", type=int, default=40)
    s.add_argument("--limit", type=int, default=0)
    s.add_argument("--print-rows", type=int, default=5)
    s.set_defaults(fn=cmd_search)

    e = sub.add_parser("eval", help="recall/QPS sweep over ef_search")
    e.add_argument("--index", required=True)
    e.add_argument("--queries", required=True)
    e.add_argument("--gt", default=None)
    e.add_argument("--k", type=int, default=10)
    e.add_argument("--limit", type=int, default=0)
    e.set_defaults(fn=cmd_eval)

    n = sub.add_parser("bench", help="headline benchmark (one JSON line)")
    n.add_argument("--n", type=int, default=0)
    n.add_argument("--dim", type=int, default=0)
    n.add_argument(
        "--dataset", default=None,
        choices=["clustered", "uniform", "sift10k", "sift1m", "glove100",
                 "deep10m"],
        help="named BASELINE config (reads <name>_base.fvecs / "
        "<name>_query.fvecs / <name>_groundtruth.ivecs under --data-dir "
        "or $TPU_HNSW_DATA; synthesizes an equivalently-shaped stand-in "
        "when the files are absent)")
    n.add_argument("--data-dir", default=None,
                   help="directory holding the real fvecs/ivecs files")
    n.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
