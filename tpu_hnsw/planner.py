"""Cost-based engine selection — the ``hnswcostestimate`` analogue.

pgvector registers ``hnswcostestimate`` with the Postgres planner
(reference: ``pgvector:src/hnsw.c``, SURVEY.md §2.2 "HNSW AM handler …
cost estimate") so the database can choose between the HNSW index scan
and a plain sequential scan per query. This module is that decision for
the engines here, priced on a :class:`HardwareModel` of five rates:

- random row gather — classical graph traversal is priced by rows
  touched;
- dense f32 scan MACs — the flat scan and the centroid routing;
- block expansion bytes — XLA materializes the [batch, probes, S, d]
  gather of probed blocks, so the stage is priced as writing and
  re-reading that intermediate;
- per-program dispatch and per-beam-step overhead.

Like upstream's estimator, these are *relative* costs for picking a
plan, not wall-clock promises. The defaults are :func:`calibrate` run on
the card; a caller can pass its own model or re-measure on the live
device.

The one decision upstream's planner cannot make — "will the ANN engine
reach the requested recall on THIS data?" — is handled by
:func:`cluster_structure_score`: the planner refuses ANN engines on
structure-free data, where both degrade far below any useful recall
target and the flat exact scan is the honest plan (README "Hard-mode
data control", ``scripts/uniform_control.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "HardwareModel", "EnginePlan", "estimate_flat_qps",
    "estimate_flat_int8_qps", "estimate_block_qps", "estimate_graph_qps",
    "cluster_structure_score", "choose_engine", "calibrate",
]


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    """Per-device cost constants.

    The defaults are the mean of two :func:`calibrate` runs at its
    default shapes, in two processes on an NVIDIA H100 80GB HBM3 with
    its power limit set to 400 W. The rates and the step overhead agreed
    within 3% between the runs; ``dispatch_s`` is host latency and moved
    18%. Pass another model, or calibrate on the live device, for a
    different card.
    """

    gather_rows_per_s: float = 6.40072e9   # random row gather
    f32_macs_per_s: float = 3.93114e12     # dense scan incl. its top-k
    expand_bytes_per_s: float = 1.73925e12  # block-expansion intermediate
    dispatch_s: float = 8.65292e-5          # per-program dispatch
    step_overhead_s: float = 1.25024e-4     # per beam step: pool top-k, masks


@dataclasses.dataclass(frozen=True)
class EnginePlan:
    """One engine priced at an operating point (the planner's "path")."""

    engine: str            # "flat" | "block" | "graph"
    est_qps: float
    exact: bool            # recall 1.0 by construction
    params: dict           # per-call knobs for the chosen engine
    reason: str


def estimate_flat_qps(n: int, dim: int, *, batch: int = 4096,
                      hw: HardwareModel = HardwareModel()) -> float:
    """Sequential-scan cost: a [batch, n] distance matmul per batch —
    2·n·d MACs per query at the end-to-end f32 rate."""
    t = batch * 2.0 * n * dim / hw.f32_macs_per_s + hw.dispatch_s
    return batch / t


#: speedup of ``FlatIndex(scan_dtype="int8")`` over the default scan.
#: Priced at parity until it is measured on the H100 (ROADMAP 3.7): the
#: streamed scan is bound by score-tile materialization and per-block
#: top-k traffic as much as by matmul input bytes, so the planner never
#: prefers it.
INT8_SCAN_SPEEDUP = 1.0


def estimate_flat_int8_qps(n: int, dim: int, *, batch: int = 4096,
                           hw: HardwareModel = HardwareModel()) -> float:
    """``FlatIndex(scan_dtype="int8")`` cost (see INT8_SCAN_SPEEDUP)."""
    t = (batch * 2.0 * n * dim / (hw.f32_macs_per_s * INT8_SCAN_SPEEDUP)
         + hw.dispatch_s)
    return batch / t


def estimate_block_qps(n: int, dim: int, *, probes: int = 8,
                       block_size: int = 256, batch: int = 4096,
                       rerank: int = 32, stage1_itemsize: int = 1,
                       hw: HardwareModel = HardwareModel()) -> float:
    """Blocked-engine cost, matching the engine's real structure
    (index/block.py): (1) dense centroid routing — a [batch, n_blocks]
    f32 matmul; (2) expansion of ``probes`` blocks per query from the
    int8 scoring copy — XLA materializes the [batch, probes, S, d]
    gather, so this stage is bandwidth-bound on writing + re-reading
    that intermediate; (3) exact f32 rerank of the ``rerank`` stage-1
    survivors (MAC-priced, negligible)."""
    n_blocks = max(1, -(-n // block_size))
    probes = max(1, min(probes, n_blocks))
    route = batch * 2.0 * n_blocks * dim / hw.f32_macs_per_s
    expand = batch * probes * block_size * dim * stage1_itemsize * 2 \
        / hw.expand_bytes_per_s
    rr = batch * 2.0 * rerank * dim * 2 / hw.f32_macs_per_s
    t = route + expand + rr + hw.dispatch_s
    return batch / t


def estimate_graph_qps(n: int, dim: int, *, m: int = 16, ef: int = 24,
                       expand: int = 4, steps: int = 7, seeds: int = 8,
                       batch: int = 4096,
                       hw: HardwareModel = HardwareModel()) -> float:
    """Classical beam-search cost: each step gathers ``expand`` frontier
    nodes' level-0 neighborhoods (2m vectors each) as random rows — the
    row-bound path — plus per-step pool maintenance and the dense
    scan-routing pass over the ~n/m upper-level elements."""
    del ef  # pool width rides the per-step overhead, not the gather count
    rows_gathered = batch * (expand * 2 * m * steps + seeds)
    n_upper = max(1, n // m)
    route = batch * 2.0 * n_upper * dim / hw.f32_macs_per_s
    t = (rows_gathered / hw.gather_rows_per_s
         + steps * hw.step_overhead_s
         + route
         + hw.dispatch_s * 2)  # routing + beam programs
    return batch / t


#: cluster_structure_score subsamples anything larger than this before
#: k-means — the score saturates well below 8k rows, and the cap bounds
#: host memory at ~(CAP·k + CAP·d) floats per iteration regardless of
#: what the caller passes (ADVICE r3: the old [S, k, d] broadcast temp
#: cost 134MB / ~1.6s at a 4096x64 sample and GBs for larger ones).
STRUCTURE_SAMPLE_CAP = 8192


def cluster_structure_score(sample: np.ndarray, *, k: int = 64,
                            iters: int = 8, seed: int = 0) -> float:
    """How much cluster structure the data has, in [0, ~1].

    Fits ``k`` centroids to a host-side sample (a few k-means rounds)
    and returns 1 − mean_dist_to_nearest_centroid / mean_dist_to_mean.
    Clustered data concentrates around centroids (score → 1); uniform /
    structure-free data gains almost nothing from k centroids over one
    (score → 0). Pure numpy so the planner can run before any device
    work. Distances use the ‖x‖²+‖c‖²−2x·cᵀ identity — a [S, k] matmul,
    never an [S, k, d] broadcast temp — and samples larger than
    ``STRUCTURE_SAMPLE_CAP`` rows are subsampled, so cost is bounded no
    matter how large a sample the caller hands over.
    """
    x = np.asarray(sample, dtype=np.float32)
    if x.ndim != 2 or len(x) < 4 * k:
        raise ValueError("need a 2-D sample with at least 4*k rows")
    rng = np.random.default_rng(seed)
    if len(x) > STRUCTURE_SAMPLE_CAP:
        x = x[rng.choice(len(x), size=STRUCTURE_SAMPLE_CAP, replace=False)]
    c = x[rng.choice(len(x), size=k, replace=False)].copy()
    x_sq = (x * x).sum(-1)  # [S], loop-invariant
    a = np.zeros(len(x), np.int64)
    for _ in range(iters):
        # ||x-c||^2 = ||x||^2 + ||c||^2 - 2 x@c.T  (argmin ignores ||x||^2)
        d2 = (c * c).sum(-1)[None, :] - 2.0 * (x @ c.T)  # [S, k]
        a = d2.argmin(1)
        for j in range(k):
            rows = x[a == j]
            if len(rows):
                c[j] = rows.mean(0)
    d_near = np.sqrt(
        np.maximum(x_sq + (c[a] * c[a]).sum(-1) - 2.0 * (x * c[a]).sum(-1),
                   0.0)).mean()
    d_mean = np.sqrt(((x - x.mean(0)) ** 2).sum(-1)).mean()
    if d_mean <= 0:
        return 1.0
    return float(max(0.0, 1.0 - d_near / d_mean))


# Below this score the ANN engines' recall collapses on the uniform
# control (scripts/uniform_control.py: 0.35 block / 0.16 graph
# recall@10 at 1M). The 128-d uniform control scores ~0.05-0.10; the
# clustered benchmark data scores ~0.4+.
STRUCTURE_MIN = 0.25


def choose_engine(n: int, dim: int, *, recall_target: float = 0.95,
                  sample: np.ndarray | None = None,
                  batch: int = 4096, m: int = 16, block_size: int = 256,
                  hw: HardwareModel = HardwareModel()) -> EnginePlan:
    """Pick the serving engine for a corpus — ``hnswcostestimate`` plus
    the planner's index-vs-seqscan choice rolled into one call.

    Prices flat / block / graph at their benchmark operating points and
    returns the fastest plan that can meet ``recall_target``: the flat
    scan is exact always; the ANN engines are only credible on data with
    cluster structure (gated by :func:`cluster_structure_score` when a
    ``sample`` is given — without one, clustered real-world-like data is
    assumed, matching upstream's optimism) and only below recall 0.99
    (the measured ceiling of their benchmark operating points).
    """
    flat = estimate_flat_qps(n, dim, batch=batch, hw=hw)
    flat8 = estimate_flat_int8_qps(n, dim, batch=batch, hw=hw)
    block = estimate_block_qps(n, dim, probes=8, block_size=block_size,
                               batch=batch, hw=hw)
    graph = estimate_graph_qps(n, dim, m=m, batch=batch, hw=hw)

    structure = None
    structure_note = ""
    if sample is not None:
        sample = np.asarray(sample, dtype=np.float32)
        # shrink k for small legitimate samples instead of propagating
        # cluster_structure_score's >=4k-rows ValueError (ADVICE r3); a
        # sample too small for even k=2 skips the gate with a note.
        k_gate = min(64, len(sample) // 4)
        if k_gate >= 2:
            structure = cluster_structure_score(sample, k=k_gate)
        else:
            structure_note = (
                f"; structure gate skipped: sample of {len(sample)} rows "
                "is too small to fit centroids (need >= 8)")
    ann_ok = structure is None or structure >= STRUCTURE_MIN

    del flat8  # measured parity with flat (INT8_SCAN_SPEEDUP): the
    # int8 scan never wins a plan, so it is not offered as one
    plans = [EnginePlan("flat", flat, True, {"exact": True},
                        "exact scan; recall 1.0 at any target")]
    if ann_ok and recall_target <= 0.99:
        plans.append(EnginePlan(
            "block", block, False,
            {"probes": 8, "block_size": block_size},
            "cluster-blocked level 0; stage-1 int8 scan + exact rerank"))
        plans.append(EnginePlan(
            "graph", graph, False,
            {"ef_search": 24, "expand": 4, "descent_ef": 8,
             "max_steps": 7, "route": "auto"},
            "classical beam search with dense scan routing"))
    best = max(plans, key=lambda p: p.est_qps)
    if structure is not None and not ann_ok and best.engine.startswith("flat"):
        best = dataclasses.replace(
            best, reason=best.reason +
            f"; ANN engines refused: structure score {structure:.2f} < "
            f"{STRUCTURE_MIN} (see scripts/uniform_control.py)")
    if structure_note:
        best = dataclasses.replace(best, reason=best.reason + structure_note)
    return best


def calibrate(n: int = 200_000, dim: int = 128, *, batch: int = 2048,
              seed: int = 0) -> HardwareModel:
    """Re-measure ALL five HardwareModel constants on the live device.

    Times, at modest shapes (~100 MB, seconds of device time), each as
    the median of several trials:

    - one tiny program → ``dispatch_s`` (per-program dispatch floor);
    - two programs chaining different numbers of random-row gathers →
      ``gather_rows_per_s`` from the slope, so neither dispatch nor the
      fetch enters it (one gather alone ends inside the dispatch floor);
    - one dense [batch, n] scoring matmul + top-k → ``f32_macs_per_s``;
    - one block-expansion program (int8 [batch, probes, S, dim] gather +
      scoring einsum, the exact stage index/block.py runs) →
      ``expand_bytes_per_s`` priced as write+re-read of the gathered
      intermediate, matching :func:`estimate_block_qps`'s accounting;
    - two real beam-search runs differing only in ``max_steps`` on a
      synthetic random graph → ``step_overhead_s``: the per-step time
      delta minus the per-step gather component (which the model prices
      separately via ``gather_rows_per_s``).
    """
    import time

    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    tbl = jnp.asarray(rng.normal(size=(n, dim)).astype(np.float32))
    ids = jnp.asarray(rng.integers(0, n, size=(batch, 128)).astype(np.int32))
    q = jnp.asarray(rng.normal(size=(batch, dim)).astype(np.float32))

    def gather(rounds):
        # ``rounds`` gathers of fresh random rows in one program
        @jax.jit
        def f(tbl, ids):
            def body(i, acc):
                rows = jnp.take(tbl, (ids + i) % n, axis=0, mode="clip")
                return acc + rows.sum()
            return jax.lax.fori_loop(0, rounds, body, jnp.float32(0))
        return f

    @jax.jit
    def scan(tbl, q):
        sc = q @ tbl.T
        return jax.lax.approx_min_k(sc, 10)[0].sum()

    @jax.jit
    def tiny(x):
        return x + 1.0

    def timeit(fn, *args, iters=10, trials=5):
        # every measured program returns a scalar reduction, so fetching
        # the LAST result bounds all ``iters`` dispatches at ~free cost;
        # the median over trials drops host-side stalls
        np.asarray(fn(*args))  # warm compile + fetch
        ts = []
        for _ in range(trials):
            t0 = time.perf_counter()
            for _ in range(iters):
                out = fn(*args)
            np.asarray(out)
            ts.append((time.perf_counter() - t0) / iters)
        return float(np.median(ts))

    t_dispatch = timeit(tiny, jnp.float32(1.0), iters=30)
    r_lo, r_hi = 2, 34
    t_gather = max((timeit(gather(r_hi), tbl, ids)
                    - timeit(gather(r_lo), tbl, ids)) / (r_hi - r_lo), 1e-9)
    t_scan = max(timeit(scan, tbl, q) - t_dispatch, 1e-9)
    gather_rows_per_s = batch * 128 / t_gather

    # --- expand_bytes_per_s: the block engine's stage-2 shape ---------
    S, probes = 256, 8
    n_blocks = max(1, n // S)
    blocks = jnp.asarray(
        rng.integers(-127, 128, size=(n_blocks, S, dim)).astype(np.int8))
    bids = jnp.asarray(
        rng.integers(0, n_blocks, size=(batch, probes)).astype(np.int32))
    q8 = jnp.asarray(rng.integers(-127, 128, size=(batch, dim)
                                  ).astype(np.int8))

    @jax.jit
    def expand(blocks, bids, q8):
        g = jnp.take(blocks, bids, axis=0)  # [batch, probes, S, dim] int8
        sc = jax.lax.dot_general(
            q8, g, (((1,), (3,)), ((0,), (0,))),
            preferred_element_type=jnp.int32)  # [batch, probes, S]
        return jax.lax.approx_min_k(-sc.reshape(batch, -1).astype(
            jnp.float32), 10)[0].sum()

    t_expand = max(timeit(expand, blocks, bids, q8, iters=5) - t_dispatch,
                   1e-9)
    expand_bytes = batch * probes * S * dim * 2  # intermediate write+re-read
    expand_bytes_per_s = expand_bytes / t_expand

    # --- step_overhead_s: beam runs differing only in max_steps ------
    from tpu_hnsw.config import HnswConfig
    from tpu_hnsw.index import graph as G
    from tpu_hnsw.index import search as SL

    m, ef, expand_w = 16, 24, 4
    gn = min(n, 65536)
    gvec = jnp.asarray(
        np.concatenate([rng.normal(size=(gn, dim)).astype(np.float32),
                        np.zeros((1, dim), np.float32)]))
    nbr0 = jnp.asarray(np.concatenate(
        [rng.integers(0, gn, size=(gn, 2 * m)),
         np.full((1, 2 * m), gn)]).astype(np.int32))
    cap_u = 1
    g = G.HnswGraph(
        vectors=gvec,
        vectors_sq=(gvec * gvec).sum(-1),
        neighbors0=nbr0,
        upper_nbrs=jnp.full((cap_u + 1, 1, m), gn, jnp.int32),
        upper_slot=jnp.full((gn + 1,), cap_u, jnp.int32),
        levels=jnp.zeros((gn + 1,), jnp.int32),
        deleted=jnp.zeros((gn + 1,), bool),
    )
    seeds = jnp.asarray(
        rng.integers(0, gn, size=(batch, 8)).astype(np.int32))

    def beam(steps):
        return lambda g, q, s: SL.search_layer(
            g, q, s, ef=ef, expand=expand_w, max_steps=steps)[0].sum()

    s_lo, s_hi = 4, 12
    t_lo = timeit(jax.jit(beam(s_lo)), g, q, seeds, iters=5)
    t_hi = timeit(jax.jit(beam(s_hi)), g, q, seeds, iters=5)
    per_step = max((t_hi - t_lo) / (s_hi - s_lo), 1e-9)
    gather_per_step = batch * expand_w * 2 * m / gather_rows_per_s
    step_overhead_s = max(per_step - gather_per_step, 1e-6)

    return HardwareModel(
        gather_rows_per_s=gather_rows_per_s,
        f32_macs_per_s=batch * 2.0 * n * dim / t_scan,
        expand_bytes_per_s=expand_bytes_per_s,
        dispatch_s=t_dispatch,
        step_overhead_s=step_overhead_s,
    )
