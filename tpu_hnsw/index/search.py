"""Batched, masked frontier-expansion beam search.

The batched reformulation of the reference's per-query pointer-chasing
``HnswSearchLayer`` (upstream ``pgvector:src/hnswutils.c``): a whole batch
of queries steps in lockstep; each step

1. picks each query's best unexpanded pool candidate(s),
2. gathers their adjacency rows (one batched device gather — the analogue of
   the per-hop neighbor page read),
3. gathers the neighbor vectors and scores them with a fused batched
   matmul,
4. merges scored neighbors into the fixed-width candidate pool via top-k.

Instead of the reference's per-query visited hash table (or an N-bit
bitmask), deduplication checks membership in the candidate pool plus the
expansion history ring — memory O(Q * (ef + steps)), independent of N, so
it scales to 100M-element shards. A node pruned from the pool can be
re-scored (never re-expanded); this only adds distance evaluations and
never loses candidates relative to the reference semantics.

Termination matches the reference: a query goes inactive when its best
unexpanded candidate is farther than its worst pooled result (the
``d_c > f`` break in ``HnswSearchLayer``), with a static step bound for
the XLA while-loop.

Compile-friendliness: the upper-level variant takes the level as a
*dynamic* scalar (adjacency rows are gathered [L, m] per element and the
level column selected on-device), so one compiled kernel serves every
upper level; only level 0 (different degree) is a second kernel. The full
query search (greedy descent over a dynamic number of upper levels + the
level-0 beam) is a single jit.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from tpu_hnsw.config import Metric
from tpu_hnsw.index import graph as G
from tpu_hnsw.ops import distance as D
from tpu_hnsw.ops import topk as T

INF = jnp.float32(jnp.inf)


def _neighbor_rows(g: G.HnswGraph, ids: jax.Array, level0: bool, level) -> jax.Array:
    """Adjacency rows for ids at a level. ``level0`` is static; for upper
    levels ``level`` is a traced scalar: the [L, m] stack is gathered per
    element and the level column picked on-device (upper tables are ~n/m
    elements, so the L-times-wider gather is still cheap)."""
    if level0:
        return jnp.take(g.neighbors0, ids, axis=0, mode="clip")
    slots = jnp.take(g.upper_slot, ids, axis=0, mode="clip")
    rows = jnp.take(g.upper_nbrs, slots, axis=0, mode="clip")  # [..., L, m]
    lvl = jnp.clip(level - 1, 0, g.upper_nbrs.shape[1] - 1)
    return jax.lax.dynamic_index_in_dim(
        jnp.moveaxis(rows, -2, 0), lvl, axis=0, keepdims=False
    )


def init_pool(
    g: G.HnswGraph,
    q: jax.Array,
    q_sq: jax.Array,
    init_ids: jax.Array,
    metric: Metric,
    ef: int,
):
    """Build a sorted candidate pool of width ef from seed ids [Q, S]."""
    v, v_sq = G.gather_vectors(g, init_ids)
    dists = D.batched_scores(q, v, metric, vecs_sq=v_sq, q_sq=q_sq)
    dists = jnp.where(init_ids == g.sentinel, INF, dists)
    s = init_ids.shape[1]
    if s < ef:
        pad = ef - s
        dists = jnp.pad(dists, ((0, 0), (0, pad)), constant_values=INF)
        init_ids = jnp.pad(init_ids, ((0, 0), (0, pad)), constant_values=g.sentinel)
    pool_d, sel = T.topk_smallest(dists, ef)
    pool_i = jnp.take_along_axis(init_ids, sel, axis=1)
    return pool_d, pool_i


def _search_layer_body(
    g: G.HnswGraph,
    q: jax.Array,
    init_ids: jax.Array,
    level,
    *,
    level0: bool,
    ef: int,
    expand: int,
    max_steps: int,
    metric: Metric,
    skip_deleted: bool,
    hist_window: int = 64,
    mask_deleted_results: bool = False,
    with_counters: bool = False,
    init_state: tuple | None = None,
    return_state: bool = False,
    reset_frontier: bool = False,
    allowed: jax.Array | None = None,
) -> tuple[jax.Array, jax.Array]:
    """Trace-time body shared by the jitted entry points.

    ``allowed`` is an optional device-resident ``[cap+1]`` bool mask — the
    device-side filtered scan: upstream runs the filter
    predicate per tuple in the executor; here disallowed elements are
    fused into the ``fresh`` mask exactly like tombstones, so they are
    never scored, never enter the pool, and the filter costs one gather
    per step instead of a host round-trip per batch. Seeds from the
    (unfiltered) upper-level routing are masked out of the results at the
    end, the same way deleted seeds are.

    ``with_counters=True`` additionally returns (hops [Q], dist_evals [Q])
    int32 per-query counters — the SURVEY §5 observability metrics
    (hops/query = loop steps in which the query expanded at least one
    candidate; dist_evals/query = fresh neighbors actually scored). The
    counters live in the while-loop carry, so the cost is two vector adds
    per step.

    ``init_state``/``return_state`` make the search RESUMABLE (the
    iterative-scan analogue of upstream hnswscan.c keeping its candidate
    discard/visited lists across GetScanItems calls): state is
    (pool_d, pool_i, pool_x, hist, hops, evals) with pool width <= ef
    (narrower pools are padded, so a resume can widen ef). With a given
    init_state the expanded flags survive, so previously-expanded nodes
    are never re-expanded — a widened resume continues the search instead
    of restarting it."""
    E = min(expand, ef)
    deg = g.neighbors0.shape[1] if level0 else g.upper_nbrs.shape[2]
    sent = g.sentinel
    Q = q.shape[0]
    # History ring: bounded window of recent expansions. Re-scoring an
    # expanded-then-pruned node that fell out of the window wastes only
    # bandwidth — it can never re-enter the pool (pool entries are
    # monotonically improving), so a small window is safe. The [Q, G, H]
    # membership compare is itself HBM traffic, so the window is kept small.
    H = max(min(hist_window, max_steps * E), E)
    hist_slots = max(H // E, 1)

    qf = q
    q_sq = D.squared_norms(q)

    if init_state is not None:
        pool_d, pool_i, pool_x, hist, hops, evals = init_state
        ef_old = pool_d.shape[1]
        if ef_old < ef:  # widen: pad pool with empty slots
            pad = ef - ef_old
            pool_d = jnp.pad(pool_d, ((0, 0), (0, pad)), constant_values=INF)
            pool_i = jnp.pad(pool_i, ((0, 0), (0, pad)), constant_values=sent)
            pool_x = jnp.pad(pool_x, ((0, 0), (0, pad)))
        if reset_frontier:
            # Widening: previously-pruned candidates live nowhere (the
            # history ring stores ids for dedup, not distances), so a
            # strictly-monotone resume would terminate immediately — every
            # retained pool entry is already expanded. Reset the expanded
            # flags and the history so the retained pool becomes the new
            # frontier: descent and pool content survive, and the
            # geometric ef doubling bounds total rework at <=2x the work
            # of a single ef_final search (the same argument upstream's
            # discarded-candidate heap avoids at the cost of unbounded
            # per-scan memory).
            pool_x = jnp.zeros_like(pool_x)
            hist = jnp.full((Q, H), sent, dtype=jnp.int32)
        if hist.shape[1] < H:
            hist = jnp.pad(hist, ((0, 0), (0, H - hist.shape[1])),
                           constant_values=sent)
        H = hist.shape[1]
        hist_slots = max(H // E, 1)
    else:
        pool_d, pool_i = init_pool(g, qf, q_sq, init_ids, metric, ef)
        pool_x = jnp.zeros((Q, ef), dtype=jnp.bool_)  # expanded flags
        hist = jnp.full((Q, H), sent, dtype=jnp.int32)
        hops = jnp.zeros((Q,), jnp.int32)
        evals = jnp.zeros((Q,), jnp.int32)

    def cond(state):
        pool_d, pool_i, pool_x, hist, step, hops, evals = state
        valid = pool_i != sent
        unexp = valid & ~pool_x
        min_unexp = jnp.min(jnp.where(unexp, pool_d, INF), axis=1)
        pool_max = jnp.where(jnp.all(valid, axis=1), jnp.max(pool_d, axis=1), INF)
        active = jnp.any(unexp, axis=1) & (min_unexp <= pool_max)
        return (step < max_steps) & jnp.any(active)

    def body(state):
        pool_d, pool_i, pool_x, hist, step, hops, evals = state
        valid = pool_i != sent
        unexp = valid & ~pool_x
        pool_max = jnp.where(jnp.all(valid, axis=1), jnp.max(pool_d, axis=1), INF)

        # pick E best unexpanded candidates within the termination bound
        masked = jnp.where(unexp, pool_d, INF)
        neg_vals, pos = jax.lax.top_k(-masked, E)  # [Q, E]
        cand_d = -neg_vals
        ok = jnp.isfinite(cand_d) & (cand_d <= pool_max[:, None])
        e_ids = jnp.where(ok, jnp.take_along_axis(pool_i, pos, axis=1), sent)

        # mark expanded
        cur = jnp.take_along_axis(pool_x, pos, axis=1)
        pool_x = jnp.put_along_axis(pool_x, pos, cur | ok, axis=1, inplace=False)

        # record in history ring (wraps after hist_slots steps)
        hist = jax.lax.dynamic_update_slice(hist, e_ids, (0, (step % hist_slots) * E))

        # batched adjacency gather (the per-hop "page read")
        nbrs = _neighbor_rows(g, e_ids, level0, level).reshape(Q, E * deg)
        fresh = nbrs != sent
        if skip_deleted:
            fresh &= ~jnp.take(g.deleted, nbrs, mode="clip")
        if allowed is not None:
            fresh &= jnp.take(allowed, nbrs, mode="clip")
        # dedup: vs pool, vs expansion history, vs earlier in this gather
        fresh &= ~jnp.any(nbrs[:, :, None] == pool_i[:, None, :], axis=2)
        fresh &= ~jnp.any(nbrs[:, :, None] == hist[:, None, :], axis=2)
        if E > 1:
            # two expanded nodes can share a neighbor; within ONE adjacency
            # row ids are unique by graph invariant, so E=1 needs no pass
            g_dim = E * deg
            earlier = (nbrs[:, :, None] == nbrs[:, None, :]) & (
                jax.lax.broadcasted_iota(jnp.int32, (1, g_dim, g_dim), 2)
                < jax.lax.broadcasted_iota(jnp.int32, (1, g_dim, g_dim), 1)
            )
            fresh &= ~jnp.any(earlier, axis=2)

        # fused gather + distance
        v, v_sq = G.gather_vectors(g, nbrs)
        dists = D.batched_scores(qf, v, metric, vecs_sq=v_sq, q_sq=q_sq)
        dists = jnp.where(fresh, dists, INF)
        ids = jnp.where(fresh, nbrs, sent)

        pool_d, pool_i, pool_x = T.merge_pools(
            pool_d, pool_i, pool_x, dists, ids, jnp.zeros_like(fresh), ef
        )
        if with_counters:
            hops = hops + jnp.any(ok, axis=1).astype(jnp.int32)
            evals = evals + jnp.sum(fresh, axis=1).astype(jnp.int32)
        return pool_d, pool_i, pool_x, hist, step + 1, hops, evals

    pool_d, pool_i, pool_x, hist, _, hops, evals = jax.lax.while_loop(
        cond, body, (pool_d, pool_i, pool_x, hist, jnp.int32(0), hops, evals)
    )
    state = (pool_d, pool_i, pool_x, hist, hops, evals)
    if mask_deleted_results or allowed is not None:
        # Tombstoned elements navigate like live ones (upstream scans keep
        # traversing marked-deleted elements until vacuum repairs the
        # graph; they are filtered at the heap-visibility check) but must
        # never be *returned* (ADVICE r1: a deleted entry point seeded the
        # pool and came back as the #1 hit). Expansion never adds deleted
        # neighbors (fresh mask), so only seeds can be deleted here — and
        # likewise only seeds can be filter-disallowed.
        deld = jnp.take(g.deleted, pool_i, mode="clip")
        if not mask_deleted_results:
            deld = jnp.zeros_like(deld)
        if allowed is not None:
            deld |= ~jnp.take(allowed, pool_i, mode="clip")
        pool_d = jnp.where(deld, INF, pool_d)
        pool_d, sel = T.topk_smallest(pool_d, ef)
        pool_i = jnp.where(
            jnp.isinf(pool_d),
            jnp.int32(sent),
            jnp.take_along_axis(pool_i, sel, axis=1),
        )
    if return_state:
        return pool_d, pool_i, state
    if with_counters:
        return pool_d, pool_i, hops, evals
    return pool_d, pool_i


@functools.partial(
    jax.jit,
    static_argnames=("level0", "ef", "expand", "max_steps", "metric", "skip_deleted"),
)
def search_layer(
    g: G.HnswGraph,
    q: jax.Array,
    init_ids: jax.Array,
    level=0,
    *,
    level0: bool = True,
    ef: int,
    expand: int = 1,
    max_steps: int = 0,
    metric: Metric = Metric.L2,
    skip_deleted: bool = True,
    allowed: jax.Array | None = None,
) -> tuple[jax.Array, jax.Array]:
    """ef-bounded beam search at one level (jit entry point).

    q: [Q, d] (storage dtype), init_ids: [Q, S] seed ids; ``level`` is a
    dynamic scalar used only when ``level0=False``.
    Returns (pool_dists [Q, ef], pool_ids [Q, ef]) sorted ascending;
    sentinel ids carry +inf.
    """
    if max_steps <= 0:
        max_steps = 2 * ef + 16
    return _search_layer_body(
        g,
        q,
        init_ids,
        level,
        level0=level0,
        ef=ef,
        expand=expand,
        max_steps=max_steps,
        metric=metric,
        skip_deleted=skip_deleted,
        allowed=allowed,
    )


@functools.partial(
    jax.jit, static_argnames=("metric", "descent_ef", "max_steps")
)
def descend_seeds(
    g: G.HnswGraph,
    q: jax.Array,
    entry,
    entry_level,
    down_to,
    *,
    metric: Metric = Metric.L2,
    descent_ef: int = 1,
    max_steps: int = 128,
) -> jax.Array:
    """Greedy upper-level descent producing seeds for a search at level
    ``down_to`` (jit entry point; ``down_to`` is dynamic).

    This is the routing half of HnswFindElementNeighbors (upstream
    pgvector:src/hnswutils.c): level-0 adjacency is short-range by
    construction, so a level-0-only beam from the global entry point can
    be stuck in the entry's basin on clustered data — repairs/insert
    searches MUST route through the upper levels first.
    """
    return _descend_body(g, q, entry, entry_level, down_to, metric,
                         max_steps=max_steps, descent_ef=descent_ef)


@functools.partial(
    jax.jit,
    static_argnames=("ef", "expand", "max_steps", "metric", "descent_ef"),
)
def search_resumable_start(
    g: G.HnswGraph,
    queries: jax.Array,
    entry,
    entry_level,
    *,
    ef: int,
    expand: int = 1,
    max_steps: int = 0,
    metric: Metric = Metric.L2,
    descent_ef: int = 1,
):
    """First pass of a resumable scan: full search (descent + level-0
    beam) that ALSO returns the level-0 loop state, so a later
    :func:`search_resume` can widen ef and continue (upstream
    hnsw.iterative_scan semantics — the scan keeps its candidate state
    between batches instead of restarting, SURVEY §3.2).

    Returns (pool_d [Q, ef], pool_i [Q, ef], state)."""
    if max_steps <= 0:
        max_steps = ef // max(expand, 1) + 16
    q = queries.astype(g.vectors.dtype)
    seeds = _descend_body(g, q, entry, entry_level, 0, metric,
                          descent_ef=descent_ef)
    return _search_layer_body(
        g, q, seeds, 0, level0=True, ef=ef, expand=expand,
        max_steps=max_steps, metric=metric, skip_deleted=True,
        mask_deleted_results=True, with_counters=True, return_state=True,
    )


@functools.partial(
    jax.jit, static_argnames=("ef", "expand", "max_steps", "metric")
)
def search_resume(
    g: G.HnswGraph,
    queries: jax.Array,
    state,
    *,
    ef: int,
    expand: int = 1,
    max_steps: int = 0,
    metric: Metric = Metric.L2,
):
    """Continue a level-0 scan from saved state with a (possibly wider)
    ef. Previously-expanded nodes stay expanded — no rework beyond the
    bounded history window's re-scores."""
    if max_steps <= 0:
        max_steps = ef // max(expand, 1) + 16
    q = queries.astype(g.vectors.dtype)
    return _search_layer_body(
        g, q, None, 0, level0=True, ef=ef, expand=expand,
        max_steps=max_steps, metric=metric, skip_deleted=True,
        mask_deleted_results=True, with_counters=True, return_state=True,
        init_state=state, reset_frontier=True,
    )


def _scan_seeds_body(
    g: G.HnswGraph,
    q: jax.Array,
    upper_ids: jax.Array,
    descent_ef: int,
    metric: Metric,
) -> jax.Array:
    """Dense matmul routing over the level>=1 subset — the batched
    alternative to greedy upper-level descent.

    The upper HNSW layers are a routing structure built for sequential
    pointer-chasing machines; on an accelerator the same ~n/m element
    subset is routed by ONE dense matmul + top-k instead of a serial
    chain of small gathers per level. Exhaustive routing over the subset is
    strictly stronger than ef=1..8 greedy descent (it finds the global
    nearest level>=1 elements), so recall can only improve vs upstream's
    descent (``HnswSearchLayer`` with ef=1, pgvector:src/hnswutils.c).

    q: [Q, d] storage dtype; upper_ids: [U] int32 ids of level>=1
    elements, sentinel-padded. Returns seed ids [Q, descent_ef].
    """
    v, v_sq = G.gather_vectors(g, upper_ids)  # [U, d], [U]
    if metric is Metric.L1:
        raise NotImplementedError("L1 routing has no matmul form")
    dots = jax.lax.dot_general(
        q, v.T, (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    if metric is Metric.L2:
        q_sq = D.squared_norms(q)
        sc = q_sq[:, None] + v_sq[None, :] - 2.0 * dots
    else:  # IP / cosine (vectors pre-normalized)
        sc = -dots
    sc = jnp.where(upper_ids[None, :] == g.sentinel, INF, sc)
    _, ti = T.topk_smallest_fast(sc, min(descent_ef, sc.shape[1]))
    return jnp.take(upper_ids, ti)


@functools.partial(
    jax.jit, static_argnames=("descent_ef", "metric")
)
def scan_seeds(
    g: G.HnswGraph,
    q: jax.Array,
    upper_ids: jax.Array,
    *,
    descent_ef: int = 8,
    metric: Metric = Metric.L2,
) -> jax.Array:
    """Jit entry point for :func:`_scan_seeds_body` (tests/tools)."""
    return _scan_seeds_body(g, q.astype(g.vectors.dtype), upper_ids,
                            descent_ef, metric)


def _descend_body(
    g: G.HnswGraph,
    q: jax.Array,
    entry,
    entry_level,
    down_to,
    metric: Metric,
    max_steps: int = 128,
    descent_ef: int = 1,
):
    """Greedy descent from a dynamic entry level down to ``down_to``
    (exclusive), as a traced fori loop — one compile for any entry level.

    ``descent_ef=1`` reproduces the reference's upper-level loop
    (FindElementNeighbors searches with ef=1). Wider descent carries a
    small beam through the upper levels and seeds level 0 with its top
    entries — measured to close multi-basin routing failures entirely
    (recall ceiling 0.96 -> 1.0 on clustered 100k data) for ~30% extra
    upper-level work, which is a tiny share of total search cost.
    """
    Q = q.shape[0]
    seeds = jnp.full((Q, 1), entry, dtype=jnp.int32)
    if descent_ef > 1:
        seeds = jnp.pad(
            seeds, ((0, 0), (0, descent_ef - 1)), constant_values=g.sentinel
        )
    L = g.upper_nbrs.shape[1]

    def body(i, seeds):
        lvl = entry_level - i
        def run(s):
            _, out = _search_layer_body(
                g, q, s, lvl, level0=False, ef=descent_ef,
                expand=min(4, descent_ef), max_steps=max_steps,
                metric=metric, skip_deleted=True,
            )
            return out
        return jax.lax.cond(lvl > down_to, run, lambda s: s, seeds)

    return jax.lax.fori_loop(0, L, body, seeds)


@functools.partial(
    jax.jit,
    static_argnames=(
        "k", "ef", "expand", "max_steps", "metric", "descent_ef",
        "with_counters",
    ),
)
def _search_jit(
    g: G.HnswGraph,
    queries: jax.Array,
    entry,
    entry_level,
    *,
    k: int,
    ef: int,
    expand: int,
    max_steps: int,
    metric: Metric,
    descent_ef: int = 1,
    with_counters: bool = False,
    allowed: jax.Array | None = None,
):
    q = queries.astype(g.vectors.dtype)
    with jax.named_scope("descend"):
        seeds = _descend_body(g, q, entry, entry_level, 0, metric,
                              descent_ef=descent_ef)
    with jax.named_scope("beam_level0"):
        out = _search_layer_body(
            g, q, seeds, 0, level0=True, ef=ef, expand=expand,
            max_steps=max_steps, metric=metric, skip_deleted=True,
            mask_deleted_results=True, with_counters=with_counters,
            allowed=allowed,
        )
    if with_counters:
        pool_d, pool_i, hops, evals = out
        return pool_d[:, :k], pool_i[:, :k], hops, evals
    pool_d, pool_i = out
    return pool_d[:, :k], pool_i[:, :k]


@functools.partial(
    jax.jit,
    static_argnames=(
        "k", "ef", "expand", "max_steps", "metric", "descent_ef",
        "with_counters",
    ),
)
def _search_scan_jit(
    g: G.HnswGraph,
    queries: jax.Array,
    upper_ids: jax.Array,
    *,
    k: int,
    ef: int,
    expand: int,
    max_steps: int,
    metric: Metric,
    descent_ef: int = 8,
    with_counters: bool = False,
    allowed: jax.Array | None = None,
):
    """Full search with dense-scan routing instead of greedy descent:
    one matmul over the level>=1 subset seeds the level-0 beam."""
    q = queries.astype(g.vectors.dtype)
    with jax.named_scope("route_scan"):
        seeds = _scan_seeds_body(g, q, upper_ids, descent_ef, metric)
    with jax.named_scope("beam_level0"):
        out = _search_layer_body(
            g, q, seeds, 0, level0=True, ef=ef, expand=expand,
            max_steps=max_steps, metric=metric, skip_deleted=True,
            mask_deleted_results=True, with_counters=with_counters,
            allowed=allowed,
        )
    if with_counters:
        pool_d, pool_i, hops, evals = out
        return pool_d[:, :k], pool_i[:, :k], hops, evals
    pool_d, pool_i = out
    return pool_d[:, :k], pool_i[:, :k]


def search(
    g: G.HnswGraph,
    queries: jax.Array,
    *,
    entry: int,
    entry_level: int,
    k: int,
    ef_search: int,
    metric: Metric,
    expand: int = 1,
    max_steps: int = 0,
    descent_ef: int = 1,
    with_counters: bool = False,
    upper_ids: jax.Array | None = None,
    allowed: jax.Array | None = None,
) -> tuple[jax.Array, jax.Array]:
    """Full query search (upstream hnswscan.c GetScanItems): upper-level
    routing (greedy descent, or a dense scan of the level>=1 subset when
    ``upper_ids`` is given) then an ef_search-bounded level-0 beam — one
    compiled program per (Q, ef, k) bucket.

    Returns (scores [Q, k] ascending, ids [Q, k]); internal score units
    (see ops.distance.score_to_distance). ``with_counters=True`` appends
    per-query (hops, dist_evals) int32 arrays (SURVEY §5 metrics).
    """
    ef = max(ef_search, k)
    if max_steps <= 0:
        # natural termination lands near ef/expand steps (measured); the
        # margin covers slow-converging tail queries without letting the
        # lockstep batch run long after everyone is done
        max_steps = ef // max(expand, 1) + 16
    if upper_ids is not None and metric is not Metric.L1:
        return _search_scan_jit(
            g,
            queries,
            upper_ids,
            k=k,
            ef=ef,
            expand=expand,
            max_steps=max_steps,
            metric=metric,
            descent_ef=max(descent_ef, 1),
            with_counters=with_counters,
            allowed=allowed,
        )
    return _search_jit(
        g,
        queries,
        jnp.int32(entry),
        jnp.int32(entry_level),
        k=k,
        ef=ef,
        expand=expand,
        max_steps=max_steps,
        metric=metric,
        descent_ef=descent_ef,
        with_counters=with_counters,
        allowed=allowed,
    )


@functools.partial(jax.jit, static_argnames=("down_to", "metric"))
def descend(
    g: G.HnswGraph,
    q: jax.Array,
    entry,
    entry_level,
    *,
    down_to: int = 0,
    metric: Metric = Metric.L2,
) -> jax.Array:
    """Standalone greedy-descent helper (build path and tests)."""
    return _descend_body(g, q, entry, entry_level, down_to, metric)
