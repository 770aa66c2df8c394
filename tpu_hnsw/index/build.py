"""Wave-batched HNSW construction.

The batched replacement of the reference's build paths: the per-tuple
insert loop (upstream ``pgvector:src/hnswinsert.c`` ``HnswInsertTupleOnDisk``
and the in-memory parallel build of ``hnswbuild.c``) becomes *waves* of B
vectors inserted together:

1. one batched descent + ef_construction search per level for the whole
   wave (reusing :mod:`tpu_hnsw.index.search`),
2. one batched ``SelectNeighbors`` per level (:mod:`.select`),
3. reciprocal-edge insertion with *deterministic conflict resolution*:
   all (target, new-element) updates of a wave are lex-sorted by
   (target, distance) and applied in fixed-size chunks under ``lax.scan``,
   each chunk re-reading the adjacency written by the previous chunk —
   the lock-free analogue of pgvector's per-element LWLock discipline
   (``HnswUpdateConnection``), with identical append-or-reselect semantics
   provided by ``select.select_neighbors``.

Wave staleness (elements of one wave not seeing each other during their
searches) matches the staleness of pgvector's *parallel* build, where
concurrent workers insert elements that in-flight searches may miss;
``wave_size=1`` reproduces exact sequential semantics (test oracle), and
intra-wave brute-force link candidates restore sequential-grade
connectivity at large wave sizes.

Compile discipline: every wave is padded to ONE static bucket
(next_pow2(wave_size)); upper-level prefixes are padded to expectation-
based buckets; upper levels share one kernel via a dynamic level scalar.
A whole build compiles O(10) programs total, regardless of wave count.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from tpu_hnsw.config import HnswConfig, Metric
from tpu_hnsw.index import graph as G
from tpu_hnsw.index import select as S
from tpu_hnsw.index.search import search_layer
from tpu_hnsw.ops import distance as D

INF = jnp.float32(jnp.inf)

# Max reciprocal insertions per target per chunk; a target receiving more
# new edges than this within a single chunk keeps the closest UPDATE_R
# (the rest are dropped; across chunks the scan serializes, so only
# same-chunk overflow beyond UPDATE_R is lossy).
UPDATE_R = 16
UPDATE_CHUNK = 8192


def next_pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << (x - 1).bit_length()


@functools.partial(jax.jit, donate_argnums=(0,))
def _set_wave(g: G.HnswGraph, ids, vecs, levels, slots) -> G.HnswGraph:
    """Scatter a wave's vectors/levels/slots into the flat tables."""
    vecs = vecs.astype(g.vectors.dtype)
    return g._replace(
        vectors=g.vectors.at[ids].set(vecs, mode="drop"),
        vectors_sq=g.vectors_sq.at[ids].set(D.squared_norms(vecs), mode="drop"),
        levels=g.levels.at[ids].set(levels, mode="drop"),
        upper_slot=g.upper_slot.at[ids].set(slots, mode="drop"),
    )


@jax.jit
def _mask_pool(pool_d, pool_i, n_valid, sentinel):
    """Invalidate pool rows >= n_valid (padding rows of a wave bucket)."""
    rows = jax.lax.broadcasted_iota(jnp.int32, pool_i.shape, 0)
    keep = rows < n_valid
    return jnp.where(keep, pool_d, INF), jnp.where(keep, pool_i, sentinel)


@functools.partial(
    jax.jit, static_argnames=("level0",), donate_argnums=(0,)
)
def _write_own_lists(g: G.HnswGraph, ids, slots, sel_ids, level, *, level0: bool):
    """Write the wave elements' own adjacency rows at a level
    (dynamic scalar for upper levels)."""
    if level0:
        deg = g.neighbors0.shape[1]
        pad = deg - sel_ids.shape[1]
        if pad > 0:
            sel_ids = jnp.pad(sel_ids, ((0, 0), (0, pad)), constant_values=g.sentinel)
        return g._replace(neighbors0=g.neighbors0.at[ids].set(sel_ids, mode="drop"))
    m = g.upper_nbrs.shape[2]
    pad = m - sel_ids.shape[1]
    if pad > 0:
        sel_ids = jnp.pad(sel_ids, ((0, 0), (0, pad)), constant_values=g.sentinel)
    lvl = jnp.clip(level - 1, 0, g.upper_nbrs.shape[1] - 1)
    return g._replace(
        upper_nbrs=g.upper_nbrs.at[slots, lvl].set(sel_ids, mode="drop")
    )


@functools.partial(
    jax.jit, static_argnames=("level0", "lm", "metric"), donate_argnums=(0,)
)
def _reciprocal_update(
    g: G.HnswGraph,
    targets,  # [U] int32 sorted by (target, dist)
    sources,  # [U] int32
    dists,  # [U] f32 dist(target, source)
    level,  # dynamic scalar (used when level0=False)
    *,
    level0: bool,
    lm: int,
    metric: Metric,
) -> G.HnswGraph:
    """Apply reciprocal-edge updates, chunk-serialized under lax.scan.

    Equivalent to running upstream ``HnswUpdateConnection`` once per
    (target, new) pair: append when the target has room, otherwise
    re-select over existing ∪ new (handled uniformly by select_neighbors'
    keep-everything degeneration).
    """
    sent = g.sentinel
    U = targets.shape[0]
    ch = min(UPDATE_CHUNK, U)
    nchunks = (U + ch - 1) // ch
    pad = nchunks * ch - U
    if pad:
        targets = jnp.pad(targets, (0, pad), constant_values=sent)
        sources = jnp.pad(sources, (0, pad), constant_values=sent)
        dists = jnp.pad(dists, (0, pad), constant_values=jnp.inf)
    xs = (
        targets.reshape(nchunks, ch),
        sources.reshape(nchunks, ch),
        dists.reshape(nchunks, ch),
    )

    adj0 = g.neighbors0 if level0 else g.upper_nbrs
    lvl = jnp.clip(level - 1, 0, g.upper_nbrs.shape[1] - 1)

    def chunk_step(adj, x):
        t, u, d = x
        gg = g._replace(neighbors0=adj) if level0 else g._replace(upper_nbrs=adj)
        # group rows by target within the chunk
        first = jnp.concatenate([jnp.ones((1,), jnp.bool_), t[1:] != t[:-1]])
        idx = jax.lax.broadcasted_iota(jnp.int32, (ch, 1), 0).squeeze(-1)
        run_start = jax.lax.cummax(jnp.where(first, idx, 0))
        rank = idx - run_start
        seg = jnp.cumsum(first) - 1  # chunk-local unique-target slot
        valid = t != sent

        tu = jnp.full((ch,), sent, jnp.int32).at[seg].set(
            jnp.where(valid, t, sent), mode="drop"
        )
        new_ids = jnp.full((ch, UPDATE_R), sent, jnp.int32).at[seg, rank].set(
            jnp.where(valid & (rank < UPDATE_R), u, sent), mode="drop"
        )
        new_dists = jnp.full((ch, UPDATE_R), jnp.inf).at[seg, rank].set(
            jnp.where(valid & (rank < UPDATE_R), d, jnp.inf), mode="drop"
        )

        # current adjacency of each unique target
        if level0:
            slots = None
            old = jnp.take(adj, tu, axis=0, mode="clip")
        else:
            slots = jnp.take(g.upper_slot, tu, mode="clip")
            rows3 = jnp.take(adj, slots, axis=0, mode="clip")  # [ch, L, m]
            old = jax.lax.dynamic_index_in_dim(
                jnp.moveaxis(rows3, 1, 0), lvl, axis=0, keepdims=False
            )
        old = jnp.where((tu == sent)[:, None], sent, old)

        # distances target -> existing neighbors (recomputed: the flat
        # layout stores no per-edge distances, trading a little bandwidth
        # for pgvector neighbor-tuple memory parity)
        tvec, tsq = G.gather_vectors(gg, tu)
        ovec, osq = G.gather_vectors(gg, old)
        od = D.batched_scores(tvec, ovec, metric, vecs_sq=osq, q_sq=tsq)
        od = jnp.where(old == sent, jnp.inf, od)

        # dedup: a new id may already sit in the target's list (possible when
        # wave elements link to each other via intra-wave candidates)
        dup = jnp.any(new_ids[:, :, None] == old[:, None, :], axis=2)
        new_ids = jnp.where(dup, sent, new_ids)
        new_dists = jnp.where(dup, jnp.inf, new_dists)

        cand_ids = jnp.concatenate([old, new_ids], axis=1)
        cand_d = jnp.concatenate([od, new_dists], axis=1)
        sel_ids, _ = S.select_neighbors(gg, cand_ids, cand_d, lm=lm, metric=metric)

        if level0:
            deg = adj.shape[1]
            if deg > lm:
                sel_ids = jnp.pad(
                    sel_ids, ((0, 0), (0, deg - lm)), constant_values=sent
                )
            adj = adj.at[tu].set(sel_ids, mode="drop")
        else:
            m = adj.shape[2]
            if m > lm:
                sel_ids = jnp.pad(sel_ids, ((0, 0), (0, m - lm)), constant_values=sent)
            adj = adj.at[slots, lvl].set(sel_ids, mode="drop")
        return adj, None

    adj0, _ = jax.lax.scan(chunk_step, adj0, xs)
    return g._replace(neighbors0=adj0) if level0 else g._replace(upper_nbrs=adj0)


@functools.partial(jax.jit, static_argnames=("w", "metric"))
def _wave_link_candidates(vecs, ids, n_valid, sentinel, *, w: int, metric: Metric):
    """Within-wave brute-force top-w candidates per wave element.

    Returns (dists [B, w], ids [B, w]) over wavemates only; padding rows and
    the self-diagonal are masked. These are merged into the candidate pool
    before SelectNeighbors so elements of one wave can pick each other as
    neighbors, matching the connectivity of a sequential build.
    """
    B = vecs.shape[0]
    scores = D.pairwise_scores(vecs, vecs, metric)  # [B, B]
    rows = jax.lax.broadcasted_iota(jnp.int32, (B, B), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (B, B), 1)
    bad = (rows == cols) | (rows >= n_valid) | (cols >= n_valid)
    scores = jnp.where(bad, INF, scores)
    vals, pos = jax.lax.top_k(-scores, w)
    vals = -vals
    cand = jnp.take_along_axis(
        jnp.broadcast_to(ids[None, :], (B, B)), pos, axis=1
    )
    return vals, jnp.where(jnp.isfinite(vals), cand, sentinel)


@jax.jit
def _sorted_updates(sel_ids, sel_dists, src_ids):
    """Flatten selections to (target, source, dist) lex-sorted updates."""
    B, lm = sel_ids.shape
    t = sel_ids.reshape(-1)
    u = jnp.broadcast_to(src_ids[:, None], (B, lm)).reshape(-1)
    d = sel_dists.reshape(-1)
    order = jnp.lexsort((d, t))
    return t[order], u[order], d[order]


@jax.jit
def _splice_seeds(prev_pool, seeds_all, n_prev, sentinel):
    """Row r < n_prev keeps its carried pool row; later rows get their
    ef=1 descent seed (sentinel-padded). Shapes static; split dynamic."""
    ef = prev_pool.shape[1]
    pad_cols = ef - seeds_all.shape[1]
    padded = jnp.concatenate(
        [seeds_all, jnp.full((seeds_all.shape[0], pad_cols), sentinel, jnp.int32)],
        axis=1,
    )
    rows = jax.lax.broadcasted_iota(jnp.int32, prev_pool.shape, 0)
    return jnp.where(rows < n_prev, prev_pool, padded)


def _prefix_bucket(B: int, m: int, level: int, bp: int) -> int:
    """Static pad size for the level-``level`` prefix of a wave of B.

    Expectation-based so it is identical across waves (one compile);
    falls back to next_pow2(bp) in the (vanishingly rare) case the draw
    exceeds 3x expectation.
    """
    exp = max(1, int(B * (float(m) ** -level) * 3) + 8)
    bucket = min(B, next_pow2(exp))
    if bp > bucket:
        bucket = min(B, next_pow2(bp))
    return bucket


def insert_wave(
    g: G.HnswGraph,
    cfg: HnswConfig,
    vecs: jax.Array,  # [B, d] wave vectors (padded rows arbitrary)
    ids_np: np.ndarray,  # [B] int32, sentinel for padding rows
    levels_np: np.ndarray,  # [B] int32, wave sorted by level DESC
    slots_np: np.ndarray,  # [B] int32 upper-table slots (cap_u for level 0)
    n_valid: int,
    entry: int,
    entry_level: int,
) -> G.HnswGraph:
    """Insert one wave. Caller guarantees: wave sorted by level descending,
    vectors normalized/cast, entry >= 0, slots pre-allocated host-side."""
    metric = cfg.metric
    efc = cfg.ef_construction
    E = cfg.build_expand_per_step
    sent = g.sentinel
    B = vecs.shape[0]

    ids = jnp.asarray(ids_np, jnp.int32)
    levels = jnp.asarray(levels_np, jnp.int32)
    slots = jnp.asarray(slots_np, jnp.int32)
    g = _set_wave(g, ids, vecs, levels, slots)

    q_all = vecs.astype(g.vectors.dtype)
    seeds_all = jnp.full((B, 1), entry, dtype=jnp.int32)
    prev_pool = None  # [*, efc] pool of the previous (higher) level
    bp_prev = 0  # true (unpadded) previous prefix count

    for lc in range(entry_level, 0, -1):
        bp = int((levels_np >= lc).sum())  # prefix rows searching this level
        if bp > 0:
            bp_pad = _prefix_bucket(B, cfg.m, lc, bp)
            # seeds: previous pool rows for the old prefix, descent seeds for
            # rows that join the prefix at this level (dynamic split index
            # so every wave reuses one compiled program)
            if prev_pool is None:
                seeds = jnp.pad(
                    seeds_all[:bp_pad],
                    ((0, 0), (0, efc - 1)),
                    constant_values=sent,
                )
            else:
                pp = prev_pool[:bp_pad]
                if pp.shape[0] < bp_pad:
                    pp = jnp.pad(
                        pp, ((0, bp_pad - pp.shape[0]), (0, 0)),
                        constant_values=sent,
                    )
                seeds = _splice_seeds(
                    pp, seeds_all[:bp_pad], jnp.int32(bp_prev), jnp.int32(sent)
                )
            pool_d, pool_i = search_layer(
                g, q_all[:bp_pad], seeds, jnp.int32(lc),
                level0=False, ef=efc, expand=E, metric=metric,
            )
            pool_d, pool_i = _mask_pool(
                pool_d, pool_i, jnp.int32(min(bp, n_valid)), sent
            )
            sel_pool_d, sel_pool_i = pool_d, pool_i
            if cfg.link_within_wave and bp > 1:
                wv, wi = _wave_link_candidates(
                    q_all[:bp_pad], ids[:bp_pad],
                    jnp.int32(min(bp, n_valid)), sent,
                    w=min(cfg.m, bp_pad), metric=metric,
                )
                sel_pool_d = jnp.concatenate([pool_d, wv], axis=1)
                sel_pool_i = jnp.concatenate([pool_i, wi], axis=1)
            sel_ids, sel_dists = S.select_neighbors(
                g, sel_pool_i, sel_pool_d, lm=cfg.m, metric=metric
            )
            g = _write_own_lists(
                g, ids[:bp_pad], slots[:bp_pad], sel_ids, jnp.int32(lc),
                level0=False,
            )
            t, u, d = _sorted_updates(sel_ids, sel_dists, ids[:bp_pad])
            g = _reciprocal_update(
                g, t, u, d, jnp.int32(lc), level0=False, lm=cfg.m, metric=metric
            )
            prev_pool, bp_prev = pool_i, min(bp, n_valid)
        # greedy descent for every row (prefix rows' results are unused)
        _, seeds_all = search_layer(
            g, q_all, seeds_all, jnp.int32(lc),
            level0=False, ef=1, expand=1, max_steps=128, metric=metric,
        )

    # level 0: the whole wave
    if prev_pool is None:
        seeds0 = jnp.pad(seeds_all, ((0, 0), (0, efc - 1)), constant_values=sent)
    else:
        pp = prev_pool
        if pp.shape[0] < B:
            pp = jnp.pad(
                pp, ((0, B - pp.shape[0]), (0, 0)), constant_values=sent
            )
        seeds0 = _splice_seeds(pp, seeds_all, jnp.int32(bp_prev), jnp.int32(sent))
    pool_d, pool_i = search_layer(
        g, q_all, seeds0, jnp.int32(0), level0=True, ef=efc, expand=E,
        metric=metric,
    )
    pool_d, pool_i = _mask_pool(pool_d, pool_i, jnp.int32(n_valid), sent)
    if cfg.link_within_wave and n_valid > 1:
        wv, wi = _wave_link_candidates(
            q_all, ids, jnp.int32(n_valid), sent,
            w=min(cfg.m, B), metric=metric,
        )
        pool_d = jnp.concatenate([pool_d, wv], axis=1)
        pool_i = jnp.concatenate([pool_i, wi], axis=1)
    sel_ids, sel_dists = S.select_neighbors(
        g, pool_i, pool_d, lm=cfg.m0, metric=metric
    )
    g = _write_own_lists(g, ids, slots, sel_ids, jnp.int32(0), level0=True)
    t, u, d = _sorted_updates(sel_ids, sel_dists, ids)
    g = _reciprocal_update(
        g, t, u, d, jnp.int32(0), level0=True, lm=cfg.m0, metric=metric
    )
    return g
