"""Flat device-array HNSW graph storage.

Device-array replacement of the reference's page-based index layout
(upstream ``pgvector:src/hnsw.h`` metapage / ``HnswElementTuple`` /
``HnswNeighborTuple`` packed into 8KB Postgres pages, (de)serialized by
``hnswutils.c``): the whole graph lives in device memory as a handful of flat,
statically-shaped arrays, so every graph access in the hot path is a
batched gather instead of a buffer-manager page read.

Layout (SURVEY.md §1.3 L3):

- ``vectors      [cap+1, d]``      vector table (row ``cap`` is an all-zero
                                   trash row so the sentinel id ``cap`` can
                                   be gathered unconditionally)
- ``neighbors0   [cap+1, 2m]``     level-0 adjacency (degree cap 2m,
                                   upstream ``HnswGetLayerM``)
- ``upper_nbrs   [cap_u+1, L, m]`` packed adjacency for levels 1..L for the
                                   ~n/m elements with level >= 1
- ``upper_slot   [cap+1]``         element id -> row in ``upper_nbrs``
                                   (``cap_u`` = trash slot)
- ``levels       [cap+1]``         per-element max level
- ``deleted      [cap+1]``         tombstones (vacuum analogue)

Scalars (count, entry point, entry level) are host-side state on
:class:`~tpu_hnsw.index.hnsw.HnswIndex`, mirroring the metapage.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from tpu_hnsw.config import HnswConfig


class HnswGraph(NamedTuple):
    """Pytree of device arrays holding the full index state."""

    vectors: jax.Array  # [cap+1, d] storage dtype
    vectors_sq: jax.Array  # [cap+1] f32 squared norms (L2 matmul form)
    neighbors0: jax.Array  # [cap+1, 2m] int32, sentinel = cap
    upper_nbrs: jax.Array  # [cap_u+1, max_level, m] int32, sentinel = cap
    upper_slot: jax.Array  # [cap+1] int32, sentinel slot = cap_u
    levels: jax.Array  # [cap+1] int32
    deleted: jax.Array  # [cap+1] bool

    @property
    def cap(self) -> int:
        return self.vectors.shape[0] - 1

    @property
    def cap_upper(self) -> int:
        return self.upper_nbrs.shape[0] - 1

    @property
    def dim(self) -> int:
        return self.vectors.shape[1]

    @property
    def sentinel(self) -> int:
        return self.cap


def upper_capacity(cap: int, m: int) -> int:
    """Capacity of the packed upper-level table.

    #elements with level>=1 is Binomial(cap, 1/m): mean cap/m, std
    ~sqrt(cap/m). The 1.25x + 256 margin is >60 std out at 1M rows —
    overflow probability is negligible, and the insert paths raise
    cleanly if it ever happens. (A 3x margin here cost ~60B/element at
    the d=128/m=16 reference shape, a fifth of pgvector's entire
    footprint, for no benefit.)
    """
    return cap // m + cap // (4 * m) + 256


def init_graph(config: HnswConfig, cap: int) -> HnswGraph:
    d = config.dim
    dtype = jnp.bfloat16 if config.dtype == "bfloat16" else jnp.float32
    cap_u = upper_capacity(cap, config.m)
    sent = jnp.int32(cap)
    return HnswGraph(
        vectors=jnp.zeros((cap + 1, d), dtype=dtype),
        vectors_sq=jnp.zeros((cap + 1,), dtype=jnp.float32),
        neighbors0=jnp.full((cap + 1, config.m0), sent, dtype=jnp.int32),
        upper_nbrs=jnp.full(
            (cap_u + 1, config.max_level, config.m), sent, dtype=jnp.int32
        ),
        upper_slot=jnp.full((cap + 1,), cap_u, dtype=jnp.int32),
        levels=jnp.zeros((cap + 1,), dtype=jnp.int32),
        deleted=jnp.zeros((cap + 1,), dtype=jnp.bool_),
    )


def neighbor_rows(g: HnswGraph, ids: jax.Array, level: int) -> jax.Array:
    """Adjacency rows for a batch of element ids at a (static) level.

    The batched-gather replacement for the reference's per-hop neighbor
    page read (``HnswLoadElement`` / buffer reads in ``HnswSearchLayer``).
    ids: ``[...]`` int32 -> ``[..., deg]`` int32.
    """
    if level == 0:
        return jnp.take(g.neighbors0, ids, axis=0, mode="clip")
    slots = jnp.take(g.upper_slot, ids, axis=0, mode="clip")
    return jnp.take(g.upper_nbrs[:, level - 1, :], slots, axis=0, mode="clip")


def gather_vectors(g: HnswGraph, ids: jax.Array) -> tuple[jax.Array, jax.Array]:
    """(vectors, squared_norms) for a batch of ids (sentinel -> zero row)."""
    v = jnp.take(g.vectors, ids, axis=0, mode="clip")
    v_sq = jnp.take(g.vectors_sq, ids, axis=0, mode="clip")
    return v, v_sq


def gather_rows(table: jax.Array, ids: jax.Array) -> jax.Array:
    """Row gather from a raw table with clip semantics."""
    return jnp.take(table, ids, axis=0, mode="clip")


def graph_degree(config: HnswConfig, level: int) -> int:
    return config.m0 if level == 0 else config.m


def from_ref(ref, config: HnswConfig, cap: int | None = None) -> tuple[HnswGraph, int, int]:
    """Load a RefHnsw oracle graph into device arrays (tests only).

    Returns (graph, n, n_upper).
    """
    import jax.numpy as jnp

    n = len(ref.vectors)
    cap = cap or n
    g = init_graph(config, cap)
    sent = cap
    vecs = np.asarray(ref.vectors, dtype=np.float32)
    nbr0 = np.full((n, config.m0), sent, np.int32)
    levels = np.asarray(ref.levels, np.int32)
    slot_of = np.full(n, g.cap_upper, np.int32)
    n_upper = 0
    upper = np.array(g.upper_nbrs)  # writable copy
    for i in range(n):
        row = ref.neighbors[i][0]
        nbr0[i, : len(row)] = row
        if levels[i] >= 1:
            slot_of[i] = n_upper
            for l in range(1, levels[i] + 1):
                row = ref.neighbors[i][l]
                upper[n_upper, l - 1, : len(row)] = row
            n_upper += 1
    vecs_d = jnp.asarray(
        np.concatenate([vecs, np.zeros((cap + 1 - n, vecs.shape[1]), np.float32)])
    ).astype(g.vectors.dtype)
    g = g._replace(
        vectors=vecs_d,
        vectors_sq=jnp.sum(
            vecs_d.astype(jnp.float32) * vecs_d.astype(jnp.float32), axis=-1
        ),
        neighbors0=g.neighbors0.at[:n].set(jnp.asarray(nbr0)),
        upper_nbrs=jnp.asarray(upper),
        upper_slot=g.upper_slot.at[:n].set(jnp.asarray(slot_of)),
        levels=g.levels.at[:n].set(jnp.asarray(levels)),
    )
    return g, n, n_upper


def to_ref_lists(g: HnswGraph, n: int, n_upper: int) -> list[list[list[int]]]:
    """Export adjacency as python lists (tests: compare vs RefHnsw)."""
    cap = g.cap
    nbr0 = np.asarray(g.neighbors0[:n])
    levels = np.asarray(g.levels[:n])
    slots = np.asarray(g.upper_slot[:n])
    upper = np.asarray(g.upper_nbrs)
    out = []
    for i in range(n):
        per_level = [[int(x) for x in nbr0[i] if x != cap]]
        for l in range(1, int(levels[i]) + 1):
            row = upper[slots[i], l - 1]
            per_level.append([int(x) for x in row if x != cap])
        out.append(per_level)
    return out
