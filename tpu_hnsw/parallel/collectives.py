"""Top-k merge collectives for partitioned search (SURVEY §5 comm backend).

The reference has no network backend (single-node shared memory); the
replacement here is XLA collectives over the device mesh (NCCL on
GPUs). Three
merge strategies, all usable inside ``shard_map``:

- :func:`gather_merge_topk` — one ``all_gather`` + local top-k. Minimum
  latency; every device receives P*k rows. The default (config E's
  merge).
- :func:`ring_merge_topk` — P-1 ``ppermute`` steps forwarding each
  device's original top-k around the ring, merging incrementally. Same
  total receive volume, but the peak live buffer is 2k rows instead of
  P*k and each step's message is k rows — the choice when P*k is large
  enough that the all_gather buffer (or its single bisection burst)
  matters.
- :func:`hierarchical_merge_topk` — two-level merge for multi-host
  deployments: merge over the intra-host axis (NVLink) first, then over
  the cross-host axis (network) — only k survivors per device cross the
  slower link, the bandwidth-optimal layout for config E at 100M+
  scale.

Distances must be ascending-comparable (operator units are, for every
metric); ids ride along.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tpu_hnsw.ops import topk as T


def gather_merge_topk(d, i, k: int, axis: str, dedup: bool = False):
    """all_gather over ``axis`` + local top-k. d/i: [Q, c] per device.
    ``dedup`` drops duplicate ids before the top-k (multi-assigned
    replicas arrive from two shards with identical distances)."""
    q = d.shape[0]
    d_all = jnp.moveaxis(jax.lax.all_gather(d, axis), 0, 1).reshape(q, -1)
    i_all = jnp.moveaxis(jax.lax.all_gather(i, axis), 0, 1).reshape(q, -1)
    if dedup:
        d_all = T.mask_duplicate_ids(d_all, i_all)
    vals, sel = T.topk_smallest(d_all, k)
    ids = jnp.take_along_axis(i_all, sel, axis=1)
    if dedup:
        ids = jnp.where(jnp.isfinite(vals), ids, -1)
    return vals, ids


def ring_merge_topk(d, i, k: int, axis: str, dedup: bool = False):
    """Ring merge: every device ends with the global top-k.

    Each step forwards the lists received in the previous step (starting
    with the device's own), so after P-1 steps every device has merged
    every other device's ORIGINAL candidates exactly once — no
    duplicates, bit-identical to the all_gather merge.
    """
    n = jax.lax.axis_size(axis)
    perm = [(s, (s + 1) % n) for s in range(n)]
    vals, sel = T.topk_smallest(d, min(k, d.shape[1]))
    acc_d = vals
    acc_i = jnp.take_along_axis(i, sel, axis=1)
    send_d, send_i = d, i
    for _ in range(n - 1):
        send_d = jax.lax.ppermute(send_d, axis, perm)
        send_i = jax.lax.ppermute(send_i, axis, perm)
        md = jnp.concatenate([acc_d, send_d], axis=1)
        mi = jnp.concatenate([acc_i, send_i], axis=1)
        if dedup:
            md = T.mask_duplicate_ids(md, mi)
        acc_d, sel = T.topk_smallest(md, k)
        acc_i = jnp.take_along_axis(mi, sel, axis=1)
        if dedup:
            acc_i = jnp.where(jnp.isfinite(acc_d), acc_i, -1)
    return acc_d, acc_i


def hierarchical_merge_topk(d, i, k: int, intra_axis: str, inter_axis: str,
                            dedup: bool = False):
    """Two-level merge: within a host first, then across hosts.

    Equivalent to a flat merge over both axes (top-k is associative);
    only k rows per device cross ``inter_axis``.
    """
    d, i = gather_merge_topk(d, i, k, intra_axis, dedup=dedup)
    return gather_merge_topk(d, i, k, inter_axis, dedup=dedup)
