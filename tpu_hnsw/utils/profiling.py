"""Profiling hooks — the EXPLAIN ANALYZE / pg_stat analogue (SURVEY §5).

The reference's observability is host machinery (EXPLAIN ANALYZE buffer
hits, pg_stat_progress_create_index); the device equivalents are
``jax.profiler`` device traces (TensorBoard/Perfetto) plus
``jax.named_scope`` annotations inside the jitted programs so trace
timelines carry index-semantics names ("route", "expand", "descend",
"beam") instead of raw HLO fusions.

Usage::

    from tpu_hnsw.utils.profiling import trace
    with trace("/tmp/tpu_hnsw_trace"):
        idx.search(queries, k=10)
    # then: tensorboard --logdir /tmp/tpu_hnsw_trace  (or open in Perfetto)
"""

from __future__ import annotations

import contextlib

import jax


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a device trace of the enclosed block (jax.profiler.trace).

    Works on GPU and CPU backends; writes a TensorBoard/Perfetto
    trace directory. Block until ready inside the region or the trailing
    async work lands outside the capture.
    """
    with jax.profiler.trace(logdir):
        yield


def annotate(name: str):
    """Name a region inside traced/jitted code (jax.named_scope): the
    pgstat progress-phase analogue, visible in profiler timelines."""
    return jax.named_scope(name)
