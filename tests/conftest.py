"""Test configuration: force an 8-device virtual CPU mesh.

Mirrors how the reference tests multi-node-ish behavior without external
infrastructure (pgvector TAP tests spin up throwaway local clusters,
SURVEY.md §4): an 8-device mesh is simulated with
``--xla_force_host_platform_device_count=8`` on the CPU backend. The
flag must be in ``XLA_FLAGS`` and the platform pinned before any
backend is initialized.

Suite hygiene (VERDICT r4 #9):

- every test gets a wall-clock timeout (default 600s, override with
  ``TPU_HNSW_TEST_TIMEOUT``; 0 disables) via SIGALRM — a hang in a
  compile turns into a visible failure, not a stuck suite. Best-effort: the alarm fires between Python bytecodes, so a
  hang inside a C call is only reported once it returns.
- ``-m smoke`` selects the fast tier (< 5 min total); see
  tests/README.md for the tier map and the JAX compilation-cache
  segfault workaround for full-suite runs.
"""

import os
import signal

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)
# tests keep the persistent compilation cache off: concurrent cache
# writes from many test programs have crashed XLA's CPU compiler, and
# correctness tests re-compile in memory anyway
os.environ.setdefault("JAX_ENABLE_COMPILATION_CACHE", "false")

import jax
import pytest

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)

_TIMEOUT = int(os.environ.get("TPU_HNSW_TEST_TIMEOUT", "600"))


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    if _TIMEOUT <= 0 or not hasattr(signal, "SIGALRM"):
        yield
        return

    def _alarm(signum, frame):
        raise TimeoutError(
            f"test exceeded {_TIMEOUT}s (TPU_HNSW_TEST_TIMEOUT)")

    old = signal.signal(signal.SIGALRM, _alarm)
    signal.alarm(_TIMEOUT)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
