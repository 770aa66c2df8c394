"""Planner (hnswcostestimate analogue) — model arithmetic + data gating.

Reference behavior: pgvector's hnswcostestimate (pgvector:src/hnsw.c)
lets the Postgres planner choose index scan vs sequential scan. Here
the same decision spans three engines, priced on a hardware model, plus
a data-structure gate the upstream planner cannot express. The tests
pass an explicit HardwareModel, so they check the planner's logic and
not the constants measured on any one machine.
"""

import numpy as np
import pytest

pytestmark = pytest.mark.smoke

from tpu_hnsw.io.datasets import synthetic_clustered, synthetic_uniform
from tpu_hnsw.planner import (STRUCTURE_MIN, EnginePlan, HardwareModel,
                              choose_engine, cluster_structure_score,
                              estimate_block_qps, estimate_flat_qps,
                              estimate_graph_qps)

# a fixed model for the logic tests: round numbers under which the block
# engine wins at 1M x 128 and the flat scan wins tiny corpora
HW = HardwareModel(gather_rows_per_s=1e8, f32_macs_per_s=2e13,
                   expand_bytes_per_s=1e11, dispatch_s=1e-3,
                   step_overhead_s=5e-3)


def _estimate(engine: str, hw: HardwareModel) -> float:
    n, d, b = 1_000_000, 128, 4096
    if engine == "flat":
        return estimate_flat_qps(n, d, batch=b, hw=hw)
    if engine == "block":
        return estimate_block_qps(n, d, probes=8, block_size=256, batch=b,
                                  rerank=32, hw=hw)
    return estimate_graph_qps(n, d, m=16, expand=4, steps=7, seeds=8,
                              batch=b, hw=hw)


class TestCostModel:
    def test_flat_cost_linear_in_n(self):
        q1 = estimate_flat_qps(100_000, 128, hw=HW)
        q2 = estimate_flat_qps(1_000_000, 128, hw=HW)
        assert q1 > q2
        # asymptotically linear: 10x rows ~ <=10x slower, >5x slower
        assert 5 < q1 / q2 <= 10.5

    @pytest.mark.parametrize("engine", ["flat", "block", "graph"])
    def test_estimators_follow_the_hardware_model(self, engine):
        """Each estimator is the model's own arithmetic: batch over the
        time its stages take at the model's rates, plus fixed costs."""
        n, d, b = 1_000_000, 128, 4096
        if engine == "flat":
            t = b * 2 * n * d / HW.f32_macs_per_s + HW.dispatch_s
        elif engine == "block":
            t = (b * 2 * (-(-n // 256)) * d / HW.f32_macs_per_s
                 + b * 8 * 256 * d * 2 / HW.expand_bytes_per_s
                 + b * 2 * 32 * d * 2 / HW.f32_macs_per_s + HW.dispatch_s)
        else:
            t = (b * (4 * 2 * 16 * 7 + 8) / HW.gather_rows_per_s
                 + 7 * HW.step_overhead_s
                 + b * 2 * (n // 16) * d / HW.f32_macs_per_s
                 + 2 * HW.dispatch_s)
        assert _estimate(engine, HW) == pytest.approx(b / t, rel=1e-12)
        # a machine twice as fast in every rate and fixed cost serves
        # twice the queries
        fast = HardwareModel(
            gather_rows_per_s=2 * HW.gather_rows_per_s,
            f32_macs_per_s=2 * HW.f32_macs_per_s,
            expand_bytes_per_s=2 * HW.expand_bytes_per_s,
            dispatch_s=HW.dispatch_s / 2,
            step_overhead_s=HW.step_overhead_s / 2)
        assert _estimate(engine, fast) == pytest.approx(
            2 * _estimate(engine, HW), rel=1e-12)

    def test_flat_wins_tiny_corpora(self):
        # at 1k rows the flat scan is dispatch-bound and nearly free,
        # while block expansion still pays its gather intermediate —
        # the planner must pick the exact scan
        flat = estimate_flat_qps(1_000, 128, hw=HW)
        block = estimate_block_qps(1_000, 128, hw=HW)
        assert flat > 2 * block
        plan = choose_engine(1_000, 128, hw=HW)
        assert plan.engine == "flat"


def test_calibrate_measures_all_five_constants():
    """calibrate() runs its probes at tiny shapes and returns a model
    whose every constant is a positive, finite measurement the planner
    can price with."""
    import dataclasses

    from tpu_hnsw.planner import calibrate

    hw = calibrate(n=4096, dim=16, batch=32)
    vals = dataclasses.asdict(hw)
    assert set(vals) == {f.name for f in dataclasses.fields(HardwareModel)}
    assert all(np.isfinite(v) and v > 0 for v in vals.values()), vals
    assert choose_engine(1_000_000, 16, hw=hw).est_qps > 0


class TestStructureScore:
    def test_clustered_beats_uniform(self):
        xc, _ = synthetic_clustered(4096, 64, n_queries=1, seed=0)
        xu, _ = synthetic_uniform(4096, 64, n_queries=1, seed=0)
        sc = cluster_structure_score(xc)
        su = cluster_structure_score(xu)
        assert sc > su
        # the gate separates them (the planner's refusal threshold)
        assert sc >= STRUCTURE_MIN > su

    def test_rejects_tiny_samples(self):
        with pytest.raises(ValueError):
            cluster_structure_score(np.zeros((8, 4), np.float32))


class TestChooseEngine:
    def test_block_engine_for_large_clustered(self):
        xc, _ = synthetic_clustered(4096, 64, n_queries=1, seed=0)
        plan = choose_engine(1_000_000, 128, sample=xc, hw=HW)
        assert isinstance(plan, EnginePlan)
        assert plan.engine == "block"
        assert plan.params["probes"] >= 1

    def test_flat_forced_on_uniform_data(self):
        xu, _ = synthetic_uniform(4096, 64, n_queries=1, seed=0)
        plan = choose_engine(1_000_000, 128, sample=xu, hw=HW)
        assert plan.engine == "flat"
        assert plan.exact
        assert "refused" in plan.reason

    def test_exact_recall_request_gets_flat(self):
        plan = choose_engine(1_000_000, 128, recall_target=1.0, hw=HW)
        assert plan.engine == "flat"

    def test_no_sample_assumes_clustered(self):
        plan = choose_engine(1_000_000, 128, hw=HW)
        assert plan.engine == "block"
