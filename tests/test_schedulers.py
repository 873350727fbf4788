"""Scheduler-equivalence: the framework's counterpart of the reference's
runUnitTest (src/test.cu:43-101) — every cadence must produce the exact same
sorted final particle multiset, because physics is keyed by genealogy, not
execution order."""

import numpy as np
import pytest

from particle_simulation_tpu import SimConfig
from particle_simulation_tpu.cross_section import bundled_paths
from particle_simulation_tpu.runtime import run_pic, sorted_particle_array
from particle_simulation_tpu.testing import run_unit_test

CFG = SimConfig(
    init_n=150,
    capacity=20_000,
    poisson_steps=3,
    poisson_timestep=6,
    grid_size=(32, 32, 32),
    cross_section_path=bundled_paths()[1],  # constant 50/50 -> heavy churn
)


@pytest.mark.parametrize("sched", ["naive", "dynamic"])
def test_cadence_equivalence(sched):
    base = run_pic(CFG.replace(scheduler="sync"), print_header=False)
    other = run_pic(CFG.replace(scheduler=sched), print_header=False)
    assert base.final_n == other.final_n
    np.testing.assert_array_equal(
        sorted_particle_array(base.state), sorted_particle_array(other.state)
    )


def test_run_unit_test_harness():
    ok = run_unit_test(
        CFG.replace(poisson_steps=2), schedulers=["naive", "dynamic"]
    )
    assert ok


def test_growth_accounting():
    """added/removed metrics are self-consistent with population sizes."""
    run = run_pic(CFG, print_header=False)
    n = CFG.init_n
    for m in run.steps:
        n = n + m.added - m.removed
        assert n == m.n
    assert run.final_n == n


def test_deterministic_across_runs():
    a = run_pic(CFG, print_header=False)
    b = run_pic(CFG, print_header=False)
    assert a.final_n == b.final_n
    np.testing.assert_array_equal(
        sorted_particle_array(a.state), sorted_particle_array(b.state)
    )


@pytest.mark.slow
def test_push_counts_identical_across_cadences():
    """Every cadence executes the exact same multiset of particle-steps, so
    the engines' counted pushes must agree exactly."""
    runs = {
        s: run_pic(CFG.replace(scheduler=s), print_header=False)
        for s in ("naive", "sync", "dynamic")
    }
    counts = {s: [m.pushes for m in r.steps] for s, r in runs.items()}
    assert counts["naive"] == counts["sync"] == counts["dynamic"]
    assert sum(counts["naive"]) > 0
