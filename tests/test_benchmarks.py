"""Benchmark sweep harness (reference runBenchmark, src/test.cu:4-41)."""

import os

from particle_simulation_tpu.benchmarks import estimate_pushes, run_benchmark, sweep_configs
from particle_simulation_tpu.observability import CSV_HEADER


def test_sweep_config_matrix():
    full = sweep_configs("full")
    # reference: mobility steps 10..90 by 10, 100..1000 by 100 -> 19 values
    ts = sorted({c.poisson_timestep for c in full})
    assert ts[0] == 10 and ts[-1] == 1000 and len(ts) == 19
    assert {c.scheduler for c in full} == {"dynamic", "sync", "naive"}
    assert all(c.init_n == 1_000_000 and c.capacity == 50_000_000 for c in full)


def test_ci_sweep_end_to_end(tmp_path):
    out = str(tmp_path / "sweep.csv")
    runs = run_benchmark("ci", out_csv=out)
    assert runs
    lines = open(out).read().strip().split("\n")
    assert lines[0] == CSV_HEADER
    assert len(lines) == len(runs) + 1
    assert all(estimate_pushes(r) > 0 for r in runs)


def test_sweep_resume_fills_only_missing_rows(tmp_path):
    """The crash-recovery contract the canonical artifact depends on: a
    resumed sweep skips recorded rows, refills a truncated CSV to the exact
    uninterrupted row multiset, and repeat_map adds only the missing reps."""
    out = str(tmp_path / "sweep.csv")
    hints = str(tmp_path / "hints.json")
    poison = str(tmp_path / "poison.json")
    kw = dict(out_csv=out, hints_path=hints, poison_path=poison)

    run_benchmark("ci", **kw)
    lines_full = open(out).read().strip().split("\n")

    # resume over a complete CSV records nothing
    again = run_benchmark("ci", resume=True, **kw)
    assert again == []
    assert open(out).read().strip().split("\n") == lines_full

    # simulate a crash: drop the tail half, resume must fill exactly it
    cut = 1 + (len(lines_full) - 1) // 2
    with open(out, "w") as f:
        f.write("\n".join(lines_full[:cut]) + "\n")
    refilled = run_benchmark("ci", resume=True, **kw)
    assert len(refilled) == len(lines_full) - cut
    key = lambda l: (l.split(",")[0], l.split(",")[3])  # (func, T)
    lines_now = open(out).read().strip().split("\n")
    assert sorted(map(key, lines_now[1:])) == sorted(map(key, lines_full[1:]))

    # repeat_map tops up to the requested rep count (error-bar rows)
    run_benchmark("ci", resume=True, repeat_map={("naive", 4): 3}, **kw)
    naive4 = [
        l for l in open(out).read().strip().split("\n")[1:]
        if key(l) == ("Naive", "4")
    ]
    assert len(naive4) == 3
