"""Benchmark sweep (the reference's runBenchmark, src/test.cu:4-41).

Canonical sweep: mobility steps 10,20,..,100,200,..,1000 x schedulers, with
init_n=1e6, capacity=5e7, 10 Poisson steps; output CSV has the reference's
schema so its analyse/ scripts apply unchanged.  The block-size axis is
replaced by the scheduler engines themselves (every row runs at the default
block size); a ``quick`` profile keeps CI runs tractable.

Honest-timing protocol:
  * ``poisson_timestep`` is a traced scalar, so one compilation per
    (scheduler, capacity-bucket) serves every T — each config is preceded by
    a 1-Poisson-step warm run at its own T so the recorded time never
    includes compilation;
  * rows are appended to the CSV as they complete, so a long sweep that is
    interrupted still leaves a valid artifact.
"""

from __future__ import annotations

import json
import os
import time
from typing import List, Optional

from .config import SimConfig
from .observability import CSV_HEADER
from .runtime import RunData, run_pic, run_pic_device


def sweep_configs(profile: str = "full") -> List[SimConfig]:
    if profile == "ci":
        mobility = [4, 8]
        init_n, capacity, poisson_steps = 200, 4000, 2
        grid = (16, 16, 16)
        schedulers = ["naive", "sync"]
    elif profile == "quick":
        mobility = [10, 50, 100]
        init_n, capacity, poisson_steps = 100_000, 2_000_000, 3
        grid = (128, 128, 128)
        schedulers = ["naive", "dynamic"]
    else:
        mobility = list(range(10, 100, 10)) + list(range(100, 1001, 100))
        init_n, capacity, poisson_steps = 1_000_000, 50_000_000, 10
        grid = (512, 512, 512)
        # fastest engines first so a time-budget truncation still leaves the
        # headline comparison (Dynamic flat vs Naive linear) complete; the
        # sync oracle's generation fixed point re-simulates ranges and is by
        # far the slowest at large T
        schedulers = ["dynamic", "naive", "sync"]

    configs = []
    for sched in schedulers:          # scheduler-major: warm compile reused
        for mob in mobility:
            configs.append(
                SimConfig(
                    init_n=init_n,
                    capacity=capacity,
                    poisson_steps=poisson_steps,
                    poisson_timestep=mob,
                    scheduler=sched,
                    grid_size=grid,
                    # canonical-artifact provenance: the sweep's physics
                    # (final n, cross-engine multiset equality) is pinned to
                    # the per-step draw protocol regardless of what the
                    # session default becomes (config.py rng_mode notes) —
                    # recorded rows stay mutually consistent across rounds
                    rng_mode="perstep",
                    rng_rounds=13,
                )
            )
    return configs


def _append_csv(path: str, run: RunData) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    new = not os.path.exists(path)
    with open(path, "a") as f:
        if new:
            f.write(CSV_HEADER + "\n")
        c = run.config
        # split chance column: dead field in the reference too (SURVEY.md §5.5)
        f.write(
            f"{run.function},{c.init_n},{c.poisson_steps},{c.poisson_timestep},"
            f"{c.block_size},{c.sleep_time_ns},0,{run.final_n},"
            f"{run.device_time_ms}\n"
        )


def _recorded_rows(out_csv: str):
    """(func, mobility steps) -> [time_ms, ...] for rows already in the CSV
    (a list per key: repeat_map rows legitimately appear several times, and
    a resumed sweep must know HOW MANY reps landed, not just that one did)."""
    done = {}
    if os.path.exists(out_csv):
        with open(out_csv) as f:
            for line in f.readlines()[1:]:
                parts = line.strip().split(",")
                if len(parts) >= 9:
                    done.setdefault(
                        (parts[0], int(parts[3])), []
                    ).append(float(parts[8]))
    return done


_FUNC_NAME = {"dynamic": "Dynamic", "sync": "CPU Sync", "naive": "Naive"}


def _load_hints(path: str) -> dict:
    if path and os.path.exists(path):
        try:
            with open(path) as f:
                return {k: int(v) for k, v in json.load(f).items()}
        except (ValueError, OSError):
            return {}
    return {}


def _save_hints(path: str, hints: dict) -> None:
    if path:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(hints, f)


_DEFAULT_CSV = "out/data/mobility_timesteps_nodet.csv"
_DEFAULT_HINTS = "out/data/sweep_hints.json"
_DEFAULT_POISON = "out/data/sweep_poison.json"


def run_benchmark(
    profile: str = "full",
    out_csv: str = _DEFAULT_CSV,
    time_budget_s: Optional[float] = None,
    resume: bool = False,
    only_schedulers: Optional[List[str]] = None,
    repeat_map: Optional[dict] = None,
    max_t: Optional[dict] = None,
    hints_path: Optional[str] = _DEFAULT_HINTS,
    poison_path: Optional[str] = _DEFAULT_POISON,
    poison_limit: int = 3,
) -> List[RunData]:
    """Run the sweep, appending each row to ``out_csv`` as it completes.

    ``resume=True`` keeps an existing CSV and skips configs already recorded
    (an interrupted canonical sweep continues where it left off); otherwise
    an existing CSV is moved to ``.bak`` and the sweep starts fresh.

    ``repeat_map`` maps (scheduler, T) -> total measurement count; extra
    measurements append DUPLICATE rows, which is exactly how the reference
    feeds seaborn's error bands (analyse/plot.py:36 aggregates repeated
    config rows).  ``max_t`` maps scheduler -> highest T to record (the
    sync oracle's generation fixed point is quadratic-ish in T at canonical
    scale; reference's Naive is likewise capped by shared memory,
    src/test.cu:23).

    Outlier protection: a measurement more than 5x above any same-scheduler
    time already recorded (and over 30 s) is re-measured once and the retry
    recorded — a stray recompile otherwise pollutes the artifact.
    """
    done = {}
    if resume:
        done = _recorded_rows(out_csv)
    elif os.path.exists(out_csv):
        os.rename(out_csv, out_csv + ".bak")
    runs: List[RunData] = []
    t_start = time.perf_counter()
    warmed = set()
    # per-scheduler bucket hysteresis carried ACROSS runs AND processes
    # (hints_path JSON): without it every T>=200 canonical point re-climbs
    # the capacity ladder (one discarded run per rung — ~6 wasted runs per
    # point at the avalanche configs), and every crash-retry process pays
    # the full climb again.
    hints: dict = _load_hints(hints_path) if resume else {}
    # poison-row ledger: a row's attempt count is bumped BEFORE it runs and
    # cleared after it records, so a row that keeps crashing the process is
    # SKIPPED after ``poison_limit`` tries instead of deadlocking every
    # resumed pass on the same config.
    poison: dict = _load_hints(poison_path) if resume else {}
    for cfg in sweep_configs(profile):
        if only_schedulers and cfg.scheduler not in only_schedulers:
            continue
        if max_t and cfg.poisson_timestep > max_t.get(cfg.scheduler, 10**9):
            continue
        reps_want = (repeat_map or {}).get(
            (cfg.scheduler, cfg.poisson_timestep), 1
        )
        reps_have = len(
            done.get((_FUNC_NAME[cfg.scheduler], cfg.poisson_timestep), ())
        )
        if reps_have >= reps_want:
            continue
        poison_key = f"{cfg.scheduler}|{cfg.poisson_timestep}"
        if poison.get(poison_key, 0) >= poison_limit:
            print(f"skipping poisoned row {poison_key} "
                  f"({poison[poison_key]} crashed attempts)", flush=True)
            continue
        if time_budget_s and time.perf_counter() - t_start > time_budget_s:
            print(f"time budget {time_budget_s}s reached — sweep truncated")
            break
        # Long rows run in bounded dispatches: one Poisson step per
        # dispatch for sync and for the XLA cadences' long tails, naive's
        # T-loop split into 20-step spans and sync's generations into
        # 25-step spans (all bit-exact, ops/step.py), and a per-step
        # snapshot (run_pic_device row_ckpt) so an interrupted row resumes
        # instead of restarting.
        long_tail = cfg.scheduler != "dynamic" and cfg.poisson_timestep >= 300
        chunk = 1 if (cfg.scheduler == "sync" or long_tail) else 2
        nchunk = 20 if long_tail and cfg.scheduler == "naive" else 0
        sspan = (
            25
            if cfg.scheduler == "sync" and cfg.poisson_timestep >= 200
            else 0
        )
        row_ckpt = None
        if (
            long_tail
            or (cfg.scheduler == "sync" and cfg.poisson_timestep >= 200)
        ) and reps_want == 1:
            row_ckpt = os.path.join(
                os.path.dirname(out_csv) or ".",
                f"row_ckpt_{cfg.scheduler}_{cfg.poisson_timestep}.npz",
            )
        # warm: compile + enter the churn regime once per scheduler (T is a
        # traced scalar, so the compilation is shared across all T points)
        if cfg.scheduler not in warmed:
            # Warm at T=10 regardless of the config's T: poisson_timestep is
            # a traced scalar so the compilation is identical, and on a
            # resumed sweep the first unrecorded config may be T>=400 — a
            # full-T warm there costs as much as the measurement itself.
            # With the persisted bucket hint the warm also compiles at the
            # avalanche bucket the real runs will use.
            warm = run_pic_device(
                cfg.replace(poisson_timestep=10),
                chunk_steps=chunk,
                w_start=hints.get(cfg.scheduler, 0),
                naive_chunk=nchunk,
                sync_span=sspan,
            )
            warm.state = None
            hints[cfg.scheduler] = max(
                hints.get(cfg.scheduler, 0), warm.last_bucket
            )
            _save_hints(hints_path, hints)
            warmed.add(cfg.scheduler)
        prior = [
            t
            for (f, _), ts in done.items()
            if f == _FUNC_NAME[cfg.scheduler]
            for t in ts
        ] + [r.device_time_ms for r in runs if r.config.scheduler == cfg.scheduler]
        poison[poison_key] = poison.get(poison_key, 0) + 1
        _save_hints(poison_path, poison)
        for rep in range(reps_have, reps_want):
            for attempt in range(2):
                t0 = time.perf_counter()
                run = run_pic_device(
                    cfg, chunk_steps=chunk,
                    w_start=hints.get(cfg.scheduler, 0),
                    naive_chunk=nchunk,
                    sync_span=sspan,
                    row_ckpt=row_ckpt,
                )
                wall = time.perf_counter() - t0
                run.state = None  # 2.4 GB of device memory per held state at 5e7
                hints[cfg.scheduler] = max(
                    hints.get(cfg.scheduler, 0), run.last_bucket
                )
                _save_hints(hints_path, hints)
                suspicious = (
                    prior
                    and run.device_time_ms > 5 * max(prior)
                    and run.device_time_ms > 30_000
                )
                if not suspicious or attempt == 1:
                    break
                print(
                    f"outlier {run.device_time_ms:.0f} ms (prior max "
                    f"{max(prior):.0f} ms) — re-measuring once",
                    flush=True,
                )
            if run.final_n >= cfg.capacity:
                print("Illegal configuration, capacity reached — skipping record")
                break
            pushes = estimate_pushes(run)
            print(
                f"{cfg.scheduler:12s} T={cfg.poisson_timestep:5d} "
                f"rep={rep} final_n={run.final_n:9d} "
                f"device={run.device_time_ms:9.1f} ms wall={wall:6.1f} s "
                f"pushes/s={pushes / max(run.device_time_ms / 1e3, 1e-9):.3e}",
                flush=True,
            )
            runs.append(run)
            _append_csv(out_csv, run)
        poison.pop(poison_key, None)
        _save_hints(poison_path, poison)
    return runs


def estimate_pushes(run: RunData) -> float:
    """Total particle-pushes executed — exact, counted by the engines
    (StepMetrics.pushes, base-2^30 i32 pairs summed in f64)."""
    return sum(m.pushes for m in run.steps)
