"""Scheduler-equivalence unit test (the reference's runUnitTest,
src/test.cu:43-101): run every scheduler cadence on the same config, sort
final particles by the reference's comparison key, demand exact equality
against the CPU Sync oracle.

In this framework equivalence is *guaranteed by construction* (genealogy-
keyed RNG, rng.py) — this harness is the regression check that the guarantee
holds across the pure-JAX cadences and the Pallas engine.
"""

from __future__ import annotations

import numpy as np

from .config import SimConfig
from .runtime import run_pic, sorted_particle_array


def run_unit_test(config: SimConfig, schedulers=None) -> bool:
    base_scheduler = "sync"  # the reference's base_function = 1 (CPU Sync)
    if schedulers is None:
        schedulers = ["dynamic", "sync", "naive"]

    base = run_pic(config.replace(scheduler=base_scheduler), print_header=False)
    base_arr = sorted_particle_array(base.state)
    print(f"base ({base_scheduler}): final n = {base.final_n}")

    ok = True
    results = []
    for sched in schedulers:
        run = run_pic(config.replace(scheduler=sched), print_header=False)
        if run.final_n != base.final_n:
            print(
                f"Final n does not match in {sched}. "
                f"Base: {base.final_n}, test: {run.final_n}"
            )
            results.append((sched, False, run.final_n))
            ok = False
            continue
        arr = sorted_particle_array(run.state)
        same = np.array_equal(base_arr, arr)
        if not same:
            bad = np.argwhere(base_arr != arr)
            i = bad[0][0] if len(bad) else -1
            print(f"Mismatch in {sched}! first differing sorted row: {i}")
            print("base:", base_arr[i])
            print("test:", arr[i])
            ok = False
        results.append((sched, same, run.final_n))

    print(f"\nTests done with following results as compared to "
          f"{base_scheduler} ({base.final_n}):")
    for sched, same, n in results:
        print(f"{sched}: {'success' if same else 'failure'} ({n})")
    return ok
