"""Collision-chance sweep + plot (reference analyse/plot_pic_cc.py).

The reference sweeps constant-chance cross-section tables (its bundled
`cross_section_.txt` stress table is one such point) and plots time vs
collision chance per scheduler, log-log.  Here the sweep itself is included
(the reference generated its pic_cc CSVs with an out-of-tree harness):

    python -m particle_simulation_tpu.analyse.plot_cc [--run] [csv]

--run executes the sweep (writes out/data/pic_cc.csv), then plots to
out/plots/time_vs_cc.png.
"""

from __future__ import annotations

import os
import sys

CC_CSV = "out/data/pic_cc.csv"
CC_HEADER = (
    "func,init n,iterations,mobility steps,block size,sleep time,"
    "collision chance,final n,time"
)


def run_cc_sweep(
    chances=(0.02, 0.1, 0.5, 2.0, 10.0, 50.0),
    schedulers=("dynamic", "sync", "naive"),
    out_csv: str = CC_CSV,
):
    """Run the sweep: constant tables with split = remove = cc/2 (percent),
    so cc is the total per-step collision probability x 100 as in the
    reference's stress table format."""
    import numpy as np

    from .. import cross_section
    from ..config import SimConfig
    from ..runtime import run_pic

    os.makedirs(os.path.dirname(out_csv) or ".", exist_ok=True)
    new = not os.path.exists(out_csv)
    with open(out_csv, "a") as f:
        if new:
            f.write(CC_HEADER + "\n")
        for cc in chances:
            table = np.full((cross_section.N_STEPS, 2), cc / 2, np.float32)
            import jax.numpy as jnp

            table_j = jnp.asarray(table)
            for sched in schedulers:
                cfg = SimConfig(
                    init_n=20_000, capacity=1_000_000, poisson_steps=3,
                    poisson_timestep=20, grid_size=(64, 64, 64),
                    scheduler=sched,
                )
                # warm once per (scheduler, cc) shape; T is traced so the
                # compile is shared — warm only on the first cc
                run = run_pic(
                    cfg.replace(poisson_steps=1), table=table_j,
                    print_header=False, auto_bucket=True,
                )
                run = run_pic(
                    cfg, table=table_j, print_header=False, auto_bucket=True
                )
                f.write(
                    f"{run.function},{cfg.init_n},{cfg.poisson_steps},"
                    f"{cfg.poisson_timestep},{cfg.block_size},"
                    f"{cfg.sleep_time_ns},{cc},{run.final_n},"
                    f"{run.device_time_ms}\n"
                )
                f.flush()
                print(f"cc={cc:6.2f} {sched:12s} final_n={run.final_n:8d} "
                      f"time={run.device_time_ms:9.1f} ms", flush=True)
    return out_csv


def plot(csv_path: str = CC_CSV, out_path: str = "out/plots/time_vs_cc.png"):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import pandas as pd

    df = pd.read_csv(csv_path)
    df.columns = [c.strip() for c in df.columns]
    fig, ax = plt.subplots(figsize=(8, 5))
    for func, grp in df.groupby("func"):
        grp = grp.sort_values("collision chance")
        ax.plot(grp["collision chance"], grp["time"], marker="o", label=func)
    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set_xlabel("Collision Chance (log scale)")
    ax.set_ylabel("Time (ms) (log scale)")
    ax.set_title("Collision Chance vs. Time Across Schedulers")
    ax.legend(title="Function")
    ax.grid(True, alpha=0.3)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    print(f"wrote {out_path}")


if __name__ == "__main__":
    args = [a for a in sys.argv[1:]]
    if "--run" in args:
        args.remove("--run")
        run_cc_sweep()
    plot(args[0] if args else CC_CSV)
