"""External-validation plot: simulated population trajectory
under constant collision tables vs the analytic branching-process mean with
Monte-Carlo bounds.

Each mobility step is one Galton-Watson branching step per particle
(split -> 2 offspring, remove -> 0, else -> 1 at the table's stated
chances; children join the NEXT step — the reference's timestamp protocol,
/root/reference/src/particle_move.cu:62-74), so E[n] and Var[n] after N
steps are closed-form (tests/test_validation.py::branching_moments).  The
solid lines are end-to-end framework runs; the bands are mean +- 3 sigma.

Usage: python -m particle_simulation_tpu.analyse.plot_validation [out.png]
"""

import math
import os
import sys
import tempfile

import numpy as np


def main(out_path: str = "out/plots/validation_growth.png") -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from particle_simulation_tpu import SimConfig
    from particle_simulation_tpu.cross_section import N_STEPS, write_table
    from particle_simulation_tpu.runtime import run_pic

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))
    from tests.test_validation import branching_moments

    n0, t_steps, k_steps = 20_000, 10, 6
    fig, ax = plt.subplots(figsize=(7, 4.5))
    for (s_pct, r_pct), color in (((50.0, 50.0), "tab:blue"),
                                  ((2.0, 1.0), "tab:orange"),
                                  ((1.0, 2.0), "tab:green")):
        with tempfile.TemporaryDirectory() as td:
            path = os.path.join(td, "t.txt")
            write_table(path, np.full((N_STEPS, 2), 0.0, np.float32)
                        + np.asarray([s_pct, r_pct], np.float32))
            cfg = SimConfig(
                init_n=n0, capacity=1 << 17, poisson_steps=k_steps,
                poisson_timestep=t_steps, grid_size=(32, 32, 32),
                scheduler="naive", cross_section_path=path,
            )
            run = run_pic(cfg, print_header=False)
        xs = np.arange(k_steps + 1) * t_steps
        measured = [n0] + [s.n for s in run.steps]
        mean = [n0]
        lo, hi = [n0], [n0]
        for x in xs[1:]:
            m, v = branching_moments(n0, s_pct, r_pct, int(x))
            mean.append(m)
            lo.append(m - 3 * math.sqrt(v))
            hi.append(m + 3 * math.sqrt(v))
        ax.fill_between(xs, lo, hi, color=color, alpha=0.18,
                        label=f"analytic {s_pct:g}/{r_pct:g} ±3σ")
        ax.plot(xs, mean, color=color, lw=0.8, ls="--")
        ax.plot(xs, measured, color=color, lw=1.6, marker="o", ms=3,
                label=f"measured {s_pct:g}/{r_pct:g}")
    ax.set_xlabel("mobility steps")
    ax.set_ylabel("population n")
    ax.set_title("End-to-end growth vs analytic branching process "
                 "(constant tables)")
    ax.legend(fontsize=7)
    ax.grid(alpha=0.25)
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    fig.tight_layout()
    fig.savefig(out_path, dpi=130)
    print(f"wrote {out_path}")


if __name__ == "__main__":
    main(*sys.argv[1:])
