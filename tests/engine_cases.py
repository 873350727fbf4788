"""Shared helpers for the dynamic-engine tests (not a test module).

The engine (ops/gpu_engine.py) runs in the Pallas interpreter on the CPU;
every case compares it with the ``sync`` oracle on the sorted particle
multiset and on every per-step metric, bit for bit.
"""

import jax.numpy as jnp
import numpy as np

from particle_simulation_tpu import SimConfig, setup_particles
from particle_simulation_tpu.ops.step import poisson_step
from particle_simulation_tpu.runtime import sorted_particle_array


def run_steps(cfg, table):
    """``cfg.poisson_steps`` Poisson steps; returns (state, metrics)."""
    state = setup_particles(cfg)
    metrics = []
    for t in range(cfg.poisson_steps):
        state, m = poisson_step(state, jnp.uint32(t), table, cfg)
        metrics.append(
            {
                "n": int(m["n"]),
                "added": int(m["added"]),
                "removed": int(m["removed"]),
                "overflow": bool(m["overflow"]),
                "pushes": int(m["pushes_lo"]) + (int(m["pushes_hi"]) << 30),
            }
        )
    return state, metrics


# Tiny but churning: 200 electrons, 16-lane programs (so a step spans
# several programs and generations), the 16^3 grid.
BASE = SimConfig(
    init_n=200,
    capacity=4096,
    poisson_steps=2,
    poisson_timestep=6,
    grid_size=(16, 16, 16),
    block_size=16,
)


def spiky_table(seed=0, rows=10_000):
    """A random (split, remove) table with spikes: most buckets collide
    rarely, a random tenth of them split or absorb with high chance."""
    rs = np.random.RandomState(seed)
    split = rs.uniform(0.0, 2.0, rows)
    remove = rs.uniform(0.0, 2.0, rows)
    spikes = rs.rand(rows) < 0.1
    split[spikes] = rs.uniform(20.0, 60.0, spikes.sum())
    remove[spikes] = rs.uniform(0.0, 40.0, spikes.sum())
    return jnp.asarray(np.stack([split, remove], axis=1), jnp.float32)


def assert_engine_matches_sync(cfg, table):
    """The engine and the sync oracle agree exactly: every metric of every
    step and the final sorted multiset.  Returns the engine's metrics."""
    ref_state, ref_m = run_steps(cfg.replace(scheduler="sync"), table)
    eng_state, eng_m = run_steps(cfg.replace(scheduler="dynamic"), table)
    assert eng_m == ref_m
    np.testing.assert_array_equal(
        sorted_particle_array(eng_state), sorted_particle_array(ref_state)
    )
    return eng_m


# integrator x collision model x boundary x draw protocol: every model
# selection the shared physics offers, run through the engine.  ``init_vth``
# gives the electrons thermal speeds so the energy-dependent tables collide
# from the first step.
INTEGRATORS = {
    "leapfrog": dict(integrator="leapfrog"),
    "boris": dict(integrator="boris"),
    "borisB": dict(integrator="boris", b_field=(1e9, -2e9, 5e8)),
}
MATRIX = [
    (f"{i}-{c}-{b}-{r}", dict(INTEGRATORS[i], collision_model=c, boundary=b,
                              rng_mode=r, init_vth=1e6))
    for i in INTEGRATORS
    for c in ("reverse", "isotropic")
    for b in ("absorb", "periodic")
    for r in ("perstep", "block2")
]
MATRIX_IDS = [name for name, _ in MATRIX]
MATRIX_KW = [kw for _, kw in MATRIX]
