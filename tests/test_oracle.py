"""f64 CPU oracle vs the f32 production path (SURVEY.md §4: oracle is a
pure-JAX CPU-runnable reference step under x64).

With the constant cross-section table, collision decisions are independent
of float precision (the uniform draw is integer-derived and the chances are
energy-independent), so f32 and f64 runs must agree EXACTLY on population
dynamics.  With the sine table, growth curves must agree statistically.
"""

import jax
import numpy as np
import pytest

from particle_simulation_tpu import SimConfig
from particle_simulation_tpu.cross_section import bundled_paths
from particle_simulation_tpu.runtime import run_pic


@pytest.fixture()
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def test_f64_oracle_const_table_exact_population(x64):
    cfg = SimConfig(
        init_n=200, capacity=20_000, poisson_steps=3, poisson_timestep=6,
        grid_size=(32, 32, 32), cross_section_path=bundled_paths()[1],
    )
    r32 = run_pic(cfg, print_header=False)
    r64 = run_pic(cfg.replace(precision="f64"), print_header=False)
    assert r64.state.pos.dtype == np.float64
    assert [m.n for m in r32.steps] == [m.n for m in r64.steps]
    assert [m.added for m in r32.steps] == [m.added for m in r64.steps]
    # id multisets identical (genealogy independent of float precision)
    n = r32.final_n
    np.testing.assert_array_equal(
        np.sort(np.asarray(r32.state.id_lo)[:n]),
        np.sort(np.asarray(r64.state.id_lo)[:n]),
    )


def test_f64_oracle_positions_close(x64):
    """Trajectories agree to f32 resolution over a short run."""
    cfg = SimConfig(
        init_n=100, capacity=1000, poisson_steps=2, poisson_timestep=8,
        grid_size=(32, 32, 32),  # sine table: no collisions while cold
    )
    r32 = run_pic(cfg, print_header=False)
    r64 = run_pic(cfg.replace(precision="f64"), print_header=False)
    n = r32.final_n
    assert n == r64.final_n
    np.testing.assert_allclose(
        np.asarray(r32.state.vel)[:n], np.asarray(r64.state.vel)[:n],
        rtol=2e-5, atol=1e-12,
    )
    np.testing.assert_allclose(
        np.asarray(r32.state.pos)[:n], np.asarray(r64.state.pos)[:n],
        rtol=1e-5,
    )
