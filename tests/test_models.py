"""Selectable physics models (models/integrator.py, models/collisions.py):
the Boris push and the isotropic collision model must be distinct from the
reference-parity defaults, energy/shape sane, and cadence-independent (all
engines bit-equal for any model selection)."""

import jax.numpy as jnp
import numpy as np
import pytest

from particle_simulation_tpu import SimConfig, setup_particles
from particle_simulation_tpu.ops.physics import Particles, boris, leapfrog
from particle_simulation_tpu.ops.step import poisson_step
from particle_simulation_tpu.runtime import sorted_particle_array


def _particles(n=8, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda: jnp.asarray(rng.normal(size=n).astype(np.float32))
    return Particles(
        px=f(), py=f(), pz=f(), vx=f(), vy=f(), vz=f(),
        ax=f(), ay=f(), az=f(),
        status=jnp.full((n,), -1, jnp.int32),
        id_hi=jnp.zeros((n,), jnp.uint32), id_lo=jnp.zeros((n,), jnp.uint32),
    )


def test_boris_differs_from_leapfrog_but_matches_velocity():
    p = _particles()
    dt = 1e-3
    lf = leapfrog(p, dt)
    bo = boris(p, dt)
    # same end-of-step velocity (both apply the full kick) ...
    np.testing.assert_allclose(np.asarray(bo.vx), np.asarray(lf.vx), rtol=1e-6)
    # ... but the drifts differ by exactly the extra half-kick a*dt^2/2
    # (boris drifts with the fully-kicked velocity)
    drift_delta = np.asarray(lf.px, np.float64) - np.asarray(bo.px, np.float64)
    expected = np.asarray(p.ax, np.float64) * dt * dt / 2
    # the delta is ~a*dt^2/2 ~ 5e-7 against positions ~0.1, so f32
    # quantization of each position (~1e-8) dominates the comparison noise
    np.testing.assert_allclose(drift_delta, expected, rtol=0.05, atol=2e-7)
    assert np.abs(expected).max() > 0


def test_zero_acceleration_integrators_agree():
    p = _particles()
    p = p._replace(ax=jnp.zeros_like(p.ax), ay=jnp.zeros_like(p.ay),
                   az=jnp.zeros_like(p.az))
    lf = leapfrog(p, 1e-3)
    bo = boris(p, 1e-3)
    np.testing.assert_array_equal(np.asarray(lf.px), np.asarray(bo.px))
    np.testing.assert_array_equal(np.asarray(lf.vx), np.asarray(bo.vx))


def _run(cfg, table):
    state = setup_particles(cfg)
    for t in range(cfg.poisson_steps):
        state, m = poisson_step(state, jnp.uint32(t), table, cfg)
    return sorted_particle_array(state), int(m["n"])


def test_boris_b_field_pure_gyration():
    """With zero E and uniform B, the Boris rotation conserves speed
    exactly-in-structure (the rotation matrix has unit determinant) and
    gyrates in the correct sense: for Ω = +Ω ẑ, v rotates from +x̂ toward
    −ŷ (v' ≈ v + v×t at first order)."""
    from particle_simulation_tpu.ops.physics import make_kick

    n = 8
    z = jnp.zeros((n,), jnp.float32)
    p = Particles(
        px=z, py=z, pz=z,
        vx=jnp.full((n,), 2.0, jnp.float32), vy=z, vz=z,
        ax=z, ay=z, az=z,
        status=jnp.full((n,), -1, jnp.int32),
        id_hi=jnp.zeros((n,), jnp.uint32), id_lo=jnp.zeros((n,), jnp.uint32),
    )
    omega, dt = 3.0, 1e-2
    kick = make_kick("boris", (p.ax, p.ay, p.az), dt, jnp.float32,
                     b_field=(0.0, 0.0, omega))
    assert len(kick) == 9
    out = boris(p, dt, kick)
    speed0 = np.float64(2.0)
    speed1 = np.sqrt(
        np.asarray(out.vx, np.float64) ** 2
        + np.asarray(out.vy, np.float64) ** 2
        + np.asarray(out.vz, np.float64) ** 2
    )
    np.testing.assert_allclose(speed1, speed0, rtol=1e-6)
    # rotation sense: v × t with t = Ω dt/2 ẑ sends +x̂ toward −ŷ... for
    # v = v x̂, v×t = v·tz (x̂×ẑ) = −v·tz ŷ
    assert np.all(np.asarray(out.vy) < 0)
    np.testing.assert_allclose(np.asarray(out.vz), 0.0, atol=0)
    # rotation angle ≈ Ω dt
    angle = np.arctan2(-np.asarray(out.vy, np.float64),
                       np.asarray(out.vx, np.float64))
    np.testing.assert_allclose(angle, omega * dt, rtol=1e-3)


def test_boris_b_field_circular_orbit():
    """Many steps of pure gyration trace a circle of radius |v|/Ω around
    the gyrocenter, returning near the start after a full period."""
    from particle_simulation_tpu.ops.physics import make_kick

    omega, dt, speed = 2.0, 2e-3, 1.0
    steps = int(round(2 * np.pi / (omega * dt)))
    z = jnp.zeros((1,), jnp.float32)
    p = Particles(
        px=z, py=z, pz=z,
        vx=jnp.full((1,), speed, jnp.float32), vy=z, vz=z,
        ax=z, ay=z, az=z,
        status=jnp.full((1,), -1, jnp.int32),
        id_hi=jnp.zeros((1,), jnp.uint32), id_lo=jnp.zeros((1,), jnp.uint32),
    )
    kick = make_kick("boris", (p.ax, p.ay, p.az), dt, jnp.float32,
                     b_field=(0.0, 0.0, omega))

    import jax

    @jax.jit
    def orbit(q0):
        def body(q, _):
            q2 = boris(q, dt, kick)
            return q2, q2.px[0] ** 2 + q2.py[0] ** 2
        return jax.lax.scan(body, q0, None, length=steps)

    q, r2s = orbit(p)
    # returns near the start after a full period
    assert np.sqrt(float(q.px[0] - p.px[0]) ** 2
                   + float(q.py[0] - p.py[0]) ** 2) < 0.02
    # farthest orbit point from the start = the gyro-diameter 2|v|/Ω
    np.testing.assert_allclose(
        np.sqrt(float(jnp.max(r2s))), 2 * speed / omega, rtol=0.01
    )


def test_boris_zero_b_path_unchanged():
    """b_field=(0,0,0) must produce the exact pre-b_field boris kick (a
    3-tuple full kick), keeping the zero-B model bit-stable."""
    from particle_simulation_tpu.ops.physics import make_kick

    p = _particles()
    k0 = make_kick("boris", (p.ax, p.ay, p.az), 1e-3, jnp.float32)
    k1 = make_kick("boris", (p.ax, p.ay, p.az), 1e-3, jnp.float32,
                   b_field=(0.0, 0.0, 0.0))
    assert len(k0) == len(k1) == 3
    for a, b in zip(k0, k1):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.slow
def test_boris_b_field_cadence_independent(const_table):
    """The finite-B rotation constants ride the hoisted kick tuple through
    every engine, so the scheduler-equivalence contract holds for B != 0
    (same tolerance rationale as the zero-B boris case above)."""
    base = SimConfig(
        init_n=150, capacity=4096, poisson_steps=2, poisson_timestep=5,
        grid_size=(16, 16, 16), block_size=16, integrator="boris",
        b_field=(0.0, 0.0, 1e9),
    )
    arr_sync, n_sync = _run(base.replace(scheduler="sync"), const_table)
    arr_dyn, n_dyn = _run(base.replace(scheduler="dynamic"), const_table)
    arr_naive, n_naive = _run(base.replace(scheduler="naive"), const_table)
    assert n_sync == n_dyn == n_naive
    assert arr_sync.shape == arr_dyn.shape == arr_naive.shape
    np.testing.assert_array_equal(arr_sync, arr_naive)
    np.testing.assert_allclose(arr_sync, arr_dyn, rtol=2e-6, atol=1e-30)


def test_boris_b_field_changes_trajectories(const_table):
    base = SimConfig(
        init_n=150, capacity=4096, poisson_steps=2, poisson_timestep=5,
        grid_size=(16, 16, 16), scheduler="sync", integrator="boris",
    )
    a, _ = _run(base, const_table)
    b, _ = _run(base.replace(b_field=(0.0, 0.0, 1e9)), const_table)
    assert a.shape != b.shape or not np.array_equal(a, b)


def test_wrap_periodic_maps_into_domain():
    from particle_simulation_tpu.ops.physics import wrap_periodic

    size = (5.12, 5.12, 5.12)
    vals = jnp.asarray(
        [-1e-8, -0.5, 0.0, 2.0, 5.12, 5.12 + 0.25, 17.0, -11.0], jnp.float32
    )
    z = jnp.zeros_like(vals)
    p = _particles(n=8)._replace(px=vals, py=z, pz=z)
    w = wrap_periodic(p, size)
    x = np.asarray(w.px, np.float64)
    assert np.all(x >= 0) and np.all(x < 5.12)
    # plain in-domain values pass through untouched
    np.testing.assert_array_equal(x[2:4], [0.0, 2.0])
    # wraps land where modular arithmetic says (f32 tolerance)
    np.testing.assert_allclose(x[5], 0.25, rtol=1e-5)
    np.testing.assert_allclose(x[1], 5.12 - 0.5, rtol=1e-6)


def test_periodic_boundary_keeps_population(const_table):
    """With periodic wrapping nothing leaves the domain: live positions
    stay in [0, size) after multiple Poisson steps."""
    cfg = SimConfig(
        init_n=150, capacity=4096, poisson_steps=2, poisson_timestep=5,
        grid_size=(16, 16, 16), scheduler="sync", boundary="periodic",
    )
    state = setup_particles(cfg)
    for t in range(cfg.poisson_steps):
        state, m = poisson_step(state, jnp.uint32(t), const_table, cfg)
    n = int(m["n"])
    pos = np.asarray(state.pos)[:n]
    assert np.all(pos >= 0) and np.all(pos < cfg.sim_size[0])


@pytest.mark.slow
def test_periodic_boundary_cadence_independent(const_table):
    base = SimConfig(
        init_n=150, capacity=4096, poisson_steps=2, poisson_timestep=5,
        grid_size=(16, 16, 16), block_size=16, boundary="periodic",
    )
    arr_sync, n_sync = _run(base.replace(scheduler="sync"), const_table)
    arr_naive, n_naive = _run(base.replace(scheduler="naive"), const_table)
    arr_dyn, n_dyn = _run(base.replace(scheduler="dynamic"), const_table)
    assert n_sync == n_naive == n_dyn
    np.testing.assert_array_equal(arr_sync, arr_naive)
    np.testing.assert_array_equal(arr_sync, arr_dyn)


@pytest.mark.slow
def test_boris_cadence_independent(const_table):
    """The alternative integrator preserves the scheduler-equivalence
    contract: all decisions/counts exact; float payloads compared with a
    tight tolerance because XLA's FMA contraction of `v - a*dt` may differ
    by ~1 ulp between differently-shaped compiled programs (the default
    leapfrog happens to compile identically and stays bit-exact)."""
    base = SimConfig(
        init_n=150, capacity=4096, poisson_steps=2, poisson_timestep=5,
        grid_size=(16, 16, 16), block_size=16, integrator="boris",
    )
    arr_sync, n_sync = _run(base.replace(scheduler="sync"), const_table)
    arr_dyn, n_dyn = _run(base.replace(scheduler="dynamic"), const_table)
    assert n_sync == n_dyn
    assert arr_sync.shape == arr_dyn.shape
    np.testing.assert_allclose(arr_sync, arr_dyn, rtol=2e-6, atol=1e-30)


@pytest.mark.slow
def test_isotropic_cadence_independent(const_table):
    """The isotropic model's DECISIONS (who splits/dies, genealogy, counts)
    are exact across cadences; the child velocity involves sin/cos whose
    fusion may differ per compiled program by ~1 ulp, so float payloads are
    compared with a tight tolerance (documented in models/collisions.py)."""
    base = SimConfig(
        init_n=150, capacity=4096, poisson_steps=2, poisson_timestep=5,
        grid_size=(16, 16, 16), block_size=16,
        collision_model="isotropic",
    )
    arr_sync, n_sync = _run(base.replace(scheduler="sync"), const_table)
    arr_dyn, n_dyn = _run(base.replace(scheduler="dynamic"), const_table)
    assert n_sync == n_dyn
    assert arr_sync.shape == arr_dyn.shape
    np.testing.assert_allclose(arr_sync, arr_dyn, rtol=2e-6, atol=1e-30)


def test_isotropic_differs_from_reverse(const_table):
    base = SimConfig(
        init_n=150, capacity=4096, poisson_steps=2, poisson_timestep=5,
        grid_size=(16, 16, 16), scheduler="sync",
    )
    a, _ = _run(base, const_table)
    b, _ = _run(base.replace(collision_model="isotropic"), const_table)
    assert a.shape != b.shape or not np.array_equal(a, b)
