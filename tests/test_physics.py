"""Unit tests of the per-particle physics (ops/physics.py) against the
reference semantics (src/particle_move.cu)."""

import jax.numpy as jnp
import numpy as np

from particle_simulation_tpu.constants import STATUS_ALIVE, STATUS_DEAD
from particle_simulation_tpu.ops.physics import (
    Particles,
    leapfrog,
    out_of_bounds,
    update_particles,
)


def mk_particles(n=4, **kw):
    f = lambda v: jnp.full((n,), v, jnp.float32)
    base = dict(
        px=f(1.0), py=f(2.0), pz=f(3.0),
        vx=f(0.0), vy=f(0.0), vz=f(0.0),
        ax=f(0.0), ay=f(0.0), az=f(0.0),
        status=jnp.full((n,), STATUS_ALIVE, jnp.int32),
        id_hi=jnp.arange(n, dtype=jnp.uint32),
        id_lo=jnp.arange(n, dtype=jnp.uint32) + 100,
    )
    base.update({k: jnp.asarray(v) for k, v in kw.items()})
    return Particles(**base)


def test_leapfrog_kick_drift_kick():
    # v' = v - a*dt (two half kicks); x' = x + (v - a*dt/2)*dt
    p = mk_particles(1, vx=[2.0], ax=[4.0], px=[1.0])
    dt = 0.5
    out = leapfrog(p, dt)
    v_half = 2.0 - 4.0 * 0.25
    assert np.isclose(float(out.px[0]), 1.0 + v_half * dt)
    assert np.isclose(float(out.vx[0]), 2.0 - 4.0 * dt)
    # y/z untouched with zero velocity/accel
    assert float(out.py[0]) == 2.0 and float(out.vz[0]) == 0.0


def test_out_of_bounds_edges():
    sim = (5.12, 5.12, 5.12)
    p = mk_particles(4,
        px=[0.0, -1e-6, 5.12, 2.0],
        py=[1.0, 1.0, 1.0, 1.0],
        pz=[1.0, 1.0, 1.0, 1.0])
    oob = np.asarray(out_of_bounds(p, sim))
    # x=0 in bounds; x<0 out; x>=size out (reference src/particle_move.cu:41-52)
    assert oob.tolist() == [False, True, True, False]


def _run_update(p, split, remove, active=None, t=3):
    n = p.px.shape[0]
    if active is None:
        active = jnp.ones((n,), bool)

    def lookup(energy):
        return (jnp.full(energy.shape, split, jnp.float32),
                jnp.full(energy.shape, remove, jnp.float32))

    return update_particles(
        p, active=active, t=t, poisson_step=0, dt=1e-3,
        sim_size=(5.12, 5.12, 5.12), split_chance=None, remove_chance=None,
        seed=1, table_lookup=lookup)


def test_certain_split_copies_child_and_flips_parent():
    p = mk_particles(3, vx=[1.0, 2.0, 3.0])
    res = _run_update(p, split=100.0, remove=0.0, t=5)
    assert np.asarray(res.spawn).all()
    # child velocity = parent's post-push velocity, NOT flipped
    np.testing.assert_allclose(np.asarray(res.child.vx), [1.0, 2.0, 3.0])
    # child stamped with spawn step (reference: new_electron.timestamp = t)
    assert np.asarray(res.child.status).tolist() == [5, 5, 5]
    # parent's velocity reversed, still alive
    np.testing.assert_allclose(np.asarray(res.particles.vx), [-1.0, -2.0, -3.0])
    assert (np.asarray(res.particles.status) == STATUS_ALIVE).all()
    # child ids differ from parents'
    assert not np.any(
        np.asarray(res.child.id_lo) == np.asarray(p.id_lo)
    )


def test_certain_remove_kills():
    p = mk_particles(3, vx=[1.0, 2.0, 3.0])
    res = _run_update(p, split=0.0, remove=100.0)
    assert not np.asarray(res.spawn).any()
    assert (np.asarray(res.particles.status) == STATUS_DEAD).all()


def test_out_of_bounds_dies_without_collision_roll():
    # Particle exits the domain: killed even when split chance is 100%.
    p = mk_particles(1, px=[5.11], vx=[100.0])  # 5.11 + 100*1e-3 > 5.12
    res = _run_update(p, split=100.0, remove=0.0)
    assert not np.asarray(res.spawn).any()
    assert int(res.particles.status[0]) == STATUS_DEAD


def test_inactive_lanes_untouched():
    p = mk_particles(2, vx=[1.0, 1.0], ax=[1.0, 1.0])
    res = _run_update(p, split=100.0, remove=0.0,
                      active=jnp.asarray([True, False]))
    assert bool(res.spawn[0]) and not bool(res.spawn[1])
    # lane 1 state unchanged
    assert float(res.particles.vx[1]) == 1.0
    assert float(res.particles.px[1]) == 1.0
    assert int(res.particles.status[1]) == STATUS_ALIVE


def test_split_remove_partition():
    """With split+remove = 100, every active particle either splits or dies;
    draw < split -> split, else die (reference ordering,
    src/particle_move.cu:67-78)."""
    n = 2048
    ids = np.arange(n)
    p = mk_particles(n, vx=np.ones(n, np.float32),
                     id_hi=np.zeros(n, np.uint32),
                     id_lo=ids.astype(np.uint32))
    res = _run_update(p, split=30.0, remove=70.0)
    spawn = np.asarray(res.spawn)
    dead = np.asarray(res.particles.status) == STATUS_DEAD
    assert (spawn ^ dead).all()  # exactly one of the two
    assert abs(spawn.mean() - 0.30) < 0.03


def test_boundary_cell_edges():
    """Particles at exact domain/cell boundaries index and deposit sanely."""
    import jax.numpy as jnp

    from particle_simulation_tpu.ops import grid as g

    grid = (8, 8, 8)
    cell = 0.5
    # exactly on a cell edge, exactly at domain max-epsilon, near zero
    pos = jnp.asarray([
        [0.5, 0.5, 0.5],            # exact interior edge -> cell 1
        [3.9999998, 3.9999998, 3.9999998],  # just inside the last cell
        [0.0, 0.0, 0.0],            # domain origin -> cell 0
    ], jnp.float32)
    idx = np.asarray(g.cell_indices(pos, cell, grid))
    assert idx[0].tolist() == [1, 1, 1]
    assert idx[1].tolist() == [7, 7, 7]
    assert idx[2].tolist() == [0, 0, 0]


def test_leapfrog_constant_acceleration_closed_form():
    """n leapfrog steps under constant a: v_n = v0 - a n dt and
    x_n = x0 + v0 n dt - a dt^2 n^2 / 2 (exact for leapfrog)."""
    import jax

    n_steps, dt, a0, v0, x0 = 50, 0.01, 3.0, 2.0, 1.0
    p = mk_particles(1, px=[x0], vx=[v0], ax=[a0])

    def body(_, pp):
        return leapfrog(pp, dt)

    out = jax.lax.fori_loop(0, n_steps, body, p)
    t = n_steps * dt
    assert np.isclose(float(out.vx[0]), v0 - a0 * t, rtol=1e-5)
    assert np.isclose(
        float(out.px[0]), x0 + v0 * t - 0.5 * a0 * t * t, rtol=1e-4
    )
