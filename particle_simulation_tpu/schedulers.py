"""Scheduler cadences.

The reference's four CUDA schedulers (Dynamic / CPU Sync / Naive / Dynamic
Old, src/pic.cu:19-316) are different ways to execute the same behavioral
spec: children spawned at mobility step t are themselves simulated from step
t+1 within the same Poisson step, and results must be scheduler-independent.
Here the spec survives as *cadence configs* over one masked-array design:

  * ``naive``   — one vectorized pass per mobility step, children appended at
                  end of each step (the reference Naive, src/pic.cu:251-288,
                  which SURVEY.md §2 marks as the natural XLA fit);
  * ``sync``    — generation fixed-point: simulate the current slot range
                  through all remaining steps, then newly spawned ranges,
                  until no new particles appear (the reference CPU Sync,
                  src/pic.cu:214-248, 514-522) — the parity oracle;
  * ``dynamic`` — the generation-pass Pallas engine (ops/gpu_engine.py,
                  compiled through Triton): each lane runs all its remaining
                  mobility steps in registers, children and survivors are
                  appended through atomic counters, self-compacting — the
                  analog of the reference's Dynamic.

The reference's Dynamic Old (mode 33, src/pic.cu:291-316) has no engine
here.

All cadences are bit-identical in physics because draws are keyed by particle
genealogy (rng.py), not by execution order — the multiset of final particles
matches exactly (the reference's runUnitTest sorts and compares,
src/test.cu:43-101; tests/test_schedulers.py does the same).

Protocol: every mobility phase returns ``(state, info)`` with info keys
``pushes_lo``/``pushes_hi`` (exact base-2^30 i32 pair of lane-steps actually
advanced — f32 would round beyond 2^24), plus, for
self-compacting engines (fn.self_compacting == True), ``added`` (exact child
count) and ``overflow``; a self-compacting engine returns an
already-compacted state and poisson_step skips its compaction pass.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .config import SimConfig
from .state import SimState
from .ops import population
from .ops.physics import StepResult, make_kick, update_particles
from .ops.step import (
    active_mask,
    make_table_lookup,
    particles_to_state,
    state_to_particles,
)

PUSH_BASE = 1 << 30


def _push_add(lo, hi, dp):
    """Accumulate an i32 increment into an exact (lo, hi) base-2^30 pair."""
    lo = lo + dp
    return lo & jnp.int32(PUSH_BASE - 1), hi + (lo >> 30)


def pushes_info(lo, hi):
    return {"pushes_lo": lo, "pushes_hi": hi}


def _one_step(state: SimState, t, poisson_step, table, config, range_lo, range_hi):
    """One mobility step restricted to slots in [range_lo, range_hi).

    Returns (state, advanced) where advanced (i32) counts the lanes that
    actually moved this step (the benchmark's ground-truth work metric)."""
    p = state_to_particles(state)
    slot = jnp.arange(state.capacity, dtype=jnp.int32)
    active = (
        active_mask(p.status, t) & (slot >= range_lo) & (slot < range_hi)
    )
    res: StepResult = update_particles(
        p, active=active, t=t, poisson_step=poisson_step,
        dt=config.mobility_dt, sim_size=config.sim_size,
        split_chance=None, remove_chance=None, seed=config.seed,
        rng_rounds=config.rng_rounds,
        rng_mode=config.rng_mode,
        integrator=config.integrator,
        collision_model=config.collision_model,
        table_lookup=make_table_lookup(table),
        # the kick carries the finite-B boris rotation constants; built from
        # the same expression the fused kernels hoist, so cadences stay
        # bit-exact for any (integrator, b_field)
        kick=make_kick(
            config.integrator, (p.ax, p.ay, p.az), config.mobility_dt,
            p.vx.dtype, b_field=config.b_field,
        ),
        boundary=config.boundary,
    )
    state = particles_to_state(state, res.particles)
    state = population.append_children(state, res.spawn, res.child)
    return state, jnp.sum(active, dtype=jnp.int32)


def mobility_phase_naive(
    state: SimState, poisson_step, table, config: SimConfig, t_steps
):
    """All live slots advance together, one fori_loop iteration per step.
    ``t_steps`` (the mobility-step count) is traced, so one compilation
    covers every sweep point.

    Deliberate divergence: the reference's Naive host loop additionally
    calls log() after EVERY mobility step (src/pic.cu:528) — but passes the
    base double-buffer pointer instead of the active half, so odd Poisson
    steps dump the stale buffer (a latent reference bug).  We keep verbose
    logging at the Poisson-step cadence for all schedulers."""

    def body(t, carry):
        st, lo, hi = carry
        st, dp = _one_step(st, t, poisson_step, table, config, 0, st.n_clamped)
        lo, hi = _push_add(lo, hi, dp)
        return st, lo, hi

    zero = jnp.zeros((), jnp.int32)
    state, lo, hi = jax.lax.fori_loop(1, t_steps + 1, body, (state, zero, zero))
    return state, pushes_info(lo, hi)


def mobility_phase_sync(
    state: SimState, poisson_step, table, config: SimConfig, t_steps
):
    """Generation fixed-point (reference CPU Sync): repeatedly simulate the
    not-yet-finished slot range through the remaining steps until the
    population stops growing.  Terminates in <= poisson_timestep generations
    because a child spawned at step t only starts at t+1."""

    def gen_cond(carry):
        st, gen_lo, _lo, _hi = carry
        return st.n_clamped > gen_lo

    def gen_body(carry):
        st, gen_lo, lo, hi = carry
        gen_hi = st.n_clamped

        def body(t, c):
            s, l_, h_ = c
            s, dp = _one_step(s, t, poisson_step, table, config, gen_lo, gen_hi)
            l_, h_ = _push_add(l_, h_, dp)
            return s, l_, h_

        st, lo, hi = jax.lax.fori_loop(1, t_steps + 1, body, (st, lo, hi))
        return st, gen_hi, lo, hi

    zero = jnp.zeros((), jnp.int32)
    state, _, lo, hi = jax.lax.while_loop(
        gen_cond, gen_body, (state, zero, zero, zero)
    )
    return state, pushes_info(lo, hi)


def get_mobility_phase(name: str):
    if name == "naive":
        return mobility_phase_naive
    if name == "sync":
        return mobility_phase_sync
    if name == "dynamic":
        from .ops.gpu_engine import mobility_phase_dynamic

        return mobility_phase_dynamic
    raise ValueError(
        f"unknown scheduler {name!r}: use 'dynamic' (mode 30), 'sync' "
        "(mode 31) or 'naive' (mode 32)"
    )
