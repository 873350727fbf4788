"""Mid-phase dead-slot reclamation (population.reclaim + the host-chunked
paths' reclaim wiring).

At the canonical naive T>=800 tails the mobility phase's CUMULATIVE appends
(~30M rows) dwarf the live population (~1M), and the un-reclaimed bucket
ladder exceeds the largest bucket that fits in device memory.  Reclamation drops DEAD rows between host-chunk
dispatches; physics must be invariant (draws are genealogy-keyed, rng.py)
and metrics must stay bit-identical via the reclaimed-count fold-back
(ops/step._sync_finalize_jit).

The reference never reclaims mid-phase (its 5e7-slot container absorbs a
whole phase, src/pic.cu:127-131) — this is a memory-management design
choice with an exactness proof obligation, discharged here.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from particle_simulation_tpu import SimConfig, setup_particles
from particle_simulation_tpu.constants import (
    STATUS_ALIVE,
    STATUS_DEAD,
    STATUS_EMPTY,
)
from particle_simulation_tpu.ops import population
from particle_simulation_tpu.ops import step as step_mod
from particle_simulation_tpu.ops.step import (
    poisson_step,
    poisson_step_naive_host,
)
from particle_simulation_tpu.runtime import sorted_particle_array
from particle_simulation_tpu.state import SimState

from engine_cases import BASE


def test_reclaim_preserves_statuses_and_order():
    """DEAD and EMPTY rows below n vanish; survivors close ranks in order
    with statuses (ALIVE, spawn stamps, other negatives)
    preserved VERBATIM — unlike compact(), which resets to ALIVE."""
    c = 16
    statuses = [
        STATUS_ALIVE, STATUS_DEAD, 7, STATUS_EMPTY, -40005, STATUS_ALIVE,
        STATUS_DEAD, 3,
    ]  # n = 8; tail beyond n stays EMPTY
    n = len(statuses)
    ids = np.arange(c, dtype=np.uint32)
    state = SimState(
        pos=jnp.arange(c * 3, dtype=jnp.float32).reshape(c, 3),
        vel=jnp.arange(c * 3, dtype=jnp.float32).reshape(c, 3) + 100.0,
        acc=jnp.zeros((c, 3), jnp.float32),
        status=jnp.array(statuses + [STATUS_EMPTY] * (c - n), jnp.int32),
        id_hi=jnp.asarray(ids),
        id_lo=jnp.asarray(ids * 2),
        n=jnp.asarray(n, jnp.int32),
    )
    out, reclaimed = population.reclaim(state)
    # live rows: indices 0, 2, 5, 7  (ALIVE / stamp>0); -40005 is NOT live
    # under the SimState protocol — it is reclaimed like DEAD here.
    keep = [0, 2, 5, 7]
    assert int(out.n) == len(keep)
    assert int(reclaimed) == n - len(keep)
    np.testing.assert_array_equal(
        np.asarray(out.status)[: len(keep)],
        [statuses[i] for i in keep],
    )
    np.testing.assert_array_equal(
        np.asarray(out.pos)[: len(keep)], np.asarray(state.pos)[keep]
    )
    np.testing.assert_array_equal(
        np.asarray(out.id_lo)[: len(keep)], np.asarray(state.id_lo)[keep]
    )
    # tail is zeroed EMPTY
    assert (np.asarray(out.status)[len(keep):] == STATUS_EMPTY).all()


def _run(cfg, table, step_fn):
    state = setup_particles(cfg)
    metrics = []
    for t in range(cfg.poisson_steps):
        state, m = step_fn(state, jnp.uint32(t), table, cfg)
        metrics.append(
            {k: np.asarray(m[k]).item() for k in
             ("n", "added", "removed", "overflow", "pushes_lo", "pushes_hi")}
        )
    return sorted_particle_array(state), metrics


NAIVE_CFG = BASE.replace(scheduler="naive", poisson_steps=2, poisson_timestep=6)


def test_naive_host_reclaim_bit_exact(const_table, monkeypatch):
    """Forced reclamation after every chunk (threshold 0): final multiset
    AND metrics identical to the in-jit naive step.  The const 50/50 table
    guarantees both deaths and spawns inside every chunk."""
    ref, ref_m = _run(NAIVE_CFG, const_table, poisson_step)
    assert any(m["removed"] > 0 for m in ref_m)  # deaths actually occur

    monkeypatch.setattr(step_mod, "_RECLAIM_MIN", 0)

    def host_step(state, t, table, cfg):
        return poisson_step_naive_host(
            state, t, table, cfg, t_chunk=2, stop_on_overflow=False
        )

    got, got_m = _run(NAIVE_CFG, const_table, host_step)
    np.testing.assert_array_equal(ref, got)
    assert ref_m == got_m


def test_naive_host_no_reclaim_above_threshold(const_table):
    """With the default threshold (1<<20) these tiny configs never
    reclaim — the host path must still be bit-exact (regression guard for
    the wiring itself)."""
    ref, ref_m = _run(NAIVE_CFG, const_table, poisson_step)

    def host_step(state, t, table, cfg):
        return poisson_step_naive_host(
            state, t, table, cfg, t_chunk=3, stop_on_overflow=False
        )

    got, got_m = _run(NAIVE_CFG, const_table, host_step)
    np.testing.assert_array_equal(ref, got)
    assert ref_m == got_m


@pytest.mark.slow
def test_bucket_decay_with_reclamation(monkeypatch):
    """run_pic_device's host-chunked paths decay the bucket hint toward the
    live population: a population that collapses (remove-heavy table) must
    END on a smaller bucket than it started, and physics must match the
    in-jit path exactly (the decay can only change WHERE work runs)."""
    import jax.numpy as jnp

    from particle_simulation_tpu.runtime import (
        _bucket_size,
        run_pic_device,
        sorted_particle_array,
    )

    monkeypatch.setattr(step_mod, "_RECLAIM_MIN", 0)
    # remove-heavy constant table: every collision kills, none split
    table = jnp.tile(jnp.asarray([[0.0, 30.0]], jnp.float32), (10000, 1))
    cfg = SimConfig(
        init_n=200_000, capacity=1 << 19, poisson_steps=3,
        poisson_timestep=4, grid_size=(16, 16, 16), scheduler="naive",
    )
    run = run_pic_device(cfg, table=table, naive_chunk=2)
    w0 = _bucket_size(cfg.init_n, cfg.capacity)
    assert run.final_n < cfg.init_n // 4  # the population really collapsed
    assert run.last_bucket < w0
    ref = run_pic_device(cfg, table=table)  # in-jit path, sticky hint
    assert ref.final_n == run.final_n
    np.testing.assert_array_equal(
        sorted_particle_array(ref.state), sorted_particle_array(run.state)
    )
