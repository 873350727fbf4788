"""Draw-protocol modes (rng_mode).

rng_mode="block2" draws one Threefry block per step pair (rng.pair_draws).
Contracts enforced here:

  * step_draws_mode("perstep", ...) IS step_draws — bit-identical;
  * block2's per-step form and the pair form agree bit-exactly;
  * the payload-recovery identity (physics.py: bits = child_lo ^ GOLDEN
    produced u) holds in every mode;
  * all cadences (sync oracle, naive, the dynamic engine) agree under
    either mode, with odd T so block2's last pair is cut in half — the
    reference's scheduler-equivalence contract (src/test.cu:43-101).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from particle_simulation_tpu import rng
from particle_simulation_tpu.runtime import sorted_particle_array

from engine_cases import BASE, run_steps


def _ids(n=4096, seed=7):
    slots = jnp.arange(n, dtype=jnp.uint32)
    return rng.initial_ids(seed, slots)


def test_perstep_mode_is_step_draws():
    id_hi, id_lo = _ids()
    for t in (1, 2, 9):
        a = rng.step_draws(39587, id_hi, id_lo, 3, t, 0.0, 100.0, rounds=13)
        b = rng.step_draws_mode(
            "perstep", 39587, id_hi, id_lo, 3, t, 0.0, 100.0, rounds=13
        )
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_block2_per_step_matches_pair_form():
    id_hi, id_lo = _ids()
    even, odd = rng.pair_draws(39587, id_hi, id_lo, 5, 8, 0.0, 100.0, rounds=13)
    for t, expect in ((8, even), (9, odd)):
        got = rng.step_draws_mode(
            "block2", 39587, id_hi, id_lo, 5, t, 0.0, 100.0, rounds=13
        )
        for x, y in zip(expect, got):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    # vector t: parity select per lane
    t_vec = jnp.where(jnp.arange(4096) % 2 == 0, 8, 9).astype(jnp.uint32)
    got = rng.step_draws_mode(
        "block2", 39587, id_hi, id_lo, 5, t_vec, 0.0, 100.0, rounds=13
    )
    for k in range(3):
        want = np.where(
            np.arange(4096) % 2 == 0, np.asarray(even[k]), np.asarray(odd[k])
        )
        np.testing.assert_array_equal(np.asarray(got[k]), want)


@pytest.mark.parametrize("mode", ["perstep", "block2"])
def test_payload_recovery_identity(mode):
    # physics.update_particles recovers the 24-bit payload that produced u
    # as child_lo ^ GOLDEN (threshold lookups decide in integer space)
    id_hi, id_lo = _ids(1024)
    for t in (4, 5):
        u, _, child_lo = rng.step_draws_mode(
            mode, 39587, id_hi, id_lo, 1, t, 0.0, 100.0, rounds=13
        )
        bits = jnp.asarray(child_lo, jnp.uint32) ^ jnp.uint32(rng.GOLDEN)
        np.testing.assert_array_equal(
            np.asarray(rng.uniform_from_bits(bits, 0.0, 100.0)), np.asarray(u)
        )


def test_block2_sibling_ids_distinct():
    # a parent splitting at both steps of a pair mints two distinct ids
    id_hi, id_lo = _ids()
    even, odd = rng.pair_draws(39587, id_hi, id_lo, 0, 2, rounds=13)
    same = np.asarray(
        (even[1] == odd[1]) & (even[2] == odd[2])
    )
    assert not same.any()


# ---- engine equivalence under each protocol ----

# odd T: block2's last step pair is cut in half; the const 50/50 table
# drives heavy splitting, so children start on both parities
_CFG = BASE.replace(poisson_timestep=7, scheduler="dynamic")


def _final(cfg, table):
    state, metrics = run_steps(cfg, table)
    return sorted_particle_array(state), metrics


@pytest.mark.parametrize("mode", ["perstep", "block2"])
def test_engine_matches_naive_odd_t(const_table, mode):
    cfg = _CFG.replace(rng_mode=mode)
    arr_d, m_d = _final(cfg, const_table)
    arr_n, m_n = _final(cfg.replace(scheduler="naive"), const_table)
    np.testing.assert_array_equal(arr_d, arr_n)
    assert m_d == m_n


@pytest.mark.parametrize("mode", ["perstep", "block2"])
def test_engine_matches_sync_odd_t(const_table, mode):
    cfg = _CFG.replace(rng_mode=mode)
    arr_d, m_d = _final(cfg, const_table)
    arr_s, m_s = _final(cfg.replace(scheduler="sync"), const_table)
    np.testing.assert_array_equal(arr_d, arr_s)
    assert m_d == m_s
