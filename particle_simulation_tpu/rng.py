"""Counter-based, genealogy-keyed RNG.

The reference (src/random.cu:3-5) carries one 48-byte cuRAND XORWOW state per
particle *slot* (seed 39587, sequence = slot index) so that physics is
independent of which scheduler executes a particle.  Here we go further and
make physics independent of *slot assignment entirely*: every particle carries
a 64-bit ``rng id`` derived from its genealogy —

  * initial particle ``i``:      id = threefry(key=(seed, GOLDEN), ctr=(0, i))
  * child of particle with id r, spawned at Poisson step p, mobility step t:
                                 id = threefry(key=r, ctr=(p, t))

and every uniform draw is a pure function of (id, poisson_step, mobility_step).
Any execution order / compaction cadence / sharding therefore yields
bit-identical physics — the property the reference's scheduler-equivalence
unit test (src/test.cu:43-101) exists to check.

The hash is the standard Threefry-2x32 block cipher (Salmon et al., SC'11),
implemented here directly in uint32 jnp ops so the *same code* runs in traced
JAX, inside the Pallas kernels (Triton on the GPU, the interpreter on the
CPU) — guaranteeing bit-exactness between the pure-JAX oracle path and the
Pallas engine.
"""

from __future__ import annotations

import jax.numpy as jnp

GOLDEN = 0x9E3779B9  # 2^32 / golden ratio; arbitrary domain-separation word.
_KS_PARITY = 0x1BD11BDA
# Threefry-2x32 rotation schedule.
_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)

# Setup-phase counter namespace (must not collide with (poisson_step, mob_step)
# pairs, which always have mob_step >= 1 in the hot loop or counter word 0).
SETUP_CTR = 0xFFFFFFFF


def _rotl(x, r: int):
    return (x << jnp.uint32(r)) | (x >> jnp.uint32(32 - r))


def threefry2x32(key0, key1, ctr0, ctr1, rounds: int = 20):
    """Threefry-2x32 with the standard 20 rounds.

    All inputs are uint32 arrays (broadcastable); returns two uint32 arrays.
    """
    k0 = jnp.asarray(key0, jnp.uint32)
    k1 = jnp.asarray(key1, jnp.uint32)
    k2 = k0 ^ k1 ^ jnp.uint32(_KS_PARITY)
    x0 = jnp.asarray(ctr0, jnp.uint32) + k0
    x1 = jnp.asarray(ctr1, jnp.uint32) + k1

    ks = (k0, k1, k2)
    for r in range(rounds):
        x0 = x0 + x1
        x1 = _rotl(x1, _ROTATIONS[r % 8])
        x1 = x1 ^ x0
        if (r + 1) % 4 == 0:
            inject = (r + 1) // 4
            x0 = x0 + ks[inject % 3]
            x1 = x1 + ks[(inject + 1) % 3] + jnp.uint32(inject)
    return x0, x1


def uniform_from_bits(bits, lo: float = 0.0, hi: float = 1.0):
    """Map uint32 bits to float32 uniform in [lo, hi).

    Uses the top 24 bits so every value is exactly representable in f32,
    mirroring curand_uniform's granularity (reference src/random.cu:7-12 then
    scales to [min, max)).
    """
    # uint32 -> int32 -> f32: values are < 2^24 so the int32 hop is lossless
    # and lowers to a plain signed conversion in every backend.
    u01 = (bits >> jnp.uint32(8)).astype(jnp.int32).astype(jnp.float32) * jnp.float32(
        2**-24
    )
    return u01 * jnp.float32(hi - lo) + jnp.float32(lo)


def initial_ids(seed: int, slots):
    """64-bit genealogy ids for initial particles at global slots `slots`."""
    s = jnp.asarray(slots, jnp.uint32)
    return threefry2x32(jnp.uint32(seed), jnp.uint32(GOLDEN), jnp.zeros_like(s), s)


def step_draws(seed, id_hi, id_lo, poisson_step, mob_step, lo=0.0, hi=1.0,
               rounds: int = 20):
    """One Threefry block per particle per mobility step yields BOTH the
    collision uniform (reference: collider's single randFloat(state, 0, 100),
    src/particle_move.cu:57) and — if the particle ionizes — the child's
    64-bit genealogy id.  The cipher is a bijection of (key, ctr), so the
    child id inherits full-entropy uniqueness at zero extra cost.

    Returns (uniform, child_hi, child_lo).
    """
    b0, b1 = threefry2x32(
        id_hi ^ jnp.uint32(seed), id_lo, jnp.asarray(poisson_step, jnp.uint32),
        jnp.asarray(mob_step, jnp.uint32), rounds=rounds,
    )
    return uniform_from_bits(b0, lo, hi), b1, b0 ^ jnp.uint32(GOLDEN)


def step_uniform(seed, id_hi, id_lo, poisson_step, mob_step, lo=0.0, hi=1.0,
                 rounds: int = 20):
    """Collision uniform only (see step_draws)."""
    return step_draws(
        seed, id_hi, id_lo, poisson_step, mob_step, lo, hi, rounds=rounds
    )[0]


def pair_draws(seed, id_hi, id_lo, poisson_step, t_even, lo=0.0, hi=1.0,
               rounds: int = 20):
    """``rng_mode="block2"``: ONE Threefry block serves a PAIR of mobility
    steps (t_even, t_even + 1).  Returns two (uniform, child_hi, child_lo)
    triples.

    Derivation (pure function of (id, poisson_step, pair base), so every
    cadence/shard/engine agrees bit-exactly — same contract as step_draws):

      block (b0, b1) = threefry(key=(id_hi^seed, id_lo), ctr=(p, t_even))
      even step:  u from b0;  child id = (b1,          b0 ^ GOLDEN)
      odd  step:  u from b1;  child id = (b0 + GOLDEN, b1 ^ GOLDEN)

    ``child_lo ^ GOLDEN`` recovers the payload that produced u for BOTH
    parities.  The two
    children of a double-splitting parent can never collide: equal ids would
    need b1 == b0 + GOLDEN and b0 == b1 simultaneously.  Statistical
    quality: both draws and both ids are disjoint output words of one
    20-round-class cipher block — the same independence argument as Salmon
    et al.'s multiple-streams usage; the trade is that a parent's odd-step
    draw shares bits with its even-step child's id, which correlates nothing
    observable (the child's own stream is a fresh cipher keyed by its id).
    """
    t0 = jnp.asarray(t_even, jnp.uint32)
    b0, b1 = threefry2x32(
        jnp.asarray(id_hi, jnp.uint32) ^ jnp.uint32(seed), id_lo,
        jnp.asarray(poisson_step, jnp.uint32), t0, rounds=rounds,
    )
    g = jnp.uint32(GOLDEN)
    even = (uniform_from_bits(b0, lo, hi), b1, b0 ^ g)
    odd = (uniform_from_bits(b1, lo, hi), b0 + g, b1 ^ g)
    return even, odd


def step_draws_mode(mode, seed, id_hi, id_lo, poisson_step, mob_step,
                    lo=0.0, hi=1.0, rounds: int = 20):
    """Per-step draws under the configured ``rng_mode``.

    "perstep" is the original step_draws (one block per step).  "block2"
    computes the step's pair block and selects by parity (one cipher per
    step, correct for scalar or vector ``mob_step``)."""
    if mode == "perstep":
        return step_draws(
            seed, id_hi, id_lo, poisson_step, mob_step, lo, hi, rounds=rounds
        )
    if mode != "block2":
        raise ValueError(f"unknown rng_mode {mode!r}")
    t = jnp.asarray(mob_step, jnp.uint32)
    even, odd = pair_draws(
        seed, id_hi, id_lo, poisson_step, t & jnp.uint32(0xFFFFFFFE),
        lo, hi, rounds=rounds,
    )
    is_odd = (t & jnp.uint32(1)) == jnp.uint32(1)
    return tuple(jnp.where(is_odd, o, e) for e, o in zip(even, odd))


def setup_uniform(id_hi, id_lo, axis, lo, hi):
    """Uniform draw for initial particle placement along one axis.

    (Reference: setup_particles draws 3 floats per slot,
    src/particle_move.cu:12-15.)
    """
    b0, _ = threefry2x32(
        id_hi, id_lo, jnp.uint32(SETUP_CTR), jnp.asarray(axis, jnp.uint32)
    )
    return uniform_from_bits(b0, lo, hi)


def setup_gaussian(id_hi, id_lo, axis):
    """Standard-normal draw per slot for thermal velocity initialization
    (SimConfig.init_vth; a new-framework extension — the reference's initial
    velocities are zero).  Box–Muller over a counter stream disjoint from
    the position draws (axis+8 vs axis 0..2 under the same SETUP_CTR), keyed
    by genealogy id so the values are shard- and order-independent."""
    b0, b1 = threefry2x32(
        id_hi, id_lo, jnp.uint32(SETUP_CTR), jnp.asarray(axis + 8, jnp.uint32)
    )
    # clamp away u1 = 0 (log(0) = -inf); 2^-25 is below the 24-bit draw's
    # granularity so no other value is affected
    u1 = jnp.maximum(uniform_from_bits(b0), jnp.float32(2**-25))
    u2 = uniform_from_bits(b1)
    r = jnp.sqrt(jnp.float32(-2.0) * jnp.log(u1))
    return r * jnp.cos(jnp.float32(2.0 * _PI) * u2)


_PI = 3.141592653589793
