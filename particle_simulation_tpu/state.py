"""Simulation state: fixed-capacity structure-of-arrays particle storage.

The reference stores an AoS ``Electron{double3 pos; double3 vel; float3 acc;
int timestamp}`` in a double buffer of 2*capacity (src/electron.h:12-17,
src/pic.cu:422).  Here we use SoA float32 arrays of shape (capacity, 3) /
(capacity,), plus the 64-bit genealogy rng id (see rng.py).  There is no explicit double buffer: compaction is a
functional gather producing new arrays (XLA double-buffers for us).

``n`` is the number of *created* slots (may exceed capacity transiently, like
the reference's atomic counter, src/pic.cu:543-545); live particles are the
slots < min(n, capacity) whose status != DEAD.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import rng
from .config import SimConfig
from .constants import STATUS_ALIVE, STATUS_EMPTY


class SimState(NamedTuple):
    """Pytree of SoA particle arrays (all shape (capacity, ...) )."""

    pos: jax.Array      # (C, 3) f32/f64 — metres
    vel: jax.Array      # (C, 3) f32/f64 — m/s
    acc: jax.Array      # (C, 3) f32    — m/s^2, frozen during a Poisson step
    status: jax.Array   # (C,)  i32    — see constants.py status protocol
    id_hi: jax.Array    # (C,)  u32    — genealogy rng id (high word)
    id_lo: jax.Array    # (C,)  u32
    n: jax.Array        # ()    i32    — created-slot count

    @property
    def capacity(self) -> int:
        return self.status.shape[0]

    @property
    def n_clamped(self) -> jax.Array:
        return jnp.minimum(self.n, self.capacity)


def float_dtype(config: SimConfig):
    return jnp.float64 if config.precision == "f64" else jnp.float32


def zero_state(config: SimConfig) -> SimState:
    c = config.capacity
    fdt = float_dtype(config)
    return SimState(
        pos=jnp.zeros((c, 3), fdt),
        vel=jnp.zeros((c, 3), fdt),
        acc=jnp.zeros((c, 3), jnp.float32),
        status=jnp.full((c,), STATUS_EMPTY, jnp.int32),
        id_hi=jnp.zeros((c,), jnp.uint32),
        id_lo=jnp.zeros((c,), jnp.uint32),
        n=jnp.zeros((), jnp.int32),
    )


def setup_particles(config: SimConfig, slot_offset: int = 0) -> SimState:
    """Seed ``init_n`` electrons uniformly in the 62-cell cube at the domain
    centre (reference setup_particles, src/particle_move.cu:7-19: each axis
    uniform in [(G/2-30)*cell, (G/2+32)*cell)).

    Velocity/acceleration start at zero.  (The reference leaves them
    uninitialized in a local struct — latent UB noted in SURVEY.md §2; the
    surrounding cudaMemset makes 0 the intended value.)

    ``slot_offset`` gives each shard of a multi-chip run a disjoint,
    contiguous global-particle-index range (``i * init_n`` for shard i —
    parallel/sharded.setup_sharded), so genealogy ids never collide across
    shards AND the seeded id multiset of a global workload is independent
    of how many shards it is split across (shard-count invariance).
    """
    st = zero_state(config)
    c, init_n = config.capacity, config.init_n
    if init_n > c:
        raise ValueError(f"init_n {init_n} exceeds capacity {c}")
    fdt = float_dtype(config)

    slots = jnp.arange(c, dtype=jnp.uint32) + jnp.uint32(slot_offset)
    id_hi, id_lo = rng.initial_ids(config.seed, slots)

    axes = []
    for ax in range(3):
        g = config.grid_size[ax]
        # Reference formula assumes a >=62-cell grid; clamp the spawn box to
        # the domain so small test grids don't seed out-of-bounds particles.
        lo = max(0, g // 2 - 30) * config.cell_size
        hi = min(g, g // 2 + 32) * config.cell_size
        axes.append(rng.setup_uniform(id_hi, id_lo, ax, lo, hi).astype(fdt))
    pos = jnp.stack(axes, axis=1)

    active = jnp.arange(c) < init_n
    vel = st.vel
    if config.init_vth:
        # Maxwellian thermal start (new-framework extension): each component
        # is init_vth * N(0,1) from the slot's genealogy stream — shard- and
        # order-independent like every other draw
        vth = jnp.asarray(config.init_vth, fdt)
        vel = jnp.stack(
            [
                vth * rng.setup_gaussian(id_hi, id_lo, ax).astype(fdt)
                for ax in range(3)
            ],
            axis=1,
        )
        vel = jnp.where(active[:, None], vel, 0)
    return st._replace(
        pos=jnp.where(active[:, None], pos, 0),
        vel=vel,
        status=jnp.where(active, STATUS_ALIVE, STATUS_EMPTY).astype(jnp.int32),
        id_hi=jnp.where(active, id_hi, 0),
        id_lo=jnp.where(active, id_lo, 0),
        n=jnp.asarray(init_n, jnp.int32),
    )
