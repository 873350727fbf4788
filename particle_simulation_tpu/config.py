"""Runtime configuration.

The reference hardcodes physics/domain constants at compile time
(src/cell.h:5-7, src/cell.cu:3-5) and takes 8 positional CLI args
(README.md:21-33, src/main.cu:10-24).  Here both live in one dataclass; the
CLI (cli.py) fills the run-shaped fields and everything else defaults to the
reference's values.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from . import constants


@dataclasses.dataclass(frozen=True)
class SimConfig:
    # ---- run-shaped parameters (the reference's 8-arg CLI contract) ----
    init_n: int = 10_000
    capacity: int = 100_000            # "max n"
    poisson_steps: int = 20            # "max t"
    poisson_timestep: int = 10         # mobility steps per Poisson step
    scheduler: str = "naive"           # naive | sync | dynamic
    verbose: int = 0                   # log cadence (0 = off)
    # lanes per program of the dynamic engine (the reference's threads per
    # block); a power of two
    block_size: int = 256
    sleep_time_ns: int = 0             # accepted for CLI parity; unused

    # ---- physics / domain (reference compile-time constants) ----
    grid_size: Tuple[int, int, int] = constants.DEFAULT_GRID_SIZE
    cell_size: float = constants.DEFAULT_CELL_SIZE
    mobility_dt: float = constants.DEFAULT_MOBILITY_DT
    seed: int = constants.DEFAULT_SEED
    cross_section_path: str = ""       # "" -> bundled sine-modulated table

    # ---- numerics / engine knobs (new-framework-only) ----
    # dtype for positions/velocities: "f32" (production) or "f64" (CPU
    # oracle runs).
    precision: str = "f32"
    # Threefry-2x32 rounds for the per-step draws.  13 is the
    # BigCrush-passing minimum with margin (Salmon et al., SC'11); 20 is the
    # library-conservative choice.  All engines share the value, so any
    # choice is self-consistent and deterministic.
    rng_rounds: int = 13
    # Draw protocol (rng.step_draws_mode): "perstep" = one Threefry block
    # per (particle, mobility step); "block2" = one block per step PAIR
    # (u's from the two output words, child ids from disjoint mixes;
    # rng.pair_draws).  Any fixed choice is deterministic and
    # cadence-independent (tests/test_rng_modes.py); the canonical sweep
    # pins "perstep" (benchmarks.py).
    rng_mode: str = "block2"
    # Physics model selections (models/integrator.py, models/collisions.py):
    # integrator: "leapfrog" (reference parity) | "boris" (zero-B Boris push)
    # collision_model: "reverse" (reference: parent velocity flips) |
    #                  "isotropic" (child emitted isotropically at parent speed)
    integrator: str = "leapfrog"
    collision_model: str = "reverse"
    # Uniform magnetic field for the boris integrator, given as the signed
    # cyclotron vector Ω = qB/m of the tracked species (rad/s).  (0,0,0)
    # keeps the zero-B boris path bit-identical to before the option
    # existed; ignored by the leapfrog (reference-parity) integrator.
    b_field: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    # Domain boundary: "absorb" = reference parity (out-of-bounds kills the
    # particle before the collision roll, src/particle_move.cu:41-52);
    # "periodic" wraps positions into [0, size) — deaths come only from
    # absorption collisions.
    boundary: str = "absorb"
    # Per-axis thermal speed (m/s) for Maxwellian initial velocities
    # (state.setup_particles): each velocity component draws
    # init_vth * N(0, 1) from the slot's genealogy stream.  0.0 = the
    # reference's zero-velocity initialization.
    init_vth: float = 0.0
    # Field model: "neighbour" = reference-parity local charge difference
    # (src/grid_operations.cu:29-56); "fft" = true spectral Poisson solve
    # (models/poisson_fft.py), the flagged fidelity upgrade.
    field_model: str = "neighbour"
    # Bounding-box subgrid edge for the field phase (ops/grid.py round-3
    # notes): the live population stays in a tiny box (dt=1e-12 s means
    # sub-cell displacement per step), so deposit/stencil/gather run on an
    # S^3 window with a bit-identical full-grid fallback.  0 disables.
    bbox_subgrid: int = 64
    # One-hot factorization of the bbox deposit histogram: counts laid out
    # (S^3/lanes, lanes).  The one-hot build cost is (R + lanes) elements
    # per particle (near-square splits minimize it); MACs are invariant.
    bbox_hist_lanes: int = 256
    # Live-prefix chunking for the field phase (ops/grid.py): the deposit
    # histogram and the packed-diff gather run over the whole working
    # prefix w, but compaction keeps every live particle in [0, n), so
    # splitting the particle axis into this many chunks and
    # lax.cond-skipping chunks past n skips the dead tail's histogram tiles
    # and gather rows.  Bit-exact for any value
    # (skipped lanes are dead, whose deposit weight is 0 and whose gathered
    # acc is masked to 0 anyway; tests/test_grid.py).  0 disables.
    grid_live_chunks: int = 0
    # Full-grid deposition strategy when the population does NOT fit the
    # bbox window (periodic/thermal extensions — the reference workload
    # never leaves its seed cube): "scatter" is the XLA .at[].add histogram;
    # "sorted" sorts the flat cell ids and one-hot-histograms each sorted
    # tile into a small grid window (ops/grid.deposit_sorted) — identical
    # counts, with a lax.cond scatter fallback for pathologically sparse tiles.
    full_deposit: str = "scatter"
    # Multi-chip field-phase strategy (parallel/sharded.py): "replicated"
    # psums the per-shard deposit grid; "slab" shards the bbox subgrid into
    # x-slabs (psum_scatter + ppermute halo exchange + all_gather rows):
    # 1/n of the grid memory per device.
    grid_mode: str = "replicated"

    @property
    def sim_size(self) -> Tuple[float, float, float]:
        return tuple(g * self.cell_size for g in self.grid_size)

    @property
    def electric_force_constant(self) -> float:
        return constants.electric_force_constant(self.cell_size)

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)


SCHEDULER_MODES = {
    # reference CLI mode string -> scheduler name (src/main.cu:26-40)
    "30": "dynamic",
    "31": "sync",
    "32": "naive",
}
