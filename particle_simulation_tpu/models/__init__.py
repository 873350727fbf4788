"""Physics models of the PIC-MCC simulation.

The reference hardcodes one model of each kind; here each is an explicit,
swappable component selected via ``SimConfig``.  The implementations live
in ``ops/`` (physics.py is shared verbatim between the XLA and Pallas
engines; grid.py holds the field paths) — this package documents the model
menu and hosts the one model with its own numerics, the spectral Poisson
solver (``poisson_fft``).

Integrators (``SimConfig.integrator``, ops/physics.INTEGRATORS):

* ``leapfrog`` (default) — the reference's kick-drift-kick with its
  v-minus-a sign convention and frozen per-Poisson-step acceleration
  (src/particle_move.cu:22-39): drift uses the mid-step velocity.
* ``boris`` — Boris push: the full velocity kick is applied first (two
  symmetric half-kicks), then the drift uses the fully-updated velocity.
  The standard PIC integrator for magnetized plasmas; with B=0 it differs
  from leapfrog only in drift phase, making it a genuinely distinct,
  testable model (tests/test_models.py).  A uniform magnetic field is
  supported via ``SimConfig.b_field`` (the signed cyclotron vector
  Ω = qB/m in rad/s; CLI ``bfield=x,y,z``): the standard Boris rotation
  v' = v⁻ + v⁻×t, v⁺ = v⁻ + v'×s with t = Ω·dt/2, s = 2t/(1+|t|²) runs
  between the half-kicks — exactly energy-conserving for pure gyration,
  deterministic and cadence-independent like everything else (the
  rotation constants ride the hoisted kick tuple through every engine).

Collision models (``SimConfig.collision_model``):

One uniform draw per particle-step is tested against energy-bucketed
(split, absorb) chances; energy = |v|^2, log10 bucketing over [1e-6, 1e16)
into 10000 buckets (reference src/particle_move.cu:55-80,
src/cross_section.cu).  Tables are data (cross_section.py); every engine
gathers from the same (N, 2) table.  On ionization the models differ in how
momentum is distributed:

* ``reverse`` (default) — the reference's model: the child is a copy of
  the post-push parent and the parent's velocity reverses
  (src/particle_move.cu:62-74).
* ``isotropic`` — the child is emitted isotropically at the parent's
  speed (direction drawn deterministically from the child's own genealogy
  id bits), the parent keeps its velocity — the common textbook MCC
  secondary model.  All DECISIONS (splits, deaths, genealogy, counts)
  stay exact and cadence-independent; the child-velocity floats involve
  sin/cos whose FMA fusion may differ by ~1 ulp between compiled
  programs, so cross-engine comparisons of velocity payloads use a tight
  tolerance rather than bit equality (tests/test_models.py).

Initialization (``SimConfig.init_vth``):

* ``0.0`` (default) — the reference's zero-velocity start
  (src/particle_move.cu:7-19 modulo its uninitialized-struct quirk).
* ``vth > 0`` — Maxwellian thermal start: each velocity component draws
  vth·N(0,1) from the slot's genealogy stream (rng.setup_gaussian),
  shard- and order-independent like every other draw.

Boundary models (``SimConfig.boundary``):

* ``absorb`` (default) — the reference's kill-at-bounds: an out-of-bounds
  particle dies before the collision roll (src/particle_move.cu:41-52).
* ``periodic`` — positions wrap into [0, size) per axis (the common PIC
  box); deaths come only from absorption collisions.  The wrap guards the
  f32 edge where mod(-eps, s) rounds to s (ops/physics.wrap_periodic).

Field models (``SimConfig.field_model``):

* ``neighbour`` (default) — the reference's nearest-cell count deposition
  + (charge[+1] - charge[-1]) * E_const neighbour difference
  (src/grid_operations.cu); not a true Poisson solve, kept for parity.
  The f32 production path packs the three integer stencil diffs into one
  i32 grid and gathers once per particle
  (ops/grid.gather_acceleration_packdiff, bit-identical);
  gather_acceleration_packed keeps the (cells, 3) row-gather
  variant, and the fused per-particle path (gather_acceleration) serves
  f64 oracle runs.
* ``fft`` — a true spectral Poisson solve (models/poisson_fft.py), the
  flagged fidelity upgrade beyond reference parity.
"""

from ..ops.physics import INTEGRATORS, boris, leapfrog  # noqa: F401
from ..ops.grid import (  # noqa: F401
    deposit,
    gather_acceleration,
    gather_acceleration_packed,
    gather_acceleration_packdiff,
)
from . import poisson_fft  # noqa: F401

COLLISION_MODELS = ("reverse", "isotropic")
FIELD_MODELS = ("neighbour", "fft")
