"""Per-particle physics: leapfrog push, bounds kill, Monte-Carlo collision.

One shape-polymorphic implementation over separate component arrays, shared
verbatim by the vectorized pure-JAX path (ops/step.py) and the Pallas engine
(ops/gpu_engine.py) so both are bit-exact.

Reference semantics reproduced:
  * leapfrog kick-drift-kick with v MINUS a*dt/2 (the reference's sign
    convention treats `acceleration` as the force per unit mass on the
    electron from positive neighbour charge; src/particle_move.cu:22-39);
  * out-of-bounds on any axis kills the particle before any collision roll
    (src/particle_move.cu:41-52, called first in updateParticle :83-87);
  * collision: one uniform draw in [0,100); energy = |v|^2 (no 1/2 m);
    log-bucket table lookup; rand < split -> ionize (child = copy of the
    post-push parent with spawn-step stamp, parent velocity reverses);
    elif rand < split+remove -> absorbed (src/particle_move.cu:55-80).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from .. import rng
from ..constants import STATUS_DEAD


class Particles(NamedTuple):
    """Component-wise particle bundle; every field has the same shape."""

    px: jnp.ndarray
    py: jnp.ndarray
    pz: jnp.ndarray
    vx: jnp.ndarray
    vy: jnp.ndarray
    vz: jnp.ndarray
    ax: jnp.ndarray
    ay: jnp.ndarray
    az: jnp.ndarray
    status: jnp.ndarray  # i32
    id_hi: jnp.ndarray   # u32
    id_lo: jnp.ndarray   # u32


class StepResult(NamedTuple):
    particles: Particles     # updated parents (only valid where `active`)
    spawn: jnp.ndarray       # bool: a child was created this step
    child: Particles         # child fields (only valid where `spawn`)


def leapfrog(p: Particles, dt, kick=None) -> Particles:
    fdt = p.vx.dtype
    dt = jnp.asarray(dt, fdt)
    if kick is None:
        kick = make_kick("leapfrog", (p.ax, p.ay, p.az), dt, fdt)
    kx, ky, kz = kick
    vx = p.vx - kx
    vy = p.vy - ky
    vz = p.vz - kz
    px = p.px + vx * dt
    py = p.py + vy * dt
    pz = p.pz + vz * dt
    vx = vx - kx
    vy = vy - ky
    vz = vz - kz
    return p._replace(px=px, py=py, pz=pz, vx=vx, vy=vy, vz=vz)


def boris(p: Particles, dt, kick=None) -> Particles:
    """Boris push.  With zero magnetic field (a 3-tuple kick): full velocity
    kick first (two symmetric half-kicks with no rotation between them),
    then drift with the NEW velocity.  Distinct from the reference's
    leapfrog, which drifts with the mid-step velocity
    (src/particle_move.cu:22-39); same sign convention (v minus a*dt).

    With a uniform magnetic field (``SimConfig.b_field`` nonzero; kick is
    the 9-tuple from make_kick): the standard Boris rotation between the
    half-kicks — v⁻ = v − h; v' = v⁻ + v⁻×t; v⁺ = v⁻ + v'×s with
    s = 2t/(1+|t|²), t = Ω·dt/2; v_new = v⁺ − h — energy-conserving for
    pure gyration (Boris 1970).  ``b_field`` is the signed cyclotron vector
    Ω = qB/m of the tracked species in rad/s; the electric half-kick keeps
    the framework's v−a convention.  Selectable via
    SimConfig.integrator = 'boris'."""
    fdt = p.vx.dtype
    dt = jnp.asarray(dt, fdt)
    if kick is None:
        kick = make_kick("boris", (p.ax, p.ay, p.az), dt, fdt)
    if len(kick) == 9:
        hx, hy, hz, tx, ty, tz, sx, sy, sz = kick
        vmx = p.vx - hx
        vmy = p.vy - hy
        vmz = p.vz - hz
        v1x = vmx + (vmy * tz - vmz * ty)
        v1y = vmy + (vmz * tx - vmx * tz)
        v1z = vmz + (vmx * ty - vmy * tx)
        vx = vmx + (v1y * sz - v1z * sy) - hx
        vy = vmy + (v1z * sx - v1x * sz) - hy
        vz = vmz + (v1x * sy - v1y * sx) - hz
    else:
        vx = p.vx - kick[0]
        vy = p.vy - kick[1]
        vz = p.vz - kick[2]
    px = p.px + vx * dt
    py = p.py + vy * dt
    pz = p.pz + vz * dt
    return p._replace(px=px, py=py, pz=pz, vx=vx, vy=vy, vz=vz)


INTEGRATORS = {"leapfrog": leapfrog, "boris": boris}


def make_kick(integrator: str, acc, dt, fdt, b_field=None):
    """Precompute the integrator's velocity-kick terms from the (frozen)
    acceleration: a*dt/2 per leapfrog half-kick, a*dt for boris.

    The acceleration never changes inside a mobility phase, so these
    products are loop constants; the Pallas engine computes them ONCE
    before its T-loop and passes them via ``update_particles(kick=...)``.
    The expression matches the in-place computation op for op, so hoisting
    is bit-exact.

    ``b_field`` (SimConfig.b_field: the signed cyclotron vector Ω = qB/m,
    rad/s) selects the finite-B boris variant: the return becomes the
    9-tuple (half-kick a·dt/2 ×3, rotation t = Ω·dt/2 ×3, s = 2t/(1+|t|²)
    ×3) consumed by ``boris``.  The B=0 boris path is untouched (a single
    full kick, bit-identical to before the b_field option existed)."""
    dt = jnp.asarray(dt, fdt)
    if (
        integrator == "boris"
        and b_field is not None
        and any(float(b) != 0.0 for b in b_field)
    ):
        half = tuple(a.astype(fdt) * (dt / 2) for a in acc)
        t = tuple(jnp.asarray(b, fdt) * (dt / 2) for b in b_field)
        t2 = t[0] * t[0] + t[1] * t[1] + t[2] * t[2]
        s = tuple(ti * (2.0 / (1.0 + t2)) for ti in t)
        return half + t + s
    scale = dt / 2 if integrator == "leapfrog" else dt
    return tuple(a.astype(fdt) * scale for a in acc)


def out_of_bounds(p: Particles, sim_size) -> jnp.ndarray:
    zero = jnp.zeros((), p.px.dtype)
    if sim_size[0] == sim_size[1] == sim_size[2]:
        # cubic domain (the reference's, src/cell.h:5-7): fold the six
        # compares into min/max reductions — 4 fewer vector ops per step.
        # Exact for finite coords (min < 0 iff any coord < 0, max >= s iff
        # any coord >= s).  NaN
        # caveat: a NaN coordinate poisons min/max, so a particle with one
        # NaN and one genuinely-out-of-bounds coordinate is kept where the
        # per-coordinate form would remove it — both forms keep all-NaN
        # particles (reference behavior: NaN compares false), and finite
        # physics never produces NaN here, so the paths only diverge in a
        # blowup regime that is already undefined.
        s = jnp.asarray(sim_size[0], p.px.dtype)
        m = jnp.minimum(jnp.minimum(p.px, p.py), p.pz)
        big = jnp.maximum(jnp.maximum(p.px, p.py), p.pz)
        return (m < zero) | (big >= s)
    sx, sy, sz = (jnp.asarray(s, p.px.dtype) for s in sim_size)
    return (
        (p.px < zero) | (p.px >= sx)
        | (p.py < zero) | (p.py >= sy)
        | (p.pz < zero) | (p.pz >= sz)
    )


def collision_energy(p: Particles):
    return p.vx * p.vx + p.vy * p.vy + p.vz * p.vz


def wrap_periodic(p: Particles, sim_size) -> Particles:
    """Wrap positions into [0, size) per axis (SimConfig.boundary =
    'periodic').  jnp.mod keeps the divisor's sign, so negatives wrap high;
    the final clip guards the f32 edge case where mod(-eps, s) rounds to s
    exactly (which would index one cell past the grid in deposition)."""
    import numpy as np

    def wrap(x, s):
        d = np.dtype(x.dtype)
        hi = jnp.asarray(np.nextafter(d.type(s), d.type(0)), x.dtype)
        return jnp.clip(jnp.mod(x, jnp.asarray(s, x.dtype)), 0, hi)

    return p._replace(
        px=wrap(p.px, sim_size[0]),
        py=wrap(p.py, sim_size[1]),
        pz=wrap(p.pz, sim_size[2]),
    )


def update_particles(
    p: Particles,
    active,
    t,
    poisson_step,
    dt,
    sim_size,
    split_chance,
    remove_chance,
    seed,
    table_lookup,
    rng_rounds: int = 20,
    rng_mode: str = "perstep",
    integrator: str = "leapfrog",
    collision_model: str = "reverse",
    kick=None,
    boundary: str = "absorb",
) -> StepResult:
    """One mobility step for every lane; inactive lanes pass through.

    ``table_lookup(energy) -> (split, remove)`` is injected so the pure-JAX
    path and the Pallas engine each gather from the table their own way;
    when ``split_chance``/``remove_chance`` are given (pre-gathered) the
    callable may be None.

    ``rng_mode`` selects the draw protocol (rng.step_draws_mode).

    ``integrator``/``collision_model``/``boundary`` are static model
    selections (SimConfig fields), shared by every engine so cadence
    equivalence holds for any choice.  boundary='absorb' is the reference's
    kill-at-bounds (src/particle_move.cu:41-52, checked before the
    collision roll); 'periodic' wraps positions instead — nothing leaves
    the domain, deaths come only from absorption collisions.
    """
    moved = INTEGRATORS[integrator](p, dt, kick)
    if boundary == "periodic":
        moved = wrap_periodic(moved, sim_size)
        in_dom = active
        oob_kill = None
    else:
        oob = out_of_bounds(moved, sim_size)
        in_dom = active & ~oob
        oob_kill = active & oob

    u, child_hi, child_lo = rng.step_draws_mode(
        rng_mode, seed, p.id_hi, p.id_lo, poisson_step, t, 0.0, 100.0,
        rounds=rng_rounds,
    )
    # Lookup energies are gated to ACTIVE lanes: inactive lanes' chances are
    # multiplied out below, and zeroing their energy pins them to table
    # bucket 0, so a stale lane never reads a far row of the table.
    energy = jnp.where(active, collision_energy(moved), 0.0)
    if table_lookup is not None:
        split_chance, remove_chance = table_lookup(energy)
    u = u.astype(split_chance.dtype)
    splits = in_dom & (u < split_chance)
    dies_mcc = in_dom & ~splits & (u < split_chance + remove_chance)
    dies = dies_mcc if oob_kill is None else oob_kill | dies_mcc
    t_i32 = jnp.asarray(t, jnp.int32)

    if collision_model == "reverse":
        # reference model: child = copy of the post-push parent, parent
        # velocity reverses (src/particle_move.cu:62-74)
        child_v = (moved.vx, moved.vy, moved.vz)
        fdt = moved.vx.dtype
        # literal -1 (not a negated constant, which Triton cannot lower)
        flip = jnp.where(splits, jnp.asarray(-1.0, fdt), jnp.asarray(1.0, fdt))
    elif collision_model == "isotropic":
        # child emitted isotropically at the parent's speed (direction drawn
        # deterministically from the child's own genealogy id bits), parent
        # velocity unchanged — a physically-common alternative MCC model
        fdt = moved.vx.dtype
        u1 = rng.uniform_from_bits(child_hi).astype(fdt)
        u2 = rng.uniform_from_bits(child_lo).astype(fdt)
        cos_t = 2.0 * u1 - 1.0
        sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, 0.0))
        phi = (2.0 * jnp.pi) * u2
        speed = jnp.sqrt(collision_energy(moved))
        child_v = (
            speed * sin_t * jnp.cos(phi),
            speed * sin_t * jnp.sin(phi),
            speed * cos_t,
        )
        flip = jnp.ones((), fdt)
    else:
        raise ValueError(f"unknown collision model {collision_model!r}")

    # Child fields are only meaningful on ``spawn`` lanes: every consumer
    # (the engine's masked append, population.append_children's
    # compaction-gather) selects by the spawn mask, so non-spawn lanes carry
    # unmasked per-step values here instead of paying three selects per
    # mobility step.
    child = moved._replace(
        vx=child_v[0],
        vy=child_v[1],
        vz=child_v[2],
        status=jnp.broadcast_to(t_i32, splits.shape),
        id_hi=child_hi,
        id_lo=child_lo,
    )

    # Parent: position/velocity advance where active; velocity flips on split
    # (reverse model); status -> DEAD where killed.
    def sel(new, old):
        return jnp.where(active, new, old)

    parents = p._replace(
        px=sel(moved.px, p.px),
        py=sel(moved.py, p.py),
        pz=sel(moved.pz, p.pz),
        vx=sel(moved.vx * flip, p.vx),
        vy=sel(moved.vy * flip, p.vy),
        vz=sel(moved.vz * flip, p.vz),
        status=jnp.where(dies, jnp.int32(STATUS_DEAD), p.status),
    )
    return StepResult(particles=parents, spawn=splits, child=child)
