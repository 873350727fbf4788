"""Generation-pass mobility engine — the ``dynamic`` scheduler.

The reference's Dynamic scheduler (src/pic.cu:19-211) keeps each electron in
registers for every remaining mobility step of the Poisson step and appends
ionized children through a global atomic counter.  This engine has that
shape, written as Pallas kernels compiled through Triton:

  * one ``pallas_call`` per *generation*, over blocks of B lanes of a work
    list (``SimConfig.block_size`` lanes, the reference's BLOCK_SIZE).
    Generation 1 is the population; generation k+1 is the children that
    generation k spawned;
  * each program loads its lanes once and runs them through steps
    ``start..T`` in a loop, calling the shared ``ops.physics.
    update_particles`` (so every draw stays keyed by genealogy, rng.py) —
    the state is read and written once per generation instead of once per
    mobility step, as in the ``naive`` cadence;
  * a child spawned at step t is appended to the next generation's log with
    status t (it starts at t+1): a block-local exclusive ``cumsum`` ranks
    the spawning lanes and one ``atomic_add`` reserves their range;
  * lanes still alive at T are appended the same way to the *done log*,
    which is the compacted next population — so the engine is
    ``self_compacting`` and ``poisson_step`` skips its compaction pass;
  * pushes (lane-steps advanced) are counted per program into an output
    vector and summed outside the kernel into the exact base-2^30 pair.

Slot order depends on the order in which blocks win the atomics, so it may
differ between runs on the GPU; the physics does not, and correctness is the
sorted-multiset comparison against the ``sync`` oracle (tests).

Overflow follows the self-compacting protocol (schedulers.py): children
beyond the work log, or survivors beyond the done log, are dropped but
counted, and ``overflow`` is raised so the capacity ladder redoes the step
one bucket up (runtime._bucketed_step).  At the top bucket
(``config.capacity``) there is no redo: which children and survivors are
dropped depends on the order in which blocks win the atomics, as in the
reference's Dynamic, so a run that overflows there is not reproducible on
the GPU.  Runs that never overflow at the top bucket are.

The kernels compile for the GPU (``jax.default_backend() == "gpu"``) and run
in the Pallas interpreter on the CPU, which is how the tests reach them; any
other backend is an error rather than a silent interpreter run.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..config import SimConfig
from ..constants import STATUS_ALIVE
from ..cross_section import energy_to_index
from ..schedulers import _push_add
from ..state import SimState
from . import population
from .physics import Particles, make_kick, update_particles
from .step import active_mask

# The exact push sum splits each per-program count into 8-bit digits; the
# digit sums stay below 2^31 while there are fewer programs than this.
_MAX_PROGRAMS = 1 << 23


def kernel_route() -> bool:
    """True to run the kernels in the Pallas interpreter.

    The GPU compiles them through Triton; the CPU (the test platform)
    interprets them.  Any other backend raises: the engine never runs the
    interpreter behind a device's back."""
    backend = jax.default_backend()
    if backend == "gpu":
        return False
    if backend == "cpu":
        return True
    raise RuntimeError(
        f"scheduler 'dynamic' has no kernel for backend {backend!r}: it "
        "compiles for 'gpu' through Triton and interprets on 'cpu'; use "
        "scheduler 'naive' or 'sync' there"
    )


def check_block_size(block_size: int) -> None:
    """Triton blocks are powers of two (and at least one warp's width of
    int32 lanes is useful); reject anything else up front."""
    if block_size < 16 or block_size & (block_size - 1):
        raise ValueError(
            f"block_size={block_size} must be a power of two >= 16 for the "
            "dynamic engine (it is the number of lanes per program)"
        )


def num_warps(block_size: int) -> int:
    """Warps per program: two lanes per thread, at most 8 warps."""
    return max(1, min(8, block_size // 64))


def _load_particles(log, lane_c) -> Particles:
    """Gather B lanes of a SimState-layout log (pos/vel/acc flattened)."""
    pos, vel, acc, status, id_hi, id_lo = log
    three = 3 * lane_c
    return Particles(
        px=pos[three], py=pos[three + 1], pz=pos[three + 2],
        vx=vel[three], vy=vel[three + 1], vz=vel[three + 2],
        ax=acc[three], ay=acc[three + 1], az=acc[three + 2],
        status=status[lane_c], id_hi=id_hi[lane_c], id_lo=id_lo[lane_c],
    )


def _append(out, p: Particles, mask, ctr_ref, ctr_index, cap):
    """Append the ``mask`` lanes of ``p`` to log ``out``: rank them with a
    block-local exclusive cumsum, reserve a range with one atomic add, store
    the lanes that fit below ``cap`` (the rest are dropped but counted)."""
    m = mask.astype(jnp.int32)
    k = jnp.sum(m)
    rank = jnp.cumsum(m) - m

    @pl.when(k > 0)
    def _():
        base = plgpu.atomic_add(ctr_ref, ctr_index, k)
        dest = base + rank
        ok = mask & (dest < cap)
        # masked-off lanes point past the end: the GPU never touches them,
        # and the interpreter's scatter drops them instead of letting a
        # stale read-back race a real store to the same slot
        dest = jnp.where(ok, dest, cap)
        pos, vel, acc, status, id_hi, id_lo = out
        three = 3 * dest
        for ref, vals in (
            (pos, (p.px, p.py, p.pz)),
            (vel, (p.vx, p.vy, p.vz)),
            (acc, (p.ax, p.ay, p.az)),
        ):
            for j, v in enumerate(vals):
                plgpu.store(ref.at[three + j], v, mask=ok)
        plgpu.store(status.at[dest], p.status, mask=ok)
        plgpu.store(id_hi.at[dest], p.id_hi, mask=ok)
        plgpu.store(id_lo.at[dest], p.id_lo, mask=ok)


def _generation_kernel(scal_ref, table_ref, *refs, config: SimConfig,
                       block: int, src_cap: int, next_cap: int, done_cap: int):
    src = refs[0:6]
    # refs[6:19] are the aliased inputs of the outputs below
    done = refs[19:25]
    nxt = refs[25:31]
    ctr_ref = refs[31]
    pushes_ref = refs[32]

    pid = pl.program_id(0)
    poisson_step = scal_ref[0].astype(jnp.uint32)
    t_steps = scal_ref[1]
    count = scal_ref[2]
    pushes_ref[pid] = jnp.int32(0)

    @pl.when(pid * block < count)
    def _():
        lane = pid * block + jax.lax.iota(jnp.int32, block)
        valid = lane < count
        p = _load_particles(src, jnp.minimum(lane, src_cap - 1))
        live = valid & population.is_live(p.status)
        # the acceleration is frozen for the phase, so the kick is a loop
        # constant (same expression as the per-step form: bit-exact)
        kick = make_kick(
            config.integrator, (p.ax, p.ay, p.az), config.mobility_dt,
            p.vx.dtype, b_field=config.b_field,
        )

        def lookup(energy):
            idx = 2 * energy_to_index(energy)
            return table_ref[idx], table_ref[idx + 1]

        # first step any lane of the block runs: children stamped s start
        # at s + 1, the population (ALIVE) at 1
        start = jnp.where(live, jnp.maximum(p.status, 0) + 1, t_steps + 1)
        t0 = jnp.min(start)

        def cond(carry):
            t, _p, _pushes, n_live = carry
            return (t <= t_steps) & (n_live > 0)

        def body(carry):
            t, p, pushes, _n = carry
            active = valid & active_mask(p.status, t)
            res = update_particles(
                p, active=active, t=t, poisson_step=poisson_step,
                dt=config.mobility_dt, sim_size=config.sim_size,
                split_chance=None, remove_chance=None, seed=config.seed,
                rng_rounds=config.rng_rounds, rng_mode=config.rng_mode,
                integrator=config.integrator,
                collision_model=config.collision_model,
                table_lookup=lookup, kick=kick, boundary=config.boundary,
            )
            _append(nxt, res.child, res.spawn, ctr_ref, 1, next_cap)
            p = res.particles
            n_live = jnp.sum((valid & population.is_live(p.status)).astype(jnp.int32))
            return t + 1, p, pushes + jnp.sum(active.astype(jnp.int32)), n_live

        n0 = jnp.sum(live.astype(jnp.int32))
        _t, p, pushes, _n = jax.lax.while_loop(
            cond, body, (t0, p, jnp.int32(0), n0)
        )
        pushes_ref[pid] = pushes
        survivors = valid & population.is_live(p.status)
        p = p._replace(status=jnp.full_like(p.status, STATUS_ALIVE))
        _append(done, p, survivors, ctr_ref, 0, done_cap)


def _flat(state_like):
    """SimState layout -> the kernel's six refs (pos/vel/acc flattened)."""
    pos, vel, acc, status, id_hi, id_lo = state_like
    return (pos.reshape(-1), vel.reshape(-1), acc.reshape(-1),
            status, id_hi, id_lo)


def _empty_log(cap: int, fdt):
    return (
        jnp.zeros((3 * cap,), fdt), jnp.zeros((3 * cap,), fdt),
        jnp.zeros((3 * cap,), jnp.float32), jnp.zeros((cap,), jnp.int32),
        jnp.zeros((cap,), jnp.uint32), jnp.zeros((cap,), jnp.uint32),
    )


def _generation(src, done, nxt, ctr, table_flat, poisson_step, t_steps, count,
                config: SimConfig):
    """One generation pass: run ``count`` lanes of ``src`` to T, appending
    children to ``nxt`` and survivors to ``done``.  Returns (done, nxt, ctr,
    per-program pushes)."""
    block = config.block_size
    src_cap = src[3].shape[0]
    grid = pl.cdiv(src_cap, block)
    if grid >= _MAX_PROGRAMS:
        raise ValueError(f"{grid} programs exceed the exact push-sum bound")
    kernel = functools.partial(
        _generation_kernel, config=config, block=block, src_cap=src_cap,
        next_cap=nxt[3].shape[0], done_cap=done[3].shape[0],
    )
    scal = jnp.stack([
        jnp.asarray(poisson_step).astype(jnp.int32),
        jnp.asarray(t_steps, jnp.int32),
        jnp.asarray(count, jnp.int32),
    ])
    outs = tuple(jax.ShapeDtypeStruct(a.shape, a.dtype) for a in done + nxt)
    out = pl.pallas_call(
        kernel,
        out_shape=outs + (
            jax.ShapeDtypeStruct(ctr.shape, ctr.dtype),
            jax.ShapeDtypeStruct((grid,), jnp.int32),
        ),
        grid=(grid,),
        # done log, next log and counters are appended to in place
        input_output_aliases={8 + i: i for i in range(13)},
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=num_warps(block), num_stages=1
        ),
        interpret=kernel_route(),
        name="dynamic_generation",
    )(scal, table_flat, *src, *done, *nxt, ctr)
    return out[0:6], out[6:12], out[12], out[13]


def exact_push_pair(partials):
    """Sum non-negative i32 per-program counts exactly into the base-2^30
    (lo, hi) pair: 8-bit digit sums cannot overflow below _MAX_PROGRAMS."""
    lo = jnp.zeros((), jnp.int32)
    hi = jnp.zeros((), jnp.int32)
    for shift in (0, 8, 16, 24):
        s = jnp.sum((partials >> shift) & 255, dtype=jnp.int32)
        low_bits = 30 - shift
        lo, hi = _push_add(lo, hi, (s & ((1 << low_bits) - 1)) << shift)
        hi = hi + (s >> low_bits)
    return lo, hi


def mobility_phase_dynamic(
    state: SimState, poisson_step, table, config: SimConfig, t_steps
):
    """Generation passes to a fixed point; returns (compacted_state, info)
    with info = pushes_lo/pushes_hi (exact pair), added (children created,
    dropped ones included) and overflow."""
    if state.pos.dtype != jnp.float32:
        raise ValueError(
            "the dynamic engine is f32-only; use scheduler='sync' or "
            "'naive' for f64 oracle runs"
        )
    check_block_size(config.block_size)
    c = state.capacity
    fdt = state.pos.dtype
    table_flat = table.astype(jnp.float32).reshape(-1)
    ctr = jnp.zeros((2,), jnp.int32)   # [done count, next-log count]
    src = _flat(state[:6])
    done = _empty_log(c, fdt)
    log_a = _empty_log(c, fdt)
    log_b = _empty_log(c, fdt)

    def run(src, done, nxt, ctr, count):
        done, nxt, ctr, partials = _generation(
            src, done, nxt, ctr.at[1].set(0), table_flat, poisson_step,
            t_steps, count, config,
        )
        lo, hi = exact_push_pair(partials)
        return done, nxt, ctr, lo, hi

    done, log_a, ctr, p_lo, p_hi = run(src, done, log_a, ctr, state.n_clamped)

    def account(carry, ctr, lo, hi):
        p_lo, p_hi, children, ovf = carry
        p_lo, p_hi = _push_add(p_lo, p_hi + hi, lo)
        spawned = ctr[1]
        return (p_lo, p_hi, children + spawned, ovf | (spawned > c)), spawned

    acc0, spawned = account(
        (jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32),
         jnp.zeros((), jnp.int32), jnp.zeros((), bool)),
        ctr, p_lo, p_hi,
    )

    # generations ping-pong between the two logs: each pass reads one and
    # appends to the other, then the two swap roles
    def cond(carry):
        return carry[-1] > 0

    def body(carry):
        done, src, dst, ctr, acc, spawned = carry
        done, dst, ctr, lo, hi = run(
            src, done, dst, ctr, jnp.minimum(spawned, c)
        )
        acc, spawned = account(acc, ctr, lo, hi)
        return done, dst, src, ctr, acc, spawned

    done, _a, _b, ctr, acc, _s = jax.lax.while_loop(
        cond, body, (done, log_a, log_b, ctr, acc0, spawned)
    )
    p_lo, p_hi, children, ovf = acc
    n_done = ctr[0]
    pos, vel, accel, status, id_hi, id_lo = done
    new_state = SimState(
        pos=pos.reshape(c, 3), vel=vel.reshape(c, 3), acc=accel.reshape(c, 3),
        status=status, id_hi=id_hi, id_lo=id_lo, n=jnp.minimum(n_done, c),
    )
    info = {
        "pushes_lo": p_lo,
        "pushes_hi": p_hi,
        "added": children,
        "overflow": ovf | (n_done > c),
    }
    return new_state, info


mobility_phase_dynamic.self_compacting = True
