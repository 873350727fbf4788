"""Jitted simulation steps: the vectorized (pure-JAX/XLA) engine.

This is the oracle/reference engine of the new framework: the whole mobility
phase of one Poisson step runs on-device inside one jitted program, as the
reference's Dynamic scheduler keeps the phase inside one kernel launch
(src/pic.cu:70-211 and SURVEY.md §3.1).

Scheduler cadences (see schedulers.py) and the Pallas engine
(ops/gpu_engine.py) produce bit-identical physics because every draw is a
pure function of particle genealogy (rng.py).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from ..config import SimConfig
from ..state import SimState
from . import grid as grid_ops
from . import population
from .physics import Particles


def state_to_particles(state: SimState) -> Particles:
    return Particles(
        px=state.pos[:, 0], py=state.pos[:, 1], pz=state.pos[:, 2],
        vx=state.vel[:, 0], vy=state.vel[:, 1], vz=state.vel[:, 2],
        ax=state.acc[:, 0], ay=state.acc[:, 1], az=state.acc[:, 2],
        status=state.status, id_hi=state.id_hi, id_lo=state.id_lo,
    )


def particles_to_state(state: SimState, p: Particles) -> SimState:
    return state._replace(
        pos=jnp.stack([p.px, p.py, p.pz], axis=1),
        vel=jnp.stack([p.vx, p.vy, p.vz], axis=1),
        acc=jnp.stack([p.ax, p.ay, p.az], axis=1),
        status=p.status, id_hi=p.id_hi, id_lo=p.id_lo,
    )


def make_table_lookup(table: jnp.ndarray):
    from ..cross_section import energy_to_index

    def lookup(energy):
        idx = energy_to_index(energy)
        row = table[idx]
        return row[..., 0], row[..., 1]

    return lookup


def active_mask(status, t):
    """A particle moves at mobility step t iff it is live and was spawned
    before step t (children spawned at t start at t+1; reference
    src/pic.cu:218 `start_t = max(1, timestamp + 1)`)."""
    return population.is_live(status) & (t > jnp.maximum(status, 0))


def grid_phase(state: SimState, config: SimConfig) -> SimState:
    """Deposit charge, compute field at particle cells, store acceleration.

    Replaces resetGrid/particlesToGrid/updateGrid/gridToParticles
    (src/grid_operations.cu) with histogram + fused stencil-gather; the
    acceleration then stays frozen for the whole mobility phase, as in the
    reference (field computed once per Poisson step, src/pic.cu:497-503).
    """
    slot = jnp.arange(state.capacity, dtype=jnp.int32)
    weight = (population.is_live(state.status) & (slot < state.n_clamped)).astype(
        jnp.int32
    )
    if (
        config.bbox_subgrid
        and config.field_model == "neighbour"
        and state.pos.dtype == jnp.float32
    ):
        # bbox subgrid fast path: deposit (one-hot histogram matmul) + stencil
        # + gather all restricted to the live population's bounding box;
        # lax.cond falls back to the full-grid path (bit-identical) when the
        # population outgrows the static window (grid.py round-3 notes).
        acc = grid_ops.bbox_field_acceleration(
            state.pos, weight, config.cell_size, config.grid_size,
            config.electric_force_constant, subgrid=config.bbox_subgrid,
            hist_lanes=config.bbox_hist_lanes,
            # live-prefix chunking (grid_live_chunks > 0): skip deposit
            # tiles and gather chunks past n — every live particle sits in
            # the compacted prefix [0, n), so the skipped lanes are dead
            # and contribute nothing on any path (bit-exact).
            n_live=(state.n_clamped if config.grid_live_chunks else None),
            live_chunks=config.grid_live_chunks,
            full_deposit=config.full_deposit,
        )
        return state._replace(acc=acc)
    charge = grid_ops.deposit_dispatch(
        state.pos, weight, config.cell_size, config.grid_size,
        mode=config.full_deposit,
    )
    acc = field_acceleration(charge, state.pos, weight, config)
    return state._replace(acc=acc)


def field_acceleration(charge, pos, weight, config: SimConfig):
    """Dispatch on the configured field model (config.field_model)."""
    if config.field_model == "fft":
        from ..models.poisson_fft import gather_acceleration_fft

        return gather_acceleration_fft(
            charge, pos, weight, config.cell_size, config.grid_size
        )
    if config.field_model != "neighbour":
        raise ValueError(f"unknown field model {config.field_model!r}")
    if pos.dtype == jnp.float64:
        # f64 oracle runs keep the fused per-particle path (full precision)
        return grid_ops.gather_acceleration(
            charge, pos, weight, config.cell_size, config.grid_size,
            config.electric_force_constant,
        )
    # f32 production path: packed-diff i32 grid + ONE scalar gather
    # (bit-identical to the fused form; grid.py gather_acceleration_packdiff)
    return grid_ops.gather_acceleration_packdiff(
        charge, pos, weight, config.cell_size, config.grid_size,
        config.electric_force_constant,
    )


def _step_config(config: SimConfig) -> SimConfig:
    """Canonicalize the config used as the jitted step's STATIC key: zero
    out every field the step function never reads (run shape, CLI echoes),
    so warm-up runs and sweeps share one compilation.  The whole frozen
    dataclass is the static key — any stray field change would silently
    retrace (the jit default-arg footgun, CLAUDE.md).  ``block_size`` is
    kept for the dynamic engine, whose lanes per program it sets."""
    return config.replace(
        init_n=0,
        poisson_steps=0,
        poisson_timestep=0,   # traced separately as t_steps
        verbose=0,
        block_size=config.block_size if config.scheduler == "dynamic" else 0,
        sleep_time_ns=0,
        cross_section_path="",
    )


def _check_config(config: SimConfig) -> None:
    """Up-front validation of the string-valued knobs: an unknown value
    would otherwise only fail deep inside tracing, or silently pick a
    default branch."""
    if config.rng_mode not in ("perstep", "block2"):
        raise ValueError(f"unknown rng_mode {config.rng_mode!r}")
    if config.full_deposit not in ("scatter", "sorted"):
        raise ValueError(f"unknown full_deposit {config.full_deposit!r}")


def poisson_step(
    state: SimState, poisson_index, table, config: SimConfig
) -> Tuple[SimState, dict]:
    """One full Poisson step: grid phase -> mobility phase (per the
    configured scheduler cadence) -> compaction.

    Mirrors the body of the reference's outer loop (src/pic.cu:487-560).
    Returns (new_state, metrics).

    ``poisson_timestep`` is passed into the compiled program as a traced
    scalar (one compilation serves every mobility-step count — essential
    when the benchmark sweep varies T over 10..1000).
    """
    _check_config(config)
    return _poisson_step_t(
        state,
        poisson_index,
        table,
        jnp.asarray(config.poisson_timestep, jnp.int32),
        _step_config(config),
    )


def poisson_loop(
    state: SimState, table, config: SimConfig, num_steps: int,
    first_index: int = 0,
):
    """Run ``num_steps`` Poisson steps entirely on device (lax.scan): one
    dispatch for the whole run, per-step metrics returned as stacked arrays.

    The production/benchmark path — the host loop in runtime.run_pic exists
    for observability hooks and early exit; this one trades those for zero
    host round-trips.  A zero population short-circuits each remaining step
    through a no-op branch (the reference breaks out of the loop,
    src/pic.cu:556-559).

    ``poisson_timestep`` and ``first_index`` are traced and the config is
    canonicalized BEFORE the jit boundary, so one compilation per
    (engine, capacity-bucket, num_steps) serves every T of a sweep.
    """
    _check_config(config)
    return _poisson_loop_jit(
        state,
        table,
        jnp.asarray(config.poisson_timestep, jnp.int32),
        jnp.asarray(first_index, jnp.int32),
        _step_config(config),
        num_steps,
    )


@functools.partial(jax.jit, static_argnames=("cfg", "num_steps"))
def _poisson_loop_jit(
    state: SimState, table, t_steps, first_index, cfg: SimConfig,
    num_steps: int,
):
    def body(st, idx):
        def live_step(s):
            return _poisson_step_t(s, idx.astype(jnp.uint32), table, t_steps, cfg)

        def dead_step(s):
            zero = jnp.zeros((), jnp.int32)
            return s, {
                "n": zero, "added": zero, "removed": zero,
                "overflow": jnp.zeros((), bool),
                "pushes": jnp.zeros((), jnp.float32),
                "pushes_lo": zero, "pushes_hi": zero,
            }

        return jax.lax.cond(st.n > 0, live_step, dead_step, st)

    indices = jnp.arange(num_steps, dtype=jnp.int32) + first_index
    return jax.lax.scan(body, state, indices)


@functools.partial(jax.jit, static_argnames=("config",))
def _sync_grid_jit(state: SimState, config: SimConfig):
    return grid_phase(state, config)


@functools.partial(jax.jit, static_argnames=("config",))
def _sync_generation_jit(
    state: SimState, poisson_index, table, t_lo, t_hi, gen_lo, gen_hi, lo, hi,
    config: SimConfig,
):
    """One generation SPAN of the CPU Sync fixed point: simulate slots in
    [gen_lo, gen_hi) through mobility steps [t_lo, t_hi).  All loop
    variables are traced, so ONE compilation serves every span of every
    generation of every Poisson step at every T.  Span-splitting a
    fori_loop at the host boundary is bit-exact: the loop body is the same
    compiled program and the carried state round-trips HBM unchanged.
    ``gen_hi`` is pinned by the caller at generation start — children
    appended by earlier spans must NOT join the active range mid-generation
    (they belong to the next generation of the fixed point)."""
    from ..schedulers import _one_step, _push_add

    def body(t, c):
        st, l_, h_ = c
        st, dp = _one_step(st, t, poisson_index, table, config, gen_lo, gen_hi)
        l_, h_ = _push_add(l_, h_, dp)
        return st, l_, h_

    state, lo, hi = jax.lax.fori_loop(t_lo, t_hi, body, (state, lo, hi))
    return state, lo, hi


@functools.partial(jax.jit, static_argnames=("config", "w"))
def _sync_generation_slice_jit(
    state: SimState, poisson_index, table, t_lo, t_hi, gen_lo, gen_len, lo, hi,
    config: SimConfig, w: int,
):
    """A generation restricted to the TAIL SLICE [gen_lo, gen_lo + w) of the
    container.  Every particle of generation >= 2 lives in [gen_lo, n) — the
    children appended by the previous generation — so simulating the whole
    container again is pure waste: the reference's CPU Sync is O(remaining
    steps) per particle (src/pic.cu:214-232 simulateMany from start_t), and
    without slicing the vectorized analog degrades to O(T * container) per
    generation.  ``w`` is a static ladder bucket (few distinct
    compilations); children spawn into the slice tail and the caller retries
    on slice overflow, exactly like the global capacity-ladder protocol.
    Bit-exact: slot order inside the slice preserves the full-array order,
    and draws are keyed by genealogy, not slot (rng.py)."""
    from ..schedulers import _one_step, _push_add

    def sl(a):
        return jax.lax.dynamic_slice_in_dim(a, gen_lo, w, axis=0)

    sub = SimState(
        pos=sl(state.pos), vel=sl(state.vel), acc=sl(state.acc),
        status=sl(state.status), id_hi=sl(state.id_hi), id_lo=sl(state.id_lo),
        n=state.n - gen_lo,
    )

    def body(t, c):
        s, l_, h_ = c
        s, dp = _one_step(s, t, poisson_index, table, config, 0, gen_len)
        l_, h_ = _push_add(l_, h_, dp)
        return s, l_, h_

    sub, lo, hi = jax.lax.fori_loop(t_lo, t_hi, body, (sub, lo, hi))

    def upd(full, part):
        return jax.lax.dynamic_update_slice_in_dim(full, part, gen_lo, axis=0)

    state = SimState(
        pos=upd(state.pos, sub.pos), vel=upd(state.vel, sub.vel),
        acc=upd(state.acc, sub.acc), status=upd(state.status, sub.status),
        id_hi=upd(state.id_hi, sub.id_hi), id_lo=upd(state.id_lo, sub.id_lo),
        n=gen_lo + sub.n,
    )
    return state, lo, hi


@functools.partial(jax.jit, donate_argnums=(0,), static_argnames=("config",))
def _naive_span_jit(
    state: SimState, poisson_index, table, t_lo, t_hi, lo, hi,
    config: SimConfig,
):
    """Naive-cadence mobility steps t in [t_lo, t_hi) over all live slots,
    as ONE bounded dispatch.  Both bounds are traced, so a single
    compilation serves every chunk of every T."""
    from ..schedulers import _one_step, _push_add

    def body(t, c):
        st, l_, h_ = c
        st, dp = _one_step(st, t, poisson_index, table, config, 0, st.n_clamped)
        l_, h_ = _push_add(l_, h_, dp)
        return st, l_, h_

    return jax.lax.fori_loop(t_lo, t_hi, body, (state, lo, hi))


def poisson_step_naive_host(
    state: SimState, poisson_index, table, config: SimConfig, t_chunk: int,
    stop_on_overflow: bool = True,
) -> Tuple[SimState, dict]:
    """One Naive Poisson step with the mobility T-loop split into host-side
    chunks of ``t_chunk`` steps — one bounded dispatch per chunk — instead
    of the whole phase inside a single dispatch (mobility_phase_naive).

    Bit-exact vs the in-jit path: the chunks partition the same fori_loop
    iteration range and physics is a pure function of genealogy (rng.py).

    Chunking bounds each dispatch to ``t_chunk`` mobility steps, as
    poisson_step_sync_host does for the sync fixed point.

    ``stop_on_overflow``: when the caller redoes an overflowed step at a
    bigger bucket anyway (runtime bucket ladder below config.capacity),
    remaining chunks are wasted work and are skipped.  At the TOP bucket
    there is no retry — overflow means children beyond the container are
    dropped and counted (reference semantics, src/pic.cu:544) while the
    existing population keeps simulating — so the caller passes False and
    every chunk runs, keeping this path bit-exact vs mobility_phase_naive's
    single fori_loop in the accepted-overflow regime too.

    Between chunks, DEAD rows are reclaimed (population.reclaim) once the
    container is large: at the canonical T>=600 tails the phase's
    CUMULATIVE appends (~30M+) dwarf the live population (~1M) and the
    un-reclaimed bucket ladder exceeds the largest bucket that fits in
    device memory — reclamation sizes the bucket by live particles
    instead.  Physics-exact (draws are genealogy-keyed);
    the reclaimed count folds into added/removed so metrics stay identical
    to the in-jit path's accounting."""
    cfg = _step_config(config)
    T = int(config.poisson_timestep)
    state = _sync_grid_jit(state, cfg)
    n_start = state.n_clamped
    zero = jnp.zeros((), jnp.int32)
    lo, hi = zero, zero
    reclaimed = zero
    for t0 in range(1, T + 1, t_chunk):
        t1 = min(t0 + t_chunk, T + 1)
        state, lo, hi = _naive_span_jit(
            state, poisson_index, table,
            jnp.asarray(t0, jnp.int32), jnp.asarray(t1, jnp.int32),
            lo, hi, cfg,
        )
        if stop_on_overflow and int(state.n) > state.capacity:
            break  # overflow: the caller redoes at a bigger bucket
        if t1 <= T and int(state.n) <= state.capacity and (
            int(state.n) >= _RECLAIM_MIN
        ):
            state, r = _reclaim_jit(state)
            reclaimed = reclaimed + r
    return _sync_finalize_jit(state, n_start, lo, hi, cfg, reclaimed)


# Containers below this hold so few rows that argsort-compaction between
# host-chunk dispatches cannot pay for itself (and every distinct bucket
# shape would mint a _reclaim_jit compilation).  Tests monkeypatch it to 0
# to force reclamation in tiny configs.
_RECLAIM_MIN = 1 << 20


@functools.partial(jax.jit, donate_argnums=(0,))
def _reclaim_jit(state: SimState):
    return population.reclaim(state)


@functools.partial(jax.jit, static_argnames=("config",))
def _sync_finalize_jit(
    state: SimState, n_start, lo, hi, config: SimConfig, reclaimed=0
):
    """``reclaimed`` — rows dropped by mid-phase reclamation (host-chunked
    paths); folded back into added/removed so metrics are bit-identical to
    the no-reclamation accounting: without reclamation every such row would
    still occupy the container here (n_end = n_end' + R), so
    added = n_end - n_start and removed = n_end - n_final are both restored
    by adding R to the primed quantities."""
    overflow = state.n > state.capacity
    added = state.n_clamped - n_start + reclaimed
    compacted = population.compact(state)
    removed = state.n_clamped - compacted.n + reclaimed
    metrics = {
        "n": compacted.n,
        "added": added,
        "removed": removed,
        "overflow": overflow,
        "pushes": lo.astype(jnp.float32)
        + hi.astype(jnp.float32) * jnp.float32(1 << 30),
        "pushes_lo": lo,
        "pushes_hi": hi,
    }
    return compacted, metrics


def poisson_step_sync_host(
    state: SimState, poisson_index, table, config: SimConfig,
    stop_on_overflow: bool = True, span: int = 0,
) -> Tuple[SimState, dict]:
    """One CPU Sync Poisson step with the generation fixed point run as a
    HOST loop — one bounded dispatch per generation — instead of the in-jit
    ``lax.while_loop`` (schedulers.mobility_phase_sync).

    Bit-exact vs the in-jit path: the generation partitioning is identical
    (gen_lo starts at 0, each generation covers [gen_lo, n_clamped) and
    advances gen_lo to the previous n_clamped) and physics is a pure
    function of genealogy (rng.py), so execution order cannot change draws.

    Each dispatch is bounded, and later generations run on a small tail
    slice of the container instead of the whole of it.

    Early exit on overflow (``stop_on_overflow=True``): children appended
    past capacity are lost, so a caller running below config.capacity redoes
    the step at a bigger bucket anyway (the exact-retry protocol of
    runtime._bucketed_step) — we stop dispatching generations as soon as n
    exceeds capacity and report overflow.  At the TOP bucket there is no
    retry and the in-jit while_loop still consumes every generation within
    the clamped container (mobility_phase_sync: while n_clamped > gen_lo),
    so the caller passes False and this loop does the same.

    ``span`` (mobility steps per dispatch, 0 = whole phase): generation 1
    at canonical scale is a single T-proportional dispatch;
    span-splitting the generation's fori at the host boundary bounds every
    dispatch to ~span mobility steps.  Bit-exact AND compile-free: the
    span bounds are traced scalars to the same compiled loop, so splitting
    only round-trips the carried state through HBM — the per-iteration
    math is the identical program.  Children appended by earlier spans do
    not join the active range (gen_hi is pinned at generation start,
    exactly the fixed point's partitioning).
    """
    from ..runtime import _bucket_size

    cfg = _step_config(config)
    C = state.capacity
    T = int(config.poisson_timestep)
    if span and span > 0:
        t_spans = [(a, min(a + span, T + 1)) for a in range(1, T + 1, span)]
    else:
        t_spans = [(1, T + 1)]
    state = _sync_grid_jit(state, cfg)
    n_start = state.n_clamped
    zero = jnp.zeros((), jnp.int32)
    lo, hi = zero, zero
    gen_lo = 0
    while True:
        n_created = int(state.n)  # one readback per generation
        n_live = min(n_created, C)
        if (stop_on_overflow and n_created > C) or n_live <= gen_lo:
            break
        gen_len = n_live - gen_lo
        room = C - gen_lo
        # generation 1 spans the whole container; later generations run on
        # a small ladder-bucket tail slice (usually the 64k floor).  A
        # clamped (non-ladder) bucket would mint a unique compilation per
        # gen_lo — fall back to the whole-array program instead.
        w = _bucket_size(gen_len, room) if gen_lo > 0 else C
        gl = jnp.asarray(gen_lo, jnp.int32)
        while True:
            if w >= room:
                gh = jnp.asarray(n_live, jnp.int32)
                for a, b in t_spans:
                    state, lo, hi = _sync_generation_jit(
                        state, poisson_index, table,
                        jnp.asarray(a, jnp.int32), jnp.asarray(b, jnp.int32),
                        gl, gh, lo, hi, cfg,
                    )
                break
            # slice path: spans chain on st2 WITHOUT readbacks; a slice
            # overflow is detected at generation end (append drops count
            # into n) and redone from the pre-generation ``state``
            st2, lo2, hi2 = state, lo, hi
            for a, b in t_spans:
                st2, lo2, hi2 = _sync_generation_slice_jit(
                    st2, poisson_index, table,
                    jnp.asarray(a, jnp.int32), jnp.asarray(b, jnp.int32),
                    gl, jnp.asarray(gen_len, jnp.int32), lo2, hi2, cfg, w,
                )
            n2 = int(st2.n)
            if n2 - gen_lo > w:
                # children overflowed the slice window: exact redo on a
                # bigger window (or the whole-array fallback if none fits)
                w = _bucket_size(n2 - gen_lo, room)
                continue
            state, lo, hi = st2, lo2, hi2
            break
        gen_lo = n_live
    return _sync_finalize_jit(state, n_start, lo, hi, cfg)


@functools.partial(jax.jit, static_argnames=("config",))
def _poisson_step_t(
    state: SimState, poisson_index, table, t_steps, config: SimConfig
) -> Tuple[SimState, dict]:
    from ..schedulers import get_mobility_phase

    state = grid_phase(state, config)
    n_start = state.n_clamped

    phase = get_mobility_phase(config.scheduler)
    state, info = phase(state, poisson_index, table, config, t_steps)

    if getattr(phase, "self_compacting", False):
        # the engine already emitted a dense, all-live population
        compacted = state
        added = info["added"]
        removed = n_start + added - compacted.n
        overflow = info["overflow"]
    else:
        overflow = state.n > state.capacity
        added = state.n_clamped - n_start
        compacted = population.compact(state)
        removed = state.n_clamped - compacted.n
    lo, hi = info["pushes_lo"], info["pushes_hi"]
    metrics = {
        "n": compacted.n,
        "added": added,
        "removed": removed,
        "overflow": overflow,
        # legacy f32 view (rounds beyond 2^24); the pair is exact
        "pushes": lo.astype(jnp.float32)
        + hi.astype(jnp.float32) * jnp.float32(1 << 30),
        "pushes_lo": lo,
        "pushes_hi": hi,
    }
    return compacted, metrics
