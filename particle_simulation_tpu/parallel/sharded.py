"""Multi-device particle sharding over a 1-D device mesh.

The reference is single-GPU/single-process (no MPI/NCCL anywhere — SURVEY.md
§2.3, §5.8); its only scaling axis is particle count within one card.  This
module is the framework's distributed story:

  * 1-D device mesh, axis ``dp``; particle arrays sharded along the capacity
    axis; the charge grid computed per-shard then ``psum``-reduced over the
    interconnect (NVLink on a multi-GPU host) so every device holds the
    full (replicated) field — deposition is
    position-indexed, not owner-computes, so particles never migrate;
  * spawn/append/compaction are shard-local (each shard owns a disjoint slot
    range and its own ``n``), so the mobility phase needs **zero**
    communication; the only collective per Poisson step is one integer-grid
    psum plus scalar metric psums;
  * initial genealogy ids are keyed by GLOBAL PARTICLE INDEX (shard i's
    j-th seeded particle is global particle ``i * init_n + j``), NOT by the
    capacity-layout slot — so the id set of a given global workload is
    ``{0 .. total_init_n - 1}`` regardless of how many shards it is split
    across, and shard-count invariance holds: the same global (init_n,
    capacity) run produces the same sorted final multiset at any mesh size
    (tests/test_sharded.py::test_shard_count_invariance).  This mirrors the
    reference's slot-keyed curand streams
    (/root/reference/src/random.cu:3-5), which exist precisely to make the
    execution layout unobservable to the physics.

Weak scaling: capacity and init_n are per-device quantities, multiplied by
the mesh size for the global run (e.g. 1e8 particles over 8 devices is
``capacity_per_shard=12_500_000``).
"""

from __future__ import annotations

import functools
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import SimConfig
from ..state import SimState, setup_particles
from ..ops import grid as grid_ops
from ..ops import population
from ..ops.step import grid_phase  # noqa: F401  (single-chip counterpart)


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), axis_names=("dp",))


def shard_state(state: SimState, mesh: Mesh) -> SimState:
    """Place a host-built state onto the mesh: arrays sharded on the
    capacity axis, per-shard counts stacked into an (n_shards,) vector."""
    sharded = NamedSharding(mesh, P("dp"))
    put = lambda a: jax.device_put(a, sharded)
    return SimState(
        pos=put(state.pos), vel=put(state.vel), acc=put(state.acc),
        status=put(state.status), id_hi=put(state.id_hi), id_lo=put(state.id_lo),
        n=put(state.n),
    )


def setup_sharded(config: SimConfig, mesh: Mesh) -> SimState:
    """Build the initial population directly in sharded form.

    ``config.init_n`` and ``config.capacity`` are PER-SHARD; each shard
    seeds its particles with the contiguous global-particle-index id range
    ``[i * init_n, (i + 1) * init_n)`` — independent of the capacity
    layout, so splitting one global workload across more shards does not
    change the seeded id multiset (shard-count invariance).
    """
    d = mesh.devices.size
    shards = []
    ns = []
    for i in range(d):
        s = setup_particles(config, slot_offset=i * config.init_n)
        shards.append(s)
        ns.append(s.n)
    cat = lambda get: jnp.concatenate([get(s) for s in shards], axis=0)
    stacked = SimState(
        pos=cat(lambda s: s.pos), vel=cat(lambda s: s.vel),
        acc=cat(lambda s: s.acc), status=cat(lambda s: s.status),
        id_hi=cat(lambda s: s.id_hi), id_lo=cat(lambda s: s.id_lo),
        n=jnp.stack(ns),
    )
    return shard_state(stacked, mesh)


def _slab_subgrid_field(idx, weight, origin, config: SimConfig, n_dev: int):
    """Grid-SHARDED field phase on the live population's bounding subgrid
    (the mesh>8 growth path, SURVEY.md §5.8):

      * global bbox via pmin/pmax (uniform across shards);
      * per-shard one-hot-histogram deposit on the S^3 subgrid, then ONE
        ``psum_scatter`` so each device holds only its summed x-slab
        (S/n_dev planes) — half the bytes of a full-grid all-reduce and
        1/n_dev of the grid memory per chip;
      * stencil on the slab with a ``ppermute`` halo exchange of one
        charge plane per neighbour (the unpaired edge chips receive zeros,
        which is exactly the reference's missing-neighbour semantics,
        src/grid_operations.cu:40-53);
      * acceleration slab rows ``all_gather``-ed (position-indexed gather
        needs the full subgrid: particles are slot-sharded, not spatially
        partitioned — the reference population never leaves its seed cube,
        so spatial partitioning would concentrate all work on one chip).

    Exact: integer counts/diffs; f32 conversion exact below 2^24 per cell
    (same bound as the replicated path).  Values are bit-identical to the
    replicated-psum path (tests/test_sharded.py).
    """
    S = config.bbox_subgrid
    sx = S // n_dev
    e_const = config.electric_force_constant

    def acc_fn(_):
        rel = idx - origin[None, :]
        flat = (rel[:, 0] * S + rel[:, 1]) * S + rel[:, 2]
        flat = jnp.where(weight > 0, flat, -1)
        counts = grid_ops._mxu_histogram(flat, S * S * S)
        planes = counts.reshape(S, S * S)
        slab = jax.lax.psum_scatter(
            planes, "dp", scatter_dimension=0, tiled=True
        )  # (sx, S*S) summed x-slab
        # halo exchange: one plane to each neighbour; edge chips get zeros
        halo_lo = jax.lax.ppermute(
            slab[-1:], "dp", [(i, i + 1) for i in range(n_dev - 1)]
        )
        halo_hi = jax.lax.ppermute(
            slab[:1], "dp", [(i + 1, i) for i in range(n_dev - 1)]
        )
        ext = jnp.concatenate([halo_lo, slab, halo_hi], axis=0).reshape(
            sx + 2, S, S
        )
        dx = ext[2:] - ext[:-2]
        mid = ext[1:-1]
        z1 = jnp.zeros((sx, 1, S), jnp.int32)
        dy = (
            jnp.concatenate([mid[:, 1:], z1], axis=1)
            - jnp.concatenate([z1, mid[:, :-1]], axis=1)
        )
        z2 = jnp.zeros((sx, S, 1), jnp.int32)
        dz = (
            jnp.concatenate([mid[:, :, 1:], z2], axis=2)
            - jnp.concatenate([z2, mid[:, :, :-1]], axis=2)
        )
        rows_slab = (
            jnp.stack([dx, dy, dz], axis=-1).reshape(sx * S * S, 3)
            .astype(jnp.float32)
            * jnp.float32(e_const)
        )
        rows = jax.lax.all_gather(rows_slab, "dp", tiled=True)  # (S^3, 3)
        acc = rows.at[jnp.maximum(flat, 0)].get(mode="promise_in_bounds")
        return jnp.where(weight[:, None] > 0, acc, 0.0)

    return acc_fn


@functools.lru_cache(maxsize=None)
def _shardmap_step(mesh: Mesh, config: SimConfig):
    """Build the (unjitted) shard_map Poisson step for a mesh + config.

    ``config`` must be canonicalized (ops.step._step_config) so one build —
    and one compilation of anything jitted around it — serves every T /
    run-shape of a sweep; ``poisson_timestep`` arrives as the TRACED scalar
    ``t_steps``.  Cached so chunked callers reuse one instance (a fresh
    Python callable per chunk would defeat the jit cache and recompile
    every chunk).
    """
    from ..schedulers import get_mobility_phase

    mobility_phase = get_mobility_phase(config.scheduler)
    n_dev = int(mesh.devices.size)
    S = config.bbox_subgrid
    use_slab = (
        config.grid_mode == "slab"
        and S > 0
        and S % max(n_dev, 1) == 0
        and config.field_model == "neighbour"
        and config.precision != "f64"
    )
    if config.grid_mode == "slab" and not use_slab:
        raise ValueError(
            "grid_mode='slab' needs bbox_subgrid % n_devices == 0, the "
            "neighbour field model and f32 precision"
        )

    def per_shard(state: SimState, poisson_index, table, t_steps):
        # state arrays here are the local shard; n is shape (1,)
        state = state._replace(n=state.n[0])

        # ---- grid phase ----
        slot = jnp.arange(state.capacity, dtype=jnp.int32)
        weight = (
            population.is_live(state.status) & (slot < state.n_clamped)
        ).astype(jnp.int32)
        from ..ops.step import field_acceleration

        def replicated_acc(_):
            charge_local = grid_ops.deposit_dispatch(
                state.pos, weight, config.cell_size, config.grid_size,
                mode=config.full_deposit,
            )
            charge = jax.lax.psum(charge_local, "dp")
            return field_acceleration(charge, state.pos, weight, config)

        if use_slab:
            idx = grid_ops.cell_indices(
                state.pos, config.cell_size, config.grid_size
            )
            lo, hi = grid_ops.live_bbox(idx, weight, config.grid_size)
            lo = jax.lax.pmin(lo, "dp")
            hi = jax.lax.pmax(hi, "dp")
            origin = jnp.maximum(lo - 1, 0)
            extent = hi - origin
            gmax = jnp.asarray(config.grid_size, jnp.int32) - 1
            fits = jnp.all(
                (extent <= S - 2) | ((extent <= S - 1) & (hi == gmax))
            )
            acc = jax.lax.cond(
                fits,
                _slab_subgrid_field(idx, weight, origin, config, n_dev),
                replicated_acc,
                0,
            )
        else:
            acc = replicated_acc(0)
        state = state._replace(acc=acc)

        # ---- mobility phase + compaction: fully shard-local ----
        n_start = state.n_clamped
        state, info = mobility_phase(
            state, poisson_index, table, config, t_steps,
        )
        if getattr(mobility_phase, "self_compacting", False):
            added = info["added"]
            removed_local = n_start + added - state.n
            overflow_local = info["overflow"]
        else:
            overflow_local = state.n > state.capacity
            added = state.n_clamped - n_start
            state = population.compact(state)
            removed_local = n_start + added - state.n
        lo, hi = info["pushes_lo"], info["pushes_hi"]

        metrics = {
            "n": jax.lax.psum(state.n, "dp"),
            "added": jax.lax.psum(added, "dp"),
            "removed": jax.lax.psum(removed_local, "dp"),
            "overflow": jax.lax.psum(overflow_local.astype(jnp.int32), "dp") > 0,
            # legacy f32 total; the per-shard (lo, hi) pairs stay sharded
            # vectors so the host can sum them exactly (i32 psum of lo
            # could overflow across shards)
            "pushes": jax.lax.psum(
                lo.astype(jnp.float32)
                + hi.astype(jnp.float32) * jnp.float32(1 << 30),
                "dp",
            ),
            "pushes_lo": lo[None],
            "pushes_hi": hi[None],
        }
        return state._replace(n=state.n[None]), metrics

    return jax.shard_map(
        per_shard,
        mesh=mesh,
        in_specs=(
            SimState(pos=P("dp"), vel=P("dp"), acc=P("dp"), status=P("dp"),
                     id_hi=P("dp"), id_lo=P("dp"), n=P("dp")),
            P(),
            P(),
            P(),
        ),
        out_specs=(
            SimState(pos=P("dp"), vel=P("dp"), acc=P("dp"), status=P("dp"),
                     id_hi=P("dp"), id_lo=P("dp"), n=P("dp")),
            {"n": P(), "added": P(), "removed": P(), "overflow": P(),
             "pushes": P(), "pushes_lo": P("dp"), "pushes_hi": P("dp")},
        ),
        check_vma=False,
    )


@functools.lru_cache(maxsize=None)
def _sharded_step_jit(mesh: Mesh, cfg: SimConfig):
    """Jitted single sharded step (canonicalized cfg, traced T)."""
    return jax.jit(_shardmap_step(mesh, cfg))


def sharded_poisson_step(mesh: Mesh, config: SimConfig):
    """Build the jitted multi-chip Poisson step.

    Returns step(state, poisson_index, table) -> (state, metrics) where the
    state is the sharded layout produced by setup_sharded.

    ``config.grid_mode`` selects the field-phase communication strategy:
    "replicated" (default) deposits per shard on the full grid and psums it;
    "slab" runs the grid-sharded bbox-subgrid path (_slab_subgrid_field)
    with a replicated fallback when the population outgrows the window.
    """
    from ..ops.step import _step_config

    step_jit = _sharded_step_jit(mesh, _step_config(config))
    t_steps = jnp.asarray(config.poisson_timestep, jnp.int32)

    def step(state, poisson_index, table):
        return step_jit(state, poisson_index, table, t_steps)

    return step


@functools.lru_cache(maxsize=None)
def _sharded_loop_jit(mesh: Mesh, cfg: SimConfig, num_steps: int):
    """Device-resident multi-chip Poisson-step chunk: ONE dispatch runs
    ``num_steps`` sharded steps via lax.scan (the multi-chip twin of
    ops/step._poisson_loop_jit).  ``cfg`` is canonicalized; T and the first
    Poisson index are traced, so one compilation per (engine, mesh, bucket,
    num_steps) serves every T of a sweep.  A globally-zero population
    short-circuits remaining steps through a no-op branch."""
    sm = _shardmap_step(mesh, cfg)
    d = int(mesh.devices.size)

    @jax.jit
    def loop(state, table, t_steps, first_index):
        def body(st, idx):
            def live_step(s):
                return sm(s, idx.astype(jnp.uint32), table, t_steps)

            def dead_step(s):
                zero = jnp.zeros((), jnp.int32)
                return s, {
                    "n": zero, "added": zero, "removed": zero,
                    "overflow": jnp.zeros((), bool),
                    "pushes": jnp.zeros((), jnp.float32),
                    "pushes_lo": jnp.zeros((d,), jnp.int32),
                    "pushes_hi": jnp.zeros((d,), jnp.int32),
                }

            return jax.lax.cond(jnp.sum(st.n) > 0, live_step, dead_step, st)

        indices = jnp.arange(num_steps, dtype=jnp.int32) + first_index
        return jax.lax.scan(body, state, indices)

    return loop


def sharded_poisson_loop(state, table, config: SimConfig, mesh: Mesh,
                         num_steps: int, first_index: int = 0):
    from ..ops.step import _step_config

    loop = _sharded_loop_jit(mesh, _step_config(config), num_steps)
    return loop(
        state, table,
        jnp.asarray(config.poisson_timestep, jnp.int32),
        jnp.asarray(first_index, jnp.int32),
    )


@functools.lru_cache(maxsize=None)
def _resize_sharded_jit(mesh: Mesh, c_old: int, w: int, fdt: str):
    """Shard-LOCAL container resize: slice (w < c_old) or zero-pad
    (w > c_old) every shard's block to ``w`` rows.  Runs inside shard_map
    so it provably moves no data between shards — after compaction each
    shard's live particles sit in its local prefix, so the dropped tail is
    dead by construction (same argument as runtime._slice_state /
    _pad_state, per shard)."""

    def local(state: SimState) -> SimState:
        def rs(a):
            if w <= c_old:
                return a[:w]
            pad = jnp.zeros((w - c_old,) + a.shape[1:], a.dtype)
            return jnp.concatenate([a, pad], axis=0)

        return SimState(
            pos=rs(state.pos), vel=rs(state.vel), acc=rs(state.acc),
            status=rs(state.status), id_hi=rs(state.id_hi),
            id_lo=rs(state.id_lo), n=state.n,
        )

    spec = SimState(pos=P("dp"), vel=P("dp"), acc=P("dp"), status=P("dp"),
                    id_hi=P("dp"), id_lo=P("dp"), n=P("dp"))
    return jax.jit(
        jax.shard_map(local, mesh=mesh, in_specs=(spec,), out_specs=spec)
    )


def _resize_sharded(state: SimState, mesh: Mesh, w: int) -> SimState:
    d = int(mesh.devices.size)
    c_old = state.capacity // d
    if w == c_old:
        return state
    fn = _resize_sharded_jit(mesh, c_old, w, str(state.pos.dtype))
    return fn(state)


def run_pic_sharded_device(
    config: SimConfig,
    mesh: Mesh,
    table=None,
    chunk_steps: int = 2,
    w_start: int = 0,
    bucket_floor: int = 1 << 16,
    row_ckpt=None,
):
    """First-class multi-chip run_pic (the sharded twin of
    runtime.run_pic_device): device-resident chunks of ``chunk_steps``
    sharded Poisson steps per dispatch, capacity-ladder bucketing of the
    PER-SHARD container between chunks (with hysteresis), overflow-redo one
    bucket up (bit-exact: physics is a pure function of genealogy), and
    crash-resumable row checkpoints.  Returns runtime.RunData whose
    ``state`` is the sharded layout and whose ``config`` is the per-shard
    config (reference outer loop: /root/reference/src/pic.cu:487-560, here
    run per shard with one grid-psum per step).

    ``bucket_floor`` is the smallest per-shard bucket the ladder may pick
    (runtime._bucket_size's floor): tests use small floors so toy
    populations still exercise bucket transitions.
    """
    from .. import cross_section
    from ..runtime import (
        RunData,
        StepMetrics,
        _bucket_size,
        _load_row_ckpt,
        _save_row_ckpt,
    )

    if table is None:
        table = cross_section.load_table(config.cross_section_path)
    d = int(mesh.devices.size)
    cap = config.capacity  # per shard

    w0 = min(_bucket_size(config.init_n, cap, floor=bucket_floor), cap)
    state = setup_sharded(config.replace(capacity=w0), mesh)
    steps = []
    wall_total = 0.0
    done = 0
    w_hint = min(w_start, cap)
    resumed = _load_row_ckpt(row_ckpt, config) if row_ckpt else None
    if resumed is not None:
        r_state, r_steps, r_wall, r_done, r_hint = resumed
        if r_state.n.shape == (d,):  # snapshot from the same mesh size
            state = shard_state(r_state, mesh)
            steps, wall_total, done, w_hint = r_steps, r_wall, r_done, r_hint
            print(
                f"sharded row resumed from {row_ckpt}: poisson step {done}, "
                f"n={int(np.sum(np.asarray(state.n)))}", flush=True,
            )

    while done < config.poisson_steps:
        k = min(chunk_steps, config.poisson_steps - done)
        n_max = int(np.max(np.asarray(state.n)))
        w = max(min(_bucket_size(n_max, cap, floor=bucket_floor), cap), w_hint)
        while True:
            part = _resize_sharded(state, mesh, w)
            cfg_w = config.replace(capacity=w)
            t0 = time.perf_counter()
            final, metrics = sharded_poisson_loop(
                part, table, cfg_w, mesh, k, first_index=done
            )
            n_final = int(metrics["n"][-1])  # host readback forces execution
            wall = time.perf_counter() - t0
            if w < cap and bool(jnp.any(metrics["overflow"])):
                w = min(_bucket_size(w + 1, cap, floor=bucket_floor), cap)
                continue
            break
        w_hint = w
        wall_total += wall
        # exact pushes: per-shard base-2^30 pairs summed as Python ints
        lo = np.asarray(metrics["pushes_lo"], dtype=np.int64)  # (k, d)
        hi = np.asarray(metrics["pushes_hi"], dtype=np.int64)
        ns = [int(x) for x in metrics["n"]]
        steps += [
            StepMetrics(
                step=done + i,
                n=ns[i],
                added=int(metrics["added"][i]),
                removed=int(metrics["removed"][i]),
                wall_s=wall / k,
                overflow=bool(metrics["overflow"][i]),
                pushes=float(int(lo[i].sum() + (hi[i].sum() << 30))),
            )
            for i in range(len(ns))
        ]
        state = final  # container stays at bucket capacity
        done += k
        if row_ckpt and done < config.poisson_steps and n_final > 0:
            host_state = SimState(
                *(np.asarray(getattr(state, f)) for f in state._fields)
            )
            _save_row_ckpt(
                row_ckpt, config, host_state, steps, wall_total, done, w_hint
            )
        if n_final == 0:
            break
    if row_ckpt and os.path.exists(row_ckpt):
        os.remove(row_ckpt)
    return RunData(
        config=config,
        final_n=int(np.sum(np.asarray(state.n))),
        total_added=sum(s.added for s in steps),
        total_removed=sum(s.removed for s in steps),
        device_time_ms=wall_total * 1e3,
        state=state,
        steps=steps,
        last_bucket=w_hint,
    )


def run_pic_sharded(config: SimConfig, mesh: Mesh, table=None, **kwargs):
    """Multi-chip run_pic, compat surface: returns (state, history) where
    history is a list of per-step metric dicts.  Since round 5 this rides
    the first-class runtime (run_pic_sharded_device: bucket ladder +
    device-resident chunks + overflow redo) — physics is bit-exact vs the
    old per-step host loop, with one history-shape caveat: if the
    population dies mid-chunk, the remaining steps of that chunk appear
    as no-op rows (n=0, added=0) that the old loop's per-step early exit
    never emitted (matching single-chip run_pic_device's behavior)."""
    run = run_pic_sharded_device(config, mesh, table, **kwargs)
    history = [
        {
            "n": s.n, "added": s.added, "removed": s.removed,
            "overflow": int(s.overflow), "pushes": int(s.pushes),
        }
        for s in run.steps
    ]
    return run.state, history
