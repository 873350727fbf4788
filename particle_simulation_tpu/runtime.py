"""Host-side simulation driver: the run_pic() equivalent of the reference's
runPIC (src/pic.cu:359-599).

The host owns only the outer Poisson loop (as in the reference,
src/pic.cu:487): per iteration it launches one jitted device program
(grid phase + whole mobility phase + compaction) and copies back a handful of
scalars for metrics / early exit — the same two-4-byte-copies-per-step
boundary profile as the reference (SURVEY.md §3.1).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, List, Optional

import jax.numpy as jnp
import numpy as np

from . import cross_section
from .config import SimConfig
from .state import SimState, setup_particles
from .ops.step import poisson_step


@dataclasses.dataclass
class StepMetrics:
    step: int
    n: int
    added: int
    removed: int
    wall_s: float
    overflow: bool
    pushes: float = 0.0


@dataclasses.dataclass
class RunData:
    """Mirror of the reference's RunData/TimingData (src/utility.h:16-31)."""

    config: SimConfig
    final_n: int
    total_added: int
    total_removed: int
    device_time_ms: float      # jitted-step wall time (block_until_ready)
    state: Optional[SimState]  # final (compacted) state; the benchmark
    # sweep drops it after recording (2.4 GB of HBM per run at canonical
    # capacity)
    steps: List[StepMetrics]
    last_bucket: int = 0       # final working-capacity bucket (hysteresis
    # seed for subsequent runs at the same config family)

    @property
    def function(self) -> str:
        return {
            "dynamic": "Dynamic", "sync": "CPU Sync",
            "naive": "Naive",
        }[self.config.scheduler]


# Working-capacity ladder: bucket sizes are m * 2^k for m in LADDER.  A
# quarter-step ladder keeps the working prefix within ~1.25-1.6x of the live
# population (vs 2-4x for pure powers of 2) — the grid phase (deposit +
# field gather) and compaction scale with the working prefix, so this is a
# direct step-time win.  Each distinct bucket is one extra compilation
# (shared across T by the traced-scalar protocol).
LADDER = (1.0, 1.25, 1.5, 1.75)
HEADROOM = 1.25


def _bucket_size(n: int, capacity: int, floor: int = 1 << 16) -> int:
    """Smallest ladder bucket >= HEADROOM * n (clamped to capacity)."""
    need = max(int(n * HEADROOM), floor)
    k = max(need.bit_length() - 1, 0)
    for kk in (k, k + 1):
        for m in LADDER:
            w = int(m * (1 << kk))
            if w >= need:
                return min(w, capacity)
    return capacity


def _slice_state(state: SimState, w: int) -> SimState:
    return SimState(
        pos=state.pos[:w], vel=state.vel[:w], acc=state.acc[:w],
        status=state.status[:w], id_hi=state.id_hi[:w], id_lo=state.id_lo[:w],
        n=state.n,
    )


def _pad_state(state: SimState, w: int) -> SimState:
    """Grow the state container to capacity ``w`` with dead (all-zero)
    slots.  After compaction every live particle sits in the prefix, so the
    tail carries no information — zero status is DEAD (population.is_live)."""
    c = state.capacity
    if w <= c:
        return state

    def z(a):
        return jnp.concatenate(
            [a, jnp.zeros((w - c,) + a.shape[1:], a.dtype)], axis=0
        )

    return SimState(
        pos=z(state.pos), vel=z(state.vel), acc=z(state.acc),
        status=z(state.status), id_hi=z(state.id_hi), id_lo=z(state.id_lo),
        n=state.n,
    )


def _merge_state(full: SimState, part: SimState, w: int) -> SimState:
    cat = lambda a, b: jnp.concatenate([a, b[w:]], axis=0)
    return SimState(
        pos=cat(part.pos, full.pos), vel=cat(part.vel, full.vel),
        acc=cat(part.acc, full.acc), status=cat(part.status, full.status),
        id_hi=cat(part.id_hi, full.id_hi), id_lo=cat(part.id_lo, full.id_lo),
        n=part.n,
    )


def _bucketed_step(state, poisson_index, table, config, w_start=0):
    """One Poisson step on the smallest power-of-2 working prefix that holds
    the population with headroom (SURVEY.md §7 'hard parts' (i)).

    If growth overflows the working capacity, the step is simply REDONE at
    the next bucket — physics is a pure function of genealogy, so the retry
    is bit-exact, and dropped-children states are discarded wholesale.
    ``w_start`` (hysteresis from the previous step's successful bucket)
    avoids re-climbing the ladder every step when mid-phase population
    peaks far exceed the step-boundary population (large-T avalanches).
    Returns (state, metrics, w_used).
    """
    n = int(state.n)
    w = max(_bucket_size(n, config.capacity), w_start)
    while True:
        if w >= config.capacity:
            state, metrics = poisson_step(state, poisson_index, table, config)
            return state, metrics, config.capacity
        part = _slice_state(state, w)
        new_part, metrics = poisson_step(
            part, poisson_index, table, config.replace(capacity=w)
        )
        if not bool(metrics["overflow"]):
            return _merge_state(state, new_part, w), metrics, w
        w = _bucket_size(w + 1, config.capacity)  # redo bigger (exact)


def run_pic(
    config: SimConfig,
    table: Optional[jnp.ndarray] = None,
    on_step: Optional[Callable[[int, SimState], None]] = None,
    print_header: bool = True,
    initial_state: Optional[SimState] = None,
    first_poisson_index: int = 0,
    auto_bucket: bool = False,
) -> RunData:
    """Run the full simulation per ``config``; the reference's runPIC.

    ``on_step(t, state)`` is the observability hook (verbose logging /
    PNG snapshots / checkpointing), called every ``config.verbose`` steps
    like the reference's log() (src/utility.cu:124-137).
    """
    if print_header:
        print(
            f"PIC with\ninit n: {config.init_n}\ncapacity: {config.capacity}\n"
            f"poisson steps: {config.poisson_steps}\n"
            f"poisson_timestep: {config.poisson_timestep}\n"
            f"scheduler: {config.scheduler}"
        )
    if table is None:
        table = cross_section.load_table(config.cross_section_path)

    state = setup_particles(config) if initial_state is None else initial_state
    steps: List[StepMetrics] = []
    total_added = 0
    total_removed = 0
    device_s = 0.0

    w_hint = 0
    for t in range(config.poisson_steps):
        if on_step is not None and config.verbose and t % config.verbose == 0:
            on_step(t, state)
        t0 = time.perf_counter()
        if auto_bucket:
            state, metrics, w_hint = _bucketed_step(
                state, jnp.uint32(t + first_poisson_index), table, config,
                w_start=w_hint,
            )
        else:
            state, metrics = poisson_step(
                state, jnp.uint32(t + first_poisson_index), table, config
            )
        n = int(metrics["n"])  # blocks
        dt_wall = time.perf_counter() - t0
        device_s += dt_wall
        m = StepMetrics(
            step=t,
            n=n,
            added=int(metrics["added"]),
            removed=int(metrics["removed"]),
            wall_s=dt_wall,
            overflow=bool(metrics["overflow"]),
            # exact: base-2^30 i32 pair -> Python int -> f64 (< 2^53)
            pushes=float(
                int(metrics["pushes_lo"]) + (int(metrics["pushes_hi"]) << 30)
            ),
        )
        steps.append(m)
        total_added += m.added
        total_removed += m.removed
        if m.overflow:
            print("\n\nOVERFLOW FROM ADDING PARTICLES\n\n")
        if n == 0:
            print("Hit 0")
            break

    # final-state log rides the same cadence gate as the per-step ones: the
    # reference's end-of-run log(verbose, poisson_steps, ...) is a plain
    # log() call whose t % verbose check applies (src/pic.cu:561,
    # src/utility.cu log's early return)
    if (
        on_step is not None
        and config.verbose
        and config.poisson_steps % config.verbose == 0
    ):
        on_step(config.poisson_steps, state)

    final_n = int(state.n)
    if print_header:
        print(f"Final amount of particles: {final_n}")
        print(f"Particles added: {total_added}")
        print(f"Particles removed: {total_removed}")
        print(f"Device time of program: {device_s * 1e3:.3f} ms")
    return RunData(
        config=config,
        final_n=final_n,
        total_added=total_added,
        total_removed=total_removed,
        device_time_ms=device_s * 1e3,
        state=state,
        steps=steps,
        last_bucket=w_hint,
    )


_ROW_CKPT_FIELDS = ("pos", "vel", "acc", "status", "id_hi", "id_lo", "n")
_ROW_METRIC_COLS = (
    "step", "n", "added", "removed", "wall_s", "overflow", "pushes"
)


def _row_ckpt_tag(config: SimConfig) -> str:
    g = "x".join(str(x) for x in config.grid_size)
    return (
        f"{config.scheduler}|{config.poisson_timestep}|{config.seed}|"
        f"{config.init_n}|{config.capacity}|{g}|{config.rng_mode}|"
        f"{config.rng_rounds}"
    )


def _save_row_ckpt(path, config, state, steps, wall_total, done, w_hint):
    """Persist an in-progress benchmark row (atomic replace: an interrupted
    save must leave the previous snapshot intact)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(  # uncompressed: ~1 GB at avalanche buckets, 1-core host
            f,
            tag=np.str_(_row_ckpt_tag(config)),
            wall_total=np.float64(wall_total),
            done=np.int64(done),
            w_hint=np.int64(w_hint),
            **{f"s_{k}": np.asarray(getattr(state, k))
               for k in _ROW_CKPT_FIELDS},
            **{f"m_{c}": np.asarray([getattr(s, c) for s in steps])
               for c in _ROW_METRIC_COLS},
        )
    os.replace(tmp, path)


def _load_row_ckpt(path, config):
    """(state, steps, wall_total, done, w_hint) or None if absent/foreign."""
    if not (path and os.path.exists(path)):
        return None
    try:
        with np.load(path) as z:
            if str(z["tag"]) != _row_ckpt_tag(config):
                return None
            state = SimState(
                **{k: jnp.asarray(z[f"s_{k}"]) for k in _ROW_CKPT_FIELDS}
            )
            cols = {c: z[f"m_{c}"] for c in _ROW_METRIC_COLS}
            steps = [
                StepMetrics(
                    step=int(cols["step"][i]), n=int(cols["n"][i]),
                    added=int(cols["added"][i]),
                    removed=int(cols["removed"][i]),
                    wall_s=float(cols["wall_s"][i]),
                    overflow=bool(cols["overflow"][i]),
                    pushes=float(cols["pushes"][i]),
                )
                for i in range(len(cols["step"]))
            ]
            return (
                state, steps, float(z["wall_total"]), int(z["done"]),
                int(z["w_hint"]),
            )
    except (OSError, ValueError, KeyError):
        return None  # unreadable snapshot: start the row over


def run_pic_device(
    config: SimConfig,
    table: Optional[jnp.ndarray] = None,
    chunk_steps: int = 2,
    w_start: int = 0,
    sync_host: bool = True,
    naive_chunk: int = 0,
    sync_span: int = 0,
    row_ckpt: Optional[str] = None,
) -> RunData:
    """Device-resident run_pic for sweeps/benchmarks: Poisson steps run in
    device-resident chunks (ops/step.poisson_loop) so the per-step host
    round-trip (one dispatch + readback) is paid once per ``chunk_steps``
    instead of per step.

    Capacity bucketing happens between chunks: each chunk executes on the
    smallest power-of-2 working prefix holding the population with headroom,
    and a chunk whose growth overflows its bucket is redone at the next
    bucket — physics is a pure function of genealogy, so the retry is
    bit-exact (same trick as _bucketed_step).

    ``row_ckpt``: crash-resumable rows for long sweeps.  After every
    Poisson step the state + accumulated
    metrics snapshot to this host file (outside the timed windows, so the
    recorded device time is untouched); a relaunched process resumes the
    row from the snapshot instead of restarting it — physics is a pure
    function of (genealogy, absolute Poisson index), so the resumed row is
    bit-exact vs an uninterrupted one (same argument as checkpoint.py's
    resume, tests/test_checkpoint.py).  Deleted once the row completes."""
    from .ops.step import (
        poisson_loop,
        poisson_step_naive_host,
        poisson_step_sync_host,
    )

    if table is None:
        table = cross_section.load_table(config.cross_section_path)
    # CPU Sync runs its generation fixed point as a host loop of bounded
    # dispatches (``sync_host=False`` restores the in-jit while_loop; see
    # poisson_step_sync_host's docstring).
    use_sync_host = sync_host and config.scheduler == "sync"
    # naive_chunk > 0 splits each Naive Poisson step's T-loop into bounded
    # dispatches of that many mobility steps (bit-exact; see
    # poisson_step_naive_host).
    use_naive_host = naive_chunk > 0 and config.scheduler == "naive"
    # The state container lives at BUCKET capacity, not config.capacity:
    # after compaction the tail beyond the working prefix is always dead, so
    # merging back into a full-capacity container preserves nothing but
    # costs 2.4 GB of device memory + a full-container copy per chunk at
    # the canonical 5e7 capacity.
    w0 = _bucket_size(config.init_n, config.capacity)
    state = setup_particles(config.replace(capacity=w0))
    steps: List[StepMetrics] = []
    wall_total = 0.0
    done = 0
    w_hint = min(w_start, config.capacity)
    resumed = _load_row_ckpt(row_ckpt, config)
    if resumed is not None:
        state, steps, wall_total, done, w_hint = resumed
        print(
            f"row resumed from {row_ckpt}: poisson step {done}, "
            f"n={int(state.n)}, {wall_total:.1f}s accumulated",
            flush=True,
        )
    # bucket hysteresis: mid-phase population peaks (ionization
    # avalanches at large T) far exceed the step-boundary population, and a
    # ladder climb costs one DISCARDED run per rung — start each chunk at
    # the last successful bucket instead of re-climbing from n.
    while done < config.poisson_steps:
        k = (
            1
            if (use_sync_host or use_naive_host)
            else min(chunk_steps, config.poisson_steps - done)
        )
        w = max(_bucket_size(int(state.n), config.capacity), w_hint)
        while True:
            state = _pad_state(state, w)
            part = _slice_state(state, w) if w < state.capacity else state
            cfg_w = config.replace(capacity=w)
            t0 = time.perf_counter()
            if use_sync_host or use_naive_host:
                # below config.capacity an overflowed step is redone at the
                # next bucket, so the host loops may stop early; at the TOP
                # bucket overflow is ACCEPTED (children dropped + counted,
                # reference src/pic.cu:544) and the in-jit paths keep
                # simulating — the host loops must too (stop_on_overflow
                # docstrings in ops/step.py)
                retried = w < config.capacity
                if use_sync_host:
                    # sync_span bounds each generation dispatch to that many
                    # mobility steps (bit-exact span-split of the same
                    # compiled loop)
                    final, m1 = poisson_step_sync_host(
                        part, jnp.uint32(done), table, cfg_w,
                        stop_on_overflow=retried, span=sync_span,
                    )
                else:
                    final, m1 = poisson_step_naive_host(
                        part, jnp.uint32(done), table, cfg_w, naive_chunk,
                        stop_on_overflow=retried,
                    )
                metrics = {key: jnp.asarray(v)[None] for key, v in m1.items()}
            else:
                final, metrics = poisson_loop(
                    part, table, cfg_w, k, first_index=done
                )
            final_n = int(final.n)  # forces execution
            wall = time.perf_counter() - t0
            if w < config.capacity and bool(jnp.any(metrics["overflow"])):
                w = _bucket_size(w + 1, config.capacity)
                continue
            break
        if use_sync_host or use_naive_host:
            # DOWNWARD hysteresis: mid-phase reclamation keeps the
            # host-chunked paths' population near the LIVE count, so a
            # bucket inherited from a crash-resume snapshot or an
            # avalanche era can be 10x oversized — decay the hint one
            # rung-halving per step toward the live population instead of
            # pinning at the historical peak forever.  An undershoot just
            # re-climbs (the chunked paths stop early on overflow, so a
            # redo costs only the chunks before the overflow).  The
            # whole-phase dispatch paths keep the sticky hint: their
            # overflow redo costs an entire k-step dispatch.
            w_hint = max(
                _bucket_size(max(final_n, 1), config.capacity),
                _bucket_size(w // 2 + 1, config.capacity),
            )
        else:
            w_hint = w
        wall_total += wall
        lo = [int(x) for x in metrics["pushes_lo"]]
        hi = [int(x) for x in metrics["pushes_hi"]]
        ns = [int(x) for x in metrics["n"]]
        steps += [
            StepMetrics(
                step=done + i,
                n=ns[i],
                added=int(metrics["added"][i]),
                removed=int(metrics["removed"][i]),
                wall_s=wall / k,
                overflow=bool(metrics["overflow"][i]),
                pushes=float(lo[i] + (hi[i] << 30)),
            )
            for i in range(len(ns))
        ]
        state = final  # container stays at bucket capacity (see above)
        done += k
        if row_ckpt and done < config.poisson_steps and final_n > 0:
            _save_row_ckpt(
                row_ckpt, config, state, steps, wall_total, done, w_hint
            )
        if final_n == 0:
            break
    if row_ckpt and os.path.exists(row_ckpt):
        os.remove(row_ckpt)
    return RunData(
        config=config,
        final_n=int(state.n),
        total_added=sum(s.added for s in steps),
        total_removed=sum(s.removed for s in steps),
        device_time_ms=wall_total * 1e3,
        state=state,
        steps=steps,
        last_bucket=w_hint,
    )


def sorted_particle_array(state: SimState) -> np.ndarray:
    """Final particles sorted by the reference's comparison key
    (timestamp, y, x, z, vy, vx, vz — src/electron.h:28-34) for
    scheduler-equivalence comparisons.  Acceleration is carried as payload
    so comparisons cover whole electrons, like the reference's operator==
    (src/electron.h:36-42 via src/test.cu:66-71)."""
    n = int(state.n)
    pos = np.asarray(state.pos)[:n]
    vel = np.asarray(state.vel)[:n]
    acc = np.asarray(state.acc)[:n]
    status = np.asarray(state.status)[:n]
    order = np.lexsort(
        (vel[:, 2], vel[:, 0], vel[:, 1], pos[:, 2], pos[:, 0], pos[:, 1], status)
    )
    return np.concatenate(
        [status[order, None].astype(pos.dtype), pos[order], vel[order],
         acc[order].astype(pos.dtype)],
        axis=1,
    )
