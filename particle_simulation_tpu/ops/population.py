"""Dynamic-population machinery under static shapes: spawn append and
dead-particle compaction.

The reference needs four CUDA schedulers + warp-ballot stream compaction
(src/pic.cu:19-357) because it mutates a shared work queue inside kernels.
XLA's functional model replaces all of that with data-parallel primitives:

  * stream compaction = stable argsort on the keep-mask + monotone
    gather (`.at[idx].get(indices_are_sorted=True)`), and spawn append =
    the same compaction of the spawned-children domain, landing in slots
    [n, n+k) in source order.

(The dynamic engine, ops/gpu_engine.py, appends through atomic counters
instead and needs none of this inside its kernels.)

Semantics preserved from the reference:
  * children land in slots [n, n+k) in source order; children beyond
    capacity are dropped but still counted in ``n`` so overflow is
    detectable (src/pic.cu:127-131, 543-545);
  * compaction closes ranks preserving order and resets survivors to ALIVE
    (remove_dead_particles + buffer flip, src/pic.cu:320-357, 491-492) —
    and is deterministic, which the warp-atomic original is not.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..constants import STATUS_ALIVE, STATUS_EMPTY
from ..state import SimState
from .physics import Particles


def is_live(status) -> jnp.ndarray:
    """Slots holding a live particle (alive-from-start or spawned-this-step)."""
    return (status == STATUS_ALIVE) | (status > 0)


def compaction_perm(mask):
    """(perm, k): stable permutation placing mask's True indices first (in
    order); k = number of Trues.  perm[:k] is strictly increasing."""
    perm = jnp.argsort(jnp.where(mask, 0, 1).astype(jnp.int8), stable=True)
    k = jnp.sum(mask, dtype=jnp.int32)
    return perm.astype(jnp.int32), k


def _sorted_take(arr, idx, unique=False):
    """Gather with genuinely non-decreasing indices.

    Callers must sanitize idx to be non-decreasing — the flags are promises
    to XLA, not hints.
    """
    return arr.at[idx].get(indices_are_sorted=True, unique_indices=unique,
                           mode="promise_in_bounds")


def append_children(state: SimState, spawn, child: Particles) -> SimState:
    """Place this step's children at slots [n, n+k) in source order.

    f32 fast path: packed row gather over a spawn window written with
    dynamic_update_slice (per-step spawn counts are small); falls back to
    the full-width gather when the window or tail headroom is exceeded.
    """
    import jax.lax as lax

    if state.pos.dtype != jnp.float32:
        return append_from(state, spawn, child)

    c = state.capacity
    window = min(1 << 17, c)
    perm, k = compaction_perm(spawn)

    def fast(st):
        rank = jnp.arange(window, dtype=jnp.int32)
        src = jnp.where(
            rank < k, _sorted_take(perm, jnp.minimum(rank, c - 1)), c - 1
        )
        packed = jnp.stack(
            [
                lax.bitcast_convert_type(getattr(child, name), jnp.int32)
                for name in child._fields
            ],
            axis=1,
        )
        rows = packed.at[src].get(
            indices_are_sorted=True, mode="promise_in_bounds"
        )
        keep = rank < k
        rows = jnp.where(keep[:, None], rows, 0)
        f32 = lambda cols: lax.bitcast_convert_type(cols, jnp.float32)
        n = st.n
        return st._replace(
            pos=lax.dynamic_update_slice(st.pos, f32(rows[:, 0:3]), (n, 0)),
            vel=lax.dynamic_update_slice(st.vel, f32(rows[:, 3:6]), (n, 0)),
            acc=lax.dynamic_update_slice(st.acc, f32(rows[:, 6:9]), (n, 0)),
            status=lax.dynamic_update_slice(st.status, rows[:, 9], (n,)),
            id_hi=lax.dynamic_update_slice(
                st.id_hi, lax.bitcast_convert_type(rows[:, 10], jnp.uint32), (n,)
            ),
            id_lo=lax.dynamic_update_slice(
                st.id_lo, lax.bitcast_convert_type(rows[:, 11], jnp.uint32), (n,)
            ),
            n=n + k,
        )

    def slow(st):
        return append_from(st, spawn, child)

    if window >= c:
        return slow(state)
    # dynamic_update_slice clamps its start: the window must fit below the
    # capacity or it would smear zeros over the tail.
    ok = (k <= window) & (state.n + window <= c) & (state.n >= 0)
    return lax.cond(ok, fast, slow, state)


def append_from(state: SimState, valid, fields: Particles) -> SimState:
    """Pull valid entries from component arrays (any size >= 1) into slots
    [n, n+k), in source order.  Gather/sort-only, no scatter."""
    c = state.capacity
    s_dom = valid.shape[0]
    perm, k = compaction_perm(valid)
    slot = jnp.arange(c, dtype=jnp.int32)
    dest_rank = slot - state.n
    is_new = (dest_rank >= 0) & (dest_rank < k)
    # perm[:C] suffices: destination ranks are < C (indexing perm by the
    # monotone-unique arange is a sorted gather by construction).
    src = _sorted_take(
        perm,
        jnp.minimum(jnp.arange(c, dtype=jnp.int32), s_dom - 1),
        unique=s_dom >= c,
    )
    src = src[jnp.clip(dest_rank, 0, c - 1)]
    # Sanitize to a non-decreasing sequence: 0s before the new range,
    # ascending valid sources inside it, s_dom-1 after it.
    src_for_dest = jnp.where(
        dest_rank < 0, 0, jnp.where(is_new, src, s_dom - 1)
    )

    def merge1(old, staged):
        g = _sorted_take(staged, src_for_dest)
        return jnp.where(is_new, g.astype(old.dtype), old)

    def merge3(old, sx, sy, sz):
        g = jnp.stack(
            [_sorted_take(sx, src_for_dest), _sorted_take(sy, src_for_dest),
             _sorted_take(sz, src_for_dest)], axis=1
        )
        return jnp.where(is_new[:, None], g.astype(old.dtype), old)

    return state._replace(
        pos=merge3(state.pos, fields.px, fields.py, fields.pz),
        vel=merge3(state.vel, fields.vx, fields.vy, fields.vz),
        acc=merge3(state.acc, fields.ax, fields.ay, fields.az),
        status=merge1(state.status, fields.status),
        id_hi=merge1(state.id_hi, fields.id_hi),
        id_lo=merge1(state.id_lo, fields.id_lo),
        n=state.n + k,
    )


def compact(state: SimState) -> SimState:
    """Drop dead particles, close ranks (stable), reset survivors to ALIVE.

    One packed (C, 11) int32 row gather instead of 11 element gathers
    (status is rebuilt, not gathered).
    """
    import jax.lax as lax

    c = state.capacity
    slot = jnp.arange(c, dtype=jnp.int32)
    live = is_live(state.status) & (slot < state.n_clamped)
    perm, n_new = compaction_perm(live)
    keep = slot < n_new
    # perm[:n_new] is ascending; pin the discarded tail to c-1 so the whole
    # index vector is genuinely non-decreasing.
    src = jnp.where(keep, perm, c - 1)

    if state.pos.dtype != jnp.float32:
        # f64 oracle mode: fields are not 4-byte; use per-field gathers.
        def take(arr):
            g = _sorted_take(arr, src)
            mask = keep[(...,) + (None,) * (arr.ndim - 1)] if arr.ndim > 1 else keep
            return jnp.where(mask, g, jnp.zeros((), arr.dtype))

        return SimState(
            pos=take(state.pos), vel=take(state.vel), acc=take(state.acc),
            status=jnp.where(keep, STATUS_ALIVE, STATUS_EMPTY).astype(jnp.int32),
            id_hi=take(state.id_hi), id_lo=take(state.id_lo), n=n_new,
        )

    b = lambda a: lax.bitcast_convert_type(a, jnp.int32)
    packed = jnp.concatenate(
        [b(state.pos), b(state.vel), b(state.acc),
         b(state.id_hi)[:, None], b(state.id_lo)[:, None]],
        axis=1,
    )
    rows = packed.at[src].get(indices_are_sorted=True, mode="promise_in_bounds")
    rows = jnp.where(keep[:, None], rows, 0)
    f = lambda cols: lax.bitcast_convert_type(cols, jnp.float32)

    return SimState(
        pos=f(rows[:, 0:3]).astype(state.pos.dtype),
        vel=f(rows[:, 3:6]).astype(state.vel.dtype),
        acc=f(rows[:, 6:9]),
        status=jnp.where(keep, STATUS_ALIVE, STATUS_EMPTY).astype(jnp.int32),
        id_hi=lax.bitcast_convert_type(rows[:, 9], jnp.uint32),
        id_lo=lax.bitcast_convert_type(rows[:, 10], jnp.uint32),
        n=n_new,
    )


def reclaim(state: SimState):
    """Mid-phase dead-slot reclamation: drop DEAD rows, close ranks
    (stable), PRESERVE every surviving status verbatim.

    Unlike :func:`compact` (the Poisson-step-boundary compaction, which
    resets survivors to ALIVE), this runs INSIDE a mobility phase, where
    statuses still carry meaning — spawn stamps (>0), ALIVE — so the
    status column is gathered like any
    other field.  Physics is invariant: draws are keyed by particle
    genealogy (rng.py), never by slot, and the final comparison is the
    sorted multiset, so removing dead rows early is unobservable except
    through ``n`` — callers must add the returned count back into their
    added/removed accounting to keep metrics identical to the
    no-reclamation path.

    The reference never does this (its 5e7-slot GPU container absorbs a
    whole phase's cumulative appends, src/pic.cu:127-131); the naive
    cadence's cumulative appends at the canonical T>=800 avalanche can
    exceed the largest bucket that fits in device memory while the live
    population stays ~1M — reclamation keeps the working bucket sized by
    LIVE particles.

    Returns (state, reclaimed) where reclaimed (i32) counts dropped rows.
    """
    import jax.lax as lax

    c = state.capacity
    slot = jnp.arange(c, dtype=jnp.int32)
    # live = ALIVE or spawn-stamped (>0); DEAD and EMPTY rows below n are
    # both reclaimable — exactly the rows the finalize compaction would
    # count in ``removed``, so the accounting transfers one-to-one.
    live = (slot < state.n_clamped) & is_live(state.status)
    perm, n_new = compaction_perm(live)
    reclaimed = state.n_clamped - n_new
    keep = slot < n_new
    src = jnp.where(keep, perm, c - 1)

    if state.pos.dtype != jnp.float32:
        def take(arr):
            g = _sorted_take(arr, src)
            mask = keep[(...,) + (None,) * (arr.ndim - 1)] if arr.ndim > 1 else keep
            return jnp.where(mask, g, jnp.zeros((), arr.dtype))

        out = SimState(
            pos=take(state.pos), vel=take(state.vel), acc=take(state.acc),
            status=jnp.where(
                keep, _sorted_take(state.status, src), STATUS_EMPTY
            ).astype(jnp.int32),
            id_hi=take(state.id_hi), id_lo=take(state.id_lo), n=n_new,
        )
        return out, reclaimed

    b = lambda a: lax.bitcast_convert_type(a, jnp.int32)
    packed = jnp.concatenate(
        [b(state.pos), b(state.vel), b(state.acc),
         state.status[:, None], b(state.id_hi)[:, None],
         b(state.id_lo)[:, None]],
        axis=1,
    )
    rows = packed.at[src].get(indices_are_sorted=True, mode="promise_in_bounds")
    rows = jnp.where(keep[:, None], rows, 0)
    f = lambda cols: lax.bitcast_convert_type(cols, jnp.float32)

    out = SimState(
        pos=f(rows[:, 0:3]).astype(state.pos.dtype),
        vel=f(rows[:, 3:6]).astype(state.vel.dtype),
        acc=f(rows[:, 6:9]),
        # STATUS_EMPTY is 0, which the masked-row zero already encodes
        status=rows[:, 9],
        id_hi=lax.bitcast_convert_type(rows[:, 10], jnp.uint32),
        id_lo=lax.bitcast_convert_type(rows[:, 11], jnp.uint32),
        n=n_new,
    )
    return out, reclaimed
