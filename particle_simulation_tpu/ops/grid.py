"""Charge-grid operations: deposition, field, gather.

Reference (src/grid_operations.cu):
  * particlesToGrid: each particle atomically adds +1 to its cell's charge
    count (:15-26).  Here: one vectorized scatter-add histogram —
    no atomics needed, XLA guarantees deterministic accumulation.
  * updateGrid + gridToParticles: per-cell acceleration = (charge[+1] -
    charge[-1]) per axis * Electric_Force_Constant with missing neighbours
    treated as absent at the boundary (:29-56), then nearest-cell gather
    (:59-72).  We fuse these: the acceleration grid (1.5 GB at 512^3) is
    never materialized — each particle gathers its six neighbour charges
    directly and forms the field in registers.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def cell_indices(pos, cell_size, grid_size):
    """Integer cell coordinates; trunc(pos/cell_size) like the C cast
    (src/grid_operations.cu:20-23).  Positions are in-bounds by protocol
    (grid ops run on freshly compacted, alive particles)."""
    inv = 1.0 / cell_size
    idx = (pos * jnp.asarray(inv, pos.dtype)).astype(jnp.int32)
    # Clamp defensively: an exactly-boundary float could truncate to G.
    maxes = jnp.asarray(grid_size, jnp.int32) - 1
    return jnp.clip(idx, 0, maxes)


def flatten_cells(ix, iy, iz, grid_size):
    gx, gy, gz = grid_size
    return (ix * gy + iy) * gz + iz


def deposit(pos, weight, cell_size, grid_size):
    """Histogram particle counts into a flat (gx*gy*gz,) int32 charge grid.

    ``weight`` is 1 for live particles and 0 for empty/padding slots.
    """
    gx, gy, gz = grid_size
    idx = cell_indices(pos, cell_size, grid_size)
    flat = flatten_cells(idx[:, 0], idx[:, 1], idx[:, 2], grid_size)
    charge = jnp.zeros((gx * gy * gz,), jnp.int32)
    return charge.at[flat].add(weight.astype(jnp.int32))


def deposit_sorted(pos, weight, cell_size, grid_size,
                   window_rows=512, tile_p=2048):
    """Full-grid deposition without the XLA scatter for SPREAD populations:
    sort the flat cell ids, then histogram each sorted
    particle tile into a small one-hot matmul WINDOW of the grid and
    accumulate windows with sequential dynamic-slice adds.

    Why this shape: a one-hot matmul histogram over the whole grid costs
    n * num_cells MACs for ANY factorization (the result size times n), so
    it cannot scale past the bbox window — but after a values-only
    ``lax.sort`` (bitonic: dense compare-exchange, NOT scatter-bound) each
    tile of ``tile_p`` consecutive ids spans only ~tile_p * num_cells / n
    cells, so a window of ``window_rows * 128`` cells covers it and the MAC
    bill drops to n * window (factorization applies per tile).  A uniform
    1M-particle population on 256^3 spans ~17 cells/particle -> ~17k cells
    per 1024-tile, well inside the default 32k window.

    EXACT, weight in {0, 1} (the deposit contract): dead lanes get the
    sentinel id ``num_cells`` which sorts to the end and falls outside
    every window row range; each window's f32 matmul counts <= tile_p hits
    per cell (exact in f32), accumulated in i32.  If any tile's id spread
    exceeds the window (pathologically sparse population), the whole
    deposit lax.cond-falls back to the scatter path — values identical
    either way (tests/test_grid.py::test_deposit_sorted_*).

    Any grouping-based deposit pays the sort, while a dense one-hot
    histogram without grouping pays n * num_cells MACs regardless of
    factorization.  Its time against the scatter on the GPU is not
    measured yet.

    Reference: particlesToGrid's atomic adds
    (/root/reference/src/grid_operations.cu:15-26).
    """
    gx, gy, gz = grid_size
    num_cells = gx * gy * gz
    if num_cells % 128:
        return deposit(pos, weight, cell_size, grid_size)
    W = window_rows * 128
    idx = cell_indices(pos, cell_size, grid_size)
    flat = flatten_cells(idx[:, 0], idx[:, 1], idx[:, 2], grid_size)
    flat = jnp.where(weight > 0, flat, num_cells)

    n = flat.shape[0]
    tiles_n = -(-n // tile_p)
    pad = tiles_n * tile_p - n
    s = jax.lax.sort(
        jnp.concatenate([flat, jnp.full((pad,), num_cells, jnp.int32)])
    )
    tiles = s.reshape(tiles_n, tile_p)
    mins = tiles[:, 0]
    real_max = jnp.max(jnp.where(tiles < num_cells, tiles, -1), axis=1)
    bases = (mins >> 7) << 7
    fits = jnp.all((real_max < 0) | (real_max - bases < W))

    iota_r = jax.lax.broadcasted_iota(jnp.int32, (1, window_rows), 1)
    iota_l = jax.lax.broadcasted_iota(jnp.int32, (1, 128), 1)

    def windowed(_):
        counts_pad = jnp.zeros((num_cells + W,), jnp.int32)

        def body(counts, xs):
            ids, base = xs
            rel = ids - base                      # >= 0 (sorted, base<=min)
            row = (rel >> 7)[:, None]             # sentinel -> row >= rows
            lane = (rel & 127)[:, None]
            oh_r = (row == iota_r).astype(jnp.bfloat16)   # (P, rows)
            oh_l = (lane == iota_l).astype(jnp.bfloat16)  # (P, 128)
            win = jax.lax.dot_general(
                oh_r, oh_l, (((0,), (0,)), ((), ())),
                preferred_element_type=jnp.float32,
            ).astype(jnp.int32).reshape(-1)
            cur = jax.lax.dynamic_slice(counts, (base,), (W,))
            return jax.lax.dynamic_update_slice(counts, cur + win, (base,)), None

        counts_pad, _ = jax.lax.scan(body, counts_pad, (tiles, bases))
        return counts_pad[:num_cells]

    def fallback(_):
        return deposit(pos, weight, cell_size, grid_size)

    return jax.lax.cond(fits, windowed, fallback, 0)


def deposit_dispatch(pos, weight, cell_size, grid_size, mode="scatter"):
    """Full-grid deposit by SimConfig.full_deposit: 'scatter' (the XLA
    .at[].add histogram) or 'sorted' (deposit_sorted; identical counts)."""
    if mode == "sorted":
        return deposit_sorted(pos, weight, cell_size, grid_size)
    return deposit(pos, weight, cell_size, grid_size)


def gather_acceleration(charge_flat, pos, weight, cell_size, grid_size, e_const):
    """Per-particle field: E * (charge at +1 neighbour − charge at −1
    neighbour) along each axis, with out-of-grid neighbours contributing 0.

    Fuses the reference's updateGrid stencil (src/grid_operations.cu:29-56)
    with its gridToParticles gather (:59-72).
    """
    gx, gy, gz = grid_size
    idx = cell_indices(pos, cell_size, grid_size)
    fdt = jnp.float64 if pos.dtype == jnp.float64 else jnp.float32

    def neighbour_charge(axis, delta):
        shifted = idx.at[:, axis].add(delta)
        coord = shifted[:, axis]
        valid = (coord >= 0) & (coord < grid_size[axis])
        c = jnp.clip(coord, 0, grid_size[axis] - 1)
        shifted = shifted.at[:, axis].set(c)
        flat = flatten_cells(shifted[:, 0], shifted[:, 1], shifted[:, 2], grid_size)
        return jnp.where(valid, charge_flat[flat], 0)

    comps = []
    for axis in range(3):
        diff = neighbour_charge(axis, +1) - neighbour_charge(axis, -1)
        comps.append(diff.astype(fdt) * jnp.asarray(e_const, fdt))
    acc = jnp.stack(comps, axis=1).astype(jnp.float32)
    return jnp.where(weight[:, None] > 0, acc, 0.0)


def gather_acceleration_packed(charge_flat, pos, weight, cell_size, grid_size,
                               e_const):
    """Same field as gather_acceleration, computed as: materialize the
    acceleration grid with shifted slices (pure bandwidth, vectorized) then
    ONE packed (n, 3) row gather.

    The fused path does 6 random gathers of (n,) each; this path does one
    ~12-byte-row gather at the cost of a transient (cells, 3) f32 grid.
    """
    gx, gy, gz = grid_size
    acc_grid = field_grid(charge_flat, grid_size, e_const).reshape(-1, 3)
    idx = cell_indices(pos, cell_size, grid_size)
    flat = flatten_cells(idx[:, 0], idx[:, 1], idx[:, 2], grid_size)
    acc = acc_grid.at[flat].get(mode="promise_in_bounds")
    return jnp.where(weight[:, None] > 0, acc, 0.0)


def _int_diffs(charge_flat, grid_size):
    """The updateGrid stencil as INTEGER per-axis neighbour differences
    (charge[+1] - charge[-1], missing neighbours = 0): three i32 grids.
    The acceleration is exactly e_const * diff (src/grid_operations.cu:29-56
    — charge counts are integers, so the stencil is integral)."""
    gx, gy, gz = grid_size
    c = charge_flat.reshape(gx, gy, gz)
    zeros = jnp.zeros_like(c)

    def diff(axis):
        up = jnp.concatenate(
            [jnp.take(c, jnp.arange(1, c.shape[axis]), axis=axis),
             jnp.take(zeros, jnp.arange(1), axis=axis)], axis=axis)
        down = jnp.concatenate(
            [jnp.take(zeros, jnp.arange(1), axis=axis),
             jnp.take(c, jnp.arange(c.shape[axis] - 1), axis=axis)], axis=axis)
        return up - down

    return diff(0), diff(1), diff(2)


_PACK_BIAS = 1 << 9   # 10-bit biased fields: diff in [-512, 511]


def gather_acceleration_packdiff(charge_flat, pos, weight, cell_size,
                                 grid_size, e_const):
    """Fastest f32 field path: pack the three integer stencil diffs into ONE
    i32 grid (10-bit biased fields), gather once per particle, unpack and
    scale in registers.

    Bit-exact to the row-gather path: f32(int diff) is exact below 2^24 and
    the e_const multiply is the same op, so acc values are identical
    (tests/test_grid.py asserts equality).  Falls back via lax.cond to the
    (cells, 3) row gather — same values — in the (physically wild) case that
    some |diff| exceeds the 10-bit field.

    The packed grid is 1/3 the bytes of the (cells, 3) f32 grid on both
    the build and the gather side.
    """
    dx, dy, dz = _int_diffs(charge_flat, grid_size)
    idx = cell_indices(pos, cell_size, grid_size)
    flat = flatten_cells(idx[:, 0], idx[:, 1], idx[:, 2], grid_size)
    lim = _PACK_BIAS - 1
    fits = (
        (jnp.max(jnp.abs(dx)) <= lim)
        & (jnp.max(jnp.abs(dy)) <= lim)
        & (jnp.max(jnp.abs(dz)) <= lim)
    )

    def packed_path(_):
        packed = (
            ((dx + _PACK_BIAS) << 20)
            | ((dy + _PACK_BIAS) << 10)
            | (dz + _PACK_BIAS)
        ).reshape(-1)
        v = packed.at[flat].get(mode="promise_in_bounds")
        mask = (1 << 10) - 1
        d3 = jnp.stack(
            [(v >> 20) - _PACK_BIAS,
             ((v >> 10) & mask) - _PACK_BIAS,
             (v & mask) - _PACK_BIAS],
            axis=1,
        )
        return d3.astype(jnp.float32) * jnp.float32(e_const)

    def rows_path(_):
        acc_grid = (
            jnp.stack([dx, dy, dz], axis=-1).reshape(-1, 3).astype(jnp.float32)
            * jnp.float32(e_const)
        )
        return acc_grid.at[flat].get(mode="promise_in_bounds")

    acc = jax.lax.cond(fits, packed_path, rows_path, 0)
    return jnp.where(weight[:, None] > 0, acc, 0.0)


# ---------------------------------------------------------------------------
# Bounding-box subgrid field phase.
#
# Physics: with mobility dt = 1e-12 s and cell size 1e-2 m, a particle moves
# one cell only at |v| >= 1e10 m/s — so the live population effectively never
# leaves the 62-cell seed cube (src/particle_move.cu:7-19) plus a thin shell.
# The full-grid phase therefore wastes almost all its work: the deposit
# scatters into a 67 MB (256^3) / 512 MB (512^3) grid, the stencil build
# streams the whole grid, and the gather reads it back — while all live
# cells fit in a 64^3 (1 MB) box.
#
# Design:
#   * bbox = min/max cell over live particles (cheap reduction);
#   * deposit into the S^3 subgrid via a one-hot matmul histogram:
#     counts(R=S^3/128, 128) = sum over particle tiles of
#     onehot_row^T @ onehot_lane (bf16 inputs, f32 accumulate, so exact) —
#     the scatter's per-update loop becomes dense matmul work;
#   * stencil + pack + gather reuse the existing packed-diff machinery on
#     the tiny subgrid;
#   * a lax.cond falls back to the full-grid path whenever the bbox does
#     not fit the static S^3 window, so the subgrid is purely an
#     optimization: values are bit-identical (tests/test_grid.py).
# ---------------------------------------------------------------------------


def live_bbox(idx, weight, grid_size):
    """(lo, hi) cell-coordinate bounds over weighted particles.  With no
    live particles lo > hi (lo=grid_size, hi=-1)."""
    live = weight[:, None] > 0
    big = jnp.asarray(grid_size, jnp.int32)
    lo = jnp.min(jnp.where(live, idx, big), axis=0)
    hi = jnp.max(jnp.where(live, idx, -1), axis=0)
    return lo, hi


def _mxu_histogram(flat, num_cells, tile_p=1024, lanes=128, n_live=None):
    """Histogram of ``flat`` ids (invalid entries = -1) over [0, num_cells),
    num_cells a multiple of ``lanes`` (a power of two), via per-tile one-hot
    matmuls with a (num_cells/lanes, lanes) factorization.

    EXACT for any population: each tile's (R, lanes) f32 matmul result
    counts at most tile_p <= 2^24 hits per cell exactly; tiles accumulate
    in f32 within groups of <= 2^14 tiles (group totals < 2^24, still
    exact) and groups fold into an i32 accumulator.

    ``lanes`` trades one-hot BUILD cost against matmul shape: the build
    touches (R + lanes) elements per particle — minimized at the square
    split R = lanes = sqrt(num_cells) — while the MAC count (n * num_cells)
    is factorization-invariant.  At 64^3 the square 512x512 split builds
    1024 elems/particle vs 2176 for 2048x128 and gives the matmul N=512.

    ``n_live`` (traced scalar, optional): every id at slot >= n_live is
    known dead (-1); tiles whose start lies past it lax.cond-skip their
    one-hot build + matmul entirely.  Bit-exact — a skipped tile's ids are
    all -1, which contribute nothing in the dense path either.
    """
    R = num_cells // lanes
    shift = lanes.bit_length() - 1
    n = flat.shape[0]
    tiles = -(-n // tile_p)
    group = min(tiles, 1 << 14)
    groups = -(-tiles // group)
    pad = groups * group * tile_p - n
    fp = jnp.concatenate([flat, jnp.full((pad,), -1, jnp.int32)])
    tiled = fp.reshape(groups, group, tile_p)
    starts = (
        jnp.arange(groups * group, dtype=jnp.int32) * tile_p
    ).reshape(groups, group)
    iota_r = jax.lax.broadcasted_iota(jnp.int32, (1, R), 1)
    iota_l = jax.lax.broadcasted_iota(jnp.int32, (1, lanes), 1)

    def tile_body(acc_f32, xs):
        ids, start = xs

        def dense(acc):
            row = (ids >> shift)[:, None]
            lane = (ids & (lanes - 1))[:, None]
            oh_r = (row == iota_r).astype(jnp.bfloat16)   # (P, R)
            oh_l = (lane == iota_l).astype(jnp.bfloat16)  # (P, lanes)
            return acc + jax.lax.dot_general(
                oh_r, oh_l, (((0,), (0,)), ((), ())),
                preferred_element_type=jnp.float32,
            )

        if n_live is None:
            return dense(acc_f32), None
        return (
            jax.lax.cond(start < n_live, dense, lambda acc: acc, acc_f32),
            None,
        )

    def group_body(acc_i32, xs):
        acc_f32, _ = jax.lax.scan(
            tile_body, jnp.zeros((R, lanes), jnp.float32), xs
        )
        return acc_i32 + acc_f32.astype(jnp.int32), None

    counts, _ = jax.lax.scan(
        group_body, jnp.zeros((R, lanes), jnp.int32), (tiled, starts)
    )
    return counts.reshape(-1)


def _chunked_fetch(fetch, safe, n_live, chunks):
    """Run ``fetch(idx_slice) -> (k, 3) f32`` over ``safe`` split into
    ``chunks`` particle-axis chunks, lax.cond-skipping chunks whose start
    lies past ``n_live`` (their lanes are all dead: the caller masks their
    acc to 0 regardless, so zeros are bit-exact)."""
    w = safe.shape[0]
    if not chunks or chunks <= 1 or n_live is None or w < 2 * chunks:
        return fetch(safe)
    ck = -(-w // chunks)
    outs = []
    for i in range(0, w, ck):
        part = safe[i : i + ck]
        outs.append(
            jax.lax.cond(
                jnp.int32(i) < n_live,
                lambda p=part: fetch(p),
                lambda p=part: jnp.zeros((p.shape[0], 3), jnp.float32),
            )
        )
    return jnp.concatenate(outs)


def _subgrid_packdiff_acc(flat_sub, counts, S, e_const, weight,
                          n_live=None, live_chunks=0):
    """Field values from subgrid counts: packed-diff build + one gather.
    Bit-identical to the full-grid packdiff path restricted to the bbox
    (missing neighbours are 0 either way — empty cells and out-of-grid
    cells both carry zero charge)."""
    dx, dy, dz = _int_diffs(counts, (S, S, S))
    lim = _PACK_BIAS - 1
    fits = (
        (jnp.max(jnp.abs(dx)) <= lim)
        & (jnp.max(jnp.abs(dy)) <= lim)
        & (jnp.max(jnp.abs(dz)) <= lim)
    )
    safe = jnp.maximum(flat_sub, 0)

    def packed_path(_):
        packed = (
            ((dx + _PACK_BIAS) << 20)
            | ((dy + _PACK_BIAS) << 10)
            | (dz + _PACK_BIAS)
        ).reshape(-1)

        def fetch(idx_part):
            v = packed.at[idx_part].get(mode="promise_in_bounds")
            mask = (1 << 10) - 1
            d3 = jnp.stack(
                [(v >> 20) - _PACK_BIAS,
                 ((v >> 10) & mask) - _PACK_BIAS,
                 (v & mask) - _PACK_BIAS],
                axis=1,
            )
            return d3.astype(jnp.float32) * jnp.float32(e_const)

        return _chunked_fetch(fetch, safe, n_live, live_chunks)

    def rows_path(_):
        acc_grid = (
            jnp.stack([dx, dy, dz], axis=-1).reshape(-1, 3).astype(jnp.float32)
            * jnp.float32(e_const)
        )

        def fetch(idx_part):
            return acc_grid.at[idx_part].get(mode="promise_in_bounds")

        return _chunked_fetch(fetch, safe, n_live, live_chunks)

    acc = jax.lax.cond(fits, packed_path, rows_path, 0)
    return jnp.where(weight[:, None] > 0, acc, 0.0)


def bbox_field_acceleration(pos, weight, cell_size, grid_size, e_const,
                            subgrid=64, tile_p=1024, hist_lanes=128,
                            n_live=None, live_chunks=0,
                            full_deposit="scatter"):
    """Full field phase (deposit + stencil + gather) on a bbox subgrid when
    the live population fits an S^3 window; falls back to the full-grid
    scatter + packdiff path (bit-identical values) otherwise.

    Replaces the reference's resetGrid/particlesToGrid/updateGrid/
    gridToParticles sequence (src/grid_operations.cu) for the production
    f32 path.

    ``n_live``/``live_chunks``: optional live-prefix chunking — compaction
    keeps live particles in slots [0, n_live), so deposit tiles and gather
    chunks past it are skipped (SimConfig.grid_live_chunks).  Bit-exact:
    every skipped lane is dead (weight 0), contributing nothing to the
    histogram and having its acc masked to 0 on every path.
    """
    S = subgrid
    assert (S * S * S) % 128 == 0, "subgrid edge must be a multiple of 8"
    idx = cell_indices(pos, cell_size, grid_size)
    lo, hi = live_bbox(idx, weight, grid_size)
    origin = jnp.maximum(lo - 1, 0)
    ext = hi - origin
    gmax = jnp.asarray(grid_size, jnp.int32) - 1
    # containment + a zero-charge margin on the high side (or the global
    # boundary, where missing neighbours contribute 0 in the reference too)
    fits = jnp.all((ext <= S - 2) | ((ext <= S - 1) & (hi == gmax)))

    def subgrid_path(_):
        rel = idx - origin[None, :]
        flat_sub = (rel[:, 0] * S + rel[:, 1]) * S + rel[:, 2]
        flat_sub = jnp.where(weight > 0, flat_sub, -1)
        counts = _mxu_histogram(
            flat_sub, S * S * S, tile_p=tile_p, lanes=hist_lanes,
            n_live=n_live,
        )
        return _subgrid_packdiff_acc(
            flat_sub, counts, S, e_const, weight,
            n_live=n_live, live_chunks=live_chunks,
        )

    def full_path(_):
        charge = deposit_dispatch(
            pos, weight, cell_size, grid_size, mode=full_deposit
        )
        return gather_acceleration_packdiff(
            charge, pos, weight, cell_size, grid_size, e_const
        )

    return jax.lax.cond(fits, subgrid_path, full_path, 0)


def field_grid(charge_flat, grid_size, e_const):
    """Materialize the full acceleration grid (gx,gy,gz,3) float32 — the
    reference's updateGrid output.  Used by tests and diagnostics only; the
    hot path uses gather_acceleration_packdiff."""
    dx, dy, dz = _int_diffs(charge_flat, grid_size)
    return jnp.stack([dx, dy, dz], axis=-1).astype(jnp.float32) * jnp.float32(
        e_const
    )
