"""Grid ops (ops/grid.py) vs a straightforward numpy re-derivation of the
reference semantics (src/grid_operations.cu)."""

import jax.numpy as jnp
import numpy as np

from particle_simulation_tpu.constants import electric_force_constant
from particle_simulation_tpu.ops import grid as g


GRID = (8, 8, 8)
CELL = 0.5


def np_reference(pos, weight):
    """Straight numpy transliteration of the *spec*: count per cell, then
    acc = E*(c[+1]-c[-1]) per axis with absent neighbours = 0."""
    charge = np.zeros(GRID, np.int64)
    idx = (pos / CELL).astype(np.int64)
    for p, w in zip(idx, weight):
        if w:
            charge[tuple(p)] += 1
    e = electric_force_constant(CELL)
    acc = np.zeros(pos.shape, np.float64)
    for k, (p, w) in enumerate(zip(idx, weight)):
        if not w:
            continue
        for ax in range(3):
            up = p.copy(); up[ax] += 1
            dn = p.copy(); dn[ax] -= 1
            c_up = charge[tuple(up)] if up[ax] < GRID[ax] else 0
            c_dn = charge[tuple(dn)] if dn[ax] >= 0 else 0
            acc[k, ax] = (c_up - c_dn) * e
    return charge, acc


def test_deposit_and_gather_match_numpy_reference():
    rng = np.random.default_rng(0)
    n = 500
    pos = rng.uniform(0, GRID[0] * CELL * 0.999, (n, 3)).astype(np.float32)
    weight = (rng.uniform(size=n) < 0.8).astype(np.int32)

    charge_np, acc_np = np_reference(pos.astype(np.float64), weight)
    charge = g.deposit(jnp.asarray(pos), jnp.asarray(weight), CELL, GRID)
    np.testing.assert_array_equal(
        np.asarray(charge).reshape(GRID), charge_np
    )
    acc = g.gather_acceleration(
        charge, jnp.asarray(pos), jnp.asarray(weight), CELL, GRID,
        electric_force_constant(CELL),
    )
    np.testing.assert_allclose(np.asarray(acc), acc_np, rtol=1e-6)


def test_dead_slots_do_not_deposit():
    pos = jnp.zeros((4, 3), jnp.float32)
    weight = jnp.asarray([1, 0, 0, 1], jnp.int32)
    charge = g.deposit(pos, weight, CELL, GRID)
    assert int(charge.sum()) == 2
    assert int(charge[0]) == 2  # both live particles in cell (0,0,0)


def test_gather_matches_full_field_grid():
    rng = np.random.default_rng(1)
    n = 200
    pos = rng.uniform(0, GRID[0] * CELL * 0.999, (n, 3)).astype(np.float32)
    weight = np.ones(n, np.int32)
    e = electric_force_constant(CELL)
    charge = g.deposit(jnp.asarray(pos), jnp.asarray(weight), CELL, GRID)
    acc = g.gather_acceleration(
        charge, jnp.asarray(pos), jnp.asarray(weight), CELL, GRID, e)
    field = np.asarray(g.field_grid(charge, GRID, e))
    idx = (pos / CELL).astype(np.int64)
    np.testing.assert_allclose(
        np.asarray(acc), field[idx[:, 0], idx[:, 1], idx[:, 2]], rtol=1e-6
    )


def test_field_direction_sign():
    """A lone charge at cell (4,4,4): the cell below it in x (3,4,4) sees
    positive x-field contribution (charge at its +1 neighbour), the cell
    above (5,4,4) sees negative — reference updateGrid sign convention
    (src/grid_operations.cu:40-43)."""
    charge = jnp.zeros((8 * 8 * 8,), jnp.int32)
    charge = charge.at[g.flatten_cells(4, 4, 4, GRID)].set(3)
    field = np.asarray(g.field_grid(charge, GRID, 1.0))
    assert field[3, 4, 4, 0] == 3.0
    assert field[5, 4, 4, 0] == -3.0
    assert field[4, 3, 4, 1] == 3.0
    assert field[4, 4, 5, 2] == -3.0
    assert field[4, 4, 4, 0] == 0.0


def test_packdiff_bit_exact_and_fallback():
    """gather_acceleration_packdiff must equal the row-gather path BIT-FOR-BIT
    on both its branches: packed (small diffs) and the lax.cond fallback
    (some |diff| >= 512)."""
    rng = np.random.default_rng(2)
    n = 400
    e = electric_force_constant(CELL)
    pos = rng.uniform(0, GRID[0] * CELL * 0.999, (n, 3)).astype(np.float32)
    weight = (rng.uniform(size=n) < 0.9).astype(np.int32)
    charge = g.deposit(jnp.asarray(pos), jnp.asarray(weight), CELL, GRID)

    ref = g.gather_acceleration_packed(
        charge, jnp.asarray(pos), jnp.asarray(weight), CELL, GRID, e)
    new = g.gather_acceleration_packdiff(
        charge, jnp.asarray(pos), jnp.asarray(weight), CELL, GRID, e)
    np.testing.assert_array_equal(np.asarray(new), np.asarray(ref))

    # force the fallback: one cell holds 1000 charge -> |diff| = 1000 > 511
    big = charge.at[g.flatten_cells(4, 4, 4, GRID)].add(1000)
    ref2 = g.gather_acceleration_packed(
        big, jnp.asarray(pos), jnp.asarray(weight), CELL, GRID, e)
    new2 = g.gather_acceleration_packdiff(
        big, jnp.asarray(pos), jnp.asarray(weight), CELL, GRID, e)
    np.testing.assert_array_equal(np.asarray(new2), np.asarray(ref2))
    # and that the fused per-particle path agrees too (spec anchor)
    fused2 = g.gather_acceleration(
        big, jnp.asarray(pos), jnp.asarray(weight), CELL, GRID, e)
    np.testing.assert_array_equal(np.asarray(fused2), np.asarray(new2))


def _full_path_acc(pos, weight, cell, grid, e):
    charge = g.deposit(jnp.asarray(pos), jnp.asarray(weight), cell, grid)
    return g.gather_acceleration_packdiff(
        charge, jnp.asarray(pos), jnp.asarray(weight), cell, grid, e)


def test_mxu_histogram_matches_scatter_deposit():
    rng = np.random.default_rng(3)
    n = 3000
    flat = rng.integers(0, 16 * 16 * 16, n).astype(np.int32)
    flat[rng.uniform(size=n) < 0.2] = -1  # invalid (dead) slots
    counts = g._mxu_histogram(jnp.asarray(flat), 16 * 16 * 16, tile_p=256)
    ref = np.bincount(flat[flat >= 0], minlength=16 * 16 * 16)
    np.testing.assert_array_equal(np.asarray(counts), ref)
    # every lanes factorization is the same exact histogram
    for lanes in (64, 256, 512, 1024):
        alt = g._mxu_histogram(
            jnp.asarray(flat), 16 * 16 * 16, tile_p=256, lanes=lanes
        )
        np.testing.assert_array_equal(np.asarray(alt), ref)


def test_bbox_field_bit_exact_clustered():
    """Clustered population (subgrid path taken): values must equal the
    full-grid packdiff path bit-for-bit."""
    rng = np.random.default_rng(4)
    grid = (64, 64, 64)
    n = 2000
    e = electric_force_constant(CELL)
    # cluster inside cells [20, 30)^3
    pos = rng.uniform(20 * CELL, 30 * CELL, (n, 3)).astype(np.float32)
    weight = (rng.uniform(size=n) < 0.9).astype(np.int32)
    ref = _full_path_acc(pos, weight, CELL, grid, e)
    got = g.bbox_field_acceleration(
        jnp.asarray(pos), jnp.asarray(weight), CELL, grid, e, subgrid=16)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_bbox_field_bit_exact_fallback():
    """Spread-out population (bbox exceeds the window): the lax.cond
    fallback must produce the identical full-grid values."""
    rng = np.random.default_rng(5)
    grid = (64, 64, 64)
    n = 2000
    e = electric_force_constant(CELL)
    pos = rng.uniform(0, 64 * CELL * 0.999, (n, 3)).astype(np.float32)
    weight = np.ones(n, np.int32)
    ref = _full_path_acc(pos, weight, CELL, grid, e)
    got = g.bbox_field_acceleration(
        jnp.asarray(pos), jnp.asarray(weight), CELL, grid, e, subgrid=16)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_bbox_field_at_global_boundaries():
    """Populations touching the global grid boundary: missing neighbours
    contribute 0 exactly like the reference (src/grid_operations.cu:40-53);
    the subgrid margin logic must reproduce that bit-for-bit."""
    rng = np.random.default_rng(6)
    grid = (64, 64, 64)
    e = electric_force_constant(CELL)
    for lo_cell, hi_cell in [(0, 10), (54, 64), (0, 14)]:
        pos = rng.uniform(
            lo_cell * CELL, hi_cell * CELL * 0.9999, (800, 3)
        ).astype(np.float32)
        weight = np.ones(800, np.int32)
        ref = _full_path_acc(pos, weight, CELL, grid, e)
        got = g.bbox_field_acceleration(
            jnp.asarray(pos), jnp.asarray(weight), CELL, grid, e, subgrid=16)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_live_prefix_chunking_bit_exact():
    """grid_live_chunks (VERDICT r4 grid-phase attack): with every live
    particle in the prefix [0, n_live), deposit tiles and gather chunks
    past it are lax.cond-skipped — outputs must be bit-equal for n_live
    at 0, 1, mid-chunk, chunk-boundary and full-w positions, for chunk
    counts that do and don't divide w."""
    rng = np.random.default_rng(7)
    grid = (64, 64, 64)
    w = 3000
    e = electric_force_constant(CELL)
    pos = jnp.asarray(
        rng.uniform(20 * CELL, 30 * CELL, (w, 3)).astype(np.float32)
    )
    # (n_live, chunks) pairs cover: empty, single-lane, mid-chunk with a
    # non-dividing chunk count, chunk-boundary, and full-w; the full
    # matrix costs ~35 s of CPU compiles, so only the distinct-branch
    # representatives stay (each pair is its own compile)
    for n_live, chunks in ((0, 7), (777, 7), (3000, 16)):
        weight = jnp.asarray(
            (
                (np.arange(w) < n_live) & (rng.uniform(size=w) < 0.9)
            ).astype(np.int32)
        )
        ref = g.bbox_field_acceleration(pos, weight, CELL, grid, e, subgrid=16)
        got = g.bbox_field_acceleration(
            pos, weight, CELL, grid, e, subgrid=16,
            n_live=jnp.int32(n_live), live_chunks=chunks,
        )
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_mxu_histogram_live_prefix_skip_exact():
    rng = np.random.default_rng(8)
    w, cells = 2000, 16 * 16 * 16
    flat = rng.integers(0, cells, w).astype(np.int32)
    for n_live in (0, 300, 1024, 2000):
        f = flat.copy()
        f[n_live:] = -1  # the contract: everything past n_live is dead
        ref = np.bincount(f[f >= 0], minlength=cells)
        got = g._mxu_histogram(
            jnp.asarray(f), cells, tile_p=256, n_live=jnp.int32(n_live)
        )
        np.testing.assert_array_equal(np.asarray(got), ref)


def test_live_prefix_chunking_engine_equality(request):
    """End-to-end: a Poisson step with grid_live_chunks on must produce the
    identical state to the default path (the flag is pure skipping)."""
    import jax

    from particle_simulation_tpu import SimConfig
    from particle_simulation_tpu.cross_section import bundled_paths, load_table
    from particle_simulation_tpu.ops.step import poisson_step
    from particle_simulation_tpu.state import setup_particles

    cfg = SimConfig(
        init_n=300, capacity=2048, poisson_steps=2, poisson_timestep=5,
        grid_size=(64, 64, 64), scheduler="naive",
        cross_section_path=bundled_paths()[1],
    )
    table = load_table(cfg.cross_section_path)

    def run(c):
        st = setup_particles(c)
        for t in range(c.poisson_steps):
            st, m = poisson_step(st, jnp.uint32(t), table, c)
        return st, m

    st0, m0 = run(cfg)
    st1, m1 = run(cfg.replace(grid_live_chunks=8))
    assert int(m0["n"]) == int(m1["n"])
    for f in ("pos", "vel", "acc", "status", "id_hi", "id_lo"):
        np.testing.assert_array_equal(
            np.asarray(getattr(st0, f)), np.asarray(getattr(st1, f))
        )


def test_deposit_sorted_matches_scatter_spread():
    """deposit_sorted (sorted-window one-hot histogram) must
    reproduce the scatter histogram EXACTLY on a spread population — the
    workload class (periodic/thermal) where the bbox window never fits."""
    rng = np.random.default_rng(7)
    grid = (32, 32, 32)
    n = 20_000
    pos = rng.uniform(0, grid[0] * CELL * 0.999, (n, 3)).astype(np.float32)
    weight = (rng.uniform(size=n) < 0.9).astype(np.int32)  # dead lanes mixed in
    want = g.deposit(jnp.asarray(pos), jnp.asarray(weight), CELL, grid)
    got = g.deposit_sorted(
        jnp.asarray(pos), jnp.asarray(weight), CELL, grid,
        window_rows=32, tile_p=256,
    )
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_deposit_sorted_sparse_fallback():
    """A population sparser than the window (one particle per far-apart
    cell) must trip the lax.cond fallback and still match scatter."""
    grid = (32, 32, 32)
    n = 64
    # place particles on a coarse lattice spanning the whole grid: each
    # 256-particle tile spans ~the full id range >> any window
    coords = np.stack(np.meshgrid(*[np.arange(4)] * 3), -1).reshape(-1, 3)
    pos = ((coords * 8 + 0.5) * CELL).astype(np.float32)[:n]
    weight = np.ones(n, np.int32)
    want = g.deposit(jnp.asarray(pos), jnp.asarray(weight), CELL, grid)
    got = g.deposit_sorted(
        jnp.asarray(pos), jnp.asarray(weight), CELL, grid,
        window_rows=2, tile_p=32,
    )
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_deposit_sorted_all_dead_and_full_grid_end():
    """Sentinel handling: all-dead populations deposit nothing; particles
    in the LAST cell land in the last window without out-of-bounds."""
    grid = (16, 16, 16)
    pos = jnp.full((512, 3), 15.9 * CELL, jnp.float32)  # all in the last cell
    got = g.deposit_sorted(pos, jnp.ones(512, jnp.int32), CELL, grid,
                           window_rows=4, tile_p=128)
    assert int(got[-1]) == 512 and int(got.sum()) == 512
    got0 = g.deposit_sorted(pos, jnp.zeros(512, jnp.int32), CELL, grid,
                            window_rows=4, tile_p=128)
    assert int(got0.sum()) == 0


def test_full_deposit_sorted_engine_equality():
    """End-to-end: full_deposit='sorted' with a periodic/thermal workload
    (init_vth spreads the population; bbox disabled so the full-grid path
    runs) produces the identical state to the scatter path."""
    from particle_simulation_tpu import SimConfig
    from particle_simulation_tpu.cross_section import bundled_paths, load_table
    from particle_simulation_tpu.ops.step import poisson_step
    from particle_simulation_tpu.state import setup_particles

    cfg = SimConfig(
        init_n=400, capacity=2048, poisson_steps=2, poisson_timestep=4,
        grid_size=(32, 32, 32), scheduler="naive", boundary="periodic",
        init_vth=1e3, bbox_subgrid=0,
        cross_section_path=bundled_paths()[1],
    )
    table = load_table(cfg.cross_section_path)

    def run(c):
        st = setup_particles(c)
        for t in range(c.poisson_steps):
            st, m = poisson_step(st, jnp.uint32(t), table, c)
        return st, m

    st0, m0 = run(cfg)
    st1, m1 = run(cfg.replace(full_deposit="sorted"))
    assert int(m0["n"]) == int(m1["n"])
    for f in ("pos", "vel", "acc", "status", "id_hi", "id_lo"):
        np.testing.assert_array_equal(
            np.asarray(getattr(st0, f)), np.asarray(getattr(st1, f))
        )


def test_bbox_field_empty_population():
    grid = (32, 32, 32)
    e = electric_force_constant(CELL)
    pos = np.zeros((16, 3), np.float32)
    weight = np.zeros(16, np.int32)
    got = g.bbox_field_acceleration(
        jnp.asarray(pos), jnp.asarray(weight), CELL, grid, e, subgrid=16)
    np.testing.assert_array_equal(np.asarray(got), np.zeros((16, 3), np.float32))
