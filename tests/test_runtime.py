"""End-to-end runtime, CLI contract, observability outputs."""

import json
import os
import zlib

import numpy as np
import pytest

from particle_simulation_tpu import SimConfig
from particle_simulation_tpu.cli import parse_args
from particle_simulation_tpu.config import SCHEDULER_MODES
from particle_simulation_tpu.observability import (
    CSV_HEADER,
    render_particles,
    write_png,
    write_timing_csv,
)
from particle_simulation_tpu.runtime import run_pic, sorted_particle_array


def test_cli_positional_contract():
    # ./run 30 VERBOSE INIT_N MAX_T BLOCK_SIZE MAX_N SLEEP POISSON_TS
    opts = parse_args(
        ["30", "2", "1000", "7", "128", "5000", "100", "9", "grid=16"]
    )
    mode, cfg = opts.mode, opts.config
    assert mode == "30"
    assert cfg.scheduler == "dynamic"
    assert cfg.verbose == 2
    assert cfg.init_n == 1000
    assert cfg.poisson_steps == 7
    assert cfg.block_size == 128
    assert cfg.capacity == 5000
    assert cfg.sleep_time_ns == 100
    assert cfg.poisson_timestep == 9
    assert cfg.grid_size == (16, 16, 16)
    assert set(SCHEDULER_MODES) == {"30", "31", "32"}


def test_cli_rejects_partial_positional_args():
    # the reference requires all 8 args (src/main.cu:10-24); partial lists
    # must not silently run with defaults
    import pytest

    with pytest.raises(SystemExit):
        parse_args(["32", "1", "1000000", "10"])


def test_cli_mesh_override():
    opts = parse_args(
        ["30", "0", "1000", "7", "128", "5000", "100", "9", "mesh=4"]
    )
    assert opts.mesh == 4


def test_cli_engine_knob_passthrough():
    # any scalar SimConfig field is a valid override, coerced by type;
    # unknown keys stay a hard error (strict-CLI contract)
    import pytest

    opts = parse_args(
        ["30", "0", "1000", "7", "128", "5000", "100", "9",
         "rng_mode=perstep", "bbox_subgrid=32", "init_vth=2.5",
         "grid_live_chunks=4"]
    )
    cfg = opts.config
    assert cfg.rng_mode == "perstep"
    assert cfg.bbox_subgrid == 32
    assert cfg.init_vth == 2.5
    assert cfg.grid_live_chunks == 4
    with pytest.raises(SystemExit):
        parse_args(["30", "0", "1000", "7", "128", "5000", "100", "9",
                    "no_such_knob=1"])
    with pytest.raises(SystemExit):
        # non-scalar fields (grid_size) are not reachable this way
        parse_args(["30", "0", "1000", "7", "128", "5000", "100", "9",
                    "grid_size=16"])


def test_run_pic_end_to_end(tmp_path):
    cfg = SimConfig(
        init_n=100, capacity=2000, poisson_steps=2, poisson_timestep=4,
        grid_size=(16, 16, 16), scheduler="naive",
    )
    hooks = []
    run = run_pic(cfg, on_step=lambda t, s: hooks.append(t), print_header=False)
    assert run.final_n >= 0
    assert len(run.steps) <= 2
    assert hooks == []  # verbose=0 -> no hook calls

    cfg_v = cfg.replace(verbose=1)
    run = run_pic(cfg_v, on_step=lambda t, s: hooks.append(t), print_header=False)
    # verbose=1 logs every Poisson step INCLUDING the end-of-run state
    # (reference: log() at src/pic.cu:494 per step + :561 after the loop)
    assert hooks == [0, 1, 2]

    # the final log rides the same t % verbose gate as the per-step ones
    # (src/pic.cu:561 is a plain log() call; src/utility.cu's early return
    # applies): verbose=5 with 2 Poisson steps logs only t=0
    hooks.clear()
    run_pic(cfg.replace(verbose=5), on_step=lambda t, s: hooks.append(t),
            print_header=False)
    assert hooks == [0]


def test_timing_csv_schema(tmp_path):
    cfg = SimConfig(
        init_n=50, capacity=500, poisson_steps=1, poisson_timestep=2,
        grid_size=(16, 16, 16),
    )
    run = run_pic(cfg, print_header=False)
    path = tmp_path / "out.csv"
    write_timing_csv([run], str(path))
    lines = path.read_text().strip().split("\n")
    assert lines[0] == CSV_HEADER
    fields = lines[1].split(",")
    assert len(fields) == 9
    assert fields[0] == "Naive"
    assert int(fields[1]) == 50


def test_png_writer_valid(tmp_path):
    img = render_particles(
        np.array([[0.5, 0.5, 0.0], [1.0, 2.0, 0.0]]), (5.12, 5.12, 5.12), 64
    )
    p = tmp_path / "snap.png"
    write_png(str(p), img)
    data = p.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    # decode IDAT and verify dimensions from IHDR
    assert data[12:16] == b"IHDR"
    w = int.from_bytes(data[16:20], "big")
    h = int.from_bytes(data[20:24], "big")
    assert (w, h) == (64, 64)


def test_capacity_overflow_flagged(capsys):
    """Driving the population past capacity must warn and clamp (reference
    src/pic.cu:543-545 'OVERFLOW FROM ADDING PARTICLES')."""
    from particle_simulation_tpu.cross_section import bundled_paths

    cfg = SimConfig(
        init_n=400, capacity=500, poisson_steps=1, poisson_timestep=6,
        grid_size=(16, 16, 16),
        cross_section_path=bundled_paths()[1],  # 50% split per step
    )
    run = run_pic(cfg, print_header=False)
    assert any(m.overflow for m in run.steps)
    assert run.final_n <= cfg.capacity
    assert "OVERFLOW" in capsys.readouterr().out


def test_zero_population_early_exit(capsys):
    """All particles dying ends the run early ('Hit 0', reference
    src/pic.cu:556-559)."""
    import numpy as np

    from particle_simulation_tpu.cross_section import N_STEPS, write_table

    import tempfile, os
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "killer.txt")
        write_table(p, np.tile(np.float32([0.0, 100.0]), (N_STEPS, 1)))
        cfg = SimConfig(
            init_n=50, capacity=200, poisson_steps=5, poisson_timestep=3,
            grid_size=(16, 16, 16), cross_section_path=p,
        )
        run = run_pic(cfg, print_header=False)
    assert run.final_n == 0
    assert len(run.steps) == 1  # exited after the first Poisson step
    assert "Hit 0" in capsys.readouterr().out


def test_device_poisson_loop_matches_host_loop():
    """poisson_loop (one dispatch, lax.scan) must equal the host-driven
    loop step for step."""
    import jax.numpy as jnp
    import numpy as np

    from particle_simulation_tpu.cross_section import bundled_paths, load_table
    from particle_simulation_tpu.ops.step import poisson_loop
    from particle_simulation_tpu.runtime import sorted_particle_array
    from particle_simulation_tpu.state import setup_particles

    cfg = SimConfig(
        init_n=150, capacity=4000, poisson_steps=3, poisson_timestep=5,
        grid_size=(16, 16, 16),
        cross_section_path=bundled_paths()[1],
    )
    table = load_table(cfg.cross_section_path)
    host = run_pic(cfg, table=table, print_header=False)
    final, metrics = poisson_loop(setup_particles(cfg), table, cfg, 3)
    assert [int(x) for x in metrics["n"]] == [m.n for m in host.steps]
    np.testing.assert_array_equal(
        sorted_particle_array(host.state), sorted_particle_array(final)
    )


@pytest.mark.slow
def test_naive_host_chunks_bit_exact():
    """The chunked-dispatch Naive path (poisson_step_naive_host: the T-loop
    split into bounded host-side spans — the worker-fault workaround for the
    canonical naive tails) must match the in-jit fori_loop path exactly,
    including per-step populations and exact push counts, with a chunk size
    that does NOT divide T (exercises the short last span)."""
    import numpy as np

    from particle_simulation_tpu.cross_section import bundled_paths
    from particle_simulation_tpu.runtime import run_pic_device, sorted_particle_array

    cfg = SimConfig(
        init_n=300, capacity=60_000, poisson_steps=3, poisson_timestep=7,
        grid_size=(32, 32, 32), scheduler="naive",
        cross_section_path=bundled_paths()[1],  # heavy churn -> growth
    )
    injit = run_pic_device(cfg, naive_chunk=0)
    host = run_pic_device(cfg, naive_chunk=3)
    assert host.final_n == injit.final_n
    assert [m.n for m in host.steps] == [m.n for m in injit.steps]
    assert [m.pushes for m in host.steps] == [m.pushes for m in injit.steps]
    np.testing.assert_array_equal(
        sorted_particle_array(injit.state), sorted_particle_array(host.state)
    )


@pytest.mark.slow
def test_host_paths_bit_exact_under_accepted_overflow():
    """At the TOP capacity bucket an overflow is ACCEPTED, not retried
    (children beyond the container are dropped and counted, reference
    src/pic.cu:543-545) and the in-jit phases keep simulating the existing
    population — the host-chunked paths must too (stop_on_overflow=False),
    not break out of the remaining chunks/generations."""
    import numpy as np

    from particle_simulation_tpu.cross_section import bundled_paths
    from particle_simulation_tpu.runtime import run_pic_device, sorted_particle_array

    # capacity tight enough that the 50%-split table overflows the top
    # bucket mid-phase (no bigger bucket exists -> accepted overflow)
    base = SimConfig(
        init_n=400, capacity=512, poisson_steps=2, poisson_timestep=6,
        grid_size=(16, 16, 16),
        cross_section_path=bundled_paths()[1],
    )
    cfg_n = base.replace(scheduler="naive")
    injit = run_pic_device(cfg_n, naive_chunk=0)
    host = run_pic_device(cfg_n, naive_chunk=2)
    assert any(m.overflow for m in injit.steps)  # regime actually reached
    assert [m.n for m in host.steps] == [m.n for m in injit.steps]
    assert [m.pushes for m in host.steps] == [m.pushes for m in injit.steps]
    np.testing.assert_array_equal(
        sorted_particle_array(injit.state), sorted_particle_array(host.state)
    )

    cfg_s = base.replace(scheduler="sync")
    injit_s = run_pic_device(cfg_s, sync_host=False)
    host_s = run_pic_device(cfg_s, sync_host=True)
    assert any(m.overflow for m in injit_s.steps)
    assert [m.n for m in host_s.steps] == [m.n for m in injit_s.steps]
    assert [m.pushes for m in host_s.steps] == [m.pushes for m in injit_s.steps]
    np.testing.assert_array_equal(
        sorted_particle_array(injit_s.state), sorted_particle_array(host_s.state)
    )


@pytest.mark.slow
def test_sync_host_generations_bit_exact():
    """The host-generation CPU Sync path (poisson_step_sync_host: fixed
    point as a host loop of bounded dispatches — the worker-fault-proof
    program shape) must match the in-jit while_loop path exactly, including
    per-step populations, exact push counts, and forced bucket regrowth."""
    import numpy as np

    import particle_simulation_tpu.runtime as rt
    from particle_simulation_tpu.cross_section import bundled_paths
    from particle_simulation_tpu.runtime import run_pic_device, sorted_particle_array

    cfg = SimConfig(
        init_n=300, capacity=60_000, poisson_steps=3, poisson_timestep=6,
        grid_size=(32, 32, 32), scheduler="sync",
        cross_section_path=bundled_paths()[1],  # heavy churn -> growth
    )
    orig = rt._bucket_size
    rt._bucket_size = lambda n, capacity, floor=512: orig(n, capacity, floor)
    try:
        injit = run_pic_device(cfg, sync_host=False)
        host = run_pic_device(cfg, sync_host=True)
    finally:
        rt._bucket_size = orig
    assert host.final_n == injit.final_n
    assert [m.n for m in host.steps] == [m.n for m in injit.steps]
    assert [m.pushes for m in host.steps] == [m.pushes for m in injit.steps]
    np.testing.assert_array_equal(
        sorted_particle_array(injit.state), sorted_particle_array(host.state)
    )


def test_sync_host_span_split_bit_exact():
    """sync_span splits each generation's T-loop into bounded host
    dispatches (the worker-fault mitigation for the canonical T>=200 sync
    rows): results must be IDENTICAL to the unsplit host path — the span
    bounds are traced scalars into the same compiled fori_loop, so the
    split only round-trips the carry through HBM.  span=3 with T=7 forces
    a ragged final span; the churny table forces multiple generations
    (spawns) plus slice-window retries under the tiny bucket floor."""
    import numpy as np

    import particle_simulation_tpu.runtime as rt
    from particle_simulation_tpu.cross_section import bundled_paths
    from particle_simulation_tpu.runtime import run_pic_device, sorted_particle_array

    cfg = SimConfig(
        init_n=300, capacity=60_000, poisson_steps=2, poisson_timestep=7,
        grid_size=(32, 32, 32), scheduler="sync",
        cross_section_path=bundled_paths()[1],  # heavy churn -> growth
    )
    orig = rt._bucket_size
    rt._bucket_size = lambda n, capacity, floor=512: orig(n, capacity, floor)
    try:
        whole = run_pic_device(cfg, sync_host=True)
        spanned = run_pic_device(cfg, sync_host=True, sync_span=3)
    finally:
        rt._bucket_size = orig
    assert spanned.final_n == whole.final_n
    assert [m.n for m in spanned.steps] == [m.n for m in whole.steps]
    assert [m.pushes for m in spanned.steps] == [m.pushes for m in whole.steps]
    np.testing.assert_array_equal(
        sorted_particle_array(whole.state), sorted_particle_array(spanned.state)
    )


def test_auto_bucket_bit_exact():
    """Bucketed execution (power-of-2 working prefixes + overflow retry)
    must reproduce the full-capacity run exactly, including forced bucket
    growth."""
    import numpy as np

    from particle_simulation_tpu.cross_section import bundled_paths
    from particle_simulation_tpu.runtime import _bucket_size, sorted_particle_array

    # tiny floor so the bucket machinery actually engages and must regrow
    import particle_simulation_tpu.runtime as rt

    cfg = SimConfig(
        init_n=300, capacity=60_000, poisson_steps=3, poisson_timestep=6,
        grid_size=(32, 32, 32),
        cross_section_path=bundled_paths()[1],  # heavy churn -> growth
    )
    base = run_pic(cfg, print_header=False)

    orig = rt._bucket_size
    rt._bucket_size = lambda n, capacity, floor=512: orig(n, capacity, floor)
    try:
        bucketed = run_pic(cfg, print_header=False, auto_bucket=True)
    finally:
        rt._bucket_size = orig

    assert bucketed.final_n == base.final_n
    np.testing.assert_array_equal(
        sorted_particle_array(base.state), sorted_particle_array(bucketed.state)
    )
    assert [m.n for m in bucketed.steps] == [m.n for m in base.steps]


@pytest.mark.slow
def test_cli_scheduler_path_uses_capacity_ladder(monkeypatch, capsys):
    """A reference-shaped `./run 32 ... MAX_N=5e6` at tiny init_n must run on
    a sub-capacity bucket by default (VERDICT r2 #6) with physics identical
    to a direct full-prefix run, and bucket=0 must restore the literal
    full-capacity shape."""
    import particle_simulation_tpu.runtime as rt
    from particle_simulation_tpu import cli

    captured = {}
    orig = rt.run_pic

    def spy(cfg, **kw):
        run = orig(cfg, **kw)
        captured["kwargs"] = kw
        captured["run"] = run
        return run

    monkeypatch.setattr(rt, "run_pic", spy)
    args = ["32", "0", "300", "2", "128", "5000000", "100", "4", "grid=16"]
    assert cli.main(list(args)) == 0
    assert captured["kwargs"]["auto_bucket"] is True
    bucketed = captured["run"]
    assert 0 < bucketed.last_bucket < 5_000_000  # sub-capacity bucket

    # physics identical to a direct run at the bucket capacity (genealogy-
    # keyed RNG makes results capacity-independent)
    cfg = bucketed.config.replace(capacity=bucketed.last_bucket)
    base = run_pic(cfg, print_header=False)
    assert base.final_n == bucketed.final_n
    np.testing.assert_array_equal(
        sorted_particle_array(base.state), sorted_particle_array(bucketed.state)
    )

    # bucket=0 must dispatch with auto_bucket=False; stub the run out (a
    # literal full-capacity 5e6 execution takes minutes on this CPU)
    monkeypatch.setattr(
        rt, "run_pic",
        lambda cfg, **kw: captured.update(kwargs=kw) or base,
    )
    assert cli.main(list(args) + ["bucket=0"]) == 0
    assert captured["kwargs"]["auto_bucket"] is False
    capsys.readouterr()  # swallow CLI prints


def test_bucket_ladder_properties():
    """The working-capacity ladder must always (a) hold the population with
    headroom, (b) be monotone in n, (c) clamp to capacity, (d) grow strictly
    on the overflow-retry path (_bucket_size(w + 1, cap) > w below cap)."""
    from particle_simulation_tpu.runtime import HEADROOM, _bucket_size

    cap = 50_000_000
    prev = 0
    for n in [0, 1, 1000, 65_536, 100_000, 1_000_000, 1_048_577,
              5_000_000, 20_000_000, 39_999_999, 60_000_000]:
        w = _bucket_size(n, cap)
        assert w >= min(int(n * HEADROOM), cap) or w == cap
        assert w >= n or w == cap
        assert w <= cap
        assert w >= prev  # monotone
        prev = w
    # overflow retry strictly grows until the cap
    w = _bucket_size(1_000_000, cap)
    seen = set()
    while w < cap:
        assert w not in seen
        seen.add(w)
        nw = _bucket_size(w + 1, cap)
        assert nw > w
        w = nw
    assert len(seen) > 10  # the quarter-step ladder is actually fine-grained


def test_row_ckpt_resume_bit_exact(tmp_path):
    """Crash-resumable benchmark rows (run_pic_device row_ckpt): a row
    resumed from a mid-run snapshot must equal the uninterrupted run
    exactly — state multiset, per-step metrics, and accumulated device
    time — because physics is a pure function of (genealogy, absolute
    Poisson index).  Also: the snapshot is deleted on completion, and a
    foreign snapshot (different config tag) is ignored."""
    from particle_simulation_tpu.cross_section import bundled_paths
    from particle_simulation_tpu.runtime import (
        _save_row_ckpt, run_pic_device, sorted_particle_array,
    )

    cfg = SimConfig(
        init_n=300, capacity=60_000, poisson_steps=4, poisson_timestep=7,
        grid_size=(32, 32, 32), scheduler="naive",
        cross_section_path=bundled_paths()[1],  # heavy churn -> growth
    )
    full = run_pic_device(cfg)

    # fabricate the snapshot an interrupted process would have left after step 2:
    # run the first 2 steps for real, then persist exactly what
    # run_pic_device's per-step hook persists
    head = run_pic_device(cfg.replace(poisson_steps=2))
    ck = str(tmp_path / "row.npz")
    _save_row_ckpt(
        ck, cfg, head.state, head.steps, head.device_time_ms / 1e3, 2,
        head.last_bucket,
    )
    resumed = run_pic_device(cfg, row_ckpt=ck)
    assert resumed.final_n == full.final_n
    assert [m.n for m in resumed.steps] == [m.n for m in full.steps]
    assert [m.pushes for m in resumed.steps] == [m.pushes for m in full.steps]
    assert [m.added for m in resumed.steps] == [m.added for m in full.steps]
    np.testing.assert_array_equal(
        sorted_particle_array(resumed.state), sorted_particle_array(full.state)
    )
    assert abs(
        resumed.device_time_ms
        - (head.device_time_ms + sum(m.wall_s for m in resumed.steps[2:]) * 1e3)
    ) < 1e-6 * max(resumed.device_time_ms, 1.0)
    assert not os.path.exists(ck)  # completed row cleans up its snapshot

    # a snapshot from a DIFFERENT config must not hijack the row
    _save_row_ckpt(
        ck, cfg.replace(seed=cfg.seed + 1), head.state, head.steps,
        head.device_time_ms / 1e3, 2, head.last_bucket,
    )
    fresh = run_pic_device(cfg, row_ckpt=ck)
    assert fresh.final_n == full.final_n
    np.testing.assert_array_equal(
        sorted_particle_array(fresh.state), sorted_particle_array(full.state)
    )
