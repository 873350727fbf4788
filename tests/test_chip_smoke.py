"""chip_smoke.py's guards: it refuses any device but a GPU (printing no
result), refuses to run outside a checkout, and its comparisons fail
loudly.  The phases themselves run only on the card."""

import json
import os
import shutil
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import pytest

from particle_simulation_tpu import cli, setup_particles

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402


def _fake(platform, n, kind="NVIDIA H100 80GB HBM3"):
    return [types.SimpleNamespace(platform=platform, device_kind=kind)] * n


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit, match="no GPU"):
        chip_smoke.require_gpu(jax.devices())


@pytest.mark.parametrize("n,count", [(1, None), (4, 4), (8, 4)])
def test_require_gpu_accepts_gpus(n, count):
    assert chip_smoke.require_gpu(_fake("gpu", n), count) == (
        "gpu", "NVIDIA H100 80GB HBM3", n)


def test_require_gpu_multi_needs_four():
    with pytest.raises(SystemExit, match="needs 4 GPUs"):
        chip_smoke.require_gpu(_fake("gpu", 2), 4)


def _run(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _assert_no_result(out):
    assert out.returncode != 0
    for line in out.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


def test_script_fails_without_accelerator():
    out = _run(os.path.join(REPO, "chip_smoke.py"), REPO)
    _assert_no_result(out)
    assert "no GPU" in out.stderr


def test_script_fails_outside_checkout(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run("chip_smoke.py", tmp_path)
    _assert_no_result(out)
    assert "checkout" in out.stderr


def test_card_identity_reads_first_line(monkeypatch):
    monkeypatch.setattr(
        chip_smoke.subprocess, "run",
        lambda *a, **k: types.SimpleNamespace(
            stdout="NVIDIA H100 80GB HBM3, 700.00 W\nsecond card\n"),
    )
    assert chip_smoke.card_identity() == "NVIDIA H100 80GB HBM3, 700.00 W"


def test_compare_multisets(const_table):
    from particle_simulation_tpu import SimConfig

    state = setup_particles(SimConfig(init_n=50, capacity=64,
                                      grid_size=(16, 16, 16)))
    chip_smoke.compare_multisets(state, state, "same")
    moved = state._replace(pos=state.pos.at[3, 0].add(1e-3))
    with pytest.raises(AssertionError, match="differ"):
        chip_smoke.compare_multisets(state, moved, "moved")
    shorter = state._replace(n=jnp.asarray(49, jnp.int32))
    with pytest.raises(AssertionError, match="differ"):
        chip_smoke.compare_multisets(state, shorter, "shorter")


def test_phase_multi_small_on_four_devices(sine_table, capsys):
    """The --multi phase at a toy size on four virtual CPU devices: both
    grid modes equal the one-device run, and every time is reported."""
    chip_smoke.phase_multi(sine_table, n_cards=4, per_card=300, grid=64,
                           t_steps=4)
    out = capsys.readouterr().out
    for mode in ("replicated", "slab"):
        assert f"[multi] {mode}: 4 cards == 1 device" in out
    assert out.count("step loop") == 4 and out.count("at T=1") == 4


def test_canonical_argv_is_the_reference_deployment():
    """1M electrons, MAX_N 5e7, 3 Poisson steps of T=100 on the default
    512^3 grid with the sine table, through the dynamic engine."""
    cfg = cli.parse_args(chip_smoke.CANONICAL_ARGV).config
    assert (cfg.scheduler, cfg.init_n, cfg.capacity, cfg.poisson_steps,
            cfg.poisson_timestep) == ("dynamic", 1_000_000, 50_000_000, 3, 100)
    assert cfg.grid_size == (512, 512, 512) and cfg.cross_section_path == ""
