"""Checkpoint/resume: a resumed run must reproduce the uninterrupted run
exactly (genealogy RNG is keyed by absolute Poisson index)."""

import numpy as np

from particle_simulation_tpu import SimConfig
from particle_simulation_tpu.checkpoint import (
    latest_step,
    load_npz,
    load_orbax,
    save_npz,
    save_orbax,
)
from particle_simulation_tpu.cross_section import bundled_paths
from particle_simulation_tpu.runtime import run_pic, sorted_particle_array
from particle_simulation_tpu.state import setup_particles

CFG = SimConfig(
    init_n=120,
    capacity=8000,
    poisson_steps=4,
    poisson_timestep=5,
    grid_size=(16, 16, 16),
    cross_section_path=bundled_paths()[1],
)


def test_npz_roundtrip(tmp_path):
    st = setup_particles(CFG)
    p = tmp_path / "snap.npz"
    save_npz(str(p), st, 7)
    st2, step = load_npz(str(p))
    assert step == 7
    for f in st._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(st, f)), np.asarray(getattr(st2, f))
        )


def test_orbax_roundtrip(tmp_path):
    st = setup_particles(CFG)
    d = str(tmp_path / "ckpt")
    save_orbax(d, st, 3)
    assert latest_step(d) == 3
    st2 = load_orbax(d, 3)
    np.testing.assert_array_equal(np.asarray(st.pos), np.asarray(st2.pos))
    assert int(st2.n) == int(st.n)


def test_resume_bit_exact(tmp_path):
    full = run_pic(CFG, print_header=False)

    half_cfg = CFG.replace(poisson_steps=2)
    half = run_pic(half_cfg, print_header=False)
    resumed = run_pic(
        CFG.replace(poisson_steps=2),
        print_header=False,
        initial_state=half.state,
        first_poisson_index=2,
    )
    assert resumed.final_n == full.final_n
    np.testing.assert_array_equal(
        sorted_particle_array(full.state), sorted_particle_array(resumed.state)
    )


def test_npz_checkpoints_resume(tmp_path):
    """Checkpoints written by the npz backend must be discoverable and
    resumable (ADVICE r1: latest_step used to ignore .npz names and
    resume_run always called load_orbax)."""
    import os

    from particle_simulation_tpu.checkpoint import make_checkpoint_hook, save_npz

    st = setup_particles(CFG)
    d = str(tmp_path / "npz_ckpt")
    os.makedirs(d)
    hook = make_checkpoint_hook(CFG, d, backend="npz")
    hook(4, st)
    assert latest_step(d) == 4
    from particle_simulation_tpu.checkpoint import load_npz

    st2, step = load_npz(os.path.join(d, "step_000004.npz"))
    assert step == 4
    np.testing.assert_array_equal(np.asarray(st.pos), np.asarray(st2.pos))


def test_missing_orbax_names_the_package(tmp_path, monkeypatch):
    """orbax is optional: without it the orbax backend fails up front, with
    a message naming the package, and the npz backend still works."""
    import sys

    import pytest

    from particle_simulation_tpu.checkpoint import make_checkpoint_hook

    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)
    with pytest.raises(RuntimeError, match="orbax-checkpoint"):
        make_checkpoint_hook(CFG, str(tmp_path))
    hook = make_checkpoint_hook(CFG, str(tmp_path), backend="npz")
    hook(2, setup_particles(CFG))
    assert latest_step(str(tmp_path)) == 2
