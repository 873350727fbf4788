"""Checkpoint / resume.

The reference has none (SURVEY.md §5.4): final state is copied to host and
discarded.  Long ionization-growth runs want restartability, so SimState
snapshots here are first-class:

  * ``save_npz``/``load_npz``: single-file numpy snapshots (host-local);
  * ``save_orbax``/``load_orbax``/``latest_step``: orbax-backed checkpoint
    directory with per-Poisson-step steps, suitable for multi-chip arrays;
  * ``make_checkpoint_hook``: an ``on_step`` hook for run_pic, firing on the
    verbose cadence like the reference's log().
"""

from __future__ import annotations

import os
from typing import Optional

import jax.numpy as jnp
import numpy as np

from .config import SimConfig
from .state import SimState

_FIELDS = ("pos", "vel", "acc", "status", "id_hi", "id_lo", "n")


def save_npz(path: str, state: SimState, poisson_step: int) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(
        path,
        poisson_step=np.int64(poisson_step),
        **{f: np.asarray(getattr(state, f)) for f in _FIELDS},
    )


def load_npz(path: str) -> tuple[SimState, int]:
    with np.load(path) as z:
        state = SimState(**{f: jnp.asarray(z[f]) for f in _FIELDS})
        return state, int(z["poisson_step"])


def _orbax():
    """orbax.checkpoint, imported on first use: it is an optional
    dependency, needed only by the orbax backend."""
    try:
        import orbax.checkpoint as ocp
    except ImportError as e:
        raise RuntimeError(
            "the orbax checkpoint backend needs the 'orbax-checkpoint' "
            "package (pip install orbax-checkpoint); the npz backend needs "
            "nothing beyond numpy"
        ) from e
    return ocp


def save_orbax(ckpt_dir: str, state: SimState, poisson_step: int) -> None:
    ocp = _orbax()

    path = os.path.abspath(os.path.join(ckpt_dir, f"step_{poisson_step:06d}"))
    with ocp.PyTreeCheckpointer() as ckptr:
        ckptr.save(path, state._asdict())


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        if not d.startswith("step_"):
            continue
        stem = d[len("step_"):]
        if stem.endswith(".npz"):
            stem = stem[: -len(".npz")]
        if stem.isdigit():
            steps.append(int(stem))
    return max(steps) if steps else None


def load_orbax(ckpt_dir: str, poisson_step: int) -> SimState:
    ocp = _orbax()

    path = os.path.abspath(os.path.join(ckpt_dir, f"step_{poisson_step:06d}"))
    with ocp.PyTreeCheckpointer() as ckptr:
        tree = ckptr.restore(path)
    return SimState(**{f: jnp.asarray(tree[f]) for f in _FIELDS})


def make_checkpoint_hook(config: SimConfig, ckpt_dir: str, backend: str = "orbax"):
    if backend == "orbax":
        _orbax()  # fail before the run starts, not at its first snapshot

    def on_step(t, state):
        if backend == "orbax":
            save_orbax(ckpt_dir, state, t)
        else:
            save_npz(os.path.join(ckpt_dir, f"step_{t:06d}.npz"), state, t)

    return on_step


def resume_run(config: SimConfig, ckpt_dir: str):
    """Restore the latest checkpoint and continue run_pic from there."""
    from .runtime import run_pic

    step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    npz_path = os.path.join(ckpt_dir, f"step_{step:06d}.npz")
    if os.path.exists(npz_path):  # npz-backend checkpoints resume too
        state, _ = load_npz(npz_path)
    else:
        state = load_orbax(ckpt_dir, step)
    remaining = config.poisson_steps - step
    if remaining <= 0:
        raise ValueError(f"checkpoint step {step} is beyond the configured run")
    # Genealogy draws are keyed by the absolute Poisson index, so resuming
    # with first_poisson_index=step reproduces the uninterrupted run exactly.
    return run_pic(
        config.replace(poisson_steps=remaining),
        print_header=False,
        initial_state=state,
        first_poisson_index=step,
    )
