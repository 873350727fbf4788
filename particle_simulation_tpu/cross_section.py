"""Cross-section (collision chance) tables.

Reference behavior reproduced bit-for-bit:
  * file format: N_STEPS=10000 whitespace-separated rows of
    ``split_chance remove_chance`` (src/cross_section.cu:3-28,
    src/cross_section.h:9-16);
  * energy -> bucket: trunc((log10(E) + 6) * N_STEPS / 22) clamped to
    [0, N_STEPS-1], i.e. log-spaced buckets over [1e-6, 1e16)
    (src/cross_section.cu:30-35);
  * the bundled table is the sine-modulated one generated by
    cross_section_gen.py:3-10.

On device the table is a (N_STEPS, 2) float32 array (80 KB); the Pallas
engine gathers from it directly, so it stays resident in the GPU's L2.
"""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np

N_STEPS = 10000

_BUNDLED = os.path.join(os.path.dirname(__file__), "data", "cross_section.txt")
_BUNDLED_CONST = os.path.join(os.path.dirname(__file__), "data", "cross_section_const.txt")


def generate_table(n_steps: int = N_STEPS) -> np.ndarray:
    """The sine-modulated demo table (cross_section_gen.py:3-10)."""
    i = np.arange(n_steps, dtype=np.float64)
    val = (np.sin(np.power(i, 2.6) / 50_000_000.0) + 1.01) * np.power(i, 0.1)
    return np.stack([val, val], axis=1).astype(np.float32)


def write_table(path: str, table: np.ndarray) -> None:
    with open(path, "w") as f:
        for split, remove in table:
            f.write(f"{float(split)} {float(remove)}\n")


def load_table(path: str = "") -> jnp.ndarray:
    """Load (split_chance, remove_chance) pairs -> (N_STEPS, 2) float32.

    Missing/short files raise instead of silently truncating (the reference
    prints to stderr and continues with garbage, src/cross_section.cu:17-21 —
    we treat that as a bug, not a feature).
    """
    if not path:
        path = _BUNDLED
    try:
        from .utils import fastio

        data = fastio.parse_float_pairs(path, N_STEPS)
    except (ImportError, OSError):
        data = np.loadtxt(path, dtype=np.float64, max_rows=N_STEPS)
    data = np.atleast_2d(np.asarray(data, dtype=np.float32))
    if data.shape != (N_STEPS, 2):
        raise ValueError(
            f"cross-section table {path!r} has shape {data.shape}, "
            f"expected ({N_STEPS}, 2)"
        )
    return jnp.asarray(data)


def bundled_paths() -> tuple[str, str]:
    """(sine-modulated demo table, constant 50/50 stress table)."""
    return _BUNDLED, _BUNDLED_CONST


def energy_to_index(energy):
    """Map kinetic 'energy' (|v|^2, no 1/2 m — reference convention,
    src/particle_move.cu:59-62) to a table bucket.

    trunc((log10(E)+6) * N_STEPS / 22) clamped to [0, N_STEPS-1]
    (src/cross_section.cu:32-35).  log10(0) = -inf truncs to a large
    negative -> clamps to 0, matching CUDA.
    """
    e = jnp.asarray(energy)
    idx = jnp.trunc((jnp.log10(e) + 6.0) * (N_STEPS / 22.0))
    idx = jnp.where(jnp.isnan(idx), 0.0, idx)  # E<0 impossible; guard anyway
    return jnp.clip(idx, 0, N_STEPS - 1).astype(jnp.int32)


def physical_table(
    sigma_split,
    sigma_remove,
    gas_density: float,
    dt: float,
    mass: float | None = None,
    n_steps: int = N_STEPS,
) -> np.ndarray:
    """Build a collision table from physical cross sections (SURVEY.md §7
    item 10: 'real argon cross sections' upgrade path).

    ``sigma_split(E)`` / ``sigma_remove(E)`` are cross sections in m^2 as a
    function of the framework's energy variable E = |v|^2 (m^2/s^2 — the
    reference's convention, no 1/2 m; src/particle_move.cu:59-62).  The
    per-mobility-step probability is the standard MCC expression

        p = 1 - exp(-n_gas * sigma(E) * |v| * dt)

    mapped to the table's percentage units and log-energy buckets
    (bucket centers of energy_to_index's formula).
    """
    i = np.arange(n_steps, dtype=np.float64) + 0.5
    log10_e = i * (22.0 / n_steps) - 6.0
    energy = np.power(10.0, log10_e)
    speed = np.sqrt(energy)
    p_split = 1.0 - np.exp(-gas_density * sigma_split(energy) * speed * dt)
    p_remove = 1.0 - np.exp(-gas_density * sigma_remove(energy) * speed * dt)
    table = np.stack([p_split * 100.0, p_remove * 100.0], axis=1)
    return np.clip(table, 0.0, 100.0).astype(np.float32)


def argon_like_table(
    gas_density: float = 1e20, dt: float = 1e-9, n_steps: int = N_STEPS
) -> np.ndarray:
    """A physically-shaped argon-like table: Lotz-form electron-impact
    ionization above a threshold, plus a low-energy attachment/absorption
    tail.  Synthetic constants (no bundled measured data), but with the
    correct qualitative structure: zero ionization below threshold, peak
    near ~4x threshold, ~1/E falloff."""
    # Energy variable is |v|^2; pick the ionization threshold so the curve
    # sits inside the table's dynamic range.
    e_ion = 5.54e12  # |v|^2 threshold (eV-equivalent for m_e ~ 15.76 eV)

    def sigma_ion(e):
        x = np.maximum(e / e_ion, 1.0)
        return np.where(e > e_ion, 2.5e-20 * np.log(x) / x, 0.0)  # Lotz-like

    def sigma_abs(e):
        return 1.0e-21 / (1.0 + e / 1e11)  # low-energy capture tail

    return physical_table(sigma_ion, sigma_abs, gas_density, dt, n_steps=n_steps)


def ensure_bundled_tables() -> None:
    os.makedirs(os.path.dirname(_BUNDLED), exist_ok=True)
    if not os.path.exists(_BUNDLED):
        write_table(_BUNDLED, generate_table())
    if not os.path.exists(_BUNDLED_CONST):
        write_table(_BUNDLED_CONST, np.full((N_STEPS, 2), 50.0, np.float32))
