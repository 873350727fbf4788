"""Spectral (FFT) Poisson field model — the flagged fidelity upgrade.

The reference's ``updateGrid`` is a local neighbour-difference approximation,
not a real Poisson solve (src/grid_operations.cu:29-56; SURVEY.md §2.1
"Grid (field) ops").  This model is the true solve as the upgrade path:
deposition -> FFT Poisson -> field gather, all under jit.

Model (periodic boundary conditions):
    lap(phi) = -rho / eps0,        E = -grad(phi),      a = (q_e / m_e) E

Discretization: eigenvalues of the standard 7-point Laplacian,
    lambda(k) = -(2 - 2 cos(2 pi k / N)) / h^2  summed over axes,
so that the *discrete* Laplacian of the returned phi reproduces -rho/eps0
exactly (tests/test_poisson_fft.py checks this to f32 roundoff).  The
gradient uses central differences, matching the solver's stencil order.

rho is the deposited electron count per cell times e / cell_volume
(charge density); with e < 0 the field pushes electrons apart, consistent
in sign with the reference's repulsive Electric_Force_Constant model.

Everything is real-to-complex FFT on the 3-D grid — a dense transform that
XLA lowers to the platform's FFT library (cuFFT on the GPU).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..constants import ELECTRON_CHARGE, ELECTRON_MASS, EPSILON0


def _laplacian_eigenvalues(shape, cell_size):
    """lambda[kx,ky,kz] (negative semidefinite), rfftn layout on last axis."""
    gx, gy, gz = shape
    h2 = cell_size * cell_size

    def eig(n, rfft=False):
        k = jnp.arange(n // 2 + 1 if rfft else n, dtype=jnp.float32)
        return -(2.0 - 2.0 * jnp.cos(2.0 * jnp.pi * k / n)) / h2

    ex = eig(gx)[:, None, None]
    ey = eig(gy)[None, :, None]
    ez = eig(gz, rfft=True)[None, None, :]
    return ex + ey + ez


def solve_potential(charge_counts, cell_size):
    """phi grid (f32) from integer electron counts per cell.

    The k=0 (mean) mode is zeroed — the standard neutralizing-background
    convention for periodic plasmas (only the mean-free part of rho has a
    periodic solution).
    """
    shape = charge_counts.shape
    rho = charge_counts.astype(jnp.float32) * (
        ELECTRON_CHARGE / (cell_size**3)
    )
    rhs = -rho / EPSILON0
    rhs_k = jnp.fft.rfftn(rhs)
    lam = _laplacian_eigenvalues(shape, cell_size)
    lam = lam.at[0, 0, 0].set(1.0)  # avoid 0/0; mode zeroed below
    phi_k = rhs_k / lam
    phi_k = phi_k.at[0, 0, 0].set(0.0)
    return jnp.fft.irfftn(phi_k, s=shape).astype(jnp.float32)


def acceleration_grid(charge_counts, cell_size):
    """(gx, gy, gz, 3) electron acceleration field a = (q/m) * (-grad phi)."""
    phi = solve_potential(charge_counts, cell_size)
    inv2h = 1.0 / (2.0 * cell_size)

    def grad(axis):
        return (jnp.roll(phi, -1, axis) - jnp.roll(phi, 1, axis)) * inv2h

    e_field = -jnp.stack([grad(0), grad(1), grad(2)], axis=-1)
    return e_field * jnp.float32(ELECTRON_CHARGE / ELECTRON_MASS)


def gather_acceleration_fft(charge_flat, pos, weight, cell_size, grid_size):
    """Drop-in counterpart of ops.grid.gather_acceleration for the FFT
    field model."""
    from ..ops.grid import cell_indices

    acc_grid = acceleration_grid(
        charge_flat.reshape(grid_size), cell_size
    ).reshape(-1, 3)
    idx = cell_indices(pos, cell_size, grid_size)
    gx, gy, gz = grid_size
    flat = (idx[:, 0] * gy + idx[:, 1]) * gz + idx[:, 2]
    acc = acc_grid[flat]
    return jnp.where(weight[:, None] > 0, acc, 0.0)
