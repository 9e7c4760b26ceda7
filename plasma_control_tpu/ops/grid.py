"""Periodic 1D grid and spectral field operators.

Compiled re-design of the reference's dense finite-difference operator stack
(`/root/reference/src/env/util.py:8-46` ``generate_grad``/``generate_laplacian``
and `/root/reference/src/env/solve.py:28-53` ``Gaussian_Elimination_Periodic``).

The reference builds a dense periodic central-difference gradient matrix G and a
dense periodic 3-point Laplacian A, then solves ``A @ phi = n - n0`` by Gaussian
elimination with a Sherman-Morrison rank-1 trick and finally forms
``E = -G @ phi``. Both A and G are *circulant*, hence simultaneously
diagonalized by the DFT with eigenvalues

    lambda_k = (2*cos(2*pi*k/M) - 2) / dx**2        (Laplacian)
    g_k      = 1j*sin(2*pi*k/M) / dx                (gradient)

so the entire chain  ``n -> phi -> E``  collapses into a single real circulant
matmul ``E_mesh = E_OP @ (n - n0)`` with ``E_OP = F^-1 diag(-g_k/lambda_k) F``
(the k=0 null mode is pinned to zero; the reference's rank-1 "gamma" trick
produces a solution that differs only by an additive constant, which G
annihilates exactly, so the electric fields agree to rounding).

One (M, M) matmul replaces the reference's sequential O(M)
elimination loop; for batched rollouts this becomes a single (B, M) @ (M, M)
matmul. An rFFT-based path is kept for large meshes and for diagnostics.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["Grid", "make_grid", "fd_laplacian_eigenvalues", "fd_gradient_eigenvalues"]


def fd_laplacian_eigenvalues(n_mesh: int, dx: float) -> np.ndarray:
    """Eigenvalues of the periodic 3-point FD Laplacian (real, <= 0)."""
    k = np.arange(n_mesh)
    return (2.0 * np.cos(2.0 * np.pi * k / n_mesh) - 2.0) / dx**2


def fd_gradient_eigenvalues(n_mesh: int, dx: float) -> np.ndarray:
    """Eigenvalues of the periodic central-difference gradient (imaginary)."""
    k = np.arange(n_mesh)
    return 1j * np.sin(2.0 * np.pi * k / n_mesh) / dx


def _circulant_from_eigenvalues(d: np.ndarray) -> np.ndarray:
    """Dense circulant matrix with DFT eigenvalues ``d`` (first column ifft(d))."""
    m = d.shape[0]
    col = np.fft.ifft(d)
    idx = (np.arange(m)[:, None] - np.arange(m)[None, :]) % m
    mat = col[idx]
    assert np.max(np.abs(mat.imag)) < 1e-10 * max(1.0, np.max(np.abs(mat.real)))
    return np.ascontiguousarray(mat.real)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["e_op", "phi_op", "inv_lap_eig", "e_eig_r", "e_eig_i", "cells"],
    meta_fields=["n_mesh", "length"],
)
@dataclasses.dataclass(frozen=True)
class Grid:
    """Periodic mesh geometry plus precomputed field-solve operators.

    ``e_op``/``phi_op`` are real (M, M) circulant operators such that
    ``E_mesh = e_op @ (n - n0)`` and ``phi_mesh = phi_op @ (n - n0)`` reproduce
    the reference's FD solve (`/root/reference/src/env/util.py:99-100`) up to an
    additive constant in phi. ``inv_lap_eig``/``e_eig_*`` support the rFFT path.
    """

    n_mesh: int
    length: float
    e_op: jax.Array  # (M, M) real:  n-n0 -> E_mesh
    phi_op: jax.Array  # (M, M) real:  n-n0 -> phi_mesh (zero-mean gauge)
    inv_lap_eig: jax.Array  # (M,) real: 1/lambda_k, 0 at k=0
    e_eig_r: jax.Array  # (M,) real part of -g_k/lambda_k (== 0)
    e_eig_i: jax.Array  # (M,) imag part of -g_k/lambda_k
    cells: jax.Array  # (M,) cell-edge coordinates j*dx

    @property
    def dx(self) -> float:
        return self.length / self.n_mesh

    def with_dtype(self, dtype) -> "Grid":
        return Grid(
            n_mesh=self.n_mesh,
            length=self.length,
            e_op=self.e_op.astype(dtype),
            phi_op=self.phi_op.astype(dtype),
            inv_lap_eig=self.inv_lap_eig.astype(dtype),
            e_eig_r=self.e_eig_r.astype(dtype),
            e_eig_i=self.e_eig_i.astype(dtype),
            cells=self.cells.astype(dtype),
        )


def make_grid(n_mesh: int, length: float, dtype=jnp.float32) -> Grid:
    """Build a periodic grid with operators computed in float64 on host."""
    dx = length / n_mesh
    lam = fd_laplacian_eigenvalues(n_mesh, dx)
    g = fd_gradient_eigenvalues(n_mesh, dx)

    inv_lam = np.zeros(n_mesh)
    inv_lam[1:] = 1.0 / lam[1:]  # pin the k=0 (constant) null mode

    e_eig = -g * inv_lam  # purely imaginary
    e_op = _circulant_from_eigenvalues(e_eig)
    phi_op = _circulant_from_eigenvalues(inv_lam.astype(complex))

    cells = dx * np.arange(n_mesh)
    np_dtype = np.dtype(jnp.dtype(dtype).name)
    # NOTE: leaves are host numpy arrays, NOT jnp arrays. This makes Grid
    # safe to construct and cache inside jit traces (jnp.asarray under a
    # trace would produce tracers that leak through module-level caches);
    # under jit they are baked as constants, in eager mode converted on use.
    return Grid(
        n_mesh=n_mesh,
        length=float(length),
        e_op=np.asarray(e_op, dtype=np_dtype),
        phi_op=np.asarray(phi_op, dtype=np_dtype),
        inv_lap_eig=np.asarray(inv_lam, dtype=np_dtype),
        e_eig_r=np.asarray(e_eig.real, dtype=np_dtype),
        e_eig_i=np.asarray(e_eig.imag, dtype=np_dtype),
        cells=np.asarray(cells, dtype=np_dtype),
    )
