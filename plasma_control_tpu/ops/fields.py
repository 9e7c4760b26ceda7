"""Field pipeline: density -> potential -> electric field -> particle forces.

Capability parity with `/root/reference/src/env/util.py:48-147`
(``compute_n``, ``compute_E``, ``compute_electric_energy``,
``compute_hamiltonian``) re-designed as pure functions:

* the Poisson solve + gradient is a single circulant matmul (see
  :mod:`plasma_control_tpu.ops.grid`) or an rFFT, instead of the reference's
  Numba Gaussian elimination (`/root/reference/src/env/solve.py:28-53`) and
  dense gradient matmul (`/root/reference/src/env/util.py:100`);
* nothing is recomputed: callers thread ``(n, e_mesh)`` through functionally
  instead of the reference's ~11 redundant deposit+solve pipelines per step
  (see SURVEY.md §3.1).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from .deposit import Kind, Method, deposit, gather
from .grid import Grid

__all__ = [
    "solve_e_mesh",
    "solve_phi_mesh",
    "solve_e_mesh_fft",
    "compute_density",
    "compute_e",
    "electric_energy",
    "kinetic_energy",
    "hamiltonian",
]


def solve_e_mesh(n: jax.Array, grid: Grid, n0: float = 1.0) -> jax.Array:
    """E_mesh from density via one circulant matmul (batched-friendly).

    Replaces ``Gaussian_Elimination_Periodic`` + ``-grad @ phi``
    (`/root/reference/src/env/util.py:99-100`). ``n`` may have leading batch
    dims; the matmul contracts the last axis. Full float32 precision: the
    GPU may otherwise run this product in TF32.
    """
    return jnp.matmul(n - n0, grid.e_op.T, precision=jax.lax.Precision.HIGHEST)


def solve_phi_mesh(n: jax.Array, grid: Grid, n0: float = 1.0) -> jax.Array:
    """phi_mesh (zero-mean gauge) from density. The reference's phi differs by
    an additive constant only (its rank-1 'gamma' regularization picks an
    arbitrary gauge), which never affects E or any published diagnostic."""
    return jnp.matmul(n - n0, grid.phi_op.T, precision=jax.lax.Precision.HIGHEST)


def solve_e_mesh_fft(n: jax.Array, grid: Grid, n0: float = 1.0) -> jax.Array:
    """rFFT path for large meshes; identical semantics to :func:`solve_e_mesh`."""
    m = grid.n_mesh
    nk = jnp.fft.rfft(n - n0, axis=-1)
    eig = (grid.e_eig_r + 1j * grid.e_eig_i)[: m // 2 + 1]
    return jnp.fft.irfft(nk * eig, n=m, axis=-1).astype(n.dtype)


@partial(jax.jit, static_argnames=("kind", "method"))
def compute_density(
    x: jax.Array,
    grid: Grid,
    n0: float = 1.0,
    kind: Kind = "cic",
    method: Method = "dense",
) -> jax.Array:
    """Parity with ``compute_n`` (`/root/reference/src/env/util.py:48-70`)."""
    return deposit(x, grid, n0=n0, kind=kind, method=method)


@partial(jax.jit, static_argnames=("kind", "method", "return_mesh"))
def compute_e(
    x: jax.Array,
    grid: Grid,
    n0: float = 1.0,
    e_external: Optional[jax.Array] = None,
    kind: Kind = "cic",
    method: Method = "dense",
    return_mesh: bool = True,
):
    """Full pipeline: deposit -> solve -> (+ external) -> gather.

    Parity with ``compute_E`` (`/root/reference/src/env/util.py:73-116`): the
    external mesh field is added *before* the gather, so particles feel
    ``E_self + E_ext`` interpolated with the same shape weights.

    Returns ``(e_particles, e_mesh)`` (or just ``e_particles``).
    """
    n = deposit(x, grid, n0=n0, kind=kind, method=method)
    e_mesh = solve_e_mesh(n, grid, n0)
    if e_external is not None:
        e_mesh = e_mesh + e_external
    e_p = gather(e_mesh, x, grid, kind=kind, method=method)
    if return_mesh:
        return e_p, e_mesh
    return e_p


def electric_energy(e_mesh: jax.Array, grid: Grid, n_particles: int) -> jax.Array:
    """PE = (1/2) sum(E^2) dx * N / L — parity with
    ``compute_electric_energy`` (`/root/reference/src/env/util.py:119-131`)."""
    pe = 0.5 * jnp.sum(e_mesh * e_mesh, axis=-1) * grid.dx
    return pe * (n_particles / grid.length)


def kinetic_energy(v: jax.Array) -> jax.Array:
    return 0.5 * jnp.sum(v * v, axis=-1)


@partial(jax.jit, static_argnames=("kind", "method"))
def hamiltonian(
    x: jax.Array,
    v: jax.Array,
    grid: Grid,
    n0: float = 1.0,
    kind: Kind = "cic",
    method: Method = "dense",
) -> jax.Array:
    """H = KE + PE — parity with ``compute_hamiltonian``
    (`/root/reference/src/env/util.py:133-147`). PE uses the *self-consistent*
    field only (no external), as in the reference."""
    n = deposit(x, grid, n0=n0, kind=kind, method=method)
    e_mesh = solve_e_mesh(n, grid, n0)
    return kinetic_energy(v) + electric_energy(e_mesh, grid, x.shape[-1])
