"""Independent NumPy float64 oracle of the reference semantics.

Written from scratch against the *documented behavior* of
`/root/reference/src/env/` (not copied): dense FD operators, bincount
deposition, exact linear-algebra Poisson solve, and an explicit
drift/kick Yoshida-4 composition matching the reference's stage order
(`integration.py:60-75` with `_symplectic_forward_step` semantics).
Used by tests to validate the JAX implementation numerically.
"""

from __future__ import annotations

import numpy as np


def grad_matrix(length: float, m: int) -> np.ndarray:
    """Periodic central-difference gradient (`env/util.py:8-26` behavior)."""
    dx = length / m
    g = np.zeros((m, m))
    i = np.arange(m)
    g[i, (i + 1) % m] = 1.0
    g[i, (i - 1) % m] = -1.0
    return g / (2.0 * dx)


def laplacian_matrix(length: float, m: int) -> np.ndarray:
    """Periodic 3-point Laplacian (`env/util.py:29-46` behavior)."""
    dx = length / m
    a = np.zeros((m, m))
    i = np.arange(m)
    a[i, i] = -2.0
    a[i, (i + 1) % m] = 1.0
    a[i, (i - 1) % m] = 1.0
    return a / dx**2


def deposit_cic(x: np.ndarray, n0: float, length: float, m: int) -> np.ndarray:
    """CIC deposition with the reference's normalization (`interpolate.py:4-20`)."""
    n_p = x.shape[0]
    dx = length / m
    x = np.mod(x, length)
    il = np.floor(x / dx).astype(int)
    frac = x / dx - il
    n = np.bincount(il % m, weights=1.0 - frac, minlength=m)
    n += np.bincount((il + 1) % m, weights=frac, minlength=m)
    return n * (n0 * length / n_p / dx)


def deposit_tsc(x: np.ndarray, n0: float, length: float, m: int) -> np.ndarray:
    """Reference-parity (shifted-kernel) TSC deposition (`interpolate.py:22-44`)."""
    n_p = x.shape[0]
    dx = length / m
    x = np.mod(x, length)
    im = np.floor(x / dx).astype(int)
    d = x / dx - im
    w_l = 0.5 * (1.5 - d) ** 2
    w_m = 0.75 - (d - 1.0) ** 2
    w_r = 0.5 * (d - 0.5) ** 2
    n = np.bincount((im - 1) % m, weights=w_l, minlength=m)
    n += np.bincount(im % m, weights=w_m, minlength=m)
    n += np.bincount((im + 1) % m, weights=w_r, minlength=m)
    return n * (n0 * length / n_p / dx)


def solve_e_mesh(n: np.ndarray, length: float, n0: float = 1.0) -> np.ndarray:
    """Exact solve of A phi = n - n0 (zero-mean gauge) then E = -G phi.

    The reference's Sherman–Morrison/gamma solution differs from any exact
    solution of the singular system only by an additive constant, which the
    gradient matrix annihilates, so E agrees.
    """
    m = n.shape[0]
    a = laplacian_matrix(length, m)
    rhs = n - n0
    # Pin the zero mode: append the constraint sum(phi) = 0.
    aug = np.vstack([a, np.ones((1, m))])
    rhs_aug = np.concatenate([rhs, [0.0]])
    phi, *_ = np.linalg.lstsq(aug, rhs_aug, rcond=None)
    return -grad_matrix(length, m) @ phi


def gather_cic(field: np.ndarray, x: np.ndarray, length: float, m: int) -> np.ndarray:
    dx = length / m
    x = np.mod(x, length)
    il = np.floor(x / dx).astype(int)
    frac = x / dx - il
    return (1.0 - frac) * field[il % m] + frac * field[(il + 1) % m]


def accel(x: np.ndarray, length: float, m: int, n0: float, e_external=None) -> np.ndarray:
    n = deposit_cic(x, n0, length, m)
    e_mesh = solve_e_mesh(n, length, n0)
    if e_external is not None:
        e_mesh = e_mesh + e_external
    return -gather_cic(e_mesh, x, length, m)


def yoshida4_step(x, v, length, m, n0, dt, e_external=None):
    """Drift/kick composition identical to the reference's stage order."""
    phi = 2.0 ** (1.0 / 3.0)
    w0 = -phi / (2.0 - phi)
    w1 = 1.0 / (2.0 - phi)
    c = [0.5 * w1, 0.5 * (w0 + w1), 0.5 * (w0 + w1), 0.5 * w1]
    d = [w1, w0, w1]
    x = x + c[0] * dt * v
    for ci, di in zip(c[1:], d):
        v = v + di * dt * accel(x, length, m, n0, e_external)
        x = x + ci * dt * v
    return np.mod(x, length), v


def electric_energy(x, length, m, n0, n_particles=None):
    n_p = n_particles if n_particles is not None else x.shape[0]
    e_mesh = solve_e_mesh(deposit_cic(x, n0, length, m), length, n0)
    return 0.5 * np.sum(e_mesh**2) * (length / m) * n_p / length


def hamiltonian(x, v, length, m, n0):
    return 0.5 * np.sum(v * v) + electric_energy(x, length, m, n0)
