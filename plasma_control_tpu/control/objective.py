"""Objective functionals: phase-space histogram, KL divergence, field energy.

Capability parity with `/root/reference/src/control/objective.py:8-35`
(``estimate_f``, ``estimate_KL_divergence``, ``estimate_electric_energy``),
as pure jittable functions. Histograms use index bucketing + scatter-add
(bin counts are static shapes).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from ..ops.deposit import deposit
from ..ops.fields import solve_e_mesh
from ..ops.grid import Grid

EPS = 1e-12  # `/root/reference/src/control/objective.py:6`

__all__ = ["estimate_f", "estimate_kl_divergence", "estimate_electric_energy", "phase_space_histogram"]


@partial(jax.jit, static_argnames=("bins",))
def phase_space_histogram(
    x: jax.Array,
    v: jax.Array,
    bins: int,
    length: float,
    vmin: float,
    vmax: float,
) -> jax.Array:
    """2D (x, v) histogram over [0, L] x [vmin, vmax] with ``bins`` bins per
    axis, matching ``np.histogram2d`` edge semantics (rightmost edge
    inclusive; out-of-range samples dropped)."""
    fx = x / length * bins
    fv = (v - vmin) / (vmax - vmin) * bins
    ix = jnp.floor(fx).astype(jnp.int32)
    iv = jnp.floor(fv).astype(jnp.int32)
    # np.histogram2d puts samples equal to the right edge in the last bin
    ix = jnp.where(fx == bins, bins - 1, ix)
    iv = jnp.where(fv == bins, bins - 1, iv)
    valid = (ix >= 0) & (ix < bins) & (iv >= 0) & (iv < bins)
    flat = jnp.where(valid, ix * bins + iv, bins * bins)  # invalid -> overflow slot
    hist = jnp.zeros(bins * bins + 1, dtype=x.dtype).at[flat].add(1.0)
    return hist[:-1].reshape(bins, bins)


@partial(jax.jit, static_argnames=("n_mesh",))
def estimate_f(
    state: jax.Array,
    n_mesh: int,
    length: float,
    vmin: float,
    vmax: float,
    n0: float,
) -> jax.Array:
    """Normalized f(x, v) from a packed (2N,) state (parity with
    ``estimate_f``, `/root/reference/src/control/objective.py:8-14`)."""
    n = state.shape[0] // 2
    dx = length / n_mesh
    dv = (vmax - vmin) / n_mesh
    hist = phase_space_histogram(state[:n], state[n:], n_mesh, length, vmin, vmax)
    return hist * (n0 / dx / dv / n)


@jax.jit
def estimate_kl_divergence(f: jax.Array, feq: jax.Array, dx: float = 0.1, dv: float = 0.04) -> jax.Array:
    """sum rel_entr(f, feq + eps) dx dv (parity with
    `/root/reference/src/control/objective.py:16-18`). ``rel_entr(x, y)`` is
    x*log(x/y) for x > 0 and 0 for x == 0 (y > 0 always holds here)."""
    y = feq + EPS
    terms = jnp.where(f > 0, f * (jnp.log(jnp.where(f > 0, f, 1.0)) - jnp.log(y)), 0.0)
    return jnp.sum(terms) * dx * dv


@partial(jax.jit, static_argnames=("n_mesh", "length"))
def estimate_electric_energy(
    state: jax.Array,
    e_external: Optional[jax.Array],
    n_mesh: int,
    length: float,
    n0: float,
) -> jax.Array:
    """Re-deposit + re-solve field energy from a packed state (parity with
    `/root/reference/src/control/objective.py:20-35`). NOTE: unlike
    ``compute_electric_energy`` in the env layer, the reference does *not*
    rescale by N/L here (the rescale line is commented out, `objective.py:34`)
    — we preserve that behavior for cost parity.
    """
    n_particles = state.shape[0] // 2
    x = state[:n_particles]
    grid = _grid_cache(n_mesh, float(length), state.dtype)
    dens = deposit(x, grid, n0=n0, kind="cic", method="dense")
    e_mesh = solve_e_mesh(dens, grid, n0)
    if e_external is not None:
        e_mesh = e_mesh + e_external
    return 0.5 * jnp.sum(e_mesh * e_mesh) * grid.dx


_GRIDS = {}


def _grid_cache(n_mesh: int, length: float, dtype) -> Grid:
    from ..ops.grid import make_grid

    key = (n_mesh, length, jnp.dtype(dtype).name)
    if key not in _GRIDS:
        _GRIDS[key] = make_grid(n_mesh, length, dtype=dtype)
    return _GRIDS[key]
