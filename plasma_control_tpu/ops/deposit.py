"""Charge deposition (scatter) and field gather.

Capability parity with `/root/reference/src/env/interpolate.py:4-44` (``CIC`` and
``TSC``), two implementations of the same weights:

* **dense** path (default): evaluate the particle-shape function for every
  (particle, cell) pair and reduce. XLA fuses the weight computation into the
  reduction (deposit) and the matrix-vector product (gather), so the (N, M)
  weight tensor is not materialized in device memory. No scatter-adds, fully
  deterministic, vmap/shard-friendly.
* **scatter** path: ``.at[idx].add(w)`` segment-sum (atomic adds on the GPU),
  O(N) work instead of O(N*M).

Normalization matches the reference exactly: ``n *= n0 * L / N / dx``
(`/root/reference/src/env/interpolate.py:18`).

NOTE on TSC parity: the reference's TSC weights
(`/root/reference/src/env/interpolate.py:28-32`) are a *shifted* quadratic
B-spline — ``w_m = 0.75 - (dist-1)**2`` is negative for ``dist < 0.5`` — i.e.
not the textbook TSC kernel. ``kind="tsc"`` reproduces those exact weights for
behavioral parity; ``kind="tsc_standard"`` provides the textbook
cell-centered TSC.
"""

from __future__ import annotations

from functools import partial
from typing import Literal

import jax
import jax.numpy as jnp

from .grid import Grid

Kind = Literal["cic", "tsc", "tsc_standard"]
Method = Literal["dense", "scatter"]

__all__ = ["deposit", "gather", "shape_weights_dense", "shape_weights_from_offset", "deposit_and_gather_indices"]


def _wrapped_offset(x: jax.Array, grid: Grid) -> jax.Array:
    """(N, M) periodic offset in cell units: pos_p - j wrapped to [-M/2, M/2)."""
    m = grid.n_mesh
    pos = x / grid.dx  # (N,)
    j = jnp.arange(m, dtype=x.dtype)  # (M,)
    d = pos[:, None] - j[None, :]
    return d - m * jnp.round(d / m)


def shape_weights_from_offset(d: jax.Array, kind: Kind = "cic") -> jax.Array:
    """Shape-function weight w(d) of a periodically wrapped cell-unit offset.

    The single source of the three weight formulas for the dense path.
    Shape-polymorphic (elementwise in ``d``).
    """
    if kind == "cic":
        return jnp.maximum(0.0, 1.0 - jnp.abs(d))
    if kind == "tsc":
        # Reference-parity shifted kernel (see module docstring):
        #   cell j-1 (offset d in [1,2)):   0.5*(2.5-d)^2
        #   cell j   (offset d in [0,1)):   0.75-(d-1)^2
        #   cell j+1 (offset d in [-1,0)):  0.5*(d+0.5)^2
        return jnp.where(
            (d >= 1.0) & (d < 2.0),
            0.5 * (2.5 - d) ** 2,
            jnp.where(
                (d >= 0.0) & (d < 1.0),
                0.75 - (d - 1.0) ** 2,
                jnp.where((d >= -1.0) & (d < 0.0), 0.5 * (d + 0.5) ** 2, 0.0),
            ),
        )
    if kind == "tsc_standard":
        a = jnp.abs(d)
        return jnp.where(
            a <= 0.5,
            0.75 - a**2,
            jnp.where(a <= 1.5, 0.5 * (1.5 - a) ** 2, 0.0),
        )
    raise ValueError(f"unknown interpolation kind: {kind}")


def shape_weights_dense(x: jax.Array, grid: Grid, kind: Kind = "cic") -> jax.Array:
    """Dense (N, M) shape-function weights; rows sum to 1 (partition of unity)."""
    return shape_weights_from_offset(_wrapped_offset(x, grid), kind)


def deposit_and_gather_indices(x: jax.Array, grid: Grid, kind: Kind = "cic"):
    """Scatter-path indices and weights, mirroring the reference layout.

    CIC: returns ((idx_l, idx_r), (w_l, w_r)) — `interpolate.py:8-14`.
    TSC: returns ((idx_l, idx_m, idx_r), (w_l, w_m, w_r)) — `interpolate.py:26-36`.
    """
    m = grid.n_mesh
    pos = jnp.mod(x, grid.length) / grid.dx
    base = jnp.floor(pos).astype(jnp.int32)
    frac = pos - base
    if kind == "cic":
        idx_l = jnp.mod(base, m)
        idx_r = jnp.mod(base + 1, m)
        return (idx_l, idx_r), (1.0 - frac, frac)
    if kind == "tsc":
        w_l = 0.5 * (1.5 - frac) ** 2
        w_m = 0.75 - (frac - 1.0) ** 2
        w_r = 0.5 * (frac - 0.5) ** 2
        idx_m = jnp.mod(base, m)
        return (jnp.mod(base - 1, m), idx_m, jnp.mod(base + 1, m)), (w_l, w_m, w_r)
    if kind == "tsc_standard":
        # center on nearest cell, offsets relative to it
        c = jnp.round(pos).astype(jnp.int32)
        u = pos - c
        w_m = 0.75 - u**2
        w_l = 0.5 * (0.5 - u) ** 2
        w_r = 0.5 * (0.5 + u) ** 2
        return (jnp.mod(c - 1, m), jnp.mod(c, m), jnp.mod(c + 1, m)), (w_l, w_m, w_r)
    raise ValueError(f"unknown interpolation kind: {kind}")


@partial(jax.jit, static_argnames=("kind", "method", "normalize"))
def deposit(
    x: jax.Array,
    grid: Grid,
    n0: float = 1.0,
    kind: Kind = "cic",
    method: Method = "dense",
    normalize: bool = True,
) -> jax.Array:
    """Deposit particle charge onto the mesh; returns density n of shape (M,).

    Equivalent to ``CIC``/``TSC`` + normalization in
    `/root/reference/src/env/interpolate.py:16-18`.
    """
    n_particles = x.shape[0]
    if method == "dense":
        w = shape_weights_dense(jnp.mod(x, grid.length), grid, kind)
        n = jnp.sum(w, axis=0)
    else:
        idxs, ws = deposit_and_gather_indices(x, grid, kind)
        n = jnp.zeros(grid.n_mesh, dtype=x.dtype)
        for idx, w in zip(idxs, ws):
            n = n.at[idx].add(w)
    if normalize:
        n = n * (n0 * grid.length / n_particles / grid.dx)
    return n


@partial(jax.jit, static_argnames=("kind", "method"))
def gather(
    field_mesh: jax.Array,
    x: jax.Array,
    grid: Grid,
    kind: Kind = "cic",
    method: Method = "dense",
) -> jax.Array:
    """Interpolate a mesh field to particle positions with the same weights.

    Equivalent to the weighted fancy-index gather in
    `/root/reference/src/env/util.py:105-111`.
    """
    if method == "dense":
        w = shape_weights_dense(jnp.mod(x, grid.length), grid, kind)
        # (N, M) @ (M,); XLA fuses the weight computation in. Full float32
        # precision: the GPU may otherwise run this product in TF32.
        return jnp.matmul(w, field_mesh, precision=jax.lax.Precision.HIGHEST)
    idxs, ws = deposit_and_gather_indices(x, grid, kind)
    out = jnp.zeros_like(x)
    for idx, w in zip(idxs, ws):
        out = out + w * field_mesh[idx]
    return out
