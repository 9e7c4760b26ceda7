"""Fourier-mode external field actuator.

Capability parity with class ``E_field``
(`/root/reference/src/control/actuator.py:4-63`):

    E_in(x) = sum_{n=1..K} a_n cos(k_n x) + b_n sin(k_n x),  k_n = 2 pi n / L

evaluated on the mesh as one (M, K) basis matmul. The basis is precomputed
once; ``compute_e`` is a pure function of the coefficient vector so it can sit
inside jitted rollouts, be vmapped over candidate control sequences, and be
differentiated for the QP correction.

Reference quirk preserved behind a flag: the reference builds the mesh with
``np.linspace(0, L, N_mesh)`` *including* the endpoint
(`actuator.py:13`), which is not the PIC cell-edge grid ``j*dx``.
``endpoint_grid=True`` (default) reproduces that exactly; ``False`` uses the
correct periodic grid.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["FourierActuator", "EField", "make_actuator"]


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["basis_cos", "basis_sin", "wavenumbers"],
    meta_fields=["length", "n_mesh", "max_mode"],
)
@dataclasses.dataclass(frozen=True)
class FourierActuator:
    length: float
    n_mesh: int
    max_mode: int
    basis_cos: jax.Array  # (M, K)
    basis_sin: jax.Array  # (M, K)
    wavenumbers: jax.Array  # (K,)

    def compute_e(self, coeff_cos: jax.Array, coeff_sin: jax.Array) -> jax.Array:
        """External mesh field from coefficients (parity with
        ``E_field.compute_E``, `/root/reference/src/control/actuator.py:54-63`).

        Accepts (..., K) batched coefficients; returns (..., M). Full
        float32 precision: the GPU may otherwise run these products in TF32.
        """
        hi = jax.lax.Precision.HIGHEST
        return (jnp.matmul(coeff_cos, self.basis_cos.T, precision=hi)
                + jnp.matmul(coeff_sin, self.basis_sin.T, precision=hi))

    def compute_e_packed(self, coeffs: jax.Array) -> jax.Array:
        """Packed (..., 2K) = [cos coeffs, sin coeffs] -> (..., M) field.

        Matches the RL action layout ``a[:K], a[K:]``
        (`/root/reference/src/control/rl/ddpg.py:445`).
        """
        k = self.max_mode
        return self.compute_e(coeffs[..., :k], coeffs[..., k:])

    def input_energy(self, coeffs: jax.Array) -> jax.Array:
        """Control-effort cost sum(a^2) * L * 0.25 — the discrete
        integral of E_in^2/2 for orthogonal Fourier modes (parity with
        ``Reward.compute_input_energy``,
        `/root/reference/src/control/rl/reward.py:52-54`)."""
        return jnp.sum(coeffs**2, axis=-1) * self.length * 0.25


class EField:
    """Stateful convenience wrapper mirroring the reference class API
    (`/root/reference/src/control/actuator.py:4-63`): ``update_params``,
    ``reinit``, ``update_E``, ``compute_E`` with held coefficients. The
    functional :class:`FourierActuator` is the compiled-path citizen; this
    class exists for drop-in script parity."""

    def __init__(self, length: float, n_mesh: int, max_mode: int, endpoint_grid: bool = True):
        self.length = length
        self.n_mesh = n_mesh
        self.max_mode = max_mode
        self.endpoint_grid = endpoint_grid
        self.reinit()

    def update_params(self, **kwargs):
        changed = False
        for k, v in kwargs.items():
            if hasattr(self, k) and v is not None:
                setattr(self, k, v)
                changed = True
        if changed:
            self.reinit()

    def reinit(self):
        self.actuator = make_actuator(self.length, self.n_mesh, self.max_mode, self.endpoint_grid)
        self.coeff_cos = jnp.zeros(self.max_mode)
        self.coeff_sin = jnp.zeros(self.max_mode)

    def update_e(self, coeff_cos=None, coeff_sin=None):
        if coeff_cos is not None:
            self.coeff_cos = jnp.asarray(coeff_cos).reshape(-1)
        if coeff_sin is not None:
            self.coeff_sin = jnp.asarray(coeff_sin).reshape(-1)

    # reference-name alias
    update_E = update_e

    def compute_e(self, coeff_cos=None, coeff_sin=None) -> jax.Array:
        a = self.coeff_cos if coeff_cos is None else jnp.asarray(coeff_cos).reshape(-1)
        b = self.coeff_sin if coeff_sin is None else jnp.asarray(coeff_sin).reshape(-1)
        return self.actuator.compute_e(a, b)

    compute_E = compute_e


def make_actuator(
    length: float,
    n_mesh: int,
    max_mode: int,
    endpoint_grid: bool = True,
    dtype=jnp.float32,
) -> FourierActuator:
    if endpoint_grid:
        xm = np.linspace(0.0, length, n_mesh)  # reference parity (actuator.py:13)
    else:
        xm = (length / n_mesh) * np.arange(n_mesh)
    k = 2.0 * np.pi / length * np.arange(1, max_mode + 1)
    basis_cos = np.cos(np.outer(xm, k))
    basis_sin = np.sin(np.outer(xm, k))
    np_dtype = np.dtype(jnp.dtype(dtype).name)
    # Host numpy leaves: safe to build/cache inside jit traces (see
    # ops/grid.py make_grid note); baked as constants under jit.
    return FourierActuator(
        length=float(length),
        n_mesh=n_mesh,
        max_mode=max_mode,
        basis_cos=np.asarray(basis_cos, dtype=np_dtype),
        basis_sin=np.asarray(basis_sin, dtype=np_dtype),
        wavenumbers=np.asarray(k, dtype=np_dtype),
    )
