"""Native C++ reference-kernel library tests: cross-validate against both the
NumPy oracle and the JAX path."""

import numpy as np
import jax.numpy as jnp
import pytest

from plasma_control_tpu.ops.grid import make_grid
from plasma_control_tpu.ops.fields import solve_e_mesh
from plasma_control_tpu.utils.native import load_library, native_rollout, native_solve_e, native_step

import oracle

L, M, N = 50.0, 64, 2000

needs_native = pytest.mark.skipif(load_library() is None, reason="native library unavailable")


@needs_native
class TestNative:
    def test_solve_matches_oracle(self, rng):
        rho = 0.1 * rng.standard_normal(M)
        rho -= rho.mean()  # consistent RHS
        e_native = native_solve_e(rho, L)
        e_oracle = oracle.solve_e_mesh(rho + 1.0, L, 1.0)
        np.testing.assert_allclose(e_native, e_oracle, rtol=1e-8, atol=1e-10)

    def test_solve_matches_jax(self, rng):
        rho = 0.1 * rng.standard_normal(M)
        rho -= rho.mean()
        e_native = native_solve_e(rho, L)
        grid = make_grid(M, L)
        e_jax = np.asarray(solve_e_mesh(jnp.asarray(rho + 1.0, dtype=jnp.float32), grid, 1.0))
        np.testing.assert_allclose(e_native, e_jax, atol=1e-5)

    def test_step_matches_oracle(self, rng):
        x = rng.uniform(0, L, N)
        v = rng.standard_normal(N)
        dt = 0.1
        xn, vn, pe = native_step(x.copy(), v.copy(), M, L, dt)
        xo, vo = oracle.yoshida4_step(x.copy(), v.copy(), L, M, 1.0, dt)
        np.testing.assert_allclose(xn, xo, rtol=1e-8, atol=1e-8)
        np.testing.assert_allclose(vn, vo, rtol=1e-8, atol=1e-8)
        pe_o = oracle.electric_energy(xo, L, M, 1.0)
        assert abs(pe - pe_o) / pe_o < 1e-6

    def test_step_with_external_field(self, rng):
        x = rng.uniform(0, L, N)
        v = rng.standard_normal(N)
        e_ext = 0.05 * np.sin(2 * np.pi * np.arange(M) / M)
        xn, vn, _ = native_step(x.copy(), v.copy(), M, L, 0.1, e_external=e_ext)
        xo, vo = oracle.yoshida4_step(x.copy(), v.copy(), L, M, 1.0, 0.1, e_ext)
        np.testing.assert_allclose(vn, vo, rtol=1e-8, atol=1e-8)

    def test_rollout_energy_series(self, rng):
        x = rng.uniform(0, L, N)
        v = rng.standard_normal(N)
        _, _, pe = native_rollout(x, v, M, L, 0.1, 20)
        assert pe.shape == (20,)
        assert np.isfinite(pe).all() and (pe > 0).all()
