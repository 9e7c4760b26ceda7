"""Unit tests for the numerics kernels (SURVEY §4 test pyramid, level 1)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from plasma_control_tpu.ops.grid import make_grid
from plasma_control_tpu.ops.deposit import deposit, gather, shape_weights_dense
from plasma_control_tpu.ops.fields import (
    compute_e,
    electric_energy,
    hamiltonian,
    solve_e_mesh,
    solve_e_mesh_fft,
    solve_phi_mesh,
)
from plasma_control_tpu.ops.integrate import (
    explicit_midpoint,
    forward_euler,
    implicit_midpoint,
    verlet_step,
    yoshida4_step,
)

import oracle

L = 50.0
M = 64
N = 2000


def _particles(rng, n=N, length=L):
    return rng.uniform(0.0, length, size=n)


# ---------------------------------------------------------------------------
# Deposition
# ---------------------------------------------------------------------------


class TestDeposit:
    @pytest.mark.parametrize("kind", ["cic", "tsc", "tsc_standard"])
    @pytest.mark.parametrize("method", ["dense", "scatter"])
    def test_charge_conservation(self, rng, kind, method):
        """Partition of unity: total deposited charge == n0 * L / dx."""
        x = jnp.asarray(_particles(rng), dtype=jnp.float32)
        grid = make_grid(M, L)
        n = deposit(x, grid, n0=1.0, kind=kind, method=method)
        total = float(jnp.sum(n)) * grid.dx
        assert abs(total - L) < 1e-3

    def test_cic_matches_oracle(self, rng):
        x64 = _particles(rng)
        grid = make_grid(M, L, dtype=jnp.float64) if jax.config.jax_enable_x64 else make_grid(M, L)
        n = np.asarray(deposit(jnp.asarray(x64, dtype=jnp.float32), grid, n0=1.0, kind="cic"))
        n_ref = oracle.deposit_cic(x64, 1.0, L, M)
        np.testing.assert_allclose(n, n_ref, rtol=2e-4, atol=2e-4)

    def test_tsc_matches_oracle(self, rng):
        x64 = _particles(rng)
        grid = make_grid(M, L)
        n = np.asarray(deposit(jnp.asarray(x64, dtype=jnp.float32), grid, n0=1.0, kind="tsc"))
        n_ref = oracle.deposit_tsc(x64, 1.0, L, M)
        np.testing.assert_allclose(n, n_ref, rtol=3e-4, atol=3e-4)

    def test_dense_equals_scatter(self, rng):
        x = jnp.asarray(_particles(rng), dtype=jnp.float32)
        grid = make_grid(M, L)
        for kind in ["cic", "tsc"]:
            nd = deposit(x, grid, kind=kind, method="dense")
            ns = deposit(x, grid, kind=kind, method="scatter")
            np.testing.assert_allclose(np.asarray(nd), np.asarray(ns), rtol=1e-4, atol=1e-4)

    @pytest.mark.parametrize("kind", ["cic", "tsc", "tsc_standard"])
    @pytest.mark.parametrize("op", ["deposit", "gather"])
    def test_scatter_matches_dense(self, rng, kind, op):
        """The scatter path (O(N) index/weight form, atomic adds on the GPU)
        computes the same deposit and gather as the dense (N, M) weights."""
        x = jnp.asarray(_particles(rng), dtype=jnp.float32)
        grid = make_grid(M, L)
        if op == "deposit":
            run = lambda method: deposit(x, grid, kind=kind, method=method)
        else:
            f = jnp.asarray(np.cos(2 * np.pi * 3 * np.arange(M) / M), dtype=jnp.float32)
            run = lambda method: gather(f, x, grid, kind=kind, method=method)
        np.testing.assert_allclose(np.asarray(run("scatter")), np.asarray(run("dense")),
                                   rtol=1e-4, atol=1e-4)

    @pytest.mark.parametrize("kind", ["cic", "tsc", "tsc_standard"])
    def test_scatter_conserves_charge_on_cell_edges(self, kind):
        """Particles exactly on cell edges, at 0 and just below L (the
        periodic wrap) deposit their whole charge through the scatter path."""
        grid = make_grid(M, L)
        x = jnp.asarray(np.concatenate([np.arange(M) * grid.dx, [0.0, L - 1e-4, L / 2]]),
                        dtype=jnp.float32)
        n = deposit(x, grid, n0=1.0, kind=kind, method="scatter", normalize=False)
        assert np.isfinite(np.asarray(n)).all()
        assert abs(float(jnp.sum(n)) - x.shape[0]) < 1e-3

    def test_weights_partition_of_unity(self, rng):
        x = jnp.asarray(_particles(rng, n=100), dtype=jnp.float32)
        grid = make_grid(M, L)
        for kind in ["cic", "tsc", "tsc_standard"]:
            w = shape_weights_dense(x, grid, kind)
            np.testing.assert_allclose(np.asarray(jnp.sum(w, axis=1)), 1.0, atol=1e-5)

    def test_gather_scatter_adjoint(self, rng):
        """<deposit(x) (unnormalized), f> == <1_N, gather(f, x)> — scatter and
        gather use identical weights (adjoint pair)."""
        x = jnp.asarray(_particles(rng, n=500), dtype=jnp.float32)
        grid = make_grid(M, L)
        f = jnp.asarray(np.sin(2 * np.pi * np.arange(M) / M), dtype=jnp.float32)
        n_raw = deposit(x, grid, normalize=False)
        lhs = float(jnp.dot(n_raw, f))
        rhs = float(jnp.sum(gather(f, x, grid)))
        assert abs(lhs - rhs) < 1e-2


# ---------------------------------------------------------------------------
# Poisson / field solve
# ---------------------------------------------------------------------------


class TestFieldSolve:
    def test_matches_oracle_dense_solve(self, rng):
        x64 = _particles(rng)
        n64 = oracle.deposit_cic(x64, 1.0, L, M)
        e_ref = oracle.solve_e_mesh(n64, L, 1.0)
        grid = make_grid(M, L)
        e = np.asarray(solve_e_mesh(jnp.asarray(n64, dtype=jnp.float32), grid, 1.0))
        np.testing.assert_allclose(e, e_ref, rtol=1e-4, atol=1e-5)

    def test_discrete_eigenmode(self):
        """A sin(k x_j) charge must produce E with the *FD* eigenvalue
        relation E_k = -g_k/lambda_k n_k, not the continuum 1/k."""
        grid = make_grid(M, L)
        dx = L / M
        j = np.arange(M)
        mode = 3
        theta = 2 * np.pi * mode * j / M
        n = 1.0 + 0.01 * np.sin(theta)
        lam = (2 * np.cos(2 * np.pi * mode / M) - 2) / dx**2
        g = np.sin(2 * np.pi * mode / M) / dx  # imaginary part of eigenvalue
        # phi = 0.01 sin(theta)/lam;  E = -dphi/dx -> -g*phi in k-space
        expected = -g * 0.01 * np.cos(theta) / lam
        e = np.asarray(solve_e_mesh(jnp.asarray(n, dtype=jnp.float32), grid, 1.0))
        np.testing.assert_allclose(e, expected, atol=1e-5)

    def test_fft_path_matches_matmul_path(self, rng):
        n = jnp.asarray(1.0 + 0.1 * rng.standard_normal(M), dtype=jnp.float32)
        grid = make_grid(M, L)
        np.testing.assert_allclose(
            np.asarray(solve_e_mesh(n, grid)), np.asarray(solve_e_mesh_fft(n, grid)), atol=1e-5
        )

    def test_batched_solve(self, rng):
        nb = jnp.asarray(1.0 + 0.1 * rng.standard_normal((8, M)), dtype=jnp.float32)
        grid = make_grid(M, L)
        out = solve_e_mesh(nb, grid)
        assert out.shape == (8, M)
        single = solve_e_mesh(nb[3], grid)
        np.testing.assert_allclose(np.asarray(out[3]), np.asarray(single), atol=1e-6)

    def test_phi_gradient_consistency(self, rng):
        """E must equal -G @ phi for the FD gradient."""
        n = 1.0 + 0.1 * rng.standard_normal(M)
        grid = make_grid(M, L)
        phi = np.asarray(solve_phi_mesh(jnp.asarray(n, dtype=jnp.float32), grid))
        e = np.asarray(solve_e_mesh(jnp.asarray(n, dtype=jnp.float32), grid))
        g = oracle.grad_matrix(L, M)
        np.testing.assert_allclose(e, -g @ phi, atol=1e-5)

    def test_full_pipeline_matches_oracle(self, rng):
        x64 = _particles(rng)
        grid = make_grid(M, L)
        e_p, e_mesh = compute_e(jnp.asarray(x64, dtype=jnp.float32), grid, 1.0)
        a_ref = -oracle.accel(x64, L, M, 1.0)
        np.testing.assert_allclose(np.asarray(e_p), a_ref, rtol=2e-3, atol=2e-4)


# ---------------------------------------------------------------------------
# Integrators
# ---------------------------------------------------------------------------


def _sho_accel(x):
    return -x  # harmonic oscillator, omega = 1


class TestIntegrators:
    def test_yoshida4_order(self):
        """Global error on the harmonic oscillator must scale ~ dt^4."""
        x0, v0 = jnp.array([1.0]), jnp.array([0.0])
        t_end = 1.0
        errs = []
        for steps in (10, 20):
            dt = t_end / steps
            x, v = x0, v0
            for _ in range(steps):
                x, v = yoshida4_step(x, v, _sho_accel, dt)
            errs.append(abs(float(x[0]) - np.cos(t_end)))
        order = np.log2(errs[0] / errs[1])
        assert order > 3.5, f"observed order {order}"

    def test_verlet_order(self):
        x0, v0 = jnp.array([1.0]), jnp.array([0.0])
        t_end = 1.0
        errs = []
        for steps in (50, 100):
            dt = t_end / steps
            x, v = x0, v0
            for _ in range(steps):
                x, v = verlet_step(x, v, _sho_accel, dt)
            errs.append(abs(float(x[0]) - np.cos(t_end)))
        order = np.log2(errs[0] / errs[1])
        assert 1.7 < order < 2.5, f"observed order {order}"

    def test_energy_conservation_sho(self):
        """Symplectic: energy error stays bounded over many periods."""
        x, v = jnp.array([1.0]), jnp.array([0.0])
        dt = 0.1
        for _ in range(1000):
            x, v = yoshida4_step(x, v, _sho_accel, dt)
        h = 0.5 * (float(x[0]) ** 2 + float(v[0]) ** 2)
        assert abs(h - 0.5) < 1e-6

    def test_generic_integrators_run(self):
        eta = jnp.array([1.0, 0.0])

        def grad(e):
            return jnp.stack([e[1], -e[0]])

        for fn in (forward_euler, explicit_midpoint):
            out = fn(eta, grad, 0.01)
            assert out.shape == (2,)
        out = implicit_midpoint(eta, grad, 0.01)
        assert np.isfinite(np.asarray(out)).all()

    def test_implicit_midpoint_accuracy(self):
        eta = jnp.array([1.0, 0.0])

        def grad(e):
            return jnp.stack([e[1], -e[0]])

        for _ in range(100):
            eta = implicit_midpoint(eta, grad, 0.01)
        assert abs(float(eta[0]) - np.cos(1.0)) < 1e-3


# ---------------------------------------------------------------------------
# Single full PIC step vs oracle
# ---------------------------------------------------------------------------


class TestStepVsOracle:
    def test_one_step_matches_oracle(self, rng):
        from plasma_control_tpu.config import SimConfig
        from plasma_control_tpu.models.pic import PlasmaState, step

        cfg = SimConfig(n_particles=N, n_mesh=M, dt=0.1, length=L)
        grid = make_grid(M, L)
        x64 = _particles(rng)
        v64 = rng.standard_normal(N)

        st = PlasmaState(jnp.asarray(x64, dtype=jnp.float32), jnp.asarray(v64, dtype=jnp.float32))
        out = step(st, grid, cfg)

        xr, vr = oracle.yoshida4_step(x64.copy(), v64.copy(), L, M, 1.0, cfg.clamped_dt())
        np.testing.assert_allclose(np.asarray(out.x), xr, rtol=0, atol=5e-3)
        np.testing.assert_allclose(np.asarray(out.v), vr, rtol=0, atol=5e-3)

    def test_step_with_external_field(self, rng):
        from plasma_control_tpu.config import SimConfig
        from plasma_control_tpu.models.pic import PlasmaState, step

        cfg = SimConfig(n_particles=N, n_mesh=M, dt=0.1, length=L)
        grid = make_grid(M, L)
        x64 = _particles(rng)
        v64 = rng.standard_normal(N)
        e_ext = 0.05 * np.sin(2 * np.pi * np.arange(M) / M)

        st = PlasmaState(jnp.asarray(x64, dtype=jnp.float32), jnp.asarray(v64, dtype=jnp.float32))
        out = step(st, grid, cfg, jnp.asarray(e_ext, dtype=jnp.float32))
        xr, vr = oracle.yoshida4_step(x64.copy(), v64.copy(), L, M, 1.0, cfg.clamped_dt(), e_ext)
        np.testing.assert_allclose(np.asarray(out.x), xr, rtol=0, atol=5e-3)
        np.testing.assert_allclose(np.asarray(out.v), vr, rtol=0, atol=5e-3)

    def test_energies_match_oracle(self, rng):
        grid = make_grid(M, L)
        x64 = _particles(rng)
        v64 = rng.standard_normal(N)
        h = float(
            hamiltonian(jnp.asarray(x64, dtype=jnp.float32), jnp.asarray(v64, dtype=jnp.float32), grid)
        )
        h_ref = oracle.hamiltonian(x64, v64, L, M, 1.0)
        assert abs(h - h_ref) / abs(h_ref) < 1e-3


class TestOddMesh:
    def test_solve_and_deposit_on_odd_mesh(self, rng):
        """Odd cell counts (no Nyquist mode) must work identically."""
        m_odd = 63
        x64 = _particles(rng)
        grid = make_grid(m_odd, L)
        n = np.asarray(deposit(jnp.asarray(x64, dtype=jnp.float32), grid, n0=1.0))
        n_ref = oracle.deposit_cic(x64, 1.0, L, m_odd)
        np.testing.assert_allclose(n, n_ref, rtol=3e-4, atol=3e-4)
        e = np.asarray(solve_e_mesh(jnp.asarray(n_ref, dtype=jnp.float32), grid, 1.0))
        e_ref = oracle.solve_e_mesh(n_ref, L, 1.0)
        np.testing.assert_allclose(e, e_ref, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(
            np.asarray(solve_e_mesh_fft(jnp.asarray(n_ref, dtype=jnp.float32), grid, 1.0)), e_ref, atol=1e-5
        )
