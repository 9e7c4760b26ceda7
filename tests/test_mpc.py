"""MPC solver tests: planning sanity, suppression, determinism."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from plasma_control_tpu.config import ControlConfig, MPCConfig, SimConfig
from plasma_control_tpu.control.actuator import make_actuator
from plasma_control_tpu.control.mpc import candidate_costs, mpc_rollout, plan
from plasma_control_tpu.models.pic import PlasmaState, init_state
from plasma_control_tpu.models.rollout import rollout
from plasma_control_tpu.ops.grid import make_grid


def tiny_cfg(**kw):
    base = dict(n_particles=1000, n_mesh=32, dt=0.1, t_max=10.0, length=50.0)
    base.update(kw)
    return SimConfig(**base)


CTRL = ControlConfig(max_mode=2)


class TestPlan:
    def test_candidate_costs_finite_and_distinct(self):
        cfg = tiny_cfg()
        mpc = MPCConfig(horizon=4, n_candidates=16)
        grid = make_grid(cfg.n_mesh, cfg.length)
        act = make_actuator(cfg.length, cfg.n_mesh, CTRL.max_mode)
        st = init_state(cfg, jax.random.PRNGKey(0))
        cand = 0.3 * jax.random.normal(jax.random.PRNGKey(1), (16, 4, 4))
        costs = np.asarray(candidate_costs(st, cand, grid, cfg, mpc, act))
        assert costs.shape == (16,)
        assert np.isfinite(costs).all()
        assert np.std(costs) > 0

    def test_leapfrog_planner_preserves_ranking(self):
        """The cheap position-Verlet planning integrator (1 pipeline/step,
        MPCConfig.plan_integrator='leapfrog') must rank candidate control
        sequences the same way as the full Yoshida-4 dynamics — that is the
        only property MPC needs from the planner model."""
        cfg = tiny_cfg()
        grid = make_grid(cfg.n_mesh, cfg.length)
        act = make_actuator(cfg.length, cfg.n_mesh, CTRL.max_mode)
        st = init_state(cfg, jax.random.PRNGKey(0))
        cand = 0.3 * jax.random.normal(jax.random.PRNGKey(1), (24, 6, 4))
        c_env = np.asarray(candidate_costs(
            st, cand, grid, cfg, MPCConfig(horizon=6, plan_model="grid", plan_integrator="env"), act))
        c_lf = np.asarray(candidate_costs(
            st, cand, grid, cfg, MPCConfig(horizon=6, plan_model="grid", plan_integrator="leapfrog"), act))
        assert np.isfinite(c_lf).all()
        # Spearman rank correlation, no scipy needed
        r_env = np.argsort(np.argsort(c_env)).astype(float)
        r_lf = np.argsort(np.argsort(c_lf)).astype(float)
        rho = np.corrcoef(r_env, r_lf)[0, 1]
        assert rho > 0.95, f"rank correlation {rho}"
        # and the actual cost values stay close (2nd- vs 4th-order, same dt)
        np.testing.assert_allclose(c_lf, c_env, rtol=0.05)

    def test_kdk_planner_preserves_ranking(self):
        """The velocity-Verlet (KDK) planner ranks candidates like the full
        Yoshida-4 dynamics and stays close in
        value (it is the adjoint splitting of the leapfrog planner)."""
        cfg = tiny_cfg()
        grid = make_grid(cfg.n_mesh, cfg.length)
        act = make_actuator(cfg.length, cfg.n_mesh, CTRL.max_mode)
        st = init_state(cfg, jax.random.PRNGKey(0))
        cand = 0.3 * jax.random.normal(jax.random.PRNGKey(1), (24, 6, 4))
        c_env = np.asarray(candidate_costs(
            st, cand, grid, cfg, MPCConfig(horizon=6, plan_model="grid", plan_integrator="env"), act))
        c_kdk = np.asarray(candidate_costs(
            st, cand, grid, cfg, MPCConfig(horizon=6, plan_model="grid", plan_integrator="kdk"), act))
        assert np.isfinite(c_kdk).all()
        r_env = np.argsort(np.argsort(c_env)).astype(float)
        r_kdk = np.argsort(np.argsort(c_kdk)).astype(float)
        rho = np.corrcoef(r_env, r_kdk)[0, 1]
        assert rho > 0.95, f"rank correlation {rho}"
        np.testing.assert_allclose(c_kdk, c_env, rtol=0.05)

    def test_plan_chunk_is_semantics_neutral(self):
        """Chunked candidate evaluation (plan_chunk, the large-N memory
        bound) returns exactly the batched costs, on both plan models."""
        cfg = tiny_cfg()
        grid = make_grid(cfg.n_mesh, cfg.length)
        act = make_actuator(cfg.length, cfg.n_mesh, CTRL.max_mode)
        st = init_state(cfg, jax.random.PRNGKey(0))
        cand = 0.3 * jax.random.normal(jax.random.PRNGKey(1), (24, 5, 4))
        for base in (dict(plan_model="spectral", plan_modes=6),
                     dict(plan_model="grid", plan_integrator="kdk")):
            full = np.asarray(candidate_costs(
                st, cand, grid, cfg, MPCConfig(horizon=5, **base), act))
            chunked = np.asarray(candidate_costs(
                st, cand, grid, cfg,
                MPCConfig(horizon=5, plan_chunk=8, **base), act))
            np.testing.assert_allclose(chunked, full, rtol=1e-6, atol=1e-7)
            # non-multiple chunk: the block is PADDED up to a chunk multiple
            # (K=24 -> 28 at chunk 7) and the padded costs discarded — still
            # exact; under shard_map this path sees the per-device local
            # block, so a hard divisibility error would misfire there
            clamped = np.asarray(candidate_costs(
                st, cand, grid, cfg,
                MPCConfig(horizon=5, plan_chunk=7, **base), act))
            np.testing.assert_allclose(clamped, full, rtol=1e-6, atol=1e-7)

    def test_spectral_planner_preserves_ranking(self):
        """The gridless low-mode spectral planning model (the default,
        MPCConfig.plan_model='spectral') ranks candidates like the full
        grid dynamics and stays close in cost."""
        cfg = tiny_cfg(n_particles=4000, n_mesh=128)
        grid = make_grid(cfg.n_mesh, cfg.length)
        act = make_actuator(cfg.length, cfg.n_mesh, CTRL.max_mode)
        st = init_state(cfg, jax.random.PRNGKey(0))
        cand = 0.3 * jax.random.normal(jax.random.PRNGKey(1), (24, 6, 4))
        c_grid = np.asarray(candidate_costs(
            st, cand, grid, cfg, MPCConfig(horizon=6, plan_model="grid", plan_integrator="kdk"), act))
        for km in (8, 16):
            c_spec = np.asarray(candidate_costs(
                st, cand, grid, cfg,
                MPCConfig(horizon=6, plan_model="spectral", plan_modes=km), act))
            assert np.isfinite(c_spec).all()
            r_g = np.argsort(np.argsort(c_grid)).astype(float)
            r_s = np.argsort(np.argsort(c_spec)).astype(float)
            rho = np.corrcoef(r_g, r_s)[0, 1]
            assert rho > 0.95, f"Km={km} rank correlation {rho}"
            # PE truncated to Km modes => costs close but slightly biased
            np.testing.assert_allclose(c_spec, c_grid, rtol=0.2)

    def test_spectral_streaming_matches_basis(self):
        """The streamed mode sums / field evaluation (never materializing the
        (Km, N) basis) equal the explicit basis-matrix forms."""
        from plasma_control_tpu.control.mpc import (
            _mode_basis, _mode_eval, _mode_sums,
        )

        x = jax.random.uniform(jax.random.PRNGKey(3), (777,), minval=0.0, maxval=50.0)
        cb, sb = _mode_basis(x, 50.0, 11)
        # basis rows are cos/sin(k_m x) exactly
        k5 = 2.0 * np.pi / 50.0 * 5
        np.testing.assert_allclose(np.asarray(cb[4]), np.cos(k5 * np.asarray(x)), atol=2e-5)
        np.testing.assert_allclose(np.asarray(sb[4]), np.sin(k5 * np.asarray(x)), atol=2e-5)
        t = (2.0 * jnp.pi / 50.0) * x
        c1, s1 = jnp.cos(t), jnp.sin(t)
        c, s = _mode_sums(c1, s1, 11)
        np.testing.assert_allclose(np.asarray(c), np.asarray(jnp.sum(cb, axis=1)), rtol=2e-4, atol=2e-3)
        np.testing.assert_allclose(np.asarray(s), np.asarray(jnp.sum(sb, axis=1)), rtol=2e-4, atol=2e-3)
        pc = jax.random.normal(jax.random.PRNGKey(4), (11,))
        ps = jax.random.normal(jax.random.PRNGKey(5), (11,))
        np.testing.assert_allclose(
            np.asarray(_mode_eval(c1, s1, pc, ps)), np.asarray(pc @ cb + ps @ sb),
            rtol=1e-4, atol=1e-4)

    @pytest.mark.parametrize("algo", ["mppi", "cem"])
    def test_plan_returns_valid(self, algo):
        cfg = tiny_cfg()
        mpc = MPCConfig(horizon=4, n_candidates=32, n_elites=8, n_iters=2, algo=algo)
        grid = make_grid(cfg.n_mesh, cfg.length)
        act = make_actuator(cfg.length, cfg.n_mesh, CTRL.max_mode)
        st = init_state(cfg, jax.random.PRNGKey(0))
        mean = jnp.zeros((4, 4))
        action, new_mean, best = plan(st, mean, jnp.asarray(0.3), jax.random.PRNGKey(2), grid, cfg, CTRL, mpc, act)
        assert action.shape == (4,)
        assert new_mean.shape == (4, 4)
        assert np.isfinite(float(best))
        assert np.abs(np.asarray(action)).max() <= CTRL.coeff_max + 1e-6

    def test_plan_deterministic(self):
        cfg = tiny_cfg()
        mpc = MPCConfig(horizon=3, n_candidates=16)
        grid = make_grid(cfg.n_mesh, cfg.length)
        act = make_actuator(cfg.length, cfg.n_mesh, CTRL.max_mode)
        st = init_state(cfg, jax.random.PRNGKey(0))
        mean = jnp.zeros((3, 4))
        out1 = plan(st, mean, jnp.asarray(0.3), jax.random.PRNGKey(5), grid, cfg, CTRL, mpc, act)
        out2 = plan(st, mean, jnp.asarray(0.3), jax.random.PRNGKey(5), grid, cfg, CTRL, mpc, act)
        np.testing.assert_array_equal(np.asarray(out1[0]), np.asarray(out2[0]))


class TestClosedLoop:
    def test_mpc_suppresses_two_stream(self):
        cfg = tiny_cfg(n_particles=2000, n_mesh=64, t_max=25.0)
        mpc = MPCConfig(horizon=5, n_candidates=64, temperature=0.1, sigma0=0.3, w_input=0.01)
        grid = make_grid(cfg.n_mesh, cfg.length)
        act = make_actuator(cfg.length, cfg.n_mesh, 3)
        ctrl = ControlConfig(max_mode=3)
        st = init_state(cfg, jax.random.PRNGKey(42))

        un = rollout(st, grid, cfg)
        out = mpc_rollout(st, grid, cfg, ctrl, mpc, act, jax.random.PRNGKey(0))

        pe_un = float(jnp.mean(un.field_energy[-50:]))
        pe_mpc = float(jnp.mean(out.field_energy[-50:]))
        assert np.isfinite(np.asarray(out.field_energy)).all()
        assert pe_mpc < 0.5 * pe_un, f"mpc {pe_mpc} vs uncontrolled {pe_un}"

    def test_kdk_mpc_suppresses(self):
        """Closed-loop MPC with the KDK planner (the fused-kernel scheme)
        suppresses the two-stream instability like the leapfrog planner."""
        cfg = tiny_cfg(n_particles=2000, n_mesh=64, t_max=25.0)
        mpc = MPCConfig(horizon=5, n_candidates=64, temperature=0.1, sigma0=0.3,
                        w_input=0.01, plan_model="grid", plan_integrator="kdk")
        grid = make_grid(cfg.n_mesh, cfg.length)
        act = make_actuator(cfg.length, cfg.n_mesh, 3)
        ctrl = ControlConfig(max_mode=3)
        st = init_state(cfg, jax.random.PRNGKey(42))

        un = rollout(st, grid, cfg)
        out = mpc_rollout(st, grid, cfg, ctrl, mpc, act, jax.random.PRNGKey(0))

        pe_un = float(jnp.mean(un.field_energy[-50:]))
        pe_mpc = float(jnp.mean(out.field_energy[-50:]))
        assert np.isfinite(np.asarray(out.field_energy)).all()
        assert pe_mpc < 0.5 * pe_un, f"kdk mpc {pe_mpc} vs uncontrolled {pe_un}"

    def test_multifidelity_mpc_suppresses(self):
        """Planning on a reduced model (subsampled particles + coarse mesh)
        must still suppress the instability in the full-fidelity closed loop.

        The dynamic fidelity guard is disabled here on purpose: at this tiny
        scale (1000 of 2000 particles) the coherent/injected ratio straddles
        the 3x threshold for the whole trajectory, so the default guard
        (correctly, per its contract) gates the drive to zero. This test
        exercises the multifidelity *mechanism*; the guard's own behavior is
        covered by TestFidelityGuard."""
        cfg = tiny_cfg(n_particles=2000, n_mesh=64, t_max=25.0)
        mpc = MPCConfig(
            horizon=5, n_candidates=64, temperature=0.1, sigma0=0.3, w_input=0.01,
            plan_model="grid", plan_particles=1000, plan_mesh=32,
            fidelity_guard=False,
        )
        grid = make_grid(cfg.n_mesh, cfg.length)
        act = make_actuator(cfg.length, cfg.n_mesh, 3)
        ctrl = ControlConfig(max_mode=3)
        st = init_state(cfg, jax.random.PRNGKey(42))

        un = rollout(st, grid, cfg)
        out = mpc_rollout(st, grid, cfg, ctrl, mpc, act, jax.random.PRNGKey(0))
        pe_un = float(jnp.mean(un.field_energy[-50:]))
        pe_mpc = float(jnp.mean(out.field_energy[-50:]))
        assert pe_mpc < 0.5 * pe_un, f"mf-mpc {pe_mpc} vs uncontrolled {pe_un}"

    def test_output_shapes(self):
        cfg = tiny_cfg(t_max=2.0)
        mpc = MPCConfig(horizon=3, n_candidates=8)
        grid = make_grid(cfg.n_mesh, cfg.length)
        act = make_actuator(cfg.length, cfg.n_mesh, CTRL.max_mode)
        st = init_state(cfg, jax.random.PRNGKey(0))
        out = mpc_rollout(st, grid, cfg, CTRL, mpc, act, jax.random.PRNGKey(1))
        t = cfg.n_steps
        assert out.coeffs.shape == (t, 4)
        assert out.field_energy.shape == (t,)
        assert out.plan_cost.shape == (t,)


class TestGradientRefinement:
    def test_grad_refine_reduces_cost(self):
        """Differentiable-simulation refinement must not increase the
        horizon cost, and typically reduces it below the sampling-only plan."""
        from plasma_control_tpu.control.mpc import _gradient_refine, _horizon_cost

        cfg = tiny_cfg(n_particles=1000, n_mesh=32)
        ctrl = ControlConfig(max_mode=2)
        mpc = MPCConfig(horizon=4, n_candidates=8, n_grad_iters=10, grad_lr=0.05, w_input=0.01)
        grid = make_grid(cfg.n_mesh, cfg.length)
        act = make_actuator(cfg.length, cfg.n_mesh, ctrl.max_mode)
        st = init_state(cfg, jax.random.PRNGKey(42))

        mean = jnp.zeros((4, 4))
        c0 = float(_horizon_cost(st, mean, grid, cfg, mpc, act))
        refined = _gradient_refine(st, mean, grid, cfg, ctrl, mpc, act)
        c1 = float(_horizon_cost(st, refined, grid, cfg, mpc, act))
        assert c1 <= c0 + 1e-5, f"refined {c1} vs initial {c0}"
        assert c1 < c0, "gradient refinement made no progress"

    def test_plan_with_refinement_runs(self):
        cfg = tiny_cfg()
        ctrl = ControlConfig(max_mode=2)
        mpc = MPCConfig(horizon=3, n_candidates=8, n_grad_iters=2)
        grid = make_grid(cfg.n_mesh, cfg.length)
        act = make_actuator(cfg.length, cfg.n_mesh, ctrl.max_mode)
        st = init_state(cfg, jax.random.PRNGKey(0))
        action, new_mean, best = plan(st, jnp.zeros((3, 4)), jnp.asarray(0.3), jax.random.PRNGKey(1), grid, cfg, ctrl, mpc, act)
        assert np.isfinite(np.asarray(action)).all()


class TestMPCBeatsFeedback:
    def test_mpc_outperforms_feedback_suppression(self):
        """The sampling MPC must suppress the two-stream field energy at
        least as well as the phase-conjugate feedback expert (measured:
        ~60 vs ~102 tail PE at this config; threshold leaves 20% slack)."""
        from plasma_control_tpu.control.feedback import feedback_rollout

        cfg = tiny_cfg(n_particles=2000, n_mesh=64, t_max=25.0)
        ctrl = ControlConfig(max_mode=3)
        grid = make_grid(cfg.n_mesh, cfg.length)
        act = make_actuator(cfg.length, cfg.n_mesh, ctrl.max_mode)
        st = init_state(cfg, jax.random.PRNGKey(42))

        fb = feedback_rollout(st, grid, cfg, ctrl, act)
        mpc = MPCConfig(horizon=8, n_candidates=128, temperature=0.05, sigma0=0.3, w_input=0.05)
        out = mpc_rollout(st, grid, cfg, ctrl, mpc, act, jax.random.PRNGKey(0))

        pe_fb = float(jnp.mean(fb.field_energy[-50:]))
        pe_mpc = float(jnp.mean(out.field_energy[-50:]))
        assert pe_mpc < 0.8 * pe_fb, f"mpc {pe_mpc} vs feedback {pe_fb}"


class TestKnotNoise:
    def test_unit_marginal_variance_and_smoothness(self):
        """Knot-interpolated noise keeps unit variance at EVERY horizon step
        (the interp renormalizes) while being temporally smooth (high lag-1
        autocorrelation), unlike white noise."""
        from plasma_control_tpu.control.mpc import knot_noise

        eps = np.asarray(knot_noise(jax.random.PRNGKey(0), 4096, 16, 2, n_knots=4))
        assert eps.shape == (4096, 16, 2)
        var = eps.var(axis=0)  # (16, 2) per-step marginal variance
        np.testing.assert_allclose(var, 1.0, atol=0.1)
        lag1 = np.mean(eps[:, 1:] * eps[:, :-1]) / np.mean(eps**2)
        assert lag1 > 0.5, f"knot noise not smooth (lag-1 autocorr {lag1})"

    def test_knot_plan_runs_and_suppresses(self):
        """MPC with knot-parameterized candidates (n_knots=3 over horizon 8)
        still suppresses the two-stream instability (cheap smoke at tiny
        scale; the quality comparison vs white noise is seed-sensitive and
        lives in the experiments, not CI)."""
        cfg = tiny_cfg(t_max=8.0)
        grid = make_grid(cfg.n_mesh, cfg.length)
        act = make_actuator(cfg.length, cfg.n_mesh, CTRL.max_mode)
        st = init_state(cfg, jax.random.PRNGKey(0))

        mpc = MPCConfig(horizon=8, n_candidates=32, n_knots=3)
        out = mpc_rollout(st, grid, cfg, CTRL, mpc, act, jax.random.PRNGKey(1))
        un = rollout(st, grid, cfg)
        assert np.isfinite(np.asarray(out.field_energy)).all()
        assert float(jnp.mean(out.field_energy[-20:])) < float(jnp.mean(un.field_energy[-20:]))


class TestAntithetic:
    def test_antithetic_plan_runs_and_suppresses(self):
        """MPC with mirrored-pair candidate sampling (MPCConfig.antithetic)
        runs, is deterministic in the key, and still suppresses (the quality
        comparison at equal K is seed-sensitive and lives in
        experiments/sampler_quality.py)."""
        cfg = tiny_cfg(t_max=8.0)
        grid = make_grid(cfg.n_mesh, cfg.length)
        act = make_actuator(cfg.length, cfg.n_mesh, CTRL.max_mode)
        st = init_state(cfg, jax.random.PRNGKey(0))

        mpc = MPCConfig(horizon=8, n_candidates=32, antithetic=True)
        out = mpc_rollout(st, grid, cfg, CTRL, mpc, act, jax.random.PRNGKey(1))
        out2 = mpc_rollout(st, grid, cfg, CTRL, mpc, act, jax.random.PRNGKey(1))
        un = rollout(st, grid, cfg)
        assert np.isfinite(np.asarray(out.field_energy)).all()
        np.testing.assert_array_equal(np.asarray(out.coeffs), np.asarray(out2.coeffs))
        assert float(jnp.mean(out.field_energy[-20:])) < float(jnp.mean(un.field_energy[-20:]))

    def test_antithetic_odd_candidate_count(self):
        """Odd K keeps exactly K candidates (the mirrored block is trimmed)."""
        cfg = tiny_cfg(t_max=2.0)
        grid = make_grid(cfg.n_mesh, cfg.length)
        act = make_actuator(cfg.length, cfg.n_mesh, CTRL.max_mode)
        st = init_state(cfg, jax.random.PRNGKey(0))
        mpc = MPCConfig(horizon=3, n_candidates=7, antithetic=True)
        out = mpc_rollout(st, grid, cfg, CTRL, mpc, act, jax.random.PRNGKey(1))
        assert np.isfinite(np.asarray(out.field_energy)).all()


class TestTerminalCost:
    @pytest.mark.parametrize(
        "kw",
        [
            dict(plan_model="spectral"),
            dict(plan_model="grid", plan_integrator="kdk"),
            dict(plan_model="grid", plan_integrator="leapfrog"),
            dict(plan_model="grid", plan_integrator="env"),
        ],
        ids=["spectral", "kdk", "leapfrog", "env"],
    )
    def test_terminal_cost_linear_in_weight(self, kw):
        """cost(w_terminal) = cost(0) + w_terminal * PE_H on every planner
        path: check linearity, and that the added term is the positive final
        planning-model field energy."""
        cfg = tiny_cfg()
        grid = make_grid(cfg.n_mesh, cfg.length)
        act = make_actuator(cfg.length, cfg.n_mesh, CTRL.max_mode)
        st = init_state(cfg, jax.random.PRNGKey(0))
        cand = 0.3 * jax.random.normal(jax.random.PRNGKey(1), (8, 4, 4))

        def costs(w):
            mpc = MPCConfig(horizon=4, n_candidates=8, w_terminal=w, **kw)
            return np.asarray(candidate_costs(st, cand, grid, cfg, mpc, act))

        c0, c1, c3 = costs(0.0), costs(1.0), costs(3.0)
        pe_h = c1 - c0
        assert (pe_h > 0).all()  # field energy is positive
        np.testing.assert_allclose(c3 - c0, 3.0 * pe_h, rtol=2e-4, atol=1e-6)

    def test_growth_terminal_formula(self):
        """_add_terminal("growth") charges exactly sum_{i=1..T} PE_H * r^i with
        r = clip(PE_H/PE_{H-1}, 0.7, 1.3), incl. the r=1 singular point."""
        from plasma_control_tpu.config import MPCConfig
        from plasma_control_tpu.control.mpc import _add_terminal

        t = 4
        mpc = MPCConfig(terminal_mode="growth", terminal_steps=t, w_field=2.0)
        total = jnp.zeros(())

        def tail(pe_prev, pe_h):
            pes = jnp.array([1.0, pe_prev, pe_h])
            return float(_add_terminal(total, pes, mpc))

        # decaying: r clipped up to 0.7
        r = 0.7
        np.testing.assert_allclose(
            tail(4.0, 2.0), 2.0 * 2.0 * sum(r**i for i in range(1, t + 1)), rtol=1e-6)
        # growing: r clipped down to 1.3
        r = 1.3
        np.testing.assert_allclose(
            tail(2.0, 2.6), 2.0 * 2.6 * sum(r**i for i in range(1, t + 1)), rtol=1e-6)
        # interior ratio
        r = 0.9
        np.testing.assert_allclose(
            tail(2.0, 1.8), 2.0 * 1.8 * sum(r**i for i in range(1, t + 1)), rtol=1e-6)
        # flat: removable singularity -> exactly T more steps of PE_H
        np.testing.assert_allclose(tail(2.0, 2.0), 2.0 * 2.0 * t, rtol=1e-6)
        # growing tail costs more than a decaying one at the SAME PE_H
        assert tail(1.5, 2.0) > tail(3.0, 2.0)
        # composes with the const weight
        mpc2 = MPCConfig(terminal_mode="growth", terminal_steps=t, w_field=2.0,
                         w_terminal=5.0)
        np.testing.assert_allclose(
            float(_add_terminal(total, jnp.array([1.0, 2.0, 2.0]), mpc2)),
            2.0 * 2.0 * t + 5.0 * 2.0, rtol=1e-6)

    @pytest.mark.parametrize(
        "kw",
        [
            dict(plan_model="spectral"),
            dict(plan_model="spectral", plan_kernel="fused"),
            dict(plan_model="grid", plan_integrator="kdk"),
        ],
        ids=["spectral", "spectral-fused", "kdk"],
    )
    def test_growth_terminal_consistent_across_paths(self, kw, request):
        """On every planner path, the growth tail added on top of the plain
        cost equals w_field * PE_H * geom(r) reconstructed from the per-step
        PEs that the w_terminal linearity trick exposes."""
        if kw.get("plan_kernel") == "fused":
            request.getfixturevalue("spectral_kernel_interpreted")
        cfg = tiny_cfg(n_particles=512)
        grid = make_grid(cfg.n_mesh, cfg.length)
        act = make_actuator(cfg.length, cfg.n_mesh, CTRL.max_mode)
        st = init_state(cfg, jax.random.PRNGKey(0))
        h, t = 4, 5
        cand = 0.3 * jax.random.normal(jax.random.PRNGKey(1), (8, h, 4))

        def costs(**extra):
            mpc = MPCConfig(horizon=h, n_candidates=8, plan_modes=4, **kw, **extra)
            return np.asarray(candidate_costs(st, cand, grid, cfg, mpc, act))

        c0 = costs()
        pe_h = costs(w_terminal=1.0) - c0
        # PE_{H-1}: the first h-1 planning steps are identical dynamics
        ch0 = np.asarray(candidate_costs(
            st, cand[:, : h - 1], grid, cfg,
            MPCConfig(horizon=h - 1, n_candidates=8, plan_modes=4, **kw), act))
        ch1 = np.asarray(candidate_costs(
            st, cand[:, : h - 1], grid, cfg,
            MPCConfig(horizon=h - 1, n_candidates=8, plan_modes=4, w_terminal=1.0, **kw), act))
        pe_hm1 = ch1 - ch0
        r = np.clip(pe_h / (pe_hm1 + 1e-30), 0.7, 1.3)
        geom = r * (1.0 - r**t) / (1.0 - r)
        cg = costs(terminal_mode="growth", terminal_steps=t)
        np.testing.assert_allclose(cg - c0, pe_h * geom, rtol=2e-3, atol=1e-5)

    def test_growth_terminal_closed_loop_suppresses(self):
        """Short horizon + growth tail estimator suppresses the instability
        (bench-scale quality gate: experiments/bench_fidelity_study.py).
        Two paired seeds, t_max=10: the old single-seed t_max=8 variant
        passed by <2% on a chaotic near-tie (H=4/K=32 is a deliberately weak
        setting) and flipped on unrelated cost-constant changes."""
        cfg = tiny_cfg(t_max=10.0)
        grid = make_grid(cfg.n_mesh, cfg.length)
        act = make_actuator(cfg.length, cfg.n_mesh, CTRL.max_mode)
        mpc = MPCConfig(horizon=4, n_candidates=32,
                        terminal_mode="growth", terminal_steps=6)
        tails_c, tails_u = [], []
        for s in range(2):
            st = init_state(cfg, jax.random.PRNGKey(s))
            out = mpc_rollout(st, grid, cfg, CTRL, mpc, act,
                              jax.random.PRNGKey(100 + s))
            assert np.isfinite(np.asarray(out.field_energy)).all()
            tails_c.append(float(jnp.mean(out.field_energy[-20:])))
            tails_u.append(float(jnp.mean(rollout(st, grid, cfg).field_energy[-20:])))
        assert np.mean(tails_c) < np.mean(tails_u), (tails_c, tails_u)

    def test_terminal_cost_closed_loop_suppresses(self):
        """Short horizon + terminal tail cost still suppresses the
        instability (quality-vs-horizon study: experiments/horizon_study.py)."""
        cfg = tiny_cfg(t_max=8.0)
        grid = make_grid(cfg.n_mesh, cfg.length)
        act = make_actuator(cfg.length, cfg.n_mesh, CTRL.max_mode)
        st = init_state(cfg, jax.random.PRNGKey(0))
        mpc = MPCConfig(horizon=4, n_candidates=32, w_terminal=6.0)
        out = mpc_rollout(st, grid, cfg, CTRL, mpc, act, jax.random.PRNGKey(1))
        un = rollout(st, grid, cfg)
        assert np.isfinite(np.asarray(out.field_energy)).all()
        assert float(jnp.mean(out.field_energy[-20:])) < float(jnp.mean(un.field_energy[-20:]))


class TestPlanFidelityCheck:
    def test_quiet_plasma_flags_subsampling_unsafe(self):
        """A freshly initialized (quiet, near-noise-floor) bump-on-tail state
        must flag particle-subsampled planning as unsafe — the measured
        failure mode (experiments/bot_bench_scale_debug.py)."""
        from plasma_control_tpu.control.mpc import plan_fidelity_check

        cfg = SimConfig(simcase="bump-on-tail", n_particles=2000, n_mesh=64,
                        dt=0.1, t_max=10.0, length=50.0)
        st = init_state(cfg, jax.random.PRNGKey(0))
        chk = plan_fidelity_check(st, cfg, CTRL, MPCConfig(plan_particles=500))
        assert not chk["safe"]
        assert chk["injected_noise_pe"] > 0

    def test_coherent_state_is_safe_and_full_fidelity_is_safe(self):
        """A strongly bunched (coherent) state is safe to plan subsampled;
        full-fidelity planning injects nothing and is always safe."""
        from plasma_control_tpu.control.mpc import plan_fidelity_check
        from plasma_control_tpu.models.pic import PlasmaState

        cfg = tiny_cfg()
        st = init_state(cfg, jax.random.PRNGKey(0))
        # bunch all particles near x = L/2: huge coherent low-mode field
        x = jnp.mod(0.5 * cfg.length + 1.5 * jax.random.normal(jax.random.PRNGKey(1), st.x.shape), cfg.length)
        bunched = PlasmaState(x, st.v)
        chk = plan_fidelity_check(bunched, cfg, CTRL, MPCConfig(plan_particles=250))
        assert chk["safe"]
        assert chk["ratio"] > 3.0

        chk_full = plan_fidelity_check(st, cfg, CTRL, MPCConfig())
        assert chk_full["safe"]
        assert chk_full["injected_noise_pe"] == 0.0


class TestFusedSpectral:
    def test_fused_spectral_matches_xla_spectral(self, spectral_kernel_interpreted):
        """The whole-horizon spectral kernel returns the same candidate
        costs as the XLA scan path (same ops, fp32 reassociation only)."""
        cfg = tiny_cfg(n_particles=384)  # non-multiple of the 256 chunk: masked tail
        grid = make_grid(cfg.n_mesh, cfg.length)
        act = make_actuator(cfg.length, cfg.n_mesh, CTRL.max_mode)
        st = init_state(cfg, jax.random.PRNGKey(0))
        cand = 0.3 * jax.random.normal(jax.random.PRNGKey(1), (16, 5, 4))
        base = dict(horizon=5, n_candidates=16, plan_modes=6)
        c_xla = np.asarray(candidate_costs(
            st, cand, grid, cfg, MPCConfig(**base, plan_kernel="xla"), act))
        c_fused = np.asarray(candidate_costs(
            st, cand, grid, cfg, MPCConfig(**base, plan_kernel="fused"), act))
        np.testing.assert_allclose(c_fused, c_xla, rtol=2e-4, atol=1e-5)

    def test_fused_spectral_with_terminal_cost(self, spectral_kernel_interpreted):
        cfg = tiny_cfg(n_particles=256)
        grid = make_grid(cfg.n_mesh, cfg.length)
        act = make_actuator(cfg.length, cfg.n_mesh, CTRL.max_mode)
        st = init_state(cfg, jax.random.PRNGKey(0))
        cand = 0.3 * jax.random.normal(jax.random.PRNGKey(1), (8, 4, 4))
        base = dict(horizon=4, n_candidates=8, plan_modes=4, w_terminal=3.0)
        c_xla = np.asarray(candidate_costs(
            st, cand, grid, cfg, MPCConfig(**base, plan_kernel="xla"), act))
        c_fused = np.asarray(candidate_costs(
            st, cand, grid, cfg, MPCConfig(**base, plan_kernel="fused"), act))
        np.testing.assert_allclose(c_fused, c_xla, rtol=2e-4, atol=1e-5)

    @pytest.mark.parametrize("plan_kernel,n,backend,expected", [
        ("auto", 5000, "gpu", True),
        ("auto", 5000, "cpu", False),
        ("auto", 10_000_000, "gpu", False),  # K*N past the int32 index
        ("xla", 5000, "gpu", False),
        ("fused", 5000, "gpu", True),
        ("fused", 5000, "cpu", ValueError),  # the kernel runs only on the GPU
        ("fused", 10_000_000, "gpu", ValueError),
    ])
    def test_auto_dispatch_policy(self, plan_kernel, n, backend, expected):
        """'auto' picks the spectral kernel on the GPU where it is
        supported and the XLA scan elsewhere; 'fused' forces it and is a
        config error off the GPU; 'xla' never picks it."""
        from plasma_control_tpu.control.mpc import _use_spectral_fused

        if expected is ValueError:
            with pytest.raises(ValueError):
                _use_spectral_fused(plan_kernel, n, 384, backend)
        else:
            assert _use_spectral_fused(plan_kernel, n, 384, backend) is expected

    def test_fused_off_gpu_is_a_config_error(self):
        """Forcing the kernel through candidate_costs on the CPU raises
        instead of running the interpreter behind the user's back."""
        cfg = tiny_cfg(n_particles=256)
        grid = make_grid(cfg.n_mesh, cfg.length)
        act = make_actuator(cfg.length, cfg.n_mesh, CTRL.max_mode)
        st = init_state(cfg, jax.random.PRNGKey(0))
        cand = 0.3 * jax.random.normal(jax.random.PRNGKey(1), (8, 4, 4))
        with pytest.raises(ValueError, match="only on the GPU"):
            candidate_costs(st, cand, grid, cfg,
                            MPCConfig(horizon=4, n_candidates=8, plan_kernel="fused"), act)


class TestDynamicFidelityGuard:
    """VERDICT r1 weak #6: the t=0-only host check misses regime changes; the
    on-device guard gates the applied drive per solve."""

    def _mk(self, n=2000, plan_particles=500):
        cfg = SimConfig(n_particles=n, n_mesh=32, dt=0.1, t_max=5.0, length=50.0)
        ctrl = ControlConfig(max_mode=2)
        mpc = MPCConfig(horizon=4, n_candidates=32, plan_modes=8,
                        plan_particles=plan_particles)
        grid = make_grid(cfg.n_mesh, cfg.length)
        act = make_actuator(cfg.length, cfg.n_mesh, ctrl.max_mode)
        return cfg, ctrl, mpc, grid, act

    def test_quiet_state_zeroes_action(self):
        """Uniform (thermal-only) positions: coherent << injected floor —
        the solve's action and warm-start mean must be gated to zero."""
        cfg, ctrl, mpc, grid, act = self._mk()
        key = jax.random.PRNGKey(0)
        x = jax.random.uniform(key, (cfg.n_particles,)) * cfg.length
        v = jax.random.normal(jax.random.PRNGKey(1), (cfg.n_particles,))
        st = PlasmaState(x, v)
        a, m, best = plan(st, jnp.zeros((4, 4)), jnp.asarray(0.3),
                          jax.random.PRNGKey(2), grid, cfg, ctrl, mpc, act)
        assert np.all(np.asarray(a) == 0.0)
        assert np.all(np.asarray(m) == 0.0)

    def test_coherent_state_plans_normally(self):
        """Strong mode-1 bunching: ratio >> threshold, guard must not bite."""
        cfg, ctrl, mpc, grid, act = self._mk(plan_particles=1000)
        n = cfg.n_particles
        x0 = jnp.linspace(0.0, cfg.length, n, endpoint=False)
        x = jnp.mod(x0 + 3.0 * jnp.sin(2 * jnp.pi * x0 / cfg.length), cfg.length)
        v = 0.1 * jax.random.normal(jax.random.PRNGKey(1), (n,))
        st = PlasmaState(x, v)
        a, m, best = plan(st, jnp.zeros((4, 4)), jnp.asarray(0.3),
                          jax.random.PRNGKey(2), grid, cfg, ctrl, mpc, act)
        assert np.any(np.asarray(a) != 0.0)

    def test_device_ratio_matches_host_check(self):
        from plasma_control_tpu.control.mpc import _fidelity_ratio, plan_fidelity_check

        cfg, ctrl, mpc, grid, act = self._mk()
        st = init_state(cfg, jax.random.PRNGKey(0))
        host = plan_fidelity_check(st, cfg, ctrl, mpc)
        dev = float(_fidelity_ratio(st.x, cfg, ctrl, mpc))
        np.testing.assert_allclose(dev, host["ratio"], rtol=1e-4)

    def test_stride_one_subsample_is_full_fidelity_and_unguarded(self):
        """plan_particles in (N/2, N): the stride arithmetic keeps ALL
        particles, so planning is exactly full fidelity and the guard must
        NOT zero the drive on fictitious injected noise (review finding
        2026-08-20). A quiet state would trip a mis-armed guard."""
        from plasma_control_tpu.control.mpc import _plan_frac, plan_fidelity_check

        cfg, ctrl, mpc0, grid, act = self._mk(plan_particles=1500)  # N=2000
        assert _plan_frac(cfg, mpc0) == 1.0
        assert plan_fidelity_check(
            init_state(cfg, jax.random.PRNGKey(0)), cfg, ctrl, mpc0
        )["safe"]
        # quiet (uniform) state: a frac<1 guard would zero everything here
        x = jax.random.uniform(jax.random.PRNGKey(0), (cfg.n_particles,)) * cfg.length
        v = jax.random.normal(jax.random.PRNGKey(1), (cfg.n_particles,))
        a, m, best = plan(PlasmaState(x, v), jnp.zeros((4, 4)), jnp.asarray(0.3),
                          jax.random.PRNGKey(2), grid, cfg, ctrl, mpc0, act)
        assert np.any(np.asarray(a) != 0.0)

    def test_plan_frac_uses_actual_stride(self):
        """Non-dividing plan_particles: frac must be ceil(N/stride)/N, not
        plan_particles/N (plan 1024 of 5000 -> stride 4 -> 1250 kept)."""
        from plasma_control_tpu.control.mpc import _plan_frac

        cfg = SimConfig(n_particles=5000, n_mesh=32, dt=0.1, t_max=1.0, length=50.0)
        assert _plan_frac(cfg, MPCConfig(plan_particles=1024)) == 1250 / 5000
        assert _plan_frac(cfg, MPCConfig()) == 1.0

    def test_host_check_honors_configured_threshold(self):
        """plan_fidelity_check must use mpc.fidelity_guard_ratio, not a
        hardcoded 3.0, so the t=0 diagnostic and the runtime guard agree."""
        from plasma_control_tpu.control.mpc import plan_fidelity_check

        cfg, ctrl, _, grid, act = self._mk()
        st = init_state(cfg, jax.random.PRNGKey(0))
        lo = plan_fidelity_check(st, cfg, ctrl,
                                 MPCConfig(plan_particles=500, fidelity_guard_ratio=1e-9))
        hi = plan_fidelity_check(st, cfg, ctrl,
                                 MPCConfig(plan_particles=500, fidelity_guard_ratio=1e9))
        assert lo["safe"] and not hi["safe"]
        assert lo["ratio"] == hi["ratio"]

    def test_guard_trips_midrun_on_decaying_plasma(self):
        """A Landau-damping run starts coherent (safe: drive engaged) and
        quiets down (unsafe: the guard disengages the drive mid-run) — the
        exact scenario the t=0 host check cannot catch. Re-engagement later
        (the wave re-coheres once undriven) is physical and allowed; the
        contract is that the trip HAPPENS and the drive is exactly zero
        while tripped."""
        cfg = SimConfig(simcase="landau", n_particles=2000, n_mesh=32, dt=0.1,
                        t_max=8.0, length=50.0, perturb_amplitude=0.35,
                        perturb_mode=2)
        ctrl = ControlConfig(max_mode=2)
        mpc = MPCConfig(horizon=4, n_candidates=32, plan_modes=8,
                        plan_particles=1000)
        grid = make_grid(cfg.n_mesh, cfg.length)
        act = make_actuator(cfg.length, cfg.n_mesh, ctrl.max_mode)
        st = init_state(cfg, jax.random.PRNGKey(0))

        from plasma_control_tpu.control.mpc import _fidelity_ratio, mpc_rollout

        assert float(_fidelity_ratio(st.x, cfg, ctrl, mpc)) >= mpc.fidelity_guard_ratio, \
            "test setup: the initial state must be safely coherent"
        out = mpc_rollout(st, grid, cfg, ctrl, mpc, act, jax.random.PRNGKey(3))
        coeffs = np.asarray(out.coeffs)
        step_active = np.any(coeffs != 0.0, axis=1)
        assert step_active[0], "drive must engage while the signal is coherent"
        first_trip = np.argmin(step_active)  # first False
        assert step_active[:first_trip].all() and not step_active[first_trip], \
            "guard must trip mid-run once the controller quiets the wave"
        assert 0 < first_trip < len(step_active) - 1
        # while tripped, the applied drive is exactly zero (not merely small)
        assert np.all(coeffs[~step_active] == 0.0)

    def test_guarded_subsampled_planning_does_not_pump_quiet_plasma(self):
        """THE hazard case (DEVNOTES 2026-08-19): quiet bump-on-tail +
        subsampled planning pumped tail PE ~10x uncontrolled. With the guard
        the drive stays off and the trajectory stays at uncontrolled levels."""
        cfg = SimConfig(simcase="bump-on-tail", n_particles=2000, n_mesh=32,
                        dt=0.1, t_max=6.0, length=50.0)
        ctrl = ControlConfig(max_mode=2)
        mpc = MPCConfig(horizon=4, n_candidates=32, plan_modes=8,
                        plan_particles=500)
        grid = make_grid(cfg.n_mesh, cfg.length)
        act = make_actuator(cfg.length, cfg.n_mesh, ctrl.max_mode)
        st = init_state(cfg, jax.random.PRNGKey(0))
        out = mpc_rollout(st, grid, cfg, ctrl, mpc, act, jax.random.PRNGKey(3))
        un = rollout(st, grid, cfg, n_steps=cfg.n_steps)
        assert np.all(np.asarray(out.coeffs) == 0.0), "guard must hold the drive off"
        # rollout's trace includes the initial PE; mpc_rollout's starts post-step
        np.testing.assert_allclose(
            np.asarray(out.field_energy), np.asarray(un.field_energy)[1:], rtol=1e-4
        )

    def test_guard_off_by_flag(self):
        cfg, ctrl, mpc, grid, act = self._mk()
        import dataclasses as dc
        mpc = dc.replace(mpc, fidelity_guard=False)
        key = jax.random.PRNGKey(0)
        x = jax.random.uniform(key, (cfg.n_particles,)) * cfg.length
        v = jax.random.normal(jax.random.PRNGKey(1), (cfg.n_particles,))
        a, m, best = plan(PlasmaState(x, v), jnp.zeros((4, 4)), jnp.asarray(0.3),
                          jax.random.PRNGKey(2), grid, cfg, ctrl, mpc, act)
        assert np.any(np.asarray(a) != 0.0)


class TestTwinCorrection:
    """Noise-floor-corrected subsampled planning (MPCConfig.plan_correction=
    "twin", VERDICT r4 #1): Wiener shrinkage from the full state + a
    zero-drive CRN twin of the plan subsample remove the in-model profit of
    cancelling phantom subsample noise."""

    def _quiet(self, n=1000, seed=0):
        cfg = tiny_cfg(n_particles=n)
        x = jax.random.uniform(jax.random.PRNGKey(seed), (n,)) * cfg.length
        v = jax.random.normal(jax.random.PRNGKey(seed + 1), (n,))
        return cfg, PlasmaState(x, v)

    def test_zero_candidate_pays_almost_nothing(self):
        """On a quiet (noise-only) plasma the corrected field cost of the
        zero-drive candidate is the lambda-shrunk coherent estimate — orders
        of magnitude below the uncorrected subsample's phantom noise
        energy."""
        from plasma_control_tpu.control.mpc import _plan_model, twin_targets

        cfg, st = self._quiet()
        mpc = MPCConfig(horizon=4, n_candidates=4, plan_modes=8,
                        plan_particles=250, w_input=0.0, fidelity_guard=False,
                        plan_correction="twin")
        grid = make_grid(cfg.n_mesh, cfg.length)
        act = make_actuator(cfg.length, cfg.n_mesh, CTRL.max_mode)
        pstate, pgrid, pcfg = _plan_model(st, grid, cfg, mpc)
        target = twin_targets(st.x, pstate, pcfg, cfg, CTRL, mpc)
        assert target is not None
        zero = jnp.zeros((4, 4, 4))
        c_plain = float(candidate_costs(pstate, zero, pgrid, pcfg, mpc, act)[0])
        c_corr = float(candidate_costs(pstate, zero, pgrid, pcfg, mpc, act,
                                       twin_target=target)[0])
        assert c_corr < 0.05 * c_plain, (c_corr, c_plain)

    def test_full_fidelity_correction_is_inactive(self):
        from plasma_control_tpu.control.mpc import twin_targets

        cfg, st = self._quiet()
        mpc = MPCConfig(plan_correction="twin")  # no plan_particles
        assert twin_targets(st.x, st, cfg, cfg, CTRL, mpc) is None
        # and the full plan program is identical with/without the flag
        grid = make_grid(cfg.n_mesh, cfg.length)
        act = make_actuator(cfg.length, cfg.n_mesh, CTRL.max_mode)
        import dataclasses as dc
        base = MPCConfig(horizon=4, n_candidates=16, plan_modes=8)
        args = (jnp.zeros((4, 4)), jnp.asarray(0.3), jax.random.PRNGKey(2),
                grid, cfg, CTRL)
        a0, m0, b0 = plan(st, args[0], args[1], args[2], grid, cfg, CTRL, base, act)
        a1, m1, b1 = plan(st, args[0], args[1], args[2], grid, cfg, CTRL,
                          dc.replace(base, plan_correction="twin"), act)
        np.testing.assert_array_equal(np.asarray(a0), np.asarray(a1))
        np.testing.assert_array_equal(np.asarray(m0), np.asarray(m1))

    def test_coherent_state_correction_is_small(self):
        """Strong mode-1 bunching: lambda ~ 1, the correction targets are
        tiny, and corrected costs track the uncorrected ones."""
        from plasma_control_tpu.control.mpc import _plan_model, twin_targets

        cfg = tiny_cfg(n_particles=2000)
        n = cfg.n_particles
        x0 = jnp.linspace(0.0, cfg.length, n, endpoint=False)
        x = jnp.mod(x0 + 3.0 * jnp.sin(2 * jnp.pi * x0 / cfg.length), cfg.length)
        v = 0.1 * jax.random.normal(jax.random.PRNGKey(1), (n,))
        st = PlasmaState(x, v)
        mpc = MPCConfig(horizon=4, n_candidates=24, plan_modes=8,
                        plan_particles=500, fidelity_guard=False,
                        plan_correction="twin")
        grid = make_grid(cfg.n_mesh, cfg.length)
        act = make_actuator(cfg.length, cfg.n_mesh, CTRL.max_mode)
        pstate, pgrid, pcfg = _plan_model(st, grid, cfg, mpc)
        target = twin_targets(st.x, pstate, pcfg, cfg, CTRL, mpc)
        assert target is not None
        cand = 0.3 * jax.random.normal(jax.random.PRNGKey(1), (24, 4, 4))
        c_plain = np.asarray(candidate_costs(pstate, cand, pgrid, pcfg, mpc, act))
        c_corr = np.asarray(candidate_costs(pstate, cand, pgrid, pcfg, mpc, act,
                                            twin_target=target))
        np.testing.assert_allclose(c_corr, c_plain, rtol=0.25)
        # and the ranking is essentially unchanged
        r0 = np.argsort(np.argsort(c_plain)).astype(float)
        r1 = np.argsort(np.argsort(c_corr)).astype(float)
        assert np.corrcoef(r0, r1)[0, 1] > 0.95

    def test_corrected_subsampled_does_not_pump_quiet_plasma(self):
        """THE hazard case under the final r5 semantics (correction + guard
        BOTH armed — the default): the closed loop must not pump the quiet
        plasma above uncontrolled levels. The guard supplies the phase-
        detectability gate the correction cannot (measured: corrected-
        UNguarded still pumps mildly at reference scale, 131.7 vs 36.7 —
        results_r5/corrected_reference_scale.json); the uncorrected/
        unguarded planner pumps ~10x (DEVNOTES 2026-08-19)."""
        cfg = SimConfig(simcase="bump-on-tail", n_particles=2000, n_mesh=32,
                        dt=0.1, t_max=6.0, length=50.0)
        ctrl = ControlConfig(max_mode=2)
        mpc = MPCConfig(horizon=4, n_candidates=32, plan_modes=8,
                        plan_particles=500, plan_correction="twin")
        grid = make_grid(cfg.n_mesh, cfg.length)
        act = make_actuator(cfg.length, cfg.n_mesh, ctrl.max_mode)
        st = init_state(cfg, jax.random.PRNGKey(0))
        out = mpc_rollout(st, grid, cfg, ctrl, mpc, act, jax.random.PRNGKey(3))
        un = rollout(st, grid, cfg, n_steps=cfg.n_steps)
        tail = lambda a: float(np.mean(np.asarray(a)[-10:]))
        assert tail(out.field_energy) <= 1.5 * tail(un.field_energy), (
            tail(out.field_energy), tail(un.field_energy))

    def test_fused_corrected_matches_xla(self):
        """Interpret-mode corrected kernel == XLA corrected spectral path
        (same CRN twin targets) to fp32 reassociation."""
        import dataclasses as dc

        from plasma_control_tpu.control.mpc import (
            _horizon_cost_spectral, _plan_model, twin_targets)
        from plasma_control_tpu.ops.pallas.spectral_horizon import (
            fused_spectral_horizon)

        cfg, st = self._quiet(n=1000)
        ctrl = CTRL
        mpc = MPCConfig(horizon=4, n_candidates=8, plan_modes=8,
                        plan_particles=250, w_input=0.0,
                        plan_correction="twin")
        grid = make_grid(cfg.n_mesh, cfg.length)
        act = make_actuator(cfg.length, cfg.n_mesh, ctrl.max_mode)
        pstate, pgrid, pcfg = _plan_model(st, grid, cfg, mpc)
        target = twin_targets(st.x, pstate, pcfg, cfg, ctrl, mpc)
        cand = 0.3 * jax.random.normal(jax.random.PRNGKey(1), (8, 4, 4))
        xla = np.asarray(jax.vmap(
            lambda u: _horizon_cost_spectral(pstate, u, pcfg, mpc, act,
                                             twin_target=target)
        )(cand))
        km = mpc.plan_modes
        uc = jnp.concatenate([cand[..., :2], jnp.zeros((8, 4, km - 2))], -1)
        us = jnp.concatenate([cand[..., 2:], jnp.zeros((8, 4, km - 2))], -1)
        pe = fused_spectral_horizon(
            pstate.x, pstate.v, uc, us, length=pcfg.length,
            dt=pcfg.clamped_dt(), n0=pcfg.n0, n_particles=pcfg.n_particles,
            interpret=True, rot=False, twin_c=target[0], twin_s=target[1])
        from plasma_control_tpu.control.mpc import _pe_factor
        fused = np.asarray(jnp.sum(mpc.w_field * _pe_factor(pcfg, mpc) * pe,
                                   axis=-1))
        np.testing.assert_allclose(fused, xla, rtol=2e-4)


class TestScaleFreeCost:
    """MPCConfig.cost_pe_nref (VERDICT r4 #3): the plan field energy is
    normalized to the reference particle count so one w_input balances field
    vs drive at every N and every plan fidelity."""

    def test_factor_exact_at_reference_scale(self):
        from plasma_control_tpu.control.mpc import _pe_factor

        cfg = SimConfig(n_particles=5000)
        assert _pe_factor(cfg, MPCConfig()) == 1.0
        assert _pe_factor(cfg, MPCConfig(cost_pe_nref=None)) == 1.0
        assert _pe_factor(SimConfig(n_particles=50000), MPCConfig()) == 0.1

    @pytest.mark.parametrize("model", ["spectral", "grid"])
    def test_field_cost_scales_with_nref(self, model):
        """With w_input=0 the whole cost is the field term: doubling nref
        must exactly double every candidate cost, on every planning path."""
        import dataclasses as dc

        cfg = tiny_cfg()
        grid = make_grid(cfg.n_mesh, cfg.length)
        act = make_actuator(cfg.length, cfg.n_mesh, CTRL.max_mode)
        st = init_state(cfg, jax.random.PRNGKey(0))
        cand = 0.3 * jax.random.normal(jax.random.PRNGKey(1), (8, 4, 4))
        base = MPCConfig(horizon=4, n_candidates=8, plan_model=model,
                         w_input=0.0, cost_pe_nref=float(cfg.n_particles))
        c1 = np.asarray(candidate_costs(st, cand, grid, cfg, base, act))
        c2 = np.asarray(candidate_costs(
            st, cand, grid, cfg,
            dc.replace(base, cost_pe_nref=2.0 * cfg.n_particles), act))
        np.testing.assert_allclose(c2, 2.0 * c1, rtol=1e-6)
        # and nref == n gives the raw (None) cost exactly
        c0 = np.asarray(candidate_costs(
            st, cand, grid, cfg, dc.replace(base, cost_pe_nref=None), act))
        np.testing.assert_allclose(c1, c0, rtol=1e-6)

    def test_twin_rejects_gradient_refinement(self):
        with pytest.raises(ValueError, match="gradient refinement"):
            MPCConfig(plan_correction="twin", n_grad_iters=1)

    def test_plan_rejects_actuator_mode_mismatch(self):
        """An actuator built with a different max_mode than the rollout's
        ControlConfig must fail with a clear message, not a deep broadcast
        error (review finding r5)."""
        cfg = tiny_cfg()
        grid = make_grid(cfg.n_mesh, cfg.length)
        act8 = make_actuator(cfg.length, cfg.n_mesh, 8)
        ctrl16 = ControlConfig(max_mode=16)
        st = init_state(cfg, jax.random.PRNGKey(0))
        with pytest.raises(ValueError, match="mode mismatch"):
            plan(st, jnp.zeros((4, 32)), jnp.asarray(0.3),
                 jax.random.PRNGKey(1), grid, cfg, ctrl16,
                 MPCConfig(horizon=4, n_candidates=8), act8)
