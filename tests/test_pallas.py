"""Whole-horizon spectral planner kernel: Pallas interpret mode and the
kernel's Triton lowering on the CPU; tests marked ``gpu`` compile it for
the card and skip here (``chip_smoke.py`` runs them on the GPU)."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from plasma_control_tpu.config import ControlConfig, MPCConfig, SimConfig
from plasma_control_tpu.control.actuator import make_actuator
from plasma_control_tpu.control.mpc import _spectral_kernel_costs, candidate_costs
from plasma_control_tpu.models.pic import init_state
from plasma_control_tpu.ops.grid import make_grid
from plasma_control_tpu.ops.pallas import spectral_horizon as sh

L = 50.0


def _inputs(n, k, h, km, seed=3):
    x = jax.random.uniform(jax.random.PRNGKey(seed), (n,)) * L
    v = jax.random.normal(jax.random.PRNGKey(seed + 1), (n,)) * 2.0
    u_c = 0.3 * jax.random.normal(jax.random.PRNGKey(seed + 2), (k, h, km))
    u_s = 0.3 * jax.random.normal(jax.random.PRNGKey(seed + 3), (k, h, km))
    return x, v, u_c, u_s


def _model(n, max_mode=2, simcase="two-stream"):
    cfg = SimConfig(simcase=simcase, n_particles=n, n_mesh=32, dt=0.1,
                    t_max=5.0, length=L)
    act = make_actuator(cfg.length, cfg.n_mesh, max_mode)
    return cfg, make_grid(cfg.n_mesh, cfg.length), act, init_state(cfg, jax.random.PRNGKey(0))


class TestSpectralDrift:
    """Rotation-drift variant of the whole-horizon spectral kernel: the drift
    advances a carried base-harmonic phasor by a small-angle polynomial
    rotation instead of recomputing cos/sin of the wrapped position."""

    def test_rot_matches_trig(self):
        n, k, h, km = 384, 8, 6, 6
        x, v, u_c, u_s = _inputs(n, k, h, km)
        kw = dict(length=L, dt=0.1, n0=1.0, n_particles=n, interpret=True)
        pe_trig = np.asarray(sh.fused_spectral_horizon(x, v, u_c, u_s, rot=False, **kw))
        pe_rot = np.asarray(sh.fused_spectral_horizon(x, v, u_c, u_s, rot=True, **kw))
        assert np.isfinite(pe_rot).all()
        np.testing.assert_allclose(pe_rot, pe_trig, rtol=2e-4, atol=1e-6)

    def test_auto_gate_is_static_on_angle_bound(self):
        assert sh._use_rot(0.1, 50.0, 384 * 5000, "auto")     # |delta| << 1
        assert not sh._use_rot(1.0, 5.0, 384 * 5000, "auto")  # 25σ sweeps > L/2
        assert sh._use_rot(1.0, 5.0, 384 * 5000, "rot")       # explicit wins
        assert not sh._use_rot(0.1, 50.0, 384 * 5000, "trig")

    def test_auto_takes_trig_when_carry_leaves_l2(self):
        """rot carries three planes, trig two: where rot's carry no longer
        fits the L2 cache (config 4: K=384, N=100k, 460 MB) trig moves a
        third fewer bytes through device memory and auto takes it."""
        assert sh._use_rot(0.1, 50.0, 384 * 5000)          # config 3: 23 MB
        assert sh._use_rot(0.1, 50.0, 384 * 7500)          # 35 MB
        assert not sh._use_rot(0.1, 50.0, 384 * 10_000)    # 46 MB
        assert not sh._use_rot(0.1, 50.0, 384 * 100_000)   # config 4

    def test_supported_gate_is_the_int32_index(self):
        assert sh.spectral_horizon_supported(5000, 384)
        assert sh.spectral_horizon_supported(1_000_000, 2048)
        assert not sh.spectral_horizon_supported(10_000_000, 256)

    @pytest.mark.parametrize("drift", ["rot", "trig"])
    def test_kernel_correct_with_chunk_tail(self, drift):
        """N=700 is not a multiple of the 256-particle chunk: the masked
        tail must contribute nothing. Kernel costs == streamed XLA costs."""
        cfg, grid, act, st = _model(700, simcase="bump-on-tail")
        cand = 0.3 * jax.random.normal(jax.random.PRNGKey(1), (8, 4, 4))
        mpc = MPCConfig(horizon=4, n_candidates=8, plan_modes=4, spectral_drift=drift)
        c_xla = np.asarray(candidate_costs(
            st, cand, grid, cfg, MPCConfig(horizon=4, n_candidates=8, plan_modes=4,
                                           plan_kernel="xla"), act))
        c_kernel = np.asarray(_spectral_kernel_costs(st, cand, cfg, mpc, act, interpret=True))
        np.testing.assert_allclose(c_kernel, c_xla, rtol=2e-4, atol=1e-5)

    def test_config_plumbs_drift_choice(self):
        """MPCConfig.spectral_drift reaches the kernel (rot vs trig produce
        the tested fp32-equal costs, and an explicit 'rot' actually flips
        the code path)."""
        ctrl = ControlConfig(max_mode=2)
        cfg, grid, act, st = _model(300)
        cand = 0.3 * jax.random.normal(jax.random.PRNGKey(1), (8, 4, ctrl.n_actions))
        costs = {}
        for drift in ("trig", "rot"):
            mpc = MPCConfig(horizon=4, n_candidates=8, plan_modes=4, spectral_drift=drift)
            costs[drift] = np.asarray(
                _spectral_kernel_costs(st, cand, cfg, mpc, act, interpret=True))
        assert np.isfinite(costs["rot"]).all()
        np.testing.assert_allclose(costs["rot"], costs["trig"], rtol=2e-4, atol=1e-6)
        # not bit-identical: the rot path must actually be different code
        assert not np.array_equal(costs["rot"], costs["trig"])


class TestTritonLowering:
    """The kernel lowers to Triton IR for the CUDA platform on the CPU: a
    primitive the Triton route cannot express fails here, before the card."""

    @pytest.mark.parametrize("rot,corrected", [(True, False), (False, False), (True, True)])
    def test_lowers_for_cuda(self, rot, corrected):
        n, k, h, km = 700, 8, 4, 4
        x, v, u_c, u_s = _inputs(n, k, h, km)
        twin = dict(twin_c=jnp.ones((h, km)), twin_s=jnp.ones((h, km))) if corrected else {}
        fn = jax.jit(functools.partial(
            sh.fused_spectral_horizon, length=L, dt=0.1, n0=1.0, n_particles=n, rot=rot))
        text = fn.trace(x, v, u_c, u_s, **twin).lower(
            lowering_platforms=("cuda",)).as_text()
        assert "triton" in text


@pytest.mark.gpu
class TestCompiledOnCard:
    """The kernel as compiled for the card against the Pallas interpreter
    at small shapes (the interpreter is the CPU tests' reference)."""

    @pytest.mark.parametrize("rot,corrected", [(True, False), (False, False), (True, True),
                                               (False, True)])
    def test_compiled_matches_interpreter(self, gpu, rot, corrected):
        n, k, h, km = 700, 16, 5, 8
        x, v, u_c, u_s = _inputs(n, k, h, km)
        twin = dict(twin_c=0.5 * jnp.ones((h, km)), twin_s=0.5 * jnp.ones((h, km))) \
            if corrected else {}
        kw = dict(length=L, dt=0.1, n0=1.0, n_particles=n, rot=rot, **twin)
        got = np.asarray(sh.fused_spectral_horizon(x, v, u_c, u_s, **kw))
        ref = np.asarray(sh.fused_spectral_horizon(x, v, u_c, u_s, interpret=True, **kw))
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6)
