"""AOT artifacts for the MPC solve (io/aot.py): portable StableHLO export
and same-topology serialized executables, both reproducing the live solve."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from plasma_control_tpu.config import ControlConfig, MPCConfig, SimConfig
from plasma_control_tpu.control.actuator import make_actuator
from plasma_control_tpu.io.aot import (
    export_plan,
    load_compiled_plan,
    load_plan,
    plan_example_args,
    plan_step_fn,
    save_compiled_plan,
)
from plasma_control_tpu.models.pic import init_state
from plasma_control_tpu.ops.grid import make_grid


@pytest.fixture(scope="module")
def setup():
    cfg = SimConfig(n_particles=300, n_mesh=32, dt=0.1, t_max=5.0)
    ctrl = ControlConfig(max_mode=2)
    mpc = MPCConfig(horizon=4, n_candidates=16)
    grid = make_grid(cfg.n_mesh, cfg.length)
    act = make_actuator(cfg.length, cfg.n_mesh, ctrl.max_mode)
    st = init_state(cfg, jax.random.PRNGKey(0))
    return cfg, ctrl, mpc, grid, act, st


def _args(setup):
    cfg, ctrl, mpc, grid, act, st = setup
    mean = jnp.zeros((mpc.horizon, ctrl.n_actions), jnp.float32)
    return (st.x, st.v, mean, jax.random.PRNGKey(7))


class TestExportPlan:
    def test_roundtrip_matches_live_solve(self, setup, tmp_path):
        cfg, ctrl, mpc, grid, act, st = setup
        live = plan_step_fn(grid, cfg, ctrl, mpc, act)
        a0, m0, c0 = live(*_args(setup))

        path = str(tmp_path / "plan.stablehlo")
        blob = export_plan(grid, cfg, ctrl, mpc, act, path=path)
        assert len(blob) > 0 and (tmp_path / "plan.stablehlo").stat().st_size == len(blob)

        restored = load_plan(path)
        a1, m1, c1 = restored(*_args(setup))
        np.testing.assert_allclose(np.asarray(a1), np.asarray(a0), rtol=1e-6)
        np.testing.assert_allclose(np.asarray(m1), np.asarray(m0), rtol=1e-6)
        np.testing.assert_allclose(np.asarray(c1), np.asarray(c0), rtol=1e-6)

    def test_exported_shapes_are_pinned(self, setup):
        cfg, ctrl, mpc, grid, act, st = setup
        restored = load_plan(export_plan(grid, cfg, ctrl, mpc, act))
        x, v, mean, key = _args(setup)
        with pytest.raises(ValueError, match="Shape mismatch"):
            restored(x[:-1], v[:-1], mean, key)  # wrong N must be rejected


class TestCompiledPlan:
    def test_roundtrip_matches_live_solve(self, setup, tmp_path):
        cfg, ctrl, mpc, grid, act, st = setup
        live = plan_step_fn(grid, cfg, ctrl, mpc, act)
        a0, m0, c0 = live(*_args(setup))

        path = str(tmp_path / "plan.exec.pkl")
        save_compiled_plan(path, grid, cfg, ctrl, mpc, act)
        restored = load_compiled_plan(path)
        a1, m1, c1 = restored(*_args(setup))
        np.testing.assert_allclose(np.asarray(a1), np.asarray(a0), rtol=1e-6)
        np.testing.assert_allclose(np.asarray(m1), np.asarray(m0), rtol=1e-6)
        np.testing.assert_allclose(np.asarray(c1), np.asarray(c0), rtol=1e-6)


class TestControlStep:
    def test_aot_host_loop_reproduces_mpc_rollout(self, setup, tmp_path):
        """A host loop over the kind='control_step' artifact reproduces
        mpc_rollout: same key schedule, same scan body. BIT-equal to a host
        loop over the live jitted control step (identical traced program);
        vs the scan-form mpc_rollout the tolerance is loose — the two are
        separately compiled programs and fp reassociation noise is amplified
        by the closed loop (measured ~4e-6 over 4 steps on CPU)."""
        from plasma_control_tpu.control.mpc import mpc_rollout
        from plasma_control_tpu.io.aot import aot_mpc_rollout, control_step_fn

        cfg, ctrl, mpc, grid, act, st = setup
        key = jax.random.PRNGKey(3)
        n_steps = 4

        path = str(tmp_path / "ctrl_step.stablehlo")
        export_plan(grid, cfg, ctrl, mpc, act, path=path, kind="control_step")
        step = load_plan(path)
        out = aot_mpc_rollout(step, st, key, n_steps, mpc.horizon, ctrl.n_actions)

        # exact contract: artifact == live jitted control step, bit for bit
        live = jax.jit(control_step_fn(grid, cfg, ctrl, mpc, act))
        ref_live = aot_mpc_rollout(live, st, key, n_steps, mpc.horizon, ctrl.n_actions)
        np.testing.assert_array_equal(
            np.asarray(out.coeffs), np.asarray(ref_live.coeffs))
        np.testing.assert_array_equal(
            np.asarray(out.final_state.x), np.asarray(ref_live.final_state.x))

        # semantic contract: == mpc_rollout up to compile-order fp noise
        ref = mpc_rollout(st, grid, cfg, ctrl, mpc, act, key, n_steps=n_steps)
        np.testing.assert_allclose(
            np.asarray(out.field_energy), np.asarray(ref.field_energy),
            rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(
            np.asarray(out.coeffs), np.asarray(ref.coeffs), rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(
            np.asarray(out.final_mean), np.asarray(ref.final_mean),
            rtol=1e-3, atol=1e-4)

    def test_compiled_control_step_matches_live(self, setup, tmp_path):
        from plasma_control_tpu.io.aot import control_step_fn

        cfg, ctrl, mpc, grid, act, st = setup
        live = control_step_fn(grid, cfg, ctrl, mpc, act)
        ref = live(*_args(setup))

        path = str(tmp_path / "ctrl_step.exec.pkl")
        save_compiled_plan(path, grid, cfg, ctrl, mpc, act, kind="control_step")
        out = load_compiled_plan(path)(*_args(setup))
        for a, b in zip(out, ref):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-7)


def test_example_args_match_config():
    cfg = SimConfig(n_particles=123, n_mesh=16)
    ctrl = ControlConfig(max_mode=3)
    mpc = MPCConfig(horizon=5, n_candidates=8)
    x, v, mean, key = plan_example_args(cfg, ctrl, mpc)
    assert x.shape == (123,) and v.shape == (123,)
    assert mean.shape == (5, 6)


class TestFingerprint:
    def test_platform_is_part_of_the_key(self, setup, monkeypatch):
        """An artifact lowered for one platform cannot run on another, so
        the staleness fingerprint changes with the platform alone."""
        import dataclasses

        from plasma_control_tpu.io import aot

        cfg, ctrl, mpc = setup[0], setup[1], setup[2]
        here = aot.config_fingerprint(cfg, ctrl, mpc)
        assert here == aot.config_fingerprint(cfg, ctrl, mpc)
        monkeypatch.setattr(aot.jax, "default_backend", lambda: "gpu")
        assert aot.config_fingerprint(cfg, ctrl, mpc) != here
        assert aot.config_fingerprint(
            cfg, ctrl, dataclasses.replace(mpc, horizon=mpc.horizon + 1)
        ) != aot.config_fingerprint(cfg, ctrl, mpc)
