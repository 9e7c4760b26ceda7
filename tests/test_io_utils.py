"""IO (export/checkpoint) and utils (guards, timing) tests."""

import pytest
import numpy as np
import jax
import jax.numpy as jnp

from plasma_control_tpu.config import SimConfig
from plasma_control_tpu.io.export import build_run_dict, load_run, save_mat, save_npz
from plasma_control_tpu.io.checkpoint import load_params, restore_checkpoint, save_checkpoint, save_params
from plasma_control_tpu.utils.guards import check_invalid_value, temporal_average


class TestExport:
    def test_mat_npz_roundtrip(self, tmp_path):
        cfg = SimConfig(n_particles=10, n_mesh=8)
        snap = np.arange(20 * 3, dtype=np.float64).reshape(20, 3)
        mdic = build_run_dict(
            cfg, snap, np.ones(3), np.full(3, 2.0),
            coeff_cos=np.zeros((2, 3)), coeff_sin=np.ones((2, 3)),
            costs={"J_kl": np.arange(3.0)},
        )
        save_mat(str(tmp_path / "d.mat"), mdic)
        save_npz(str(tmp_path / "d.npz"), mdic)

        m = load_run(str(tmp_path / "d.mat"))
        np.testing.assert_allclose(m["snapshot"], snap)
        z = load_run(str(tmp_path / "d.npz"))
        np.testing.assert_allclose(z["snapshot"], snap)
        np.testing.assert_allclose(z["cost"]["J_kl"], np.arange(3.0))
        assert int(z["N"]) == 10


class TestCheckpoint:
    def test_params_roundtrip(self, tmp_path):
        params = {"w": jnp.arange(6.0).reshape(2, 3), "b": jnp.zeros(3)}
        save_params(str(tmp_path / "p.msgpack"), params)
        like = {"w": jnp.zeros((2, 3)), "b": jnp.ones(3)}
        out = load_params(str(tmp_path / "p.msgpack"), like)
        np.testing.assert_allclose(np.asarray(out["w"]), np.arange(6.0).reshape(2, 3))

    def test_full_state_roundtrip(self, tmp_path):
        tree = {
            "x": jnp.arange(5.0),
            "v": jnp.ones(5),
            "key": jax.random.PRNGKey(3),
            "step": jnp.asarray(7),
        }
        save_checkpoint(str(tmp_path / "ckpt"), tree)
        out = restore_checkpoint(str(tmp_path / "ckpt"), like=tree)
        np.testing.assert_allclose(np.asarray(out["x"]), np.arange(5.0))
        assert int(out["step"]) == 7


class TestGuards:
    def test_check_invalid(self):
        assert not bool(check_invalid_value(jnp.ones(4)))
        assert bool(check_invalid_value(jnp.asarray([1.0, jnp.nan])))
        assert bool(check_invalid_value(jnp.asarray([1.0, jnp.inf])))
        assert bool(check_invalid_value(jnp.asarray([1e5])))  # overflow > 1e4

    def test_temporal_average(self):
        y = jnp.arange(10.0)
        out = np.asarray(temporal_average(y, 4))
        # interior: mean over [i-2, i+2) = i - 0.5
        np.testing.assert_allclose(out[3:7], np.arange(3.0, 7.0) - 0.5)


class TestTiming:
    def test_slope_time_positive(self):
        from plasma_control_tpu.utils.timing import slope_time, time_fn

        step = lambda c: c * 1.000001 + 1e-7
        t = slope_time(step, jnp.ones((64, 64)), r1=2, r2=32)
        assert t >= 0.0
        t2 = time_fn(jax.jit(lambda x: x + 1), jnp.ones(16), reps=3)
        assert t2 > 0.0


class TestMetrics:
    def test_jsonl_logging(self, tmp_path):
        import json
        from plasma_control_tpu.utils.metrics import MetricsLogger

        path = str(tmp_path / "m.jsonl")
        with MetricsLogger(path, run="test") as log:
            log.log("step", t=1, pe=jnp.asarray(0.5))
            log.log_series("trace", {"pe": np.arange(3.0)})
        lines = [json.loads(l) for l in open(path)]
        assert lines[0]["kind"] == "step" and lines[0]["run"] == "test"
        assert lines[0]["pe"] == 0.5
        assert lines[1]["pe"] == [0.0, 1.0, 2.0]


class TestResumableRollout:
    def test_segmented_matches_unsegmented(self, tmp_path):
        from plasma_control_tpu.config import SimConfig
        from plasma_control_tpu.io.resume import resumable_rollout
        from plasma_control_tpu.models.pic import init_state
        from plasma_control_tpu.models.rollout import rollout
        from plasma_control_tpu.ops.grid import make_grid

        cfg = SimConfig(n_particles=500, n_mesh=32, dt=0.1, t_max=4.0)
        grid = make_grid(cfg.n_mesh, cfg.length)
        st = init_state(cfg, jax.random.PRNGKey(0))

        ref = rollout(st, grid, cfg, record_snapshots=True)
        _, pe, _, xs, _ = resumable_rollout(st, grid, cfg, segment_steps=7)
        np.testing.assert_allclose(pe, np.asarray(ref.field_energy), rtol=1e-5)
        np.testing.assert_allclose(xs[-1], np.asarray(ref.xs[-1]), atol=1e-5)

    def test_resume_continues_exactly(self, tmp_path):
        from plasma_control_tpu.config import SimConfig
        from plasma_control_tpu.io.resume import resumable_rollout
        from plasma_control_tpu.models.pic import init_state, PlasmaState
        from plasma_control_tpu.ops.grid import make_grid
        import dataclasses

        cfg = SimConfig(n_particles=500, n_mesh=32, dt=0.1, t_max=4.0)
        grid = make_grid(cfg.n_mesh, cfg.length)
        st = init_state(cfg, jax.random.PRNGKey(0))
        ck = str(tmp_path / "ck")

        # "interrupted" run: only the first 20 of 40 steps
        cfg_half = dataclasses.replace(cfg, t_max=2.0)
        final_half, *_ = resumable_rollout(st, grid, cfg_half, ckpt_path=ck, segment_steps=10)

        # resumed full run picks up at step 20 and completes
        final_full, pe, _, _, _ = resumable_rollout(st, grid, cfg, ckpt_path=ck, segment_steps=10)
        assert len(pe) == 20  # only the remaining steps produced here

        # equivalence with a straight run
        ref, *_ = resumable_rollout(st, grid, cfg, segment_steps=40)
        np.testing.assert_allclose(np.asarray(final_full.x), np.asarray(ref.x), atol=1e-4)


class TestResumableFeedback:
    def _setup(self):
        from plasma_control_tpu.config import ControlConfig, SimConfig
        from plasma_control_tpu.control.actuator import make_actuator
        from plasma_control_tpu.models.pic import init_state
        from plasma_control_tpu.ops.grid import make_grid

        cfg = SimConfig(n_particles=500, n_mesh=32, dt=0.1, t_max=4.0)  # 40 steps
        ctrl = ControlConfig(max_mode=2)
        grid = make_grid(cfg.n_mesh, cfg.length)
        act = make_actuator(cfg.length, cfg.n_mesh, ctrl.max_mode)
        st = init_state(cfg, jax.random.PRNGKey(0))
        return cfg, ctrl, grid, act, st

    def test_segmented_matches_unsegmented(self):
        from plasma_control_tpu.control.feedback import feedback_rollout
        from plasma_control_tpu.io.resume import resumable_feedback_rollout

        cfg, ctrl, grid, act, st = self._setup()
        ref = feedback_rollout(st, grid, cfg, ctrl, act, record_snapshots=True)
        _, tr = resumable_feedback_rollout(st, grid, cfg, ctrl, act, segment_steps=7)
        np.testing.assert_allclose(tr["field_energy"], np.asarray(ref.field_energy), rtol=1e-5)
        np.testing.assert_allclose(tr["coeff_cos"], np.asarray(ref.coeff_cos), atol=1e-6)
        np.testing.assert_allclose(tr["xs"][-1], np.asarray(ref.xs[-1]), atol=1e-5)

    def test_resume_continues_exactly(self, tmp_path):
        import dataclasses

        from plasma_control_tpu.io.resume import resumable_feedback_rollout

        cfg, ctrl, grid, act, st = self._setup()
        ck = str(tmp_path / "fb-ck")

        # "interrupted" run: first 20 of 40 steps
        cfg_half = dataclasses.replace(cfg, t_max=2.0)
        resumable_feedback_rollout(st, grid, cfg_half, ctrl, act, ckpt_path=ck, segment_steps=10)

        # resumed run completes the remaining 20
        fin, tr = resumable_feedback_rollout(st, grid, cfg, ctrl, act, ckpt_path=ck, segment_steps=10)
        assert len(tr["field_energy"]) == 20  # only the remaining steps here

        _, ref = resumable_feedback_rollout(st, grid, cfg, ctrl, act, segment_steps=40)
        np.testing.assert_allclose(np.asarray(fin.x), np.asarray(ref["xs"][-1]), atol=1e-4)
        np.testing.assert_allclose(tr["field_energy"], ref["field_energy"][20:], rtol=1e-4)


class TestResumableMPC:
    def _setup(self):
        from plasma_control_tpu.config import ControlConfig, MPCConfig, SimConfig
        from plasma_control_tpu.control.actuator import make_actuator
        from plasma_control_tpu.models.pic import init_state
        from plasma_control_tpu.ops.grid import make_grid

        cfg = SimConfig(n_particles=400, n_mesh=32, dt=0.1, t_max=1.2)  # 12 steps
        ctrl = ControlConfig(max_mode=2)
        mpc = MPCConfig(horizon=3, n_candidates=8)
        grid = make_grid(cfg.n_mesh, cfg.length)
        act = make_actuator(cfg.length, cfg.n_mesh, ctrl.max_mode)
        st = init_state(cfg, jax.random.PRNGKey(0))
        return cfg, ctrl, mpc, grid, act, st

    def test_segmented_matches_unsegmented(self):
        from plasma_control_tpu.control.mpc import mpc_rollout
        from plasma_control_tpu.io.resume import resumable_mpc_rollout

        cfg, ctrl, mpc, grid, act, st = self._setup()
        key = jax.random.PRNGKey(7)
        ref = mpc_rollout(st, grid, cfg, ctrl, mpc, act, key)
        _, tr = resumable_mpc_rollout(st, grid, cfg, ctrl, mpc, act, key, segment_steps=5)
        np.testing.assert_allclose(tr["field_energy"], np.asarray(ref.field_energy), rtol=1e-5)
        np.testing.assert_allclose(tr["coeffs_full"], np.asarray(ref.coeffs), atol=1e-6)

    def test_resume_continues_exactly(self, tmp_path):
        import dataclasses

        from plasma_control_tpu.io.resume import resumable_mpc_rollout

        cfg, ctrl, mpc, grid, act, st = self._setup()
        key = jax.random.PRNGKey(7)
        ck = str(tmp_path / "mpc-ck")

        # "interrupted" run: first 6 of 12 control steps
        cfg_half = dataclasses.replace(cfg, t_max=0.6)
        resumable_mpc_rollout(st, grid, cfg_half, ctrl, mpc, act, key, ckpt_path=ck, segment_steps=3)

        # resumed run completes the remaining 6 with the same key schedule
        fin, tr = resumable_mpc_rollout(st, grid, cfg, ctrl, mpc, act, key, ckpt_path=ck, segment_steps=3)
        assert len(tr["field_energy"]) == 6  # only the remaining steps here

        # equivalence with an uninterrupted run: full coeff history + final state
        _, ref = resumable_mpc_rollout(st, grid, cfg, ctrl, mpc, act, key, segment_steps=12)
        np.testing.assert_allclose(tr["coeffs_full"], ref["coeffs_full"], atol=1e-5)
        np.testing.assert_allclose(
            tr["field_energy"], ref["field_energy"][6:], rtol=1e-4
        )


class TestInitialStateImport:
    def test_roundtrip_through_mat(self, tmp_path):
        """A state exported to .mat (reference schema) reloads exactly and
        reproduces the same rollout — the reference-IC import path."""
        from plasma_control_tpu.config import SimConfig
        from plasma_control_tpu.io.export import build_run_dict, load_initial_state, save_mat
        from plasma_control_tpu.models.pic import PlasmaState, init_state
        from plasma_control_tpu.models.rollout import rollout
        from plasma_control_tpu.ops.grid import make_grid

        cfg = SimConfig(n_particles=400, n_mesh=32, dt=0.1, t_max=2.0)
        grid = make_grid(cfg.n_mesh, cfg.length)
        st = init_state(cfg, jax.random.PRNGKey(0))
        out = rollout(st, grid, cfg, record_snapshots=True)
        from plasma_control_tpu.models.rollout import snapshot_from_rollout

        mdic = build_run_dict(cfg, np.asarray(snapshot_from_rollout(out)), np.ones(1), np.ones(1))
        save_mat(str(tmp_path / "d.mat"), mdic)

        x, v = load_initial_state(str(tmp_path / "d.mat"), column=0)
        np.testing.assert_allclose(x, np.asarray(st.x), atol=1e-6)
        st2 = PlasmaState(jnp.asarray(x), jnp.asarray(v))
        out2 = rollout(st2, grid, cfg)
        np.testing.assert_allclose(
            np.asarray(out2.field_energy), np.asarray(out.field_energy), rtol=1e-5
        )


class TestDebug:
    def test_nan_checks_context(self):
        from plasma_control_tpu.utils.debug import nan_checks

        with pytest.raises(FloatingPointError):
            with nan_checks():
                jax.jit(lambda x: jnp.log(x))(jnp.asarray(-1.0)).block_until_ready()
        # config restored
        assert not jax.config.jax_debug_nans


class TestTrainCheckpointRobustness:
    def test_corrupt_meta_returns_none(self, tmp_path):
        """A truncated meta.npz (preemption mid-write before the atomic
        replace existed) must warn and return None — fresh start — instead of
        raising into the trainer."""
        import warnings

        from plasma_control_tpu.io.resume import restore_train_checkpoint

        d = tmp_path / "ck"
        d.mkdir()
        (d / "meta.npz").write_bytes(b"\x00garbage")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            assert restore_train_checkpoint(str(d), None, None, None, None) is None

    def test_missing_dir_returns_none(self, tmp_path):
        from plasma_control_tpu.io.resume import restore_train_checkpoint

        assert restore_train_checkpoint(str(tmp_path / "nope"), None, None, None, None) is None


class TestCompileCache:
    """utils/cache.py: one place decides where the persistent compilation
    cache lives."""

    def _calls(self, monkeypatch):
        from plasma_control_tpu.utils import cache

        calls = {}
        monkeypatch.setattr(cache.jax.config, "update",
                            lambda name, value: calls.__setitem__(name, value))
        return cache, calls

    def test_env_var_wins_and_nothing_is_set(self, monkeypatch, tmp_path):
        cache, calls = self._calls(monkeypatch)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert cache.enable_compile_cache() == str(tmp_path)
        assert calls == {}

    def test_default_is_the_checkout(self, monkeypatch):
        import os

        cache, calls = self._calls(monkeypatch)
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        path = cache.enable_compile_cache()
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert path == os.path.join(root, ".jax_cache")
        assert calls["jax_compilation_cache_dir"] == path
