"""End-to-end CLI smoke tests: each run script on a tiny config produces the
data + plot artifact set (SURVEY §2.4 entry-point parity)."""

import os
import runpy
import sys

import numpy as np
import pytest

TINY = [
    "--num_particle", "400",
    "--num_mesh", "32",
    "--t_max", "3.0",
    "--is_save",
]


def run_script(tmp_path, script, extra):
    argv = [script] + TINY + [
        "--save_file", str(tmp_path / "dataset"),
        "--save_plot", str(tmp_path / "result"),
    ] + extra
    old = sys.argv
    sys.argv = argv
    try:
        runpy.run_path(os.path.join(os.path.dirname(__file__), "..", script), run_name="__main__")
    finally:
        sys.argv = old


def check_artifacts(tmp_path, tag, controlled=True, simcase="two-stream"):
    d = tmp_path / "dataset" / simcase / tag
    r = tmp_path / "result" / simcase / tag
    assert (d / "data.mat").exists()
    assert (d / "data.npz").exists()
    for f in ["log_E.pdf", "Ek_spectrum.pdf", "Ek_t.pdf", "phase_space_evolution.pdf", "x_dist.pdf", "v_dist.pdf", "cost.pdf"]:
        assert (r / f).exists(), f
    if controlled:
        assert (r / "Ek_t_external.pdf").exists()

    from plasma_control_tpu.io.export import load_run

    data = load_run(str(d / "data.npz"))
    assert data["snapshot"].shape[0] == 2 * 400
    assert np.isfinite(data["PE"]).all()


class TestRunScripts:
    def test_run_wo_oc(self, tmp_path):
        run_script(tmp_path, "run_wo_oc.py", [])
        check_artifacts(tmp_path, "wo-oc", controlled=False)

    def test_run_feedback(self, tmp_path):
        run_script(tmp_path, "run_feedback.py", ["--max_mode", "2"])
        check_artifacts(tmp_path, "feedback")

    def test_run_wo_oc_landau(self, tmp_path):
        """The landau simcase works end-to-end through the CLI (density-
        perturbed Maxwellian, no velocity perturbation, full artifact set)."""
        run_script(tmp_path, "run_wo_oc.py", ["--simcase", "landau"])
        check_artifacts(tmp_path, "wo-oc", controlled=False, simcase="landau")

    def test_run_mpc(self, tmp_path):
        run_script(
            tmp_path, "run_mpc.py",
            ["--max_mode", "2", "--n_candidates", "16", "--horizon", "3"],
        )
        check_artifacts(tmp_path, "mpc-control")

    def test_run_mpc_terminal_cost_flags(self, tmp_path):
        """--w_terminal / --no_antithetic reach MPCConfig and still produce
        the full artifact set."""
        run_script(
            tmp_path, "run_mpc.py",
            ["--max_mode", "2", "--n_candidates", "16", "--horizon", "4",
             "--w_terminal", "4.0", "--no_antithetic"],
        )
        check_artifacts(tmp_path, "mpc-control")

    def test_run_mpc_aot_roundtrip(self, tmp_path):
        """--save_aot builds a control-step artifact; --aot runs the closed
        loop through it (no framework tracing) and produces the full
        artifact set — the serving/cold-start path."""
        art = str(tmp_path / "ctrl_step.stablehlo")
        run_script(
            tmp_path, "run_mpc.py",
            ["--max_mode", "2", "--n_candidates", "16", "--horizon", "3",
             "--save_aot", art],
        )
        assert os.path.exists(art) and os.path.getsize(art) > 0
        run_script(
            tmp_path, "run_mpc.py",
            ["--max_mode", "2", "--n_candidates", "16", "--horizon", "3",
             "--aot", art],
        )
        check_artifacts(tmp_path, "mpc-control")

    def test_run_mpc_aot_rejects_stale_artifact(self, tmp_path):
        """--aot refuses an artifact whose fingerprint sidecar names another
        configuration (or JAX version, or platform) than the flags."""
        art = str(tmp_path / "ctrl_step.stablehlo")
        run_script(
            tmp_path, "run_mpc.py",
            ["--max_mode", "2", "--n_candidates", "16", "--horizon", "3",
             "--save_aot", art],
        )
        with pytest.raises(SystemExit, match="rebuild it with --save_aot"):
            run_script(
                tmp_path, "run_mpc.py",
                ["--max_mode", "2", "--n_candidates", "16", "--horizon", "4",
                 "--aot", art],
            )

    def test_run_ddpg_train_and_eval(self, tmp_path):
        run_script(
            tmp_path, "run_ddpg.py",
            ["--max_mode", "2", "--optimize", "--num_episode", "1", "--mlp_dim", "8",
             "--capacity", "128", "--batch_size", "8", "--min_buffer_size", "16", "--update_freq", "8"],
        )
        check_artifacts(tmp_path, "ddpg-control")
        assert (tmp_path / "dataset" / "two-stream" / "ddpg-control" / "ddpg_best.msgpack").exists()

    def test_run_ppo_eval_only(self, tmp_path):
        run_script(tmp_path, "run_ppo.py", ["--max_mode", "2", "--mlp_dim", "8"])
        check_artifacts(tmp_path, "ppo-control")

    def test_run_sac_eval_only(self, tmp_path):
        run_script(
            tmp_path, "run_sac.py",
            ["--max_mode", "2", "--mlp_dim", "8"],
        )
        check_artifacts(tmp_path, "sac-control")

    def test_run_lqr(self, tmp_path):
        run_script(
            tmp_path, "run_lqr.py",
            ["--max_mode", "2", "--n_excite_rollouts", "2", "--excite_steps", "20", "--n_lags", "3"],
        )
        check_artifacts(tmp_path, "lqr-control")

    def test_run_dagger_train_and_eval(self, tmp_path):
        """Amortized-MPC distillation end-to-end: 1 DAgger iteration on a
        tiny config trains, saves weights, and produces the artifact set."""
        actor = tmp_path / "actor.msgpack"
        run_script(
            tmp_path, "run_dagger.py",
            ["--max_mode", "2", "--optimize", "--dagger_iters", "1",
             "--epochs_per_iter", "5", "--mlp_dim", "8",
             "--horizon", "3", "--n_candidates", "8", "--plan_modes", "4",
             "--actor_path", str(actor)],
        )
        check_artifacts(tmp_path, "dagger-control")
        assert actor.exists()

    def test_run_dagger_eval_only(self, tmp_path):
        run_script(
            tmp_path, "run_dagger.py",
            ["--max_mode", "2", "--mlp_dim", "8",
             "--actor_path", str(tmp_path / "missing.msgpack")],
        )
        check_artifacts(tmp_path, "dagger-control")


class TestMPCConfigValidation:
    def test_negative_terminal_steps_rejected(self):
        """A negative tail length would flip the geometric tail into a cost
        credit rewarding growing candidates (ADVICE r1)."""
        from plasma_control_tpu.config import MPCConfig

        with pytest.raises(ValueError, match="terminal_steps"):
            MPCConfig(terminal_steps=-1)

    def test_growth_mode_short_horizon_warns(self):
        from plasma_control_tpu.config import MPCConfig

        with pytest.warns(UserWarning, match="horizon >= 2"):
            MPCConfig(horizon=1, terminal_mode="growth")
