"""Receding-horizon sampling MPC control (the controller that replaces the
reference's RL training loops; BASELINE.json north star).

Usage: python run_mpc.py --simcase bump-on-tail --max_mode 4 \\
           --n_candidates 512 --horizon 8 --plan_modes 8

Planning runs at full fidelity by default. ``--plan_particles`` speeds up
solves ~proportionally but is only safe while the coherent field dwarfs the
subsample's injected noise floor (strong-signal regimes like a growing
two-stream); on quiet plasmas it makes the controller PUMP the field it
should damp — the script checks this at t=0 and warns
(control/mpc.py::plan_fidelity_check).
"""

import jax
import numpy as np

from plasma_control_tpu.cli import (
    add_control_args,
    add_mpc_args,
    base_parser,
    build_control_config,
    build_mpc_config,
    build_sim_config,
    compute_cost_traces,
    run_and_save,
)
from plasma_control_tpu.control.actuator import make_actuator
from plasma_control_tpu.control.evaluate import policy_rollout
from plasma_control_tpu.control.mpc import mpc_rollout
from plasma_control_tpu.models.distributions import make_distribution
from plasma_control_tpu.models.pic import init_state
from plasma_control_tpu.models.rollout import rollout
from plasma_control_tpu.ops.grid import make_grid


def main():
    p = add_mpc_args(add_control_args(base_parser("PIC simulation with receding-horizon MPC E-field control")))
    p.add_argument("--checkpoint_every", type=int, default=0,
                   help="env steps between full controller-state checkpoints (0 = off)")
    p.add_argument("--checkpoint_path", type=str, default=None)
    p.add_argument("--no_resume", action="store_true", help="ignore an existing checkpoint")
    p.add_argument("--aot", type=str, default=None, metavar="ARTIFACT",
                   help="run the closed loop through an AOT control-step artifact "
                        "(io/aot.py: .stablehlo from export_plan(kind='control_step'), "
                        "or .pkl from save_compiled_plan) instead of tracing/compiling "
                        "the framework — the cold-start/serving path. Shapes are pinned "
                        "by the artifact and must match the flags.")
    p.add_argument("--save_aot", type=str, default=None, metavar="PATH",
                   help="build + save the control-step artifact for this configuration "
                        "and exit (.pkl -> pickled XLA executable, else StableHLO)")
    args = vars(p.parse_args())
    cfg = build_sim_config(args)
    ctrl = build_control_config(args)
    mpc = build_mpc_config(args)

    grid = jax.device_put(make_grid(cfg.n_mesh, cfg.length))
    actuator = make_actuator(cfg.length, cfg.n_mesh, ctrl.max_mode, endpoint_grid=ctrl.endpoint_grid)
    state = init_state(cfg, jax.random.PRNGKey(cfg.seed))

    if args["save_aot"]:
        import time

        from plasma_control_tpu.io.aot import (
            export_plan, save_compiled_plan, write_fingerprint)

        t0 = time.perf_counter()
        if args["save_aot"].endswith(".pkl"):
            save_compiled_plan(args["save_aot"], grid, cfg, ctrl, mpc, actuator,
                               kind="control_step")
        else:
            export_plan(grid, cfg, ctrl, mpc, actuator, path=args["save_aot"],
                        kind="control_step")
        write_fingerprint(args["save_aot"], cfg, ctrl, mpc)
        print(f"# AOT control-step artifact written to {args['save_aot']} "
              f"({time.perf_counter() - t0:.1f}s)")
        return

    if args["aot"] and args["checkpoint_every"]:
        raise SystemExit("--aot runs a host loop over a fixed artifact; use the "
                         "traced path for --checkpoint_every segmented resume")

    from plasma_control_tpu.control.mpc import _plan_frac, plan_fidelity_check

    if _plan_frac(cfg, mpc) < 1.0 and mpc.plan_correction == "none":
        # with --plan_correction twin the subsampled cost is noise-corrected
        # (MPCConfig.plan_correction) and this warning does not apply

        chk = plan_fidelity_check(state, cfg, ctrl, mpc)
        if not chk["safe"]:
            guard_msg = (
                "the on-device fidelity guard (MPCConfig.fidelity_guard, on by "
                "default) will hold the drive OFF until the coherent signal "
                "clears the floor"
                if mpc.fidelity_guard
                else "the guard is DISABLED — the planner can 'cancel' noise "
                "that does not exist in the real plasma and pump it instead "
                "of damping"
            )
            print(
                f"# WARNING: --plan_particles {mpc.plan_particles} injects a plan-model "
                f"noise floor ({chk['injected_noise_pe']:.1f}) comparable to the coherent "
                f"field energy ({chk['coherent_pe']:.1f}, ratio {chk['ratio']:.2f} < {mpc.fidelity_guard_ratio:g}) at t=0 — "
                f"{guard_msg}. Plan at full fidelity (drop --plan_particles) for "
                "quiet/saturated plasmas."
            )

    if args["aot"]:
        import time

        from plasma_control_tpu.io.aot import (
            aot_mpc_rollout, check_fingerprint, load_compiled_plan, load_plan)

        try:
            check_fingerprint(args["aot"], cfg, ctrl, mpc)
        except ValueError as e:
            raise SystemExit(str(e))
        t0 = time.perf_counter()
        loader = load_compiled_plan if args["aot"].endswith(".pkl") else load_plan
        ctrl_step = loader(args["aot"])
        print(f"# AOT artifact loaded in {time.perf_counter() - t0:.1f}s "
              f"(no framework tracing)")
        out = aot_mpc_rollout(ctrl_step, state, jax.random.PRNGKey(cfg.seed + 1),
                              cfg.n_steps, mpc.horizon, ctrl.n_actions)
        coeffs = out.coeffs
    elif args["checkpoint_every"]:
        from plasma_control_tpu.io.resume import resumable_mpc_rollout

        ck = args["checkpoint_path"] or f"checkpoints/{args['simcase']}-mpc"
        _, traces = resumable_mpc_rollout(
            state, grid, cfg, ctrl, mpc, actuator, jax.random.PRNGKey(cfg.seed + 1),
            ckpt_path=ck,
            segment_steps=args["checkpoint_every"],
            resume=not args["no_resume"],
        )
        coeffs = jax.numpy.asarray(traces["coeffs_full"])
    else:
        out = mpc_rollout(state, grid, cfg, ctrl, mpc, actuator, jax.random.PRNGKey(cfg.seed + 1))
        coeffs = out.coeffs  # (T, 2K)

    # re-play the recorded control sequence to collect snapshots
    replay = rollout(
        state, grid, cfg,
        e_external_traj=actuator.compute_e_packed(coeffs),
        record_snapshots=True,
    )
    snapshot = np.concatenate([np.asarray(replay.xs).T, np.asarray(replay.vs).T], axis=0)
    coeff_cos = np.asarray(coeffs[:, : ctrl.max_mode]).T
    coeff_sin = np.asarray(coeffs[:, ctrl.max_mode :]).T
    costs = compute_cost_traces(snapshot, cfg, ctrl, coeffs=np.asarray(coeffs))

    high_idx = None
    if cfg.simcase == "bump-on-tail":
        high_idx = np.asarray(make_distribution(cfg).high_indices())

    run_and_save(
        "mpc-control", args, cfg, ctrl, snapshot, replay.hamiltonian, replay.field_energy,
        coeff_cos=coeff_cos, coeff_sin=coeff_sin, costs=costs, high_idx=high_idx,
    )


if __name__ == "__main__":
    main()
