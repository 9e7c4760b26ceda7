"""Controller landscape: tail field energy of every controller family at the
standard test config (two-stream, N=2000, M=64, max_mode=3, t=25, tail = last
50 steps) — reproduces the DEVNOTES "Controller landscape" table in one run.

Usage:
    python experiments/controller_landscape.py [--cpu] [--seeds 3]
        [--actor artifacts/ddpg_two_stream_shaped.msgpack ...]

Each ``--actor`` msgpack is evaluated as a deterministic closed-loop DDPG
actor (the reference's evaluation tail, `run_ddpg.py:249-313`). Seed variance
on two-stream suppression is large (DEVNOTES: +-2x) — compare means.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--seeds", type=int, default=3)
    p.add_argument("--actor", action="append", default=[])
    p.add_argument("--dagger_mpc", action="store_true",
                   help="also train + evaluate a policy distilled from the MPC "
                        "expert (amortized MPC, control/rl/dagger.py)")
    p.add_argument("--dagger_encoder", default="spectral",
                   choices=["deepsets", "spectral"],
                   help="actor encoder for --dagger_mpc (spectral phase-space "
                        "moments measured 2.1x better than DeepSets, DEVNOTES)")
    args = p.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from plasma_control_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()

    import jax.numpy as jnp
    import numpy as np

    from plasma_control_tpu.config import ControlConfig, MPCConfig, SimConfig
    from plasma_control_tpu.control.actuator import make_actuator
    from plasma_control_tpu.control.evaluate import policy_rollout
    from plasma_control_tpu.control.feedback import feedback_rollout
    from plasma_control_tpu.control.mpc import mpc_rollout
    from plasma_control_tpu.models.pic import init_state
    from plasma_control_tpu.models.rollout import rollout
    from plasma_control_tpu.ops.grid import make_grid

    cfg = SimConfig(n_particles=2000, n_mesh=64, dt=0.1, t_max=25.0, length=50.0)
    ctrl = ControlConfig(max_mode=3)
    grid = make_grid(cfg.n_mesh, cfg.length)
    act = make_actuator(cfg.length, cfg.n_mesh, ctrl.max_mode)
    states = [init_state(cfg, jax.random.PRNGKey(42 + s)) for s in range(args.seeds)]

    def tail(pe):
        return float(jnp.mean(pe[-50:]))

    rows = []
    rows.append(("none", [tail(rollout(st, grid, cfg).field_energy) for st in states]))
    rows.append(("feedback", [tail(feedback_rollout(st, grid, cfg, ctrl, act).field_energy) for st in states]))
    mpc = MPCConfig(horizon=8, n_candidates=128)
    rows.append((
        "mpc K=128 knots3",
        [tail(mpc_rollout(st, grid, cfg, ctrl, mpc, act, jax.random.PRNGKey(i)).field_energy)
         for i, st in enumerate(states)],
    ))

    if args.dagger_mpc:
        from plasma_control_tpu.control.rl.dagger import dagger_train
        from plasma_control_tpu.control.rl.ddpg import DDPGConfig

        mpc_exp = MPCConfig(horizon=8, n_candidates=64)
        nets_d, params_d, hist = dagger_train(
            cfg, ctrl, DDPGConfig(encoder=args.dagger_encoder), grid, act,
            jax.random.PRNGKey(7), n_iters=4, epochs_per_iter=300, mpc=mpc_exp,
        )
        fn_d = lambda s: nets_d.actor.sample(params_d, s[None])[0]
        rows.append((
            f"dagger(mpc expert, 4 iters, {args.dagger_encoder})",
            [tail(policy_rollout(st, grid, cfg, act, fn_d, record_snapshots=False).field_energy)
             for st in states],
        ))

    if args.actor:
        from plasma_control_tpu.control.rl.ddpg import DDPGConfig, make_ddpg
        from plasma_control_tpu.io.checkpoint import load_params

        nets, ts = make_ddpg(cfg, ctrl, DDPGConfig(), jax.random.PRNGKey(0))
        for path in args.actor:
            params = load_params(path, ts.actor_params)
            fn = lambda s: nets.actor.sample(params, s[None])[0]
            rows.append((
                f"ddpg:{os.path.basename(path)}",
                [tail(policy_rollout(st, grid, cfg, act, fn, record_snapshots=False).field_energy)
                 for st in states],
            ))

    print(f"{'controller':34s} tail PE per seed{' ':14s} mean")
    for name, tails in rows:
        print(f"{name:34s} {str([round(t, 1) for t in tails]):30s} {np.mean(tails):8.1f}")


if __name__ == "__main__":
    main()
