"""Velocity-moment order study for the spectral actor (amortized MPC).

Round-2 finding (DEVNOTES): switching the DAgger actor's encoder from
DeepSets to per-mode phase-space moments (density + current, v_order=1) cut
closed-loop tail PE 2.1-2.5x — the encoder, not DAgger, was the learned
controller's bottleneck. This study asks whether the NEXT moments of the
linearized Vlasov hierarchy — per-mode pressure (v_order=2) and heat flux
(v_order=3) — buy further distillation quality, at the same landscape config
the 57.5 baseline was measured at (two-stream, N=2000, M=64, max_mode=3,
t=25, MPC expert K=64/H=8, 6 DAgger iterations, eval on 3 held-out seeds).

Usage:
    python experiments/encoder_order_study.py [--cpu] [--orders 1,2,3]
        [--iters 6] [--train_seeds 1]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--orders", default="1,2,3")
    p.add_argument("--iters", type=int, default=6)
    p.add_argument("--train_seeds", type=int, default=1,
                   help="independent DAgger trainings per order (key 7+i)")
    p.add_argument("--eval_seeds", type=int, default=3)
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
    from plasma_control_tpu.control.rl.dagger import dagger_train
    from plasma_control_tpu.control.rl.ddpg import DDPGConfig
    from plasma_control_tpu.models.pic import init_state
    from plasma_control_tpu.ops.grid import make_grid

    cfg = SimConfig(n_particles=2000, n_mesh=64, dt=0.1, t_max=25.0, length=50.0)
    ctrl = ControlConfig(max_mode=3)
    grid = make_grid(cfg.n_mesh, cfg.length)
    act = make_actuator(cfg.length, cfg.n_mesh, ctrl.max_mode)
    mpc_exp = MPCConfig(horizon=8, n_candidates=64)
    eval_states = [init_state(cfg, jax.random.PRNGKey(42 + s)) for s in range(args.eval_seeds)]

    def tail(pe):
        return float(jnp.mean(pe[-50:]))

    print(f"{'v_order':8s} {'train':6s} {'bc_loss':8s} tail PE per eval seed{' ':10s} mean")
    for order in [int(o) for o in args.orders.split(",")]:
        for ts in range(args.train_seeds):
            hp = DDPGConfig(encoder="spectral", encoder_v_order=order)
            nets, params, hist = dagger_train(
                cfg, ctrl, hp, grid, act, jax.random.PRNGKey(7 + ts),
                n_iters=args.iters, epochs_per_iter=300, mpc=mpc_exp, verbose=False,
            )
            fn = lambda s: nets.actor.sample(params, s[None])[0]
            tails = [
                tail(policy_rollout(st, grid, cfg, act, fn, record_snapshots=False).field_energy)
                for st in eval_states
            ]
            print(
                f"{order:<8d} {ts:<6d} {hist['bc_loss'][-1]:<8.4f} "
                f"{str([round(t, 1) for t in tails]):32s} {np.mean(tails):8.1f}",
                flush=True,
            )


if __name__ == "__main__":
    main()
