"""Amortized MPC: distill the sampling-MPC planner into a single-forward-pass
actor with DAgger (control/rl/dagger.py, expert="mpc"), at the controller-
landscape config, with more iterations than the quick landscape run and
best-iteration selection (dagger_train(return_best=True)).

Saves the best actor to artifacts/dagger_mpc_actor.msgpack and evaluates it
closed-loop on the landscape seeds (two-stream N=2000/M=64, tail = last 50
steps) — comparable to the DEVNOTES controller-landscape table.

Run: python experiments/dagger_mpc_train.py [n_iters] [encoder]
``encoder``: "deepsets" (reference ParticleEncoder) or "spectral" (per-mode
phase-space moments, networks.SpectralEncoder — built for this distillation).
Measured results are recorded in DEVNOTES.md.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

if __name__ == "__main__":
    from plasma_control_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()

    import numpy as np
    import jax.numpy as jnp

    from plasma_control_tpu.config import ControlConfig, MPCConfig, SimConfig
    from plasma_control_tpu.control.actuator import make_actuator
    from plasma_control_tpu.control.evaluate import policy_rollout
    from plasma_control_tpu.control.rl.dagger import dagger_train
    from plasma_control_tpu.control.rl.ddpg import DDPGConfig
    from plasma_control_tpu.io.checkpoint import save_params
    from plasma_control_tpu.models.pic import init_state
    from plasma_control_tpu.ops.grid import make_grid

    n_iters = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    encoder = sys.argv[2] if len(sys.argv) > 2 else "deepsets"
    expert_k = int(sys.argv[3]) if len(sys.argv) > 3 else 64

    cfg = SimConfig(n_particles=2000, n_mesh=64, dt=0.1, t_max=25.0, length=50.0)
    ctrl = ControlConfig(max_mode=3)
    grid = make_grid(cfg.n_mesh, cfg.length)
    act = make_actuator(cfg.length, cfg.n_mesh, ctrl.max_mode)

    mpc_exp = MPCConfig(horizon=8, n_candidates=expert_k)
    nets, params, hist = dagger_train(
        cfg, ctrl, DDPGConfig(encoder=encoder), grid, act, jax.random.PRNGKey(7),
        n_iters=n_iters, epochs_per_iter=400, mpc=mpc_exp,
    )
    print("encoder:", encoder, "expert_k:", expert_k, flush=True)
    print("pe_tail per iter:", [round(p, 1) for p in hist["pe_tail"]], flush=True)

    suffix = "" if encoder == "deepsets" else f"_{encoder}"
    out = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "artifacts", f"dagger_mpc_actor{suffix}.msgpack")
    save_params(out, params)
    print("saved", out, flush=True)

    fn = lambda s: nets.actor.sample(params, s[None])[0]
    tails = []
    for s in range(3):
        st = init_state(cfg, jax.random.PRNGKey(42 + s))
        pe = policy_rollout(st, grid, cfg, act, fn, record_snapshots=False).field_energy
        tails.append(round(float(jnp.mean(pe[-50:])), 1))
    print("eval tails (landscape seeds):", tails, "mean", round(float(np.mean(tails)), 1))
