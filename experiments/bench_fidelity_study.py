"""Bench-scale planning-fidelity study: closed-loop suppression at the
BASELINE config-3 shapes (bump-on-tail, N=5000/M=250, max_mode=4, K=512,
plan 1024/64) for the planner-fidelity reductions that the tiny-config
horizon study (experiments/horizon_study.py) found quality-neutral or
near-neutral: horizon 10 -> 8 (20% less work), plan_modes 16 -> 8 (~1.5x),
plan_particles 1024 -> 512 (~2x), and the short-horizon + terminal-cost
combination. The harder two-stream case is included for the candidate
default.

Any change to bench.py's MPC defaults must be justified by THIS study:
the headline metric is solves/s of the *quality-validated* solve — a
fidelity knob may only move if the seed-paired tail PE stays within noise
of the current default on BOTH sim cases.

Run: python experiments/bench_fidelity_study.py [n_seeds]

Result (4 paired seeds, 2026-08-19, tail PE = mean over last 100
steps; all variants here plan on a 1024-particle subsample, base = the
pre-round bench config):

    bump-on-tail uncontrolled            mean 33.4
    bump-on-tail H10.Km16.N1024 (base)   mean 270.0   <- CONTROL PUMPS 8x
    bump-on-tail H8/Km8/N512 variants    mean 219-414 (all pumping)
    two-stream   uncontrolled            mean 1074.5
    two-stream   H10.Km16.N1024 (base)   mean 188.9   (5.7x suppression)
    two-stream   H8 variants             mean 198-231 (H8 ~= H10)

This run exposed the multi-fidelity planning hazard (subsample noise
cancellation — see DEVNOTES 2026-08-19 and
experiments/bot_bench_scale_debug.py, which confirms full-fidelity planning
suppresses bump-on-tail to ~11-23 at the same states and that the bench
config H8/Km8/fullN is quality-equal on two-stream). bench.py moved to
full-fidelity planning as a consequence.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

if __name__ == "__main__":
    import numpy as np
    import jax.numpy as jnp

    from plasma_control_tpu.config import ControlConfig, MPCConfig, SimConfig
    from plasma_control_tpu.control.actuator import make_actuator
    from plasma_control_tpu.control.mpc import mpc_rollout
    from plasma_control_tpu.models.pic import init_state
    from plasma_control_tpu.models.rollout import rollout
    from plasma_control_tpu.ops.grid import make_grid

    n_seeds = int(sys.argv[1]) if len(sys.argv) > 1 else 4

    ctrl = ControlConfig(max_mode=4)
    base = dict(n_candidates=512, plan_particles=1024, plan_mesh=64)
    variants = [
        ("H10.Km16.N1024 (bench default)", dict()),
        ("H8.Km16.N1024", dict(horizon=8)),
        ("H8.Km8.N1024", dict(horizon=8, plan_modes=8)),
        ("H8.Km8.N512", dict(horizon=8, plan_modes=8, plan_particles=512)),
        ("H6.w4.Km8.N512", dict(horizon=6, w_terminal=4.0, plan_modes=8, plan_particles=512)),
    ]

    for case in ("bump-on-tail", "two-stream"):
        cfg = SimConfig(
            simcase=case, n_particles=5000, n_mesh=250, dt=0.1, t_max=50.0, length=50.0
        )
        grid = make_grid(cfg.n_mesh, cfg.length)
        act = make_actuator(cfg.length, cfg.n_mesh, ctrl.max_mode)

        tails_un = []
        for s in range(n_seeds):
            st = init_state(cfg, jax.random.PRNGKey(100 + s))
            un = rollout(st, grid, cfg)
            tails_un.append(float(jnp.mean(un.field_energy[-100:])))
        print(case, "uncontrolled", [round(t, 1) for t in tails_un],
              "mean", round(float(np.mean(tails_un)), 1), flush=True)

        for label, kw in variants:
            mpc = MPCConfig(**{**base, **kw})
            tails = []
            for s in range(n_seeds):
                st = init_state(cfg, jax.random.PRNGKey(100 + s))
                out = mpc_rollout(st, grid, cfg, ctrl, mpc, act, jax.random.PRNGKey(s))
                tails.append(float(jnp.mean(out.field_energy[-100:])))
            print(case, label, [round(t, 2) for t in tails],
                  "mean", round(float(np.mean(tails)), 2),
                  "median", round(float(np.median(tails)), 2), flush=True)
