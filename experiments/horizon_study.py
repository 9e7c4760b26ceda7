"""Horizon study: suppression (tail field energy) vs planning horizon, with
and without the terminal tail cost (MPCConfig.w_terminal), plus the spectral
model-order (plan_modes) sensitivity — the quality gates for trading horizon
length (solve rate is ~linear in H) against control quality.

Rationale: the MPC running cost sums H steps of field energy; truncating H
under-penalizes candidates that look cheap now but leave energy behind. A
terminal weight w_terminal * PE_H is the simplest value-function tail
estimate (the tail of a state whose PE persists ~w_terminal more steps), so
H can shrink until the *first action* quality degrades — the only thing the
receding-horizon loop consumes.

Run: python experiments/horizon_study.py [n_seeds]

Result (8 seeds, two-stream N=1000/M=32, K=64, max_mode=3, t_max=15,
spectral planner, knots3+antithetic defaults; tail PE = mean PE over the
last 30 steps; run 2026-08-19; seeds are paired across variants):

    H10.w0      mean 26.6  median 23.7
    H8.w0       mean 25.1  median 23.6   (= H10 within noise, 20% less work)
    H6.w0       mean 31.3  median 28.3
    H6.w4       mean 28.6  median 30.5
    H5.w0       mean 46.1  median 40.9
    H5.w5       mean 28.7  median 28.6   <- terminal cost recovers most of it
    H4.w0       mean 61.9  median 63.3
    H4.w6       mean 55.3  median 48.6   <- but not below H~5
    H4.w6.Km8   mean 52.5  median 51.5
    H8.w0.Km8   mean 27.2  median 25.0   (= Km16 within noise at H=8)

Interpretation: without a tail cost quality degrades sharply below H=8
(H5 is 1.8x worse than H10); w_terminal ~ (10-H) recovers H=5-6 to within
~14% of H=10 but cannot rescue H=4 — at these scales the terminal PE is a
good tail statistic only once the horizon covers ~half a plasma period
(omega_p ~ 1, dt=0.1 => ~6 steps). H=8 and plan_modes=8 are each
quality-neutral; their rate gains at the bench shapes are measured in
experiments/bench_fidelity_study.py before touching bench defaults.
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
    from plasma_control_tpu.ops.grid import make_grid

    n_seeds = int(sys.argv[1]) if len(sys.argv) > 1 else 8

    cfg = SimConfig(n_particles=1000, n_mesh=32, dt=0.1, t_max=15.0, length=50.0)
    ctrl = ControlConfig(max_mode=3)
    grid = make_grid(cfg.n_mesh, cfg.length)
    act = make_actuator(cfg.length, cfg.n_mesh, ctrl.max_mode)

    variants = [
        ("H10.w0", dict(horizon=10)),
        ("H8.w0", dict(horizon=8)),
        ("H6.w0", dict(horizon=6)),
        ("H6.w4", dict(horizon=6, w_terminal=4.0)),
        ("H5.w0", dict(horizon=5)),
        ("H5.w5", dict(horizon=5, w_terminal=5.0)),
        ("H4.w0", dict(horizon=4)),
        ("H4.w6", dict(horizon=4, w_terminal=6.0)),
        ("H4.w6.Km8", dict(horizon=4, w_terminal=6.0, plan_modes=8)),
        ("H8.w0.Km8", dict(horizon=8, plan_modes=8)),
    ]
    for label, kw in variants:
        mpc = MPCConfig(n_candidates=64, **kw)
        tails = []
        for s in range(n_seeds):
            st = init_state(cfg, jax.random.PRNGKey(100 + s))
            out = mpc_rollout(st, grid, cfg, ctrl, mpc, act, jax.random.PRNGKey(s))
            tails.append(float(jnp.mean(out.field_energy[-30:])))
        print(
            label,
            [round(t, 1) for t in tails],
            "mean", round(float(np.mean(tails)), 1),
            "median", round(float(np.median(tails)), 1),
            flush=True,
        )
