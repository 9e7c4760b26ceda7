"""Growth-extrapolated terminal tail cost vs the constant weight: can the
per-candidate geometric extrapolation (MPCConfig.terminal_mode="growth")
rescue horizons the flat w_terminal cannot (H < 6)?

The flat weight charges every candidate w * PE_H regardless of where its
trajectory was heading; the growth estimator charges the extrapolated
running cost of T more steps at the candidate's own measured end-of-horizon
growth ratio r = PE_H / PE_{H-1} — a candidate that leaves the field low
but GROWING pays up to sum_{i<=T} 1.3^i ~ 2x per tail step, one that leaves
it damped pays almost nothing. Solve rate is ~linear in H, so every rescued
horizon step is ~12-20% more solves/s at the bench shapes.

Run: python experiments/growth_terminal_study.py [n_seeds]

Config matches experiments/horizon_study.py (two-stream N=1000/M=32, K=64,
max_mode=3, t_max=15, spectral planner Km=16, knots3+antithetic defaults;
tail PE = mean over the last 30 steps; seeds paired across variants).
Reference points from that study (8 seeds, 2026-08-19):
H10.w0 26.6 / H8.w0 25.1 / H6.w4 28.6 / H5.w5 28.7 / H4.w6 55.3.

Result (8 paired seeds, 2026-08-20, same seeds as horizon_study):

    H8.w0        mean 23.5  median 19.6   (baseline; horizon_study got 25.1)
    H6.g4        mean 24.9  median 24.0   (= H8 within noise)
    H5.g5        mean 24.2  median 23.0   <- FULL recovery; const H5.w5 was 28.7
    H5.g8        mean 34.7  median 35.1   <- over-extrapolation amplifies ratio noise
    H4.g6        mean 30.7  median 27.8   <- const H4.w6 was 55.3: 1.8x better,
    H4.g6.Km8    mean 30.5  median 25.6      but still ~30% above H8
    H4.g10       mean 32.2  median 32.5
    H3.g7        mean 206.5 median 179.5  <- collapses (tail >> horizon)

Interpretation: the per-candidate ratio fully recovers H=5 where the flat
weight plateaued (the flat weight cannot tell a growing ending from a damped
one at equal PE_H), and buys back most of H=4. Two regimes bound it:
(a) the tail length must not greatly exceed the horizon that measured the
ratio (H5.g8, H3.g7 — extrapolation noise compounds geometrically), and
(b) the horizon must still cover enough of a plasma oscillation for
PE_H/PE_{H-1} to read the secular trend (H<=4). terminal_steps ~ horizon is
the sweet spot. Bench-default consequences are gated at bench scale by
experiments/bench_growth_study.py.
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

    g = dict(terminal_mode="growth")
    variants = [
        ("H8.w0", dict(horizon=8)),
        ("H6.g4", dict(horizon=6, terminal_steps=4, **g)),
        ("H5.g5", dict(horizon=5, terminal_steps=5, **g)),
        ("H5.g8", dict(horizon=5, terminal_steps=8, **g)),
        ("H4.g6", dict(horizon=4, terminal_steps=6, **g)),
        ("H4.g6.Km8", dict(horizon=4, terminal_steps=6, plan_modes=8, **g)),
        ("H4.g10", dict(horizon=4, terminal_steps=10, **g)),
        ("H3.g7", dict(horizon=3, terminal_steps=7, **g)),
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
