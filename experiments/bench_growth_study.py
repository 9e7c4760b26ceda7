"""Bench-scale quality gate for the growth-terminal horizon reduction.

The headline solve rate is ~linear in the planning horizon (the solve is
K x H spectral rollout steps), so H=8 -> 6 is ~1.33x and -> 5 is ~1.6x
solves/s — IF the closed-loop suppression stays within noise of the H=8
default on BOTH bench sim cases at full planning fidelity. Per the policy
in experiments/bench_fidelity_study.py, bench.py's MPC defaults may only
move on the evidence of this seed-paired study at the BASELINE config-3
shapes (N=5000, M=250, max_mode=4, K=512, full-fidelity spectral Km=8).

Variants: the current bench default (H8.Km8), H6 + growth tail
(terminal_steps=4: rank like H~10), H5 + growth tail (terminal_steps=5),
and H6 + const w_terminal=4 as the estimator ablation.

Run: python experiments/bench_growth_study.py [n_seeds]

Result (3 paired seeds, 2026-08-20; tail PE = mean over the last
100 steps, IE = mean input energy):

    bump-on-tail uncontrolled            mean 23.8
    bump-on-tail H8.Km8 (bench default)  mean 13.2  IE 10.1
    bump-on-tail H6.g4.Km8               mean 19.5  IE 15.6
    bump-on-tail H5.g5.Km8               mean 14.9  IE 14.8
    bump-on-tail H6.w4.Km8 (const)       mean 13.4  IE 12.8   <- = H8
    two-stream   uncontrolled            mean 1063.0
    two-stream   H8.Km8 (bench default)  mean 26.2  IE 37.4
    two-stream   H6.g4.Km8               mean 36.5  IE 39.9
    two-stream   H5.g5.Km8               mean 42.4  IE 42.2
    two-stream   H6.w4.Km8 (const)       mean 25.8  IE 40.4   <- = H8

Follow-up probe — const estimator at H5/H4 (same harness/seeds, 2026-08-20):

    bump-on-tail H5.w5.Km8               mean 10.8  IE 11.8   <- beats H8!
    bump-on-tail H4.w6.Km8               mean  9.3  IE  9.4   <- beats H8!
    two-stream   H5.w5.Km8               mean 36.0  IE 45.7   <- FAILS (37%)
    two-stream   H4.w6.Km8               mean 44.7  IE 48.7   <- FAILS (71%)

On the quiet bump-on-tail, shorter horizons with a strong flat tail weight
are MORE conservative (drive only when clearly profitable) and win; but the
growing two-stream needs the horizon to see the instability develop, and
H<=5 loses reliably there.

Verdict: at bench scale the CONST estimator wins — H6.w4 is seed-paired
equal to the H8 default on BOTH cases (13.4/25.8 vs 13.2/26.2) and moves
the headline ~8/6 = 1.33x. The growth estimator, which dominated at the
small config (K=64, max_mode=3, Km=16), FAILS here (two-stream 36-42 vs
26): with K=512 near-duplicate elite candidates and only Km=8 modes the
end-of-horizon PE ratio is dominated by oscillatory/model noise, and the
geometric tail (up to ~3x spread between the clip bounds) injects more
cost variance between near-equal candidates than the information it adds.
terminal_mode="growth" stays the right tool for small-K, well-resolved
planning (growth_terminal_study.py); the bench default moves to H6 + the
flat weight.
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

    n_seeds = int(sys.argv[1]) if len(sys.argv) > 1 else 3

    ctrl = ControlConfig(max_mode=4)
    variants = [
        ("H8.Km8 (bench default)", dict(horizon=8, plan_modes=8)),
        ("H6.g4.Km8", dict(horizon=6, plan_modes=8,
                           terminal_mode="growth", terminal_steps=4)),
        ("H5.g5.Km8", dict(horizon=5, plan_modes=8,
                           terminal_mode="growth", terminal_steps=5)),
        ("H6.w4.Km8 (const ablation)", dict(horizon=6, plan_modes=8, w_terminal=4.0)),
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
            mpc = MPCConfig(n_candidates=512, **kw)
            tails, ies = [], []
            for s in range(n_seeds):
                st = init_state(cfg, jax.random.PRNGKey(100 + s))
                out = mpc_rollout(st, grid, cfg, ctrl, mpc, act, jax.random.PRNGKey(s))
                tails.append(float(jnp.mean(out.field_energy[-100:])))
                ies.append(float(jnp.mean(out.input_energy)))
            print(case, label, [round(t, 1) for t in tails],
                  "mean", round(float(np.mean(tails)), 1),
                  "IE", round(float(np.mean(ies)), 2), flush=True)
