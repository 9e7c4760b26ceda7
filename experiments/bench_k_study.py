"""Seed-paired candidate-count (K) study at bench scale + the 8-seed re-gate
of the H8 -> H6.w4 horizon reduction (ADVICE r1 #3).

The solve cost is ~linear in K (the solve is K x H spectral rollout steps),
so K=512 -> 256 is ~2x headline solves/s IF the closed-loop suppression
stays seed-paired equal on BOTH bench cases at full planning fidelity
(policy: experiments/bench_fidelity_study.py). The sampler is structured
(knot + antithetic + feedback seeding + CEM elite refit), so the effective
candidate diversity at K=512 may be far above what the suppression needs.

ADVICE r1 #3: the H6.w4 == H8 equality that moved the bench default was
gated on only 3 paired seeds; this study re-runs that pair at 8 seeds
alongside the K sweep (all variants share seeds -> fully paired).

Run: python experiments/bench_k_study.py [n_seeds]

Result (8 paired seeds, 2026-08-20; tail PE = mean PE over the last
100 steps, mean over seeds; full per-seed lists in the run log / git log):

  bump-on-tail uncontrolled        mean 36.2
  bump-on-tail H8.K512 (old dflt)  mean 12.8  IE  9.95
  bump-on-tail H6.w4.K512 (dflt)   mean 13.2  IE 12.93  <- = H8 at 8 seeds
  bump-on-tail H6.w4.K256          mean 12.8  IE 12.56  <- = K512
  bump-on-tail H6.w4.K128          mean 12.8  IE 12.37  <- = K512
  two-stream   uncontrolled        mean 1117.2
  two-stream   H8.K512 (old dflt)  mean 31.0  IE 36.39  (median 23.9; one 74.7)
  two-stream   H6.w4.K512 (dflt)   mean 27.5  IE 39.31  <- = H8 at 8 seeds
  two-stream   H6.w4.K256          mean 33.8  IE 38.93  (median 23.1 = K512's
                                                         23.5, but one 80.1)
  two-stream   H6.w4.K128          mean 41.7  IE 41.70  <- DEGRADED (3 seeds
                                                           at 61-78)

Verdict (2026-08-20): ADVICE r1 #3 settled — H6.w4 == H8 at 8 paired seeds
on BOTH cases (13.2/27.5 vs 12.8/31.0; two-stream medians 23.5 vs 23.9).
K=128 fails the two-stream gate outright. K=256 is equal on bump-on-tail
and equal-in-median on two-stream but shows one fat-tail seed (80.1 — still
13x suppression of the 1027 uncontrolled, 3.3x above K512's 24.0 on that
seed); the 16-seed two-stream resolution study (same harness, K512/K384/
K256) decides whether the headline moves — see the follow-up block below.

Follow-up: 16-seed two-stream resolution (same paired harness/seeds,
2026-08-20):

  two-stream H6.w4.K512   mean 29.9  median 24.2  max 51.4
  two-stream H6.w4.K384   mean 29.4  median 23.8  max 66.2  <- = K512
  two-stream H6.w4.K256   mean 35.4  median 28.9  max 80.9  <- FAILS (+18%
                                                       mean, +19% median)

Final verdict (2026-08-20): the bench default moves K 512 -> 384 (1.33x
less planning work, seed-paired equal suppression on BOTH cases at 8/16
seeds). K<=256 remains valid for bump-on-tail-like quiet cases only (flat
there down to K=128) and is NOT the general default.
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
    from plasma_control_tpu.control.mpc import mpc_rollout
    from plasma_control_tpu.models.pic import init_state
    from plasma_control_tpu.models.rollout import rollout
    from plasma_control_tpu.ops.grid import make_grid

    n_seeds = int(sys.argv[1]) if len(sys.argv) > 1 else 8

    ctrl = ControlConfig(max_mode=4)
    variants = [
        ("H8.K512 (old default)", dict(horizon=8, plan_modes=8, n_candidates=512)),
        ("H6.w4.K512 (default)", dict(horizon=6, w_terminal=4.0, plan_modes=8,
                                      n_candidates=512)),
        ("H6.w4.K256", dict(horizon=6, w_terminal=4.0, plan_modes=8,
                            n_candidates=256)),
        ("H6.w4.K128", dict(horizon=6, w_terminal=4.0, plan_modes=8,
                            n_candidates=128)),
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
            mpc = MPCConfig(**kw)
            tails, ies = [], []
            for s in range(n_seeds):
                st = init_state(cfg, jax.random.PRNGKey(100 + s))
                out = mpc_rollout(st, grid, cfg, ctrl, mpc, act, jax.random.PRNGKey(s))
                tails.append(float(jnp.mean(out.field_energy[-100:])))
                ies.append(float(jnp.mean(out.input_energy)))
            print(case, label, [round(t, 1) for t in tails],
                  "mean", round(float(np.mean(tails)), 1),
                  "IE", round(float(np.mean(ies)), 2), flush=True)
