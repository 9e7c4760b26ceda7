"""Mechanism probe for the rot-drift gate: is there a SYSTEMATIC in-solve
cost difference between the trig and rot drift variants of the spectral
horizon kernel at bench scale, or only unbiased fp noise?

Evolves a two-stream state to mid-instability (uncontrolled, the hard
regime for the gate), samples one solve's candidate set, evaluates the
(K, H) planning-model field energies with BOTH drift variants on identical
inputs, and reports: per-candidate cost agreement, Spearman rank agreement,
elite-set overlap, and whether the rot-minus-trig cost difference is biased
with respect to candidate energy (a signed correlation would indicate a
real model difference; a symmetric cloud indicates fp reassociation noise
and the closed-loop gate spread is seed chaos).

Usage: python experiments/rot_cost_probe.py [t_evolve]   (on the GPU)
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
    from plasma_control_tpu.control.mpc import knot_noise
    from plasma_control_tpu.models.pic import init_state
    from plasma_control_tpu.models.rollout import rollout
    from plasma_control_tpu.ops.grid import make_grid
    from plasma_control_tpu.ops.pallas.spectral_horizon import fused_spectral_horizon

    t_evolve = float(sys.argv[1]) if len(sys.argv) > 1 else 15.0
    cfg = SimConfig(simcase="two-stream", n_particles=5000, n_mesh=250,
                    dt=0.1, t_max=50.0, length=50.0)
    ctrl = ControlConfig(max_mode=4)
    mpc = MPCConfig(n_candidates=384, horizon=6, w_terminal=4.0, plan_modes=8)
    grid = make_grid(cfg.n_mesh, cfg.length)
    act = make_actuator(cfg.length, cfg.n_mesh, ctrl.max_mode)

    st = init_state(cfg, jax.random.PRNGKey(100))
    st = rollout(st, grid, cfg, n_steps=int(t_evolve / cfg.dt)).final_state

    ka = ctrl.max_mode
    km = max(mpc.plan_modes, ka)
    # representative candidate set: knot-interpolated antithetic noise around
    # a zero nominal (the same family _plan_impl samples)
    eps = knot_noise(jax.random.PRNGKey(7), mpc.n_candidates // 2, mpc.horizon,
                     ctrl.n_actions, mpc.n_knots)
    cand = mpc.sigma0 * jnp.concatenate([eps, -eps])

    def pad(u):
        return jnp.concatenate(
            [u, jnp.zeros(u.shape[:-1] + (km - ka,), u.dtype)], axis=-1)

    u_c, u_s = pad(cand[..., :ka]), pad(cand[..., ka:])

    pes = {}
    for name, use_rot in (("trig", False), ("rot", True)):
        pe = fused_spectral_horizon(
            st.x, st.v, u_c, u_s, length=cfg.length, dt=cfg.clamped_dt(),
            n0=cfg.n0, n_particles=cfg.n_particles, rot=use_rot)
        pes[name] = np.asarray(pe, np.float64)

    ie = np.asarray(act.input_energy(cand), np.float64)
    costs = {k: (mpc.w_field * v + mpc.w_input * ie).sum(-1)
             + mpc.w_terminal * v[:, -1] for k, v in pes.items()}

    ct, cr = costs["trig"], costs["rot"]
    d = cr - ct
    rel = np.abs(d) / np.maximum(np.abs(ct), 1e-12)
    rank_t, rank_r = np.argsort(np.argsort(ct)), np.argsort(np.argsort(cr))
    rho = np.corrcoef(rank_t, rank_r)[0, 1]
    n_el = 64
    el_t = set(np.argsort(ct)[:n_el].tolist())
    el_r = set(np.argsort(cr)[:n_el].tolist())
    # bias test: is the signed diff correlated with cost level?
    bias_corr = np.corrcoef(ct, d)[0, 1]
    t_stat = d.mean() / (d.std(ddof=1) / np.sqrt(len(d)))

    print(f"t_evolve={t_evolve}  mean PE level {pes['trig'].mean():.3f}")
    print(f"cost rel diff: max {rel.max():.2e}  median {np.median(rel):.2e}")
    print(f"signed diff mean {d.mean():+.3e} (t={t_stat:+.2f})  "
          f"bias corr(cost, diff) {bias_corr:+.3f}")
    print(f"rank (Spearman) {rho:.6f}   elite-{n_el} overlap "
          f"{len(el_t & el_r)}/{n_el}")
    print(f"argmin same: {int(np.argmin(ct)) == int(np.argmin(cr))} "
          f"(trig {int(np.argmin(ct))}, rot {int(np.argmin(cr))})")
