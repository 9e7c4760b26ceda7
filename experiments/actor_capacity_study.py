"""Actor-capacity study for the learned two-stream controller (VERDICT r3 #5).

The committed spectral DAgger actor trails the MPC planner 1.7x on
two-stream tail PE (90.3 vs 52.4, 8 seeds, artifacts/results_r3/
matrix.json), and DEVNOTES has named "a bigger actor (attention over
particles)" as the untried lever for three rounds. This study either closes
the gap or proves the plateau, at the reference default workload the
matrix/gates use (two-stream N=5000/M=250/t_max=50/max_mode=3 —
`/root/reference/run_ddpg.py:27-61`):

Variants (all DAgger-distilled from the same bench-gated MPC planner
expert, 6 iterations x 400 epochs, best-iteration selection):

* ``spectral``      — the committed r3 config (SpectralActor, mlp_dim=64).
* ``spectral-wide`` — same architecture, 4x trunk (mlp_dim=256): is FLAT
  capacity the binding constraint?
* ``attention``     — SpectralAttentionActor (mode-token transformer,
  d=64/4h/2L, per-mode output heads): is mode-coupling STRUCTURE the
  constraint?
* ``attention-big`` — d=128/4h/3L: capacity scaling of the structured actor.

Each trained actor is evaluated closed-loop on ``n_eval`` held-out seeds
(policy_rollout, deterministic); the planner and uncontrolled references
come from artifacts/results_r4/matrix.json (same eval protocol).

Writes artifacts/results_r4/actor_capacity.json; the winner (if any) is
retrained/committed by run_dagger.py --encoder <winner>.

Usage: python experiments/actor_capacity_study.py [n_eval] [variant ...]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

if __name__ == "__main__":
    from plasma_control_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()

    import numpy as np

    from plasma_control_tpu.config import ControlConfig, MPCConfig, SimConfig
    from plasma_control_tpu.control.actuator import make_actuator
    from plasma_control_tpu.control.evaluate import policy_rollout
    from plasma_control_tpu.control.rl.dagger import dagger_train
    from plasma_control_tpu.control.rl.ddpg import DDPGConfig
    from plasma_control_tpu.io.checkpoint import save_params
    from plasma_control_tpu.models.pic import init_state
    from plasma_control_tpu.ops.grid import make_grid

    n_eval = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    wanted = sys.argv[2:] or None

    cfg = SimConfig(simcase="two-stream", n_particles=5000, n_mesh=250,
                    dt=0.1, t_max=50.0, length=50.0)
    ctrl = ControlConfig(max_mode=3)
    # the bench-gated planner config = the expert run_dagger distills
    # (same as experiments/results_matrix.py)
    mpc = MPCConfig(horizon=6, w_terminal=4.0, n_candidates=512, plan_modes=8)
    grid = jax.device_put(make_grid(cfg.n_mesh, cfg.length))
    act = make_actuator(cfg.length, cfg.n_mesh, ctrl.max_mode)

    base = dict(output_min=ctrl.coeff_min, output_max=ctrl.coeff_max)
    variants = {
        "spectral": DDPGConfig(encoder="spectral", mlp_dim=64, **base),
        "spectral-wide": DDPGConfig(encoder="spectral", mlp_dim=256, **base),
        "attention": DDPGConfig(encoder="attention", mlp_dim=64,
                                attn_dim=64, attn_heads=4, attn_layers=2, **base),
        "attention-big": DDPGConfig(encoder="attention", mlp_dim=128,
                                    attn_dim=128, attn_heads=4, attn_layers=3, **base),
    }
    if wanted:
        variants = {k: v for k, v in variants.items() if k in wanted}

    outdir = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "artifacts", "results_r4")
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, "actor_capacity.json")
    results = {}
    if os.path.exists(path):  # resumable across interrupted sessions
        results = json.load(open(path)).get("results", {})

    for name, hp in variants.items():
        if name in results:
            print(f"skip {name} (already in {path})", flush=True)
            continue
        t0 = time.perf_counter()
        nets, params, hist = dagger_train(
            cfg, ctrl, hp, grid, act, jax.random.PRNGKey(cfg.seed + 7),
            n_iters=6, epochs_per_iter=400, mpc=mpc, verbose=True,
        )
        train_s = time.perf_counter() - t0
        action_fn = lambda s: nets.actor.sample(params, s[None])[0]
        tails = []
        for s in range(n_eval):
            st = init_state(cfg, jax.random.PRNGKey(cfg.seed + s))
            pe = np.asarray(policy_rollout(
                st, grid, cfg, act, action_fn, record_snapshots=False
            ).field_energy)
            tails.append(round(float(pe[-len(pe) // 5:].mean()), 2))
        results[name] = {
            "eval_tail_pe_per_seed": tails,
            "eval_tail_pe_mean": round(float(np.mean(tails)), 2),
            "train_bc_loss": [round(v, 4) for v in hist["bc_loss"]],
            "train_pe_tail_per_iter": [round(v, 1) for v in hist["pe_tail"]],
            "train_s": round(train_s, 1),
            "n_params": int(sum(x.size for x in jax.tree.leaves(params))),
        }
        save_params(os.path.join(outdir, f"actor_{name}.msgpack"), params)
        print(f"{name}: eval tails {tails} mean "
              f"{results[name]['eval_tail_pe_mean']} "
              f"({results[name]['n_params']} params, {train_s:.0f}s)", flush=True)
        with open(path, "w") as f:
            json.dump({"meta": {
                "config": "two-stream N=5000 M=250 t_max=50 max_mode=3; "
                          "expert = bench-gated MPC H6.w4.K512.Km8; DAgger "
                          "6x400, best-iteration; eval deterministic "
                          "policy_rollout",
                "n_eval": n_eval, "device": str(jax.devices()[0]),
            }, "results": results}, f, indent=1)
    print("wrote", path)
