"""Closed-loop MPC at N=1,000,000 particles on ONE chip (round 4).

BASELINE config 5 (N=1M, 256 cells) existed only as a *push-throughput*
row (1.5e8 particle-push/s, SCALING config-5). This demo closes the same
gap config4_quality.py closed for config 4: can the framework *control* an
instability at a million particles, on one device?

Design (everything the round-4 config-4 study learned, applied at 10x N):

* plan model: FULL-fidelity gridless spectral (all 1M particles — the
  subsampled plan model plateaus on its phantom noise floor, config-4
  study). O(K*H*N*Km) with no mesh, no (N, M) weight tensors.
* K=256 knot-sampled candidates, H=6 + w_terminal=4, Km=16 (= 2x
  max_mode — the plan model must see the harmonics above the actuated
  band; the K=64/Km=8 first attempt is kept in the artifact as the
  negative result: Km == max_mode barely suppressed). XLA scan path (the
  planning kernel was not used at this N), chunked.
* env step: scatter deposition (cfg.deposit_method="scatter") — the dense
  (N, M) weight tensor at N=1M x M=256 would be 1 GB per materialization;
  the scatter path is the large-N tool (ops/deposit.py).

Writes artifacts/results_r4/million_particle_control.json.

Usage: python experiments/million_particle_control.py [n_seeds] [K] [Km] [H] [w_input]
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
    from plasma_control_tpu.diag.landau import damping_rate_decay_phase
    from plasma_control_tpu.io.resume import resumable_mpc_rollout
    from plasma_control_tpu.models.pic import init_state
    from plasma_control_tpu.models.rollout import rollout
    from plasma_control_tpu.ops.grid import make_grid

    n_seeds = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    k_cand = int(sys.argv[2]) if len(sys.argv) > 2 else 256
    km = int(sys.argv[3]) if len(sys.argv) > 3 else 16
    horizon = int(sys.argv[4]) if len(sys.argv) > 4 else 10
    w_input = float(sys.argv[5]) if len(sys.argv) > 5 else 0.5

    cfg = SimConfig(simcase="two-stream", n_particles=1_000_000, n_mesh=256,
                    dt=0.1, t_max=50.0, length=50.0,
                    deposit_method="scatter")
    ctrl = ControlConfig(max_mode=8)
    # plan_chunk=16 bounds the planner's live set to 16 x N planes (64 MB
    # each): the unchunked K=64 x 1M evaluation crashed the worker
    # (several 256 MB (K, N) planes live at once; control/mpc.py::
    # candidate_costs has the mechanism).
    # plan_modes MUST exceed max_mode: the first attempt (K=64, Km=8 ==
    # max_mode) barely suppressed (tail 46k vs 54k) — the plan model could
    # not see harmonically generated energy above the actuated modes, so
    # the planner misranked; Km=2x max_mode is the gate the reference-scale
    # ranking study set (control/mpc.py::_horizon_cost_spectral docstring).
    # w_input scales with N for cost-function scale invariance: PE carries
    # an explicit factor of N (ops/fields.py N/L rescale), so the relative
    # drive penalty at w=0.05 is 10x weaker at N=1e6 than at the config-4
    # winner's N=1e5 — w=0.5 restores the gated tradeoff.
    mpc = MPCConfig(horizon=horizon, w_terminal=4.0, n_candidates=k_cand,
                    plan_modes=km, plan_chunk=16, w_input=w_input)
    grid = jax.device_put(make_grid(cfg.n_mesh, cfg.length))
    act = make_actuator(cfg.length, cfg.n_mesh, ctrl.max_mode)
    ts = np.linspace(0, cfg.t_max, cfg.n_steps)

    outdir = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "artifacts", "results_r4")
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, "million_particle_control.json")
    results = {"uncontrolled": [], f"mpc_K{k_cand}_Km{km}_H{horizon}_w{w_input}_fullfid": []}
    if os.path.exists(path):
        results.update(json.load(open(path)).get("per_run", {}))

    def stats(pe, ie=None):
        pe = np.asarray(pe)
        d = {"tail_pe": round(float(pe[-len(pe) // 5:].mean()), 2),
             "peak_pe": round(float(pe.max()), 2),
             "gamma_decay_phase": round(
                 damping_rate_decay_phase(ts[: len(pe)], pe), 5)}
        if ie is not None:
            d["input_energy_mean"] = round(float(np.asarray(ie).mean()), 4)
        return d

    def checkpoint():
        with open(path, "w") as f:
            json.dump({"per_run": results}, f, indent=1)

    for s in range(n_seeds):
        st = init_state(cfg, jax.random.PRNGKey(cfg.seed + s))
        if not any(r["seed"] == s for r in results["uncontrolled"]):
            t0 = time.perf_counter()
            un = rollout(st, grid, cfg)
            row = {**stats(un.field_energy[1:]), "seed": s,
                   "wall_s": round(time.perf_counter() - t0, 1)}
            results["uncontrolled"].append(row)
            checkpoint()
            print(f"seed {s} uncontrolled: {row}", flush=True)
        key = f"mpc_K{k_cand}_Km{km}_H{horizon}_w{w_input}_fullfid"
        if not any(r["seed"] == s for r in results[key]):
            t0 = time.perf_counter()
            # segmented rollout (io/resume.py): a single 500-step x N=1M
            # compiled launch runs ~5 min on-device and gets the worker
            # killed (uncontrolled survives at
            # ~150 s; the MPC program does not) — 50-step segments keep
            # each launch ~30 s AND make the run preemption-proof, which
            # is how a production control run of this size should ship.
            _, traces = resumable_mpc_rollout(
                st, grid, cfg, ctrl, mpc, act,
                jax.random.PRNGKey(cfg.seed + 100 + s),
                ckpt_path=f"/tmp/m1_ck_{key}_seed{s}", segment_steps=50)
            row = {**stats(traces["field_energy"], traces["input_energy"]),
                   "seed": s,
                   "wall_s": round(time.perf_counter() - t0, 1)}
            results[key].append(row)
            checkpoint()
            print(f"seed {s} {key}: {row}", flush=True)

    summary = {name: {
        "tail_pe_mean": round(float(np.mean([r["tail_pe"] for r in rows])), 2),
        "tail_pe_per_seed": [r["tail_pe"] for r in sorted(rows, key=lambda r: r["seed"])],
    } for name, rows in results.items() if rows}
    with open(path, "w") as f:
        json.dump({"meta": {
            "config": "two-stream N=1,000,000 M=256 max_mode=8 dt=0.1 "
                      "t_max=50 (BASELINE config-5 scale, ONE chip); planner "
                      "variants K/Km/H/w_input in the key, w_terminal=4, "
                      "FULL-fidelity spectral (all 1M particles), "
                      "plan_chunk=16, 50-step segmented rollouts; env step "
                      "scatter deposition",
            "findings": "suppression is MONOTONE in planner strength — "
                      "K64/Km8(=max_mode): 1.04x (Km must exceed max_mode, "
                      "the plan model was blind to the harmonics); "
                      "K256/Km16/H6: 2.3x; K384/Km16/H10: 4.1x; + "
                      "scale-invariant w_input=0.5 (PE carries a factor N, "
                      "so w must scale with N to keep the gated tradeoff): "
                      "4.8x 2-seed mean (6.6x/3.7x), the strongest planner "
                      "that fits one chip. Unlike config-4 (N=100k, 167x), "
                      "the controller does not prevent saturation (peaks "
                      "~34k vs 68k): the cleaner (lower-noise) N=1M wave "
                      "traps before a bounded 8-mode drive can kill it, and "
                      "K>=512/H>10 full-fidelity planners exceed one chip's "
                      "memory/launch budget — the flagged first multi-chip "
                      "workload (shard K over the rollout axis).",
            "n_seeds": n_seeds, "device": str(jax.devices()[0]),
        }, "summary": summary, "per_run": results}, f, indent=1)
    print("wrote", path)
    print(json.dumps(summary))
