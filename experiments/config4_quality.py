"""Closed-loop control QUALITY at BASELINE config-4 scale (VERDICT r3 #1).

Every suppression artifact through round 3 was at reference scale (N<=10k);
config 4 — two-stream, N=100k particles, 256 cells, 8 control modes, K=4096
candidate rollouts (`BASELINE.md:33`; the reference's largest analogue is
N=10k, `/root/reference/run_sac.py:33-35,57`) — existed only as a
throughput row. This study provides the missing evidence:

1. **Suppression at scale**: paired closed-loop rollouts (same init seed)
   uncontrolled vs MPC at the config-4 planner shape, >=3 seeds — tail PE,
   decay-phase damping rate, input energy.
2. **K-quality gate at the config-4 shape**: does K=4096 earn its ~10x cost
   over K=384 at N=100k/8 modes? (The K gates through round 3 were all run
   at N=5000/4 modes; K=384 was gated there, not here.) Paired seeds across
   K in {384, 1024, 4096}.

The planner config matches the SCALING config-4 rate row exactly
(bench_scaling.py::config4): H=10,
plan_particles=2048, plan_mesh=64, spectral plan model at plan_modes=16.
Particle-subsampled planning is quality-safe on the growing two-stream
(coherent PE >> subsample noise floor — DEVNOTES multi-fidelity hazard;
the dynamic fidelity guard is active regardless).

Writes artifacts/results_r4/config4_quality.json; bench_scaling config4
attaches this artifact's summary to its rate row so the scaling artifact
of record carries quality evidence, not just solves/s.

Usage: python experiments/config4_quality.py [n_seeds] [K,K,...]
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

    import jax.numpy as jnp
    import numpy as np

    from plasma_control_tpu.config import ControlConfig, MPCConfig, SimConfig
    from plasma_control_tpu.control.actuator import make_actuator
    from plasma_control_tpu.control.mpc import mpc_rollout
    from plasma_control_tpu.diag.landau import damping_rate_decay_phase
    from plasma_control_tpu.models.pic import init_state
    from plasma_control_tpu.models.rollout import rollout
    from plasma_control_tpu.ops.grid import make_grid

    n_seeds = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    wanted = sys.argv[2].split(",") if len(sys.argv) > 2 else None

    cfg = SimConfig(simcase="two-stream", n_particles=100_000, n_mesh=256,
                    dt=0.1, t_max=50.0, length=50.0)
    ctrl = ControlConfig(max_mode=8)
    grid = jax.device_put(make_grid(cfg.n_mesh, cfg.length))
    act = make_actuator(cfg.length, cfg.n_mesh, ctrl.max_mode)
    ts = np.linspace(0, cfg.t_max, cfg.n_steps)

    # Variants. The *_sub2048 family is the SCALING rate row's planner
    # (subsampled plan model, 2048 of 100k); the *_fullfid family plans on
    # ALL 100k particles — affordable because the gridless spectral model is
    # O(K*H*N*Km) with no mesh (vs
    # 123 for K=4096 subsampled). Hypothesis for the fullfid family: the
    # subsample noise floor (the documented multi-fidelity hazard) caps how
    # far the controller can push PE down once it approaches the phantom
    # floor, so full fidelity should deepen late-stage suppression.
    sub = dict(horizon=10, plan_particles=2048, plan_mesh=64)
    full = dict(horizon=10, plan_modes=16)
    variants = {
        "mpc_K384": MPCConfig(n_candidates=384, **sub),
        "mpc_K1024": MPCConfig(n_candidates=1024, **sub),
        "mpc_K4096": MPCConfig(n_candidates=4096, **sub),
        "mpc_K192_fullfid": MPCConfig(n_candidates=192, **full),
        "mpc_K384_fullfid": MPCConfig(n_candidates=384, **full),
        "mpc_K512_fullfid": MPCConfig(n_candidates=512, **full),
        "mpc_K1024_fullfid": MPCConfig(n_candidates=1024, **full),
    }
    if wanted:
        variants = {k: v for k, v in variants.items() if k in wanted}

    def stats(pe, ie=None):
        pe = np.asarray(pe)
        d = {
            "tail_pe": round(float(pe[-len(pe) // 5:].mean()), 2),
            "peak_pe": round(float(pe.max()), 2),
            "gamma_decay_phase": round(damping_rate_decay_phase(ts[: len(pe)], pe), 5),
        }
        if ie is not None:
            d["input_energy_mean"] = round(float(np.asarray(ie).mean()), 4)
        return d

    outdir = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "artifacts", "results_r4")
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, "config4_quality.json")
    results = {}
    if os.path.exists(path):  # merge/resume across sessions
        results = json.load(open(path)).get("per_run", {})

    def checkpoint():  # incremental save: a worker crash loses nothing
        with open(path, "w") as f:
            json.dump({"per_run": results}, f, indent=1)

    if "uncontrolled" not in results:
        results["uncontrolled"] = []
    for s in range(n_seeds):
        if any(r["seed"] == s for r in results["uncontrolled"]):
            continue
        st = init_state(cfg, jax.random.PRNGKey(cfg.seed + s))
        t0 = time.perf_counter()
        un = rollout(st, grid, cfg)
        row = stats(un.field_energy[1:])
        row["seed"] = s
        results["uncontrolled"].append(row)
        checkpoint()
        print(f"seed {s} uncontrolled: {row}  ({time.perf_counter()-t0:.1f}s)",
              flush=True)

    for name, mpc in variants.items():
        rows = results.setdefault(name, [])
        for s in range(n_seeds):
            if any(r["seed"] == s for r in rows):
                continue
            st = init_state(cfg, jax.random.PRNGKey(cfg.seed + s))
            t0 = time.perf_counter()
            out = mpc_rollout(st, grid, cfg, ctrl, mpc, act,
                              jax.random.PRNGKey(cfg.seed + 100 + s))
            row = stats(out.field_energy, out.input_energy)
            row["seed"] = s
            rows.append(row)
            checkpoint()
            print(f"seed {s} {name}: {row}  ({time.perf_counter()-t0:.1f}s)",
                  flush=True)

    summary = {}
    for name, rows in results.items():
        rows.sort(key=lambda r: r["seed"])
        tails = [r["tail_pe"] for r in rows]
        summary[name] = {
            "tail_pe_mean": round(float(np.mean(tails)), 2),
            "tail_pe_per_seed": tails,
            "gamma_mean": round(float(np.mean([r["gamma_decay_phase"] for r in rows])), 5),
        }
        if rows and "input_energy_mean" in rows[0]:
            summary[name]["input_energy_mean"] = round(
                float(np.mean([r["input_energy_mean"] for r in rows])), 3)

    # K gate verdicts: paired per-seed tail-PE comparisons within each
    # fidelity family against that family's largest K
    gate = {}
    for fam, suffix in (("sub2048", ""), ("fullfid", "_fullfid")):
        fam_ks = sorted(int(n.split("_K")[1].split("_")[0]) for n in results
                        if n.startswith("mpc_K") and n.endswith(suffix)
                        and (suffix or "_fullfid" not in n))
        if len(fam_ks) < 2:
            continue
        kmax = fam_ks[-1]
        ref = {r["seed"]: r["tail_pe"] for r in results[f"mpc_K{kmax}{suffix}"]}
        for k in fam_ks[:-1]:
            d = [r["tail_pe"] - ref[r["seed"]]
                 for r in results[f"mpc_K{k}{suffix}"] if r["seed"] in ref]
            if not d:
                continue
            gate[f"{fam}:K{k}_minus_K{kmax}_tail_pe"] = {
                "per_seed": [round(v, 2) for v in d],
                "mean": round(float(np.mean(d)), 2),
                "mean_pct_of_Kmax": round(
                    100.0 * float(np.mean(d))
                    / max(summary[f"mpc_K{kmax}{suffix}"]["tail_pe_mean"], 1e-9), 1),
            }

    payload = {
        "meta": {
            "config": "BASELINE config 4: two-stream N=100000 M=256 max_mode=8 "
                      "dt=0.1 t_max=50. Planner families: sub2048 = H=10 "
                      "plan_particles=2048 plan_mesh=64 spectral Km=16 (the "
                      "SCALING rate row); fullfid = H=10 spectral Km=16 on all "
                      "100k particles (no subsample noise floor)",
            "k1024_fullfid_note": "K=1024 at full fidelity did not run "
                      "as one 500-step launch (2 fresh processes, "
                      "2026-08-21); the fullfid K gate "
                      "is therefore K192-vs-K384 (down) plus the sub2048 "
                      "family (up), both decided",
            "n_seeds": n_seeds,
            "device": str(jax.devices()[0]),
        },
        "summary": summary,
        "k_gate": gate,
        "per_run": results,
    }
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)
    print("wrote", path)
    print(json.dumps({"summary": summary, "k_gate": gate}))
