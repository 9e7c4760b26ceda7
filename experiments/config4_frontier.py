"""Config-4 fidelity-quality FRONTIER (VERDICT r4 #1, #3, #4).

Round 4 left the two extremes committed: the subsampled rate-row planner
(plan 2048-of-100k, K=4096, ~197 solves/s) plateaus at tail PE ~9.3k on its
own phantom noise floor, while the quality-gated full-fidelity controller
(K=384, all 100k particles) suppresses 156x at ~21 solves/s. This study
closes the space between them with the round-5 mechanisms:

1. **Twin-corrected subsampled planning** (``MPCConfig.plan_correction=
   "twin"``): per-mode Wiener shrinkage from the full state + a zero-drive
   CRN twin remove the in-model profit of cancelling phantom subsample noise
   — the mechanism that capped the fast planner. Swept along an
   equal-planning-work fidelity axis (n_plan x K ~ 8.4M particle-candidates):
   (2048, 4096), (4096, 2048), (10000, 1024).
2. **Scale-free cost gate at N=100k** (``cost_pe_nref=5000``, the new
   default): the full-fidelity K=384 controller of record re-run under the
   normalized cost — no hand-scaled w_input, compare against the r4 raw-cost
   156x (`artifacts/results_r4/config4_quality.json`).
3. **K=1024 full-fidelity via plan_chunk** (VERDICT r4 #4): the r4 crash row
   re-attempted with chunked candidate evaluation (chunk=256 bounds the live
   plan state to 256 x 100k planes, the same mechanism that made N=1M run).

Each variant also gets a measured solve rate (the canonical two-length chain
slope, utils/timing.py::mpc_solve_rate) so the artifact carries the frontier
(rate, tail PE) points directly. Paired seeds throughout (same init seed =>
same trajectory realization across variants).

Writes artifacts/results_r5/config4_frontier.json (incremental, resumable).

Usage: python experiments/config4_frontier.py [n_seeds] [variant,variant,...]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

if __name__ == "__main__":
    REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    from plasma_control_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()

    import numpy as np

    from plasma_control_tpu.config import ControlConfig, MPCConfig, SimConfig
    from plasma_control_tpu.control.actuator import make_actuator
    from plasma_control_tpu.control.mpc import mpc_rollout
    from plasma_control_tpu.diag.landau import damping_rate_decay_phase
    from plasma_control_tpu.models.pic import init_state
    from plasma_control_tpu.models.rollout import rollout
    from plasma_control_tpu.ops.grid import make_grid
    from plasma_control_tpu.utils.timing import mpc_solve_rate

    n_seeds = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    wanted = sys.argv[2].split(",") if len(sys.argv) > 2 else None

    cfg = SimConfig(simcase="two-stream", n_particles=100_000, n_mesh=256,
                    dt=0.1, t_max=50.0, length=50.0)
    ctrl = ControlConfig(max_mode=8)
    grid = jax.device_put(make_grid(cfg.n_mesh, cfg.length))
    act = make_actuator(cfg.length, cfg.n_mesh, ctrl.max_mode)
    ts = np.linspace(0, cfg.t_max, cfg.n_steps)

    full = dict(horizon=10, plan_modes=16)
    # sub rows keep plan_mesh=64 to match the SCALING rate row exactly (the
    # spectral plan model never touches the mesh; only caches differ)
    sub = dict(horizon=10, plan_modes=16, plan_mesh=64)
    variants = {
        # scale-free cost gate: the r4 controller of record under the new
        # normalized-cost default (r4 ran raw cost; w_input stays 0.05)
        "fullfid_K384": MPCConfig(n_candidates=384, **full),
        # the r4 rate-row planner under the new cost default (ablation base)
        "sub2048_K4096_plain": MPCConfig(n_candidates=4096,
                                         plan_particles=2048, **sub),
        # the twin-corrected frontier sweep (equal planning work per solve).
        # fidelity_guard=False: these rows deliberately drive below the
        # guard's detectability threshold (that is the point of the deep-
        # suppression frontier) — an informed opt-out with the correction
        # active. The rows first ran under the early-r5 semantics where
        # "twin" bypassed the guard unconditionally; guard=False reproduces
        # them exactly under the final semantics (guard armed by default).
        "sub2048_K4096_corr": MPCConfig(n_candidates=4096, plan_particles=2048,
                                        plan_correction="twin",
                                        fidelity_guard=False, **sub),
        "sub4096_K2048_corr": MPCConfig(n_candidates=2048, plan_particles=4096,
                                        plan_correction="twin",
                                        fidelity_guard=False, **sub),
        "sub10000_K1024_corr": MPCConfig(n_candidates=1024,
                                         plan_particles=10000,
                                         plan_correction="twin",
                                         fidelity_guard=False, **sub),
        # the same best fast point under DEFAULT semantics (guard armed):
        # how much of the deep suppression does the guard threshold cost?
        "sub10000_K1024_corr_guarded": MPCConfig(n_candidates=1024,
                                                 plan_particles=10000,
                                                 plan_correction="twin",
                                                 **sub),
        # VERDICT #4: the r4 K=1024 full-fidelity crash row. MEASURED r5
        # (2026-08-21, this artifact's k1024_notes): with plan_chunk=256 the
        # live plan state (256 x 100k planes) is SMALLER than the working
        # unchunked K=384 row's, yet a single 500-step launch still crashed
        # the worker -> the crash is launch size/time, not K x N memory.
        # The distinguishing follow-up runs the same program in 50-step
        # segments (io/resume.py, the config-5 mechanism). LAST so a crash
        # cannot block the frontier rows.
        "fullfid_K1024_chunk256_seg50": MPCConfig(n_candidates=1024,
                                                  plan_chunk=256, **full),
    }
    SEGMENTED = {"fullfid_K1024_chunk256_seg50"}
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

    outdir = os.path.join(REPO, "artifacts", "results_r5")
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, "config4_frontier.json")
    results, rates = {}, {}
    if os.path.exists(path):  # merge/resume across sessions
        prev = json.load(open(path))
        results = prev.get("per_run", {})
        rates = prev.get("solve_rates", {})

    def checkpoint():  # incremental save: a worker crash loses nothing
        with open(path, "w") as f:
            json.dump({"per_run": results, "solve_rates": rates}, f, indent=1)

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
            if name in SEGMENTED:
                from plasma_control_tpu.io.resume import resumable_mpc_rollout

                _, traces = resumable_mpc_rollout(
                    st, grid, cfg, ctrl, mpc, act,
                    jax.random.PRNGKey(cfg.seed + 100 + s),
                    ckpt_path=f"/tmp/c4f_{name}_seed{s}", segment_steps=50)
                pe_t, ie_t = traces["field_energy"], traces["input_energy"]
            else:
                out = mpc_rollout(st, grid, cfg, ctrl, mpc, act,
                                  jax.random.PRNGKey(cfg.seed + 100 + s))
                pe_t, ie_t = out.field_energy, out.input_energy
            row = stats(pe_t, ie_t)
            row["seed"] = s
            rows.append(row)
            checkpoint()
            print(f"seed {s} {name}: {row}  ({time.perf_counter()-t0:.1f}s)",
                  flush=True)
        if name not in rates:
            # solve rate at a mid-run state (t=15: instability developed) —
            # the twin/corrected paths pay their per-solve overhead here too
            try:
                st = init_state(cfg, jax.random.PRNGKey(cfg.seed))
                st = rollout(st, grid, cfg, n_steps=150).final_state
                r = mpc_solve_rate(st, grid, cfg, ctrl, mpc, act)
                rates[name] = {"solves_per_s": round(r["solves_per_s"], 1)}
            except Exception as e:  # rate row must not lose quality rows
                rates[name] = {"error": f"{type(e).__name__}: {e}"[:200]}
            checkpoint()
            print(f"rate {name}: {rates[name]}", flush=True)

    summary = {}
    for name, rows in results.items():
        rows.sort(key=lambda r: r["seed"])
        tails = [r["tail_pe"] for r in rows]
        summary[name] = {
            "tail_pe_mean": round(float(np.mean(tails)), 2),
            "tail_pe_per_seed": tails,
        }
        if rows and "input_energy_mean" in rows[0]:
            summary[name]["input_energy_mean"] = round(
                float(np.mean([r["input_energy_mean"] for r in rows])), 3)
        if name in rates:
            summary[name].update(rates[name])

    # Frontier analysis: along the corrected-subsample axis, fit the
    # tail-PE-vs-plan-fidelity power law (detection-floor scaling)
    frontier = {}
    pts = []
    for name, s in summary.items():
        n_eff = None
        if name.startswith("sub"):
            req = int(name.split("_")[0][3:])
            stride = max(1, cfg.n_particles // req)
            n_eff = -(-cfg.n_particles // stride)
        elif name.startswith("fullfid"):
            n_eff = cfg.n_particles
        if (n_eff and "_corr" in name and not name.endswith("_guarded")
                or name == "fullfid_K384"):
            pts.append((n_eff, s["tail_pe_mean"], s.get("solves_per_s")))
    pts.sort()
    if len(pts) >= 3:
        ln_n = np.log([p[0] for p in pts])
        ln_t = np.log([p[1] for p in pts])
        slope = float(np.polyfit(ln_n, ln_t, 1)[0])
        frontier = {
            "points_n_tail_rate": pts,
            "tail_vs_nplan_power": round(slope, 3),
            "reading": "corrected-subsample tail PE scales ~ n_plan^"
                       f"{round(slope, 2)}: with phantom-cancellation profit "
                       "removed by the twin correction, the residual limit is "
                       "the subsample's DETECTION floor — coherent modal "
                       "energy below the n-particle shot noise is invisible "
                       "to the planner, corrected or not. Extrapolating, "
                       "tail<=250 needs n_plan ~ 40k. The "
                       "corrected n=10k/K=1024 controller (21x "
                       "suppression, 9x better than the r4 subsampled row's "
                       "quality) is the new fast point; full fidelity "
                       "remains the quality-gated controller of record. "
                       "GUARD SEMANTICS: the corr frontier rows set "
                       "fidelity_guard=False (informed deep-suppression "
                       "opt-out; see corrected_reference_scale.json for "
                       "why the guard stays armed by default) — under the "
                       "default guard the same fast controller lands tail "
                       "~2196 = 8.3x "
                       "(sub10000_K1024_corr_guarded row): the guard "
                       "threshold trades the last 2.6x of tail for "
                       "phase-detectability safety.",
        }

    payload = {
        "frontier": frontier,
        "meta": {
            "config": "BASELINE config 4: two-stream N=100000 M=256 max_mode=8 "
                      "dt=0.1 t_max=50; all rows under the r5 scale-free cost "
                      "default cost_pe_nref=5000 (w_input=0.05 everywhere, no "
                      "hand scaling); corr rows use plan_correction='twin'; "
                      "paired seeds (same init realization across variants); "
                      "solve rates are two-length chain slopes at a t=15 state",
            "n_seeds": n_seeds,
            "device": str(jax.devices()[0]),
            "r4_reference": "results_r4/config4_quality.json: fullfid_K384 raw "
                            "cost 116.4, sub2048_K4096 raw 9324, uncontrolled "
                            "18160 (8 seeds, same seed scheme)",
            "k1024_notes": "fullfid K=1024 with plan_chunk=256 in ONE "
                           "500-step launch crashed the worker "
                           "(2026-08-21, seed 0 — same failure as r4's "
                           "unchunked attempt) even though chunk=256 holds "
                           "LESS live plan state than the working unchunked "
                           "K=384 row: the crash is launch size/time, not "
                           "K x N memory (closing VERDICT r4 #4's "
                           "speculation). The *_seg50 row runs the identical "
                           "program in 50-step segments",
        },
        "summary": summary,
        "solve_rates": rates,
        "per_run": results,
    }
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)
    print("wrote", path)
    print(json.dumps({"summary": summary}))
