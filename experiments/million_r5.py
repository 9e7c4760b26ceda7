"""Real suppression at N=1,000,000 on one chip (VERDICT r4 #2, #8).

Round 4 proved closed-loop MPC *runs* at 1M (plan_chunk + segmented
rollouts) but the strongest planner fitting one chip only reached 4.8x
(2 seeds): full-fidelity planning at 1M costs ~330 s per 500-step rollout,
so neither K nor seeds could scale. The round-5 twin correction changes the
economics — subsampled planning at n=10,000 (stride 100) with the
noise-floor-corrected cost is ~100x cheaper per solve than full fidelity,
safe in the quiet regime by construction, AND the n=10,000 plan state rides
the fused Pallas kernel (N_pad=10112, the hardware-verified tall shape).
That buys K=1024 candidates, engagement from t=0 (the r4 meta: the wave
traps before a late drive can kill it — with cheap planning the controller
is always on), and >=4 seeds.

All rows run the r5 scale-free cost default (cost_pe_nref=5000, w_input at
its 0.05 default — VERDICT #3's "no hand-tuned w at 1M" gate; the r4 rows
hand-scaled w_input=0.5 against the raw cost).

Writes artifacts/results_r5/million_r5.json (incremental, resumable).

Usage: python experiments/million_r5.py [n_seeds] [variant,variant,...]
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
    from plasma_control_tpu.diag.landau import damping_rate_decay_phase
    from plasma_control_tpu.io.resume import resumable_mpc_rollout
    from plasma_control_tpu.models.pic import init_state
    from plasma_control_tpu.models.rollout import rollout
    from plasma_control_tpu.ops.grid import make_grid

    n_seeds = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    wanted = sys.argv[2].split(",") if len(sys.argv) > 2 else None

    cfg = SimConfig(simcase="two-stream", n_particles=1_000_000, n_mesh=256,
                    dt=0.1, t_max=50.0, length=50.0,
                    deposit_method="scatter")
    ctrl = ControlConfig(max_mode=8)
    grid = jax.device_put(make_grid(cfg.n_mesh, cfg.length))
    act = make_actuator(cfg.length, cfg.n_mesh, ctrl.max_mode)
    ts = np.linspace(0, cfg.t_max, cfg.n_steps)

    # corrected-subsampled planners: n=10,000 of 1M (stride 100) on the fused
    # kernel; plan_chunk unnecessary (the plan state is 10k, not 1M).
    # fidelity_guard=False reproduces the committed rows exactly under the
    # final r5 semantics (they first ran when "twin" bypassed the guard
    # unconditionally; see config4_frontier.py for the rationale).
    corr = dict(horizon=10, plan_modes=16, plan_particles=10000,
                plan_correction="twin", fidelity_guard=False)
    # full-fidelity planners: plan_chunk bounds the live K x 1M planes; the
    # r4 "K>=512 exceeds one chip" blocker was launch size/time (config-4
    # frontier, k1024_notes) — 50-step segments lift it. w_terminal=4.0
    # matches the r4 rows exactly (the first wt-less fullfid_K384 attempt is
    # kept in per_run as a wt0 data point).
    full = dict(horizon=10, plan_modes=16, plan_chunk=16, w_terminal=4.0)
    ctrl2 = ControlConfig(max_mode=8, coeff_min=-2.0, coeff_max=2.0)
    # variants: (MPCConfig, ControlConfig override or None, n_seeds_cap)
    variants = {
        # MEASURED (this artifact): detection-floor-limited at N/n=100 —
        # tails ~20-30k, 2.4x; the floor binds ABOVE full-fidelity quality,
        # so estimator improvements cannot reach 10x at this n
        "corr_sub10k_K1024": (MPCConfig(n_candidates=1024, **corr), None, 4),
        "corr_sub10k_K256": (MPCConfig(n_candidates=256, **corr), None, 4),
        # VERDICT #3 gate at 1M: full fidelity under the normalized default
        # (no hand-scaled w_input; r4's rows hand-tuned raw w=0.5)
        "fullfid_K384_wt4": (MPCConfig(n_candidates=384, **full), None, 4),
        # r4's hand-tuned raw w=0.5 == normalized 0.0025 at N=1M: does the
        # scale-free default under-drive here?
        "fullfid_K384_wt4_wraw05": (MPCConfig(n_candidates=384,
                                              w_input=0.0025, **full),
                                    None, 4),
        # the r4-flagged "strongest planner exceeds one chip" row, unblocked
        # — at the 1M-gated w (0.0025 ⇔ raw 0.5; the normalized default
        # measured 25-47k vs 7.5k at this w, rows above)
        "fullfid_K512_wt4_wraw05": (MPCConfig(n_candidates=512,
                                              w_input=0.0025, **full),
                                    None, 4),
        # AUTHORITY probe (mechanism, VERDICT #2): double the drive bound —
        # if suppression jumps, the ceiling was authority-limited; if flat,
        # the trapped (BGK) wave is dynamically robust to an 8-mode bounded
        # drive and the committed negative identifies trapping
        "fullfid_K384_wt4_wraw05_cm2": (MPCConfig(n_candidates=384,
                                                  w_input=0.0025, **full),
                                        ctrl2, 4),
        # third point on the authority curve: +-4 bounds — does suppression
        # keep scaling with authority or saturate?
        "fullfid_K384_wt4_wraw05_cm4": (MPCConfig(n_candidates=384,
                                                  w_input=0.0025, **full),
                                        ControlConfig(max_mode=8,
                                                      coeff_min=-4.0,
                                                      coeff_max=4.0), 4),
        # WAVENUMBER-authority probe: +-4 saturated at the +-2 level, so the
        # second limit is not drive AMPLITUDE — is it the actuated band?
        # 16 actuated modes at +-2 bounds (plan_modes=32 so the plan model
        # still sees harmonics above the actuated band — the r4 Km==max_mode
        # blindness lesson). If tails drop below the cm2 plateau, the limit
        # is spatial-structure authority (detrapping needs k's the 8-mode
        # drive lacks); if flat, it is the planner/horizon itself.
        # Km=32 doubles the per-solve work, so 50-step segments crossed the
        # attachment's launch-kill threshold (worker crash, 2026-08-21) —
        # 25-step segments keep each launch at the measured-safe length
        "fullfid_K384_wt4_wraw05_cm2_mm16": (
            MPCConfig(n_candidates=384, w_input=0.0025, horizon=10,
                      plan_modes=32, plan_chunk=16, w_terminal=4.0),
            ControlConfig(max_mode=16, coeff_min=-2.0, coeff_max=2.0), 4, 25),
    }
    if wanted:
        variants = {k: v for k, v in variants.items() if k in wanted}

    def stats(pe, ie=None):
        pe = np.asarray(pe)
        d = {"tail_pe": round(float(pe[-len(pe) // 5:].mean()), 2),
             "peak_pe": round(float(pe.max()), 2),
             "gamma_decay_phase": round(
                 damping_rate_decay_phase(ts[: len(pe)], pe), 5)}
        if ie is not None:
            d["input_energy_mean"] = round(float(np.asarray(ie).mean()), 4)
        return d

    outdir = os.path.join(REPO, "artifacts", "results_r5")
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, "million_r5.json")
    results = {}
    if os.path.exists(path):
        results = json.load(open(path)).get("per_run", {})

    def checkpoint():
        with open(path, "w") as f:
            json.dump({"per_run": results}, f, indent=1)

    results.setdefault("uncontrolled", [])
    for s in range(n_seeds):
        if any(r["seed"] == s for r in results["uncontrolled"]):
            continue
        st = init_state(cfg, jax.random.PRNGKey(cfg.seed + s))
        t0 = time.perf_counter()
        un = rollout(st, grid, cfg)
        row = {**stats(un.field_energy[1:]), "seed": s,
               "wall_s": round(time.perf_counter() - t0, 1)}
        results["uncontrolled"].append(row)
        checkpoint()
        print(f"seed {s} uncontrolled: {row}", flush=True)

    for name, spec in variants.items():
        mpc, ctrl_ov, seed_cap = spec[:3]
        seg_steps = spec[3] if len(spec) > 3 else 50
        rows = results.setdefault(name, [])
        for s in range(min(n_seeds, seed_cap)):
            if any(r["seed"] == s for r in rows):
                continue
            st = init_state(cfg, jax.random.PRNGKey(cfg.seed + s))
            t0 = time.perf_counter()
            # per-variant actuator: a ControlConfig override may change the
            # actuated mode count (mm16 probe) — the actuator must match it
            act_v = act if ctrl_ov is None or ctrl_ov.max_mode == ctrl.max_mode \
                else make_actuator(cfg.length, cfg.n_mesh, ctrl_ov.max_mode)
            # 50-step segments: each launch stays well under the attachment's
            # long-launch kill threshold AND the run is preemption-proof
            # (round-4 finding: one 500-step x 1M MPC launch kills the worker)
            _, traces = resumable_mpc_rollout(
                st, grid, cfg, ctrl_ov or ctrl, mpc, act_v,
                jax.random.PRNGKey(cfg.seed + 100 + s),
                ckpt_path=f"/tmp/m1r5_{name}_seed{s}", segment_steps=seg_steps)
            row = {**stats(traces["field_energy"], traces["input_energy"]),
                   "seed": s, "wall_s": round(time.perf_counter() - t0, 1)}
            rows.append(row)
            checkpoint()
            print(f"seed {s} {name}: {row}", flush=True)

    summary = {}
    for name, rows in results.items():
        if not rows:
            continue
        rows.sort(key=lambda r: r["seed"])
        summary[name] = {
            "tail_pe_mean": round(float(np.mean([r["tail_pe"] for r in rows])), 2),
            "n_seeds": len(rows),
            "tail_pe_per_seed": [r["tail_pe"] for r in rows],
            "peak_pe_per_seed": [r["peak_pe"] for r in rows],
            "wall_s_per_seed": [r.get("wall_s") for r in rows],
        }
        if "input_energy_mean" in rows[0]:
            summary[name]["input_energy_mean"] = round(
                float(np.mean([r["input_energy_mean"] for r in rows])), 3)
    un_mean = summary.get("uncontrolled", {}).get("tail_pe_mean")
    for name in variants:
        if name in summary and un_mean:
            summary[name]["suppression_x"] = round(
                un_mean / max(summary[name]["tail_pe_mean"], 1e-9), 2)

    with open(path, "w") as f:
        json.dump({"meta": {
            "config": "two-stream N=1,000,000 M=256 max_mode=8 dt=0.1 t_max=50 "
                      "(BASELINE config-5 scale, ONE chip); env step scatter "
                      "deposition, 50-step segmented rollouts; corr_* = "
                      "twin-corrected subsampled spectral (plan 10,000 of 1M, "
                      "fused Pallas kernel at N_pad=10112); fullfid_* = all "
                      "1M particles, plan_chunk=16; H=10/Km=16 throughout, "
                      "wt4 = w_terminal=4 (r4 parity)",
            "findings": "(1) ESTIMATOR: the twin-corrected n=10k subsample "
                      "is detection-floor-limited at N/n=100 — 2.4x, below "
                      "full fidelity, so estimator improvements cannot carry "
                      "this scale. (2) COST SCALE (VERDICT r4 #3 gate at 1M, "
                      "FAILS): the scale-free default w_input=0.05 "
                      "under-drives full-fidelity planning (tails 25-47k, "
                      "IE~60) while w_input=0.0025 (== r4's hand raw 0.5) "
                      "restores r4 quality (7.5-14.5k, IE~90): per-particle "
                      "PE normalization is exact at 5k and gate-equal at "
                      "100k but the OPTIMAL w still falls ~20x at 1M — the "
                      "drive's cost-benefit ratio is physics, not units; "
                      "documented, not hidden by a per-scale hand default. "
                      "(3) PLANNER STRENGTH saturated: K=512 == K=384 "
                      "(11.8k 2-seed vs 14.3k 4-seed, within the fat seed "
                      "spread) — the r4 'strongest planner exceeds one "
                      "chip' flag is closed by chunk+segments, and K was "
                      "not the binding axis. "
                      "(4) MECHANISM (VERDICT r4 #2): the first ceiling is "
                      "BOUNDED-DRIVE AUTHORITY, not trapping robustness — "
                      "doubling the coeff bound to +-2 (cm2 rows, 4 seeds, "
                      "paired) improves the tail 2.1x/3.6x/1.0x/4.9x per "
                      "seed (mean 6.3k = 8.5x suppression, median 12.4x, "
                      "3/4 seeds >=10x), with the drive riding its bound "
                      "in both cases (IE ~196 vs ~91; rms drive field ~2.8 "
                      "vs ~1.9 against a saturated wave field ~0.4). The "
                      "AMPLITUDE curve then SATURATES: +-4 (cm4 rows, IE "
                      "~270) is paired-equal to +-2 (7.1k vs 6.3k) — and "
                      "the second constraint is WAVENUMBER authority: 16 "
                      "actuated modes at +-2 (mm16 rows, plan_modes=32) "
                      "reach tail 3.6k = 14.8x mean / per-seed 8.7-35x "
                      "(>=10x on 3/4 seeds at the 4-seed standard) — "
                      "detrapping the cleaner 1M wave needs spatial "
                      "structure above the 8 actuated modes. Summary: the "
                      "reference-inherited +-1 8-mode actuator caps the "
                      "one-chip controller of record at ~3.8-5.0x here "
                      "(fullfid wraw05 / K512 rows); the residue is the "
                      "actuator spec — quantified along both its axes — "
                      "not the planner (K512==K384), the estimator, or "
                      "the chip.",
            "r4_reference": "results_r4/million_particle_control.json: "
                            "full-fidelity K384/Km16/H10 + hand-scaled "
                            "w_input=0.5 reached 4.8x at ~330 s/rollout "
                            "(2 seeds); uncontrolled tail ~48-54k",
            "row_notes": "fullfid_K384 (no wt suffix) is the superseded "
                         "1-seed w_terminal=0 probe kept for provenance — "
                         "the gate rows are the wt4 family; per-row seed "
                         "counts are in summary.n_seeds",
            "n_seeds": n_seeds, "device": str(jax.devices()[0]),
        }, "summary": summary, "per_run": results}, f, indent=1)
    print("wrote", path)
    print(json.dumps(summary))
