"""Twin-corrected subsampled planning at REFERENCE scale (round 5).

The multi-fidelity hazard was discovered at this scale (bump-on-tail
N=5000: an unguarded subsampled planner PUMPS tail PE to ~270-330 vs ~33
uncontrolled — DEVNOTES 2026-08-19), and since round 2 the shipped answer
has been "don't subsample quiet plasmas" (fidelity guard zeroes the drive).
The r5 twin correction claims to make subsampled planning *safe* rather
than merely disabled. This study commits the reference-scale evidence for
that claim on the two quiet cases, 8 paired seeds each:

* bump-on-tail (bench case, max_mode=4): uncorrected-unguarded (the
  historical hazard row), guarded (drive held off == uncontrolled),
  corrected (plan 1024 of 5000), and full fidelity.
* landau (N=2000, A=0.3 mode-2): corrected subsampled (plan 512 of 2000)
  vs full fidelity vs uncontrolled, PE thirds.

Expected shape of the result (detection-floor reasoning from the config-4
frontier): corrected-subsampled must NOT pump (that is the safety claim)
but plateaus above full fidelity wherever the coherent field sits below
the subsample's shot-noise detection floor.

Writes artifacts/results_r5/corrected_reference_scale.json.

Usage: python experiments/corrected_reference_scale.py [n_seeds]
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

    import dataclasses

    import numpy as np

    from plasma_control_tpu.config import ControlConfig, MPCConfig, SimConfig
    from plasma_control_tpu.control.actuator import make_actuator
    from plasma_control_tpu.control.mpc import mpc_rollout
    from plasma_control_tpu.models.pic import init_state
    from plasma_control_tpu.models.rollout import rollout
    from plasma_control_tpu.ops.grid import make_grid

    n_seeds = int(sys.argv[1]) if len(sys.argv) > 1 else 8

    outdir = os.path.join(REPO, "artifacts", "results_r5")
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, "corrected_reference_scale.json")
    results = {}
    if os.path.exists(path):
        results = json.load(open(path)).get("per_run", {})

    def checkpoint():
        with open(path, "w") as f:
            json.dump({"per_run": results}, f, indent=1)

    # the bench-gated planner shape (H=6 + w_terminal=4, Km=8) with the
    # fidelity axis varied; K=384 everywhere
    base = dict(horizon=6, w_terminal=4.0, n_candidates=384, plan_modes=8)
    cases = {
        "bump-on-tail": dict(
            cfg=SimConfig(simcase="bump-on-tail", n_particles=5000,
                          n_mesh=250, dt=0.1, t_max=50.0),
            ctrl=ControlConfig(max_mode=4),
            variants={
                "fullfid": MPCConfig(**base),
                "sub1024_corr": MPCConfig(plan_particles=1024,
                                          plan_correction="twin", **base),
                # the historical hazard row: subsampled, guard OFF, no
                # correction — must pump (the negative control)
                "sub1024_unguarded": MPCConfig(plan_particles=1024,
                                               fidelity_guard=False, **base),
                # the r2-r4 shipped answer: guard ON (drive held off)
                "sub1024_guarded": MPCConfig(plan_particles=1024, **base),
            },
        ),
        "landau": dict(
            cfg=SimConfig(simcase="landau", n_particles=2000, n_mesh=32,
                          dt=0.1, t_max=15.0, perturb_amplitude=0.3,
                          perturb_mode=2),
            ctrl=ControlConfig(max_mode=3),
            variants={
                "fullfid": MPCConfig(**base),
                "sub512_corr": MPCConfig(plan_particles=512,
                                         plan_correction="twin", **base),
            },
        ),
    }

    for case, spec in cases.items():
        cfg, ctrl = spec["cfg"], spec["ctrl"]
        grid = jax.device_put(make_grid(cfg.n_mesh, cfg.length))
        act = make_actuator(cfg.length, cfg.n_mesh, ctrl.max_mode)
        rows_c = results.setdefault(case, {})
        rows_c.setdefault("uncontrolled", [])
        for s in range(n_seeds):
            if any(r["seed"] == s for r in rows_c["uncontrolled"]):
                continue
            st = init_state(cfg, jax.random.PRNGKey(cfg.seed + s))
            pe = np.asarray(rollout(st, grid, cfg).field_energy[1:])
            rows_c["uncontrolled"].append(
                {"seed": s, "tail_pe": round(float(pe[-len(pe) // 5:].mean()), 2)})
            checkpoint()
        for name, mpc in spec["variants"].items():
            rows = rows_c.setdefault(name, [])
            for s in range(n_seeds):
                if any(r["seed"] == s for r in rows):
                    continue
                st = init_state(cfg, jax.random.PRNGKey(cfg.seed + s))
                t0 = time.perf_counter()
                out = mpc_rollout(st, grid, cfg, ctrl, mpc, act,
                                  jax.random.PRNGKey(cfg.seed + 100 + s))
                pe = np.asarray(out.field_energy)
                rows.append({
                    "seed": s,
                    "tail_pe": round(float(pe[-len(pe) // 5:].mean()), 2),
                    "input_energy_mean": round(float(np.asarray(
                        out.input_energy).mean()), 3),
                })
                checkpoint()
                print(f"{case} {name} seed {s}: tail "
                      f"{rows[-1]['tail_pe']} ({time.perf_counter()-t0:.1f}s)",
                      flush=True)

    summary = {}
    for case, rows_c in results.items():
        summary[case] = {}
        for name, rows in rows_c.items():
            tails = [r["tail_pe"] for r in sorted(rows, key=lambda r: r["seed"])]
            summary[case][name] = {
                "tail_pe_mean": round(float(np.mean(tails)), 2),
                "tail_pe_per_seed": tails,
            }
    with open(path, "w") as f:
        json.dump({"meta": {
            "purpose": "reference-scale evidence for the r5 twin correction "
                       "on the QUIET cases where uncorrected subsampled "
                       "planning pumps (the original multi-fidelity hazard, "
                       "DEVNOTES 2026-08-19).",
            "finding": "the correction is NOT sufficient on never-coherent "
                       "quiet plasmas: corrected-unguarded bump-on-tail "
                       "pumps to tail 131.7 (vs 36.7 uncontrolled, 186.2 "
                       "uncorrected-unguarded, 13.0 full fidelity) and "
                       "landau to ~153 — it removes the PHANTOM-target "
                       "profit but cannot supply the PHASE of a marginally "
                       "detected real signal, so the lambda-weighted drive "
                       "is mis-phased and pumps mildly. DESIGN CONSEQUENCE "
                       "(shipped): the fidelity guard stays armed with the "
                       "correction (an early r5 build bypassed it); the "
                       "sub1024_corr/sub512_corr rows here ran under the "
                       "bypass semantics (== fidelity_guard=False now) and "
                       "are kept as the committed negative; under default "
                       "semantics these configs behave like the "
                       "sub1024_guarded row (drive held off, uncontrolled "
                       "levels). Large-N deep-suppression configs opt out "
                       "explicitly (config4_frontier corr rows).",
            "planner": "bench-gated shape H=6/w_terminal=4/K=384/Km=8; r5 "
                       "cost default",
            "n_seeds": n_seeds, "device": str(jax.devices()[0]),
        }, "summary": summary, "per_run": results}, f, indent=1)
    print("wrote", path)
    print(json.dumps(summary))
