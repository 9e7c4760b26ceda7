"""Committed end-to-end results matrix (VERDICT r1 missing #3/#4).

Runs the full controller matrix {wo-oc, feedback, mpc, dagger} x
{two-stream, bump-on-tail} at the reference default workload (N=5000,
M=250, t_max=50, max_mode=3 — `/root/reference/run_ddpg.py:27-61`) over
several seeds on the attached device, and commits the quantitative
evidence the reference only ships as PDFs (`/root/reference/result/`):

* ``artifacts/results_r<N>/matrix.json`` — per-run field-energy traces
  (decimated), tail PE, input energy, and the log-E2 damping-rate
  regression (`/root/reference/src/interpret/landau.py:44-75` semantics)
  over the controlled window;
* ``artifacts/results_r<N>/log_E_<case>.pdf`` — overlay of log <E^2>(t) for
  all four controllers (the reference's headline verification plot,
  `/root/reference/src/plot.py:551-595`).

Run: python experiments/results_matrix.py [n_seeds] [outdir_name]
"""

import json
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
    from plasma_control_tpu.control.evaluate import policy_rollout
    from plasma_control_tpu.control.feedback import feedback_rollout
    from plasma_control_tpu.control.mpc import mpc_rollout
    from plasma_control_tpu.control.rl.ddpg import DDPGConfig, make_ddpg
    from plasma_control_tpu.diag.landau import damping_rate_from_field_energy
    from plasma_control_tpu.io.checkpoint import load_params
    from plasma_control_tpu.models.pic import init_state
    from plasma_control_tpu.models.rollout import rollout
    from plasma_control_tpu.ops.grid import make_grid

    n_seeds = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    outdir = os.path.join(root, "artifacts",
                          sys.argv[2] if len(sys.argv) > 2 else "results_r4")
    os.makedirs(outdir, exist_ok=True)

    ctrl = ControlConfig(max_mode=3)

    matrix = {}
    for simcase in ("two-stream", "bump-on-tail"):
        # the quality-gated bench planner config (experiments/bench_growth_study)
        # under the SHIPPING kernel-drift default ("auto" -> rot at these
        # shapes) — the final 112-rollout gate certified rot seed-paired
        # equal on all three simcases (experiments/rot_drift_gate.py n=80
        # two-stream decision; VERDICT r3 weak #3 asked the matrix to be
        # regenerated under this default, replacing the provisional pre-n=80
        # per-case trig override the r3 artifacts were generated with)
        mpc = MPCConfig(horizon=6, w_terminal=4.0, n_candidates=512, plan_modes=8)
        cfg = SimConfig(simcase=simcase, n_particles=5000, n_mesh=250,
                        dt=0.1, t_max=50.0, length=50.0)
        grid = jax.device_put(make_grid(cfg.n_mesh, cfg.length))
        act = make_actuator(cfg.length, cfg.n_mesh, ctrl.max_mode)

        actor_path = os.path.join(
            root, "artifacts", f"dagger_actor_{simcase.replace('-', '_')}.msgpack"
        )
        # output range MUST match run_dagger's training-time config
        # (ctrl.coeff_min/max = +-1.0) — the bare DDPGConfig default is
        # +-1.25, which would evaluate a 1.25x-gain variant of the trained
        # policy (review finding 2026-08-20)
        nets, ts = make_ddpg(
            cfg, ctrl,
            DDPGConfig(encoder="spectral",
                       output_min=ctrl.coeff_min, output_max=ctrl.coeff_max),
            jax.random.PRNGKey(cfg.seed + 7))
        actor_params = load_params(actor_path, ts.actor_params)
        action_fn = lambda s: nets.actor.sample(actor_params, s[None])[0]

        runs = {
            "wo-oc": lambda st, k: rollout(st, grid, cfg).field_energy[1:],
            "feedback": lambda st, k: feedback_rollout(
                st, grid, cfg, ctrl, act, record_snapshots=False
            ).field_energy,
            "mpc": lambda st, k: mpc_rollout(st, grid, cfg, ctrl, mpc, act, k).field_energy,
            "dagger": lambda st, k: policy_rollout(
                st, grid, cfg, act, action_fn, record_snapshots=False
            ).field_energy,
        }

        case = {}
        for name, fn in runs.items():
            traces, tails, rates, t_arr = [], [], [], None
            for s in range(n_seeds):
                st = init_state(cfg, jax.random.PRNGKey(cfg.seed + s))
                pe = np.asarray(fn(st, jax.random.PRNGKey(cfg.seed + 100 + s)))
                t_arr = cfg.dt * (1.0 + np.arange(len(pe)))
                # damping-rate regression over the controlled window (skip the
                # first fifth: transient/growth before the controller bites)
                lo = len(pe) // 5
                rate = float(damping_rate_from_field_energy(
                    jnp.asarray(t_arr[lo:]), jnp.asarray(pe[lo:])
                ))
                traces.append(pe)
                tails.append(float(pe[-len(pe) // 5:].mean()))
                rates.append(rate)
                print(f"{simcase:13s} {name:9s} seed {s}: tail PE "
                      f"{tails[-1]:9.2f}  gamma {rate:+.4f}", flush=True)
            arr = np.stack(traces)
            case[name] = {
                "tail_pe_per_seed": [round(v, 3) for v in tails],
                "tail_pe_mean": round(float(np.mean(tails)), 3),
                "damping_rate_per_seed": [round(v, 5) for v in rates],
                "damping_rate_mean": round(float(np.mean(rates)), 5),
                # decimate x5 to keep the committed JSON small
                "pe_trace_seed0_decimated": [round(float(v), 4) for v in arr[0][::5]],
                "trace_dt": cfg.dt * 5,
            }
        matrix[simcase] = case

        # overlay plot: the reference's log <E^2>(t) verification figure
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(6, 4))
        for name in runs:
            pe = np.asarray(matrix[simcase][name]["pe_trace_seed0_decimated"])
            t = matrix[simcase][name]["trace_dt"] * (1 + np.arange(len(pe)))
            ax.semilogy(t, pe, label=name)
        ax.set_xlabel("t")
        ax.set_ylabel(r"field energy $\propto \langle E^2 \rangle$")
        ax.set_title(f"{simcase}: controller matrix (seed 0, N=5000/M=250)")
        ax.legend()
        fig.tight_layout()
        fig.savefig(os.path.join(outdir, f"log_E_{simcase}.pdf"))
        plt.close(fig)

    # ---- third simcase: landau (no committed dagger actor — the case is
    # a framework addition validated against the kinetic rate; controllers
    # compared are {wo-oc, feedback, mpc} at the DEVNOTES landau-control
    # config: natural damping that MPC accelerates and feedback PUMPS) ----
    lcfg = SimConfig(simcase="landau", n_particles=2000, n_mesh=32, dt=0.1,
                     t_max=15.0, perturb_amplitude=0.3, perturb_mode=2)
    lmpc = MPCConfig(horizon=6, w_terminal=4.0, n_candidates=512, plan_modes=8)
    lgrid = jax.device_put(make_grid(lcfg.n_mesh, lcfg.length))
    lact = make_actuator(lcfg.length, lcfg.n_mesh, ctrl.max_mode)
    lruns = {
        "wo-oc": lambda st, k: rollout(st, lgrid, lcfg).field_energy[1:],
        "feedback": lambda st, k: feedback_rollout(
            st, lgrid, lcfg, ctrl, lact, record_snapshots=False).field_energy,
        "mpc": lambda st, k: mpc_rollout(
            st, lgrid, lcfg, ctrl, lmpc, lact, k).field_energy,
    }
    # landau DAgger actor (VERDICT r4 #6: 4 controllers x 3 simcases) —
    # trained at this exact config by run_dagger.py, committed weights
    lactor_path = os.path.join(root, "artifacts", "dagger_actor_landau.msgpack")
    if os.path.exists(lactor_path):
        lnets, lts = make_ddpg(
            lcfg, ctrl,
            DDPGConfig(encoder="spectral",
                       output_min=ctrl.coeff_min, output_max=ctrl.coeff_max),
            jax.random.PRNGKey(lcfg.seed + 7))
        lactor_params = load_params(lactor_path, lts.actor_params)
        l_action = lambda s: lnets.actor.sample(lactor_params, s[None])[0]
        lruns["dagger"] = lambda st, k: policy_rollout(
            st, lgrid, lcfg, lact, l_action, record_snapshots=False
        ).field_energy
    lcase = {}
    for name, fn in lruns.items():
        thirds_all, tails, trace0 = [], [], None
        for s in range(n_seeds):
            st = init_state(lcfg, jax.random.PRNGKey(lcfg.seed + s))
            pe = np.asarray(fn(st, jax.random.PRNGKey(lcfg.seed + 100 + s)))
            if s == 0:
                trace0 = pe
            n3 = len(pe) // 3
            thirds_all.append([round(float(pe[i*n3:(i+1)*n3].mean()), 2)
                               for i in range(3)])
            tails.append(round(float(pe[-len(pe) // 5:].mean()), 3))
            print(f"{'landau':13s} {name:9s} seed {s}: thirds {thirds_all[-1]}",
                  flush=True)
        lcase[name] = {
            # PE means over t-thirds: the robust statistic for an
            # oscillating decaying envelope (DEVNOTES landau-control)
            "pe_thirds_per_seed": thirds_all,
            "pe_thirds_mean": [round(float(np.mean([t[i] for t in thirds_all])), 2)
                               for i in range(3)],
            "tail_pe_per_seed": tails,
            "tail_pe_mean": round(float(np.mean(tails)), 3),
            "pe_trace_seed0_decimated": [round(float(v), 4) for v in trace0[::5]],
            "trace_dt": lcfg.dt * 5,
        }
    matrix["landau"] = lcase

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 4))
    for name in lruns:
        pe = np.asarray(lcase[name]["pe_trace_seed0_decimated"])
        t = lcase[name]["trace_dt"] * (1 + np.arange(len(pe)))
        ax.semilogy(t, pe, label=name)
    ax.set_xlabel("t")
    ax.set_ylabel(r"field energy $\propto \langle E^2 \rangle$")
    ax.set_title("landau: controller matrix (seed 0, N=2000/M=32)")
    ax.legend()
    fig.tight_layout()
    fig.savefig(os.path.join(outdir, "log_E_landau.pdf"))
    plt.close(fig)

    meta = {
        "config": "N=5000 M=250 t_max=50 dt=0.1 max_mode=3 (reference run_ddpg defaults)",
        "landau_config": "N=2000 M=32 t_max=15 A=0.3 mode-2 (the validated "
                         "landau simcase); statistic = PE means over "
                         "t-thirds; dagger row present when "
                         "artifacts/dagger_actor_landau.msgpack is committed "
                         "(r5: 4 controllers x 3 simcases)",
        "mpc": "H=6 w_terminal=4 K=512 Km=8 full-fidelity spectral (bench-gated); "
               "spectral_drift UNSET = shipping default 'auto' (rot at these "
               "shapes; certified equal on all simcases at 112 paired rollouts, "
               "rot_drift_gate final n=80 decision)",
        "dagger": "spectral-encoder amortized-MPC actor, committed weights "
                  "artifacts/dagger_actor_<case>.msgpack (run_dagger.py --optimize)",
        "n_seeds": n_seeds,
        "device": str(jax.devices()[0]),
    }
    with open(os.path.join(outdir, "matrix.json"), "w") as f:
        json.dump({"meta": meta, "results": matrix}, f, indent=1)
    print("wrote", os.path.join(outdir, "matrix.json"))
