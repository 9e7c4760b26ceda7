"""Shared CLI machinery for the run scripts.

Mirrors the reference's argparse surface (`/root/reference/run_wo_oc.py:20-57`,
`run_ddpg.py:23-91`, etc.) — same flag names and defaults — plus the
framework's additions (MPC flags, deposit method, npz export). Each top-level
``run_*.py`` script is a thin wrapper over a function here.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np

from .config import ControlConfig, MPCConfig, SimConfig
from .utils.cache import enable_compile_cache

enable_compile_cache()

__all__ = ["base_parser", "add_control_args", "add_mpc_args", "build_sim_config", "build_control_config", "run_and_save"]


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--simcase", type=str, default="two-stream",
                   choices=["two-stream", "bump-on-tail", "landau"])
    p.add_argument("--interpol", type=str, default="CIC", choices=["CIC", "TSC"])
    p.add_argument("--gamma", type=float, default=5.0, help="kept for reference-CLI parity; the spectral solve needs no gamma")
    p.add_argument("--save_file", type=str, default="./dataset/")
    p.add_argument("--save_plot", type=str, default="./result/")
    p.add_argument("--is_save", action="store_true", default=False)
    p.add_argument("--num_particle", type=int, default=5000)
    p.add_argument("--num_mesh", type=int, default=250)
    p.add_argument("--t_min", type=float, default=0.0)
    p.add_argument("--t_max", type=float, default=50.0)
    p.add_argument("--dt", type=float, default=0.1)
    p.add_argument("--L", type=float, default=50.0)
    p.add_argument("--n0", type=float, default=1.0)
    p.add_argument("--vb", type=float, default=3.0)
    p.add_argument("--vth", type=float, default=1.0)
    p.add_argument("--A", type=float, default=0.1)
    p.add_argument("--n_mode", type=int, default=2)
    p.add_argument("--a", type=float, default=0.2)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--deposit_method", type=str, default="dense", choices=["dense", "scatter"])
    return p


def add_control_args(p: argparse.ArgumentParser, max_mode: int = 3, coeff: float = 1.0):
    p.add_argument("--max_mode", type=int, default=max_mode)
    p.add_argument("--coeff_max", type=float, default=coeff)
    p.add_argument("--coeff_min", type=float, default=-coeff)
    return p


def add_mpc_args(p: argparse.ArgumentParser):
    p.add_argument("--horizon", type=int, default=10)
    p.add_argument("--n_candidates", type=int, default=512)
    p.add_argument("--n_elites", type=int, default=64)
    p.add_argument("--n_iters", type=int, default=2)
    p.add_argument("--sigma0", type=float, default=0.3)
    p.add_argument("--temperature", type=float, default=0.05)
    p.add_argument("--w_field", type=float, default=1.0)
    p.add_argument("--w_input", type=float, default=0.05)
    p.add_argument("--algo", type=str, default="mppi", choices=["mppi", "cem"])
    p.add_argument("--plan_particles", type=int, default=0, help="0 = full fidelity")
    p.add_argument("--plan_chunk", type=int, default=0,
                   help="evaluate candidates in sequential chunks of this size "
                        "(bounds memory to plan_chunk x N planes; needed for "
                        "full-fidelity planning at very large N; 0 = one batch)")
    p.add_argument("--plan_mesh", type=int, default=0, help="0 = full fidelity")
    p.add_argument("--smooth_noise", type=float, default=0.0,
                   help="AR(1) beta for temporally correlated candidate noise (0 = white)")
    p.add_argument("--n_knots", type=int, default=3,
                   help="sample candidate noise at N knots and interpolate over the "
                        "horizon (0 = off/white); an explicit --smooth_noise > 0 wins. "
                        "Default 3: ~2x better suppression at equal n_candidates "
                        "(experiments/sampler_quality.py)")
    p.add_argument("--plan_integrator", type=str, default="kdk",
                   choices=["env", "leapfrog", "kdk"],
                   help="candidate-rollout integrator; applied steps always use Yoshida-4")
    p.add_argument("--plan_kernel", type=str, default="auto",
                   choices=["auto", "xla", "fused"],
                   help="planning-step kernel (plan_model=spectral): 'auto' = the "
                        "whole-horizon spectral GPU kernel on the GPU, the XLA "
                        "scan elsewhere; 'fused' forces the kernel (GPU only)")
    p.add_argument("--plan_model", type=str, default="spectral",
                   choices=["spectral", "grid"],
                   help="candidate-rollout dynamics: gridless low-mode spectral "
                        "(default; ~2.6x faster solves at equal suppression) or "
                        "the mesh PIC at plan fidelity")
    p.add_argument("--plan_modes", type=int, default=16,
                   help="Fourier modes kept by the spectral planning model "
                        "(at least max_mode is always used)")
    p.add_argument("--w_terminal", type=float, default=0.0,
                   help="terminal tail-cost weight on the final-step planning "
                        "field energy (value-function tail estimate; lets "
                        "shorter horizons rank like long ones down to H~5-6 — "
                        "experiments/horizon_study.py). 0 = off")
    p.add_argument("--spectral_drift", type=str, default="auto",
                   choices=["trig", "rot", "auto"],
                   help="drift variant inside the spectral horizon kernel; "
                        "default auto = the phasor-rotation drift (quality-"
                        "gated seed-paired equal on all three simcases at 112 "
                        "paired rollouts, experiments/rot_drift_gate.py) with a "
                        "trig fallback for pathological dt*L; 'trig' opts out")
    p.add_argument("--terminal_mode", type=str, default="const",
                   choices=["const", "growth"],
                   help="terminal tail estimator: 'const' = flat --w_terminal "
                        "weight; 'growth' = per-candidate geometric "
                        "extrapolation of --terminal_steps more running-cost "
                        "steps at the candidate's own measured end-of-horizon "
                        "PE growth ratio (penalizes 'low but growing' endings)")
    p.add_argument("--terminal_steps", type=int, default=4,
                   help="tail length of the 'growth' extrapolation in "
                        "planning steps (e.g. 4 when planning H=6 to rank "
                        "like H=10)")
    p.add_argument("--no_antithetic", action="store_true",
                   help="disable mirrored-pair (antithetic) candidate sampling")
    p.add_argument("--plan_correction", type=str, default="none",
                   choices=["none", "twin"],
                   help="noise-floor correction for SUBSAMPLED planning: 'twin' "
                        "scores each candidate's mode phasors against a "
                        "zero-drive twin of the plan subsample (common random "
                        "numbers) shrunk by the full-state coherence per mode — "
                        "removes the in-model profit of cancelling subsample "
                        "noise phases that don't exist in the real plasma "
                        "(MPCConfig.plan_correction); spectral plan model only")
    p.add_argument("--cost_pe_nref", type=float, default=5000.0,
                   help="scale-free plan cost: multiply the planning field "
                        "energy by this / n_plan_particles so one --w_input "
                        "balances field vs drive at every N (default 5000 = "
                        "the reference scale, factor exactly 1.0 there); "
                        "0 = raw plan PE (pre-r5 behavior)")
    return p


def build_sim_config(args: dict) -> SimConfig:
    return SimConfig(
        simcase=args["simcase"],
        n_particles=args["num_particle"],
        n_mesh=args["num_mesh"],
        t_min=args["t_min"],
        t_max=args["t_max"],
        dt=args["dt"],
        length=args["L"],
        n0=args["n0"],
        vb=args["vb"],
        vth=args["vth"],
        perturb_amplitude=args["A"],
        perturb_mode=args["n_mode"],
        bump_a=args["a"],
        interpol=args["interpol"].lower(),
        deposit_method=args["deposit_method"],
        seed=args["seed"],
    )


def build_control_config(args: dict) -> ControlConfig:
    return ControlConfig(
        max_mode=args.get("max_mode", 3),
        coeff_min=args.get("coeff_min", -1.0),
        coeff_max=args.get("coeff_max", 1.0),
        reward_n_mesh=args["num_mesh"],
    )


def build_mpc_config(args: dict) -> MPCConfig:
    return MPCConfig(
        horizon=args["horizon"],
        n_candidates=args["n_candidates"],
        n_elites=args["n_elites"],
        n_iters=args["n_iters"],
        sigma0=args["sigma0"],
        temperature=args["temperature"],
        w_field=args["w_field"],
        w_input=args["w_input"],
        algo=args["algo"],
        plan_particles=args["plan_particles"] or None,
        plan_mesh=args["plan_mesh"] or None,
        plan_chunk=args.get("plan_chunk", 0) or None,
        smooth_noise=args.get("smooth_noise", 0.0),
        n_knots=args.get("n_knots", 0) or None,
        plan_integrator=args.get("plan_integrator", "kdk"),
        plan_kernel=args.get("plan_kernel", "auto"),
        plan_model=args.get("plan_model", "spectral"),
        plan_modes=args.get("plan_modes", 16),
        w_terminal=args.get("w_terminal", 0.0),
        terminal_mode=args.get("terminal_mode", "const"),
        spectral_drift=args.get("spectral_drift", "auto"),
        terminal_steps=args.get("terminal_steps", 4),
        antithetic=not args.get("no_antithetic", False),
        plan_correction=args.get("plan_correction", "none"),
        cost_pe_nref=args.get("cost_pe_nref", 5000.0) or None,
    )


def compute_cost_traces(snapshot, cfg: SimConfig, ctrl: ControlConfig, coeffs=None):
    """Per-step J_KL / J_ee (+ J_ie) traces like the run scripts
    (`run_wo_oc.py:121-125`, `run_feedback.py:159-163`). ``snapshot`` is
    (2N, T+1); costs evaluated on the post-step states (columns 1..T)."""
    import jax
    import jax.numpy as jnp

    from .control.reward import Reward

    snap = jnp.asarray(snapshot)
    init_state = snap[:, 0]
    reward = Reward(init_state, ctrl.reward_n_mesh, cfg.length, ctrl.vmin, ctrl.vmax, cfg.n0)
    states = snap[:, 1:].T  # (T, 2N)
    j_kl = jax.vmap(reward.compute_kl_divergence)(states)
    j_ee = jax.vmap(lambda s: reward.compute_electric_energy(s))(states)
    costs = {r"$J_{KL}$": np.asarray(j_kl), r"$J_{ee}$": np.asarray(j_ee)}
    if coeffs is not None:
        j_ie = jax.vmap(reward.compute_input_energy)(jnp.asarray(coeffs))
        costs[r"$J_{ie}$"] = np.asarray(j_ie)
    return costs


def run_and_save(
    tag: str,
    args: dict,
    cfg: SimConfig,
    ctrl: Optional[ControlConfig],
    snapshot,
    energy,
    field_energy,
    coeff_cos=None,
    coeff_sin=None,
    costs=None,
    high_idx=None,
):
    """Dump data + the reference's plot set for one run
    (`run_wo_oc.py:134-189`, `run_feedback.py:183-243`)."""
    from .io.export import build_run_dict, save_mat, save_npz

    filepath = os.path.join(args["save_file"], args["simcase"], tag)
    savepath = os.path.join(args["save_plot"], args["simcase"], tag)
    os.makedirs(filepath, exist_ok=True)
    os.makedirs(savepath, exist_ok=True)

    snapshot = np.asarray(snapshot)
    mdic = build_run_dict(cfg, snapshot, np.asarray(energy), np.asarray(field_energy), coeff_cos, coeff_sin, costs)
    if args.get("is_save"):
        save_mat(os.path.join(filepath, "data.mat"), mdic)
        save_npz(os.path.join(filepath, "data.npz"), mdic)

    from .viz import plots as P  # matplotlib: needed only to draw

    nt = snapshot.shape[1] - 1
    dx = cfg.length / cfg.n_mesh
    if costs:
        P.plot_cost_over_time(cfg.t_max, nt, costs, savepath, "cost.pdf")
    P.plot_log_e(cfg.t_max, cfg.length, dx, cfg.n_mesh, snapshot, savepath, "log_E.pdf")
    P.plot_e_k_spectrum(cfg.t_max, cfg.length, dx, cfg.n_mesh, snapshot, savepath, "Ek_spectrum.pdf")
    P.plot_e_k_over_time(cfg.t_max, cfg.length, dx, cfg.n_mesh, 5, snapshot, savepath, "Ek_t.pdf")
    if coeff_cos is not None:
        P.plot_e_k_external_over_time(cfg.t_max, coeff_cos, coeff_sin, savepath, "Ek_t_external.pdf")
    if args["simcase"] == "bump-on-tail":
        P.plot_bump_on_tail_evolution(
            snapshot, savepath, "phase_space_evolution.pdf", 0, cfg.length, -10.0, 10.0, high_idx
        )
    else:  # two-stream and landau: plain phase-space scatter
        P.plot_two_stream_evolution(snapshot, savepath, "phase_space_evolution.pdf", 0, cfg.length, -10.0, 10.0)
    P.plot_x_dist_evolution(snapshot, savepath, "x_dist.pdf", 0, cfg.length, cfg.n_mesh)
    P.plot_v_dist_evolution(snapshot, savepath, "v_dist.pdf", -10.0, 10.0, cfg.n_mesh)
    print(f"# saved artifacts: {filepath} (data), {savepath} (plots)")
