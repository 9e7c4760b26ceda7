"""Unified configuration for simulations, control, and benchmarks.

The reference scatters defaults across five argparse entry points with
inconsistent values (`/root/reference/run_ddpg.py:27-61` dt=0.1,
`/root/reference/run_ppo.py:39` dt=0.05, `/root/reference/run_sac.py:33-35,57`
N=10000/N_mesh=500/max_mode=5). Here a single dataclass carries everything,
with presets reproducing each script's defaults.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal, Optional

SimCase = Literal["two-stream", "bump-on-tail", "landau"]


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Physics + discretization parameters (reference argparse block,
    `/root/reference/run_wo_oc.py:24-55`)."""

    simcase: SimCase = "two-stream"
    n_particles: int = 5000
    n_mesh: int = 250
    t_min: float = 0.0
    t_max: float = 50.0
    dt: float = 0.1
    length: float = 50.0
    n0: float = 1.0
    vb: float = 3.0  # beam velocity
    vth: float = 1.0  # thermal velocity (sigma)
    perturb_amplitude: float = 0.1  # A
    perturb_mode: int = 2  # n_mode
    bump_a: float = 0.2  # bump-on-tail beam fraction parameter
    interpol: Literal["cic", "tsc", "tsc_standard"] = "cic"
    deposit_method: Literal["dense", "scatter"] = "dense"
    integrator: Literal["yoshida4", "verlet", "symplectic_euler"] = "yoshida4"
    seed: int = 42

    @property
    def dx(self) -> float:
        return self.length / self.n_mesh

    @property
    def n_steps(self) -> int:
        """Nt = ceil((tmax - tmin)/dt) (`/root/reference/src/env/pic.py:177`)."""
        return int(math.ceil((self.t_max - self.t_min) / self.dt))

    @property
    def cfl_dt(self) -> float:
        """CFL-like bound dt <= 2/sqrt(N/L) (`/root/reference/src/env/pic.py:71-73`)."""
        return 2.0 / math.sqrt(self.n_particles / self.length)

    def clamped_dt(self) -> float:
        return min(self.dt, self.cfl_dt)


@dataclasses.dataclass(frozen=True)
class ControlConfig:
    """Actuator + cost parameters (`/root/reference/run_ddpg.py:56-61`)."""

    max_mode: int = 3
    coeff_min: float = -1.0
    coeff_max: float = 1.0
    # Reward weights (`/root/reference/src/control/rl/reward.py:27-33`)
    alpha: float = 1.0
    beta: float = 1.0
    reward_n_mesh: int = 500
    vmin: float = -25.0
    vmax: float = 25.0
    # Reference quirk: actuator mesh uses np.linspace(0, L, M) *including* the
    # endpoint (`/root/reference/src/control/actuator.py:13`), which is not the
    # PIC cell-edge grid. True keeps parity; False uses the correct grid.
    endpoint_grid: bool = True

    @property
    def n_actions(self) -> int:
        return 2 * self.max_mode


@dataclasses.dataclass(frozen=True)
class MPCConfig:
    """Receding-horizon sampling MPC (new capability; BASELINE.json north star)."""

    horizon: int = 10  # planning horizon in env steps
    n_candidates: int = 512  # sampled control sequences per solve
    n_elites: int = 64  # CEM elite set
    n_iters: int = 2  # CEM refinement iterations per solve
    sigma0: float = 0.3  # initial sampling stddev
    temperature: float = 0.05  # MPPI softmax temperature
    w_field: float = 1.0  # field-energy cost weight
    w_input: float = 0.05  # control-effort cost weight
    algo: Literal["mppi", "cem"] = "mppi"
    # Multi-fidelity planning: the candidate rollouts inside a solve may use a
    # reduced model (subsampled particles / coarser mesh). The applied
    # environment step always uses the full model, and replanning every step
    # closes the loop over model error — standard hierarchical MPC. None =
    # plan at full fidelity.
    #
    # HAZARD: particle subsampling injects unscreened sampling noise into the
    # plan model's low modes (n0^2 (1-n/N) / (2 k^2) per mode). When the
    # coherent field is not well above that floor — e.g. bump-on-tail near
    # saturation — the planner profits in-model by cancelling the subsample's
    # noise phases and the applied drive PUMPS the real plasma (measured:
    # tail PE 270 vs 33 uncontrolled at BASELINE config-3 scale; full
    # fidelity suppresses to ~20 — experiments/bot_bench_scale_debug.py,
    # DEVNOTES 2026-08-19). Use control.mpc.plan_fidelity_check before
    # reducing; run_mpc warns automatically. Strong-signal regimes (growing
    # two-stream, coherent field >> floor) remain safe and ~N_plan/N faster.
    plan_particles: Optional[int] = None
    plan_mesh: Optional[int] = None
    # Evaluate candidate costs in sequential chunks of this size
    # (lax.map over chunks of the batched evaluator) to bound the live
    # working set to plan_chunk x N planes instead of K x N. Required for
    # very-large-N FULL-fidelity planning on the XLA path (N=1e6: even K=64
    # holds several 256 MB (K, N) planes live; see
    # control/mpc.py::candidate_costs). A block
    # that is not a multiple of the chunk (under shard_map: the per-device
    # LOCAL block) is padded up to one and the padded costs discarded, so
    # the requested chunk is always the chunk launched.
    # None = single batched evaluation.
    plan_chunk: Optional[int] = None
    # Noise-floor-corrected subsampled planning cost ("twin" correction;
    # spectral plan model only). The subsampled plan state's mode phasors are
    # coherent signal + sampling noise; an uncorrected planner profits
    # in-model by cancelling the noise phases (the HAZARD above). The
    # correction removes that profit EXACTLY where it is phantom:
    #   1. once per solve, estimate each mode's coherent energy fraction
    #      lambda_m from the FULL state (Wiener shrinkage: lambda =
    #      r^2 sig^2 / (r^2 sig^2 + n(1-r)), one O(N*Km) pass);
    #   2. roll a zero-drive TWIN of the plan subsample over the horizon with
    #      the same dynamics (common random numbers: same particles, same
    #      discretization) recording its mode phasors (c0, s0)(t);
    #   3. score each candidate on the corrected field energy
    #      sum_m |(c, s) - (1 - lambda_m) (c0, s0)|^2 / k_m^2.
    # For a pure-noise mode (lambda=0) the zero-drive candidate costs 0 and
    # any drive ADDS cost (the CRN difference is the drive effect alone); for
    # a coherent mode (lambda=1) the cost is unchanged. At full fidelity the
    # correction is inactive (identical program).
    # WHAT IT DOES AND DOES NOT FIX (measured, r5): it removes the
    # in-model PHANTOM-target profit — the hazard above — which at strong
    # signal (config-4 two-stream) breaks the subsampled planner's plateau
    # 9x (results_r5/config4_frontier.json). It does NOT supply the phase
    # of a marginally-detected real signal: on a never-coherent quiet
    # plasma the lambda-weighted drive is still mis-phased and pumps
    # mildly (reference-scale bump-on-tail: corrected-unguarded 131.7 vs
    # 36.7 uncontrolled vs 186.2 uncorrected-unguarded —
    # results_r5/corrected_reference_scale.json). The fidelity guard
    # therefore stays armed with the correction; deep-suppression runs at
    # large N opt out explicitly (fidelity_guard=False) to drive below the
    # guard threshold — an informed tradeoff with the correction active.
    # Cost: one extra (uncandidated) H-step plan rollout + one O(N*Km) pass
    # per solve — negligible next to the K x H candidate block.
    plan_correction: Literal["none", "twin"] = "none"
    # Scale-free plan cost: multiply the planning-model field
    # energy by cost_pe_nref / n_plan_particles before weighting. The raw
    # plan PE carries a factor n (mode sums scale with particle count), so
    # one w_input cannot balance field vs drive across N — the reference
    # normalizes its reward terms for the same reason
    # (`/root/reference/src/control/rl/reward.py:31-33`). With the default
    # 5000 (the reference/bench workload), the cost is invariant to BOTH the
    # environment N and the plan fidelity n, and at the reference scale the
    # factor is exactly 1.0 — every bench/matrix number at N=5000 is
    # unchanged by construction. None disables (raw plan PE, the pre-r5
    # behavior; the r4 config-4/1M artifacts used raw PE with hand-scaled
    # w_input).
    # GATES (r5, artifacts/results_r5): N=5000 exact no-op; N=100k
    # seed-paired equal to the r4 hand tuning (config4_frontier
    # fullfid_K384: 113.9 vs 116.4 at w_input=0.05). At N=1M the
    # normalization is NOT sufficient: the optimal w_input is a further
    # ~20x lower (0.0025, == r4's hand raw 0.5 — million_r5.json rows
    # fullfid_K384_wt4 25-47k vs _wraw05 7.5-14.5k). That residue is
    # physics, not units — at 1M the cleaner wave demands more drive per
    # unit of achievable suppression — so it is documented per-scale
    # rather than absorbed into another hidden rescale.
    cost_pe_nref: Optional[float] = 5000.0
    # Dynamic fidelity guard for subsampled planning (active only when
    # plan_particles < N). Per solve, ON-DEVICE, compare the full state's
    # coherent modal energy (plan frame) against the subsample's injected
    # noise floor; when the ratio drops below fidelity_guard_ratio the solve
    # is untrustworthy (the planner would profit by cancelling noise phases
    # that don't exist in the real plasma — the HAZARD above) and the guard
    # ZEROES the applied action and resets the warm-start mean. Rationale:
    # shapes are static under jit so the plan cannot switch particle counts
    # mid-scan, but in the unsafe regime the coherent field is at/below the
    # screened noise floor where the correct drive is ~none (measured: quiet
    # bump-on-tail uncontrolled tail PE ~25 vs ~270 when pumped by an
    # unguarded subsampled planner). Unlike the t=0-only host check
    # (plan_fidelity_check), this follows regime CHANGES — e.g. a controller
    # that successfully quiets a two-stream re-enters the unsafe regime and
    # the guard disengages the drive instead of letting it pump.
    fidelity_guard: bool = True
    fidelity_guard_ratio: float = 3.0
    # Cost fidelity: True (default) recomputes the field at the exact
    # post-step positions for the PE cost (one extra deposit+solve per step);
    # False reuses the field of the last kick substage — ~14% faster solves
    # but measurably weaker suppression (the half-stage-stale PE biases
    # candidate ranking), so it is opt-in.
    exact_cost_energy: bool = True
    # Gradient refinement (the SURVEY §7 'QP correction' analogue): after the
    # sampling update, run n_grad_iters Adam steps on the horizon cost wrt
    # the nominal sequence, differentiating through the PIC rollout
    # (rematerialized per step). 0 disables.
    n_grad_iters: int = 0
    grad_lr: float = 0.05
    # Seed the candidate pool with the phase-conjugate feedback action
    # (computed at the current state, held over the horizon). Guarantees the
    # sampler never does worse than the hand-crafted expert at solve time.
    seed_feedback: bool = True
    # Planning integrator fidelity. The *applied* env step always uses
    # cfg.integrator (Yoshida-4, reference parity); candidate rollouts inside
    # a solve only need to *rank* control sequences, so a cheaper symplectic
    # scheme suffices. "env" = use cfg.integrator (3 deposit+gather pipelines
    # per step for Yoshida-4); "leapfrog" = position-Verlet drift-kick-drift
    # (1 pipeline per step, ~2-3x faster solves; 2nd-order accurate — ranking
    # is unchanged at dt=0.1, see tests/test_mpc.py::test_leapfrog_planner);
    # "kdk" = velocity-Verlet kick-drift-kick (the adjoint 2nd-order
    # splitting) with the boundary half-kicks *merged* (staggered
    # velocities): 2 CIC weight evaluations per step, exact post-step PE by
    # construction, and the cheapest of the three per step.
    # Ranking fidelity vs the env integrator is tested
    # (tests/test_mpc.py::test_kdk_planner_preserves_ranking).
    plan_integrator: Literal["env", "leapfrog", "kdk"] = "kdk"
    # Temporal correlation of candidate perturbations: 0 = white noise;
    # beta in (0, 1) applies an AR(1) filter along the horizon
    # (eps_t = beta*eps_{t-1} + sqrt(1-beta^2)*w_t), keeping per-step
    # variance sigma^2 while favoring smooth control sequences.
    smooth_noise: float = 0.0
    # Knot parameterization of candidate perturbations: sample noise at
    # n_knots points along the horizon and linearly interpolate to all H
    # steps (marginal variance renormalized to sigma^2 at every step).
    # Cuts the effective search dimension from H*2K to n_knots*2K — smooth
    # candidates by construction, better suppression at equal n_candidates
    # for horizons where the optimal control varies slowly (the physical
    # mode amplitudes evolve on the plasma-frequency scale, ~10 dt).
    # An explicitly-set smooth_noise > 0 takes precedence (AR(1) is never on
    # by default, so setting it expresses intent). None/0/>=horizon = off
    # (white noise).
    # Default 3: measured 2.2x better two-stream suppression than white
    # noise at equal K (tail PE 27.9 vs 61.5, 4 seeds; also beats AR(1)
    # beta=0.8 at 29.8 — experiments/sampler_quality.py). Rollout cost
    # unchanged. Horizons <= n_knots automatically fall back to white noise.
    n_knots: Optional[int] = 3
    # Planning-step kernel (plan_model="spectral"). "auto" runs the
    # whole-horizon spectral GPU kernel (ops/pallas/spectral_horizon.py) on
    # the GPU and the XLA scan elsewhere; "xla" always runs the XLA scan;
    # "fused" forces the kernel and is a config error off the GPU. The grid
    # model has only the XLA path.
    plan_kernel: Literal["auto", "xla", "fused"] = "auto"
    # Drift variant inside the spectral horizon kernel: "rot" advances the
    # base-harmonic phasor by a small-angle polynomial rotation (no per-step
    # cos/sin, three carried planes), "trig" recomputes cos/sin of the
    # wrapped position (two carried planes), "auto" = rot where the static
    # angle bound holds and its carry fits the L2 cache, else trig (see
    # ops/pallas/spectral_horizon.py::_use_rot). rot is fp32-cost-equal per
    # solve and closed-loop quality-gated seed-paired equal to trig on all
    # three simcases at bench scale — bump-on-tail 13.7 vs 13.3 (8 paired
    # seeds), two-stream 36.8 vs 36.5 (80 paired seeds, 95% CI [-9%, +11%]),
    # landau 3.7 vs 3.7 (8 paired seeds) — experiments/rot_drift_gate.py.
    spectral_drift: Literal["trig", "rot", "auto"] = "auto"
    # Planning *dynamics* model. "spectral" (default) = gridless low-mode
    # dynamics: the self-field is the truncated Fourier series of the exact
    # point-particle density (continuum Poisson mode-by-mode), deposit and
    # gather become streamed mode projections — no mesh, no shape-function
    # weights, no (N, M) weight tiles — with equal closed-loop suppression
    # to the grid KDK planner (seed-averaged
    # tail PE 61.8-72.7 spectral vs 69.7 grid on the two-stream test config,
    # 5.7 vs 5.2 on bump-on-tail). "grid" = the mesh PIC at plan fidelity
    # (plan_particles/plan_mesh above) — reference-faithful plan dynamics;
    # required by the plan_integrator choices.
    # Candidate ranking matches the grid planner when plan_modes covers the
    # unstable modes (~2-4x max_mode): rank corr 0.987+, see
    # control/mpc.py::_horizon_cost_spectral and
    # tests/test_mpc.py::test_spectral_planner_preserves_ranking.
    plan_model: Literal["grid", "spectral"] = "spectral"
    # Number of Fourier modes kept by the spectral planning model (at least
    # max_mode is always used so the actuator's modes are inside the model).
    plan_modes: int = 16
    # Terminal tail cost: add w_terminal * PE_H (the planning-model field
    # energy after the LAST horizon step) to every candidate's cost. This is
    # a value-function tail estimate: the running cost sums H steps of field
    # energy, and near the instability the post-horizon tail is dominated by
    # how much field energy the candidate leaves behind, which PE_H measures
    # directly (the effective tail value of a state whose PE decays/persists
    # over ~w_terminal more steps). It lets SHORT horizons rank candidates
    # like long ones — quality-vs-horizon measurements live in
    # experiments/horizon_study.py. 0 disables (pure running cost).
    w_terminal: float = 0.0
    # Terminal tail ESTIMATOR. "const" = the flat w_terminal weight above.
    # "growth" = per-candidate geometric extrapolation: measure each
    # candidate's own end-of-horizon PE growth ratio r = PE_H / PE_{H-1}
    # (clipped to [0.7, 1.3] against step-to-step noise) and charge the
    # extrapolated running cost of terminal_steps more planning steps,
    #     tail = w_field * PE_H * sum_{i=1..T} r^i = w_field*PE_H*r(1-r^T)/(1-r).
    # Unlike the constant weight, this distinguishes a candidate that leaves
    # the field LOW BUT GROWING (r > 1: penalized up to ~2x per tail step)
    # from one that leaves it low and damped (r < 1: tail nearly free) —
    # exactly the information a short horizon truncates away. Composes with
    # w_terminal (both added); requires horizon >= 2 (degrades to "const"
    # otherwise). Rollout cost unchanged: the per-step PEs are already
    # computed on every planning path.
    # WHEN TO USE WHICH (measured, 2026-08-20): "growth" dominates at
    # small-K well-resolved planning (K=64/Km=16: it fully recovers H=5
    # where the flat weight plateaus, and halves the H=4 penalty —
    # experiments/growth_terminal_study.py); at bench scale (K=512/Km=8)
    # the flat weight is MORE robust (the end-of-horizon ratio between
    # near-duplicate elites is noise-dominated and the geometric tail
    # injects cost variance: two-stream 36-42 vs 26 tail PE —
    # experiments/bench_growth_study.py). Keep terminal_steps ~ horizon;
    # much longer tails compound extrapolation noise geometrically.
    terminal_mode: Literal["const", "growth"] = "const"
    # Tail length T of the "growth" extrapolation, in planning steps: how
    # many post-horizon steps of running cost the estimator charges. Natural
    # setting: (reference horizon) - horizon, e.g. 4 when planning with H=6
    # to rank like H=10.
    terminal_steps: int = 4
    # Antithetic variates: sample K/2 perturbations and mirror them
    # (eps, -eps). Within a pair the odd terms of the local cost expansion
    # cancel, so elite selection / MPPI weighting responds to curvature
    # rather than sampling noise — measurably better suppression at equal K.
    # Composes with knot/AR(1) noise (both are linear in the underlying
    # normals). Default True: with the knot-3 sampler, 8-seed two-stream
    # tail PE mean 25.1 vs 33.3 without (and white noise 41.7 vs 62.2,
    # 4 seeds) — experiments/sampler_quality.py.
    antithetic: bool = True

    def __post_init__(self):
        if self.plan_correction == "twin" and self.n_grad_iters > 0:
            # the gradient refinement differentiates the RAW plan cost, not
            # the corrected one — Adam would silently step the nominal
            # toward cancelling phantom subsample noise that the sampling
            # stage just priced out (review finding r5). Thread twin targets
            # into _gradient_refine before lifting this.
            raise ValueError(
                "plan_correction='twin' does not compose with gradient "
                "refinement (n_grad_iters > 0): the refinement cost is the "
                "uncorrected plan PE and would re-introduce the phantom "
                "noise-cancellation drive the correction removes"
            )
        if self.terminal_steps < 0:
            # a negative tail length flips the geometric series' sign and
            # silently turns the "growth" tail into a cost CREDIT that
            # rewards growing candidates (r(1-r^t)/(1-r) < 0 for t < 0)
            raise ValueError(
                f"terminal_steps must be >= 0, got {self.terminal_steps}"
            )
        if self.terminal_mode == "growth" and self.horizon < 2:
            import warnings

            # the growth ratio PE_H/PE_{H-1} needs two horizon steps; with
            # H < 2 the tail silently becomes a no-op (NOT the "const" mode
            # — that one also needs w_terminal > 0 to do anything)
            warnings.warn(
                "terminal_mode='growth' needs horizon >= 2; the growth tail "
                "is a no-op at this horizon (set w_terminal for a constant "
                "terminal cost instead)",
                stacklevel=2,
            )


def preset(name: str, **overrides) -> SimConfig:
    """Named presets matching the reference scripts' defaults."""
    base = {
        "wo-oc": SimConfig(),
        "feedback": SimConfig(),
        "ddpg": SimConfig(),  # run_ddpg.py:27-61
        "ppo": SimConfig(dt=0.05),  # run_ppo.py:39
        "sac": SimConfig(n_particles=10000, n_mesh=500),  # run_sac.py:33-35
        "bench-small": SimConfig(n_particles=10000, n_mesh=64),  # BASELINE config 1
        "bench-host": SimConfig(n_particles=100000, n_mesh=256),  # BASELINE config 4
        "bench-multihost": SimConfig(n_particles=1_000_000, n_mesh=256),  # config 5
    }[name]
    return dataclasses.replace(base, **overrides) if overrides else base
