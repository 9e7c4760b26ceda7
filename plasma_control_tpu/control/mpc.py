"""Receding-horizon sampling MPC (MPPI / CEM) for external-field control.

This is the BASELINE.json north-star capability that replaces the reference's
DDPG/PPO/SAC training loops with a trajectory-optimization engine: at every
control step, sample K candidate Fourier-coefficient sequences around a
warm-started nominal, roll each out through the *full PIC dynamics* for a
short horizon (batched ``vmap`` over candidates, all on-device), score with
the field-energy + control-effort cost (`/root/reference/README.md:70`,
`/root/reference/src/control/rl/reward.py:52-76`), and update the nominal by
MPPI exponential averaging or CEM elite refitting. The first action is
applied; the nominal is shifted (receding horizon).

Everything — candidate sampling, K batched H-step rollouts, cost reduction,
the argmin/weighting, the outer receding-horizon loop — is one compiled
program with no host sync inside (SURVEY §7 hard part 5). The candidate axis
is the unit of data parallelism for multi-chip scaling
(:mod:`plasma_control_tpu.parallel`).
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..config import ControlConfig, MPCConfig, SimConfig
from ..models.pic import PlasmaState, step
from ..models.rollout import _energies
from ..ops.grid import Grid
from .actuator import FourierActuator

__all__ = [
    "MPCOutput",
    "candidate_costs",
    "knot_noise",
    "plan",
    "plan_fidelity_check",
    "mpc_rollout",
    "twin_targets",
]


def _pe_factor(plan_cfg: SimConfig, mpc: MPCConfig) -> float:
    """Scale-free plan-cost factor (``MPCConfig.cost_pe_nref``): the plan
    model's field energy carries a factor n (its mode sums scale with the
    particle count), so the PE term is multiplied by nref/n before weighting
    — one ``w_input`` then balances field vs drive at every environment N
    AND every plan fidelity n. Exactly 1.0 at the reference/bench scale
    (nref = n = 5000), so all N=5000 gated results are unchanged."""
    if mpc.cost_pe_nref is None:
        return 1.0
    return float(mpc.cost_pe_nref) / float(plan_cfg.n_particles)


def _reduced_model(grid: Grid, cfg: SimConfig, mpc: MPCConfig, dtype=jnp.float32):
    """Static half of the multi-fidelity reduction: (plan_grid, plan_cfg).

    Shape-only — computable once per configuration (no state involved), so
    sharded-planner factories (:mod:`plasma_control_tpu.parallel.pic_shard`)
    can build their cost closures ahead of the per-solve path.
    """
    plan_cfg = cfg
    plan_grid = grid
    if mpc.plan_particles is not None and mpc.plan_particles < cfg.n_particles:
        stride = max(1, cfg.n_particles // mpc.plan_particles)
        n_eff = -(-cfg.n_particles // stride)
        plan_cfg = dataclasses.replace(plan_cfg, n_particles=n_eff)
    if mpc.plan_mesh is not None and mpc.plan_mesh < cfg.n_mesh:
        plan_cfg = dataclasses.replace(plan_cfg, n_mesh=mpc.plan_mesh)
        plan_grid = _grid_cache(mpc.plan_mesh, cfg.length, dtype)
    return plan_grid, plan_cfg


def _reduce_state(state: PlasmaState, cfg: SimConfig, mpc: MPCConfig) -> PlasmaState:
    """Dynamic half of the reduction: strided particle subsample (preserving
    the beam-ordering mixture proportions of the initial distributions,
    `dist.py:78-97,160-183`)."""
    if mpc.plan_particles is not None and mpc.plan_particles < cfg.n_particles:
        stride = max(1, cfg.n_particles // mpc.plan_particles)
        return PlasmaState(state.x[::stride], state.v[::stride])
    return state


def _plan_model(state: PlasmaState, grid: Grid, cfg: SimConfig, mpc: MPCConfig):
    """Reduced planning model (multi-fidelity MPC).

    Subsamples particles with a stride and optionally coarsens the mesh.
    Returns (plan_state, plan_grid, plan_cfg).
    """
    plan_grid, plan_cfg = _reduced_model(grid, cfg, mpc, state.x.dtype)
    return _reduce_state(state, cfg, mpc), plan_grid, plan_cfg


def _plan_frac(cfg: SimConfig, mpc: MPCConfig) -> float:
    """ACTUAL planned-particle fraction n_eff/N under the stride arithmetic
    of :func:`_reduce_state` (stride = N // plan_particles, n_eff =
    ceil(N/stride)) — NOT plan_particles/N. The two differ whenever
    plan_particles does not divide N, and for plan_particles in (N/2, N]
    the stride is 1 and planning is exactly full fidelity (frac = 1.0, so
    the guard and the host check are statically no-ops)."""
    n = cfg.n_particles
    if mpc.plan_particles is None or mpc.plan_particles >= n:
        return 1.0
    stride = max(1, n // mpc.plan_particles)
    n_eff = -(-n // stride)
    return min(n_eff / n, 1.0)


def _fidelity_ratio(
    x: jax.Array, cfg: SimConfig, ctrl: ControlConfig, mpc: MPCConfig
) -> jax.Array:
    """On-device coherent-vs-injected-noise ratio of subsampled planning.

    The traced core of :func:`plan_fidelity_check` (same statistics, jnp ops,
    no host sync) so the guard can run inside a compiled solve — one
    O(N*Km) mode-sum pass over the FULL state, negligible next to the K x H
    candidate rollouts. See plan_fidelity_check's docstring for the physics.
    """
    n = cfg.n_particles
    km = max(int(mpc.plan_modes), ctrl.max_mode)
    dtype = x.dtype
    k = (2.0 * jnp.pi / cfg.length) * jnp.arange(1, km + 1, dtype=dtype)
    t = (2.0 * jnp.pi / cfg.length) * jnp.ravel(x)
    c, s = _mode_sums(jnp.cos(t), jnp.sin(t), km)
    modal = (cfg.n0**2 / n) * (c * c + s * s) / (k * k)
    floor_full = cfg.n0**2 / (k * k)
    frac = _plan_frac(cfg, mpc)
    coherent = frac * jnp.sum(jnp.maximum(modal - floor_full, 0.0))
    injected = sum(
        cfg.n0**2 * (1.0 - frac) / (2.0 * math.pi * m / cfg.length) ** 2
        for m in range(1, km + 1)
    )
    return coherent / max(injected, 1e-30)


def plan_fidelity_check(
    state: PlasmaState, cfg: SimConfig, ctrl: ControlConfig, mpc: MPCConfig
) -> dict:
    """Is subsampled planning (``mpc.plan_particles < N``) safe at this state?

    Subsampling n of N particles injects *unscreened* sampling noise into the
    planning model's low Fourier modes: per mode, added energy
    ``n0^2 (1 - n/N) / k_m^2`` in plan-model field-energy units (both
    quadratures of the hypergeometric variance of the subsampled mode sums:
    E[c^2 + s^2] = n(1 - n/N) for the noise part, times the plan PE scale
    n0^2/n), while the real plasma's low-mode noise is Debye-screened far
    below that. When the coherent signal the controller should act on is not
    well above this injected floor, the planner "profits" in-model by
    cancelling the subsample's noise phases — which do not exist in the real
    plasma — and the applied drive pumps the real field instead of damping
    it. Measured (2026-08-19, bench scale bump-on-tail N=5000, plan 1024 and
    2048): tail PE 270-330 controlled vs 33 uncontrolled; full-fidelity
    planning at the same state suppresses to ~11-20
    (experiments/bot_bench_scale_debug.py, DEVNOTES). A growing two-stream
    becomes immune once its coherent field (~1000) dwarfs the floor; at a
    QUIET t=0 the check is conservative by construction (the coherent signal
    only appears as the instability grows).

    The comparison is done consistently in the PLAN model's frame: the
    coherent modal energy of the full state (its measured modal PE minus its
    own Poisson floor ``n0^2/k^2``) appears in the subsampled model
    attenuated by n/N (plan PE scale n0^2/n times the (n/N)^2-scaled mode
    sums).

    Returns {"coherent_pe", "injected_noise_pe", "ratio", "safe"}; ``safe``
    means plan-frame coherent >= ``mpc.fidelity_guard_ratio`` x injected
    (the same threshold the per-solve dynamic guard uses, so the t=0
    diagnostic and the runtime behavior cannot disagree). The planned
    fraction uses the ACTUAL stride arithmetic of the reduction
    (:func:`_plan_frac`), not plan_particles/N. Cheap (one pass over the
    full state); called by run_mpc at t=0 when a particle reduction is
    requested.
    """
    import numpy as np

    n = cfg.n_particles
    km = max(int(mpc.plan_modes), ctrl.max_mode)
    k = (2.0 * np.pi / cfg.length) * np.arange(1, km + 1)
    t = (2.0 * np.pi / cfg.length) * np.asarray(jnp.ravel(state.x))
    c = np.stack([np.sum(np.cos(m * t)) for m in range(1, km + 1)])
    s = np.stack([np.sum(np.sin(m * t)) for m in range(1, km + 1)])
    # full-state modal field energy minus its own Poisson shot floor
    # (E[c^2+s^2] = N for iid-uniform positions) = coherent part
    modal = (cfg.n0**2 / n) * (c * c + s * s) / (k * k)
    floor_full = cfg.n0**2 / (k * k)
    frac = _plan_frac(cfg, mpc)
    # plan-frame: coherent attenuates by n/N; injected noise is (1-n/N)-scaled
    coherent = frac * float(np.sum(np.maximum(modal - floor_full, 0.0)))
    injected = float(np.sum(cfg.n0**2 * (1.0 - frac) / (k * k)))
    ratio = coherent / injected if injected > 0 else float("inf")
    return {
        "coherent_pe": coherent,
        "injected_noise_pe": injected,
        "ratio": ratio,
        "safe": ratio >= mpc.fidelity_guard_ratio,
    }


_PLAN_GRIDS = {}
_PLAN_ACTS = {}


def _grid_cache(n_mesh: int, length: float, dtype):
    from ..ops.grid import make_grid as _make_grid

    key = (n_mesh, float(length), jnp.dtype(dtype).name)
    if key not in _PLAN_GRIDS:
        _PLAN_GRIDS[key] = _make_grid(n_mesh, length, dtype=dtype)
    return _PLAN_GRIDS[key]


def _actuator_cache(length: float, n_mesh: int, max_mode: int, dtype):
    from .actuator import make_actuator as _make_actuator

    key = (float(length), n_mesh, max_mode, jnp.dtype(dtype).name)
    if key not in _PLAN_ACTS:
        _PLAN_ACTS[key] = _make_actuator(length, n_mesh, max_mode, dtype=dtype)
    return _PLAN_ACTS[key]


class MPCOutput(NamedTuple):
    final_state: PlasmaState
    field_energy: jax.Array  # (T,) PE after each applied step
    kinetic: jax.Array  # (T,)
    hamiltonian: jax.Array  # (T,)
    coeffs: jax.Array  # (T, 2K) applied packed coefficients
    input_energy: jax.Array  # (T,)
    plan_cost: jax.Array  # (T,) best candidate cost at each solve
    final_mean: jax.Array  # (H, 2K) shifted nominal after the last solve


def _reject_grid_pallas_kernel(plan_kernel: str) -> None:
    """The grid planner has only the XLA path; the one planning kernel is
    the spectral whole-horizon kernel (plan_model="spectral")."""
    if plan_kernel == "fused":
        raise ValueError(
            f"plan_kernel={plan_kernel!r}: the grid-planner has no kernel "
            "of its own. Use plan_kernel='xla'/'auto' for the grid model, or "
            "plan_model='spectral' with plan_kernel='fused' for the "
            "whole-horizon spectral kernel."
        )


def _step_and_pe(
    state: PlasmaState,
    e_ext: jax.Array,
    grid: Grid,
    cfg: SimConfig,
    exact: bool,
    plan_integrator: str = "env",
    plan_kernel: str = "auto",
):
    """One planning step returning (state, PE).

    With ``plan_integrator="leapfrog"`` the candidate dynamics use a
    position-Verlet drift-kick-drift split — ONE deposit+solve+gather
    pipeline per step instead of Yoshida-4's three (2nd-order symplectic;
    candidate *ranking* is insensitive to the difference at dt=0.1). With
    ``exact=False`` the PE additionally reuses the kick-stage field instead
    of re-solving at the exact post-step positions."""
    from ..ops.deposit import deposit as _dep, gather as _gat
    from ..ops.fields import electric_energy, solve_e_mesh
    from ..ops.integrate import yoshida4_coefficients

    _reject_grid_pallas_kernel(plan_kernel)
    if plan_integrator == "leapfrog":
        dt = cfg.clamped_dt()
        x = state.x + 0.5 * dt * state.v
        n = _dep(x, grid, n0=cfg.n0, kind=cfg.interpol, method=cfg.deposit_method)
        e_self = solve_e_mesh(n, grid, cfg.n0)
        accel = -_gat(e_self + e_ext, x, grid, kind=cfg.interpol, method=cfg.deposit_method)
        v = state.v + dt * accel
        x = jnp.mod(x + 0.5 * dt * v, cfg.length)
        if exact:
            n2 = _dep(x, grid, n0=cfg.n0, kind=cfg.interpol, method=cfg.deposit_method)
            e_self = solve_e_mesh(n2, grid, cfg.n0)
        pe = electric_energy(e_self, grid, cfg.n_particles)
        return PlasmaState(x, v), pe

    if cfg.integrator != "yoshida4" or exact:
        new = step(state, grid, cfg, e_ext)
        pe, _ = _energies(new, grid, cfg)
        return new, pe

    cs, ds = yoshida4_coefficients()
    dt = cfg.clamped_dt()
    x, v = state.x, state.v
    x = x + cs[0] * dt * v
    e_self = None
    for c, d in zip(cs[1:], ds):
        n = _dep(x, grid, n0=cfg.n0, kind=cfg.interpol, method=cfg.deposit_method)
        e_self = solve_e_mesh(n, grid, cfg.n0)
        accel = -_gat(e_self + e_ext, x, grid, kind=cfg.interpol, method=cfg.deposit_method)
        v = v + d * dt * accel
        x = x + c * dt * v
    pe = electric_energy(e_self, grid, cfg.n_particles)
    return PlasmaState(jnp.mod(x, cfg.length), v), pe


def knot_noise(key, n_candidates, horizon, dim, n_knots, dtype=jnp.float32):
    """(K, H, D) unit-variance noise interpolated from ``n_knots`` samples.

    Samples iid normals at n_knots points along the horizon and linearly
    interpolates; each step's marginal variance is renormalized to 1 (linear
    interpolation of iid normals has variance (1-f)^2 + f^2 < 1 between
    knots). Candidates are piecewise-linear in t — smooth by construction —
    and the effective search dimension drops from H*D to n_knots*D.
    """
    eps = jax.random.normal(key, (n_candidates, n_knots, dim), dtype=dtype)
    t = jnp.linspace(0.0, n_knots - 1.0, horizon)
    i0 = jnp.clip(jnp.floor(t).astype(jnp.int32), 0, max(n_knots - 2, 0))
    f = (t - i0)[None, :, None].astype(dtype)
    out = (1.0 - f) * eps[:, i0] + f * eps[:, jnp.minimum(i0 + 1, n_knots - 1)]
    return out / jnp.sqrt((1.0 - f) ** 2 + f**2)


def _use_spectral_fused(
    plan_kernel: str, n_particles: int, n_candidates: int, backend: str
) -> bool:
    """Dispatch policy for the whole-horizon spectral GPU kernel.

    "auto" selects it on the GPU where the kernel's flat scratch index fits,
    and the XLA scan elsewhere; "fused" forces it and is a config error off
    the GPU or outside that limit; "xla" never selects it. Costs agree with
    the XLA scan to fp32 reassociation (tests/test_mpc.py::TestFusedSpectral).
    """
    from ..ops.pallas.spectral_horizon import spectral_horizon_supported

    supported = spectral_horizon_supported(n_particles, n_candidates)
    if plan_kernel == "fused":
        if backend != "gpu":
            raise ValueError(
                "plan_kernel='fused' (spectral horizon kernel) runs only on "
                f"the GPU (backend is {backend!r}); use 'auto' or 'xla'"
            )
        if not supported:
            raise ValueError(
                "plan_kernel='fused' (spectral horizon kernel) needs "
                f"K*N < 2**31 (got K={n_candidates}, N={n_particles})"
            )
        return True
    return plan_kernel == "auto" and backend == "gpu" and supported


def _spectral_kernel_costs(state, coeff_seqs, cfg, mpc, actuator,
                           twin_target=None, interpret=False):
    """(K, H, 2K) candidates -> (K,) costs through the whole-horizon kernel:
    the same cost assembly as :func:`_horizon_cost_spectral` over the
    kernel's (K, H) field energies. ``interpret=True`` runs the kernel in
    the Pallas interpreter (CPU tests)."""
    from ..ops.pallas.spectral_horizon import _use_rot, fused_spectral_horizon

    ka = actuator.max_mode
    km = max(int(mpc.plan_modes), ka)
    dtype = coeff_seqs.dtype

    def pad(u_half):  # (..., ka) -> (..., km), as in _horizon_cost_spectral
        return jnp.concatenate(
            [u_half, jnp.zeros(u_half.shape[:-1] + (km - ka,), dtype)], axis=-1
        )

    pe = fused_spectral_horizon(
        state.x, state.v,
        pad(coeff_seqs[..., :ka]), pad(coeff_seqs[..., ka:]),
        length=cfg.length, dt=cfg.clamped_dt(), n0=cfg.n0,
        n_particles=cfg.n_particles,
        rot=_use_rot(cfg.clamped_dt(), cfg.length,
                     coeff_seqs.shape[0] * cfg.n_particles, mpc.spectral_drift),
        interpret=interpret,
        twin_c=None if twin_target is None else twin_target[0],
        twin_s=None if twin_target is None else twin_target[1],
    )  # (K, H) exact post-drift spectral-model PE (corrected if twinned)
    pe = _pe_factor(cfg, mpc) * pe
    ie = actuator.input_energy(coeff_seqs)  # (K, H)
    total = _add_terminal(jnp.sum(mpc.w_field * pe + mpc.w_input * ie, axis=-1), pe, mpc)
    return _finite_or_huge(total)


def _finite_or_huge(total: jax.Array) -> jax.Array:
    """NaN/divergence guard (reference analogue: `src/util.py:3-14`): diverged
    candidates get an effectively-infinite cost instead of poisoning stats."""
    return jnp.where(jnp.isfinite(total), total, jnp.asarray(3.4e38, total.dtype))


def _add_terminal(total: jax.Array, pes: jax.Array, mpc: MPCConfig) -> jax.Array:
    """Add the configured terminal tail cost. ``pes``: (..., H) planning PE.

    ``terminal_mode="const"``: ``w_terminal * PE_H`` (flat weight).
    ``"growth"``: per-candidate geometric extrapolation — charge
    ``terminal_steps`` more steps of running field cost at the candidate's
    own measured end-of-horizon growth ratio ``r = PE_H / PE_{H-1}``
    (clipped; see :class:`MPCConfig`). The two compose (both added);
    no-op when neither is active. Works on every planning path: the
    per-step PEs are already computed, so the tail estimate is free.
    """
    pe_h = pes[..., -1]
    if mpc.terminal_mode == "growth" and pes.shape[-1] >= 2:
        r = jnp.clip(pes[..., -1] / (pes[..., -2] + 1e-30), 0.7, 1.3)
        t = int(mpc.terminal_steps)
        # sum_{i=1..T} r^i, guarded at the removable r=1 singularity
        geom = jnp.where(
            jnp.abs(r - 1.0) < 1e-6,
            jnp.asarray(float(t), r.dtype),
            r * (1.0 - r**t) / jnp.where(jnp.abs(1.0 - r) < 1e-6, 1.0, 1.0 - r),
        )
        total = total + mpc.w_field * pe_h * geom
    if mpc.w_terminal:
        total = total + mpc.w_terminal * pe_h
    return total


def _horizon_cost_kdk(
    state: PlasmaState,
    coeff_seq: jax.Array,  # (H, 2K)
    grid: Grid,
    cfg: SimConfig,
    mpc: MPCConfig,
    actuator: FourierActuator,
) -> jax.Array:
    """Velocity-Verlet (kick-drift-kick) candidate rollout cost.

    The adjoint splitting of the ``"leapfrog"`` drift-kick-drift step (both
    2nd-order symplectic, equally good at *ranking* candidates). Its
    advantage is structural: the self-consistent field at the step boundary
    is shared between kick2 of step t and kick1 of step t+1, so one
    deposit+solve pipeline per step suffices and the post-step PE entering
    the cost is exact by construction (``exact_cost_energy`` is implied —
    there is no cheaper surrogate in this scheme).

    Implementation: the two half-kicks that straddle each step boundary are
    *merged*. Tracking only the half-step (staggered) velocities ``vh``,

        vh_{t+1} = vh_t + dt/2 * (a2_t + a1_{t+1})
                 = vh_t - dt/2 * gather(w(x_{t+1}), 2*E_self + u_t + u_{t+1})

    by linearity of the gather in the field — ONE gather per step instead of
    two (2 CIC weight evaluations/step total vs 3 on the DKD-exact XLA path).
    The integer-step velocities are never materialized; the horizon cost only
    needs the field energies, which are exact. Candidate trajectories are
    bit-identical to explicit KDK up to fp reassociation of the two kicks.
    """
    from ..ops.deposit import deposit as _dep, gather as _gat, shape_weights_dense
    from ..ops.fields import electric_energy, solve_e_mesh

    dt = cfg.clamped_dt()
    e_ext_seq = actuator.compute_e_packed(coeff_seq)  # (H, M)
    # u_t + u_{t+1} for each boundary; the last entry is arbitrary (the final
    # merged kick can't change any PE entering the cost) — pad with the last.
    e_pair_seq = jnp.concatenate([e_ext_seq[1:], e_ext_seq[-1:]]) + e_ext_seq
    norm = cfg.n0 * cfg.length / cfg.n_particles / grid.dx

    def fields_and_kick(x, e_add):
        """(E_self, -gather(E_self*scale + e_add, x)) with ONE weight eval.

        The deposit at x and the gather at x use the same shape-function
        weights; the (N, M) tile is shared explicitly rather than trusting
        XLA to CSE across the two ops."""
        if cfg.deposit_method == "dense":
            w = shape_weights_dense(jnp.mod(x, cfg.length), grid, cfg.interpol)
            e_self = solve_e_mesh(jnp.sum(w, axis=0) * norm, grid, cfg.n0)
            return e_self, lambda scale: -jnp.matmul(
                w, scale * e_self + e_add, precision=jax.lax.Precision.HIGHEST)
        n = _dep(x, grid, n0=cfg.n0, kind=cfg.interpol, method=cfg.deposit_method)
        e_self = solve_e_mesh(n, grid, cfg.n0)
        return e_self, lambda scale: -_gat(
            scale * e_self + e_add, x, grid, kind=cfg.interpol, method=cfg.deposit_method
        )

    pe_f = _pe_factor(cfg, mpc)

    def body(carry, inp):
        x, vh = carry
        e_pair, u = inp
        x2 = jnp.mod(x + dt * vh, cfg.length)
        e2, kick = fields_and_kick(x2, e_pair)
        vh2 = vh + 0.5 * dt * kick(2.0)
        pe = pe_f * electric_energy(e2, grid, cfg.n_particles)
        c = mpc.w_field * pe + mpc.w_input * actuator.input_energy(u)
        return (x2, vh2), (c, pe)

    _, kick0 = fields_and_kick(state.x, e_ext_seq[0])
    vh0 = state.v + 0.5 * dt * kick0(1.0)
    _, (costs, pes) = jax.lax.scan(body, (state.x, vh0), (e_pair_seq, coeff_seq))
    total = _add_terminal(jnp.sum(costs), pes, mpc)
    return _finite_or_huge(total)


def _mode_basis(x: jax.Array, length: float, n_modes: int):
    """(Km, N) cos/sin basis cos(k_m x), sin(k_m x), k_m = 2 pi m / L.

    Built by the three-term (Chebyshev) recurrence f((h+1)t) = 2cos(t) f(ht)
    - f((h-1)t) — TWO
    transcendental evaluations per particle total, 4 MACs per extra mode —
    laid out modes-major so the particle axis is the contiguous one."""
    t = (2.0 * jnp.pi / length) * x
    c1, s1 = jnp.cos(t), jnp.sin(t)
    twoc = c1 + c1
    cs, ss = [c1], [s1]
    c_pp, s_pp = jnp.ones_like(c1), jnp.zeros_like(s1)
    c_prev, s_prev = c1, s1
    for _ in range(n_modes - 1):
        c_next = twoc * c_prev - c_pp
        s_next = twoc * s_prev - s_pp
        cs.append(c_next)
        ss.append(s_next)
        c_pp, c_prev = c_prev, c_next
        s_pp, s_prev = s_prev, s_next
    return jnp.stack(cs), jnp.stack(ss)


def _mode_sums(c1: jax.Array, s1: jax.Array, n_modes: int):
    """Mode sums c_m = sum_p cos(k_m x_p), s_m = sum_p sin(k_m x_p), m=1..Km.

    Streaming form of ``sum(_mode_basis(x), axis=-1)``: the recurrence runs
    with two live (N,) registers and per-mode scalar reductions, so the
    (Km, N) basis tensor is never materialized (XLA fuses the whole unrolled
    chain into one kernel — the device-memory traffic is just x in, 2*Km
    scalars out).
    """
    twoc = c1 + c1
    cs, ss = [jnp.sum(c1, axis=-1)], [jnp.sum(s1, axis=-1)]
    c_pp, s_pp = jnp.ones_like(c1), jnp.zeros_like(s1)
    c_prev, s_prev = c1, s1
    for _ in range(n_modes - 1):
        c_next = twoc * c_prev - c_pp
        s_next = twoc * s_prev - s_pp
        cs.append(jnp.sum(c_next, axis=-1))
        ss.append(jnp.sum(s_next, axis=-1))
        c_pp, c_prev = c_prev, c_next
        s_pp, s_prev = s_prev, s_next
    return jnp.stack(cs, axis=-1), jnp.stack(ss, axis=-1)


def _mode_eval(c1: jax.Array, s1: jax.Array, pc: jax.Array, ps: jax.Array):
    """sum_m pc[m] cos(k_m x_p) + ps[m] sin(k_m x_p) per particle, streamed.

    Same recurrence as :func:`_mode_sums` with a running (N,) accumulator
    instead of a dot_general — as unrolled multiply-adds it fuses with the
    recurrence and touches device memory only for c1/s1."""
    n_modes = pc.shape[-1]
    twoc = c1 + c1
    acc = pc[..., 0:1] * c1 + ps[..., 0:1] * s1
    c_pp, s_pp = jnp.ones_like(c1), jnp.zeros_like(s1)
    c_prev, s_prev = c1, s1
    for m in range(1, n_modes):
        c_next = twoc * c_prev - c_pp
        s_next = twoc * s_prev - s_pp
        acc = acc + pc[..., m : m + 1] * c_next + ps[..., m : m + 1] * s_next
        c_pp, c_prev = c_prev, c_next
        s_pp, s_prev = s_prev, s_next
    return acc


def _horizon_cost_spectral(
    state: PlasmaState,
    coeff_seq: jax.Array,  # (H, 2K)
    cfg: SimConfig,
    mpc: MPCConfig,
    actuator: FourierActuator,
    twin_target=None,  # optional ((H, Km), (H, Km)) noise-correction targets
) -> jax.Array:
    """Gridless low-mode spectral candidate rollout (``plan_model="spectral"``).

    The planning dynamics drop the mesh entirely: the self-consistent field is
    the truncated Fourier series of the exact point-particle density,

        n_m = (n0/N) sum_p e^{-i k_m x_p},   E_m = i n_m / k_m   (m = 1..Km),

    i.e. the continuum Poisson solve mode-by-mode (the reference's FD
    Laplacian/gradient pair, `/root/reference/src/env/solve.py:28-53` +
    `/root/reference/src/env/util.py:8-26`, converges to exactly this as
    dx -> 0). Deposit and gather both become (Km, N) mode projections —
    O(N*Km) MACs with NO shape-function weights, no scatter, no mesh — a
    1D gridless ("sheet-model") PIC truncated to the Km lowest modes. The
    instabilities under control live in modes 1-3 at the reference scales
    (k_m v_b ~ omega_p => m <= 3 for L=50, v_b=3), so a Km ~ 2-4x above
    max_mode ranks candidates like the full grid dynamics (tested:
    tests/test_mpc.py::test_spectral_planner_preserves_ranking).

    Time stepping is the same merged-half-kick staggered KDK as
    :func:`_horizon_cost_kdk`; the post-drift PE is exact *within the model*:
    PE = (n0^2/N) sum_m (c_m^2 + s_m^2) / k_m^2 with the reference's N/L
    rescale (`/root/reference/src/env/util.py:129-131`) already folded in.
    """
    n_p = cfg.n_particles
    ka = actuator.max_mode
    km = max(int(mpc.plan_modes), ka)  # actuator modes always inside the model
    dt = cfg.clamped_dt()
    dtype = state.x.dtype
    k = (2.0 * jnp.pi / cfg.length) * jnp.arange(1, km + 1, dtype=dtype)
    g = 2.0 * cfg.n0 / (n_p * k)  # self-field coefficient scale
    inv_k2 = 1.0 / (k * k)
    pe_scale = cfg.n0**2 / n_p * _pe_factor(cfg, mpc)

    def pad(u_half):  # (..., ka) -> (..., km)
        return jnp.concatenate(
            [u_half, jnp.zeros(u_half.shape[:-1] + (km - ka,), dtype)], axis=-1
        )

    u_c, u_s = pad(coeff_seq[..., :ka]), pad(coeff_seq[..., ka:])
    # u_t + u_{t+1} at each step boundary (last pad arbitrary, as in the grid
    # KDK path: the final merged kick cannot change any PE entering the cost)
    pair_c = jnp.concatenate([u_c[1:], u_c[-1:]]) + u_c
    pair_s = jnp.concatenate([u_s[1:], u_s[-1:]]) + u_s

    two_pi_over_l = 2.0 * jnp.pi / cfg.length

    def body(carry, inp):
        x, vh = carry
        if twin_target is None:
            pc_ext, ps_ext, u = inp
        else:
            # per-step noise-correction targets (1 - lambda_m)(c0, s0)(t):
            # the candidate is charged for its phasor RELATIVE to the
            # zero-drive twin's noise fraction (MPCConfig.plan_correction)
            pc_ext, ps_ext, u, tc_t, ts_t = inp
        x2 = jnp.mod(x + dt * vh, cfg.length)
        t = two_pi_over_l * x2
        c1, s1 = jnp.cos(t), jnp.sin(t)
        c, s = _mode_sums(c1, s1, km)  # (Km,) mode sums
        # E_self(x) = sum_m g_m s_m cos(k_m x) - g_m c_m sin(k_m x)
        pc = 2.0 * (g * s) + pc_ext
        ps = 2.0 * (-g * c) + ps_ext
        accel = -_mode_eval(c1, s1, pc, ps)
        vh2 = vh + 0.5 * dt * accel
        if twin_target is None:
            pe = pe_scale * jnp.sum((c * c + s * s) * inv_k2, axis=-1)
        else:
            dc, ds = c - tc_t, s - ts_t
            pe = pe_scale * jnp.sum((dc * dc + ds * ds) * inv_k2, axis=-1)
        cost = mpc.w_field * pe + mpc.w_input * actuator.input_energy(u)
        return (x2, vh2), (cost, pe)

    # initial (un-merged) half-kick at the current positions
    t0 = two_pi_over_l * state.x
    c1_0, s1_0 = jnp.cos(t0), jnp.sin(t0)
    c0, s0 = _mode_sums(c1_0, s1_0, km)
    pc0 = g * s0 + u_c[0]
    ps0 = -(g * c0) + u_s[0]
    vh0 = state.v + 0.5 * dt * (-_mode_eval(c1_0, s1_0, pc0, ps0))
    inputs = (pair_c, pair_s, coeff_seq)
    if twin_target is not None:
        inputs = inputs + (twin_target[0].astype(dtype), twin_target[1].astype(dtype))
    _, (costs, pes) = jax.lax.scan(body, (state.x, vh0), inputs)
    total = _add_terminal(jnp.sum(costs), pes, mpc)
    return _finite_or_huge(total)


def _twin_mode_traj(state: PlasmaState, cfg: SimConfig, mpc: MPCConfig, km: int):
    """Zero-drive TWIN of the spectral plan rollout: the (H, Km) mode-sum
    trajectory of the plan state under NO external drive, with exactly the
    same discretization as the candidate rollouts (merged-half-kick staggered
    KDK, same initial un-merged half kick, same post-drift sampling points) —
    common random numbers by construction: a zero-coefficient candidate
    reproduces this trajectory bit-for-bit on the XLA path, so differencing
    cancels the subsample's sampling noise exactly. See
    :class:`MPCConfig.plan_correction`."""
    n_p = cfg.n_particles
    dt = cfg.clamped_dt()
    dtype = state.x.dtype
    k = (2.0 * jnp.pi / cfg.length) * jnp.arange(1, km + 1, dtype=dtype)
    g = 2.0 * cfg.n0 / (n_p * k)
    two_pi_over_l = 2.0 * jnp.pi / cfg.length

    def body(carry, _):
        x, vh = carry
        x2 = jnp.mod(x + dt * vh, cfg.length)
        t = two_pi_over_l * x2
        c1, s1 = jnp.cos(t), jnp.sin(t)
        c, s = _mode_sums(c1, s1, km)
        vh2 = vh + 0.5 * dt * (-_mode_eval(c1, s1, 2.0 * (g * s), 2.0 * (-(g * c))))
        return (x2, vh2), (c, s)

    t0 = two_pi_over_l * state.x
    c1_0, s1_0 = jnp.cos(t0), jnp.sin(t0)
    c0, s0 = _mode_sums(c1_0, s1_0, km)
    vh0 = state.v + 0.5 * dt * (-_mode_eval(c1_0, s1_0, g * s0, -(g * c0)))
    _, (cs, ss) = jax.lax.scan(body, (state.x, vh0), None, length=mpc.horizon)
    return cs, ss  # each (H, Km)


def twin_targets(
    full_x: jax.Array,
    plan_state: PlasmaState,
    plan_cfg: SimConfig,
    full_cfg: SimConfig,
    ctrl: ControlConfig,
    mpc: MPCConfig,
):
    """Noise-correction targets for subsampled spectral planning, or None.

    Returns ``(tc, ts)`` of shape (H, Km) each: the per-mode noise fraction
    ``rho_m = 1 - lambda_m`` times the zero-drive twin's mode-sum trajectory.
    ``lambda_m`` is the Wiener shrinkage coefficient of the subsample's mode
    phasor estimated from the FULL state once per solve: with coherent
    signal power ``sig2_m = max(|C_m|^2 + |S_m|^2 - N, 0)`` (the full-state
    modal power minus its own Poisson shot floor ``E[C^2+S^2] = N`` for
    random phases), subsample fraction r = n/N and subsample noise power
    n(1-r) (sampling without replacement),

        lambda_m = r^2 sig2_m / (r^2 sig2_m + n (1 - r))  in [0, 1).

    Inactive (returns None) at full fidelity or when
    ``mpc.plan_correction != "twin"``; requires the spectral plan model
    (the grid planner has no per-mode phasor to correct — ``plan`` raises).
    """
    if mpc.plan_correction != "twin" or _plan_frac(full_cfg, mpc) >= 1.0:
        return None
    km = max(int(mpc.plan_modes), ctrl.max_mode)
    dtype = plan_state.x.dtype
    t = (2.0 * jnp.pi / full_cfg.length) * jnp.ravel(full_x).astype(dtype)
    cf, sf = _mode_sums(jnp.cos(t), jnp.sin(t), km)
    n_full = float(full_cfg.n_particles)
    n_plan = float(plan_cfg.n_particles)
    r = n_plan / n_full
    sig2 = jnp.maximum(cf * cf + sf * sf - n_full, 0.0)
    lam = (r * r * sig2) / (r * r * sig2 + n_plan * (1.0 - r))
    rho = 1.0 - lam  # (Km,) noise fraction per mode
    c0, s0 = _twin_mode_traj(plan_state, plan_cfg, mpc, km)
    return rho * c0, rho * s0


def _horizon_cost(
    state: PlasmaState,
    coeff_seq: jax.Array,  # (H, 2K)
    grid: Grid,
    cfg: SimConfig,
    mpc: MPCConfig,
    actuator: FourierActuator,
    twin_target=None,
) -> jax.Array:
    """Cost of one candidate control sequence over the planning horizon."""
    if mpc.plan_model == "spectral":
        return _horizon_cost_spectral(state, coeff_seq, cfg, mpc, actuator,
                                      twin_target=twin_target)
    if mpc.plan_integrator == "kdk":
        return _horizon_cost_kdk(state, coeff_seq, grid, cfg, mpc, actuator)

    pe_f = _pe_factor(cfg, mpc)

    def body(carry: PlasmaState, u):
        e_ext = actuator.compute_e_packed(u)
        new, pe = _step_and_pe(
            carry, e_ext, grid, cfg, mpc.exact_cost_energy,
            mpc.plan_integrator, mpc.plan_kernel,
        )
        pe = pe_f * pe
        c = mpc.w_field * pe + mpc.w_input * actuator.input_energy(u)
        return new, (c, pe)

    _, (costs, pes) = jax.lax.scan(body, state, coeff_seq)
    total = _add_terminal(jnp.sum(costs), pes, mpc)
    return _finite_or_huge(total)


def candidate_costs(state, coeff_seqs, grid, cfg, mpc, actuator,
                    twin_target=None):
    """(K, H, 2K) candidates -> (K,) costs, batched rollout.

    ``twin_target``: optional ((H, Km), (H, Km)) noise-correction targets
    from :func:`twin_targets` (``MPCConfig.plan_correction="twin"``) —
    spectral plan model only; threaded through chunking and into the
    kernel's corrected variant.

    With the spectral plan model on the GPU the whole K x H block dispatches
    to one whole-horizon kernel launch (:func:`_use_spectral_fused`);
    otherwise a vmapped per-candidate scan on the XLA path.

    ``mpc.plan_chunk`` bounds the live working set: the K candidates are
    evaluated in sequential chunks of that size (``lax.map`` over chunks of
    the batched evaluator), so peak memory is ``plan_chunk x N`` planes
    instead of ``K x N``. Required for very-large-N full-fidelity planning
    on one device — at N=1e6 even K=64 holds several 256 MB (K, N) planes
    live at once on the XLA path; chunked
    evaluation is sequential over chunks, so prefer the largest chunk that
    fits. Semantics-neutral by construction (same per-candidate program).
    A candidate block that is not a multiple of the chunk is PADDED up to
    one with copies of candidate 0 and the padded costs discarded — the
    chunk size requested is always the chunk size launched (an earlier
    clamp-to-largest-divisor silently serialized divisor-poor blocks to
    chunk=1). Under shard_map this function sees the per-device
    LOCAL block (K / n_devices); padding composes there too (each device
    pads its own block).
    """
    if mpc.plan_chunk is not None and coeff_seqs.shape[0] > mpc.plan_chunk:
        k_total = coeff_seqs.shape[0]
        chunk = int(mpc.plan_chunk)
        k_pad = -(-k_total // chunk) * chunk
        if k_pad != k_total:
            pad = jnp.broadcast_to(
                coeff_seqs[:1], (k_pad - k_total,) + coeff_seqs.shape[1:]
            )
            coeff_seqs = jnp.concatenate([coeff_seqs, pad])
        inner = dataclasses.replace(mpc, plan_chunk=None)
        chunks = coeff_seqs.reshape(k_pad // chunk, chunk,
                                    *coeff_seqs.shape[1:])
        out = jax.lax.map(
            lambda c: candidate_costs(state, c, grid, cfg, inner, actuator,
                                      twin_target=twin_target),
            chunks,
        )
        return out.reshape(k_pad)[:k_total]
    if twin_target is not None and mpc.plan_model != "spectral":
        raise ValueError(
            "plan_correction='twin' requires plan_model='spectral' — the "
            "grid planner has no per-mode phasor to correct"
        )
    if mpc.plan_model == "spectral" and _use_spectral_fused(
        mpc.plan_kernel, cfg.n_particles, coeff_seqs.shape[0], jax.default_backend()
    ):
        return _spectral_kernel_costs(state, coeff_seqs, cfg, mpc, actuator,
                                      twin_target=twin_target)
    if mpc.plan_model == "grid":
        _reject_grid_pallas_kernel(mpc.plan_kernel)
    return jax.vmap(
        lambda u: _horizon_cost(state, u, grid, cfg, mpc, actuator,
                                twin_target=twin_target)
    )(coeff_seqs)


def _gradient_refine(state, mean, grid, cfg, ctrl, mpc, actuator):
    """Local trajectory optimization: Adam on the horizon cost wrt the
    nominal control sequence, with gradients flowing *through the PIC
    dynamics* (differentiable simulation; each step rematerialized to bound
    memory). This is the deterministic 'QP-correction' refinement layered on
    the sampling solve (SURVEY §7)."""

    pe_f = _pe_factor(cfg, mpc)

    def cost_fn(u):
        def body(carry: PlasmaState, ut):
            e_ext = actuator.compute_e_packed(ut)
            new = jax.checkpoint(lambda s, e: step(s, grid, cfg, e))(carry, e_ext)
            pe, _ = _energies(new, grid, cfg)
            pe = pe_f * pe
            return new, (mpc.w_field * pe + mpc.w_input * actuator.input_energy(ut), pe)

        _, (costs, pes) = jax.lax.scan(body, state, u)
        return _add_terminal(jnp.sum(costs), pes, mpc)

    import optax

    tx = optax.adam(mpc.grad_lr)

    def one_iter(carry, _):
        u, opt = carry
        _, g = jax.value_and_grad(cost_fn)(u)
        g = jnp.where(jnp.isfinite(g), g, 0.0)  # divergence guard
        upd, opt = tx.update(g, opt, u)
        u = jnp.clip(optax.apply_updates(u, upd), ctrl.coeff_min, ctrl.coeff_max)
        return (u, opt), None

    (refined, _), _ = jax.lax.scan(one_iter, (mean, tx.init(mean)), None, length=mpc.n_grad_iters)
    # keep the refinement only if it actually lowered the cost
    better = cost_fn(refined) < cost_fn(mean)
    return jnp.where(better, refined, mean)


def _plan_impl(
    state: PlasmaState,
    mean: jax.Array,
    sigma: jax.Array,
    key: jax.Array,
    grid: Grid,
    cfg: SimConfig,
    ctrl: ControlConfig,
    mpc: MPCConfig,
    actuator: FourierActuator,
    costs_fn,
    candidate_sharding=None,
):
    """Full-featured MPC solve body over an injectable candidate scorer.

    ``state``/``grid``/``cfg``/``actuator`` are the (possibly fidelity-
    reduced) PLANNING model; ``costs_fn(state, cand) -> (K,) costs`` scores
    the candidate block — the default is :func:`candidate_costs` on this
    device, and the sharded planners inject a ``shard_map`` scorer built once
    per mesh (:func:`plasma_control_tpu.parallel.pic_shard.make_sharded_plan`)
    so every sampling/seeding/terminal/CEM feature works identically single-
    and multi-chip.
    """
    h, d = mean.shape

    if mpc.seed_feedback and mpc.n_candidates >= 2:
        # phase-conjugate expert action at the current (plan) state, held
        # over the horizon (`run_feedback.py:130-143` law as a seed)
        from ..control.feedback import feedback_coefficients
        from ..ops.deposit import deposit as _dep
        from ..ops.fields import solve_e_mesh as _solve

        dens = _dep(state.x, grid, n0=cfg.n0, kind=cfg.interpol, method=cfg.deposit_method)
        fa, fb_ = feedback_coefficients(_solve(dens, grid, cfg.n0), ctrl.max_mode)
        fb_seq = jnp.broadcast_to(jnp.concatenate([fa, fb_]), (h, d)).astype(mean.dtype)
    else:
        fb_seq = None

    def _colored(eps):
        if mpc.smooth_noise <= 0.0:
            return eps
        beta = jnp.asarray(mpc.smooth_noise, eps.dtype)
        scale = jnp.sqrt(1.0 - beta**2)

        def ar(carry, w):
            nxt = beta * carry + scale * w
            return nxt, nxt

        # scan along the horizon axis; first sample keeps unit variance
        eps_t = jnp.moveaxis(eps, 1, 0)  # (H, K, D)
        _, out = jax.lax.scan(ar, eps_t[0], eps_t[1:])
        return jnp.moveaxis(jnp.concatenate([eps_t[:1], out]), 0, 1)

    def _base_noise(k, n):
        """Unit-variance perturbations: AR(1)-colored, knot-interpolated, or white.

        An explicit ``smooth_noise > 0`` wins over the knot default: the AR(1)
        option is only ever set deliberately (its default is 0), whereas
        ``n_knots=3`` is the silent MPCConfig default — honoring the explicit
        setting avoids silently ignoring it. ``n_knots`` falsy (None/0) or
        >= horizon falls back to white noise."""
        if mpc.smooth_noise <= 0.0 and mpc.n_knots and 1 <= mpc.n_knots < h:
            return knot_noise(k, n, h, d, mpc.n_knots, mean.dtype)
        return _colored(jax.random.normal(k, (n, h, d), dtype=mean.dtype))

    def draw(k):
        if mpc.antithetic and mpc.n_candidates >= 2:
            # mirrored pairs (eps, -eps): first-order terms of the local cost
            # expansion cancel within a pair, so the MPPI/CEM update sees the
            # curvature instead of sampling noise — better suppression at
            # equal K (classic antithetic variates; experiments/
            # sampler_quality.py measures the gain)
            eps = _base_noise(k, (mpc.n_candidates + 1) // 2)
            return jnp.concatenate([eps, -eps], axis=0)[: mpc.n_candidates]
        return _base_noise(k, mpc.n_candidates)

    def sample(k):
        cand = mean[None] + sigma * draw(k)
        # keep the nominal itself in the pool (index 0): never regress
        cand = cand.at[0].set(mean)
        if fb_seq is not None:
            cand = cand.at[1].set(fb_seq)
        cand = jnp.clip(cand, ctrl.coeff_min, ctrl.coeff_max)
        if candidate_sharding is not None:
            cand = jax.lax.with_sharding_constraint(cand, candidate_sharding)
        return cand

    if mpc.algo == "mppi":
        cand = sample(key)
        costs = costs_fn(state, cand)
        w = jax.nn.softmax(-(costs - jnp.min(costs)) / mpc.temperature)
        new_mean = jnp.einsum("k,khd->hd", w, cand)
        best = jnp.min(costs)
    else:  # CEM
        def cem_iter(carry, k):
            mu, sd = carry
            cand = jnp.clip(mu[None] + sd * draw(k), ctrl.coeff_min, ctrl.coeff_max)
            cand = cand.at[0].set(mu)
            if fb_seq is not None:
                cand = cand.at[1].set(jnp.clip(fb_seq, ctrl.coeff_min, ctrl.coeff_max))
            if candidate_sharding is not None:
                cand = jax.lax.with_sharding_constraint(cand, candidate_sharding)
            costs = costs_fn(state, cand)
            _, elite_idx = jax.lax.top_k(-costs, mpc.n_elites)
            elites = cand[elite_idx]
            mu2 = jnp.mean(elites, axis=0)
            sd2 = jnp.std(elites, axis=0) + 1e-3
            return (mu2, sd2), jnp.min(costs)

        keys = jax.random.split(key, mpc.n_iters)
        (new_mean, _), bests = jax.lax.scan(cem_iter, (mean, jnp.broadcast_to(sigma, mean.shape)), keys)
        best = bests[-1]

    if mpc.n_grad_iters > 0:
        new_mean = _gradient_refine(state, new_mean, grid, cfg, ctrl, mpc, actuator)

    return new_mean[0], new_mean, best


def _apply_fidelity_guard(plan_out, full_x, full_cfg, ctrl, mpc):
    """Gate an (action, new_mean, best) solve on the dynamic fidelity ratio.

    No-op (statically) at full-fidelity planning or with the guard disabled;
    otherwise zeroes the applied action and the warm-start mean whenever the
    on-device coherent/injected ratio is unsafe — see
    :class:`MPCConfig.fidelity_guard`. The warm start is reset too: an unsafe
    solve's mean encodes noise-phase cancellation and must not seed the next
    (possibly safe) solve.
    """
    action, new_mean, best = plan_out
    # arm only when the stride arithmetic ACTUALLY drops particles — for
    # plan_particles in (N/2, N) the stride is 1, planning is full fidelity,
    # and zeroing the drive on fictitious injected noise would silently
    # disable the controller (review finding 2026-08-20). The guard stays
    # armed even with the twin correction (an early r5 build bypassed it):
    # the correction removes the in-model PHANTOM-target profit, but the
    # drive's PHASE still comes from the subsample's noisy phasor, and on a
    # never-coherent quiet plasma that mis-phased drive pumps — measured at
    # reference scale: corrected-unguarded bump-on-tail tail PE 131.7 vs
    # 36.7 uncontrolled at 8 seeds (better than uncorrected-unguarded's
    # 186.2, still pumping — results_r5/corrected_reference_scale.json).
    # The guard's coherent/injected ratio measures exactly the phase
    # detectability the correction cannot supply. Deep-suppression runs at
    # large N that deliberately drive below the guard threshold (the
    # config-4 frontier's corrected rows) set fidelity_guard=False
    # explicitly — with the correction active that is an informed tradeoff,
    # not the silent hazard it is without it.
    if not (mpc.fidelity_guard and _plan_frac(full_cfg, mpc) < 1.0):
        return plan_out
    safe = _fidelity_ratio(full_x, full_cfg, ctrl, mpc) >= mpc.fidelity_guard_ratio
    return (
        jnp.where(safe, action, jnp.zeros_like(action)),
        jnp.where(safe, new_mean, jnp.zeros_like(new_mean)),
        best,
    )


@partial(jax.jit, static_argnames=("cfg", "ctrl", "mpc", "candidate_sharding"))
def plan(
    state: PlasmaState,
    mean: jax.Array,  # (H, 2K) warm-started nominal sequence
    sigma: jax.Array,  # (H, 2K) or scalar sampling stddev
    key: jax.Array,
    grid: Grid,
    cfg: SimConfig,
    ctrl: ControlConfig,
    mpc: MPCConfig,
    actuator: FourierActuator,
    candidate_sharding=None,
):
    """One MPC solve. Returns (first_action, new_mean, best_cost).

    ``candidate_sharding``: optional ``NamedSharding`` (e.g. over a
    ``"rollout"`` mesh axis). The sampled candidate block is constrained to
    it, and GSPMD partitions the K independent H-step rollouts across the
    mesh — the cost reduction/softmax is the only cross-device communication.
    For the planning kernel on several devices, use the shard_map planner
    (:func:`plasma_control_tpu.parallel.pic_shard.make_sharded_plan`) instead.
    """
    if candidate_sharding is not None and mpc.plan_kernel != "xla":
        # GSPMD cannot partition a pallas_call: the planning kernel only
        # composes with several devices via shard_map (each device runs the
        # kernel on its local candidate block — parallel.pic_shard.
        # make_sharded_plan). Under the constraint path, "auto" falls back to
        # the XLA scan; an explicitly forced kernel is a config error.
        if mpc.plan_kernel == "fused":
            raise ValueError(
                f"plan_kernel={mpc.plan_kernel!r} (Pallas) cannot be used with "
                "candidate_sharding (GSPMD constraint path) — use "
                "parallel.pic_shard.make_sharded_plan (shard_map) for "
                "multi-chip with Pallas planning kernels"
            )
        mpc = dataclasses.replace(mpc, plan_kernel="xla")

    if mean.shape[-1] != 2 * actuator.max_mode:
        # a ctrl/actuator mode mismatch otherwise surfaces deep in the
        # spectral cost as a cryptic broadcast error (review finding r5:
        # an actuator built with a different max_mode than the ControlConfig
        # driving the rollout)
        raise ValueError(
            f"coefficient/actuator mode mismatch: the nominal carries "
            f"{mean.shape[-1] // 2} modes but the actuator was built with "
            f"max_mode={actuator.max_mode} — build the actuator with the "
            "same ControlConfig.max_mode as the rollout"
        )
    full_x, full_cfg = state.x, cfg
    # Multi-fidelity: candidate rollouts may run on a reduced model.
    state, grid, cfg = _plan_model(state, grid, cfg, mpc)
    if actuator.n_mesh != grid.n_mesh:
        actuator = _actuator_cache(cfg.length, grid.n_mesh, actuator.max_mode, mean.dtype)

    # Noise-floor correction for subsampled planning: Wiener shrinkage from
    # the full state + the zero-drive twin trajectory, once per solve
    # (None at full fidelity / when plan_correction="none").
    target = twin_targets(full_x, state, cfg, full_cfg, ctrl, mpc)

    def costs_fn(st, cand):
        return candidate_costs(st, cand, grid, cfg, mpc, actuator,
                               twin_target=target)

    out = _plan_impl(
        state, mean, sigma, key, grid, cfg, ctrl, mpc, actuator, costs_fn,
        candidate_sharding=candidate_sharding,
    )
    return _apply_fidelity_guard(out, full_x, full_cfg, ctrl, mpc)


def _mpc_rollout_impl(
    state: PlasmaState,
    grid: Grid,
    cfg: SimConfig,
    ctrl: ControlConfig,
    mpc: MPCConfig,
    actuator: FourierActuator,
    plan_fn,
    key: jax.Array,
    n_steps: Optional[int] = None,
    mean0: Optional[jax.Array] = None,
    step_keys: Optional[jax.Array] = None,
) -> MPCOutput:
    """Receding-horizon loop body over an injectable per-step solver.

    ``plan_fn(state, mean, sigma, key) -> (action, new_mean, best)`` — the
    single-device :func:`plan` partial, or a shard_map planner
    (:func:`plasma_control_tpu.parallel.pic_shard.make_sharded_mpc_rollout`).
    ``grid``/``cfg``/``actuator`` here are the FULL environment model: the
    applied step always runs at full fidelity regardless of the plan model.
    """
    t = step_keys.shape[0] if step_keys is not None else (
        n_steps if n_steps is not None else cfg.n_steps
    )
    d = 2 * ctrl.max_mode
    if mean0 is None:
        mean0 = jnp.zeros((mpc.horizon, d), dtype=state.x.dtype)
    sigma = jnp.asarray(mpc.sigma0, dtype=state.x.dtype)

    def body(carry, k):
        st, mean = carry
        action, new_mean, best = plan_fn(st, mean, sigma, k)
        e_ext = actuator.compute_e_packed(action)
        new_st = step(st, grid, cfg, e_ext)
        pe, ke = _energies(new_st, grid, cfg)
        ie = actuator.input_energy(action)
        # receding horizon: shift, repeat last
        shifted = jnp.concatenate([new_mean[1:], new_mean[-1:]])
        return (new_st, shifted), (pe, ke, action, ie, best)

    keys = step_keys if step_keys is not None else jax.random.split(key, t)
    (final, mean_f), (pe, ke, coeffs, ie, best) = jax.lax.scan(body, (state, mean0), keys)
    return MPCOutput(
        final_state=final,
        field_energy=pe,
        kinetic=ke,
        hamiltonian=pe + ke,
        coeffs=coeffs,
        input_energy=ie,
        plan_cost=best,
        final_mean=mean_f,
    )


@partial(jax.jit, static_argnames=("cfg", "ctrl", "mpc", "n_steps", "candidate_sharding"))
def mpc_rollout(
    state: PlasmaState,
    grid: Grid,
    cfg: SimConfig,
    ctrl: ControlConfig,
    mpc: MPCConfig,
    actuator: FourierActuator,
    key: jax.Array,
    n_steps: Optional[int] = None,
    candidate_sharding=None,
    mean0: Optional[jax.Array] = None,
    step_keys: Optional[jax.Array] = None,
) -> MPCOutput:
    """Closed-loop receding-horizon control for ``n_steps`` env steps.

    The whole loop — T solves x (K candidates x H-step PIC rollouts) — is one
    compiled program; the per-step replanning warm-starts from the shifted
    previous nominal. ``mean0`` overrides the zero initial nominal and
    ``step_keys`` (T, 2) overrides the per-solve key schedule — together they
    let segmented/resumed runs (:func:`plasma_control_tpu.io.resume.
    resumable_mpc_rollout`) reproduce an unsegmented run exactly.
    """

    def plan_fn(st, mean, sigma, k):
        return plan(
            st, mean, sigma, k, grid, cfg, ctrl, mpc, actuator,
            candidate_sharding=candidate_sharding,
        )

    return _mpc_rollout_impl(
        state, grid, cfg, ctrl, mpc, actuator, plan_fn, key,
        n_steps=n_steps, mean0=mean0, step_keys=step_keys,
    )
