"""Sharded PIC stepping and MPC planning over a device mesh.

New capability (the reference is single-device, SURVEY §2.6):

* **particle sharding** — the particle arrays (x, v) are sharded along a
  ``"particle"`` mesh axis. Deposition computes a *local partial density* from
  the local particle block and ``psum``s the small (M,) vector — the
  particle-decomposition form of PIC domain decomposition. The field solve is replicated
  (tiny circulant matmul); the gather needs only local particles + the
  replicated mesh field. One psum of M floats per field evaluation (3 per
  Yoshida step) is the entire communication volume.
* **rollout sharding** — MPC candidate control sequences are sharded along a
  ``"rollout"`` axis; each device rolls out its candidate block independently
  (zero communication) and only the (K,) cost vector is gathered for the
  MPPI/CEM update.

Both run unchanged on a virtual CPU mesh (tests) and on several GPUs.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..config import ControlConfig, MPCConfig, SimConfig
from ..control.actuator import FourierActuator
from ..control.mpc import (
    MPCOutput,
    _actuator_cache,
    _apply_fidelity_guard,
    _mpc_rollout_impl,
    _plan_impl,
    _reduce_state,
    _reduced_model,
    candidate_costs,
    twin_targets,
)
from ..models.pic import PlasmaState
from ..ops.deposit import deposit, gather
from ..ops.fields import solve_e_mesh
from ..ops.grid import Grid
from ..ops.integrate import INTEGRATORS

__all__ = [
    "make_particle_sharded_step",
    "make_sharded_candidate_costs",
    "make_sharded_plan",
    "make_sharded_mpc_rollout",
    "sharded_plan",
]


def make_particle_sharded_step(
    mesh: Mesh,
    grid: Grid,
    cfg: SimConfig,
    axis: str = "particle",
):
    """Build a jit-compiled step function with (x, v) sharded over ``axis``.

    Returns ``step_fn(x, v, e_external) -> (x, v)`` where the particle arrays
    are sharded over the mesh axis and ``e_external`` (an (M,) mesh field) is
    replicated. Semantics identical to :func:`plasma_control_tpu.models.pic.step`.
    """
    norm = cfg.n0 * cfg.length / cfg.n_particles / grid.dx

    def accel_factory(e_ext):
        def accel(x_local):
            n_raw = deposit(x_local, grid, kind=cfg.interpol, method=cfg.deposit_method, normalize=False)
            n = jax.lax.psum(n_raw, axis) * norm  # collective: (M,) floats
            e_mesh = solve_e_mesh(n, grid, cfg.n0) + e_ext
            return -gather(e_mesh, x_local, grid, kind=cfg.interpol, method=cfg.deposit_method)

        return accel

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P()),
        out_specs=(P(axis), P(axis)),
    )
    def _sharded(x, v, e_ext):
        integ = INTEGRATORS[cfg.integrator]
        x2, v2 = integ(x, v, accel_factory(e_ext), cfg.clamped_dt())
        return jnp.mod(x2, cfg.length), v2

    return jax.jit(_sharded)


def make_sharded_candidate_costs(
    mesh: Mesh,
    grid: Grid,
    cfg: SimConfig,
    mpc: MPCConfig,
    actuator: FourierActuator,
    axis: str = "rollout",
):
    """Candidate-cost evaluation with the candidate axis sharded over ``axis``.

    Each device scores its local candidate block (independent H-step PIC
    rollouts); only the (K,) cost vector crosses devices (all-gather at the
    boundary). Returns ``costs_fn(state, coeff_seqs) -> (K,) costs``.
    """

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(axis)),
        out_specs=P(axis),
        check_vma=False,
    )
    def _local(x, v, cand):
        return candidate_costs(PlasmaState(x, v), cand, grid, cfg, mpc, actuator)

    return jax.jit(lambda state, cand: _local(state.x, state.v, cand))


def _sharded_costs_closure(
    mesh: Mesh,
    plan_grid: Grid,
    plan_cfg: SimConfig,
    mpc: MPCConfig,
    plan_act: FourierActuator,
    axis: str,
):
    """shard_map candidate scorer over the (already fidelity-reduced) plan
    model: each device scores its local candidate block with the FULL
    single-chip scorer (every kernel incl. the spectral horizon kernel runs
    per-device inside shard_map); only the (K,) cost vector crosses devices.
    """
    if mpc.n_candidates % mesh.shape[axis]:
        raise ValueError(
            f"n_candidates={mpc.n_candidates} must divide evenly over the "
            f"{axis!r} mesh axis ({mesh.shape[axis]} devices)"
        )

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(axis)),
        out_specs=P(axis),
        check_vma=False,
    )
    def _local(x, v, cand):
        return candidate_costs(PlasmaState(x, v), cand, plan_grid, plan_cfg, mpc, plan_act)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(axis), P(), P()),
        out_specs=P(axis),
        check_vma=False,
    )
    def _local_corrected(x, v, cand, tc, ts):
        # replicated (H, Km) noise-correction targets from twin_targets():
        # each device applies the same correction to its local block
        return candidate_costs(
            PlasmaState(x, v), cand, plan_grid, plan_cfg, mpc, plan_act,
            twin_target=(tc, ts),
        )

    def costs_fn(st, cand, target=None):
        if target is None:
            return _local(st.x, st.v, cand)
        return _local_corrected(st.x, st.v, cand, target[0], target[1])

    return costs_fn


def make_sharded_plan(
    mesh: Mesh,
    grid: Grid,
    cfg: SimConfig,
    ctrl: ControlConfig,
    mpc: MPCConfig,
    actuator: FourierActuator,
    axis: str = "rollout",
):
    """Build the FULL-featured MPC solve with candidates sharded over ``axis``.

    One planner, two execution modes (VERDICT r1 #3): this is the same
    :func:`plasma_control_tpu.control.mpc._plan_impl` body the single-chip
    :func:`~plasma_control_tpu.control.mpc.plan` runs — knot/AR(1)/antithetic
    sampling, feedback seeding, terminal tail costs, CEM iterations, gradient
    refinement, multi-fidelity reduction, and the fused spectral Pallas
    kernel all work identically — with only the candidate scorer swapped for
    a ``shard_map`` closure built ONCE here (the old ``sharded_plan`` rebuilt
    its jit wrapper on every call).

    Returns a jitted ``plan_fn(state, mean, sigma, key) ->
    (first_action, new_mean, best_cost)``.
    """
    plan_grid, plan_cfg = _reduced_model(grid, cfg, mpc)
    plan_act = actuator
    if plan_act.n_mesh != plan_grid.n_mesh:
        plan_act = _actuator_cache(
            plan_cfg.length, plan_grid.n_mesh, actuator.max_mode, jnp.float32
        )
    costs_fn = _sharded_costs_closure(mesh, plan_grid, plan_cfg, mpc, plan_act, axis)

    @jax.jit
    def plan_fn(state: PlasmaState, mean, sigma, key):
        pstate = _reduce_state(state, cfg, mpc)
        target = twin_targets(state.x, pstate, plan_cfg, cfg, ctrl, mpc)
        out = _plan_impl(
            pstate, mean, sigma, key, plan_grid, plan_cfg, ctrl, mpc, plan_act,
            lambda st, cand: costs_fn(st, cand, target),
        )
        return _apply_fidelity_guard(out, state.x, cfg, ctrl, mpc)

    return plan_fn


def make_sharded_mpc_rollout(
    mesh: Mesh,
    grid: Grid,
    cfg: SimConfig,
    ctrl: ControlConfig,
    mpc: MPCConfig,
    actuator: FourierActuator,
    axis: str = "rollout",
):
    """Closed-loop receding-horizon MPC with every solve sharded over ``axis``.

    The full T-step loop compiles to ONE program on the mesh: per step, the
    sharded :func:`make_sharded_plan` solve (rollouts data-parallel over
    devices, cost gather at the boundary) followed by the full-fidelity
    replicated environment step. Returns a jitted
    ``rollout_fn(state, key, n_steps=None, mean0=None, step_keys=None) ->
    MPCOutput`` with the same semantics/fields as
    :func:`plasma_control_tpu.control.mpc.mpc_rollout`.
    """
    plan_grid, plan_cfg = _reduced_model(grid, cfg, mpc)
    plan_act = actuator
    if plan_act.n_mesh != plan_grid.n_mesh:
        plan_act = _actuator_cache(
            plan_cfg.length, plan_grid.n_mesh, actuator.max_mode, jnp.float32
        )
    costs_fn = _sharded_costs_closure(mesh, plan_grid, plan_cfg, mpc, plan_act, axis)

    def plan_fn(st, mean, sigma, k):
        pstate = _reduce_state(st, cfg, mpc)
        target = twin_targets(st.x, pstate, plan_cfg, cfg, ctrl, mpc)
        out = _plan_impl(
            pstate, mean, sigma, k, plan_grid, plan_cfg, ctrl, mpc, plan_act,
            lambda s2, cand: costs_fn(s2, cand, target),
        )
        return _apply_fidelity_guard(out, st.x, cfg, ctrl, mpc)

    @partial(jax.jit, static_argnames=("n_steps",))
    def rollout_fn(
        state: PlasmaState,
        key: jax.Array,
        n_steps: Optional[int] = None,
        mean0: Optional[jax.Array] = None,
        step_keys: Optional[jax.Array] = None,
    ) -> MPCOutput:
        return _mpc_rollout_impl(
            state, grid, cfg, ctrl, mpc, actuator, plan_fn, key,
            n_steps=n_steps, mean0=mean0, step_keys=step_keys,
        )

    return rollout_fn


_SHARDED_PLANS = {}


def sharded_plan(
    state: PlasmaState,
    mean: jax.Array,
    sigma: jax.Array,
    key: jax.Array,
    mesh: Mesh,
    grid: Grid,
    cfg: SimConfig,
    ctrl: ControlConfig,
    mpc: MPCConfig,
    actuator: FourierActuator,
):
    """One full-featured MPC solve sharded over the ``rollout`` mesh axis.

    Convenience wrapper over :func:`make_sharded_plan` with a build cache
    keyed by (mesh, configs, shapes) so repeated calls hit the same compiled
    executable instead of rebuilding the closure per solve (the round-1
    recompile-per-call bug). Prefer the factory in loops you control.
    """
    cache_key = (mesh, cfg, ctrl, mpc, actuator.max_mode, grid.n_mesh)
    if cache_key not in _SHARDED_PLANS:
        # bounded FIFO: a config sweep (dataclasses.replace(mpc, ...) in a
        # loop) would otherwise grow one jitted closure + compiled
        # executables per variant for the life of the process
        while len(_SHARDED_PLANS) >= 8:
            _SHARDED_PLANS.pop(next(iter(_SHARDED_PLANS)))
        _SHARDED_PLANS[cache_key] = make_sharded_plan(mesh, grid, cfg, ctrl, mpc, actuator)
    return _SHARDED_PLANS[cache_key](state, mean, sigma, key)
