"""DAgger behavior cloning of the feedback or MPC expert.

An addition that fixes the covariate-shift failure of the
reference's one-shot behavior cloning (`ddpg.py:364-405`, see DEVNOTES):
because the experts here are *solvers* — the FFT phase-conjugate law
(`run_feedback.py:130-143`) or the sampling-MPC planner
(:func:`plasma_control_tpu.control.mpc.plan`) — they can relabel every state
the learner visits, on-device, inside the rollout scan. Each DAgger iteration
rolls the current policy closed-loop through the PIC dynamics (one compiled
scan), records the expert action at every visited state, aggregates, and
refits the actor on the whole dataset.

With ``expert="mpc"`` this is **amortized MPC**: the actor distills the
planner (which beats the feedback law ~2.5x on tail field energy, DEVNOTES
controller landscape) into a single forward pass per control step.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import optax

from ...config import ControlConfig, MPCConfig, SimConfig
from ...models.pic import PlasmaState, init_state, step
from ...ops.grid import Grid
from ..actuator import FourierActuator
from ..feedback import feedback_rollout
from .ddpg import DDPGConfig, _Nets, _expert_action, make_ddpg

__all__ = ["collect_policy_rollout", "fit_bc", "dagger_train"]


@partial(jax.jit, static_argnames=("nets", "cfg", "ctrl", "n_steps", "mpc"))
def collect_policy_rollout(
    nets: _Nets,
    actor_params,
    state0: PlasmaState,
    grid: Grid,
    actuator: FourierActuator,
    cfg: SimConfig,
    ctrl: ControlConfig,
    n_steps: int,
    mpc: Optional[MPCConfig] = None,
    key: Optional[jax.Array] = None,
):
    """Roll the current policy; return (states (T, 2N), expert actions (T, A),
    field energy (T,)).

    ``mpc=None`` relabels with the phase-conjugate feedback law; an
    ``MPCConfig`` relabels with a full MPC solve at every visited state
    (warm-started along the learner's own trajectory, as a receding-horizon
    controller would be)."""
    actor = nets.actor
    from ...models.rollout import _energies

    if mpc is None:
        def body(carry: PlasmaState, _):
            s_packed = jnp.concatenate([carry.x, carry.v])
            a_exp = _expert_action(carry.x, grid, cfg, ctrl.max_mode)
            a = actor.sample(actor_params, s_packed[None])[0]
            new = step(carry, grid, cfg, actuator.compute_e_packed(a))
            pe, _ = _energies(new, grid, cfg)
            return new, (s_packed, a_exp, pe)

        _, (states, experts, pes) = jax.lax.scan(body, state0, None, length=n_steps)
        return states, experts, pes

    from ..mpc import plan

    if key is None:
        raise ValueError("expert='mpc' relabeling needs a PRNG key")
    sigma = jnp.asarray(mpc.sigma0, state0.x.dtype)
    mean0 = jnp.zeros((mpc.horizon, 2 * ctrl.max_mode), dtype=state0.x.dtype)

    def body_mpc(carry, k):
        st, mean = carry
        s_packed = jnp.concatenate([st.x, st.v])
        a_exp, new_mean, _ = plan(st, mean, sigma, k, grid, cfg, ctrl, mpc, actuator)
        a = actor.sample(actor_params, s_packed[None])[0]
        new = step(st, grid, cfg, actuator.compute_e_packed(a))
        pe, _ = _energies(new, grid, cfg)
        shifted = jnp.concatenate([new_mean[1:], new_mean[-1:]])
        return (new, shifted), (s_packed, a_exp, pe)

    keys = jax.random.split(key, n_steps)
    _, (states, experts, pes) = jax.lax.scan(body_mpc, (state0, mean0), keys)
    return states, experts, pes


@partial(jax.jit, static_argnames=("nets", "hp", "n_epochs"), donate_argnums=(1, 2))
def fit_bc(
    nets: _Nets,
    actor_params,
    opt_state,
    states: jax.Array,  # (D, 2N)
    actions: jax.Array,  # (D, A)
    key: jax.Array,
    hp: DDPGConfig,
    n_epochs: int,
):
    """Full-batch L2 regression of the actor onto expert actions."""
    actor, _, tx = nets

    def epoch(carry, k):
        params, opt = carry

        def loss_fn(p):
            pred = actor.sample(p, states)
            return jnp.mean(jnp.sum((actions - pred) ** 2, axis=1))

        l, g = jax.value_and_grad(loss_fn)(params)
        u, opt = tx.update(g, opt, params)
        return (optax.apply_updates(params, u), opt), l

    (params, opt), losses = jax.lax.scan(epoch, (actor_params, opt_state), jax.random.split(key, n_epochs))
    return params, opt, losses[-1]


def dagger_train(
    cfg: SimConfig,
    ctrl: ControlConfig,
    hp: DDPGConfig,
    grid: Grid,
    actuator: FourierActuator,
    key: jax.Array,
    n_iters: int = 5,
    epochs_per_iter: int = 300,
    verbose: bool = True,
    mpc: Optional[MPCConfig] = None,
    return_best: bool = True,
):
    """DAgger loop. Returns (nets, actor_params, history).

    history['pe_tail'][i] is the closed-loop tail field energy of the policy
    at iteration i — should approach the expert's. ``mpc=None`` clones the
    phase-conjugate feedback law; an ``MPCConfig`` clones the sampling-MPC
    planner (amortized MPC — the planner beats the feedback law ~2.5x on
    suppression, so the distilled policy's ceiling is much higher).

    ``return_best`` (default) returns the parameters of the iteration with
    the lowest measured closed-loop tail PE rather than the last: the
    iterates are noisy (measured 79 -> 138 between consecutive iterations at
    the landscape config) because each refit sees a different aggregate mix,
    and each iteration already pays for the evaluation rollout that scores
    it — keeping the argmin is free model selection.
    """
    k_net, k_env, key = jax.random.split(key, 3)
    nets, ts = make_ddpg(cfg, ctrl, hp, k_net)
    params, opt = ts.actor_params, ts.actor_opt
    n_steps = cfg.n_steps

    # iteration 0 dataset: the expert's own trajectory
    state0 = init_state(cfg, k_env)
    if mpc is None:
        fb = feedback_rollout(state0, grid, cfg, ctrl, actuator, record_snapshots=True, n_steps=n_steps)
        states = jnp.concatenate([fb.xs[:-1], fb.vs[:-1]], axis=1)
        actions = jnp.concatenate([fb.coeff_cos, fb.coeff_sin], axis=1)
    else:
        from ...models.rollout import rollout as _env_rollout
        from ..mpc import mpc_rollout

        key, k_mpc = jax.random.split(key)
        out = mpc_rollout(state0, grid, cfg, ctrl, mpc, actuator, k_mpc, n_steps=n_steps)
        replay = _env_rollout(
            state0, grid, cfg,
            e_external_traj=actuator.compute_e_packed(out.coeffs),
            record_snapshots=True, n_steps=n_steps,
        )
        states = jnp.concatenate([replay.xs[:-1], replay.vs[:-1]], axis=1)
        actions = out.coeffs

    history = {"bc_loss": [], "pe_tail": []}
    # None (-> fall back to the final params) rather than the initial tree:
    # fit_bc donates its params input, so if no iteration ever improves
    # best_pe (e.g. every evaluation rollout diverges to NaN, which fails
    # the < comparison), an alias of the initial device buffers would be
    # returned deleted.
    best_params, best_pe = None, float("inf")
    for it in range(n_iters):
        key, k_fit, k_env2, k_plan = jax.random.split(key, 4)
        params, opt, loss = fit_bc(nets, params, opt, states, actions, k_fit, hp, epochs_per_iter)

        roll_state = init_state(cfg, k_env2)
        s_new, a_new, pes = collect_policy_rollout(
            nets, params, roll_state, grid, actuator, cfg, ctrl, n_steps,
            mpc=mpc, key=k_plan,
        )
        states = jnp.concatenate([states, s_new])
        actions = jnp.concatenate([actions, a_new])

        pe_tail = float(jnp.mean(pes[-n_steps // 5 :]))
        history["bc_loss"].append(float(loss))
        history["pe_tail"].append(pe_tail)
        if pe_tail < best_pe:
            # host copy: fit_bc DONATES actor_params, so keeping the device
            # arrays would leave best_params pointing at deleted buffers
            # after the next iteration
            best_pe, best_params = pe_tail, jax.device_get(params)
        if verbose:
            print(
                f"| dagger iter {it + 1}/{n_iters} | bc_loss {float(loss):.5f} "
                f"| policy PE_tail {pe_tail:.1f}",
                flush=True,
            )

    if return_best and best_params is not None:
        return nets, best_params, history
    return nets, params, history
