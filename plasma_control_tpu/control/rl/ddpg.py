"""DDPG (TD3-flavored, with behavior cloning) in JAX/Flax/optax.

Capability parity with `/root/reference/src/control/rl/ddpg.py:305-539`,
re-designed as one compiled program: the entire episode — policy forward, expert
(phase-conjugate) action, PIC environment step, reward, replay-buffer write,
and the conditional TD3 update — runs inside ONE compiled ``lax.scan``; the
reference instead crosses the CPU(NumPy sim)<->GPU(torch nets) boundary twice
per step (`ddpg.py:434-436`, SURVEY §3.3).

Algorithmic parity (`ddpg.py:213-303`):
  * twin critics, target-policy smoothing noise 0.1 clipped to ±0.1,
    min(Q1', Q2') bootstrap;
  * Huber critic losses, global-norm grad clip 1.0;
  * actor loss = -Q1(s, pi(s)) + 1.0 * reward-weighted BC loss to the FFT
    feedback expert action;
  * Polyak target updates (tau);
  * offline stage: one expert rollout + 50 epochs reward-weighted behavior
    cloning (`ddpg.py:364-405`).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import optax

from ...config import ControlConfig, SimConfig
from ...models.pic import PlasmaState, init_state, step
from ...ops.deposit import deposit
from ...ops.fields import solve_e_mesh
from ...ops.grid import Grid
from ..actuator import FourierActuator
from ..feedback import feedback_coefficients, feedback_rollout
from ..reward import Reward
from .buffer import ReplayBuffer, buffer_init, buffer_push, buffer_sample
from .networks import DDPGActor, DDPGCritic

__all__ = ["DDPGConfig", "DDPGState", "make_ddpg", "update_policy", "train"]


@dataclasses.dataclass(frozen=True)
class DDPGConfig:
    """Hyperparameters with the reference CLI defaults
    (`/root/reference/run_ddpg.py:59-80`)."""

    mlp_dim: int = 64
    lr: float = 1e-3
    gamma: float = 0.995  # --r
    tau: float = 0.005
    capacity: int = 100_000
    batch_size: int = 100
    update_freq: int = 10
    min_buffer_size: int = 10_000
    num_episodes: int = 500
    noise_scale: float = 0.1
    ou_mu: float = 0.0
    ou_theta: float = 0.15
    ou_sigma: float = 0.2
    output_min: float = -1.25  # --coeff_min
    output_max: float = 1.25  # --coeff_max
    alpha: float = 0.1  # reward weights (`run_ddpg.py:79-80`)
    beta: float = 0.1
    bc_weight: float = 1.0  # actor BC term weight (`ddpg.py:288`)
    policy_noise: float = 0.1  # target smoothing (`ddpg.py:259-261`)
    noise_clip: float = 0.1
    n_bc_epochs: int = 50  # offline BC epochs (`ddpg.py:390`)
    # "reference" = the reference reward (structurally flat in PE at its own
    # workloads, see Reward.compute_reward_shaped); "shaped" = scale-free
    # smooth alternative (new capability).
    reward_shape: str = "reference"
    # Actor state encoder: "deepsets" = the reference's ParticleEncoder
    # (`encode.py:4-38`); "spectral" = per-mode phase-space moments
    # (networks.SpectralEncoder, new capability) — the sufficient statistics
    # of the low-mode wave dynamics, built for distilling the MPC planner
    # (the DeepSets mean-pool loses the phase precision the control law
    # needs; DEVNOTES RL findings); "attention" = the mode-token transformer
    # actor over the same spectral moments with per-mode output heads
    # (networks.SpectralAttentionActor — the capacity lever for closing the
    # learned-vs-planner gap, VERDICT r3 #5).
    encoder: str = "deepsets"
    encoder_modes: int = 8
    # Velocity-moment order of the spectral encoder: 1 = density + current
    # per mode (the round-2 committed actors), 2 adds per-mode pressure,
    # 3 heat flux — successive closures of the linearized Vlasov moment
    # hierarchy (networks.SpectralEncoder docstring).
    encoder_v_order: int = 1
    # SpectralAttentionActor capacity knobs (encoder="attention" only).
    attn_dim: int = 64
    attn_heads: int = 4
    attn_layers: int = 2


class DDPGState(NamedTuple):
    actor_params: dict
    q1_params: dict
    q2_params: dict
    target_actor_params: dict
    target_q1_params: dict
    target_q2_params: dict
    actor_opt: optax.OptState
    q1_opt: optax.OptState
    q2_opt: optax.OptState


class _Nets(NamedTuple):
    actor: DDPGActor
    critic: DDPGCritic
    tx: optax.GradientTransformation


def make_ddpg(cfg: SimConfig, ctrl: ControlConfig, hp: DDPGConfig, key: jax.Array):
    """Build networks, params and optimizer states (6 networks + 3 Adams,
    parity with `/root/reference/run_ddpg.py:135-186`)."""
    if hp.encoder == "attention":
        from .networks import SpectralAttentionActor

        actor = SpectralAttentionActor(
            mlp_dim=hp.mlp_dim,
            n_actions=ctrl.n_actions,
            n_modes=hp.encoder_modes,
            output_min=hp.output_min,
            output_max=hp.output_max,
            length=cfg.length,
            v_order=hp.encoder_v_order,
            d_model=hp.attn_dim,
            n_heads=hp.attn_heads,
            n_layers=hp.attn_layers,
        )
    elif hp.encoder == "spectral":
        from .networks import SpectralActor

        actor = SpectralActor(
            mlp_dim=hp.mlp_dim,
            n_actions=ctrl.n_actions,
            n_modes=hp.encoder_modes,
            output_min=hp.output_min,
            output_max=hp.output_max,
            length=cfg.length,
            v_order=hp.encoder_v_order,
        )
    else:
        actor = DDPGActor(
            mlp_dim=hp.mlp_dim,
            n_actions=ctrl.n_actions,
            output_min=hp.output_min,
            output_max=hp.output_max,
            length=cfg.length,
        )
    critic = DDPGCritic(mlp_dim=hp.mlp_dim, length=cfg.length)
    dummy_s = jnp.zeros((1, 2 * cfg.n_particles))
    dummy_a = jnp.zeros((1, ctrl.n_actions))
    ka, k1, k2 = jax.random.split(key, 3)
    actor_params = actor.init(ka, dummy_s)
    q1_params = critic.init(k1, dummy_s, dummy_a)
    q2_params = critic.init(k2, dummy_s, dummy_a)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(hp.lr))
    state = DDPGState(
        actor_params=actor_params,
        q1_params=q1_params,
        q2_params=q2_params,
        target_actor_params=jax.tree.map(jnp.copy, actor_params),
        target_q1_params=jax.tree.map(jnp.copy, q1_params),
        target_q2_params=jax.tree.map(jnp.copy, q2_params),
        actor_opt=tx.init(actor_params),
        q1_opt=tx.init(q1_params),
        q2_opt=tx.init(q2_params),
    )
    return _Nets(actor=actor, critic=critic, tx=tx), state


def _huber(pred, target):
    return jnp.mean(optax.losses.huber_loss(pred, target))


def update_policy(
    nets: _Nets,
    ts: DDPGState,
    batch,
    key: jax.Array,
    hp: DDPGConfig,
) -> Tuple[DDPGState, jax.Array, jax.Array, jax.Array]:
    """One TD3+BC update (parity with ``update_policy``, `ddpg.py:213-303`)."""
    s, a, s2, r, d, a_bc = batch
    actor, critic, tx = nets

    next_a = actor.sample(ts.target_actor_params, s2)
    noise = jnp.clip(
        jax.random.normal(key, next_a.shape) * hp.policy_noise, -hp.noise_clip, hp.noise_clip
    )
    next_a = jnp.clip(next_a + noise, hp.output_min, hp.output_max)
    tq1 = critic.apply(ts.target_q1_params, s2, next_a)
    tq2 = critic.apply(ts.target_q2_params, s2, next_a)
    target_q = r[:, None] + hp.gamma * (1.0 - d[:, None]) * jnp.minimum(tq1, tq2)
    target_q = jax.lax.stop_gradient(target_q)

    def q_loss(p):
        return _huber(critic.apply(p, s, a), target_q)

    q1_l, g1 = jax.value_and_grad(q_loss)(ts.q1_params)
    u1, q1_opt = tx.update(g1, ts.q1_opt, ts.q1_params)
    q1_params = optax.apply_updates(ts.q1_params, u1)

    q2_l, g2 = jax.value_and_grad(q_loss)(ts.q2_params)
    u2, q2_opt = tx.update(g2, ts.q2_opt, ts.q2_params)
    q2_params = optax.apply_updates(ts.q2_params, u2)

    def p_loss(p):
        a_pi = actor.sample(p, s)
        bc = jnp.mean(jnp.sum((a_bc - a_pi) ** 2, axis=1) * r)
        return -jnp.mean(critic.apply(q1_params, s, a_pi)) + hp.bc_weight * bc

    p_l, gp = jax.value_and_grad(p_loss)(ts.actor_params)
    up, actor_opt = tx.update(gp, ts.actor_opt, ts.actor_params)
    actor_params = optax.apply_updates(ts.actor_params, up)

    polyak = lambda tgt, src: optax.incremental_update(src, tgt, hp.tau)
    new_ts = DDPGState(
        actor_params=actor_params,
        q1_params=q1_params,
        q2_params=q2_params,
        target_actor_params=polyak(ts.target_actor_params, actor_params),
        target_q1_params=polyak(ts.target_q1_params, q1_params),
        target_q2_params=polyak(ts.target_q2_params, q2_params),
        actor_opt=actor_opt,
        q1_opt=q1_opt,
        q2_opt=q2_opt,
    )
    return new_ts, q1_l, q2_l, p_l


def _expert_action(x: jax.Array, grid: Grid, cfg: SimConfig, max_mode: int) -> jax.Array:
    """FFT phase-conjugate expert action from the current state
    (`ddpg.py:429-431`; computed on the env grid rather than the reference's
    hard-coded 250-cell mesh, identical when N_mesh=250)."""
    n = deposit(x, grid, n0=cfg.n0, kind=cfg.interpol, method=cfg.deposit_method)
    e_mesh = solve_e_mesh(n, grid, cfg.n0)
    a, b = feedback_coefficients(e_mesh, max_mode)
    return jnp.concatenate([a, b])


def _ou_step(ou: jax.Array, key: jax.Array, hp: DDPGConfig) -> jax.Array:
    """Ornstein-Uhlenbeck noise (`ddpg.py:188-210`)."""
    dx = hp.ou_theta * (hp.ou_mu - ou) + hp.ou_sigma * jax.random.normal(key, ou.shape)
    return ou + dx


def behavior_cloning(
    nets: _Nets,
    ts: DDPGState,
    states_bc: jax.Array,  # (T, 2N)
    actions_bc: jax.Array,  # (T, A)
    rewards_bc: jax.Array,  # (T,)
    key: jax.Array,
    hp: DDPGConfig,
) -> DDPGState:
    """Offline reward-weighted BC (parity with `ddpg.py:389-405`, including
    the exploration noise the reference injects into the BC predictions)."""
    actor, _, tx = nets

    def epoch(carry, k):
        params, opt = carry

        def loss_fn(p):
            pred = actor.sample(p, states_bc)
            noise = jnp.clip(jax.random.normal(k, pred.shape) * 0.1, -0.1, 0.1)
            pred = jnp.clip(pred + noise, hp.output_min, hp.output_max)
            l2 = jnp.sum((actions_bc - pred) ** 2, axis=1)
            return jnp.sum(l2 * rewards_bc)

        _, g = jax.value_and_grad(loss_fn)(params)
        u, opt = tx.update(g, opt, params)
        return (optax.apply_updates(params, u), opt), None

    (params, opt), _ = jax.lax.scan(
        epoch, (ts.actor_params, ts.actor_opt), jax.random.split(key, hp.n_bc_epochs)
    )
    return ts._replace(actor_params=params, actor_opt=opt)


@partial(jax.jit, static_argnames=("nets", "cfg", "ctrl", "hp", "n_steps"), donate_argnums=(1, 2))
def run_episode(
    nets: _Nets,
    ts: DDPGState,
    buf: ReplayBuffer,
    state0: PlasmaState,
    reward_feq: jax.Array,
    key: jax.Array,
    grid: Grid,
    actuator: FourierActuator,
    cfg: SimConfig,
    ctrl: ControlConfig,
    hp: DDPGConfig,
    n_steps: int,
):
    """One fully-compiled online episode (parity with the per-step loop
    `ddpg.py:421-500`): returns (ts, buf, metrics dict)."""
    actor = nets.actor
    reward_cls = Reward(
        jnp.concatenate([state0.x, state0.v]),
        n_mesh=ctrl.reward_n_mesh,
        length=cfg.length,
        vmin=ctrl.vmin,
        vmax=ctrl.vmax,
        n0=cfg.n0,
        alpha=hp.alpha,
        beta=hp.beta,
        n_actions=ctrl.n_actions,
    )
    reward_cls.feq = reward_feq

    def body(carry, inp):
        env, buf, ts, ou = carry
        t, k = inp
        k_ou, k_up = jax.random.split(k)

        s_packed = jnp.concatenate([env.x, env.v])
        a_bc = _expert_action(env.x, grid, cfg, ctrl.max_mode)
        a = actor.sample(ts.actor_params, s_packed[None])[0]
        ou = _ou_step(ou, k_ou, hp)
        a = jnp.clip(a + ou * hp.noise_scale, hp.output_min, hp.output_max)

        e_ext = actuator.compute_e_packed(a)
        env2 = step(env, grid, cfg, e_ext)
        s2_packed = jnp.concatenate([env2.x, env2.v])
        r = reward_cls.reward_fn(hp.reward_shape)(s_packed, a)
        done = jnp.where(t == n_steps - 1, 1.0, 0.0)

        buf = buffer_push(buf, s_packed, a, s2_packed, r, done, a_bc)

        do_update = (buf.size >= hp.min_buffer_size) & (t % hp.update_freq == 0)

        def yes(args):
            ts, buf = args
            batch = buffer_sample(buf, k_up, hp.batch_size)
            ts2, q1l, q2l, pl = update_policy(nets, ts, batch, k_up, hp)
            return ts2, q1l, q2l, pl

        def no(args):
            ts, _ = args
            z = jnp.zeros(())
            return ts, z, z, z

        ts, q1l, q2l, pl = jax.lax.cond(do_update, yes, no, (ts, buf))
        return (env2, buf, ts, ou), (r, q1l, q2l, pl, do_update)

    ou0 = jnp.full((ctrl.n_actions,), hp.ou_mu)
    keys = jax.random.split(key, n_steps)
    step_idx = jnp.arange(n_steps)
    (_, buf, ts, _), (rs, q1s, q2s, ps, upd) = jax.lax.scan(
        body, (state0, buf, ts, ou0), (step_idx, keys)
    )
    n_upd = jnp.maximum(jnp.sum(upd), 1)
    metrics = {
        "reward_mean": jnp.sum(rs * upd) / n_upd,
        "q1_loss": jnp.sum(q1s) / n_upd,
        "q2_loss": jnp.sum(q2s) / n_upd,
        "p_loss": jnp.sum(ps) / n_upd,
        "n_updates": jnp.sum(upd),
        "reward_total": jnp.sum(rs),
    }
    return ts, buf, metrics


def train(
    cfg: SimConfig,
    ctrl: ControlConfig,
    hp: DDPGConfig,
    grid: Grid,
    actuator: FourierActuator,
    key: jax.Array,
    num_episodes: Optional[int] = None,
    verbose: int = 10,
    save_best: Optional[str] = None,
    save_every: int = 10,
    ckpt_path: Optional[str] = None,
    ckpt_every: int = 10,
    resume: bool = True,
):
    """Full training: offline expert BC stage + online episodes
    (parity with ``train``, `ddpg.py:305-539`). If ``save_best`` is given the
    best actor weights are persisted every ``save_every`` episodes (the
    reference saves on every update, `ddpg.py:496`).

    If ``ckpt_path`` is given the COMPLETE training state (networks, optimizer
    moments, replay buffer, RNG key, history) is checkpointed every
    ``ckpt_every`` episodes and a preempted run resumes exactly — same episode
    keys, same updates — where it stopped (new capability; the reference loses
    everything but the weights, `ddpg.py:496`).

    Returns (nets, ts, best_params, history dict with per-episode arrays).
    """
    import numpy as np

    k_init, k_net, k_bc, k_run = jax.random.split(key, 4)
    state0 = init_state(cfg, k_init)
    nets, ts = make_ddpg(cfg, ctrl, hp, k_net)

    n_steps = cfg.n_steps
    init_packed = jnp.concatenate([state0.x, state0.v])
    reward_cls = Reward(
        init_packed, ctrl.reward_n_mesh, cfg.length, ctrl.vmin, ctrl.vmax, cfg.n0,
        hp.alpha, hp.beta, ctrl.n_actions,
    )

    buf = buffer_init(hp.capacity, 2 * cfg.n_particles, ctrl.n_actions)
    episodes = num_episodes if num_episodes is not None else hp.num_episodes
    hist = {"reward": [], "q1_loss": [], "q2_loss": [], "p_loss": []}

    # Attempt resume BEFORE the offline stage: a restored checkpoint would
    # overwrite the BC'd networks anyway, so the expert rollout + cloning
    # (a full episode of compute) is skipped entirely on resume.
    ep0, ck = 0, None
    if ckpt_path and resume:
        from ...io.resume import restore_train_checkpoint

        ck = restore_train_checkpoint(ckpt_path, ts, buf, k_run, ts.actor_params)
    if ck is not None:
        ts, buf, k_run = ck["ts"], ck["buf"], ck["key"]
        ep0, hist = ck["ep_done"], ck["hist"]
        best_reward, best_params = ck["best_reward"], ck["best_params"]
        print(f"# resumed DDPG training from {ckpt_path} at episode {ep0}")
    else:
        # ---- offline stage: expert rollout + reward-weighted BC ----------
        fb = feedback_rollout(state0, grid, cfg, ctrl, actuator, record_snapshots=True, n_steps=n_steps)
        states_bc = jnp.concatenate([fb.xs[:-1], fb.vs[:-1]], axis=1)  # (T, 2N)
        actions_bc = jnp.concatenate([fb.coeff_cos, fb.coeff_sin], axis=1)  # (T, A)
        rewards_bc = jax.vmap(reward_cls.reward_fn(hp.reward_shape))(states_bc, actions_bc)
        ts = behavior_cloning(nets, ts, states_bc, actions_bc, rewards_bc, k_bc, hp)
        best_reward, best_params = None, jax.tree.map(jnp.copy, ts.actor_params)

    for ep in range(ep0, episodes):
        k_run, k_ep, k_env = jax.random.split(k_run, 3)
        ep_state = init_state(cfg, k_env)  # env.reinit(): full resample
        ts, buf, m = run_episode(
            nets, ts, buf, ep_state, reward_cls.feq, k_ep, grid, actuator, cfg, ctrl, hp, n_steps
        )
        rm = float(m["reward_mean"])
        hist["reward"].append(rm)
        hist["q1_loss"].append(float(m["q1_loss"]))
        hist["q2_loss"].append(float(m["q2_loss"]))
        hist["p_loss"].append(float(m["p_loss"]))
        if int(m["n_updates"]) > 0 and (best_reward is None or rm > best_reward):
            best_reward = rm
            best_params = jax.tree.map(jnp.copy, ts.actor_params)
        if save_best and ep % save_every == 0:
            from ...io.checkpoint import save_params

            save_params(save_best, best_params)
        if ckpt_path and ((ep + 1) % ckpt_every == 0 or ep == episodes - 1):
            from ...io.resume import save_train_checkpoint

            save_train_checkpoint(ckpt_path, ts, buf, k_run, ep + 1, hist, best_reward, best_params)
        if verbose and ep % verbose == 0:
            print(f"| episode:{ep + 1} | reward:{rm:.4f} | p_loss:{hist['p_loss'][-1]:.4f}")

    hist = {k: np.asarray(v) for k, v in hist.items()}
    return nets, ts, best_params, hist
