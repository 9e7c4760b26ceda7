"""Device-resident replay buffer.

Capability parity with ``ReplayBuffer`` (`/root/reference/src/control/rl/ddpg.py:24-41`,
a Python deque of torch tensors) re-designed for compiled training: preallocated device
arrays with a ring pointer, living inside jitted training scans (no host
round-trips per transition). Sampling is uniform over the filled region.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

__all__ = ["ReplayBuffer", "buffer_init", "buffer_push", "buffer_sample"]


class ReplayBuffer(NamedTuple):
    """Ring-buffer storage for (s, a, s', r, done, a_bc) transitions
    (`ddpg.py:18-22`)."""

    state: jax.Array  # (C, S)
    action: jax.Array  # (C, A)
    next_state: jax.Array  # (C, S)
    reward: jax.Array  # (C,)
    done: jax.Array  # (C,)
    action_bc: jax.Array  # (C, A)
    ptr: jax.Array  # () int32 next write slot
    size: jax.Array  # () int32 filled count


def buffer_init(capacity: int, state_dim: int, action_dim: int, dtype=jnp.float32) -> ReplayBuffer:
    z = jnp.zeros
    return ReplayBuffer(
        state=z((capacity, state_dim), dtype),
        action=z((capacity, action_dim), dtype),
        next_state=z((capacity, state_dim), dtype),
        reward=z((capacity,), dtype),
        done=z((capacity,), dtype),
        action_bc=z((capacity, action_dim), dtype),
        ptr=jnp.zeros((), jnp.int32),
        size=jnp.zeros((), jnp.int32),
    )


def buffer_push(buf: ReplayBuffer, state, action, next_state, reward, done, action_bc=None) -> ReplayBuffer:
    cap = buf.state.shape[0]
    i = buf.ptr
    if action_bc is None:
        action_bc = jnp.zeros_like(action)
    return ReplayBuffer(
        state=jax.lax.dynamic_update_index_in_dim(buf.state, state, i, 0),
        action=jax.lax.dynamic_update_index_in_dim(buf.action, action, i, 0),
        next_state=jax.lax.dynamic_update_index_in_dim(buf.next_state, next_state, i, 0),
        reward=buf.reward.at[i].set(reward),
        done=buf.done.at[i].set(done),
        action_bc=jax.lax.dynamic_update_index_in_dim(buf.action_bc, action_bc, i, 0),
        ptr=(i + 1) % cap,
        size=jnp.minimum(buf.size + 1, cap),
    )


def buffer_sample(buf: ReplayBuffer, key: jax.Array, batch_size: int):
    """Uniform sample over the filled region (with replacement, a standard
    relaxation of the reference's ``random.sample``, `ddpg.py:36-37`)."""
    idx = jax.random.randint(key, (batch_size,), 0, jnp.maximum(buf.size, 1))
    take = lambda arr: jnp.take(arr, idx, axis=0)
    return (
        take(buf.state),
        take(buf.action),
        take(buf.next_state),
        take(buf.reward),
        take(buf.done),
        take(buf.action_bc),
    )
