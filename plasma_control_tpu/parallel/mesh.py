"""Device mesh construction and sharding helpers.

The reference is strictly single-process/single-device (SURVEY §2.6); scaling
is a first-class new capability here. The mesh follows the algorithm alone
(the cards of one host are joined all to all):

* axis ``"rollout"`` — data-parallel candidate/rollout batching (the MPC
  solver's K sampled control sequences; RL batch envs). Collectives: cost
  gather/top-k.
* axis ``"particle"`` — optional sharding of the particle axis for N >= 1M:
  deposition becomes local partial densities + ``psum`` of the small (M,)
  density vector; the gather needs only the replicated E_mesh.

Tests exercise these on a virtual 8-device CPU mesh; the same code runs
unchanged on several GPUs (``chip_smoke.py --four``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "shard_batch", "replicate", "P", "Mesh"]


def make_mesh(
    axis_sizes: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = ("rollout",),
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a mesh over available devices.

    Default: all devices along a single ``rollout`` axis. Pass
    ``axis_names=("rollout", "particle")`` with ``axis_sizes`` for 2D meshes.
    """
    devs = list(devices if devices is not None else jax.devices())
    if axis_sizes is None:
        axis_sizes = [len(devs)] + [1] * (len(axis_names) - 1)
    arr = np.array(devs).reshape(tuple(axis_sizes))
    return Mesh(arr, tuple(axis_names))


def shard_batch(tree, mesh: Mesh, axis: str = "rollout"):
    """Shard the leading axis of every leaf across ``axis``; replicate rest."""
    sharding = NamedSharding(mesh, P(axis))
    return jax.tree.map(lambda x: jax.device_put(x, sharding), tree)


def replicate(tree, mesh: Mesh):
    sharding = NamedSharding(mesh, P())
    return jax.tree.map(lambda x: jax.device_put(x, sharding), tree)
