"""Multi-host launch helpers.

The reference has no distributed runtime (SURVEY §2.6). In a multi-process
launch, each process calls :func:`initialize_distributed` once before any
jax call that touches devices, with the coordinator given explicitly or
through environment variables; otherwise this is a no-op.
"""

from __future__ import annotations

import os
from typing import Optional

import jax

__all__ = ["initialize_distributed", "is_multihost", "process_summary"]


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialize jax.distributed from explicit arguments or the
    ``JAX_COORDINATOR_ADDRESS``/``JAX_NUM_PROCESSES``/``JAX_PROCESS_ID``
    environment variables. Returns True if distributed mode is active;
    with neither, nothing is initialized and it returns False.
    """
    coordinator_address = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])

    if coordinator_address is None and num_processes is None:
        return False

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return jax.process_count() > 1


def is_multihost() -> bool:
    return jax.process_count() > 1


def process_summary() -> str:
    return (
        f"process {jax.process_index()}/{jax.process_count()}, "
        f"{jax.local_device_count()} local / {jax.device_count()} global devices"
    )
