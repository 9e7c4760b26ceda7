"""Test configuration: the suite runs on the CPU with 8 virtual devices, so
sharding and collective tests run without accelerators, and the Pallas
kernel runs in interpret mode. Tests marked ``gpu`` need the card: they skip
here, and ``chip_smoke.py`` runs them on the GPU with
``PLASMA_TESTS_ON_GPU=1``, which leaves the platform as JAX finds it.
"""

import functools
import os

import numpy as np
import pytest

import jax

if os.environ.get("PLASMA_TESTS_ON_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU; chip_smoke.py runs this on the card")


@pytest.fixture
def spectral_kernel_interpreted(monkeypatch):
    """Dispatch the spectral plan model to the whole-horizon kernel, run in
    the Pallas interpreter, as the GPU dispatch would compile it: for tests
    of the paths around the kernel (cost assembly, shard_map planners)."""
    from plasma_control_tpu.control import mpc

    monkeypatch.setattr(mpc, "_use_spectral_fused",
                        lambda plan_kernel, *_: plan_kernel != "xla")
    monkeypatch.setattr(mpc, "_spectral_kernel_costs",
                        functools.partial(mpc._spectral_kernel_costs, interpret=True))
