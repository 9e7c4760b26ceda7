"""Ahead-of-time artifacts for the MPC solve — the deployment/serving story.

The reference has no deployment path at all (every run re-builds everything
in-process, `/root/reference/run_ddpg.py:135-186`); this module lets a
controller be *shipped*: trace/compile once, persist, and bring a fresh
process (or another host with the same devices) to a ready solve without
re-tracing the framework.

Two artifact kinds, complementary:

* :func:`export_plan` / :func:`load_plan` — **portable StableHLO** via
  ``jax.export``. The artifact pins shapes/dtypes and the lowering
  platform; loading skips Python tracing entirely (no framework objects
  needed). The backend compile still runs at first call, served by the
  persistent compilation cache when it holds the program.
* :func:`save_compiled_plan` / :func:`load_compiled_plan` — **pickled XLA
  executable** (``jax.experimental.serialize_executable``): near-instant
  load, but valid only on the same topology + compiler version. This is
  the "warm spare" artifact for elastic recovery of a long control run.

Both wrap the same solve step: ``(x, v, mean, key) -> (action, new_mean,
best_cost)`` — :func:`plasma_control_tpu.control.mpc.plan` with the static
configuration closed over, exactly the receding-horizon production step.

For full closed-loop serving there is also the **control step** —
``(x, v, mean, key) -> (x', v', mean', action, pe, ke, ie, best)`` — the
exact ``lax.scan`` body of :func:`plasma_control_tpu.control.mpc.
mpc_rollout` (solve + apply + env step + warm-start shift). A host loop
over the artifact is bit-equal to a host loop over the live jitted step
(same traced program) and matches the scan-form ``mpc_rollout`` up to
fp reassociation noise of the two separately compiled programs
(tests/test_aot.py::TestControlStep measures both contracts).
``run_mpc.py --save_aot``/``--aot <artifact>`` builds and runs the closed
loop this way, with a :func:`config_fingerprint` sidecar (configuration,
JAX version, platform) that ``--aot`` checks before loading;
``experiments/aot_cold_start.py`` times a fresh process through an artifact.
Unpickling executes code, so a pickled executable is never auto-loaded
(see :func:`load_compiled_plan`'s warning).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import pickle
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp

from ..config import ControlConfig, MPCConfig, SimConfig
from ..control.actuator import FourierActuator
from ..control.mpc import plan
from ..models.pic import PlasmaState
from ..ops.grid import Grid

__all__ = [
    "check_fingerprint",
    "config_fingerprint",
    "write_fingerprint",
    "plan_step_fn",
    "plan_example_args",
    "control_step_fn",
    "export_plan",
    "load_plan",
    "save_compiled_plan",
    "load_compiled_plan",
    "aot_mpc_rollout",
]


def config_fingerprint(cfg: SimConfig, ctrl: ControlConfig, mpc: MPCConfig) -> str:
    """Staleness key of an exported artifact: the configuration, the JAX
    version and the platform it is lowered for (an artifact lowered for
    one platform cannot run on another)."""
    return hashlib.sha256(
        json.dumps(
            {
                "cfg": dataclasses.asdict(cfg),
                "ctrl": dataclasses.asdict(ctrl),
                "mpc": dataclasses.asdict(mpc),
                "jax": jax.__version__,
                "platform": jax.default_backend(),
            },
            sort_keys=True,
            default=str,
        ).encode()
    ).hexdigest()


def write_fingerprint(path: str, cfg: SimConfig, ctrl: ControlConfig, mpc: MPCConfig) -> None:
    """Write the ``<path>.meta.json`` sidecar of an artifact built at ``path``."""
    with open(path + ".meta.json", "w") as f:
        json.dump({"config_sha256": config_fingerprint(cfg, ctrl, mpc)}, f)


def check_fingerprint(path: str, cfg: SimConfig, ctrl: ControlConfig, mpc: MPCConfig) -> None:
    """Raise ValueError unless the artifact at ``path`` was built for this
    configuration, JAX version and platform."""
    try:
        with open(path + ".meta.json") as f:
            built = json.load(f).get("config_sha256")
    except FileNotFoundError:
        built = None
    if built != config_fingerprint(cfg, ctrl, mpc):
        raise ValueError(
            f"{path} was built for another configuration, JAX version or "
            "platform (or has no .meta.json sidecar); rebuild it with --save_aot"
        )


def plan_step_fn(
    grid: Grid,
    cfg: SimConfig,
    ctrl: ControlConfig,
    mpc: MPCConfig,
    actuator: FourierActuator,
    sigma: Optional[jax.Array] = None,
) -> Callable:
    """The jittable production solve step with all static config closed over:
    ``(x, v, mean, key) -> (action, new_mean, best_cost)``."""
    sigma_arr = jnp.asarray(mpc.sigma0 if sigma is None else sigma, jnp.float32)

    def step(x, v, mean, key):
        return plan(PlasmaState(x, v), mean, sigma_arr, key, grid, cfg, ctrl, mpc, actuator)

    return step


def control_step_fn(
    grid: Grid,
    cfg: SimConfig,
    ctrl: ControlConfig,
    mpc: MPCConfig,
    actuator: FourierActuator,
) -> Callable:
    """The jittable closed-loop CONTROL step — the exact scan body of
    :func:`plasma_control_tpu.control.mpc.mpc_rollout` (solve, apply the
    first action through the actuator, advance the plasma one env step,
    shift the warm start): ``(x, v, mean, key) ->
    (x', v', mean', action, pe, ke, ie, best)``. A host loop over this
    function with ``jax.random.split(key, T)`` reproduces
    ``mpc_rollout(..., key)`` exactly — the serving form of the controller.
    """
    from ..models.pic import step as env_step
    from ..models.rollout import _energies

    sigma = jnp.asarray(mpc.sigma0, jnp.float32)

    def ctrl_step(x, v, mean, key):
        st = PlasmaState(x, v)
        action, new_mean, best = plan(st, mean, sigma, key, grid, cfg, ctrl, mpc, actuator)
        e_ext = actuator.compute_e_packed(action)
        new_st = env_step(st, grid, cfg, e_ext)
        pe, ke = _energies(new_st, grid, cfg)
        ie = actuator.input_energy(action)
        shifted = jnp.concatenate([new_mean[1:], new_mean[-1:]])
        return new_st.x, new_st.v, shifted, action, pe, ke, ie, best

    return ctrl_step


def plan_example_args(cfg: SimConfig, ctrl: ControlConfig, mpc: MPCConfig) -> Tuple:
    """Abstract example arguments fixing the exported shapes/dtypes."""
    n = cfg.n_particles
    return (
        jnp.zeros((n,), jnp.float32),
        jnp.zeros((n,), jnp.float32),
        jnp.zeros((mpc.horizon, ctrl.n_actions), jnp.float32),
        jax.random.PRNGKey(0),
    )


def _build_fn(grid, cfg, ctrl, mpc, actuator, kind: str) -> Callable:
    if kind == "plan":
        return plan_step_fn(grid, cfg, ctrl, mpc, actuator)
    if kind == "control_step":
        return control_step_fn(grid, cfg, ctrl, mpc, actuator)
    raise ValueError(f"unknown AOT artifact kind {kind!r}")


def export_plan(
    grid: Grid,
    cfg: SimConfig,
    ctrl: ControlConfig,
    mpc: MPCConfig,
    actuator: FourierActuator,
    path: Optional[str] = None,
    kind: str = "plan",
) -> bytes:
    """Serialize the solve step (``kind="plan"``) or the full closed-loop
    control step (``kind="control_step"``) as a portable StableHLO artifact
    (current default platform). Returns the bytes; writes them to ``path``
    if given."""
    from jax import export as jexport

    fn = jax.jit(_build_fn(grid, cfg, ctrl, mpc, actuator, kind))
    # the GPU planning kernel lowers to Triton IR, which JAX does not promise
    # to keep loadable across versions: an artifact is only valid for the
    # JAX version and platform of its config_fingerprint
    triton = jexport.DisabledSafetyCheck.custom_call("__gpu$xla.gpu.triton")
    blob = jexport.export(fn, disabled_checks=[triton])(
        *plan_example_args(cfg, ctrl, mpc)).serialize()
    if path is not None:
        with open(path, "wb") as f:
            f.write(blob)
    return blob


def load_plan(blob_or_path) -> Callable:
    """Load an :func:`export_plan` artifact; returns the callable solve step
    (no framework tracing — shapes/platform are pinned in the artifact)."""
    from jax import export as jexport

    if isinstance(blob_or_path, (bytes, bytearray)):
        blob = bytes(blob_or_path)
    else:
        with open(blob_or_path, "rb") as f:
            blob = f.read()
    return jexport.deserialize(blob).call


def save_compiled_plan(
    path: str,
    grid: Grid,
    cfg: SimConfig,
    ctrl: ControlConfig,
    mpc: MPCConfig,
    actuator: FourierActuator,
    kind: str = "plan",
) -> None:
    """Compile the solve step (or full control step, ``kind="control_step"``)
    now and pickle the XLA executable (same topology/compiler only — the
    fast-resume artifact)."""
    from jax.experimental import serialize_executable as se

    fn = jax.jit(_build_fn(grid, cfg, ctrl, mpc, actuator, kind))
    compiled = fn.lower(*plan_example_args(cfg, ctrl, mpc)).compile()
    payload, in_tree, out_tree = se.serialize(compiled)
    try:  # single-program jit: replicas * partitions devices (normally 1)
        xe = compiled._executable.xla_executable
        n_devices = xe.num_replicas * xe.num_partitions
    except AttributeError:
        n_devices = 1
    with open(path, "wb") as f:
        pickle.dump(
            {"payload": payload, "in_tree": in_tree, "out_tree": out_tree,
             "num_devices": n_devices},
            f,
        )


def aot_mpc_rollout(
    ctrl_step: Callable,
    state: PlasmaState,
    key: jax.Array,
    n_steps: int,
    horizon: int,
    n_actions: int,
):
    """Closed-loop receding-horizon control as a HOST loop over an AOT
    ``control_step`` artifact (:func:`load_plan` / :func:`load_compiled_plan`
    of a ``kind="control_step"`` export). Reproduces
    ``mpc_rollout(state, ..., key, n_steps)`` exactly: same zero initial
    nominal, same ``jax.random.split(key, T)`` per-solve key schedule, same
    scan-body semantics (the artifact IS the scan body). Returns an
    :class:`plasma_control_tpu.control.mpc.MPCOutput`.

    This is the serving form: one device program launch per control period,
    ready on a fresh process at artifact-load (not XLA-compile) latency.
    """
    from ..control.mpc import MPCOutput

    x, v = state.x, state.v
    mean = jnp.zeros((horizon, n_actions), jnp.float32)
    keys = jax.random.split(key, n_steps)
    pe, ke, coeffs, ie, best = [], [], [], [], []
    for i in range(n_steps):
        x, v, mean, a, p, k_, e, b = ctrl_step(x, v, mean, keys[i])
        pe.append(p); ke.append(k_); coeffs.append(a); ie.append(e); best.append(b)
    pe = jnp.stack(pe); ke = jnp.stack(ke)
    return MPCOutput(
        final_state=PlasmaState(x, v),
        field_energy=pe,
        kinetic=ke,
        hamiltonian=pe + ke,
        coeffs=jnp.stack(coeffs),
        input_energy=jnp.stack(ie),
        plan_cost=jnp.stack(best),
        final_mean=mean,
    )


def load_compiled_plan(path: str) -> Callable:
    """Load a :func:`save_compiled_plan` executable (near-instant; raises if
    the topology/compiler no longer matches).

    .. warning:: The artifact is a pickle (inherent to
       ``jax.experimental.serialize_executable``'s in/out tree payload), and
       unpickling executes code from the file. Only load artifacts you
       produced or obtained from a trusted source; for anything crossing a
       trust boundary use the StableHLO path (:func:`export_plan` /
       :func:`load_plan`), whose artifact is pure serialized IR.
    """
    from jax.experimental import serialize_executable as se

    with open(path, "rb") as f:
        d = pickle.load(f)
    # bind to exactly as many devices as the program was compiled for —
    # otherwise the loader binds the whole client (e.g. the 8-virtual-device
    # CI mesh) and execution rejects single-shard arguments
    devs = jax.devices()[: d.get("num_devices", 1)]
    return se.deserialize_and_load(
        d["payload"], d["in_tree"], d["out_tree"], execution_devices=devs
    )
