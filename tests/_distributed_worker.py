"""Subprocess worker for tests/test_distributed.py (not collected by pytest).

Run as: ``python tests/_distributed_worker.py <process_id> <num_processes>
<port>``. Each worker contributes 4 virtual CPU devices to a
``jax.distributed`` rendezvous on localhost — the multi-process (DCN) code
path the in-process 8-virtual-device mesh cannot exercise (SURVEY §4
"multi-host simulation on CPU") — then runs one
full-featured sharded MPC solve over the GLOBAL mesh and checks it against
the single-device :func:`plasma_control_tpu.control.mpc.plan` computed
locally. Prints ``DIST_OK {...}`` on success; any assertion kills the
worker with a non-zero exit code, which the parent test reports.
"""

import json
import os
import sys

import jax

# config.update before backend init pins the CPU (tests/conftest.py does the
# same). Collectives across processes on the CPU backend go through gloo.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 4)
jax.config.update("jax_cpu_collectives_implementation", "gloo")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    pid, nprocs, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]

    from plasma_control_tpu.parallel.launch import (
        initialize_distributed,
        is_multihost,
        process_summary,
    )

    active = initialize_distributed(
        coordinator_address=f"127.0.0.1:{port}", num_processes=nprocs, process_id=pid
    )
    assert active == (nprocs > 1), f"active={active} for {nprocs} processes"
    assert is_multihost() == (nprocs > 1)
    assert jax.process_index() == pid
    assert jax.local_device_count() == 4
    assert jax.device_count() == 4 * nprocs
    summary = process_summary()
    assert f"process {pid}/{nprocs}" in summary and "4 local" in summary

    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from plasma_control_tpu.config import ControlConfig, MPCConfig, SimConfig
    from plasma_control_tpu.control.actuator import make_actuator
    from plasma_control_tpu.control.mpc import plan
    from plasma_control_tpu.models.pic import PlasmaState, init_state
    from plasma_control_tpu.ops.grid import make_grid
    from plasma_control_tpu.parallel.pic_shard import make_sharded_plan

    # mirror tests/test_parallel.py::TestUnifiedShardedPlanner shapes
    cfg = SimConfig(n_particles=1000, n_mesh=32, dt=0.1, t_max=5.0)
    mpc = MPCConfig(horizon=4, n_candidates=32, plan_modes=4, w_terminal=2.0)
    ctrl = ControlConfig(max_mode=2)
    grid = make_grid(cfg.n_mesh, cfg.length)
    act = make_actuator(cfg.length, cfg.n_mesh, ctrl.max_mode)
    st0 = init_state(cfg, jax.random.PRNGKey(0))
    # host-numpy leaves: every process passes identical uncommitted values,
    # which jit lays out as replicated over the global mesh
    st = PlasmaState(np.asarray(st0.x), np.asarray(st0.v))

    mesh = Mesh(np.array(jax.devices()), ("rollout",))  # global: 4 * nprocs
    plan_fn = make_sharded_plan(mesh, grid, cfg, ctrl, mpc, act)

    mean = jnp.zeros((mpc.horizon, ctrl.n_actions))
    sigma = jnp.asarray(0.3)
    key = jax.random.PRNGKey(7)
    a1, m1, b1 = plan_fn(st, mean, sigma, key)
    a1, m1, b1 = np.asarray(a1), np.asarray(m1), float(b1)

    # single-process reference on this worker's local device 0
    a0, m0, b0 = plan(st, mean, sigma, key, grid, cfg, ctrl, mpc, act)
    a0, m0, b0 = np.asarray(a0), np.asarray(m0), float(b0)

    np.testing.assert_allclose(a1, a0, atol=1e-5)
    np.testing.assert_allclose(m1, m0, atol=1e-5)
    assert abs(b1 - b0) < 1e-4 * max(1.0, abs(b0)), (b1, b0)

    print(
        "DIST_OK "
        + json.dumps(
            {
                "pid": pid,
                "global_devices": jax.device_count(),
                "best_cost": b0,
                "action_linf": float(np.abs(a1 - a0).max()),
            }
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()
