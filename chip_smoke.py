"""Smoke test of the receding-horizon MPC controller on NVIDIA GPUs.

    python chip_smoke.py          # one card: physics, planner kernel, closed loop
    python chip_smoke.py --four   # four cards: the sharded planner and the
                                  # particle-sharded step, each against one card

Every phase compares what the card computes with a plain reference and
prints the compared quantity beside its tolerance; any failure exits
non-zero. The last line of standard output is one JSON object naming the
device. Without a GPU the script exits non-zero before any phase runs.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(ok: bool, msg: str):
    print(("ok   " if ok else "FAIL ") + msg, flush=True)
    if not ok:
        sys.exit(1)


def phase_device(n_cards: int):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        fail(f"no GPU: JAX reports platform {devs[0].platform!r}")
    if len(devs) < n_cards:
        fail(f"need {n_cards} GPUs, JAX reports {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    for line in smi[:n_cards]:
        print(f"card: {line}")
    print(f"jax {jax.__version__}: {len(devs)} x {devs[0].device_kind}", flush=True)
    return devs


def _config3():
    """BASELINE config 3, the headline controller: bump-on-tail, N=5000,
    M=250, 4 actuated modes; spectral planner, Km=8, K=384, H=6, terminal
    weight 4, knot sampler."""
    from plasma_control_tpu.cli import (
        add_control_args, add_mpc_args, base_parser, build_control_config,
        build_mpc_config, build_sim_config)

    p = add_mpc_args(add_control_args(base_parser("chip smoke")))
    args = vars(p.parse_args([
        "--simcase", "bump-on-tail", "--num_particle", "5000", "--num_mesh", "250",
        "--L", "50", "--dt", "0.1", "--max_mode", "4", "--plan_modes", "8",
        "--n_candidates", "384", "--horizon", "6", "--w_terminal", "4",
    ]))
    return build_sim_config(args), build_control_config(args), build_mpc_config(args)


def _config4():
    """BASELINE config 4 with its full-fidelity controller of record:
    two-stream, N=100k, M=256, 8 actuated modes; K=384, H=10, Km=16."""
    import dataclasses

    from plasma_control_tpu.config import ControlConfig, SimConfig

    _, _, mpc3 = _config3()
    cfg = SimConfig(simcase="two-stream", n_particles=100_000, n_mesh=256,
                    dt=0.1, length=50.0)
    return cfg, ControlConfig(max_mode=8), dataclasses.replace(
        mpc3, horizon=10, plan_modes=16, w_terminal=0.0)


def _config5():
    """BASELINE config 5's environment: two-stream, N=1M, M=256."""
    from plasma_control_tpu.config import SimConfig

    return SimConfig(simcase="two-stream", n_particles=1_000_000, n_mesh=256,
                     dt=0.1, length=50.0)


def _model(cfg, ctrl):
    import jax

    from plasma_control_tpu.control.actuator import make_actuator
    from plasma_control_tpu.models.pic import init_state
    from plasma_control_tpu.ops.grid import make_grid

    grid = jax.device_put(make_grid(cfg.n_mesh, cfg.length))
    act = make_actuator(cfg.length, cfg.n_mesh, ctrl.max_mode,
                        endpoint_grid=ctrl.endpoint_grid)
    return grid, act, init_state(cfg, jax.random.PRNGKey(cfg.seed))


def phase_physics():
    """Config 1 (two-stream, N=10k, M=64), 50 uncontrolled Yoshida-4 steps
    in float32 on the card against the float64 NumPy oracle."""
    import jax

    from plasma_control_tpu.config import ControlConfig, SimConfig
    from plasma_control_tpu.models.rollout import rollout
    sys.path.insert(0, "tests")
    import oracle

    cfg = SimConfig(simcase="two-stream", n_particles=10_000, n_mesh=64,
                    dt=0.1, length=50.0)
    grid, _, st = _model(cfg, ControlConfig())
    steps = 50
    out = jax.jit(lambda s: rollout(s, grid, cfg, n_steps=steps))(st)
    x32, pe32 = np.asarray(out.final_state.x), np.asarray(out.field_energy)

    x, v = np.asarray(st.x, np.float64), np.asarray(st.v, np.float64)
    pe64 = [oracle.electric_energy(x, cfg.length, cfg.n_mesh, cfg.n0)]
    for _ in range(steps):
        x, v = oracle.yoshida4_step(x, v, cfg.length, cfg.n_mesh, cfg.n0,
                                    cfg.clamped_dt())
        pe64.append(oracle.electric_energy(x, cfg.length, cfg.n_mesh, cfg.n0))
    pe64 = np.asarray(pe64)
    dx = np.abs(x32 - x)
    dx = np.minimum(dx, cfg.length - dx).max()
    dpe = np.max(np.abs(pe32 - pe64) / pe64)
    # float32 rounding (~1e-7 relative per operation) grown by the unstable
    # two-stream over t=5: the same comparison in float32 on the CPU reaches
    # 1.0e-4 in position and 2.8e-6 relative in field energy; the limits
    # leave ten times that and more
    tol_x, tol_pe = 1e-3, 1e-4
    print("phase physics: float32, matmuls at Precision.HIGHEST, vs float64 oracle")
    check(bool(np.isfinite(x32).all() and np.isfinite(pe32).all()), "finite outputs")
    check(dx <= tol_x, f"max |x - x_oracle| = {dx:.3e} (tol {tol_x:g})")
    check(dpe <= tol_pe, f"max rel |PE - PE_oracle| = {dpe:.3e} (tol {tol_pe:g})")


def phase_planner_kernel():
    """The whole-horizon spectral kernel, as compiled for the card, against
    the XLA scan (`_horizon_cost_spectral`) at config-3 and config-4 shapes."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from plasma_control_tpu.control.mpc import candidate_costs

    rtol = 2e-4  # fp32 reassociation plus the rot drift's polynomial rotation
    for name, (cfg, ctrl, mpc) in (("config 3", _config3()), ("config 4", _config4())):
        grid, act, st = _model(cfg, ctrl)
        cand = jnp.clip(0.3 * jax.random.normal(
            jax.random.PRNGKey(1), (mpc.n_candidates, mpc.horizon, ctrl.n_actions)),
            ctrl.coeff_min, ctrl.coeff_max)
        ref = np.asarray(candidate_costs(
            st, cand, grid, cfg, dataclasses.replace(mpc, plan_kernel="xla"), act))
        for drift in ("rot", "trig"):
            got = np.asarray(candidate_costs(
                st, cand, grid, cfg,
                dataclasses.replace(mpc, plan_kernel="fused", spectral_drift=drift), act))
            err = np.max(np.abs(got - ref) / np.abs(ref))
            print(f"phase planner kernel, {name} (N={cfg.n_particles}, K={mpc.n_candidates}, "
                  f"H={mpc.horizon}, Km={mpc.plan_modes}): kernel {drift} drift vs XLA trig, float32")
            check(bool(np.isfinite(got).all()), "finite costs")
            check(err <= rtol, f"max rel cost error {err:.3e} (rtol {rtol:g})")
            check(int(np.argmin(got)) == int(np.argmin(ref)),
                  f"argmin {int(np.argmin(got))} == {int(np.argmin(ref))}")


def phase_card_tests():
    """The tests marked ``gpu`` (kernel compiled for the card against the
    Pallas interpreter), in this process."""
    import os

    import pytest

    class Outcomes:
        passed = skipped = 0

        def pytest_runtest_logreport(self, report):
            if report.passed and report.when == "call":
                self.passed += 1
            elif report.skipped:
                self.skipped += 1

    os.environ["PLASMA_TESTS_ON_GPU"] = "1"
    print("phase card tests: pytest -m gpu tests/test_pallas.py", flush=True)
    seen = Outcomes()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider", "tests/test_pallas.py"],
                     plugins=[seen])
    check(rc == 0 and seen.passed > 0 and seen.skipped == 0,
          f"card tests: exit code {int(rc)}, {seen.passed} passed, {seen.skipped} skipped")


def phase_closed_loop(steps: int = 20):
    """Config 3 closed loop through `mpc_rollout`, as `run_mpc.py` drives it."""
    import dataclasses

    import jax

    from plasma_control_tpu.control.mpc import mpc_rollout, plan

    cfg, ctrl, mpc = _config3()
    grid, act, st = _model(cfg, ctrl)
    key = jax.random.PRNGKey(cfg.seed + 1)
    t0 = time.perf_counter()
    out = mpc_rollout(st, grid, cfg, ctrl, mpc, act, key, n_steps=steps)
    pe = np.asarray(out.field_energy)
    print(f"phase closed loop: config 3, {steps} control periods "
          f"({time.perf_counter() - t0:.1f} s with compilation), float32")
    print("field energy: " + " ".join(f"{p:.4g}" for p in pe))
    finite = all(np.isfinite(np.asarray(a)).all() for a in jax.tree.leaves(out))
    check(finite, "every output finite")
    # first action against an XLA-planner solve from the loop's first key
    mean0 = jax.numpy.zeros((mpc.horizon, ctrl.n_actions))
    sigma = jax.numpy.asarray(mpc.sigma0)
    a_xla, _, _ = plan(st, mean0, sigma, jax.random.split(key, steps)[0], grid, cfg,
                       ctrl, dataclasses.replace(mpc, plan_kernel="xla"), act)
    diff = float(np.max(np.abs(np.asarray(out.coeffs[0]) - np.asarray(a_xla))))
    # MPPI's softmax at temperature 0.05 turns the planners' fp32-level cost
    # differences into small shifts of the weighted mean
    tol = 0.05
    check(diff <= tol, f"first action vs XLA planner: max |diff| = {diff:.3e} "
                       f"(tol {tol:g}, coefficient bound {ctrl.coeff_max:g})")


def phase_four():
    """Four cards: the rollout-sharded planner at config-3 shapes and the
    particle-sharded Yoshida-4 step at N=1M, M=256, each against one card."""
    import jax
    import jax.numpy as jnp

    from plasma_control_tpu.control.mpc import plan
    from plasma_control_tpu.models.pic import PlasmaState, step
    from plasma_control_tpu.parallel.mesh import make_mesh, shard_batch
    from plasma_control_tpu.parallel.pic_shard import (
        make_particle_sharded_step, make_sharded_plan)

    devs = jax.devices()[:4]
    cfg, ctrl, mpc = _config3()
    grid, act, st = _model(cfg, ctrl)
    mesh = make_mesh((4,), ("rollout",), devices=devs)
    key = jax.random.PRNGKey(7)
    mean0 = jnp.zeros((mpc.horizon, ctrl.n_actions))
    sigma = jnp.asarray(mpc.sigma0)
    a4, _, b4 = make_sharded_plan(mesh, grid, cfg, ctrl, mpc, act)(st, mean0, sigma, key)
    a1, _, b1 = plan(st, mean0, sigma, key, grid, cfg, ctrl, mpc, act)
    da = float(np.max(np.abs(np.asarray(a4) - np.asarray(a1))))
    db = abs(float(b4) - float(b1)) / abs(float(b1))
    print("phase four: make_sharded_plan on a 4-card rollout mesh vs one card, "
          "config 3, float32")
    check(da <= 1e-3, f"first action max |diff| = {da:.3e} (tol 1e-3)")
    check(db <= 1e-5, f"best cost rel diff = {db:.3e} (tol 1e-5)")

    cfg5 = _config5()
    grid5, _, st5 = _model(cfg5, ctrl)
    pmesh = make_mesh((4,), ("particle",), devices=devs)
    step4 = make_particle_sharded_step(pmesh, grid5, cfg5)
    e0 = jnp.zeros((cfg5.n_mesh,))
    x4, v4 = step4(shard_batch(st5.x, pmesh, "particle"),
                   shard_batch(st5.v, pmesh, "particle"), e0)
    ref = jax.jit(lambda s: step(s, grid5, cfg5, e0))(PlasmaState(st5.x, st5.v))
    dx = np.abs(np.asarray(x4) - np.asarray(ref.x))
    dx = float(np.minimum(dx, cfg5.length - dx).max())
    dv = float(np.max(np.abs(np.asarray(v4) - np.asarray(ref.v))))
    # the psum adds the four partial densities in another order than one card
    print("phase four: make_particle_sharded_step on a 4-card particle mesh vs "
          f"one card, N={cfg5.n_particles}, M={cfg5.n_mesh}, one Yoshida-4 step, float32")
    check(dx <= 1e-4, f"max |x diff| = {dx:.3e} (tol 1e-4)")
    check(dv <= 1e-4, f"max |v diff| = {dv:.3e} (tol 1e-4)")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card phase")
    n_cards = 4 if ap.parse_args().four else 1

    from plasma_control_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    devs = phase_device(n_cards)
    if n_cards == 4:
        phase_four()
    else:
        phase_physics()
        phase_planner_kernel()
        phase_card_tests()
        phase_closed_loop()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind, "count": len(devs)}}))


if __name__ == "__main__":
    main()
