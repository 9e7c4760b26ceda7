"""Benchmark harness — prints ONE JSON line with the headline metric.

Headline: full-horizon MPC solves/s on one GPU (BASELINE.json config 3:
bump-on-tail, 4 Fourier control modes, reference default workload N=5000
particles / 250 cells). The solve is the framework's quality-validated
default for this case: gridless spectral candidate dynamics at full
particle fidelity, plan_modes=8, horizon 6 with a terminal tail cost
(w_terminal=4: the solve charges 4 more steps of the final planning-model
field energy, which lets H=6 rank candidates like H=10), K=384
knot-sampled antithetic candidates. Quality gates (closed-loop, bench
scale, seed-paired — experiments/bench_growth_study.py, bench_k_study.py,
bench_fidelity_study.py): H6.w4 == H8 at 8 paired seeds on both cases
(bump-on-tail 13.2 vs 12.8, two-stream 27.5 vs 31.0); K=384 == K=512 at 16
paired two-stream seeds (mean 29.4 vs 29.9), while K=256 fails the
two-stream gate (+18% mean). A particle-subsampled planning model (plan
1024 of 5000) is harmful on this quiet workload (the planner cancels
subsample noise that does not exist in the real plasma); it is reported as
``mpc_solves_per_s_reduced_fidelity`` in BENCH_DETAILS.json, not as the
headline.

``vs_baseline`` compares against a compiled CPU implementation of the same
K x H solve with the reference's exact kernel semantics (native/pic_ref.cpp:
Thomas + Sherman-Morrison Poisson solve, CIC, Yoshida-4) at the same
(full-fidelity) shapes, measured in-process — the reference itself publishes
no numbers (BASELINE.md) and its hot kernels are Numba/LLVM-compiled, so
-O3 C++ is the single-core apples-to-apples baseline (a NumPy fallback is
used if no toolchain is available).

Details (push-throughput sub-benchmark, timings) go to BENCH_DETAILS.json.
The run needs a GPU and stops if JAX finds none.
"""

from __future__ import annotations

import json
import math
import time

import numpy as np

def _json_safe(obj):
    """NaN/Inf -> None, recursively: ``json.dumps`` would emit the bare
    token ``NaN`` (invalid per RFC 8259, rejected by strict parsers/jq)."""
    if isinstance(obj, dict):
        return {k: _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    return obj


def _numpy_reference_step_rate(n_particles: int, n_mesh: int, length: float, dt: float, reps: int = 30) -> float:
    """Steps/s of a reference-style NumPy PIC step (same math, CPU)."""
    rng = np.random.default_rng(0)
    x = rng.uniform(0, length, n_particles)
    v = rng.standard_normal(n_particles)
    dx = length / n_mesh

    # precomputed circulant E operator (the same one the JAX path uses)
    k = np.arange(n_mesh)
    lam = (2 * np.cos(2 * np.pi * k / n_mesh) - 2) / dx**2
    g = 1j * np.sin(2 * np.pi * k / n_mesh) / dx
    inv = np.zeros(n_mesh, dtype=complex)
    inv[1:] = 1.0 / lam[1:]
    eig = -g * inv
    col = np.fft.ifft(eig).real
    e_op = col[(k[:, None] - k[None, :]) % n_mesh]

    def accel(xp):
        xm = np.mod(xp, length)
        il = np.floor(xm / dx).astype(int)
        frac = xm / dx - il
        il %= n_mesh
        ir = (il + 1) % n_mesh
        n = np.bincount(il, weights=1.0 - frac, minlength=n_mesh)
        n += np.bincount(ir, weights=frac, minlength=n_mesh)
        n *= length / n_particles / dx
        e_mesh = e_op @ (n - 1.0)
        return -((1.0 - frac) * e_mesh[il] + frac * e_mesh[ir])

    phi = 2 ** (1 / 3)
    w0, w1 = -phi / (2 - phi), 1 / (2 - phi)
    cs = [0.5 * w1, 0.5 * (w0 + w1), 0.5 * (w0 + w1), 0.5 * w1]
    ds = [w1, w0, w1]

    def step(x, v):
        x = x + cs[0] * dt * v
        for c, d in zip(cs[1:], ds):
            v = v + d * dt * accel(x)
            x = x + c * dt * v
        return np.mod(x, length), v

    step(x, v)  # warm caches
    t0 = time.perf_counter()
    for _ in range(reps):
        x, v = step(x, v)
    return reps / (time.perf_counter() - t0)


def _native_reference_step_rate(n_particles, n_mesh, length, dt, reps=100, trials=5):
    """Steps/s of the compiled C++ reference-semantics step, or None.

    Takes the BEST of several trials: the host is shared and a loaded trial
    under-measures the baseline, which would inflate vs_baseline (observed
    4x swings). The max is the fairest number for the CPU and the
    conservative one for the reported ratio."""
    from plasma_control_tpu.utils.native import native_step, load_library

    if load_library() is None:
        return None
    rng = np.random.default_rng(0)
    x = rng.uniform(0, length, n_particles)
    v = rng.standard_normal(n_particles)
    native_step(x, v, n_mesh, length, dt)  # warm
    best = 0.0
    for _ in range(trials):
        xt, vt = x.copy(), v.copy()
        t0 = time.perf_counter()
        for _ in range(reps):
            xt, vt, _ = native_step(xt, vt, n_mesh, length, dt)
        best = max(best, reps / (time.perf_counter() - t0))
    return best


def main():
    import jax

    from plasma_control_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures the GPU; JAX reports {dev.platform!r}")

    from plasma_control_tpu.config import ControlConfig, MPCConfig, SimConfig
    from plasma_control_tpu.control.actuator import make_actuator
    from plasma_control_tpu.models.pic import init_state
    from plasma_control_tpu.models.rollout import rollout
    from plasma_control_tpu.ops.grid import make_grid
    from plasma_control_tpu.utils.timing import mpc_solve_rate

    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    details = {"device": device}

    # ---------------- headline: MPC solves/s (1 card) ----------------
    cfg = SimConfig(
        simcase="bump-on-tail", n_particles=5000, n_mesh=250, dt=0.1, t_max=50.0, length=50.0
    )
    ctrl = ControlConfig(max_mode=4)
    # Full-fidelity planning (candidate rollouts over all N particles). The
    # CPU baseline below is measured at the SAME full shapes so vs_baseline
    # compares equal work.
    mpc = MPCConfig(horizon=6, w_terminal=4.0, n_candidates=384, plan_modes=8)
    grid = make_grid(cfg.n_mesh, cfg.length)
    act = make_actuator(cfg.length, cfg.n_mesh, ctrl.max_mode)
    state = init_state(cfg, jax.random.PRNGKey(0))

    # Sustained throughput: the two-length warm-started solve-chain slope
    # (utils/timing.py::mpc_solve_rate).
    res = mpc_solve_rate(state, grid, cfg, ctrl, mpc, act)
    solves_per_s = res["solves_per_s"]
    details["mpc_compile_s"] = res["compile_s"]
    details["mpc_solves_per_s"] = solves_per_s
    details["mpc_ms_per_solve_all"] = [round(1e3 * s, 3) for s in res["sec_per_solve_all"]]
    details["mpc_wall_chain52_s"] = round(res["wall_chain_s"], 3)

    # Real-time margin: each solve advances one control period dt = 0.1
    # (simulation units, where w_pe = sqrt(n0) = 1 and the plasma period is
    # 2*pi), so the controller keeps up with any plasma whose
    # w_pe <= solves/s * dt rad/s.
    details["real_time_factor"] = {
        "plasma_periods_per_wall_s": round(solves_per_s * cfg.dt / (2 * np.pi), 2),
        "max_real_time_w_pe_rad_per_s": round(solves_per_s * cfg.dt, 1),
    }

    # Secondary: the XLA scan planner at the same shapes.
    mpc_xla = MPCConfig(horizon=6, w_terminal=4.0, n_candidates=384,
                        plan_modes=8, plan_kernel="xla")
    details["mpc_solves_per_s_xla"] = mpc_solve_rate(
        state, grid, cfg, ctrl, mpc_xla, act
    )["solves_per_s"]

    # Secondary: the particle-subsampled planning configuration (plan 1024 of
    # 5000, Km=16, H=10) — valid only for strong-signal regimes (e.g. a
    # growing two-stream); harmful on this quiet bump-on-tail workload
    # (module docstring). Recorded for the scaling story, not the headline.
    mpc_rf = MPCConfig(horizon=10, n_candidates=512, plan_particles=1024, plan_mesh=64)
    details["mpc_solves_per_s_reduced_fidelity"] = mpc_solve_rate(
        state, grid, cfg, ctrl, mpc_rf, act
    )["solves_per_s"]

    # ---------------- sub-benchmark: particle-push steps/s ----------------
    cfg1 = SimConfig(simcase="two-stream", n_particles=10000, n_mesh=64, dt=0.1, t_max=50.0)
    grid1 = make_grid(cfg1.n_mesh, cfg1.length)
    st1 = init_state(cfg1, jax.random.PRNGKey(0))
    roll = jax.jit(lambda s: rollout(s, grid1, cfg1, n_steps=500).final_state)
    t0 = time.perf_counter()
    jax.block_until_ready(roll(st1))
    details["rollout_compile_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(3):
        out1 = roll(st1)
    jax.block_until_ready(out1)
    details["push_steps_per_s"] = 3 * 500 / (time.perf_counter() - t0)

    # ---------------- CPU baseline (reference-style NumPy) ----------------
    plan_n = mpc.plan_particles or cfg.n_particles
    plan_m = mpc.plan_mesh or cfg.n_mesh
    np_rate = _native_reference_step_rate(plan_n, plan_m, cfg.length, cfg.dt)
    if np_rate is None:
        details["cpu_baseline"] = "numpy"
        np_rate = _numpy_reference_step_rate(plan_n, plan_m, cfg.length, cfg.dt, reps=100)
    else:
        details["cpu_baseline"] = "native-cpp"
    details["numpy_step_rate"] = np_rate
    # one full solve = n_candidates * horizon PIC steps
    np_solves_per_s = np_rate / (mpc.n_candidates * mpc.horizon)
    details["numpy_solves_per_s"] = np_solves_per_s

    vs_baseline = solves_per_s / np_solves_per_s

    with open("BENCH_DETAILS.json", "w") as f:
        json.dump(_json_safe(details), f, indent=2)

    print(
        json.dumps(
            _json_safe(
                {
                    "metric": "mpc_solves_per_s",
                    "value": round(solves_per_s, 3),
                    "unit": "solves/s",
                    "vs_baseline": round(vs_baseline, 2),
                    "device": device,
                }
            )
        )
    )


if __name__ == "__main__":
    main()
