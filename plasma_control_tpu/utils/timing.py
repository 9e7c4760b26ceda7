"""Timing and profiling harness (SURVEY §5: the reference has none — only
tqdm bars).

Two measurement modes:

* :func:`time_fn` — classic warm-up + repeat + block timing.
* :func:`slope_time` — chains R data-dependent iterations of the op inside a
  single compiled ``lax.scan`` and differences wall times for two values of
  R, so the per-launch dispatch cost and the first iteration's warm-up
  cancel and only the per-iteration device time remains. Every timed call
  ends in ``block_until_ready``.

:func:`profile_trace` wraps ``jax.profiler`` for kernel-level inspection.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["time_fn", "slope_time", "mpc_solve_rate", "profile_trace"]


def time_fn(fn: Callable, *args, reps: int = 10, warmup: int = 1) -> float:
    """Mean seconds per call (warm-up excluded)."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    out = None
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def slope_time(step_fn: Callable, carry0, r1: int = 2, r2: int = 52) -> float:
    """Seconds per iteration of ``carry = step_fn(carry)`` measured by the
    two-length scan-chain slope (latency/dispatch effects cancel)."""

    def chained(r):
        @jax.jit
        def run(c):
            def body(c, _):
                return step_fn(c), ()

            c, _ = jax.lax.scan(body, c, None, length=r)
            return c

        return run

    f1, f2 = chained(r1), chained(r2)
    jax.block_until_ready(f1(carry0))
    jax.block_until_ready(f2(carry0))
    t0 = time.perf_counter()
    jax.block_until_ready(f1(carry0))
    ta = time.perf_counter() - t0
    t0 = time.perf_counter()
    jax.block_until_ready(f2(carry0))
    tb = time.perf_counter() - t0
    return max(tb - ta, 0.0) / (r2 - r1)


def mpc_solve_rate(
    state,
    grid,
    cfg,
    ctrl,
    mpc,
    actuator,
    r1: int = 2,
    r2: int = 52,
    trials: int = 5,
    plan_fn=None,
) -> dict:
    """Canonical MPC solves/s measurement: two-length warm-started solve
    chains (exactly the receding-horizon production pattern — each solve
    warm-starts from the previous nominal, no host sync inside a chain),
    rate = median chain-length slope over ``trials`` so the constant
    per-launch dispatch cost cancels.

    Single source of truth for bench.py and the experiments/ rate studies.
    Returns {"solves_per_s", "sec_per_solve_all", "wall_chain_s",
    "compile_s"}.

    Cold-compile note: both chain lengths run the SAME compiled program —
    the scan is always ``r2`` steps with the live solve count ``r`` a
    dynamic scalar (steps past ``r`` take a ``lax.cond`` passthrough whose
    cost is a carry copy, ~0 next to a solve, cancelling in the slope).
    This halves cold-compile time vs compiling one program per chain length.
    """
    from ..control.mpc import plan

    if plan_fn is None:
        # default: the single-device solve; pass e.g. a make_sharded_plan
        # closure to rate a multi-chip planner with the same methodology
        def plan_fn(st, mn_c, sg, k):
            return plan(st, mn_c, sg, k, grid, cfg, ctrl, mpc, actuator)

    mean = jnp.zeros((mpc.horizon, ctrl.n_actions), dtype=jnp.float32)
    sigma = jnp.asarray(mpc.sigma0, dtype=jnp.float32)

    @jax.jit
    def run(st, mn, key, r):
        def body(carry, ik):
            i, k = ik
            mn_c, best = carry

            def do(_):
                _, new_mean, b = plan_fn(st, mn_c, sigma, k)
                return new_mean, b

            def skip(_):
                return mn_c, best

            mn2, b2 = jax.lax.cond(i < r, do, skip, None)
            return (mn2, b2), b2

        (_, _), bests = jax.lax.scan(
            body,
            (mn, jnp.asarray(0.0, jnp.float32)),
            (jnp.arange(r2), jax.random.split(key, r2)),
        )
        return bests

    t0 = time.perf_counter()
    jax.block_until_ready(run(state, mean, jax.random.PRNGKey(1), r1))
    compile_s = time.perf_counter() - t0
    jax.block_until_ready(run(state, mean, jax.random.PRNGKey(2), r2))  # warm both lengths

    slopes, wall = [], []
    for i in range(trials):
        t0 = time.perf_counter()
        jax.block_until_ready(run(state, mean, jax.random.PRNGKey(10 + 2 * i), r1))
        ta = time.perf_counter() - t0
        t0 = time.perf_counter()
        jax.block_until_ready(run(state, mean, jax.random.PRNGKey(11 + 2 * i), r2))
        tb = time.perf_counter() - t0
        slopes.append((tb - ta) / (r2 - r1))
        wall.append(tb)
    est = float(np.median(slopes))
    return {
        "solves_per_s": 1.0 / est,
        "sec_per_solve_all": slopes,
        "wall_chain_s": float(np.median(wall)),
        "compile_s": compile_s,
    }


@contextlib.contextmanager
def profile_trace(logdir: str):
    """jax.profiler trace context; view with TensorBoard/xprof."""
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()
