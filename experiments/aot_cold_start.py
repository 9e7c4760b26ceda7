"""Cold-start measurement: fresh process -> first MPC solve via an AOT
artifact (the deployment story as a measured path, not just a module).

Run it on its own, after ``run_mpc.py --save_aot`` has built an artifact, so
the measurement includes everything a fresh serving process pays:
interpreter + jax import, backend attach, artifact load (pickled-executable
deserialize+load, or StableHLO deserialize + backend compile served by the
persistent compilation cache), and the first solve with outputs
materialized. Prints one JSON line. It opens the card itself, so no other
JAX process may hold it.

Usage: python experiments/aot_cold_start.py <artifact> <n_particles> <horizon> <n_actions>
"""

import json
import os
import sys
import time

_T_PROC0 = time.perf_counter()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import jax  # noqa: E402

from plasma_control_tpu.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax.numpy as jnp  # noqa: E402

from plasma_control_tpu.io.aot import load_compiled_plan, load_plan  # noqa: E402


def main() -> None:
    path = sys.argv[1]
    n, h, d = int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
    import_s = time.perf_counter() - _T_PROC0

    t0 = time.perf_counter()
    fn = load_compiled_plan(path) if path.endswith(".pkl") else load_plan(path)
    load_s = time.perf_counter() - t0

    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.uniform(0.0, 50.0, n), jnp.float32)
    v = jnp.asarray(rng.standard_normal(n), jnp.float32)
    mean = jnp.zeros((h, d), jnp.float32)

    t0 = time.perf_counter()
    out = fn(x, v, mean, jax.random.PRNGKey(0))
    action = np.asarray(out[3])  # control_step output: (x', v', mean', action, ...)
    first_solve_s = time.perf_counter() - t0
    assert np.isfinite(action).all()

    print(json.dumps({
        "artifact": os.path.basename(path),
        "import_s": round(import_s, 3),
        "load_s": round(load_s, 3),
        "first_solve_s": round(first_solve_s, 3),
        "total_s": round(time.perf_counter() - _T_PROC0, 3),
    }))


if __name__ == "__main__":
    main()
