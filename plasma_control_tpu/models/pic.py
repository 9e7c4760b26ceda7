"""Particle-in-cell simulation: functional core + stateful convenience wrapper.

Capability parity with class ``PIC`` (`/root/reference/src/env/pic.py:11-223`),
re-designed as pure compiled functions:

* the state is an immutable pytree ``(x, v)``; stepping is a pure function
  usable under ``jit``/``vmap``/``lax.scan``;
* one Yoshida-4 step performs exactly 3 deposit+solve+gather pipelines (the
  kick substages) instead of the reference's ~11 redundant ones (SURVEY §3.1);
* RNG is explicit (`jax.random` keys) instead of the class-scope
  ``np.random.seed(42)`` (`/root/reference/src/env/pic.py:12`).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..config import SimConfig
from ..ops.deposit import deposit, gather
from ..ops.fields import electric_energy, kinetic_energy, solve_e_mesh
from ..ops.grid import Grid, make_grid
from ..ops.integrate import INTEGRATORS
from .distributions import make_distribution, sample_initial_state

__all__ = ["PlasmaState", "step", "make_accel_fn", "init_state", "PIC"]


class PlasmaState(NamedTuple):
    """Particle phase-space state; both arrays have shape (N,) (or (B, N)
    under vmap)."""

    x: jax.Array
    v: jax.Array


def init_state(cfg: SimConfig, key: jax.Array, dtype=jnp.float32) -> PlasmaState:
    """Sample the initial distribution with perturbation applied
    (parity with ``PIC.initialize``, `/root/reference/src/env/pic.py:63-79`)."""
    x, v = sample_initial_state(cfg, key, dtype=dtype)
    return PlasmaState(x=x, v=v)


def make_accel_fn(
    grid: Grid,
    cfg: SimConfig,
    e_external: Optional[jax.Array] = None,
    e_external_fn: Optional[Callable[[jax.Array], jax.Array]] = None,
):
    """dv/dt = -(E_self(x) + E_ext) gathered at particle positions.

    Parity with ``PIC.compute_state_gradient``
    (`/root/reference/src/env/pic.py:125-129`): the external mesh field is
    added to the self-consistent mesh field *before* the gather, and held
    constant over the step (zero-order hold), exactly as ``update_state`` does.
    ``e_external_fn`` supports the state-dependent variant
    ``update_state_w_input_func`` (`pic.py:148-163`).
    """

    def accel(x: jax.Array) -> jax.Array:
        n = deposit(x, grid, n0=cfg.n0, kind=cfg.interpol, method=cfg.deposit_method)
        e_mesh = solve_e_mesh(n, grid, cfg.n0)
        if e_external is not None:
            e_mesh = e_mesh + e_external
        if e_external_fn is not None:
            e_mesh = e_mesh + e_external_fn(x)
        return -gather(e_mesh, x, grid, kind=cfg.interpol, method=cfg.deposit_method)

    return accel


@partial(jax.jit, static_argnames=("cfg",))
def step(
    state: PlasmaState,
    grid: Grid,
    cfg: SimConfig,
    e_external: Optional[jax.Array] = None,
) -> PlasmaState:
    """One symplectic time step + periodic wrap.

    Parity with ``PIC.update_state`` (`/root/reference/src/env/pic.py:131-146`)
    minus its redundant trailing density/field refresh — diagnostics are
    computed on demand by callers.
    """
    accel = make_accel_fn(grid, cfg, e_external=e_external)
    integ = INTEGRATORS[cfg.integrator]
    x, v = integ(state.x, state.v, accel, cfg.clamped_dt())
    return PlasmaState(x=jnp.mod(x, cfg.length), v=v)


@partial(jax.jit, static_argnames=("cfg",))
def diagnostics(state: PlasmaState, grid: Grid, cfg: SimConfig):
    """(n, e_mesh, PE, KE, H) computed once from the current state."""
    n = deposit(state.x, grid, n0=cfg.n0, kind=cfg.interpol, method=cfg.deposit_method)
    e_mesh = solve_e_mesh(n, grid, cfg.n0)
    pe = electric_energy(e_mesh, grid, cfg.n_particles)
    ke = kinetic_energy(state.v)
    return n, e_mesh, pe, ke, pe + ke


class PIC:
    """Stateful convenience wrapper mirroring the reference class API
    (`/root/reference/src/env/pic.py:11-223`): ``initialize``/``reinit``,
    ``update_state``, ``update_state_w_input_func``, ``get_state``,
    ``get_energy``, ``get_electric_energy``, ``simulate``.

    Internally everything runs through the pure functional core, so the same
    instance methods are jit-compiled and device-resident.
    """

    def __init__(self, cfg: SimConfig, key: Optional[jax.Array] = None, dtype=jnp.float32):
        self.cfg = cfg
        self.dtype = dtype
        # Grid leaves are host constants; pin them on device once so the
        # per-call jit argument transfer is free.
        self.grid = jax.device_put(make_grid(cfg.n_mesh, cfg.length, dtype=dtype))
        self.key = key if key is not None else jax.random.PRNGKey(cfg.seed)
        self.dist = make_distribution(cfg)
        self.initialize()

    # -- lifecycle ---------------------------------------------------------
    def initialize(self):
        self.key, sub = jax.random.split(self.key)
        self.state = init_state(self.cfg, sub, dtype=self.dtype)

    def reinit(self):
        """Full resample (parity with ``PIC.reinit``, `pic.py:84-91`)."""
        self.initialize()

    def update_params(self, **kwargs):
        """Update config fields and rebuild derived state (parity with
        ``PIC.update_params``, `pic.py:81-84`; config is immutable here so a
        new SimConfig is derived)."""
        import dataclasses as _dc

        valid = {k: v for k, v in kwargs.items() if v is not None and hasattr(self.cfg, k)}
        if not valid:
            return
        self.cfg = _dc.replace(self.cfg, **valid)
        self.grid = jax.device_put(make_grid(self.cfg.n_mesh, self.cfg.length, dtype=self.dtype))
        self.dist = make_distribution(self.cfg)
        self.initialize()

    # -- stepping ----------------------------------------------------------
    def update_state(self, e_external: Optional[jax.Array] = None):
        self.state = step(self.state, self.grid, self.cfg, e_external)

    def update_state_w_input_func(self, input_fn: Callable[[jax.Array], jax.Array]):
        """State-dependent external field evaluated inside the integrator
        (parity with `pic.py:148-163`)."""
        accel = make_accel_fn(self.grid, self.cfg, e_external_fn=input_fn)
        integ = INTEGRATORS[self.cfg.integrator]
        x, v = integ(self.state.x, self.state.v, accel, self.cfg.clamped_dt())
        self.state = PlasmaState(x=jnp.mod(x, self.cfg.length), v=v)

    # -- observers ---------------------------------------------------------
    @property
    def x(self):
        return self.state.x

    @property
    def v(self):
        return self.state.v

    def get_state(self) -> jax.Array:
        """Packed (2N,) snapshot column (parity with `pic.py:165-167`)."""
        return jnp.concatenate([self.state.x, self.state.v])

    def get_energy(self) -> jax.Array:
        return diagnostics(self.state, self.grid, self.cfg)[4]

    def get_electric_energy(self) -> jax.Array:
        return diagnostics(self.state, self.grid, self.cfg)[2]

    def get_density(self) -> jax.Array:
        return diagnostics(self.state, self.grid, self.cfg)[0]

    def get_e_mesh(self) -> jax.Array:
        return diagnostics(self.state, self.grid, self.cfg)[1]

    # -- open-loop rollout -------------------------------------------------
    def simulate(self, e_external_traj: Optional[jax.Array] = None):
        """Open-loop Nt-step rollout (parity with ``PIC.simulate``,
        `/root/reference/src/env/pic.py:175-223`): returns
        ``(snapshot (2N, Nt+1), H (Nt+1,), PE (Nt+1,))`` including the initial
        state, as one compiled ``lax.scan``."""
        from .rollout import rollout, snapshot_from_rollout  # avoid cycle

        out = rollout(
            self.state,
            self.grid,
            self.cfg,
            e_external_traj=e_external_traj,
            record_snapshots=True,
        )
        self.state = out.final_state
        return snapshot_from_rollout(out), out.hamiltonian, out.field_energy
