"""Golden-trace tests: the compiled JAX closed loop vs an independent
float64 native-C++ implementation of the reference semantics.

This is the BASELINE.md acceptance-style check: the controlled field-energy
trajectory of our JAX path must track the reference implementation within
tight tolerance over the control horizon.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from plasma_control_tpu.config import ControlConfig, SimConfig
from plasma_control_tpu.control.actuator import make_actuator
from plasma_control_tpu.control.feedback import feedback_rollout
from plasma_control_tpu.models.pic import PlasmaState, init_state
from plasma_control_tpu.models.rollout import rollout
from plasma_control_tpu.ops.grid import make_grid
from plasma_control_tpu.utils.native import load_library, native_rollout, native_solve_e, native_step

import oracle

needs_native = pytest.mark.skipif(load_library() is None, reason="native library unavailable")

L, M, N, DT = 50.0, 64, 2000, 0.1
K = 3  # control modes


def _native_feedback_trace(x, v, t_steps):
    """Reference-semantics closed-loop feedback in float64 via the C++ lib."""
    xm = np.linspace(0.0, L, M)  # endpoint grid, actuator parity
    k = 2 * np.pi / L * np.arange(1, K + 1)
    basis_cos = np.cos(np.outer(xm, k))
    basis_sin = np.sin(np.outer(xm, k))

    pes = []
    for _ in range(t_steps):
        dens = oracle.deposit_cic(x, 1.0, L, M)
        e_mesh = native_solve_e(dens - 1.0, L)
        ek = np.fft.fft(e_mesh) / M * 2.0
        a = -np.real(ek[1 : K + 1])
        b = np.imag(ek[1 : K + 1])
        e_ext = basis_cos @ a + basis_sin @ b
        x, v, pe = native_step(x, v, M, L, DT, e_external=e_ext)
        pes.append(pe)
    return np.asarray(pes)


@needs_native
class TestGoldenTraces:
    def test_uncontrolled_pe_trace_matches(self):
        cfg = SimConfig(n_particles=N, n_mesh=M, dt=DT, t_max=8.0, length=L)
        grid = make_grid(M, L)
        st = init_state(cfg, jax.random.PRNGKey(42))
        out = rollout(st, grid, cfg)

        x = np.asarray(st.x, dtype=np.float64)
        v = np.asarray(st.v, dtype=np.float64)
        _, _, pe_ref = native_rollout(x, v, M, L, DT, cfg.n_steps)

        pe_jax = np.asarray(out.field_energy[1:])
        rel = np.abs(pe_jax - pe_ref) / np.abs(pe_ref)
        assert rel.max() < 0.01, f"max relative PE error {rel.max():.4f}"

    def test_feedback_pe_trace_matches(self):
        """Controlled trajectory: float32 JAX path vs float64 reference path
        must agree on the field-energy trace within 1% (BASELINE tolerance)."""
        cfg = SimConfig(n_particles=N, n_mesh=M, dt=DT, t_max=8.0, length=L)
        ctrl = ControlConfig(max_mode=K)
        grid = make_grid(M, L)
        act = make_actuator(L, M, K)
        st = init_state(cfg, jax.random.PRNGKey(42))

        fb = feedback_rollout(st, grid, cfg, ctrl, act)
        pe_jax = np.asarray(fb.field_energy)

        pe_ref = _native_feedback_trace(
            np.asarray(st.x, dtype=np.float64), np.asarray(st.v, dtype=np.float64), cfg.n_steps
        )
        rel = np.abs(pe_jax - pe_ref) / np.abs(pe_ref)
        assert rel.max() < 0.01, f"max relative PE error {rel.max():.4f}"


def _load_ddpg_golden(case: str):
    """Load the committed golden trace extracted from the reference's own
    torch DDPG evaluation run (`/root/reference/run_ddpg.py:249-313`, executed
    on CPU with 120 episodes; see experiments/make_ddpg_golden.py)."""
    path = os.path.join(os.path.dirname(__file__), "data", f"ddpg_golden_{case}.npz")
    if not os.path.exists(path):
        pytest.skip(f"golden npz missing: {path}")
    return np.load(path)


def _ddpg_replay_inputs(d):
    """Actuator mesh fields for replay steps 1..T-1.

    Alignment (`/root/reference/run_ddpg.py:276-313`): snapshot column t and
    PE[t] are recorded AFTER step t; coeff column t is the action applied
    DURING step t. So a replay starting from snapshot column 0 applies coeff
    columns 1..T-1 and compares against PE[1:]. The basis uses the
    reference's endpoint-inclusive actuator grid
    (`/root/reference/src/control/actuator.py:13`).
    """
    n_mesh, length = int(d["n_mesh"]), float(d["length"])
    cc, cs = d["coeff_cos"], d["coeff_sin"]
    k = 2.0 * np.pi / length * np.arange(1, cc.shape[0] + 1)
    xm = np.linspace(0.0, length, n_mesh)
    basis_cos, basis_sin = np.cos(np.outer(xm, k)), np.sin(np.outer(xm, k))
    return (basis_cos @ cc[:, 1:] + basis_sin @ cs[:, 1:]).T  # (T-1, M)


class TestReferenceDDPGGolden:
    """BASELINE.md acceptance metric: field-energy trajectory error vs the
    reference DDPG controller < 1%.

    The reference's own torch DDPG was trained+evaluated (CPU) to produce
    `dataset/<case>/ddpg-control/data.mat`; the compact golden npz holds its
    post-step-0 state, applied coefficient sequence, and recorded PE(t).
    Replaying the recorded actions through our dynamics and comparing PE
    isolates exactly the framework-fidelity part of the contract (the action
    sequence itself is the reference controller's, bit-for-bit).

    Measured margins (2026-08-20): float64 native replay ~1e-11 both cases;
    float32 JAX path 7.1e-4 (two-stream) / 2.4e-3 (bump-on-tail) over the
    full 499-step horizon — 4x inside the 1% tolerance at worst.
    """

    # two_stream / bump_on_tail are DDPG runs (499 replay steps, dt=0.1);
    # two_stream_ppo is the reference's PPO controller (999 steps at its
    # script's dt=0.05 default; its train() needs the np.float64 reward
    # coercion noted in PARITY.md to run at all — the eval trace replayed
    # here is its own code's output either way).
    #
    # Per-case float32 tolerance: over ~1000 steps of a saturated two-stream
    # the Lyapunov amplification of fp32 rounding dominates — measured
    # profile for the PPO trace: <0.01% through step 500, 0.41% at 750,
    # 3.1% max (at step 942, PE ~1446); the float64 oracle replay of the
    # same trace is exact to 8e-9, so the excursion is chaos, not model
    # error. The BASELINE <1% contract is the 499-step DDPG bump-on-tail
    # case, which passes at 0.24%.
    CASES = ["two_stream", "bump_on_tail", "two_stream_ppo"]
    F32_TOL = {"two_stream": 0.01, "bump_on_tail": 0.01, "two_stream_ppo": 0.05}
    F32_WINDOW_750_TOL = 0.01  # all cases: <1% through step 750 (or horizon)

    @needs_native
    @pytest.mark.parametrize("case", CASES)
    def test_native_float64_replay_is_exact(self, case):
        """The C++ oracle replay must match the reference's recorded PE to
        float64 roundoff — proof the two implementations are the same
        algorithm, not merely close."""
        d = _load_ddpg_golden(case)
        n_mesh, length, dt = int(d["n_mesh"]), float(d["length"]), float(d["dt"])
        e_traj = _ddpg_replay_inputs(d)
        x, v = d["x0"].copy(), d["v0"].copy()
        pes = np.empty(e_traj.shape[0])
        for t in range(e_traj.shape[0]):
            x, v, pes[t] = native_step(x, v, n_mesh, length, dt, e_external=e_traj[t])
        rel = np.abs(pes - d["pe"][1:]) / np.abs(d["pe"][1:])
        # ~1e-11 at 499 steps; 8e-9 at the PPO case's 999 steps (float64
        # roundoff accumulating through the same chaotic dynamics)
        assert rel.max() < 1e-7, f"max relative PE error {rel.max():.3e}"

    @pytest.mark.parametrize("case", CASES)
    def test_jax_float32_replay_within_baseline_tolerance(self, case):
        """The compiled float32 JAX path must track the reference DDPG
        trajectory within the BASELINE <1% tolerance over the full horizon."""
        d = _load_ddpg_golden(case)
        n_mesh, length, dt = int(d["n_mesh"]), float(d["length"]), float(d["dt"])
        t_steps = int(d["pe"].shape[0]) - 1
        cfg = SimConfig(
            simcase=str(d["simcase"]),
            n_particles=int(d["n_particles"]),
            n_mesh=n_mesh,
            dt=dt,
            t_max=dt * t_steps,
            length=length,
        )
        grid = make_grid(n_mesh, length)
        st = PlasmaState(
            x=jnp.asarray(d["x0"], jnp.float32), v=jnp.asarray(d["v0"], jnp.float32)
        )
        e_traj = jnp.asarray(_ddpg_replay_inputs(d), jnp.float32)
        out = rollout(st, grid, cfg, e_external_traj=e_traj, n_steps=t_steps)
        pe_jax = np.asarray(out.field_energy)
        ref = d["pe"]
        rel0 = abs(pe_jax[0] - ref[0]) / abs(ref[0])
        assert rel0 < 1e-5, f"initial-state PE mismatch {rel0:.3e}"
        rel = np.abs(pe_jax[1:] - ref[1:]) / np.abs(ref[1:])
        assert rel[:750].max() < self.F32_WINDOW_750_TOL, (
            f"max relative PE error {rel[:750].max():.4f} through step 750"
        )
        assert rel.max() < self.F32_TOL[case], (
            f"max relative PE error {rel.max():.4f}"
        )


@needs_native
class TestGoldenBumpOnTail:
    def test_bump_on_tail_feedback_trace(self):
        """Same golden check on the bump-on-tail case."""
        cfg = SimConfig(
            simcase="bump-on-tail", n_particles=N, n_mesh=M, dt=DT, t_max=8.0, length=L
        )
        ctrl = ControlConfig(max_mode=K)
        grid = make_grid(M, L)
        act = make_actuator(L, M, K)
        st = init_state(cfg, jax.random.PRNGKey(7))

        fb = feedback_rollout(st, grid, cfg, ctrl, act)
        pe_ref = _native_feedback_trace(
            np.asarray(st.x, dtype=np.float64), np.asarray(st.v, dtype=np.float64), cfg.n_steps
        )
        rel = np.abs(np.asarray(fb.field_energy) - pe_ref) / np.abs(pe_ref)
        assert rel.max() < 0.01, f"max relative PE error {rel.max():.4f}"
