"""Whole-horizon spectral planner kernel for NVIDIA GPUs (Pallas, Triton route).

The default MPC planner (`MPCConfig.plan_model="spectral"`) rolls K candidate
control sequences through the gridless low-mode dynamics
(`plasma_control_tpu/control/mpc.py::_horizon_cost_spectral`): per step, a
staggered-KDK drift, the Km mode sums of the particle phasors (deposit), the
mode-space Poisson solve (a per-mode scale) and the field evaluation back at
the particles (gather) — O(N*Km) multiply-adds per candidate-step.

On the XLA path each of the H steps must finish its Km reductions over all N
particles before the kick can run, so every step is several kernels and the
(K, N) carry goes through device memory between them. Here ONE launch runs
the whole horizon: one program per candidate, looping over power-of-two
particle chunks (masked tail). The kick of step t needs only the mode sums of
step t (known when the step starts) and the particle's own phasor, so the
kick, the next drift and the next step's mode-sum accumulation share ONE
pass over the particles: H passes per candidate, each reading and writing the
candidate's carried state once. That state lives in a scratch output of
K x 3 x N floats (K x 2 x N for the trig drift), ~23 MB at K=384, N=5000 —
inside the card's L2.

Semantics match ``_horizon_cost_spectral`` (same merged-half-kick staggered
KDK, same initial un-merged half kick, same post-drift PE): the returned
(K, H) PE block feeds the identical cost assembly in ``candidate_costs``.

Drift variants (``rot``): "trig" carries x, wraps it and recomputes cos/sin
per step, exactly as the XLA path does; "rot" carries the base-harmonic
phasor (cos k1 x, sin k1 x) and advances it by a small-angle polynomial
rotation — no transcendentals per step, agreeing with trig to fp32 round-off
per solve (tests/test_pallas.py::TestSpectralDrift). :func:`_use_rot`
resolves ``MPCConfig.spectral_drift="auto"``.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

__all__ = ["fused_spectral_horizon", "spectral_horizon_supported"]

# |delta| = (2*pi/L)*dt*|v| per step. With |v| <= _V_SAFE (25 thermal widths
# at the reference's vth=1 — far beyond any populated tail) the 4/5th-order
# cos/sin polynomials have truncation error ~ delta^6/720: < 2.2e-5 at the
# |delta| <= 0.5 gate bound. The gate is static (dt, L are trace-time
# constants), so the choice never recompiles per call.
_V_SAFE = 25.0
# The carried state that "auto" keeps for the rot drift: below the card's
# 50 MB L2 with room for the rest of the solve. On an H100 (K=384, H=6,
# Km=8) rot solved faster up to a 35 MB carry and trig at 46 and 69 MB; at
# 92 MB rot led again by ~5%, at 460 MB (N=100k) trig by ~45%.
_L2_CARRY_BYTES = 40 * 2**20
# Particle chunk per loop iteration and warps per program. A chunk of 256
# over 4 warps keeps each of the ~10 live chunk planes plus the 2*Km mode
# accumulators at two registers per thread.
_BLOCK = 256
_NUM_WARPS = 4


def _use_rot(dt: float, length: float, n_carry: int, mode: str = "auto") -> bool:
    """Resolve the drift choice: "rot", "trig", or "auto". ``n_carry`` is
    K * N, the candidate-particle count of one launch.

    "auto" takes rot where the static angle bound holds (an accuracy gate on
    the rotation polynomials) and rot's three carried planes fit the L2
    cache; trig carries two planes, so where the carry spills to device
    memory trig moves a third fewer bytes and is the faster drift."""
    if mode == "rot":
        return True
    if mode == "trig":
        return False
    return ((2.0 * np.pi / length) * dt * _V_SAFE <= 0.5
            and 3 * 4 * n_carry <= _L2_CARRY_BYTES)


def spectral_horizon_supported(n_particles: int, n_candidates: int) -> bool:
    """True if the flat index k * N + i of the (K * N,) state planes fits
    the kernel's int32 pointer arithmetic."""
    return n_candidates * n_particles < 2**31


def _kernel(
    x0_ref, c10_ref, s10_ref, v0_ref, coef_ref, *rest,
    n: int, km: int, horizon: int, dt: float, length: float, g: tuple,
    inv_k2: tuple, pe_scale: float, width: int, h_pad: int, block: int,
    rot: bool, corrected: bool,
):
    tw_ref, rest = (rest[0], rest[1:]) if corrected else (None, rest)
    # carried state: (cos k1 x, sin k1 x, vh) for rot, (x, vh) for trig
    if rot:
        pe_ref, st0_ref, st1_ref, st2_ref = rest
    else:
        pe_ref, st0_ref, st2_ref = rest
    k = pl.program_id(0)
    base = k * n
    c_ang = 2.0 * np.pi / length
    inv_l = 1.0 / length
    row = k * width
    n_chunks = -(-n // block)

    def coef(j):  # scalar j of this candidate's coefficient row
        return coef_ref[row + j]

    def harmonics(c1, s1, mf):
        """Chebyshev recurrence f((h+1)t) = 2cos(t) f(ht) - f((h-1)t):
        yields (cos k_m x, sin k_m x) for m = 1..km. Harmonic 0 is seeded
        with the lane mask, so masked lanes stay identically zero."""
        twoc = c1 + c1
        c_pp, s_pp = mf, jnp.zeros_like(mf)
        c_p, s_p = c1, s1
        out = [(c_p, s_p)]
        for _ in range(km - 1):
            c_n = twoc * c_p - c_pp
            s_n = twoc * s_p - s_pp
            c_pp, c_p, s_pp, s_p = c_p, c_n, s_p, s_n
            out.append((c_p, s_p))
        return out

    # mode sums at the current positions: step 0 kicks with the shared x0
    # sums (folded into the coefficient row by the wrapper), so its field
    # coefficients are just the row's first 2*km entries
    pc = [coef(m) for m in range(km)]
    ps = [coef(km + m) for m in range(km)]
    pe_row = jnp.zeros((h_pad,), jnp.float32)
    for t in range(horizon):
        first = t == 0

        def body(i, accs, pc=pc, ps=ps, first=first):
            idx = i * block + jnp.arange(block)
            live = idx < n
            mf = live.astype(jnp.float32)
            gidx = base + idx
            if first:
                vh = pltriton.load(v0_ref.at[idx], mask=live, other=0.0)
                c1 = pltriton.load(c10_ref.at[idx], mask=live, other=0.0)
                s1 = pltriton.load(s10_ref.at[idx], mask=live, other=0.0)
                if not rot:
                    x = pltriton.load(x0_ref.at[idx], mask=live, other=0.0)
            else:
                vh = pltriton.load(st2_ref.at[gidx], mask=live, other=0.0)
                if rot:
                    c1 = pltriton.load(st0_ref.at[gidx], mask=live, other=0.0)
                    s1 = pltriton.load(st1_ref.at[gidx], mask=live, other=0.0)
                else:
                    x = pltriton.load(st0_ref.at[gidx], mask=live, other=0.0)
                    ang = c_ang * x
                    c1 = jnp.cos(ang) * mf
                    s1 = jnp.sin(ang) * mf
            # kick at the current positions (the un-merged half kick at t=0,
            # else the merged kick of the previous step boundary)
            acc = jnp.zeros_like(vh)
            for m, (cm, sm) in enumerate(harmonics(c1, s1, mf)):
                acc = acc + pc[m] * cm + ps[m] * sm
            vh = vh - (0.5 * dt) * acc
            # drift
            if rot:
                d = (c_ang * dt) * vh
                d2 = d * d
                cd = 1.0 + d2 * (-0.5 + d2 * (1.0 / 24.0))
                sd = d * (1.0 + d2 * (-1.0 / 6.0 + d2 * (1.0 / 120.0)))
                c1, s1 = c1 * cd - s1 * sd, s1 * cd + c1 * sd
                pltriton.store(st0_ref.at[gidx], c1, mask=live)
                pltriton.store(st1_ref.at[gidx], s1, mask=live)
            else:
                x = x + dt * vh
                x = x - length * jnp.floor(x * inv_l)
                ang = c_ang * x
                c1 = jnp.cos(ang) * mf
                s1 = jnp.sin(ang) * mf
                pltriton.store(st0_ref.at[gidx], x, mask=live)
            pltriton.store(st2_ref.at[gidx], vh, mask=live)
            # this step's mode sums at the new positions
            new = []
            for m, (cm, sm) in enumerate(harmonics(c1, s1, mf)):
                new.append(accs[2 * m] + cm)
                new.append(accs[2 * m + 1] + sm)
            return tuple(new)

        zero = jnp.zeros((block,), jnp.float32)
        accs = lax.fori_loop(0, n_chunks, body, (zero,) * (2 * km))
        sums = [jnp.sum(a) for a in accs]
        pe = jnp.float32(0.0)
        pc, ps = [], []
        for m in range(km):
            cm, sm = sums[2 * m], sums[2 * m + 1]
            if corrected:
                dcm = cm - tw_ref[t * km + m]
                dsm = sm - tw_ref[(horizon + t) * km + m]
                pe = pe + (dcm * dcm + dsm * dsm) * inv_k2[m]
            else:
                pe = pe + (cm * cm + sm * sm) * inv_k2[m]
            # merged-kick field coefficients of this step boundary:
            # 2*E_self + u_t + u_{t+1}
            col = 2 * km + t * km + m
            pc.append(2.0 * (g[m] * sm) + coef(col))
            ps.append(2.0 * (-(g[m] * cm)) + coef(horizon * km + col))
        pe_row = jnp.where(jnp.arange(h_pad) == t, pe_scale * pe, pe_row)
    pe_ref[pl.ds(k * h_pad, h_pad)] = pe_row


@functools.partial(
    jax.jit,
    static_argnames=("length", "dt", "n0", "n_particles", "interpret", "rot"),
)
def fused_spectral_horizon(
    x0: jax.Array,  # (N,)
    v0: jax.Array,  # (N,)
    u_c: jax.Array,  # (K, H, Km) padded external cosine coefficients
    u_s: jax.Array,  # (K, H, Km)
    *,
    length: float,
    dt: float,
    n0: float,
    n_particles: int,
    rot: bool,
    interpret: bool = False,
    twin_c: jax.Array | None = None,  # (H, Km) noise-correction target, or None
    twin_s: jax.Array | None = None,
) -> jax.Array:
    """(K, H) exact post-drift spectral-model field energies per candidate.

    With ``twin_c``/``twin_s`` set (``MPCConfig.plan_correction="twin"``),
    the returned energies are the CORRECTED |phasor - target|^2 form — see
    :func:`plasma_control_tpu.control.mpc.twin_targets`."""
    k_cand, horizon, km = u_c.shape
    n = n_particles
    f32 = jnp.float32
    x0 = x0.astype(f32)
    v0 = v0.astype(f32)
    kv = 2.0 * np.pi / length * np.arange(1, km + 1)
    g = 2.0 * n0 / (n * kv)

    # shared across candidates: the x0 phasor and its mode sums
    t0 = (2.0 * np.pi / length) * x0
    c10, s10 = jnp.cos(t0), jnp.sin(t0)
    twoc = c10 + c10
    c_pp, s_pp, c_p, s_p = jnp.ones_like(c10), jnp.zeros_like(s10), c10, s10
    c0, s0 = [jnp.sum(c_p)], [jnp.sum(s_p)]
    for _ in range(km - 1):
        c_pp, c_p = c_p, twoc * c_p - c_pp
        s_pp, s_p = s_p, twoc * s_p - s_pp
        c0.append(jnp.sum(c_p))
        s0.append(jnp.sum(s_p))
    c0, s0 = jnp.stack(c0), jnp.stack(s0)

    # per-candidate coefficient row: step-0 field coefficients, then the
    # boundary pairs u_t + u_{t+1} (last: u_{H-1} + u_{H-1}) for cos and sin
    pc0 = g * s0 + u_c[:, 0, :]
    ps0 = -(g * c0) + u_s[:, 0, :]
    pair_c = jnp.concatenate([u_c[:, 1:], u_c[:, -1:]], axis=1) + u_c
    pair_s = jnp.concatenate([u_s[:, 1:], u_s[:, -1:]], axis=1) + u_s
    coef = jnp.concatenate(
        [pc0, ps0, pair_c.reshape(k_cand, -1), pair_s.reshape(k_cand, -1)], axis=1
    ).astype(f32)
    width = coef.shape[1]
    h_pad = pl.next_power_of_2(horizon)

    corrected = twin_c is not None
    operands = [x0, c10, s10, v0, coef.reshape(-1)]
    if corrected:
        operands.append(jnp.concatenate(
            [twin_c.reshape(-1), twin_s.reshape(-1)]).astype(f32))
    kernel = functools.partial(
        _kernel,
        n=n,
        km=km,
        horizon=horizon,
        dt=dt,
        length=length,
        g=tuple(float(v) for v in g),
        inv_k2=tuple(float(v) for v in 1.0 / (kv * kv)),
        pe_scale=n0**2 / n,
        width=width,
        h_pad=h_pad,
        block=_BLOCK,
        rot=rot,
        corrected=corrected,
    )
    state = jax.ShapeDtypeStruct((k_cand * n,), f32)
    pe, *_ = pl.pallas_call(
        kernel,
        grid=(k_cand,),
        out_shape=(jax.ShapeDtypeStruct((k_cand * h_pad,), f32),)
        + (state,) * (3 if rot else 2),
        compiler_params=pltriton.CompilerParams(num_warps=_NUM_WARPS, num_stages=1),
        backend="triton",
        interpret=interpret,
        name="spectral_horizon",
    )(*operands)
    return pe.reshape(k_cand, h_pad)[:, :horizon]
