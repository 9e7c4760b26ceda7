"""ctypes binding to the native C++ reference-kernel library.

``native/pic_ref.cpp`` implements the reference's exact discrete semantics
(Thomas + Sherman-Morrison periodic Poisson solve, CIC, Yoshida-4) as -O3
C++. It serves as (a) an independent oracle for cross-validating the JAX
kernels and (b) the honest compiled CPU baseline in bench.py (the reference's
hot kernels are Numba/LLVM-compiled, so a C++ loop is the right single-core
apples-to-apples).

The library is built on demand with ``make -C native`` (g++); all entry
points degrade gracefully (return None) if no toolchain is available.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "libpic_ref.so"))
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _build() -> bool:
    try:
        subprocess.run(
            ["make", "-C", os.path.abspath(_NATIVE_DIR)],
            check=True,
            capture_output=True,
            timeout=120,
        )
        return True
    except Exception:
        return False


def load_library() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if not os.path.exists(_LIB_PATH) and not _build():
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None

    dp = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
    lib.pic_ref_step.restype = ctypes.c_double
    lib.pic_ref_step.argtypes = [
        dp, dp, ctypes.c_int64, ctypes.c_int, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_void_p,
    ]
    lib.pic_ref_rollout.restype = None
    lib.pic_ref_rollout.argtypes = [
        dp, dp, ctypes.c_int64, ctypes.c_int, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_int, dp,
    ]
    lib.pic_ref_solve_e.restype = None
    lib.pic_ref_solve_e.argtypes = [dp, ctypes.c_int, ctypes.c_double, ctypes.c_double, dp]
    _LIB = lib
    return _LIB


def native_step(x, v, n_mesh, length, dt, n0=1.0, gamma=5.0, e_external=None):
    """In-place Yoshida-4 step; returns (x, v, PE) or None if unavailable."""
    lib = load_library()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, dtype=np.float64)
    v = np.ascontiguousarray(v, dtype=np.float64)
    if e_external is not None:
        e_ext = np.ascontiguousarray(e_external, dtype=np.float64)
        ptr = e_ext.ctypes.data_as(ctypes.c_void_p)
    else:
        ptr = None
    pe = lib.pic_ref_step(x, v, x.shape[0], n_mesh, length, dt, n0, gamma, ptr)
    return x, v, pe


def native_rollout(x, v, n_mesh, length, dt, n_steps, n0=1.0, gamma=5.0):
    """Open-loop rollout; returns (x, v, pe_series) or None."""
    lib = load_library()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, dtype=np.float64)
    v = np.ascontiguousarray(v, dtype=np.float64)
    pe = np.zeros(n_steps, dtype=np.float64)
    lib.pic_ref_rollout(x, v, x.shape[0], n_mesh, length, dt, n0, gamma, n_steps, pe)
    return x, v, pe


def native_solve_e(rho, length, gamma=5.0):
    """E mesh from rho = n - n0 via the reference's elimination path, or None."""
    lib = load_library()
    if lib is None:
        return None
    rho = np.ascontiguousarray(rho, dtype=np.float64)
    out = np.zeros_like(rho)
    lib.pic_ref_solve_e(rho, rho.shape[0], length, gamma, out)
    return out
