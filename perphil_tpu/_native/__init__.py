"""Native (C++) runtime components, loaded via ctypes.

The compute path of perphil-tpu is pure JAX/XLA; the native layer
covers host-side runtime work that is inherently sequential — currently the
ILU(0) factorization (``csrc/structured_ilu.cpp``), the analogue of PETSc's
C factorization kernels. Everything degrades gracefully to numpy when no
compiler is available.
"""

from __future__ import annotations

import ctypes
import subprocess
import sysconfig
from pathlib import Path
from typing import Optional

_NATIVE_DIR = Path(__file__).parent
_CSRC = _NATIVE_DIR.parent.parent / "csrc"
_LIB_PATH = _NATIVE_DIR / "libperphil_native.so"

_lib: Optional[ctypes.CDLL] = None
_tried = False


_SOURCES = ("structured_ilu.cpp", "csr_solver.cpp")


def _build() -> bool:
    srcs = [_CSRC / s for s in _SOURCES if (_CSRC / s).exists()]
    if not srcs:
        return False
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
             *[str(s) for s in srcs], "-o", str(_LIB_PATH)],
            check=True, capture_output=True, timeout=120,
        )
        return True
    except Exception:
        return False


def _stale() -> bool:
    if not _LIB_PATH.exists():
        return True
    so_mtime = _LIB_PATH.stat().st_mtime
    return any(
        (_CSRC / s).exists() and (_CSRC / s).stat().st_mtime > so_mtime
        for s in _SOURCES
    )


def load() -> Optional[ctypes.CDLL]:
    """Load (building on first use or stale .so) the native library, or None."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if _stale() and not _build():
        return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.ilu0_factorize.argtypes = [
            ctypes.POINTER(ctypes.c_double),  # vals
            i64p,                              # deltas
            ctypes.POINTER(ctypes.c_uint8),    # valid
            ctypes.c_int64,                    # nrows
            ctypes.c_int64,                    # noffs
            i64p,                              # lower_order
            ctypes.c_int64,                    # nlower
            i64p,                              # mmap
            i64p,                              # uppers
            i64p,                              # uppers_ptr
            ctypes.c_int64,                    # center
        ]
        lib.ilu0_factorize.restype = None
        dp = ctypes.POINTER(ctypes.c_double)
        lib.csr_ilu0_factorize.argtypes = [
            ctypes.c_int64, i64p, i64p, dp, i64p,
        ]
        lib.csr_ilu0_factorize.restype = ctypes.c_int64
        lib.csr_gmres_ilu.argtypes = [
            ctypes.c_int64,               # n
            i64p, i64p, dp,               # A csr
            i64p, i64p, dp, i64p,         # F csr + diag (may be null)
            dp,                           # b
            ctypes.c_double,              # rtol
            ctypes.c_double,              # atol
            ctypes.c_int64,               # restart
            ctypes.c_int64,               # max_it
            dp,                           # x out
            dp,                           # rnorm out
            dp,                           # rnorm history (may be null)
        ]
        lib.csr_gmres_ilu.restype = ctypes.c_int64
        lib.csr_gs_sweeps.argtypes = [
            ctypes.c_int64,               # n
            i64p, i64p, dp,               # A csr
            dp,                           # b
            dp,                           # x (in/out)
            ctypes.c_double,              # rtol
            ctypes.c_double,              # atol
            ctypes.c_double,              # stol
            ctypes.c_int64,               # max_it
        ]
        lib.csr_gs_sweeps.restype = ctypes.c_int64
        # int32-index variants (PETSc's default PetscInt): 33% less index
        # traffic in the memory-bound SpMV/trisolve kernels
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.csr_ilu0_factorize_i32.argtypes = [
            ctypes.c_int64, i32p, i32p, dp, i32p,
        ]
        lib.csr_ilu0_factorize_i32.restype = ctypes.c_int64
        lib.csr_gmres_ilu_i32.argtypes = [
            ctypes.c_int64,
            i32p, i32p, dp,
            i32p, i32p, dp, i32p,
            dp,
            ctypes.c_double,
            ctypes.c_double,
            ctypes.c_int64,
            ctypes.c_int64,
            dp,
            dp,
            dp,
        ]
        lib.csr_gmres_ilu_i32.restype = ctypes.c_int64
        lib.csr_gs_sweeps_i32.argtypes = [
            ctypes.c_int64, i32p, i32p, dp, dp, dp,
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_int64,
        ]
        lib.csr_gs_sweeps_i32.restype = ctypes.c_int64
        _lib = lib
    except (OSError, AttributeError):
        # AttributeError: an ABI-stale .so (mtime newer than sources but
        # missing newer symbols) must degrade to the numpy paths, not crash
        _lib = None
    return _lib
