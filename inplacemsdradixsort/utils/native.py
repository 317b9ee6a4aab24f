"""ctypes bindings to the native host runtime (csrc/native.cpp).

Runs ``make -C csrc`` on first use, which rebuilds the shared library by
timestamp, so the library in use is always built from the committed
``native.cpp``; callers fall back to the pure-numpy implementations when
no compiler is present.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
_LIB_PATH = os.path.join(_CSRC, "libinpmsdradix_native.so")
_lib = None
_tried = False


def _build() -> bool:
    try:
        subprocess.run(
            ["make", "-C", _CSRC], check=True,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        )
        return os.path.exists(_LIB_PATH)
    except Exception:
        return False


def load() -> Optional[ctypes.CDLL]:
    """The native library, building it if needed; None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not _build():
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.mt64_fill.argtypes = [ctypes.c_uint64, u64p, ctypes.c_size_t]
    lib.mt64_fill_u32.argtypes = [ctypes.c_uint64, u32p, ctypes.c_size_t]
    lib.uniform_fill_u32_par.argtypes = [
        ctypes.c_uint64, u32p, ctypes.c_size_t, ctypes.c_int
    ]
    lib.zipf_fill_u32.argtypes = [
        ctypes.c_uint64, ctypes.c_double, ctypes.c_uint32, ctypes.c_int,
        u32p, ctypes.c_size_t, ctypes.c_int,
    ]
    lib.check_sorted_u32.argtypes = [u32p, ctypes.c_size_t, u64p,
                                     ctypes.c_int]
    lib.check_sorted_u32.restype = ctypes.c_int
    lib.check_sorted_u64.argtypes = [u64p, ctypes.c_size_t, u64p,
                                     ctypes.c_int]
    lib.check_sorted_u64.restype = ctypes.c_int
    lib.check_same_u32.argtypes = [u32p, u32p, ctypes.c_size_t,
                                   ctypes.c_int]
    lib.check_same_u32.restype = ctypes.c_int
    _lib = lib
    return _lib


def available() -> bool:
    return load() is not None


def _ptr(a: np.ndarray, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def mt64_stream(seed: int, n: int) -> np.ndarray:
    """Reference-compatible MT19937-64 stream (rand.c:47-86), native."""
    lib = load()
    out = np.empty(n, np.uint64)
    lib.mt64_fill(seed, _ptr(out, ctypes.c_uint64), n)
    return out


def uniform_u32(seed: int, n: int, parallel: bool = True) -> np.ndarray:
    lib = load()
    out = np.empty(n, np.uint32)
    if parallel:
        lib.uniform_fill_u32_par(seed, _ptr(out, ctypes.c_uint32), n, 0)
    else:
        lib.mt64_fill_u32(seed, _ptr(out, ctypes.c_uint32), n)
    return out


def zipf_u32(seed: int, n: int, theta: float = 0.75,
             num_items: int = 1 << 20, shuffle: bool = True) -> np.ndarray:
    lib = load()
    out = np.empty(n, np.uint32)
    lib.zipf_fill_u32(seed, theta, num_items, int(shuffle),
                      _ptr(out, ctypes.c_uint32), n, 0)
    return out


def check_sorted(keys: np.ndarray, threads: int = 0) -> Tuple[bool, int]:
    """(is_ascending, checksum) — the native check() analog."""
    lib = load()
    keys = np.ascontiguousarray(keys)
    cs = ctypes.c_uint64(0)
    if keys.dtype == np.uint32:
        ok = lib.check_sorted_u32(
            _ptr(keys, ctypes.c_uint32), keys.size, ctypes.byref(cs),
            threads,
        )
    elif keys.dtype == np.uint64:
        ok = lib.check_sorted_u64(
            _ptr(keys, ctypes.c_uint64), keys.size, ctypes.byref(cs),
            threads,
        )
    else:
        raise TypeError(keys.dtype)
    return bool(ok), int(cs.value)


def check_same(keys: np.ndarray, rids: np.ndarray) -> bool:
    lib = load()
    return bool(lib.check_same_u32(
        _ptr(np.ascontiguousarray(keys), ctypes.c_uint32),
        _ptr(np.ascontiguousarray(rids), ctypes.c_uint32),
        keys.size, 0,
    ))
