"""ctypes loader for the native wide cluster-tree builder.

Counterpart of ``lens_flare_tpu/accel/native/__init__.py`` (its wide-tree
half).  ``builder.cpp`` is compiled with g++ at first use into
``lens_flare_tpu_torch/_build/``, under a name that carries a hash of the
source and flags, so an edited source is never served from a stale build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "builder.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "_build"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
_LOCK = threading.Lock()
_LIB = None
_TRIED = False


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / f"libwide_builder_{h.hexdigest()[:16]}.so"


def _compile(so: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(
            ["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp)],
            check=True, capture_output=True, timeout=120,
        )
    except (OSError, subprocess.SubprocessError):
        return False
    os.replace(tmp, so)
    return True


def get_lib():
    """Load (building if needed) the native library; None if unavailable."""
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        so = _library_path()
        if not so.exists() and not _compile(so):
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            return None
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        lib.lf_build_wide.restype = ctypes.c_int
        lib.lf_build_wide.argtypes = [
            f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            f32p, f32p, f32p, i32p,
        ]
        _LIB = lib
        return _LIB


def build_wide_native(tri_p: np.ndarray, b1: int, b2: int, k: int):
    """Wide cluster tree via the C++ builder; returns a WideBVH or None."""
    lib = get_lib()
    if lib is None:
        return None
    from ..wide import WideBVH

    n = len(tri_p)
    top = np.zeros((b1, 8), np.float32)
    child = np.zeros((b1 * b2, 8), np.float32)
    soa = np.zeros((b1 * b2 * k, 12), np.float32)
    tid = np.zeros(b1 * b2 * k, np.int32)
    rc = lib.lf_build_wide(
        np.ascontiguousarray(tri_p.reshape(n, 9), np.float32), n, b1, b2, k,
        top, child, soa, tid,
    )
    if rc != 0:
        return None
    return WideBVH(top_boxes=top, child_boxes=child, tri_soa=soa, tri_id=tid, b1=b1, b2=b2, k=k)
