"""ctypes loader for the native builders (binary SAH BVH and wide cluster tree).

Counterpart of ``lens_flare_tpu/accel/native/__init__.py``.  ``builder.cpp``
is compiled with g++ at first use into
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
        lib.lf_build_bvh.restype = ctypes.c_int
        lib.lf_build_bvh.argtypes = [
            f32p, f32p, ctypes.c_int, ctypes.c_int,
            f32p, f32p, i32p, i32p, i32p, i32p, i32p, i32p,
        ]
        lib.lf_build_wide.restype = ctypes.c_int
        lib.lf_build_wide.argtypes = [
            f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            f32p, f32p, f32p, i32p,
        ]
        _LIB = lib
        return _LIB


def build_bvh_native(box_min: np.ndarray, box_max: np.ndarray, max_leaf: int = 4):
    """Binary SAH BVH via the C++ builder; returns a FlatBVH, or None without a build or primitives."""
    lib = get_lib()
    n = len(box_min)
    if lib is None or n == 0:
        return None
    from ..bvh import FlatBVH

    cap = max(2 * n, 1)
    node_min = np.zeros((cap, 3), np.float32)
    node_max = np.zeros((cap, 3), np.float32)
    node_left = np.zeros(cap, np.int32)
    node_right = np.zeros(cap, np.int32)
    node_start = np.zeros(cap, np.int32)
    node_count = np.zeros(cap, np.int32)
    prim_order = np.zeros(n, np.int32)
    depth = np.zeros(1, np.int32)
    m = lib.lf_build_bvh(
        np.ascontiguousarray(box_min, np.float32), np.ascontiguousarray(box_max, np.float32),
        n, max_leaf, node_min, node_max, node_left, node_right, node_start, node_count,
        prim_order, depth,
    )
    return FlatBVH(
        node_min=node_min[:m].copy(),
        node_max=node_max[:m].copy(),
        node_left=node_left[:m].copy(),
        node_right=node_right[:m].copy(),
        node_start=node_start[:m].copy(),
        node_count=node_count[:m].copy(),
        prim_order=prim_order,
        max_depth=int(depth[0]),
    )


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
