"""Build and load the CUDA kernels of ``ops/csrc`` (nvcc -> .so -> ctypes).

The library is compiled at first use from the sources in the package, for
``sm_90a`` (Hopper), into ``lens_flare_tpu_torch/_build/``.  Its file name
carries a hash of the sources and flags, so an edited source is never
served from a stale build.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("intersect.cu",)
# --fmad=false: products and sums round exactly as the plain PyTorch
# versions' separate ops do, so kernel and plain version agree bit for bit
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# argtypes of the C functions in csrc/intersect.cu
SIGNATURES = {
    "lf_tree_closest": [_P] * 8 + [_I] * 6 + [_P] * 5,
    "lf_tree_any_hit": [_P] * 8 + [_I] * 5 + [_P] * 5,
    "lf_tree_closest_shade": [_P] * 9 + [_I] * 5 + [_P] * 6,
    "lf_brute": [_P] * 6 + [_I] * 5 + [_P] * 5,
    "lf_tree_closest_mxu": [_P] * 9 + [_I] * 5 + [_P] * 5,
    "lf_tree_group": [_P] * 9 + [_I] * 9 + [_P] * 6,
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_log = ""  # nvcc's output (-Xptxas -v: registers and spills per kernel)
build_seconds = 0.0


def find_nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _library_path(csrc_dir: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((csrc_dir / name).read_bytes())
    return BUILD_DIR / f"liblf_kernels_{h.hexdigest()[:16]}.so"


def build(csrc_dir: Path = CSRC_DIR) -> Path:
    """Compile the kernels if no build of the sources in ``csrc_dir`` exists.

    ``csrc_dir`` other than the package's own serves A/B runs against
    another version of the sources (``lens_flare_tpu_torch.ab_walk``).
    """
    global build_log, build_seconds
    csrc_dir = Path(csrc_dir)
    so = _library_path(csrc_dir)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *(str(csrc_dir / s) for s in SOURCES)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    build_log = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{build_log}")
    os.replace(tmp, so)
    return so


def open_library(path: Path) -> ctypes.CDLL:
    """A built kernel library with the argtypes of every function set."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def load_library() -> ctypes.CDLL:
    """The kernel library the wrappers launch, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = open_library(build())
        return _lib
