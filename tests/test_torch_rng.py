"""The port's threefry RNG against jax.random, bit for bit.

Tolerance: none.  Every word and every float must be identical, because
the integrator parity tests rely on both packages drawing the same tape.

On the CPU the port draws with its plain int64 code, compared with
jax.random below; it never loads the kernel library.  Kernel H
(``ops/csrc/rng.cu``) is held to that plain code bit for bit, as uint32
words and float32 bits, on every shape the cells draw: on the card
(``-m gpu``), and on the CPU through the same source built by g++ behind a
shim header (its launches become loops over blocks and threads), which
runs the wrappers' stride and broadcast handling of ``_rng`` unchanged.
"""

import contextlib
import re
import shutil
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

try:
    import jax

    from lens_flare_tpu.integrator.path import RenderSettings, tape_size
except ImportError:  # the card's machine has no JAX: only the gpu cases run there
    jax = None

from lens_flare_tpu_torch import _rng
from lens_flare_tpu_torch.ops import _build
from lens_flare_tpu_torch.ops import intersect_cuda as ic

SEEDS = [0, 1, 7, 12345, 2**31 - 1]


def _np(x):
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in(seed):
    key = jax.random.PRNGKey(seed)
    kt = _rng.prng_key(seed)
    assert (_np(key) == kt.numpy()).all()
    rng = np.random.default_rng(seed)
    for data in rng.integers(0, 2**32, 8, dtype=np.uint64):
        want = _np(jax.random.fold_in(key, np.uint32(data)))
        assert (want == _rng.fold_in(kt, int(data)).numpy()).all()


@pytest.mark.parametrize("depth", [1, 2, 3, 4])
def test_uniform_tape_matches_jax(depth):
    """The per-lane tape of radiance_sample, keyed as render_wavefront keys it."""
    settings = RenderSettings(max_ray_depth=depth, total_light_samples=2)
    u = tape_size(settings)
    key = jax.random.PRNGKey(depth)
    pix = np.arange(0, 4096, 37, dtype=np.uint32)
    jk = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(key, pix)
    jk = jax.vmap(jax.random.fold_in, in_axes=(0, None))(jk, np.uint32(3))
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (u,)))(jk))

    tk = _rng.fold_in(_rng.prng_key(depth).expand(len(pix), 2), torch.as_tensor(pix.astype(np.int64)))
    tk = _rng.fold_in(tk, 3)
    got = _rng.uniform(tk, (u,)).numpy()
    assert got.dtype == np.float32
    assert (got.view(np.uint32) == want.view(np.uint32)).all()


def test_split_and_uniform_of_split_keys():
    """irradiance_falloff's draw: uniform(split(key, 16)[j], (2,))."""
    key = jax.random.PRNGKey(5)
    keys = jax.random.split(key, 16)
    kt = _rng.split(_rng.prng_key(5), 16)
    assert (_np(keys) == kt.numpy()).all()
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (2,)))(keys))
    assert (want.view(np.uint32) == _rng.uniform(kt, (2,)).numpy().view(np.uint32)).all()


def test_random_keys():
    """Arbitrary (k0, k1) words, not only PRNGKey outputs."""
    rng = np.random.default_rng(11)
    raw = rng.integers(0, 2**32, (32, 2), dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (9,)))(raw))
    got = _rng.uniform(torch.as_tensor(raw.astype(np.int64)), (9,)).numpy()
    assert (want.view(np.uint32) == got.view(np.uint32)).all()
    want_f = _np(jax.vmap(jax.random.fold_in, in_axes=(0, None))(raw, np.uint32(4000000000)))
    assert (want_f == _rng.fold_in(torch.as_tensor(raw.astype(np.int64)), 4000000000).numpy()).all()


# ---------------------------------------------------------------------------
# the CPU never takes the kernel
# ---------------------------------------------------------------------------


def _refuse(*args, **kw):
    raise AssertionError("a CPU tensor loaded the kernel library")


@pytest.mark.parametrize("seed", [3, 2**32 - 1])
def test_cpu_tensors_never_load_the_library(seed, monkeypatch):
    monkeypatch.setattr(_build, "load_library", _refuse)
    monkeypatch.setattr(_build, "build", _refuse)
    monkeypatch.setattr(_build, "open_library", _refuse)
    ic.reset_launch_counts()
    key = jax.random.PRNGKey(seed)
    kt = _rng.prng_key(seed)
    pix = np.arange(0, 5000, 71, dtype=np.uint32)
    jk = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(key, pix)
    tk = _rng.fold_in(kt.expand(len(pix), 2), torch.as_tensor(pix.astype(np.int64)))
    assert (_np(jk) == tk.numpy()).all()
    jk = jax.vmap(jax.random.fold_in, in_axes=(0, None))(jk, np.uint32(seed))
    tk = _rng.fold_in(tk, torch.tensor(seed & _rng.MASK32))  # a 0-d index, as a captured sample takes it
    assert (_np(jk) == tk.numpy()).all()
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (40,)))(jk))
    assert (want.view(np.uint32) == _rng.uniform(tk, (40,)).numpy().view(np.uint32)).all()
    want = np.asarray(jax.vmap(lambda k: jax.random.bits(k, (5,)))(jk)).astype(np.int64)
    assert (want == _rng.random_bits(tk, (5,)).numpy()).all()
    assert (_np(jax.random.split(key, 16)) == _rng.split(kt, 16).numpy()).all()
    assert ic.KERNELS["H"].launches == 0


def test_kernel_h_is_declared_where_it_is_built():
    """KERNELS' entry names a symbol that the build declares and ``csrc/rng.cu`` defines."""
    h = ic.KERNELS["H"]
    assert h.symbol == "lf_threefry" and h.name == "threefry"
    assert h.symbol in _build.SIGNATURES and "rng.cu" in _build.SOURCES
    src = Path(_build.PACKAGE_DIR.parent / h.source).read_text()
    assert Path(_build.CSRC_DIR / "rng.cu").read_text() == src
    m = re.search(r'extern "C" int ' + h.symbol + r"\(([^)]*)\)", src)
    assert m and len(m.group(1).split(",")) == len(_build.SIGNATURES[h.symbol])
    assert "lens_flare_tpu/integrator/path.py" in h.replaces


def test_kernel_route_imports_nothing_more():
    """The routing around kernel H adds no import to a fresh process: ``torch.broadcast_shapes``, for
    one, loads sympy, seconds of every run's set-up."""
    code = """
import sys, torch
from lens_flare_tpu_torch import _rng
before = set(sys.modules)
_rng._takes_kernel = lambda keys: True
_rng._launch = lambda mode, keys, u=1, data=None: torch.zeros((keys.shape[0], 2 if mode < 2 else u))
k = _rng.fold_in(_rng.prng_key(1).expand(64, 2), torch.arange(64))
k = _rng.fold_in(_rng.fold_in(k, torch.tensor(3)), 7)
_rng.uniform(k, (32,)), _rng.random_bits(k, (4,)), _rng.uniform(_rng.split(_rng.prng_key(5), 16), (2,))
print(sorted(m for m in set(sys.modules) - before if not m.startswith("lens_flare_tpu_torch")))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         cwd=Path(__file__).resolve().parent.parent)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]", res.stdout


# ---------------------------------------------------------------------------
# kernel H against the plain int64 code, bit for bit
# ---------------------------------------------------------------------------

ROUTED = types.SimpleNamespace(fold_in=_rng.fold_in, uniform=_rng.uniform, split=_rng.split,
                               random_bits=_rng.random_bits)
PLAIN = types.SimpleNamespace(fold_in=_rng.fold_in_plain, uniform=_rng.uniform_plain, split=_rng.split_plain,
                              random_bits=_rng.random_bits_plain)


def _keys(n, dev, seed, top_bits=False):
    g = np.random.default_rng(seed)
    k = g.integers(0, 2**32, (n, 2), dtype=np.uint64).astype(np.int64)
    if top_bits:  # words with bit 31 set, and the extremes
        k |= 1 << 31
        k[:2] = [[2**32 - 1, 2**32 - 1], [2**31, 2**32 - 1]]
    return torch.as_tensor(k, device=dev)


def _pixels(n, dev):
    i = torch.arange(n, dtype=torch.int64, device=dev)
    return (i * 7919) % 2_073_600  # 1080p pixel indices, in no order


# each case draws with r (the routed functions or the plain ones) on device dev; the shapes the
# cells draw: the sample tape (U = 32: depth 4, two light slots; U = 40: three), the pixel keys of
# an expanded key, the 0-d sample index, the falloff's split + uniform
CASES = {
    "uniform_u32": lambda r, dev: r.uniform(_keys(65_536, dev, 1), (32,)),
    "uniform_u40": lambda r, dev: r.uniform(_keys(65_536, dev, 2), (40,)),
    "uniform_ragged_lanes": lambda r, dev: r.uniform(_keys(1_000_003, dev, 3), (1,)),
    "uniform_ragged_draws": lambda r, dev: r.uniform(_keys(1, dev, 4), (1_000_003,)),
    "uniform_2d_shape": lambda r, dev: r.uniform(_keys(333, dev, 5), (3, 7)),
    "top_bits": lambda r, dev: (r.random_bits(_keys(4099, dev, 6, True), (9,)),
                                r.uniform(_keys(4099, dev, 6, True), (9,))),
    "fold_in_int": lambda r, dev: (r.fold_in(_keys(65_536, dev, 7, True), 4_000_000_000),
                                   r.fold_in(_keys(65_536, dev, 7), -5)),
    "fold_in_int64_tensor": lambda r, dev: r.fold_in(
        _keys(65_536, dev, 8), torch.as_tensor(np.random.default_rng(8).integers(-2**40, 2**40, 65_536), device=dev)),
    "fold_in_int32_tensor": lambda r, dev: r.fold_in(
        _keys(65_536, dev, 9), torch.arange(-32_768, 32_768, dtype=torch.int32, device=dev) * 65_537),
    "fold_in_0d_index": lambda r, dev: r.fold_in(_keys(65_536, dev, 10), torch.tensor(13, device=dev)),
    "fold_in_expanded_key": lambda r, dev: r.fold_in(
        _rng.prng_key(2**31 + 7, device=dev).expand(65_536, 2), _pixels(65_536, dev)),
    "fold_in_one_key": lambda r, dev: r.fold_in(_rng.prng_key(11, device=dev), 123),
    "split_uniform": lambda r, dev: (r.split(_rng.prng_key(12, device=dev), 16),
                                     r.uniform(r.split(_rng.prng_key(12, device=dev), 16), (2,))),
    "sample_tape": lambda r, dev: r.uniform(
        r.fold_in(r.fold_in(_rng.prng_key(2_148_300_001, device=dev).expand(65_536, 2), _pixels(65_536, dev)),
                  torch.tensor(3, dtype=torch.int64, device=dev)), (32,)),
}


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _same(got, want):
    got, want = (got,) if torch.is_tensor(got) else got, (want,) if torch.is_tensor(want) else want
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape and a.is_contiguous(), (a.dtype, b.dtype, a.shape, b.shape)
        assert torch.equal(_bits(a), _bits(b))


# the CUDA source built for the CPU: device qualifiers dropped, intrinsics written out, and
# ``kernel<<<grid, threads, 0, stream>>>(args)`` turned into a loop over blocks and threads
SHIM = r"""
#include <cstdint>
#include <cstring>
#include <math.h>
#define __global__
#define __device__
#define __forceinline__ inline
#define __restrict__
struct LfDim { unsigned int x; };
static LfDim blockIdx, threadIdx;
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
static inline cudaError_t cudaGetLastError() { return cudaSuccess; }
static inline uint32_t __funnelshift_l(uint32_t lo, uint32_t hi, uint32_t s) {
  s &= 31u;
  return s ? (hi << s) | (lo >> (32u - s)) : hi;
}
static inline float __uint_as_float(uint32_t u) { float f; std::memcpy(&f, &u, 4); return f; }
struct longlong2 { long long x, y; };
static inline longlong2 make_longlong2(long long x, long long y) { return {x, y}; }
#define LF_CPU_LAUNCH(grid, threads, kernel) \
  for (blockIdx.x = 0; blockIdx.x < (unsigned)(grid); ++blockIdx.x) \
    for (threadIdx.x = 0; threadIdx.x < (unsigned)(threads); ++threadIdx.x) kernel
"""


@pytest.fixture(scope="module")
def rng_library(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build csrc/rng.cu for the CPU")
    src = (_build.CSRC_DIR / "rng.cu").read_text().replace("#include <cuda_runtime.h>", SHIM)
    src, launches = re.subn(r"(\w+(?:<\w+>)?)<<<(\w+), (\w+), 0, (\w+)>>>\(", r"LF_CPU_LAUNCH(\2, \3, \1)(", src)
    assert launches == 3, "every launch of rng.cu is rewritten"
    d = tmp_path_factory.mktemp("rng_cpu")
    (d / "rng_cpu.cpp").write_text(src)
    so = d / "librng_cpu.so"
    res = subprocess.run([gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC", "-o", str(so),
                          str(d / "rng_cpu.cpp")], capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    import ctypes

    lib = ctypes.CDLL(str(so))
    lib.lf_threefry.argtypes = _build.SIGNATURES["lf_threefry"]
    lib.lf_threefry.restype = ctypes.c_int
    return lib


@pytest.fixture
def kernel_on_cpu(rng_library, monkeypatch):
    """``_rng``'s kernel route on CPU tensors, through rng.cu built for the CPU."""
    monkeypatch.setattr(_rng, "_takes_kernel", lambda keys: True)
    monkeypatch.setattr(_build, "load_library", lambda: rng_library)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: types.SimpleNamespace(cuda_stream=None))
    ic.reset_launch_counts()


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_source_equals_plain_on_the_cpu(case, kernel_on_cpu):
    got = CASES[case](ROUTED, "cpu")
    assert ic.KERNELS["H"].launches > 0
    _same(got, CASES[case](PLAIN, "cpu"))


def test_kernel_route_launches_once_per_call(kernel_on_cpu):
    keys = _rng.fold_in(_rng.prng_key(1).expand(100, 2), torch.arange(100))
    _rng.uniform(_rng.fold_in(keys, torch.tensor(2)), (32,))
    _rng.uniform(_rng.split(_rng.prng_key(5), 16), (2,))
    assert ic.KERNELS["H"].launches == 5
    assert _rng.uniform(keys[:0], (32,)).shape == (0, 32) and ic.KERNELS["H"].launches == 5  # nothing to draw
    with pytest.raises(ValueError, match="int64"):
        _rng.uniform(keys.to(torch.int32), (2,))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernel H has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_equals_plain_on_card(case, cuda_device):
    ic.reset_launch_counts()
    got = CASES[case](ROUTED, cuda_device)
    assert ic.KERNELS["H"].launches > 0 and all(
        x.device.type == "cuda" for x in ((got,) if torch.is_tensor(got) else got))
    want = CASES[case](PLAIN, cuda_device)
    torch.cuda.synchronize()
    _same(got, want)
