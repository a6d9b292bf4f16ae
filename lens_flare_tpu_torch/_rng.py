"""Bit-exact threefry2x32 counter RNG, matching ``jax.random`` (jax 0.9.0).

The JAX package draws every random number from ``jax.random`` keys
(``integrator/path.py:392-411``, ``flare/starburst.py:169,179``).  This
module reproduces the calls it makes, bit for bit, so the port's samples are
lane-for-lane identical to the reference's:

- ``prng_key(seed)``       == ``jax.random.PRNGKey(seed)``
- ``fold_in(key, data)``   == ``jax.random.fold_in(key, data)``
- ``uniform(key, shape)``  == ``jax.random.uniform(key, shape)`` (float32, [0, 1))
- ``split(key, num)``      == ``jax.random.split(key, num)``

under jax's default ``jax_threefry_partitionable=True``: the counter of
element ``i`` of a draw is the 64-bit pair ``(i >> 32, i & 0xffffffff)``,
and a 32-bit draw is the XOR of the two output words.

Keys are ``int64`` tensors of shape ``(..., 2)`` holding uint32 values.  On
a CUDA device each call is one launch of kernel H (``ops/csrc/rng.cu``,
``lf_threefry``), counted in ``ops.intersect_cuda.KERNELS["H"]``; it raises
if the kernel cannot launch.  On the CPU the plain versions run
(``fold_in_plain``, ``random_bits_plain``, ``uniform_plain``,
``split_plain``): ``int64`` arithmetic masked to 32 bits (torch has no full
uint32 support), the same bits.
"""

from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds (jax's ``_threefry2x32_lowering``).

    All arguments are int64 tensors (or ints) with values in [0, 2^32),
    broadcast against each other.  Returns the two output words.
    """
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + k0) & MASK32
    x1 = (x1 + k1) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed -> (2,) int64 key."""
    return torch.tensor([0, int(seed) & MASK32], dtype=torch.int64, device=device)


def fold_in_plain(keys: torch.Tensor, data) -> torch.Tensor:
    """Fold uint32 ``data`` (int or tensor broadcast against keys[..., 0]) into keys.

    An int enters the arithmetic as a scalar: no tensor is made from it on
    the host, so the call can be captured in a CUDA graph.
    """
    data = int(data) & MASK32 if not torch.is_tensor(data) else data.to(torch.int64) & MASK32
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1], 0, data)
    return torch.stack([y0, y1], dim=-1)


def _counts(n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    i = torch.arange(n, dtype=torch.int64, device=device)
    return i >> 32, i & MASK32


def random_bits_plain(keys: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """32-bit random words -> int64 tensor of shape ``keys.shape[:-1] + shape``."""
    n = math.prod(shape)
    hi, lo = _counts(n, keys.device)
    k0 = keys[..., 0, None]
    k1 = keys[..., 1, None]
    y0, y1 = threefry2x32(k0, k1, hi, lo)
    return (y0 ^ y1).reshape(keys.shape[:-1] + tuple(shape))


def uniform_plain(keys: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """float32 uniforms in [0, 1): mantissa fill of the 23 high bits."""
    bits = random_bits_plain(keys, shape)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(f, 0.0)


def split_plain(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` -> (num, 2) keys."""
    hi, lo = _counts(num, key.device)
    y0, y1 = threefry2x32(key[0], key[1], hi, lo)
    return torch.stack([y0, y1], dim=-1)


# lf_threefry's modes (ops/csrc/rng.cu)
_FOLD_IN, _SPLIT, _BITS, _UNIFORM = range(4)


def _takes_kernel(keys: torch.Tensor) -> bool:
    return keys.device.type == "cuda"


def _launch(mode: int, keys: torch.Tensor, u: int = 1, data=None) -> torch.Tensor:
    """One launch of kernel H on ``keys`` (n, 2), read by stride: (n, 2) int64 keys (fold_in, split),
    (n, u) int64 words or (n, u) float32 uniforms.  ``data`` (fold_in): an int, or an int32 or int64
    tensor of shape (n,) or (), read on the device."""
    from .ops._build import load_library
    from .ops.intersect_cuda import KERNELS

    if keys.dtype != torch.int64 or keys.dim() != 2 or keys.shape[1] != 2:
        raise ValueError(f"keys: want int64 (n, 2), got {keys.dtype} {tuple(keys.shape)}")
    n, dev = keys.shape[0], keys.device
    d_ptr, d_stride, d_bytes, d_const = None, 0, 8, 0
    if torch.is_tensor(data):
        if data.device != dev:
            raise ValueError(f"data is on {data.device}, keys on {dev}")
        d_ptr, d_stride, d_bytes = data.data_ptr(), (data.stride(0) if data.dim() else 0), data.element_size()
    elif data is not None:
        d_const = int(data) & MASK32
    if mode in (_FOLD_IN, _SPLIT):
        out = torch.empty((n, 2), dtype=torch.int64, device=dev)
    else:
        out = torch.empty((n, u), dtype=torch.float32 if mode == _UNIFORM else torch.int64, device=dev)
    if out.numel() == 0:
        return out
    lib = load_library()
    with torch.cuda.device(dev):
        rc = lib.lf_threefry(
            keys.data_ptr(), keys.stride(0), keys.stride(1), d_ptr, d_stride, d_bytes, d_const,
            n, u, mode, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"kernel lf_threefry failed to launch: cudaError {rc}")
    KERNELS["H"].launches += 1
    return out


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """Fold uint32 ``data`` (int or tensor broadcast against keys[..., 0]) into keys.

    On a CUDA device a tensor ``data`` is read by the kernel where it lies:
    a 0-d sample index inside a captured program never reaches the host.
    """
    if not _takes_kernel(keys):
        return fold_in_plain(keys, data)
    if not torch.is_tensor(data):
        lead = keys.shape[:-1]
    else:
        if data.dtype not in (torch.int32, torch.int64):
            data = data.to(torch.int64)
        # views, no copy (torch.broadcast_shapes would import sympy: seconds of set-up)
        data, k0 = torch.broadcast_tensors(data, keys[..., 0])
        lead = k0.shape
        data = data.reshape(-1) if len(lead) != 0 else data
    # an expanded key stays a stride-0 view; a (2,) key is one lane
    return _launch(_FOLD_IN, keys.expand(*lead, 2).reshape(-1, 2), data=data).view(*lead, 2)


def random_bits(keys: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """32-bit random words -> int64 tensor of shape ``keys.shape[:-1] + shape``."""
    if not _takes_kernel(keys):
        return random_bits_plain(keys, shape)
    return _launch(_BITS, keys.reshape(-1, 2), math.prod(shape)).view(keys.shape[:-1] + tuple(shape))


def uniform(keys: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """float32 uniforms in [0, 1): mantissa fill of the 23 high bits."""
    if not _takes_kernel(keys):
        return uniform_plain(keys, shape)
    return _launch(_UNIFORM, keys.reshape(-1, 2), math.prod(shape)).view(keys.shape[:-1] + tuple(shape))


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` -> (num, 2) keys."""
    if not _takes_kernel(key):
        return split_plain(key, num)
    return _launch(_SPLIT, key.expand(num, 2))
