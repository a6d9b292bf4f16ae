"""Threefry-2x32 counter RNG as ``jax.random`` draws it (frozen copy of ``lens_flare_tpu_torch/_rng.py``).

The reference renders the program's estimator on the same random numbers:
``prng_key``, ``fold_in``, ``uniform`` and ``split`` under
``jax_threefry_partitionable=True``.  Keys are int64 tensors of shape
``(..., 2)`` holding uint32 values.
"""

from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0, k1, x0, x1):
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
    return torch.tensor([0, int(seed) & MASK32], dtype=torch.int64, device=device)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    data = int(data) & MASK32 if not torch.is_tensor(data) else data.to(torch.int64) & MASK32
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1], 0, data)
    return torch.stack([y0, y1], dim=-1)


def _counts(n: int, device):
    i = torch.arange(n, dtype=torch.int64, device=device)
    return i >> 32, i & MASK32


def uniform(keys: torch.Tensor, shape: tuple) -> torch.Tensor:
    """float32 uniforms in [0, 1) of shape ``keys.shape[:-1] + shape``."""
    n = math.prod(shape)
    hi, lo = _counts(n, keys.device)
    y0, y1 = threefry2x32(keys[..., 0, None], keys[..., 1, None], hi, lo)
    bits = (y0 ^ y1).reshape(keys.shape[:-1] + tuple(shape))
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(f, 0.0)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    hi, lo = _counts(num, key.device)
    y0, y1 = threefry2x32(key[0], key[1], hi, lo)
    return torch.stack([y0, y1], dim=-1)
