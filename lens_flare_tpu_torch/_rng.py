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

Keys are ``int64`` tensors of shape ``(..., 2)`` holding uint32 values; all
arithmetic is ``int64`` masked to 32 bits (torch has no full uint32 support).
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


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """Fold uint32 ``data`` (int or tensor broadcast against keys[..., 0]) into keys."""
    if not torch.is_tensor(data):
        data = torch.tensor(int(data), dtype=torch.int64, device=keys.device)
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1], 0, data.to(torch.int64) & MASK32)
    return torch.stack([y0, y1], dim=-1)


def _counts(n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    i = torch.arange(n, dtype=torch.int64, device=device)
    return i >> 32, i & MASK32


def random_bits(keys: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """32-bit random words -> int64 tensor of shape ``keys.shape[:-1] + shape``."""
    n = math.prod(shape)
    hi, lo = _counts(n, keys.device)
    k0 = keys[..., 0, None]
    k1 = keys[..., 1, None]
    y0, y1 = threefry2x32(k0, k1, hi, lo)
    return (y0 ^ y1).reshape(keys.shape[:-1] + tuple(shape))


def uniform(keys: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """float32 uniforms in [0, 1): mantissa fill of the 23 high bits."""
    bits = random_bits(keys, shape)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(f, 0.0)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` -> (num, 2) keys."""
    hi, lo = _counts(num, key.device)
    y0, y1 = threefry2x32(key[0], key[1], hi, lo)
    return torch.stack([y0, y1], dim=-1)
