"""The port's threefry RNG against jax.random, bit for bit.

Tolerance: none.  Every word and every float must be identical, because
the integrator parity tests rely on both packages drawing the same tape.
"""

import jax
import numpy as np
import pytest
import torch

from lens_flare_tpu.integrator.path import RenderSettings, tape_size
from lens_flare_tpu_torch import _rng

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
