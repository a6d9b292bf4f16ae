"""The environment light of the port against the JAX package's ``integrator/envlight.py`` and renderer.

Maps are made from numpy seeds (8x16 to 64x128 texels) with all-zero rows
and runs of equal texels, so that the CDF tables hold ties and flat rows.

Tolerances and why:

- ``build_env``'s four float32 tables: bit-equal (both packages build them
  in float64 NumPy and round once);
- ``sample_env``'s texel (y, x): equal on every lane.  The index comes from
  comparisons on equal tables, so it is exact; it is read out through a map
  whose texels hold their own index.  The uniforms include u = 0, u equal
  to CDF entries (ties: the count must include them), rows whose CDF is all
  zero (count W, clipped to W - 1) and u -> 1.  Its radiance is then equal,
  and ``wi`` and ``pdf`` go through sin and cos of the same angles: rtol
  1e-5 (XLA:CPU and ATen differ in their last ulps);
- ``sample_dir``: rtol 1e-5 at the seam (phi -> 0 and 2 pi, x -> 0 and W),
  the poles (theta -> 0 and pi) and random directions, and an atol of what
  the angles' ulps explain: an ulp of ``arctan2`` (``arccos``) moves x (y)
  by W / 2 pi (H / pi) ulps of 2 pi (pi) texels, and the lookup changes by
  at most the map's largest value per texel moved; two ulps of each give
  2.2e-5 on the 16x32 map of range 3 (2.3e-6 read).  Across a round
  boundary the lookup picks the neighbouring texel, but that texel's
  bilerp weight is then within an ulp of 0, so the lookup stays continuous;
- frames of ``terrain_dae(8)`` (a sun, an area light) under a sky with a
  bright disk, the camera pulled back so that 67% of the pixel-centre
  rays miss: every pixel within rtol 1e-5 (atol 1e-6) of the JAX
  ``Renderer``'s, counts and rays traced equal, tiled with a padded last
  tile and adaptive (``-a``).  The largest differences read: 1.38e-5
  absolute, 1.29e-5 relative on a pixel under 0.35 (so within the atol);
  no pixel is beyond the tolerance, so none needed tracing to a texel
  picked across a round boundary.  NEE lanes skipped are equal too.  The
  same frame without the sky (bounce rays still miss): rtol 2e-5, since
  one of its 3,600 values reads 1.27e-5 relative (6.0e-6 on 0.47), the
  float32 noise of ROADMAP Queue 3 item 4, the same before and after the
  miss distance became 1e30;
- ``-e`` through both command lines: the PNGs within one 8-bit level on
  >= 99% of values, as ``tests/test_torch_cli.py`` holds them.

On the card (``-m gpu``): ``sample_env``, ``sample_dir`` and ``bilerp`` on
CUDA tensors equal the CPU's (indices exactly), and NaN, infinite and
out-of-range coordinates raise no device-side assert.
"""

import math

import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp

    from lens_flare_tpu import cli as j_cli
    from lens_flare_tpu.integrator import envlight as j_env
    from lens_flare_tpu.integrator import lights as j_lights
    from lens_flare_tpu.renderer import Renderer as JaxRenderer
except ImportError:  # the card's machine: only the gpu case can run
    jnp = None

import chip_smoke
from lens_flare_tpu_torch import cli
from lens_flare_tpu_torch.convert import env_from_numpy
from lens_flare_tpu_torch.integrator import envlight, lights
from lens_flare_tpu_torch.renderer import Renderer
from lens_flare_tpu_torch.utils import exr
from lens_flare_tpu_torch.utils.image import load_png

RTOL, ATOL = 1e-5, 1e-6
W, H = 40, 30  # 1,200 pixels: two 512-lane tiles and a padded third
TILE = 512


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: tier-1 runs six test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_map(h, w, seed):
    """A map with two all-zero rows (one of them the last), a run of equal texels and a black first column."""
    rng = np.random.default_rng(seed)
    m = rng.uniform(0.0, 3.0, (h, w, 3)).astype(np.float32)
    m[h // 3] = 0.0
    m[h - 1] = 0.0
    m[h // 2, w // 4 : w // 2] = 1.25
    m[:, 0] = 0.0
    return m


def sky_map(h=32, w=64, seed=0):
    """A sky: blue gradient, noise and a small bright disk (the sun)."""
    rng = np.random.default_rng(seed)
    y = np.arange(h)[:, None] / h
    m = np.stack(np.broadcast_arrays(0.3 + 0.7 * (1 - y), 0.4 + 0.5 * (1 - y), 0.9 + 0 * y), -1)
    m = np.broadcast_to(m, (h, w, 3)) + rng.uniform(0.0, 0.3, (h, w, 3))
    m[h // 8 : h // 8 + 2, w // 6 : w // 6 + 3] = 40.0
    return m.astype(np.float32)


def pull_back(camera):
    chip_smoke.pull_back(camera, 0.2)


@pytest.mark.parametrize("h,w", [(8, 16), (16, 32), (64, 128)])
def test_build_env_tables_equal_jax(h, w):
    m = random_map(h, w, seed=h)
    want, got = j_env.build_env(m), envlight.build_env(m)
    for name in envlight.EnvLightArrays._fields:
        a, b = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b), name
    assert np.all(np.asarray(want.conds_y)[h // 3] == 0.0)  # the zero row's CDF is flat


def _uniforms(env, n, seed):
    """Random uniforms, then u = 0, u on CDF entries (ties), at the zero rows and u -> 1."""
    rng = np.random.default_rng(seed)
    h, w = env.pdf_map.shape
    u = rng.uniform(size=(n, 2)).astype(np.float32)
    conds, marg = np.asarray(env.conds_y), np.asarray(env.marginal_y)
    k = n // 8
    u[:k, 0] = 0.0  # ties the black first column's CDF entry: x counts it
    u[k : 2 * k, 1] = 0.0
    u[2 * k : 3 * k, 0] = conds[rng.integers(0, h, k), rng.integers(0, w, k)]
    u[3 * k : 4 * k, 1] = marg[rng.integers(0, h, k)]
    # the zero row's marginal step is flat: u1 on it counts both equal entries
    u[4 * k : 5 * k, 1] = marg[h // 3]
    u[5 * k : 6 * k] = np.float32(1.0 - 2.0**-24)
    # u1 on the last CDF value: y = H, clipped to the last row, which is zero,
    # so its conditional CDF is flat: x counts W, clipped to W - 1
    u[6 * k : 7 * k, 1] = marg[-1]
    return u


@pytest.mark.parametrize("h,w", [(8, 16), (64, 128)])
def test_sample_env_matches_jax(h, w):
    m = random_map(h, w, seed=h + 1)
    j_e = j_env.build_env(m)
    t_e = env_from_numpy(j_e)
    u = _uniforms(j_e, 4096, seed=w)
    # a map whose texels hold their own index reads out the sampled (y, x)
    index = np.broadcast_to(np.arange(h * w, dtype=np.float32).reshape(h, w, 1), (h, w, 3))
    want_idx = j_env.sample_env(j_e._replace(data=jnp.asarray(index)), jnp.asarray(u)).radiance
    got_idx = envlight.sample_env(t_e._replace(data=torch.as_tensor(index.copy())), torch.as_tensor(u)).radiance
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    assert np.any(got_idx.numpy()[:, 0] == h * w - 1)  # the zero last row's count, clipped
    want = j_env.sample_env(j_e, jnp.asarray(u))
    got = envlight.sample_env(t_e, torch.as_tensor(u))
    np.testing.assert_array_equal(got.radiance.numpy(), np.asarray(want.radiance))
    np.testing.assert_allclose(got.wi.numpy(), np.asarray(want.wi), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.pdf.numpy(), np.asarray(want.pdf), rtol=RTOL)


def test_sample_dir_seam_poles_and_nan():
    m = random_map(16, 32, seed=5)
    j_e = j_env.build_env(m)
    t_e = env_from_numpy(j_e)
    rng = np.random.default_rng(6)
    eps = np.array([0.0, 1e-7, 1e-5, 1e-3], np.float32)
    # phi = atan2(-z, x) + pi: x < 0, z -> +-0 puts phi at 0 and 2 pi (texel x at 0 and W)
    seam = np.concatenate([np.stack([-np.ones(4), np.zeros(4), s * eps], -1) for s in (1, -1)])
    # theta = acos(y): y -> +-1 puts theta at 0 and pi (v at 0 and H)
    poles = np.concatenate([np.stack([eps, s * np.ones(4), eps[::-1]], -1) for s in (1, -1)])
    d = np.concatenate([seam, poles, rng.normal(size=(2048, 3))]).astype(np.float32)
    want = np.asarray(j_env.sample_dir(j_e, jnp.asarray(d)))
    got = envlight.sample_dir(t_e, torch.as_tensor(d)).numpy()
    h, w = m.shape[:2]
    ulp_x = w / (2 * np.pi) * np.spacing(np.float32(2 * np.pi))
    ulp_y = h / np.pi * np.spacing(np.float32(np.pi))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=2 * m.max() * (ulp_x + ulp_y))
    # non-finite and zero directions: no fault, finite values; the zero
    # direction equals JAX's, a NaN or inf one is looked up as it
    bad = np.array([[np.nan, 0, 0], [0, np.inf, 1], [-np.inf, np.nan, 0], [0, 0, 0]], np.float32)
    got = envlight.sample_dir(t_e, torch.as_tensor(bad)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[3], np.asarray(j_env.sample_dir(j_e, jnp.asarray(bad[3:])))[0], rtol=RTOL)
    np.testing.assert_array_equal(got[:3], np.broadcast_to(got[3], (3, 3)))


def test_bilerp_clamps_every_tap():
    """Texel coordinates outside the map read the texels JAX's indexing reads (negative from the end,
    then clamped), and NaN ones never fault."""
    m = random_map(8, 16, seed=7)
    x = np.array([-3.0, -0.6, 16.4, 17.0, 1e9, np.nan, 3.2], np.float32)
    y = np.array([-2.0, 9.0, 0.2, 8.0, -1e9, 3.0, np.nan], np.float32)
    got = envlight.bilerp(torch.as_tensor(m), torch.as_tensor(x), torch.as_tensor(y)).numpy()
    want = np.asarray(j_env.bilerp(jnp.asarray(m), jnp.asarray(x), jnp.asarray(y)))
    fin = np.isfinite(x) & np.isfinite(y)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)
    assert got.shape == (7, 3)


def test_env_light_rows_match_jax():
    """LT_ENV in the per-slot and the generic sampler; dist is INF, as JAX's."""
    m = random_map(16, 32, seed=8)
    j_e = j_env.build_env(m)
    t_e = env_from_numpy(j_e)
    from lens_flare_tpu.scene import build as j_build
    from lens_flare_tpu_torch.scene import build

    def table(mod, lt):
        return mod.LightTable(
            light_type=np.array([mod.LT_DIRECTIONAL, lt], np.int32),
            radiance=np.array([[1.0, 0.9, 0.8], [0, 0, 0]], np.float32),
            position=np.zeros((2, 3), np.float32), direction=np.array([[0, 1, 0], [0, 0, 0]], np.float32),
            dim_x=np.zeros((2, 3), np.float32), dim_y=np.zeros((2, 3), np.float32),
            area=np.zeros(2, np.float32), is_delta=np.array([True, False]),
        )

    j_arr = j_lights.lights_to_device(table(j_build, j_lights.LT_ENV))
    t_arr = lights.lights_to_device(table(build, lights.LT_ENV), "cpu")
    rng = np.random.default_rng(9)
    n = 1024
    p = rng.normal(size=(n, 3)).astype(np.float32)
    u = _uniforms(j_e, n, seed=10)
    li = rng.integers(0, 2, n).astype(np.int32)
    types = (1, 4)
    want = j_lights.sample_light(j_arr, jnp.asarray(li), jnp.asarray(p), jnp.asarray(u), env=j_e, types_present=types)
    got = lights.sample_light(t_arr, torch.as_tensor(li), torch.as_tensor(p), torch.as_tensor(u), env=t_e,
                              types_present=types)
    static = lights.sample_light_static(t_arr, 1, lights.LT_ENV, torch.as_tensor(p), torch.as_tensor(u), env=t_e)
    j_static = j_lights.sample_light_static(j_arr, 1, j_lights.LT_ENV, jnp.asarray(p), jnp.asarray(u), env=j_e)
    for name in ("radiance", "wi", "dist", "pdf"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(getattr(static, name).numpy(), np.asarray(getattr(j_static, name)),
                                   rtol=RTOL, atol=ATOL)
    assert (static.dist == lights.INF).all() and np.float32(lights.INF) == j_lights.INF


def test_save_probability_debug_matches_jax(tmp_path):
    m = random_map(8, 16, seed=11)
    j_env.save_probability_debug(j_env.build_env(m), tmp_path / "jax.png")
    envlight.save_probability_debug(envlight.build_env(m), tmp_path / "port.png")
    np.testing.assert_array_equal(load_png(tmp_path / "port.png"), load_png(tmp_path / "jax.png"))


@pytest.fixture(scope="module")
def terrain(tmp_path_factory):
    return chip_smoke.terrain_dae(8).write(tmp_path_factory.mktemp("env") / "terrain.dae")


def _renderers(terrain, **kw):
    kw = dict(dict(width=W, height=H, ns_aa=2, max_ray_depth=3, indirect=True, seed=0, envmap=sky_map(),
                   tile_pixels=TILE), **kw)
    r = Renderer(device="cpu", **kw)
    r.load(terrain)
    pull_back(r.camera)
    j = JaxRenderer(use_pallas=False, **kw)
    j.load(terrain)
    pull_back(j.camera)
    return r, j


@pytest.mark.parametrize("mode", ["tiled", "adaptive", "no_sky"])
def test_frame_matches_jax(mode, terrain):
    """The frame, its counts, rays traced and NEE lanes skipped equal the JAX ``Renderer``'s.

    Bounce rays miss on this frame, with the sky and without it (``no_sky``):
    a missed lane's next vertex lies at the miss distance, 1e30 in both
    packages, and its light sample and skip decision follow from there.
    """
    kw = dict(ns_aa=8, samples_per_batch=2, max_tolerance=0.05) if mode == "adaptive" else {}
    if mode == "no_sky":
        kw["envmap"] = None
    r, j = _renderers(terrain, **kw)
    assert 0.1 < chip_smoke.miss_share(r) < 0.9, "the frame should show both sky and terrain"
    assert len(r.bundle.lights.light_type) == len(r.scene.lights.light_type) + (mode != "no_sky")
    hdr, counts = r.render(progress=False)
    j_hdr, j_counts = j.render(progress=False)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(j_counts))
    np.testing.assert_allclose(hdr.numpy(), np.asarray(j_hdr), rtol=2e-5 if mode == "no_sky" else RTOL, atol=ATOL)
    assert r.stats.total_rays == j.stats.total_rays
    assert r.stats.total_zero_skipped == j.stats.total_zero_skipped
    if mode != "adaptive":  # 1,200 pixels in tiles of 512: the last is padded with 336 lanes that miss
        assert (W * H) % TILE and (counts == 2).all()
    else:
        assert counts.min() < counts.max()  # the adaptive stop took effect


def test_second_build_adds_no_second_env_row(terrain):
    r = Renderer(device="cpu", width=W, height=H, envmap=sky_map(), ns_area_light=2)
    r.load(terrain)
    n_scene = len(r.scene.lights.light_type)
    r.set_frame_size(W // 2, H // 2)
    r._build()
    assert len(r.scene.lights.light_type) == n_scene
    assert len(r.bundle.lights.light_type) == n_scene + 1
    assert r.settings.light_slot_types.count(lights.LT_ENV) == 2  # ns_area_light slots: not delta


def test_cli_env_matches_jax(terrain, tmp_path, capsys):
    sky = tmp_path / "sky.exr"
    exr.write(sky, sky_map(), pixel_type=exr.PIXELTYPE_HALF)
    r = Renderer(device="cpu", width=W, height=H)
    r.load(terrain)
    pull_back(r.camera)
    r.camera.dump_settings(tmp_path / "cam.txt")
    flags = ["-r", str(W), str(H), "-s", "2", "-m", "3", "-e", str(sky), "-c", str(tmp_path / "cam.txt")]
    assert cli.main([*flags, "-f", str(tmp_path / "port.png"), "--device", "cpu", str(terrain)]) == 0
    assert f"[PathTracer] Loading environment map {sky}" in capsys.readouterr().out
    assert j_cli.main([*flags, "-f", str(tmp_path / "jax.png"), str(terrain)]) == 0
    got, want = load_png(tmp_path / "port.png"), load_png(tmp_path / "jax.png")
    assert got.shape == want.shape == (H, W, 3)
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert (diff <= 1).mean() >= 0.99, (diff <= 1).mean()
    # the sky is in the frame: a render without -e differs
    assert cli.main([*flags[:-4], "-c", str(tmp_path / "cam.txt"), "-f", str(tmp_path / "dark.png"),
                     "--device", "cpu", str(terrain)]) == 0
    assert np.abs(load_png(tmp_path / "dark.png").astype(np.int64) - got).mean() > 10


def test_env_gives_the_miss_lookup_its_gradient():
    """A texel's gradient reaches it through the miss lookup's embedding gather: one texel's
    bilerp weight sum is its gradient of sum(sample_dir)."""
    m = torch.as_tensor(random_map(8, 16, seed=12))
    env = envlight.build_env(m.numpy())
    data = m.clone().requires_grad_(True)
    d = torch.as_tensor(np.random.default_rng(13).normal(size=(512, 3)).astype(np.float32))
    envlight.sample_dir(env._replace(data=data), d).sum().backward()
    assert math.isclose(float(data.grad.sum()), 512 * 3, rel_tol=1e-5)  # the weights sum to 1 per lane and channel


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_env_on_card_matches_cpu(cuda_device):
    m = random_map(64, 128, seed=14)
    cpu, gpu = envlight.build_env(m), envlight.build_env(m, cuda_device)
    rng = np.random.default_rng(15)
    u = torch.as_tensor(rng.uniform(size=(65536, 2)).astype(np.float32))
    u[:64] = 0.0
    u[64:128, 1] = cpu.marginal_y[-1]
    want, got = envlight.sample_env(cpu, u), envlight.sample_env(gpu, u.to(cuda_device))
    assert torch.equal(got.radiance.cpu(), want.radiance)
    for name in ("wi", "pdf"):
        torch.testing.assert_close(getattr(got, name).cpu(), getattr(want, name), rtol=RTOL, atol=ATOL)
    d = torch.as_tensor(rng.normal(size=(65536, 3)).astype(np.float32))
    d[:4] = torch.tensor([[float("nan"), 0, 0], [0, float("inf"), 1], [0, 0, 0], [-1, 0, 0]])
    got = envlight.sample_dir(gpu, d.to(cuda_device))
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    h, w = m.shape[:2]
    atol = 2 * m.max() * (w / (2 * np.pi) * np.spacing(np.float32(2 * np.pi)) + h / np.pi * np.spacing(np.float32(np.pi)))
    torch.testing.assert_close(got.cpu(), envlight.sample_dir(cpu, d), rtol=RTOL, atol=float(atol))
    x = torch.tensor([-3.0, 1e9, float("nan"), 200.0, -1e9])
    y = torch.tensor([-2.0, 70.0, 3.0, float("nan"), 1e9])
    got = envlight.bilerp(gpu.data, x.to(cuda_device), y.to(cuda_device))
    torch.cuda.synchronize()
    fin = torch.isfinite(x) & torch.isfinite(y)
    assert torch.equal(got.cpu()[fin], envlight.bilerp(cpu.data, x, y)[fin])
