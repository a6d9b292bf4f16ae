"""The port's kernel bench (``python -m lens_flare_tpu_torch.bench_kernels``).

Its wavefronts are held to ``tools/bench_kernels._wavefronts`` on the
3,200-triangle terrain: the same pixels, camera rays, threefry cosine
bounces and shadow rays.  Tolerance: the hit masks (t_hi > 0) equal on
>= 99.9% of lanes and, where both sides are live, every component within
1e-5 + 1e-4 relative on >= 99.9% of lanes and within 1e-3 relative on all,
the FMA tolerance of ``test_torch_intersect.py`` (the JAX side's hit
normals, bounce frame and norms come from XLA:CPU, which may contract
products into fused multiply-adds, and a normal's cancellation amplifies
that).  The first 7,999 pixels of the film in
block order see only sky, so 16,384 lanes are compared.  Then ``--device
cpu`` runs end to end at a tiny size: the plain versions of every kernel,
the group-walk parity check and the coefficient-walk A/B, with no time, and
hands back every E and F call it made as a case whose kernel and plain
version agree exactly.
"""

import importlib.util
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from lens_flare_tpu_torch import bench_kernels as bk

ROOT = Path(__file__).resolve().parent.parent


def _tool():
    spec = importlib.util.spec_from_file_location("tools_bench_kernels", ROOT / "tools" / "bench_kernels.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_wavefronts_match_tool():
    tool = _tool()
    n = 16384
    want = tool._wavefronts(tool._build("terrain40"), n, jax.random.PRNGKey(0))
    got = bk.wavefronts(bk.build_renderer(40, "cpu"), n)
    for name, w, g in zip(("primary", "bounce", "shadow"), want, got):
        w = [np.asarray(x) for x in w]
        g = [x.numpy() for x in g]
        live_w, live_g = w[3] > w[2], g[3] > g[2]
        assert (live_w == live_g).mean() >= 0.999, name
        both = live_w & live_g
        if name != "primary":
            assert both.sum() > 1000, name
        for x, y in zip(w, g):
            x, y = x[both].reshape(both.sum(), -1), y[both].reshape(both.sum(), -1)
            close = np.isclose(y, x, rtol=1e-4, atol=1e-5).all(axis=1)
            assert close.mean() >= 0.999, name
            # the rest: a shading normal that cancellation moved by a few ulps
            assert (np.abs(y - x) <= 1e-3 * np.maximum(np.abs(x), 1.0)).all(), name


def test_rays_on_a_wide_film():
    """The wavefronts of a non-square film (chip_smoke.py's 1920x1080 rows, cut down) and random_rays.

    Block order follows the film's own width: the first 32x32 block's pixels
    come first, then the block to its right.  random_rays: camera rays at
    the camera's clip range, bounces live exactly where the camera ray hit,
    shadow rays live on a subset of those, odd shadow lanes along the bounce.
    """
    from lens_flare_tpu_torch.renderer import Renderer
    from lens_flare_tpu_torch.scene.camera import camera_params, generate_rays
    from lens_flare_tpu_torch.scene.procedural import make_terrain_scene

    r = Renderer(width=96, height=64, max_ray_depth=4, device="cpu")
    r.load_flat_scene(make_terrain_scene(8))
    n = 2048
    primary, bounce, shadow = bk.wavefronts(r, n)
    px = np.concatenate([np.tile(np.arange(32), 32), 32 + np.tile(np.arange(32), 32)])
    py = np.concatenate([np.repeat(np.arange(32), 32)] * 2)
    cam = camera_params(r.camera, "cpu")
    x = (torch.as_tensor(px, dtype=torch.float32) + 0.5) / 96
    y = (torch.as_tensor(py, dtype=torch.float32) + 0.5) / 64
    o, d = generate_rays(cam, x, y)
    assert torch.equal(primary[0], o) and torch.equal(primary[1], d)
    assert all(w[0].shape == (n, 3) and w[2].shape == (n,) for w in (primary, bounce, shadow))

    gen = torch.Generator().manual_seed(0)
    rays = bk.random_rays(r, n, gen)
    cam_o, cam_d, lo, hi = rays["camera"]
    assert torch.equal(lo, cam.n_clip.expand(n)) and torch.equal(hi, cam.f_clip.expand(n))
    hit = rays["bounce"][3] > 0
    assert 0 < hit.sum() < n
    live = rays["shadow"][3] > 0
    assert (live <= hit).all() and 0.5 < live.sum() / hit.sum() < 0.9
    odd = torch.arange(n) % 2 == 1
    assert torch.equal(rays["shadow"][1][odd], rays["bounce"][1][odd])


def test_cpu_run_end_to_end(tmp_path):
    out = tmp_path / "bench.json"
    cases = []
    art = bk.main(["--device", "cpu", "--n", "1024", "--scenes", "8,40", "--out", str(out)], cases=cases)
    assert json.loads(out.read_text()) == art
    assert art["platform"] == "cpu" and art["device"] == "cpu"
    rows = art["rows"]
    default = [r for r in rows if "wavefront" in r and "tree" not in r]
    assert len(default) == 6 and all(r["ms"] is None for r in default)
    parity = [r for r in rows if r.get("check", "").startswith("top_batch")]
    assert [r["top_batch"] for r in parity] == [2, 4] and all(r["ok"] for r in parity)
    mxu = [r for r in rows if "tree" in r]
    assert [r["tree"] for r in mxu] == ["8x32x32"] * 2 + ["32x32x32"] * 2
    for r in mxu:
        assert r["hit_agree"] == 1.0 and r["prim_agree"] == 1.0 and r["t_maxrel"] < 1e-3
        assert r["tests_base"] == r["tests_mxu"] > 0
        assert r["base_ms"] is None and r["speedup"] is None
    assert [c.label for c in cases] == [
        "terrain40_bounce_tb2", "terrain40_shadow_tb2", "terrain40_bounce_tb4", "terrain40_shadow_tb4",
        "terrain64_primary", "terrain64_bounce", "terrain128_primary", "terrain128_bounce",
    ]
    for c in cases:
        got, want = c.kernel(), c.plain()
        assert all(torch.equal(g, w) for g, w in zip(got, want)), c.label
        assert c.ms is None and c.base_tests.shape == c.rays[2].shape
        if c.key == "E":
            assert torch.equal(got[3], c.base_tests), c.label  # A's tests: the same chunks


@pytest.mark.parametrize("tool", ["bench_kernels", "ab_walk"])
def test_refuses_without_card(tool, monkeypatch, tmp_path):
    """Both measuring entry points raise, before building anything, where there is no card."""
    from lens_flare_tpu_torch import ab_walk

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {"bench_kernels": ["--n", "64"], "ab_walk": ["--baseline", str(tmp_path)]}[tool]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        {"bench_kernels": bk, "ab_walk": ab_walk}[tool].main(argv + ["--out", str(tmp_path / "x.json")])
    assert not (tmp_path / "x.json").exists()
