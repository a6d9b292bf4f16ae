"""The port's command line against the JAX package's, on one small Cornell-box file.

``chip_smoke.cornell_box`` writes the file: diffuse walls, a microfacet
(gold) block, an emitting ceiling panel (what ``-H`` sees), mirror and
glass spheres, an area, a spot, a point and a directional light.  ``lens_flare_tpu_torch.cli.main([..., "--device",
"cpu"])`` and ``lens_flare_tpu.cli.main`` render it with the same flags:
a ``-c`` camera file (written by the JAX camera at another frame size, so
the ``-r`` size must win), a ``-p`` cell, ``-x``/``-y`` aperture PNGs and
the flare; a second case adds ``-H`` (uniform-hemisphere direct light).
Both draw the same threefry tape lane for lane.

Tolerances and why:
- the PNGs, decoded: equal within one 8-bit level on >= 99% of the
  cell's values (the two sides round the last bits of a radiance
  differently, and a value near a level boundary may land on either);
- the HDR, through ``Renderer.load`` + ``render`` of the same cell: the
  ``_close`` rule of ``test_torch_integrator.py``, >= 99% of pixels within
  1e-4 absolute + 1e-4 relative and a mean relative difference < 1e-3.
  Glass and mirror paths follow the same random numbers on both sides,
  and no looser fraction was needed (a reflect/refract coin or Russian
  roulette step near its threshold could flip one pixel's path);
- ``rays_traced`` within 0.5%, as in ``test_torch_integrator.py``, and
  the binary walk's primitive tests within 1% of the JAX walk's.
The third case renders a frame with ``Renderer(use_wide_tree=False)``,
kernel G's binary-BVH walk (its plain version on the CPU), against the
JAX ``Renderer`` at the same rule.

``--upsample 1`` (Loop subdivision of every mesh) through both command
lines prints the same triangle counts and gives PNGs within one level;
the subdivided scene's HDR, through each package's ``subdivide_scene`` and
``Renderer``, within ``_close``.  ``--view`` runs the port's terminal
viewer on a scripted tty (keys ``r``, then ``q``) and returns 0.  Only
``--devices`` and ``-t`` above 1 are still refused.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from lens_flare_tpu import cli as j_cli
from lens_flare_tpu.scene import halfedge as j_halfedge
from lens_flare_tpu.renderer import Renderer as JaxRenderer
from lens_flare_tpu.scene import build as j_build
from lens_flare_tpu.scene import camera as j_camera
from lens_flare_tpu_torch import cli
from lens_flare_tpu_torch.lens.aperture import polygon_mask
from lens_flare_tpu_torch import term_viewer
from lens_flare_tpu_torch.renderer import Renderer
from lens_flare_tpu_torch.scene import halfedge
from lens_flare_tpu_torch.utils.image import load_png, save_png

W, H = 48, 36
CELL = (8, 6, 32, 24)
KW = dict(width=W, height=H, ns_aa=4, max_ray_depth=5, indirect=True, seed=0)


def _close(got, want, atol=1e-4, rtol=1e-4, frac=0.99):
    got = np.asarray(got, np.float64).reshape(-1, 3)
    want = np.asarray(want, np.float64).reshape(-1, 3)
    ok = (np.abs(got - want) <= atol + rtol * np.abs(want)).all(axis=1)
    assert ok.mean() >= frac, f"{ok.mean():.4f} of pixels within tolerance"
    rel = np.abs(got - want).sum() / max(np.abs(want).sum(), 1e-30)
    assert rel < 1e-3, rel


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    dae = chip_smoke.cornell_box().write(d / "cornell.dae")
    scene, info = j_build.load_scene(dae)
    cam = j_camera.Camera()
    cam.configure(info.camera, 64, 64)  # not the -r size
    j_camera.place_from_scene_info(cam, info, scene.bbox_min, scene.bbox_max)
    cam.rotate_by(0.15, -0.2)
    cam.move_forward(cam.r * 0.3)
    cam.dump_settings(d / "cam.txt")
    save_png(d / "aperture.png", polygon_mask(64, 5, rotation=0.3))
    save_png(d / "ghost.png", polygon_mask(32, 6))
    return d


def _cell(a):
    x, y, dx, dy = CELL
    return np.asarray(a)[y : y + dy, x : x + dx]


@pytest.mark.parametrize("hemisphere", [False, True], ids=["nee", "hemisphere"])
def test_cli_matches_jax(hemisphere, files):
    d = files
    flags = ["-r", str(W), str(H), "-s", "4", "-m", "5", "-c", str(d / "cam.txt"),
             "-p", *map(str, CELL), "-x", str(d / "aperture.png"), "-y", str(d / "ghost.png"),
             "-i", "1.5", "-n", "20"] + (["-H"] if hemisphere else [])
    tag = "h" if hemisphere else "n"
    assert cli.main([*flags, "-f", str(d / f"port_{tag}.png"), "--device", "cpu", str(d / "cornell.dae")]) == 0
    assert j_cli.main([*flags, "-f", str(d / f"jax_{tag}.png"), str(d / "cornell.dae")]) == 0
    got, want = load_png(d / f"port_{tag}.png"), load_png(d / f"jax_{tag}.png")
    assert got.shape == want.shape == (H, W, 3)
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert (diff <= 1).mean() >= 0.99, (diff <= 1).mean()
    assert (d / f"port_{tag}_rate.png").exists()
    # the HDR of the same cell through Renderer.load + render
    kw = dict(KW, direct_hemisphere_sample=hemisphere, camera_settings=str(d / "cam.txt"))
    r = Renderer(device="cpu", **kw)
    r.load(d / "cornell.dae")
    hdr, counts = r.render(cell=CELL, progress=False)
    j = JaxRenderer(use_pallas=False, **kw)
    j.load(d / "cornell.dae")
    j_hdr, j_counts = j.render(cell=CELL, progress=False)
    assert _cell(hdr.numpy()).sum() > 0 and (counts.numpy() == np.asarray(j_counts)).all()
    _close(_cell(hdr.numpy()), _cell(j_hdr))
    assert abs(r.stats.total_rays - j.stats.total_rays) <= 5e-3 * j.stats.total_rays
    # every family and light type of the file was in the frame's tables
    assert set(r.settings.bsdf_families) == {0, 1, 2, 3, 5} and set(r.settings.light_types) == {1, 2, 3, 5}


def test_binary_bvh_frame_matches_jax(files):
    """Renderer(use_wide_tree=False): the whole frame through kernel G's plain version."""
    kw = dict(KW, ns_aa=2)
    r = Renderer(device="cpu", use_wide_tree=False, **kw)
    r.load(files / "cornell.dae")
    assert r.bundle.cscene is None and r.bundle.bvh is not None
    hdr, counts = r.render(progress=False)
    j = JaxRenderer(use_pallas=False, **kw)
    j.load(files / "cornell.dae")
    j_hdr, j_counts = j.render(progress=False)
    assert (counts.numpy() == np.asarray(j_counts)).all() and hdr.numpy().sum() > 0
    _close(hdr.numpy(), j_hdr)
    # the same tree and walk: on identical rays the tests agree lane for lane
    # (test_torch_bvh.py); here the rays differ in their last bits, and in an
    # axis-aligned box a ray's entry into two boxes that share a plane can
    # tie, so which one it visits first (and its tests) may differ: 0.67%
    # more tests on this frame
    assert abs(r.stats.total_isects - j.stats.total_isects) <= 1e-2 * j.stats.total_isects
    assert abs(r.stats.total_rays - j.stats.total_rays) <= 5e-3 * j.stats.total_rays


def test_trace_writes_a_chrome_trace(files, tmp_path):
    """--trace DIR profiles the render with torch.profiler and writes DIR/trace.json, which names the
    port's own ranges."""
    out = tmp_path / "trace"
    assert cli.main(["-r", "16", "12", "-f", str(tmp_path / "t.png"), "--device", "cpu", "--trace", str(out),
                     str(files / "cornell.dae")]) == 0
    text = (out / "trace.json").read_text()
    assert '"traceEvents"' in text and (tmp_path / "t.png").exists()
    for name in ("lf.renderer.render", "lf.renderer.prepare", "lf.renderer.tile", "lf.image.to_color"):
        assert f'"{name}"' in text, name


def test_upsample_matches_jax(files, capsys):
    """--upsample 1: the same Loop-subdivided scene through both command lines, and its HDR."""
    d = files
    flags = ["-r", str(W), str(H), "-s", "2", "-m", "3", "--upsample", "1"]
    assert cli.main([*flags, "-f", str(d / "port_up.png"), "--device", "cpu", str(d / "cornell.dae")]) == 0
    port_out = capsys.readouterr().out
    assert j_cli.main([*flags, "-f", str(d / "jax_up.png"), str(d / "cornell.dae")]) == 0
    jax_out = capsys.readouterr().out
    line = [ln for ln in port_out.splitlines() if "Loop-subdivided" in ln]
    assert line == [ln for ln in jax_out.splitlines() if "Loop-subdivided" in ln]
    assert line == ["[PathTracer] Loop-subdivided x1: 22 -> 88 triangles"]
    got, want = load_png(d / "port_up.png"), load_png(d / "jax_up.png")
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert got.shape == (H, W, 3) and (diff <= 1).mean() >= 0.99, (diff <= 1).mean()
    kw = dict(KW, ns_aa=2, max_ray_depth=3)
    r = Renderer(device="cpu", **kw)
    r.load(d / "cornell.dae")
    r.load_flat_scene(halfedge.subdivide_scene(r.scene, 1), camera=r.camera)
    j = JaxRenderer(use_pallas=False, **kw)
    j.load(d / "cornell.dae")
    j.load_flat_scene(j_halfedge.subdivide_scene(j.scene, 1), camera=j.camera)
    np.testing.assert_array_equal(r.scene.tri_p, j.scene.tri_p)
    hdr, counts = r.render(progress=False)
    j_hdr, j_counts = j.render(progress=False)
    assert (counts.numpy() == np.asarray(j_counts)).all() and hdr.numpy().sum() > 0
    _close(hdr.numpy(), j_hdr)


class ScriptedTTY:
    """Stands in for ``term_viewer.TerminalIO``: yields one scripted event per ``events`` call."""

    def __init__(self, script=(("key", "r"), ("key", "q"))):
        self.script = list(script)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def events(self, timeout=0.0):
        if self.script:
            yield self.script.pop(0)


def test_view_runs_the_terminal_viewer(files, monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(term_viewer, "TerminalIO", ScriptedTTY)
    monkeypatch.setattr(term_viewer.os, "get_terminal_size", lambda *fd: term_viewer.os.terminal_size((24, 10)))
    rc = cli.main(["-r", "24", "16", "-s", "2", "-m", "2", "--view", "--trace", str(tmp_path / "t"),
                   "-f", str(tmp_path / "v.png"), "--device", "cpu", str(files / "cornell.dae")])
    out = capsys.readouterr().out
    assert rc == 0
    assert "--trace applies to offline renders only" in out
    # one frame drawn after 'r': 8 rows of 24 half-block cells, and the RENDER HUD line
    assert out.count("\u2580") == 8 * 24 and "[RENDER] spp=2" in out
    assert not (tmp_path / "v.png").exists() and not (tmp_path / "t").exists()


@pytest.mark.parametrize("flags", [["--devices", "2"], ["-t", "2"]], ids=["devices", "threads"])
def test_only_multi_device_is_refused(flags, files, tmp_path, monkeypatch):
    """The name is from when these flags were refused.  Multi-device rendering is ported (ROADMAP Queue 1
    item 9): the flags shard the render over two devices (two stand-ins of the CPU) and write the
    one-device PNG."""
    from lens_flare_tpu_torch.parallel import mesh

    def args(name):
        return ["-r", "8", "6", "-f", str(tmp_path / name), "--device", "cpu", str(files / "cornell.dae")]

    assert cli.main(["--devices", "1", "-t", "1", *args("one.png")]) == 0
    monkeypatch.setattr(mesh, "available_devices", lambda device: [torch.device("cpu")] * 2)
    assert cli.main([*flags, *args("two.png")]) == 0
    assert (tmp_path / "one.png").read_bytes() == (tmp_path / "two.png").read_bytes()
