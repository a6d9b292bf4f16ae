"""The port runs with JAX (and PIL) unimportable, as on the card's machine.

A subprocess installs a meta-path hook that refuses ``jax``, ``jaxlib``,
``flax``, ``optax``, ``orbax``, ``PIL`` and the JAX package
``lens_flare_tpu`` itself (the port keeps its own copies of the host
modules it needs), then imports the port, renders a 16x12 frame of the
port's 128-triangle terrain with the flare on the CPU, writes its PNGs,
renders it again under ``compiled.disabled()`` (``compiled.py``,
``ab_compiled.py`` and ``ab_cli.py`` imported), renders its pixels with
``parallel.render.render_sharded`` on two shards (bit-equal to one),
runs the kernel bench on the CPU at a tiny size, and runs the port's
command line on a Cornell-box COLLADA file (``chip_smoke.py``'s writer)
with ``-x``/``-y`` aperture PNGs, which the port reads without PIL, and
on a terrain file under a HALF sky map written by the port's
``utils/exr.write`` (``-e``) and with ``--lens-model realistic``, runs
``--upsample 1`` (Loop subdivision), drives the interactive ``Application``
through one frame in each mode and a mesh edit, runs
``optimize_lens`` for three steps with a checkpoint (``torch.optim`` and
``torch.save`` in place of optax and orbax), and takes the gradient of a
``render_image`` with respect to an albedo.  Any import of a refused
package fails the run.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

SCRIPT = textwrap.dedent(
    """
    import sys
    BLOCKED = {"jax", "jaxlib", "flax", "optax", "orbax", "PIL", "lens_flare_tpu"}

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ModuleNotFoundError(f"refused import of {name}")
            return None

    sys.meta_path.insert(0, Refuse())
    import numpy as np
    import torch

    import lens_flare_tpu_torch
    from lens_flare_tpu_torch import bench_kernels
    from lens_flare_tpu_torch.lens.aperture import ApertureTexture, polygon_mask
    from lens_flare_tpu_torch.renderer import Renderer
    from lens_flare_tpu_torch.scene.procedural import make_terrain_scene

    r = Renderer(
        width=16, height=12, ns_aa=1, max_ray_depth=4, seed=0, device="cpu",
        flare_intensity=1.5, flare_radius=30.0,
        aperture=ApertureTexture.from_array(polygon_mask(32, 5)),
        ghost_aperture=ApertureTexture.from_array(polygon_mask(16, 6)),
    )
    r.load_flat_scene(make_terrain_scene(8))
    out = sys.argv[1]
    hdr = r.render_to_file(out)
    assert hdr.shape == (12, 16, 3) and torch.isfinite(hdr).all()
    from lens_flare_tpu_torch import ab_cli, ab_compiled, compiled  # the captured programs and the A/Bs

    with compiled.disabled():
        eager = r.render(progress=False)[0]
    assert torch.equal(eager, r.render(progress=False)[0]) and len(r._programs) == 0
    from lens_flare_tpu_torch import _rng
    from lens_flare_tpu_torch.integrator.path import render_wavefront
    from lens_flare_tpu_torch.parallel import make_mesh
    from lens_flare_tpu_torch.parallel.render import render_sharded
    from lens_flare_tpu_torch.scene.camera import camera_params

    px, py, cam = torch.arange(192) % 16, torch.arange(192) // 16, camera_params(r.camera, "cpu")
    one = render_wavefront(r.bundle, r.settings, cam, px, py, 16, 12, _rng.prng_key(0))
    two = render_sharded(r.bundle, r.settings, cam, px, py, 16, 12, _rng.prng_key(0), mesh=make_mesh(devices=["cpu"] * 2))
    assert all(torch.equal(a, b) for a, b in zip(one, two))
    art = bench_kernels.main(["--device", "cpu", "--n", "256", "--scenes", "8,40", "--out", sys.argv[2]])
    assert any(r.get("check") == "top_batch2_parity" for r in art["rows"])

    import pathlib
    import chip_smoke
    from lens_flare_tpu_torch import cli
    from lens_flare_tpu_torch.utils.image import load_png, save_png

    d = pathlib.Path(sys.argv[3])
    dae = chip_smoke.cornell_box().write(d / "cornell.dae")
    save_png(d / "ap.png", polygon_mask(32, 5))
    save_png(d / "ghost.png", polygon_mask(16, 6))
    rc = cli.main(["-r", "16", "12", "-s", "1", "-m", "3", "-x", str(d / "ap.png"), "-y", str(d / "ghost.png"),
                   "-i", "1.5", "-n", "10", "-f", str(d / "cornell.png"), "--device", "cpu", str(dae)])
    assert rc == 0 and load_png(d / "cornell.png").shape == (12, 16, 3)
    from lens_flare_tpu_torch.utils import exr

    sky = np.broadcast_to(np.linspace(2.0, 0.2, 16, dtype=np.float32)[:, None, None], (16, 32, 3))
    exr.write(d / "sky.exr", sky, pixel_type=exr.PIXELTYPE_HALF)
    terrain = chip_smoke.terrain_dae(4).write(d / "terrain.dae")
    rc = cli.main(["-r", "16", "12", "-s", "1", "-m", "2", "-e", str(d / "sky.exr"), "-f", str(d / "sky.png"),
                   "--device", "cpu", str(terrain)])
    assert rc == 0 and load_png(d / "sky.png").max() > 0
    rc = cli.main(["-r", "16", "12", "-s", "1", "-m", "1", "--lens-model", "realistic", "-f", str(d / "real.png"),
                   "--device", "cpu", str(terrain)])
    assert rc == 0 and load_png(d / "real.png").shape == (12, 16, 3)
    rc = cli.main(["-r", "16", "12", "-s", "1", "-m", "2", "--upsample", "1", "-f", str(d / "up.png"),
                   "--device", "cpu", str(dae)])
    assert rc == 0 and load_png(d / "up.png").shape == (12, 16, 3)

    # the interactive application: one frame in each mode, and a mesh edit
    from lens_flare_tpu_torch.app import Application
    from lens_flare_tpu_torch.term_viewer import frame_to_ansi

    ra = Renderer(width=16, height=12, ns_aa=2, device="cpu")
    ra.load(dae)
    app = Application(ra, preview_width=16)
    frames = [app.frame()]
    for key in ("v", "r"):
        app.keyboard_event(key)
        frames.append(app.frame())
    app.keyboard_event("e")
    app.keyboard_event("u")
    frames.append(app.frame())
    assert all(f.shape == (12, 16, 3) and np.isfinite(f).all() for f in frames)
    assert ra.scene.num_triangles == 28 and frame_to_ansi(frames[2], 8, 3).count("\u2580") == 24

    # lens design with a checkpoint, and the gradient of a render
    from lens_flare_tpu_torch import _rng
    from lens_flare_tpu_torch.diff import render as dr
    from lens_flare_tpu_torch.diff.optimize import OptimizeConfig, ghost_image, optimize_lens
    from lens_flare_tpu_torch.integrator.path import make_settings
    from lens_flare_tpu_torch.lens.prescription import reference_prescription
    from lens_flare_tpu_torch.scene.camera import camera_params

    tex, axis = torch.full((8, 8), 0.8), torch.tensor([0.6, 0.55])
    target = ghost_image(reference_prescription(), tex, axis, 0.35, 16, 16)
    init = reference_prescription()
    init.spacings = init.spacings * 1.03
    cfg = OptimizeConfig(steps=3, log_every=0, checkpoint_dir=str(d / "lens_ck"), checkpoint_every=2)
    lens, losses = optimize_lens(target, tex, axis, 0.35, cfg, init_lens=init, device="cpu")
    assert len(losses) == 3 and (d / "lens_ck" / "step_2.pt").exists()
    r = Renderer(width=8, height=6, device="cpu")
    r.load(dae)
    px, py = torch.arange(48) % 8, torch.arange(48) // 8
    settings = make_settings(r.scene.lights, bsdf_table=r.scene.bsdfs, ns_aa=1, max_ray_depth=2)
    albedo = r.bundle.bsdfs.albedo[0].clone().requires_grad_(True)
    bundle = dr.replace_row(r.bundle, "bsdfs", "albedo", 0, albedo)
    dr.render_image(bundle, settings, camera_params(r.camera, "cpu"), px, py, 8, 6, _rng.prng_key(0), 1).sum().backward()
    assert torch.isfinite(albedo.grad).all() and albedo.grad.abs().sum() > 0
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not loaded, loaded
    print("rendered", float(hdr.mean()))
    """
)


def test_port_renders_without_jax(tmp_path):
    out = tmp_path / "frame.png"
    res = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(out), str(tmp_path / "bench.json"), str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr[-4000:]
    assert "rendered" in res.stdout
    png = out.read_bytes()
    assert png.startswith(b"\x89PNG\r\n\x1a\n") and len(png) > 100
    assert (tmp_path / "frame_rate.png").exists()
    assert (tmp_path / "bench.json").exists()
    assert (tmp_path / "cornell.png").read_bytes().startswith(b"\x89PNG")
    assert (tmp_path / "sky.png").read_bytes().startswith(b"\x89PNG")
    assert (tmp_path / "real.png").read_bytes().startswith(b"\x89PNG")
    assert (tmp_path / "up.png").read_bytes().startswith(b"\x89PNG")
