"""The port runs with JAX (and PIL) unimportable, as on the card's machine.

A subprocess installs a meta-path hook that refuses ``jax``, ``jaxlib``,
``flax``, ``optax``, ``orbax``, ``PIL`` and the JAX package
``lens_flare_tpu`` itself (the port keeps its own copies of the host
modules it needs), then imports the port, renders a 16x12 frame of the
port's 128-triangle terrain with the flare on the CPU, writes its PNGs and
runs the kernel bench on the CPU at a tiny size.  Any import of a refused
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
    art = bench_kernels.main(["--device", "cpu", "--n", "256", "--scenes", "8,40", "--out", sys.argv[2]])
    assert any(r.get("check") == "top_batch2_parity" for r in art["rows"])
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not loaded, loaded
    print("rendered", float(hdr.mean()))
    """
)


def test_port_renders_without_jax(tmp_path):
    out = tmp_path / "frame.png"
    res = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(out), str(tmp_path / "bench.json")],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr[-4000:]
    assert "rendered" in res.stdout
    png = out.read_bytes()
    assert png.startswith(b"\x89PNG\r\n\x1a\n") and len(png) > 100
    assert (tmp_path / "frame_rate.png").exists()
    assert (tmp_path / "bench.json").exists()
