"""The port's turntable against ``tools/turntable.py``, on a small terrain file.

``scene/writer.py:terrain_dae(8)`` writes the file (128 triangles, a sun
and a fill light).  ``python -m lens_flare_tpu_torch.turntable ... --device
cpu`` runs in this process and ``tools/turntable.py`` in a subprocess with
``JAX_PLATFORMS=cpu``, both with ``--frames 3 --size 32 24 -s 1 -m 2``.
Both orbit the same host camera and draw the same threefry tape.

- The PNGs ``frame_000.png`` .. ``frame_002.png``, decoded: within one
  8-bit level on >= 99% of their values, ``tests/test_torch_cli.py``'s rule
  (the two sides round a radiance's last bits differently, and a value
  near a level boundary may land on either).
- The camera's dumps ``frames/frame_1.txt`` .. ``frame_3.txt``: the same
  names and the same text, and each loads back through ``load_settings``.
- Frame 2 rendered again through the port's command line with ``-c
  frames/frame_3.txt`` and the turntable's size, ``-s`` and ``-m``: the same
  PNG, byte for byte (on the card, ``chip_smoke.py``'s ``turntable`` phase
  does the same at 1920x1080).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from lens_flare_tpu_torch import cli, turntable
from lens_flare_tpu_torch.scene.camera import Camera
from lens_flare_tpu_torch.scene.writer import terrain_dae
from lens_flare_tpu_torch.utils.image import load_png

ROOT = Path(__file__).resolve().parents[1]
FRAMES = 3
ARGS = ["--frames", str(FRAMES), "--size", "32", "24", "-s", "1", "-m", "2"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("turntable")
    scene = terrain_dae(8).write(d / "terrain.dae")
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    res = subprocess.run([sys.executable, str(ROOT / "tools" / "turntable.py"), str(scene), *ARGS,
                          "--out", str(d / "jax")], cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    assert turntable.main([str(scene), *ARGS, "--out", str(d / "port"), "--device", "cpu"]) == 0
    return scene, d / "port", d / "jax"


def test_frames_match_the_jax_tool(runs):
    _, port, jax = runs
    names = sorted(p.name for p in port.glob("*.png"))
    assert names == [f"frame_{i:03d}.png" for i in range(FRAMES)] == sorted(p.name for p in jax.glob("*.png"))
    for name in names:
        got, want = load_png(port / name).astype(np.int64), load_png(jax / name).astype(np.int64)
        assert got.shape == want.shape == (24, 32, 3) and want.max() > 0
        diff = np.abs(got - want)
        assert diff.max() <= 1 and (diff == 0).mean() >= 0.99, (name, diff.max(), (diff == 0).mean())
    assert not np.array_equal(load_png(port / names[0]), load_png(port / names[-1])), "the camera did not orbit"


def test_dumped_settings_match_the_jax_tool(runs):
    _, port, jax = runs
    names = sorted(p.name for p in (port / "frames").iterdir())
    assert names == [f"frame_{i}.txt" for i in range(1, FRAMES + 1)]
    assert names == sorted(p.name for p in (jax / "frames").iterdir())
    for name in names:
        assert (port / "frames" / name).read_text() == (jax / "frames" / name).read_text()
        cam = Camera()
        cam.load_settings(port / "frames" / name)
        assert np.isfinite(cam.pos).all() and np.isfinite(cam.c2w).all()


def test_last_frame_renders_again_from_its_dump(runs, tmp_path):
    scene, port, _ = runs
    again = tmp_path / "again.png"
    assert cli.main(["-c", str(port / "frames" / f"frame_{FRAMES}.txt"), "-r", "32", "24", "-s", "1", "-m", "2",
                     "-f", str(again), "--device", "cpu", str(scene)]) == 0
    assert np.array_equal(load_png(again), load_png(port / f"frame_{FRAMES - 1:03d}.png"))
