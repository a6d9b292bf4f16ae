"""Kernel C's bound and the brute-mode scene's wavefronts (``benchlib/brute_roofline.py``), on the CPU."""

import json
import tempfile

import pytest
import torch
from conftest import BENCH

from benchlib import brute_roofline, cornell_scene, roofline
from benchlib.scene import LT_DIRECTIONAL

CONFIG = json.loads((BENCH / "configs" / "config1_cornell_spheres.json").read_text())


def test_brute_work_counts_live_lanes_rows_and_blocks():
    n = 600  # three blocks of 256 lanes, the last ragged
    o, d = torch.zeros((n, 3)), torch.ones((n, 3))
    t_lo = torch.full((n,), 1e-4)
    t_hi = torch.where(torch.arange(n) < 450, 5.0, 0.0)  # 450 live lanes; dead ones test nothing
    w = brute_roofline.brute_work(22, 2, (o, d, t_lo, t_hi))
    assert w["flops"] == 450 * (22 * roofline.FLOP_PER_TEST["any"] + 2 * brute_roofline.SPHERE_FLOP_PER_TEST)
    assert w["bytes"] == n * roofline.LANE_BYTES + 3 * (22 * 48 + 2 * 32)
    b_ms, by = roofline.bound_ms(w)
    assert by == "bytes" and b_ms == pytest.approx(w["bytes"] / roofline.PEAK_BYTES * 1e3)


@pytest.fixture(scope="module")
def box():
    """The cell's renderer on the CPU at 64 x 48 (A and C run their plain versions)."""
    from lens_flare_tpu_torch.renderer import Renderer

    scene = cornell_scene.make(CONFIG["scene"], 2**33 + 5)
    r = Renderer(width=64, height=48, device="cpu", **dict(CONFIG["render"], tile_pixels=3072))
    r.load(cornell_scene.write(scene, tempfile.mkdtemp()))
    lights = {"type": scene.light_type, "position": scene.light_position, "direction": scene.light_direction}
    return scene, r, lights


def test_wavefronts_of_the_box(box):
    from lens_flare_tpu_torch.ops import intersect_cuda as ic
    from lens_flare_tpu_torch.scene.camera import camera_params

    scene, r, lights = box
    cs = r.bundle.cscene
    cam = camera_params(r.camera, torch.device("cpu"))._asdict()
    waves = brute_roofline.wavefronts(lambda *rays: ic.tree_closest_hit(cs, *rays), cs, cam, 64, 48, 3072, lights, 7)
    assert list(waves) == ["camera", "bounce", "shadow_area", "shadow_spot", "shadow_point", "shadow_directional"]
    t, slot = ic.tree_closest_hit(cs, *waves["camera"])[:2]
    n_slots = cs.tri.shape[0]
    on_sphere = slot >= n_slots
    assert bool(on_sphere.any()) and bool((slot >= 0).any())
    o2, d2, t_lo, t_hi = waves["bounce"]
    p = waves["camera"][0] + waves["camera"][1] * t[:, None]
    centre = cs.sph[(slot[on_sphere] - n_slots).long(), :3]
    out = ((p[on_sphere] - centre) * d2[on_sphere]).sum(-1)
    assert bool((out > 0).all())  # a bounce off a sphere leaves it: its normal is the centre's
    assert bool((t_hi[slot < 0] == 0).all()) and bool((t_hi[slot >= 0] == 1e30).all())
    for code, pos in zip(lights["type"], lights["position"]):
        name = "shadow_" + brute_roofline.SHADOW_NAMES[int(code)]
        so, sd, _, sh = waves[name]
        assert torch.allclose(torch.linalg.norm(sd, dim=-1), torch.ones(3072), atol=1e-5)
        if int(code) != LT_DIRECTIONAL:  # stops short of the light's position
            end = so[slot >= 0] + sd[slot >= 0] * (sh[slot >= 0] / 0.999)[:, None]
            assert torch.allclose(end, torch.as_tensor(pos).expand_as(end), atol=1e-3)


def test_measure_on_the_box(box, monkeypatch):
    """Rows of A and C with their bounds; the share is the sum of the bounds over the sum of the times
    (the times stood in for: the CPU has no CUDA events)."""
    scene, r, lights = box
    monkeypatch.setattr(roofline, "cuda_ms", lambda fn: (fn(), 0.01)[1])
    out = brute_roofline.measure(r, lights, 7)
    assert {k: v["kernel"] for k, v in out["rows"].items()} == {
        "camera": "A", "bounce": "A", "shadow_area": "C", "shadow_spot": "C", "shadow_point": "C",
        "shadow_directional": "C"}
    bounds = [v["bound_ms"] for v in out["rows"].values()]
    assert all(b > 0 for b in bounds) and out["share"] == pytest.approx(sum(bounds) / 0.06)


def test_measure_reads_none_off_brute_mode(box):
    _, r, lights = box
    cs = r.bundle.cscene
    r.bundle = r.bundle._replace(cscene=None)
    try:
        assert brute_roofline.measure(r, lights, 7) is None
    finally:
        r.bundle = r.bundle._replace(cscene=cs)
