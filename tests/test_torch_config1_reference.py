"""BASELINE config 1 in the port against the benchmark's plain reference (``benchmark/benchlib/cornell_ref.py``),
on the CPU at a small size, and once on the card; and the lanes the trace kernels are handed.

The scene is the ``cornell_256_16spp`` cell's: the Cornell box with a
mirror and a glass sphere, its spheres and block drawn from the seed,
written by the benchmark's own COLLADA writer (``benchlib/cornell_scene.py``)
and read as the command line reads it (``Renderer.load``).  On the CPU the
frame is 48 x 32 at 4 samples a pixel, depth 5.

Tolerances and why:

- the writer: the port's reader gives back the arrays written exactly
  (9 significant digits parse back to the same float32, and the
  transforms, normals and light rows are the loader's own rules on the
  parsed numbers);
- the frame, rendered through ``Renderer.render``: every pixel within
  ``compare.REL`` (1e-4 of its largest channel), the per-pixel rule behind
  the cell's ``hdr_off``, and the 8-bit levels equal; the reference runs
  the same equations on the same threefry tape, so only float32 rounding
  may differ (~3e-6 of a pixel read).  The pixels show both spheres, the
  block and the emitter;
- the lanes: exact counts, host integers.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parent.parent / "benchmark"
sys.path[:0] = [str(BENCH)]

from benchlib import compare, cornell_scene, sky_scene  # noqa: E402
from benchlib.cornell_ref import CornellReference  # noqa: E402
from benchlib.reference import to_8bit  # noqa: E402
from benchlib.reference import to_color as ref_to_color  # noqa: E402

from lens_flare_tpu_torch import compiled  # noqa: E402
from lens_flare_tpu_torch.integrator import path as tpath  # noqa: E402
from lens_flare_tpu_torch.ops import intersect_cuda as ic  # noqa: E402
from lens_flare_tpu_torch.renderer import Renderer  # noqa: E402
from lens_flare_tpu_torch.scene.build import LT_AREA, LT_DIRECTIONAL, LT_POINT, LT_SPOT, load_scene  # noqa: E402
from lens_flare_tpu_torch.scene.collada import load_dae  # noqa: E402
from lens_flare_tpu_torch.utils.image import to_color  # noqa: E402
from test_torch_compiled import cpu_capture  # noqa: E402, F401  (the card's stand-in)

CONFIG = json.loads((BENCH / "configs" / "config1_cornell_spheres.json").read_text())
SEEDS = (2**33 + 5, 2**32 + 11)  # boxes whose 48 x 32 view shows both spheres
PARTS = {5: "block", 6: "emitter", 7: "mirror sphere", 8: "glass sphere"}  # material rows
PIXELS_OFF_ON_CARD = 1e-3  # share of the frame's pixels off on the card


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: tier-1 runs six test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def renderer(tmp_path, seed, device, width=48, height=32, ns=4, tile=1024):
    """The cell's scene under ``seed``, written and loaded as the command line loads it."""
    scene = cornell_scene.make(CONFIG["scene"], seed)
    r = Renderer(width=width, height=height, device=device, seed=seed % 2**32,
                 **dict(CONFIG["render"], tile_pixels=tile, ns_aa=ns))
    r.load(cornell_scene.write(scene, tmp_path))
    return scene, r


def against_reference(scene, r, hdr):
    """(compare's numbers at every pixel, the material rows the camera rays hit) of a rendered frame."""
    w, h, dev = r.width, r.height, hdr.device
    ys, xs = np.mgrid[0:h, 0:w]
    px, py = torch.as_tensor(xs.ravel(), device=dev), torch.as_tensor(ys.ravel(), device=dev)
    ref = CornellReference(scene, dict(CONFIG["render"], seed=r.seed), dev)
    cam = ref.camera(sky_scene.home_camera(scene, w, h).params())
    want = ref.still(cam, px, py, w, h, r.ns_aa)
    numbers = compare.frame_numbers(
        {"hdr": hdr[py, px], "u8": to_8bit(to_color(hdr.cpu().numpy()))[ys.ravel(), xs.ravel()]},
        {"hdr": want, "u8": to_8bit(ref_to_color(want.cpu().numpy()))},
    )
    return numbers, set(ref.first_hits_all(cam, px, py, w, h, r.ns_aa).tolist())


# ---------------------------------------------------------------------------
# the benchmark's writer, read back by the port's reader
# ---------------------------------------------------------------------------


def test_dae_writer_reads_back(tmp_path):
    scene = cornell_scene.make(CONFIG["scene"], SEEDS[0])
    dae = cornell_scene.write(scene, tmp_path)
    flat, _ = load_scene(dae)
    assert len(flat.tri_p) == 22 and flat.num_spheres == 2
    for name in ("tri_p", "tri_n", "tri_bsdf", "sph_center", "sph_radius", "sph_bsdf"):
        assert np.array_equal(getattr(flat, name), getattr(scene, name)), name
    assert flat.bsdfs.bsdf_type.tolist() == [0, 0, 0, 0, 0, 3, 1, 2, 5]
    assert flat.bsdfs.ior[8] == np.float32(1.5) and np.array_equal(flat.bsdfs.radiance[6], np.float32([5.0, 4.6, 4.0]))
    lt = flat.lights
    assert lt.light_type.tolist() == scene.light_type.tolist() == [LT_AREA, LT_SPOT, LT_POINT, LT_DIRECTIONAL]
    for mine, theirs in ((scene.light_radiance, lt.radiance), (scene.light_position, lt.position),
                         (scene.light_direction, lt.direction), (scene.light_dim_x, lt.dim_x),
                         (scene.light_dim_y, lt.dim_y), (scene.light_area, lt.area)):
        assert np.array_equal(mine, theirs)
    assert np.array_equal(lt.dim_x[1], np.array([np.cos(np.radians(40.0)), 2.0, 0.0], np.float32))  # the spot's cone
    assert np.array_equal(flat.bbox_min, scene.bbox_min) and np.array_equal(flat.bbox_max, scene.bbox_max)
    cam = load_dae(dae).camera
    assert (cam.h_fov, cam.v_fov, cam.n_clip, cam.f_clip) == (50.0, 40.0, 0.01, 100.0)
    assert np.array_equal(cam.transform, scene.camera["transform"])


def test_reference_imports_nothing_of_the_program():
    """The scene writer and the reference load neither the port, nor JAX, nor the JAX package."""
    import subprocess

    code = (f"import sys; sys.path[:0] = [{str(BENCH)!r}]\n"
            "from benchlib import cornell_ref, cornell_scene, brute_roofline\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'lens_flare_tpu', "
            "'lens_flare_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("seed", [1, 2**31 + 77, 2**40 + 3, 2**62 + 9])
def test_seeded_parts_stay_clear(seed):
    """The spheres rest on the floor inside the walls, clear of the block's footprint and each other."""
    cfg = CONFIG["scene"]
    turn, centres = cornell_scene.draw(cfg, seed)
    assert 0.0 <= turn < 90.0
    gap, (bx, _, bz) = cfg["clearance"], cfg["block"]["translate"]
    radii = [s["radius"] for s in cfg["spheres"]]
    for (x, y, z), r in zip(centres, radii):
        assert y == r and max(abs(x), abs(z)) <= 1.0 - r - gap
        assert np.hypot(x - bx, z - bz) >= cornell_scene.block_footprint(cfg) + r + gap
    (x0, _, z0), (x1, _, z1) = centres
    assert np.hypot(x0 - x1, z0 - z1) >= sum(radii) + gap
    assert cornell_scene.draw(cfg, seed) == (turn, centres)


# ---------------------------------------------------------------------------
# the frame against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_frame_matches_reference(tmp_path, seed):
    scene, r = renderer(tmp_path, seed, "cpu")
    hdr, counts = r.render(progress=False)
    assert bool((counts == 4).all())
    numbers, seen = against_reference(scene, r, hdr)
    assert set(PARTS) <= seen, [PARTS[k] for k in set(PARTS) - seen]
    assert numbers["hdr_off"][0] == 0 and numbers["ldr_off"][0] == 0, numbers


# ---------------------------------------------------------------------------
# the lanes handed to the trace kernels
# ---------------------------------------------------------------------------


def test_lanes_count_the_widths_handed(tmp_path, monkeypatch):
    """``KERNELS[k].lanes`` sums the widths the integrator hands each trace function: on this brute-mode
    scene A takes every closest-hit wavefront and C every shadow wavefront, two 1,024-lane tiles (the
    second padded) x 4 samples x 5 vertices, with 4 light slots a shadow wavefront."""
    _, r = renderer(tmp_path, SEEDS[0], "cpu")
    handed = {"closest": 0, "any": 0}
    real = tpath.walk_slots

    def walk(cs, o, d, t_lo, t_hi, any_hit=False, **kw):
        handed["any" if any_hit else "closest"] += o.shape[0]
        return real(cs, o, d, t_lo, t_hi, any_hit=any_hit, **kw)

    monkeypatch.setattr(tpath, "walk_slots", walk)
    ic.reset_launch_counts()
    r.render(progress=False)
    lanes = compiled.lane_counts()
    assert lanes["A"] == handed["closest"] == 2 * 1024 * 4 * 5
    assert lanes["C"] == handed["any"] == 4 * lanes["A"]
    assert all(n == 0 for k, n in lanes.items() if k not in "AC")
    assert all(k.launches == 0 for k in ic.KERNELS.values() if k.name != "shade_vertex_plain")  # the CPU launches none
    ic.reset_launch_counts()
    assert all(k.lanes == 0 and k.launches == 0 for k in ic.KERNELS.values())


def test_replayed_frame_counts_the_lanes_of_an_eager_one(tmp_path, cpu_capture):  # noqa: F811
    """Through the CPU stand-in of the captured programs, a replayed frame adds the lanes its capture
    recorded: as many as an eager frame hands over, and the same film."""
    _, r = renderer(tmp_path, SEEDS[1], "cpu", width=24, height=16, ns=2, tile=256)
    counts = []
    for eager in (True, False, False):
        ic.reset_launch_counts()
        if eager:
            with compiled.disabled():
                film, _ = r.render(progress=False)
        else:
            film, _ = r.render(progress=False)
        counts.append((compiled.lane_counts(), film))
    assert len(r._programs) == 2 and len(cpu_capture) == 2
    (eager_lanes, eager_film), (_, first), (replay_lanes, replay_film) = counts
    assert eager_lanes == replay_lanes and eager_lanes["A"] == 2 * 256 * 2 * 5
    assert torch.equal(eager_film, first) and torch.equal(eager_film, replay_film)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the trace kernels have no CPU mode there")
    return torch.device("cuda")


@pytest.mark.gpu
def test_frame_matches_reference_on_card(tmp_path, cuda_device):
    """The cell's frame at its own size on the card (256 x 256, 16 samples a pixel: kernels A and C),
    replayed, against the reference on the card at every pixel; a grazing ray that the kernels and the
    reference decide apart may change a pixel, so up to ``PIXELS_OFF_ON_CARD`` of them.  The same seed's
    frame rendered eagerly (``compiled.disabled()``) hands the kernels the same lanes and launches;
    whether its film equals the replayed one bit for bit is printed."""
    scene, r = renderer(tmp_path, SEEDS[0], "cuda", width=256, height=256, ns=16, tile=65536)
    r.render(progress=False)  # the warm-up frame captures the programs
    ic.reset_launch_counts()
    hdr, _ = r.render(progress=False)
    replayed = (compiled.lane_counts(), compiled.launch_counts())
    ic.reset_launch_counts()
    with compiled.disabled():
        eager, _ = r.render(progress=False)
    assert (compiled.lane_counts(), compiled.launch_counts()) == replayed
    assert replayed[1]["A"] == 16 * 5 and replayed[1]["C"] == 16 * 5 and replayed[0]["C"] == 4 * 16 * 5 * 65536
    numbers, seen = against_reference(scene, r, hdr)
    diff = (hdr != eager).any(dim=-1)
    print(f"[config1_on_card] {numbers} parts seen {sorted(seen)}; replayed film bit-equal to eager: "
          f"{not bool(diff.any())} ({int(diff.sum())} pixels differ, max abs {float((hdr - eager).abs().max())})")
    assert set(PARTS) <= seen
    for name in ("hdr_off", "ldr_off"):
        off, total = numbers[name]
        assert off <= PIXELS_OFF_ON_CARD * total, numbers
