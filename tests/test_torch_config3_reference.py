"""BASELINE config 3 in the port against the benchmark's plain reference (``benchmark/benchlib/sky_ref.py``,
``realistic_ref.py``), on the CPU at a small size, and once on the card.

The scene is the ``realistic_1080p`` cell's, shrunk: terrain 8 (128
triangles, four BSDF quadrants) written by the benchmark's own COLLADA
writer, a 64 x 32 sky with its bright disk written by the benchmark's own
EXR writer (HALF, ZIP), a 48 x 32 film, depth 4.  The program reads both
files as the command line does (``exr.read``, ``Renderer.load``).

Tolerances and why:

- the writers: the port's readers give back the arrays written exactly:
  9 significant digits parse back to the same float32, and a HALF texel
  widens to float32 exactly;
- the frame, rendered through ``Renderer.render`` and ``composite_flare``
  (the cell's run of the whole harness is the benchmark's own test): every
  pixel within ``compare.REL`` (1e-4 of its largest channel), the per-pixel
  rule behind the cell's ``hdr_off``, and the 8-bit levels equal; the
  reference runs the same equations on the same threefry tape, so only
  float32 rounding may differ, ~1e-7 of a pixel.  The pixels show all four
  materials and the sky;
- the flare: the L1 of the difference over the L1 of the reference's flare
  within ``FLARE_TOL``; the program sums the ghost taps in float32 in a
  fixed order, the reference in float64 (~1e-12 read);
- the ghost buffer alone at 64 x 48, for three suns, and the frame's own:
  its relative L1 within ``GHOST_TOL``, where float32 against float64 sums
  read ~1e-8 and TF32 products (the cell's control) ~4e-2;
- ``sample_env``: the texel picked, its radiance, direction and pdf equal
  lane for lane to the reference's count-based inversion (JAX's plain
  count of ``cdf <= u``; the program halves the row), on uniforms that
  include 0, values equal to CDF entries (ties) and values near 1.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parent.parent / "benchmark"
sys.path[:0] = [str(BENCH)]

from benchlib import compare, realistic_ref, sky_scene  # noqa: E402
from benchlib.reference import to_8bit  # noqa: E402
from benchlib.reference import to_color as ref_to_color  # noqa: E402
from benchlib.scene import mask  # noqa: E402
from benchlib.sky_ref import Materials, Sky, SkyReference  # noqa: E402

from lens_flare_tpu_torch.flare.pipeline import FlarePipeline  # noqa: E402
from lens_flare_tpu_torch.integrator import envlight  # noqa: E402
from lens_flare_tpu_torch.lens.aperture import ApertureTexture  # noqa: E402
from lens_flare_tpu_torch.lens.prescription import reference_prescription  # noqa: E402
from lens_flare_tpu_torch.renderer import Renderer  # noqa: E402
from lens_flare_tpu_torch.scene.build import load_scene  # noqa: E402
from lens_flare_tpu_torch.scene.collada import load_dae  # noqa: E402
from lens_flare_tpu_torch.utils import exr  # noqa: E402
from lens_flare_tpu_torch.utils.image import to_color  # noqa: E402

CONFIG = json.loads((BENCH / "configs" / "config3_sky_realistic.json").read_text())
SEED = 2**31 + 91
FLARE_TOL = 1e-6  # relative L1 of the flare: float32 against float64 tap sums read ~1e-12
GHOST_TOL = 1e-6  # relative L1 of the ghost buffer: ~1e-8 read; TF32 products read ~4e-2
PIXELS_OFF_ON_CARD = 1e-3  # share of a frame's pixels off on the card, a fifth of the cell's hdr_off limit


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: tier-1 runs six test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_scene(seed=SEED, n_quads=8):
    """Config 3's scene at terrain ``n_quads`` under a 64 x 32 sky, made from ``seed``."""
    return sky_scene.make(dict(CONFIG["scene"], n_quads=n_quads), dict(CONFIG["sky"], width=64, height=32), seed)


# ---------------------------------------------------------------------------
# the benchmark's own writers, read back by the port's readers
# ---------------------------------------------------------------------------


def test_dae_writer_reads_back(tmp_path):
    scene = small_scene()
    dae, _ = sky_scene.write(scene, tmp_path)
    flat, info = load_scene(dae)
    assert np.array_equal(flat.tri_p, scene.tri_p) and np.array_equal(flat.tri_n, scene.tri_n)
    assert np.array_equal(flat.tri_bsdf, scene.tri_bsdf)
    mats = Materials(scene.materials, "cpu")
    assert flat.bsdfs.bsdf_type.tolist() == mats.kind.tolist() == [0, 3, 2, 5]
    for name in ("albedo", "reflectance", "transmittance", "eta", "k", "alpha", "ior"):
        assert np.array_equal(getattr(flat.bsdfs, name), getattr(mats, name).numpy()), name
    lt = flat.lights
    assert lt.light_type.tolist() == scene.light_type.tolist() == [1, 3]
    for mine, theirs in ((scene.light_radiance, lt.radiance), (scene.light_position, lt.position),
                         (scene.light_direction, lt.direction), (scene.light_dim_x, lt.dim_x),
                         (scene.light_dim_y, lt.dim_y), (scene.light_area, lt.area)):
        assert np.array_equal(mine, theirs)
    assert np.array_equal(flat.bbox_min, scene.bbox_min) and np.array_equal(flat.bbox_max, scene.bbox_max)
    cam = load_dae(dae).camera
    assert (cam.h_fov, cam.v_fov, cam.n_clip, cam.f_clip) == (35.0, 20.0, 0.01, 1000.0)
    assert np.array_equal(cam.transform, scene.camera["transform"])


@pytest.mark.parametrize("kind", ["smooth", "noise"])
def test_exr_writer_reads_back(tmp_path, kind):
    """HALF texels, ZIP blocks that shrink (a smooth map) and blocks stored raw (noise, which deflate
    cannot shrink), read back by the port's reader."""
    from benchlib import exr_writer

    rng = np.random.default_rng(3)
    if kind == "smooth":
        img = small_scene().sky
    else:
        img = (rng.random((37, 53, 3)) * rng.choice([1e-3, 1.0, 6e4], size=(37, 53, 1))).astype(np.float32)
    exr_writer.write(tmp_path / "a.exr", img)
    assert np.array_equal(exr.read(tmp_path / "a.exr"), img.astype(np.float16).astype(np.float32))


# ---------------------------------------------------------------------------
# the frame and the flare against the reference
# ---------------------------------------------------------------------------


def rel_l1(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).abs().sum() / want.abs().sum())


def frames_against_reference(tmp_path, device, n_quads, width, height, thetas=(0.0, 0.3)):
    """Config 3's frames, shrunk, through the command line's path (``exr.read``, ``Renderer.load`` of the
    written files, ``render``, ``composite_flare``), each at the file camera's theta plus one of ``thetas``
    and a render seed of its own, against the reference at every pixel: per frame, the numbers
    ``compare`` gives (the flare read as composite minus film), the ghost buffer's relative L1, and the
    materials the camera rays hit (-1: the sky)."""
    scene = small_scene(n_quads=n_quads)
    dae, sky = sky_scene.write(scene, tmp_path)
    f = CONFIG["flare"]
    settings = dict(CONFIG["render"], tile_pixels=1024, ns_aa=1)
    r = Renderer(width=width, height=height, device=device, envmap=exr.read(sky), lens_model=f["lens_model"],
                 aperture=ApertureTexture.from_array(mask(f["aperture_mask"])),
                 flare_intensity=f["flare_intensity"], flare_radius=f["flare_radius"], **settings)
    r.load(dae)
    assert r.env_builds == 1
    theta0 = r.camera.theta
    ys, xs = np.mgrid[0:height, 0:width]
    px = torch.as_tensor(xs.ravel(), device=device)
    py = torch.as_tensor(ys.ravel(), device=device)
    out = []
    for k, dtheta in enumerate(thetas):
        seed = SEED + 1000 * k
        r.seed = seed
        r.camera.theta = theta0 + dtheta
        r.camera.compute_position()
        hdr, _ = r.render(progress=False)
        flared = r.composite_flare(hdr)
        ghosts = r.flare_pipeline().ghost_buffer()
        u8 = to_8bit(to_color(flared.cpu().numpy()))

        ref = SkyReference(scene, dict(settings, seed=seed), device)
        cam = sky_scene.home_camera(scene, width, height)
        assert abs(cam.theta - theta0) < 1e-6
        cam.theta = theta0 + dtheta
        cam.compute_position()
        x, y = cam.analyze_world_coord(scene.light_position[0])
        assert 0 <= x <= 1 and 0 <= y <= 1  # the sun on screen: the flare runs
        params = ref.camera(cam.params())
        want_hdr = ref.tiled(params, px, py, width, height)
        w_ghosts, burst, glow = realistic_ref.flare(scene, cam, mask(f["aperture_mask"]), width, height,
                                                    f["flare_intensity"], f["flare_radius"], seed, device)
        w_flared = ((want_hdr + w_ghosts[py, px]) + burst[py, px]) + glow[py, px]
        numbers = compare.frame_numbers(
            {"hdr": hdr[py, px], "u8": u8[ys.ravel(), xs.ravel()], "flare": flared - hdr},
            {"hdr": want_hdr, "u8": to_8bit(ref_to_color(w_flared.cpu().numpy())),
             "flare": (((hdr + w_ghosts) + burst) + glow) - hdr},
        )
        seen = set(ref.first_hits(params, px, py, width, height).tolist())
        out.append((numbers, rel_l1(ghosts, w_ghosts), seen))
    return out


def test_frame_matches_reference(tmp_path):
    frames = frames_against_reference(tmp_path, "cpu", 8, 48, 32)
    assert set().union(*(seen for _, _, seen in frames)) == {-1, 0, 1, 2, 3}
    for numbers, ghost_err, _ in frames:
        assert numbers["hdr_off"][0] == 0 and numbers["ldr_off"][0] == 0, numbers
        assert numbers["flare_err"][0] <= FLARE_TOL, numbers
        assert ghost_err <= GHOST_TOL, ghost_err


@pytest.mark.parametrize("axis", [(0.31, 0.62), (0.5, 0.55), (0.74, 0.28)])
def test_ghost_buffer_matches_reference(axis):
    w, h = 64, 48
    angle = float(np.arctan2(axis[1], axis[0]))
    radiance = np.array([1.3, 1.1, 0.65], np.float32)
    pipe = FlarePipeline(width=w, height=h, flare_origins=np.array([axis], np.float32),
                         flare_radiances=radiance[None], axis_ray=np.array(axis), angle_to_sun=angle,
                         lens=reference_prescription(), lens_model="realistic", device="cpu")
    got = pipe.ghost_buffer()
    want = realistic_ref.ghost_buffer(torch.tensor(angle, dtype=torch.float32), torch.as_tensor(radiance),
                                      torch.tensor(axis, dtype=torch.float32), w, h, "cpu")
    assert want.sum() > 0
    assert rel_l1(got, want) <= GHOST_TOL


def test_sample_env_texels_equal_count_inversion():
    scene = small_scene()
    program, ref = envlight.build_env(scene.sky), Sky(scene.sky, "cpu")
    rng = np.random.default_rng(7)
    u = torch.as_tensor(rng.random((20000, 2)).astype(np.float32))
    u[:64] = 0.0
    u[64:128, 1] = ref.marginal_y[rng.integers(0, 32, 64)]  # ties with the marginal CDF
    rows = rng.integers(0, 32, 64)
    u[128:192, 0] = ref.conds_y[rows, rng.integers(0, 64, 64)]  # ties with a conditional CDF
    u[192:256] = 1.0 - 2.0**-24
    got = envlight.sample_env(program, u)
    y, x = ref.texel(u)
    rad, wi, pdf = ref.sample(u)
    h, w = scene.sky.shape[:2]
    index_map = envlight.build_env(np.stack([np.arange(h * w, dtype=np.float32).reshape(h, w)] * 3, -1))
    index_map = index_map._replace(pdf_map=program.pdf_map, marginal_y=program.marginal_y, conds_y=program.conds_y)
    picked = envlight.sample_env(index_map, u).radiance[:, 0].long()
    assert torch.equal(picked, y * w + x)
    assert torch.equal(got.radiance, rad) and torch.equal(got.wi, wi) and torch.equal(got.pdf, pdf)
    assert torch.equal(ref.data, program.data) and torch.equal(ref.conds_y, program.conds_y)


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
    """The shrunk frames on the card (terrain 40: kernel D's multi-level tree), captured, against the
    reference on the card; a grazing ray that the kernel's walk and the reference's brute force decide
    apart may change a pixel, so up to ``PIXELS_OFF_ON_CARD`` of them (sound 1080p runs: 0 to 6.1e-5)."""
    frames = frames_against_reference(tmp_path, "cuda", 40, 96, 54)
    assert set().union(*(seen for _, _, seen in frames)) == {-1, 0, 1, 2, 3}
    for numbers, ghost_err, _ in frames:
        print(f"[config3_on_card] {numbers} ghost_err {ghost_err}")
        for name in ("hdr_off", "ldr_off"):
            off, total = numbers[name]
            assert off <= PIXELS_OFF_ON_CARD * total, numbers
        assert numbers["flare_err"][0] <= FLARE_TOL, numbers
        assert ghost_err <= GHOST_TOL, ghost_err
