"""Kernel I (``ops/csrc/shade.cu``) and the vertex loop of ``integrator/path.py``.

A sample is one loop over its path's vertices: the closest-hit walk, the
vertex's shading, the NEE rays' walk, the NEE gather.  On a CUDA device,
for scenes of any BSDF families, triangles and spheres under directional,
point, spot and area lights, kernel I shades each vertex
(``lf_shade_vertex``, ``lf_gather_vertex``); everything else runs the plain
vertex functions.  On the CPU:

- the route chooser: the terrain cells' scene and settings take the kernel on
  a CUDA device, in I-a's diffuse instance; config 3's BSDF families, every
  family, spot and area lights and spheres take it in the general instance;
  each thing the kernel does not do (the sky, also with a spot or an area
  light, ``-H``, hemisphere, sphere and mesh lights, a table that records a
  gradient, more slots than the kernel holds, the CPU) takes the plain route;
- the plain vertex loop against the JAX integrator on one tape, with padded
  lanes (t_hi = 0), camera misses and light samples of pdf 0 (an area light
  of infinite area), at the tolerances of ``tests/test_torch_integrator.py``;
- ``shade.cu`` itself, built by g++ behind a shim header (launches rewritten
  to loops over blocks and threads, ``__ldg`` a load), on CPU tensors through
  the kernel route's own wrappers, against the plain route: every frame of
  the tiled, adaptive, thin-lens bokeh, binary-BVH and single-vertex routes,
  and a 32x32 2-spp depth-5 frame of the Cornell box (mirror and glass
  spheres, a microfacet block, an emitter; area, spot, point and sun).
  Counts, rays, tests and skipped lanes are equal; the film agrees to a few
  float32 roundings, because PyTorch's CPU kernels divide by a Python number
  (``x / pi``) where its CUDA kernels, and so the kernel, multiply by the
  reciprocal, and its CPU ``sqrt``, ``sin``, ``exp``, ``log``, ``atan`` and
  ``pow`` are not glibc's.

On the card (``-m gpu``; the CPU cases are the same functions): the kernel
route against the plain route (``_takes_vertex_kernel`` patched to False),
bit for bit in film, counts, s1, s2 and stats, on a 65,536-lane tile of
terrain 512 (pinhole, depth 4), of terrain 256 with the thin lens and the
octagon bokeh (adaptive stages 4, 4, 8) and of the Cornell box at the
``cornell_256_16spp`` cell's size (256x256, 16 spp, depth 5), and on the
viewer's 800x600 frame; the route counters and ``KERNELS["I"]`` counting
what a frame ran.
"""

import contextlib
import ctypes
import dataclasses
import re
import shutil
import subprocess
import types

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from lens_flare_tpu.accel.wide import build_wide_bvh
    from lens_flare_tpu.integrator import path as jpath
    from lens_flare_tpu.renderer import Renderer as JaxRenderer
    from lens_flare_tpu.scene.procedural import make_terrain_scene as j_make_terrain_scene
except ImportError:  # the card's machine has no JAX: only the gpu cases run there
    jpath = None

from lens_flare_tpu_torch import _rng, compiled
from lens_flare_tpu_torch import bench_kernels as bk
from lens_flare_tpu_torch.convert import camera_params_from_numpy, cuda_scene_from_wide_bvh, scene_bundle_from_numpy
from lens_flare_tpu_torch.integrator import path
from lens_flare_tpu_torch.lens.aperture import ApertureTexture, polygon_mask
from lens_flare_tpu_torch.ops import _build
from lens_flare_tpu_torch.ops import intersect_cuda as ic
from lens_flare_tpu_torch.renderer import Renderer
from lens_flare_tpu_torch.scene.build import (
    LT_AREA, LT_DIRECTIONAL, LT_HEMISPHERE, LT_MESH, LT_POINT, LT_SPHERE, LT_SPOT,
)
from lens_flare_tpu_torch.scene.camera import camera_params, generate_rays
from lens_flare_tpu_torch.scene.collada import BSDF_DIFFUSE, BSDF_EMISSION, BSDF_GLASS, BSDF_MICROFACET
from lens_flare_tpu_torch.scene.procedural import make_terrain_scene
from lens_flare_tpu_torch.scene.writer import cornell_box

needs_jax = pytest.mark.skipif(jpath is None, reason="needs the JAX package (the reference)")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: tier-1 runs six test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cuda_lanes(n=4, requires_grad=False):
    """Stand-ins for a CUDA device's ray tensors: the chooser reads only their device and grad flag."""
    return types.SimpleNamespace(device=torch.device("cuda"), requires_grad=requires_grad, shape=(n, 3))


@pytest.fixture(scope="module")
def terrain():
    r = Renderer(device="cpu", width=16, height=12, seed=0, max_ray_depth=4)
    r.load_flat_scene(make_terrain_scene(8))
    return r


# ---------------------------------------------------------------------------
# the route chooser
# ---------------------------------------------------------------------------


def test_terrain_on_cuda_takes_the_kernel(terrain):
    s = terrain.settings
    assert s.bsdf_families == (BSDF_DIFFUSE,) and s.light_slot_types == (LT_DIRECTIONAL, LT_POINT)
    assert path._takes_vertex_kernel(terrain.bundle, s, _cuda_lanes(), _cuda_lanes())
    emissive = s._replace(bsdf_families=(BSDF_DIFFUSE, BSDF_EMISSION))
    assert path._takes_vertex_kernel(terrain.bundle, emissive, _cuda_lanes(), _cuda_lanes())
    with torch.no_grad():  # a gradient-requiring table records nothing without grad mode
        table = terrain.bundle.bsdfs.albedo.clone().requires_grad_(True)
        b = terrain.bundle._replace(bsdfs=terrain.bundle.bsdfs._replace(albedo=table))
        assert path._takes_vertex_kernel(b, s, _cuda_lanes(), _cuda_lanes())


def _case(case, terrain):
    """The terrain's (bundle, settings, lanes) changed as ``case`` names."""
    b, s = terrain.bundle, terrain.settings
    lanes = _cuda_lanes(requires_grad=case == "grad_rays")
    many = (0,) * (path.VERTEX_MAX_SLOTS + 1)
    sky = case == "sky" or case.endswith("_with_sky")
    case = case.removesuffix("_with_sky")
    if sky:
        b = b._replace(env=object())
    if case == "config3_families":
        s = s._replace(bsdf_families=(BSDF_DIFFUSE, BSDF_MICROFACET, BSDF_GLASS))
    elif case == "every_family":
        s = s._replace(bsdf_families=None)
    elif case in ("area_light", "spot_light", "hemisphere_light", "sphere_light", "mesh_light"):
        code = {"area_light": LT_AREA, "spot_light": LT_SPOT, "hemisphere_light": LT_HEMISPHERE,
                "sphere_light": LT_SPHERE, "mesh_light": LT_MESH}[case]
        s = s._replace(light_slot_types=(LT_DIRECTIONAL, code))
    elif case == "hemisphere_H":
        s = s._replace(direct_hemisphere_sample=True)
    elif case == "grad_table":
        b = b._replace(lights=b.lights._replace(radiance=b.lights.radiance.clone().requires_grad_(True)))
    elif case == "spheres":
        b = b._replace(scene=b.scene._replace(sph_center=torch.zeros((1, 3)), sph_radius=torch.ones(1),
                                              sph_bsdf=torch.zeros(1, dtype=torch.int32)))
    elif case == "too_many_slots":
        s = s._replace(light_slots=many, light_slot_types=(LT_DIRECTIONAL,) * len(many))
    return b, s, lanes


@pytest.mark.parametrize("case", ["config3_families", "every_family", "area_light", "spot_light", "spheres"])
def test_what_the_general_kernel_does_takes_the_kernel(case, terrain):
    """Every BSDF family, spot and area slots and spheres take kernel I, in I-a's general instance; the
    terrain's diffuse scene under sun and point lights takes the instance that holds none of them."""
    b, s, lanes = _case(case, terrain)
    assert path._takes_vertex_kernel(b, s, lanes, lanes)
    assert path._general_vertex_kernel(b, s) and not path._general_vertex_kernel(terrain.bundle, terrain.settings)


PLAIN_CASES = ("sky", "hemisphere_H", "grad_table", "grad_rays", "too_many_slots", "spot_light_with_sky",
               "area_light_with_sky", "hemisphere_light", "sphere_light", "mesh_light")


@pytest.mark.parametrize("case", PLAIN_CASES)
def test_what_the_kernel_does_not_do_takes_the_plain_route(case, terrain):
    b, s, lanes = _case(case, terrain)
    assert not path._takes_vertex_kernel(b, s, lanes, lanes)


def test_the_cpu_takes_the_plain_route(terrain):
    ic.reset_launch_counts()
    terrain.render(progress=False)
    # 192 pixels in one tile, one sample, four vertices
    assert path.vertex_routes() == {"kernel": 0, "plain": 4} and ic.KERNELS["I"].launches == 0


# ---------------------------------------------------------------------------
# the plain vertex loop against the JAX integrator
# ---------------------------------------------------------------------------

W, H = 32, 24


def _close(got, want, atol=1e-4, rtol=1e-4, frac=0.99):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    ok = np.abs(got - want) <= atol + rtol * np.abs(want)
    ok = ok.reshape(len(ok), -1).all(axis=1)
    assert ok.mean() >= frac, f"{ok.mean():.4f} of lanes within tolerance"
    rel = np.abs(got - want).sum() / max(np.abs(want).sum(), 1e-30)
    assert rel < 1e-3, rel


def _with_null_area_light(scene):
    """The scene with an area light of infinite area appended: every sample of it has pdf 0."""
    lt = scene.lights
    extra = dict(light_type=LT_AREA, radiance=(5.0, 5.0, 5.0), position=(0.0, 0.0, 3.0), direction=(0.0, 0.0, -1.0),
                 dim_x=(1.0, 0.0, 0.0), dim_y=(0.0, 1.0, 0.0), area=np.inf, is_delta=False)
    rows = {f: np.concatenate([np.asarray(getattr(lt, f)), np.asarray([v], np.asarray(getattr(lt, f)).dtype)])
            for f, v in extra.items()}
    return dataclasses.replace(scene, lights=dataclasses.replace(lt, **rows))


@needs_jax
def test_plain_vertex_loop_matches_jax():
    """One depth-4 sample of terrain 16 through the vertex loop against the JAX radiance_sample on the same
    tape: the orbit's view, whose corners miss the terrain; every third lane padded (valid False: t_hi = 0,
    nothing counted); the sun, the fill light and an area light whose samples all have pdf 0."""
    scene = _with_null_area_light(j_make_terrain_scene(16))
    jr = JaxRenderer(use_pallas=False, width=W, height=H, ns_aa=1, max_ray_depth=4, ns_area_light=1, seed=0)
    jr.load_flat_scene(scene)
    cs = cuda_scene_from_wide_bvh(build_wide_bvh(scene.tri_p), scene.sph_center, scene.sph_radius,
                                  scene.num_triangles)
    bundle = scene_bundle_from_numpy(jr.bundle.scene, jr.bundle.bsdfs, jr.bundle.lights, cs)
    settings = path.make_settings(scene.lights, bsdf_table=scene.bsdfs, max_ray_depth=4, ns_area_light=1)
    assert settings.light_slot_types == (LT_DIRECTIONAL, LT_POINT, LT_AREA)
    cam = camera_params_from_numpy(jr.camera.params())
    i = np.arange(W * H)
    px, py = (i % W).astype(np.int32), (i // W).astype(np.int32)
    valid = i % 3 != 0
    jk = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(jax.random.PRNGKey(0), (py * W + px).astype(np.uint32))
    jk = jax.vmap(jax.random.fold_in, in_axes=(0, None))(jk, np.uint32(3))
    tk = _rng.fold_in(path.pixel_keys(_rng.prng_key(0), torch.as_tensor(px), torch.as_tensor(py), W), 3)

    # the camera rays of that tape miss the terrain at some real lanes
    tape = _rng.uniform(tk, (path.tape_size(settings),))
    o, d = generate_rays(cam, (torch.as_tensor(px) + tape[:, 0]) / W, (torch.as_tensor(py) + tape[:, 1]) / H)
    hit, _ = path.trace_closest(bundle, o.contiguous(), d.contiguous(), cam.n_clip.expand(W * H).contiguous(),
                                cam.f_clip.expand(W * H).contiguous(), coherent=True)
    assert (~hit.hit.numpy() & valid).sum() > 20 and (hit.hit.numpy() & valid).sum() > 200

    ic.reset_launch_counts()
    L, st = path.radiance_sample(bundle, settings, cam, tk, torch.as_tensor(px), torch.as_tensor(py), W, H,
                                 valid=torch.as_tensor(valid))
    assert path.vertex_routes() == {"kernel": 0, "plain": 4}
    jL, jst = jpath.radiance_sample(jr.bundle, jr.settings, jr.camera.params(), jk, jnp.asarray(px),
                                    jnp.asarray(py), W, H, valid=jnp.asarray(valid))
    _close(L.numpy()[valid], np.asarray(jL)[valid])
    np.testing.assert_allclose(st.numpy()[[0, 2]], np.asarray(jst)[[0, 2]], rtol=5e-3)
    assert st[2] > 0


# ---------------------------------------------------------------------------
# shade.cu built for the CPU, against the plain route
# ---------------------------------------------------------------------------

SHIM = r"""
#include <cstdint>
#include <cstring>
#include <math.h>
#define __global__
#define __device__
#define __forceinline__ inline
#define __restrict__
template <typename T> static inline T __ldg(const T* p) { return *p; }
struct LfDim { unsigned int x; };
static LfDim blockIdx, threadIdx;
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
static inline cudaError_t cudaGetLastError() { return cudaSuccess; }
#define LF_CPU_LAUNCH(grid, threads, kernel) \
  for (blockIdx.x = 0; blockIdx.x < (unsigned)(grid); ++blockIdx.x) \
    for (threadIdx.x = 0; threadIdx.x < (unsigned)(threads); ++threadIdx.x) kernel
"""


@pytest.fixture(scope="module")
def shade_library(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build csrc/shade.cu for the CPU")
    src = (_build.CSRC_DIR / "shade.cu").read_text().replace("#include <cuda_runtime.h>", SHIM)
    src, launches = re.subn(r"(\w+)<<<(\w+), (\w+), 0, [^>]*>>>\(", r"LF_CPU_LAUNCH(\2, \3, \1)(", src)
    assert launches == 2, "both launches of shade.cu are rewritten"
    d = tmp_path_factory.mktemp("shade_cpu")
    (d / "shade_cpu.cpp").write_text(src)
    so = d / "libshade_cpu.so"
    res = subprocess.run([gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC", "-o", str(so),
                          str(d / "shade_cpu.cpp")], capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    lib = ctypes.CDLL(str(so))
    for name in ("lf_shade_vertex", "lf_gather_vertex"):
        getattr(lib, name).argtypes = _build.SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    return lib


@pytest.fixture
def route(shade_library, monkeypatch):
    """``route(kernel)`` sets the vertex route of CPU lanes: kernel I's source built for the CPU, or plain."""
    monkeypatch.setattr(_build, "load_library", lambda: shade_library)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: types.SimpleNamespace(cuda_stream=None))
    return lambda kernel: monkeypatch.setattr(path, "_takes_vertex_kernel", lambda b, s, o, d: kernel)


FRAMES = {
    "terrain8_A_C": dict(scene=8),
    "terrain40_D_B_adaptive": dict(scene=40, ns_aa=8, samples_per_batch=2),
    "terrain40_G": dict(scene=40, use_wide_tree=False),
    "terrain40_bokeh_adaptive": dict(scene=40, bokeh=True, ns_aa=8, samples_per_batch=2),
    "terrain40_depth1": dict(scene=40, max_ray_depth=1),
    # config 1's scene (scene/writer.py:cornell_box with its default lights and spheres: mirror, glass,
    # microfacet and emission; area, spot, point and sun): I-a's general instance
    "cornell_32_2spp": dict(scene="cornell", width=32, height=32, ns_aa=2, max_ray_depth=5),
}


def frame_renderer(case, device, tmp_path, width=None, height=None, tile=1024):
    """The case's renderer: its film is ``width`` x ``height`` if given, else the case's, else 64 x 48."""
    kw = {"width": 64, "height": 48, **FRAMES[case]}
    scene = kw.pop("scene")
    if kw.pop("bokeh", False):
        kw.update(lens_radius=0.05, focal_distance=1.5, bokeh=ApertureTexture.from_array(polygon_mask(32, 8)))
    kw.setdefault("max_ray_depth", 4)
    kw.update({k: v for k, v in (("width", width), ("height", height)) if v is not None})
    r = Renderer(device=device, seed=0, tile_pixels=tile, **kw)
    if scene == "cornell":
        r.load(cornell_box().write(tmp_path / "cornell.dae"))
    else:
        r.load_flat_scene(make_terrain_scene(scene))
    return r


def _frame(r):
    ic.reset_launch_counts()
    hdr, counts = r.render(progress=False)
    st = r.stats
    return hdr, counts, (st.total_rays, st.total_isects, st.total_zero_skipped), path.vertex_routes(), \
        ic.KERNELS["I"].launches


@pytest.mark.parametrize("case", list(FRAMES))
def test_kernel_source_equals_plain_on_the_cpu(case, route, tmp_path):
    r = frame_renderer(case, "cpu", tmp_path)
    route(True)
    got = _frame(r)
    route(False)
    want = _frame(r)
    assert got[3]["plain"] == 0 and got[3]["kernel"] == want[3]["plain"] > 0
    assert got[4] == 2 * got[3]["kernel"] and want[4] == 0  # I-a and I-b per vertex
    assert torch.equal(got[1], want[1]) and got[2] == want[2], (got[2], want[2])
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=2e-6, atol=1e-7)


VERTEX_OUTPUTS = {
    0: ("L0", "L", "throughput", "alive", "camera_hit", "shadow_o", "shadow_d", "shadow_t_lo", "shadow_t_hi",
        "contrib", "bounce_o", "bounce_d", "bounce_t_lo", "bounce_t_hi", "point", "bounce", "step",
        "L0_gathered", "L_gathered", "stats"),
}
VERTEX_OUTPUTS[1] = VERTEX_OUTPUTS[0]
EXACT_OUTPUTS = ("alive", "camera_hit", "bounce", "shadow_t_lo", "bounce_t_lo", "stats")


@pytest.mark.parametrize("case", ["terrain40_D_B_adaptive", "terrain40_G", "terrain40_bokeh_adaptive",
                                  "cornell_32_2spp"])
def test_vertex_errors_compare_every_output_on_the_cpu(case, route, tmp_path):
    """``bench_kernels.vertex_errors``, the card's check of kernel I on vertices 0 and 1, through the CPU
    build: it names every output of I-a and I-b, finds the flags, counts and stats equal and the floats
    within a few roundings (the CPU's ``x / pi`` and ``sin``, see above), and sees a bounce direction that
    one lane of the kernel's output gets wrong."""
    # the Cornell box on a 128 x 128 film: its 16,384 lanes meet the glass sphere often enough that a wrong
    # Schlick term turns some coins
    side = 128 if case.startswith("cornell") else None
    r = frame_renderer(case, "cpu", tmp_path, width=side, height=side)
    tape, ray = bk.vertex_wavefront(r, r.width * r.height if side else 1024, blocked=True)
    errs = bk.vertex_errors(r.bundle, r.settings, tape, ray)
    assert sorted(errs) == sorted(f"v{k}.{name}" for k, names in VERTEX_OUTPUTS.items() for name in names)
    # a bounce that misses puts the next vertex 1e30 away: its shadow rays trace nothing, and one rounding
    # of their origin is ~1e23
    far = {"v1.shadow_o": 1e30}
    for name, e in errs.items():
        assert e == 0.0 if name.split(".")[1] in EXACT_OUTPUTS else e <= 1e-5 * far.get(name, 1.0), (name, e)

    shade = path._shade_kernel

    def wrong_lane(*args):
        kpath, nee, ray = shade(*args)
        if ray is not None:
            ray[1][7, 0] += 1e-3
        return kpath, nee, ray

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(path, "_shade_kernel", wrong_lane)
        errs = bk.vertex_errors(r.bundle, r.settings, tape, ray)
    assert errs["v0.bounce_d"] >= 1e-3 - 1e-6 and errs["v1.bounce_d"] >= 1e-3 - 1e-6


def test_kernel_wrappers_refuse_what_the_kernel_cannot_read(route, terrain):
    route(True)
    s = terrain.settings
    ray = tuple(x.contiguous() for x in (torch.zeros((4, 3)), torch.ones((4, 3)), torch.zeros(4), torch.ones(4)))
    tape = torch.zeros((4, path.tape_size(s)))
    walk = path._walk_closest(terrain.bundle, *ray)
    with pytest.raises(ValueError, match="tape"):
        path._shade_kernel(terrain.bundle, s, tape[:, :3].contiguous(), 0, 4, walk, ray, None, None)
    with pytest.raises(ValueError, match="valid"):
        path._shade_kernel(terrain.bundle, s, tape, 0, 4, walk, ray, None, torch.ones(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="light slots"):
        path._shade_kernel(terrain.bundle, s._replace(light_slots=(0, 7)), tape, 0, 4, walk, ray, None, None)
    with pytest.raises(ValueError, match="light slot types"):
        hemi = s._replace(light_slot_types=(LT_DIRECTIONAL, LT_HEMISPHERE))
        path._shade_kernel(terrain.bundle, hemi, tape, 0, 4, walk, ray, None, None)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernel I has no CPU mode")
    return torch.device("cuda")


def _tile_sums(r, n_samples, kernel, monkeypatch):
    """render_batch over the renderer's 256x256 film, one 65,536-lane tile: (film, s1, s2, stats), eagerly."""
    monkeypatch.setattr(path, "_takes_vertex_kernel", lambda b, s, o, d: kernel)
    ys, xs = np.divmod(np.arange(r.width * r.height), r.width)
    px, py = (torch.as_tensor(a, device=r.device) for a in (xs, ys))
    key = _rng.prng_key(2_147_483_659, device=r.device)
    with compiled.disabled():
        out = path.render_batch(r.bundle, r.settings, camera_params(r.camera, r.device), px, py, r.width,
                                r.height, key, 0, n_samples)
    torch.cuda.synchronize()
    return out


def _same_bits(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(torch.int32) if a.dtype == torch.float32 else a, b.view(torch.int32) if b.dtype == torch.float32 else b)


CARD_TILES = {
    # terrain 512 (the orbit's scene: a stream tree, kernel A, then B), pinhole, depth 4
    "terrain512_pinhole": lambda dev, tmp: _card_renderer(512, dev),
    # terrain 256 (config 2's scene: kernels D and B), thin lens, octagon bokeh
    "terrain256_bokeh": lambda dev, tmp: _card_renderer(256, dev, bokeh=True),
    # the cornell_256_16spp cell's size: the Cornell box (kernels A and C; I-a's general instance), 16 spp,
    # depth 5
    "cornell_256_16spp": lambda dev, tmp: _card_cornell(dev, tmp),
}


def _card_cornell(dev, tmp_path):
    r = Renderer(device=dev, width=256, height=256, ns_aa=16, max_ray_depth=5, ns_area_light=1, indirect=True,
                 seed=0, tile_pixels=65_536)
    r.load(cornell_box().write(tmp_path / "cornell.dae"))
    return r


def _card_renderer(nq, dev, bokeh=False):
    kw = dict(width=256, height=256, ns_aa=16, max_ray_depth=4, ns_area_light=1, indirect=True, seed=0,
              tile_pixels=65_536)
    scene = make_terrain_scene(nq)
    if bokeh:
        kw.update(samples_per_batch=4, max_tolerance=0.05,
                  lens_radius=0.01 * float(np.linalg.norm(scene.bbox_max - scene.bbox_min)),
                  bokeh=ApertureTexture.from_array(polygon_mask(500, 8)))
    r = Renderer(device=dev, **kw)
    r.load_flat_scene(scene)
    if bokeh:
        r.autofocus(r.width / 2, r.height / 2)
    return r


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CARD_TILES))
def test_kernel_equals_plain_on_card(case, cuda_device, monkeypatch, tmp_path):
    """A 65,536-lane tile, 4 samples through render_batch, and the whole 256x256 frame (one tile: the
    bokeh case's adaptive stages 4, 4, 8; the Cornell box's 16 samples summed), both eagerly, by the kernel
    and by the plain route."""
    r = CARD_TILES[case](cuda_device, tmp_path)
    got = _tile_sums(r, 4, True, monkeypatch)
    want = _tile_sums(r, 4, False, monkeypatch)
    for a, b in zip(got, want):
        assert _same_bits(a, b), case
    frames = {}
    for kernel in (True, False):
        monkeypatch.setattr(path, "_takes_vertex_kernel", lambda b, s, o, d, k=kernel: k)
        with compiled.disabled():
            frames[kernel] = _frame(r)
    (g, w) = frames[True], frames[False]
    assert _same_bits(g[0], w[0]) and torch.equal(g[1], w[1]) and g[2] == w[2], case
    assert g[3]["kernel"] > 0 and g[3]["plain"] == 0 and w[3]["kernel"] == 0


@pytest.mark.gpu
def test_viewer_frame_equals_plain_on_card(cuda_device, monkeypatch):
    """The viewer's 800x600 RENDER frames (one sample each) by both routes, bit for bit."""
    from lens_flare_tpu_torch.app import Application

    frames = {}
    for kernel in (True, False):
        monkeypatch.setattr(path, "_takes_vertex_kernel", lambda b, s, o, d, k=kernel: k)
        r = Renderer(device=cuda_device, width=800, height=600, ns_aa=16, max_ray_depth=4, ns_area_light=1,
                     indirect=True, seed=0)
        r.load_flat_scene(make_terrain_scene(64))
        app = Application(r, progressive_batch=1)
        app.keyboard_event("r")
        frames[kernel] = [app.frame() for _ in range(3)]
    for a, b in zip(frames[True], frames[False]):
        assert np.array_equal(a, b)


@pytest.mark.gpu
def test_route_counters_count_what_a_frame_ran_on_card(cuda_device):
    """A replayed 4-sample frame in two tiles at depth 4: 32 vertex wavefronts by the kernel, each an I-a
    and an I-b launch (the routes of the sky, -H and the Cornell box: ``test_torch_compiled.py``)."""
    r = Renderer(device=cuda_device, width=16, height=12, tile_pixels=128, ns_aa=4, max_ray_depth=4, seed=0)
    r.load_flat_scene(make_terrain_scene(8))
    r.render(progress=False)  # captures
    got = _frame(r)
    assert got[3] == {"kernel": 2 * 4 * 4, "plain": 0} and got[4] == 2 * 2 * 4 * 4
