"""The port's interactive Application against the JAX package's, driven headless by one script.

``lens_flare_tpu_torch.app.Application`` (``device="cpu"``) and
``lens_flare_tpu.app.Application`` get the same key and mouse events on the
Cornell box written by ``scene/writer.py:cornell_box()`` (every BSDF family
and light type), each on its own package's ``Renderer``.

Equal, exactly (the host code is a copy): the mode after each key, the
HUD ``info()``, the log, the renderer's knobs and settings, the camera's
state after orbit, pan, scroll, keyboard orbit and reset, the BVH walk of
the arrow keys, the cell a drag selects (the reference's ``screenH - y``
flip), the triangle arrays after each mesh-edit key, and the VISUALIZE
frame's wireframe (which pixels it draws, and their colours).

Within a tolerance, where the two packages trace rays (ROADMAP Queue 3
item 4: XLA:CPU contracts products into FMAs, the port rounds each):
- the EDIT preview: equal hit masks, colours within 1e-5, t within 1e-5
  relative; the VISUALIZE frame's dimmed preview likewise;
- the autofocus distance: 1e-5 relative;
- each progressive RENDER frame: ``test_torch_cli._close`` (>= 99% of
  pixels within 1e-4 absolute + 1e-4 relative, mean relative difference
  < 1e-3), counts equal;
- the finished progressive film against the port's own
  ``Renderer.render()``: rtol 1e-5, atol 1e-6, the limits of the JAX
  package's own test (``tests/test_app.py:96``).

The app's programs (the preview, and the keys and sample programs of a
RENDER frame) run through ``compiled.py``: on the CPU stand-in for the
card (``test_torch_compiled.cpu_capture``) and, marked ``gpu``, on the card,
the replayed frames equal ``compiled.disabled()`` frames bit for bit, an
orbit replays without a new capture, and a mesh edit drops the programs.
"""

import dataclasses

import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp

    from lens_flare_tpu import app as japp
    from lens_flare_tpu.integrator.path import trace_closest as j_trace_closest
    from lens_flare_tpu.scene.camera import generate_rays as j_generate_rays
    from lens_flare_tpu.renderer import Renderer as JaxRenderer

    from test_torch_cli import _close
    from test_torch_compiled import cpu_capture  # noqa: F401  (the CPU stand-in for the card's captures)
except ImportError:  # the card's machine: only the gpu cases can run
    japp = None

from lens_flare_tpu_torch import app as tapp
from lens_flare_tpu_torch import compiled
from lens_flare_tpu_torch.integrator.path import trace_closest
from lens_flare_tpu_torch.ops import intersect_cuda as ic
from lens_flare_tpu_torch.renderer import Renderer
from lens_flare_tpu_torch.scene.camera import camera_params, generate_rays
from lens_flare_tpu_torch.scene.writer import cornell_box

W, H = 48, 36
KW = dict(width=W, height=H, ns_aa=3, max_ray_depth=2, indirect=True, seed=0, tile_pixels=512)
needs_jax = pytest.mark.skipif(japp is None, reason="needs the JAX package (the reference)")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: tier-1 runs six test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cornell(tmp_path_factory):
    return cornell_box().write(tmp_path_factory.mktemp("app") / "cornell.dae")


def _port_app(cornell, device="cpu", use_wide_tree=None, **kw):
    r = Renderer(device=device, use_wide_tree=use_wide_tree, **{**KW, **kw})
    r.load(cornell)
    return tapp.Application(r, preview_width=W, progressive_batch=1)


def _pair(cornell, use_wide_tree=None, **kw):
    """(port app, JAX app) on the same file, knobs and frame size.

    ``use_wide_tree=False`` puts the port on the JAX package's own route,
    the binary BVH, whose walk breaks ties between triangles that share an
    edge as the JAX walk does; the default, the cluster tree, may pick the
    other triangle of such a tie.
    """
    j = JaxRenderer(use_pallas=False, **{**KW, **kw})
    j.load(cornell)
    return _port_app(cornell, use_wide_tree=use_wide_tree, **kw), \
        japp.Application(j, preview_width=W, progressive_batch=1)


def _event(app, ev):
    kind, *args = ev
    if kind == "key":
        app.keyboard_event(args[0])
    elif kind == "press":
        app.mouse_pressed(*args)
    elif kind == "release":
        app.mouse_released(*args)
    elif kind == "move":
        app.cursor_event(*args)
    elif kind == "scroll":
        app.scroll_event(*args)


def _same_camera(a, b):
    for f in ("pos", "target_pos", "c2w", "phi", "theta", "r", "min_r", "max_r", "lens_radius", "focal_distance"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)), err_msg=f)


def _same_state(mine, ref):
    assert mine.mode.name == ref.mode.name
    assert mine.info() == ref.info()
    assert mine.log == ref.log
    assert mine.selection_history == ref.selection_history
    assert (mine.show_rays, mine.render_cell) == (ref.show_rays, ref.render_cell)
    assert mine._cell_bounds() == ref._cell_bounds()
    r, j = mine.renderer, ref.renderer
    for k in ("ns_aa", "ns_area_light", "max_ray_depth", "direct_hemisphere_sample", "lens_radius",
              "focal_distance"):
        assert getattr(r, k) == getattr(j, k), k
    for k in r.settings._fields:
        assert getattr(r.settings, k) == getattr(j.settings, k), k
    _same_camera(r.camera, j.camera)


KEYS = ["r", "]", "[", "[", "[", "=", "-", "-", ">", "<", "h", "h", "l", "l", "k", "'", ";", "C", "C",
        "v", "LEFT", "RIGHT", "LEFT", "UP", "UP", "UP", "a", "q", "w", "q", " ", "e", "v", "r", "e", "v", "e"]


@needs_jax
def test_keys_modes_and_info_match_jax(cornell, tmp_path):
    mine, ref = _pair(cornell)
    mine.filename, ref.filename = str(tmp_path / "port"), str(tmp_path / "jax")
    _same_state(mine, ref)
    for key in KEYS + ["r"]:
        for app in (mine, ref):
            app.keyboard_event(key)
        _same_state(mine, ref)
    assert mine.mode == tapp.Mode.RENDER and len(mine.selection_history) == 1
    # 'd' in RENDER mode dumps the camera in the reference's text format (the log names the file)
    for app in (mine, ref):
        app.keyboard_event("d")
    assert mine.log[-1].replace("port_", "jax_") == ref.log[-1]
    assert (tmp_path / "port_cam_settings.txt").read_text() == (tmp_path / "jax_cam_settings.txt").read_text()


MOUSE = [
    ("press", tapp.LEFT, 10.0, 10.0), ("move", 20.0, 12.0), ("move", 31.0, 4.0), ("release", tapp.LEFT),
    ("press", tapp.RIGHT, 10.0, 10.0), ("move", 14.0, 10.0), ("move", 16.0, 21.0), ("release", tapp.RIGHT),
    ("scroll", 1.0), ("scroll", -2.5), ("key", "v"), ("key", "q"), ("key", "w"), ("key", "q"), ("scroll", 0.5),
    ("key", " "), ("key", "e"), ("press", tapp.LEFT, 1.0, 30.0), ("move", 40.0, 2.0), ("release", tapp.LEFT),
]


@needs_jax
def test_camera_moves_match_jax(cornell):
    """Left-drag orbit, right-drag pan, scroll dolly, keyboard orbit and the space-bar reset."""
    mine, ref = _pair(cornell)
    cam0 = dataclasses.replace(mine.renderer.camera)
    moved = False
    for ev in MOUSE:
        _event(mine, ev)
        _event(ref, ev)
        _same_state(mine, ref)
        moved |= not np.array_equal(mine.renderer.camera.pos, cam0.pos)
    assert moved
    assert mine.renderer.camera.theta != cam0.theta  # the last drag orbited after the reset


def _same_preview(mine, ref, tie_share=0.0):
    """Equal hit masks, t within 1e-5 relative on every hit, and colours within 1e-5 on all but
    0.2% of the pixels and within 1e-4 on all but ``tie_share`` of them.

    The 0.2%: pixels at a sphere's silhouette, where the quadratic's
    discriminant cancels and the two packages' rounding (ROADMAP Queue 3
    item 4) moves t by a few ulps and the normal by up to 4.7e-5 (2 of the
    1,728 pixels here).  ``tie_share``: a tie between two triangles at a
    shared edge, the same t and the other triangle's normal; each such pixel
    is checked to be one (``_only_ties``).
    """
    got, want = mine.frame(), ref.frame()
    assert got.shape == want.shape == (H, W, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(mine._preview_hit, ref._preview_hit)
    hit = mine._preview_hit
    assert hit.mean() > 0.2
    np.testing.assert_allclose(mine._preview_t[hit], ref._preview_t[hit], rtol=1e-5)
    _same_colours(got, want, tie_share)
    _only_ties(mine, ref, np.abs(got - want).max(axis=-1).ravel() > 1e-4)
    return got


def _ray_triangle(o, d, p):
    """(t, u, v) of the ray's plane crossing in triangle ``p``'s barycentrics, float64 (Moller-Trumbore)."""
    e1, e2 = p[1] - p[0], p[2] - p[0]
    q = np.cross(d, e2)
    det = e1 @ q
    s = o - p[0]
    r = np.cross(s, e1)
    return (e2 @ r) / det, (s @ q) / det, (d @ r) / det


def _only_ties(mine, ref, pixels):
    """The preview pixels in ``pixels`` are ties: each package hit another triangle, and the
    pixel's ray meets both triangles at the preview's t (on their shared edge)."""
    if not pixels.any():
        return
    pw, ph = mine._preview_res()
    x, y = mine.renderer.preview_lanes(pw, ph)
    n = x.shape[0]
    cam = camera_params(mine.renderer.camera, "cpu")
    o, d = generate_rays(cam, x, y)
    hit, _ = trace_closest(mine.renderer.bundle, o.contiguous(), d.contiguous(),
                           cam.n_clip.expand(n).contiguous(), cam.f_clip.expand(n).contiguous())
    j_cam = ref.renderer.camera.params()
    jo, jd = j_generate_rays(j_cam, jnp.asarray(x.numpy()), jnp.asarray(y.numpy()))
    j_hit, _ = j_trace_closest(ref.renderer.bundle, jo, jd, jnp.full(n, j_cam.n_clip), jnp.full(n, j_cam.f_clip))
    prim, j_prim = hit.prim.numpy(), np.asarray(j_hit.prim)
    tri = np.asarray(mine.renderer.scene.tri_p, np.float64)
    o, d, t = o.double().numpy(), d.double().numpy(), mine._preview_t.ravel()
    for i in np.flatnonzero(pixels):
        assert prim[i] != j_prim[i] and 0 <= min(prim[i], j_prim[i]) and max(prim[i], j_prim[i]) < len(tri), \
            (i, prim[i], j_prim[i])
        for k in (prim[i], j_prim[i]):
            tk, u, v = _ray_triangle(o[i], d[i], tri[k])
            assert abs(tk - t[i]) <= 1e-5 * t[i] and min(u, v, 1 - u - v) >= -1e-5, (i, k, tk, t[i], u, v)


def _same_colours(got, want, tie_share=0.0, scale=1.0):
    diff = np.abs(got - want).max(axis=-1)
    assert (diff > 1e-5 * scale).mean() <= 2e-3 + tie_share, np.argwhere(diff > 1e-5 * scale)
    assert (diff > 1e-4 * scale).mean() <= tie_share, np.argwhere(diff > 1e-4 * scale)


@needs_jax
@pytest.mark.parametrize("route", ["binary_bvh", "cluster_tree"])
def test_edit_preview_matches_jax(route, cornell):
    # the cluster tree's walk takes the other triangle of a tie on 2 of the 1,728 pixels, at the block's edges
    mine, ref = _pair(cornell, use_wide_tree=False if route == "binary_bvh" else None)
    tie_share = 0.0 if route == "binary_bvh" else 2e-3
    first = _same_preview(mine, ref, tie_share)
    assert mine.frame() is first  # cached until the camera moves
    for ev in MOUSE[:4]:  # an orbit
        _event(mine, ev)
        _event(ref, ev)
    assert not np.array_equal(_same_preview(mine, ref, tie_share), first)


@needs_jax
def test_visualize_frame_matches_jax(cornell):
    mine, ref = _pair(cornell, use_wide_tree=False)
    preview, j_preview = mine.frame(), ref.frame()
    for bvh_field in ("node_min", "node_max", "node_left", "node_right"):
        np.testing.assert_array_equal(getattr(mine._host_bvh(), bvh_field), getattr(ref._host_bvh(), bvh_field))
    rays = [(np.array([0.5, 0.5, 2.0]), np.array([0.0, 0.0, -1.0]), 1.5, True),
            (np.array([0.2, 0.8, 2.0]), np.array([0.3, 0.1, -1.0]), 0.0, False)]
    for keys in (["v"], ["LEFT"], ["RIGHT", "a"]):
        for app in (mine, ref):
            for k in keys:
                app.keyboard_event(k)
            if app.show_rays and app.logged_rays is None:
                for ray in rays:
                    app.log_ray(*ray)
        got, want = mine.frame(), ref.frame()
        # the wireframe: the same pixels in the same colours
        drawn, j_drawn = got != preview * 0.35, want != j_preview * 0.35
        np.testing.assert_array_equal(drawn.any(-1), j_drawn.any(-1))
        assert drawn.any()
        np.testing.assert_array_equal(got[drawn.any(-1)], want[drawn.any(-1)])
        # under it, the dimmed preview, within the preview's tolerances
        _same_colours(got, want, scale=0.35)
    assert mine.selection_history == ref.selection_history and len(mine.selection_history) == 3


@needs_jax
@pytest.mark.parametrize("batch", [1, 2])
def test_progressive_frames_match_jax(batch, cornell):
    mine, ref = _pair(cornell)
    mine.progressive_batch = ref.progressive_batch = batch
    for app in (mine, ref):
        app.keyboard_event("r")
    n_frames = 0
    while not ref.render_done:
        got, want = mine.frame(), ref.frame()
        n_frames += 1
        assert got.shape == want.shape == (H, W, 3)
        np.testing.assert_array_equal(mine._counts.numpy(), ref._counts)
        hdr, j_hdr = mine._hdr().numpy(), ref._film / np.maximum(ref._counts, 1)[..., None]
        assert hdr.sum() > 0
        _close(hdr, j_hdr)
        _close(got, want)
    assert mine.render_done and n_frames == -(-KW["ns_aa"] // batch)
    # sample for sample the offline render's estimator
    offline, counts = mine.renderer.render(progress=False)
    assert (counts.numpy() == KW["ns_aa"]).all()
    np.testing.assert_allclose(mine._hdr().numpy(), offline.numpy(), rtol=1e-5, atol=1e-6)
    # the logged primary rays of the visualizer's overlay
    assert mine.logged_rays.shape == ref.logged_rays.shape == (24, 7)
    np.testing.assert_array_equal(mine.logged_rays[:, 6] > 0, ref.logged_rays[:, 6] > 0)
    np.testing.assert_allclose(mine.logged_rays, ref.logged_rays, rtol=1e-5, atol=1e-5)


@needs_jax
def test_cell_render_and_autofocus_match_jax(cornell):
    mine, ref = _pair(cornell, lens_radius=0.05, focal_distance=1.0)
    script = [("key", "r"), ("key", "C"), ("press", tapp.LEFT, 8.0, 12.0), ("move", 30.0, 28.0),
              ("release", tapp.LEFT)]
    for ev in script:
        _event(mine, ev)
        _event(ref, ev)
        _same_state(mine, ref)
    x0, y0, dx, dy = mine._cell_bounds()
    assert (x0, y0, dx, dy) == (8, H - 28, 22, 16)  # dragged rows 12..28 are film rows 36-28 .. 36-12
    got, want = mine.frame(), ref.frame()
    counts = mine._counts.numpy()
    np.testing.assert_array_equal(counts, ref._counts)
    assert counts[y0 : y0 + dy, x0 : x0 + dx].min() == 1 and counts.sum() == dx * dy
    _close(mine._hdr().numpy()[y0 : y0 + dy, x0 : x0 + dx],
           (ref._film / np.maximum(ref._counts, 1)[..., None])[y0 : y0 + dy, x0 : x0 + dx])
    _close(got, want)
    # right-click autofocus on the box's back wall (screen rows top-down: the screenH - y flip)
    for app in (mine, ref):
        app.mouse_pressed(tapp.RIGHT, 24.0, 14.0)
        app.mouse_released(tapp.RIGHT)
    d, j_d = mine.renderer.camera.focal_distance, ref.renderer.camera.focal_distance
    assert np.isfinite(d) and d > 0 and abs(d - j_d) <= 1e-5 * j_d
    assert mine._sample_idx == 0 and mine.log[:-1] == ref.log[:-1]


@needs_jax
@pytest.mark.parametrize("mesh", [0, 5], ids=["wall", "block"])
def test_mesh_edit_keys_match_jax(mesh, cornell):
    """u, d, i, f, s and c on the selected mesh (a wall quad, the open block): the same scene after each."""
    mine, ref = _pair(cornell, use_wide_tree=False)
    mine.selected_mesh = ref.selected_mesh = mesh
    mine.selected_edge = ref.selected_edge = 3
    edited = 0
    for key in "udifsc":
        before = mine.renderer.scene.num_triangles
        for app in (mine, ref):
            app.keyboard_event(key)
        s, j = mine.renderer.scene, ref.renderer.scene
        for f in ("tri_p", "tri_n", "tri_bsdf", "bbox_min", "bbox_max"):
            np.testing.assert_array_equal(getattr(s, f), np.asarray(getattr(j, f)), err_msg=f"{key}: {f}")
            assert getattr(s, f).dtype == np.asarray(getattr(j, f)).dtype
        assert mine.log == ref.log and mine._preview_cache is None
        edited += s.num_triangles != before
    assert edited >= 3
    _same_preview(mine, ref)  # the rebuilt scene traces as the JAX one does


@needs_jax
def test_mesh_edit_rejects_nonmanifold(cornell):
    """Non-manifold soup (a triangle duplicated) is refused by u and f in both packages, not crashed on."""
    mine, ref = _pair(cornell)
    for app in (mine, ref):
        s = app.renderer.scene
        app.renderer.load_flat_scene(dataclasses.replace(
            s, tri_p=np.concatenate([s.tri_p[:1], s.tri_p]), tri_n=np.concatenate([s.tri_n[:1], s.tri_n]),
            tri_bsdf=np.concatenate([s.tri_bsdf[:1], s.tri_bsdf])), camera=app.renderer.camera)
    t0 = mine.renderer.scene.num_triangles
    for key in "uf":
        for app in (mine, ref):
            app.keyboard_event(key)
    assert mine.renderer.scene.num_triangles == ref.renderer.scene.num_triangles == t0
    assert mine.log == ref.log and "rejected" in mine.log[-1]


def test_save_image(cornell, tmp_path):
    from lens_flare_tpu_torch.utils.image import load_png

    app = _port_app(cornell)
    app.filename = str(tmp_path / "shot")
    app.keyboard_event("r")
    frame = app.frame()
    app.keyboard_event("s")
    png = load_png(tmp_path / "shot.png")
    assert png.shape == (H, W, 3)
    # no flare configured: the PNG is the frame, bottom-up film flipped
    want = np.clip(np.round(frame[::-1] * 255.0), 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(png, want)


# ---------------------------------------------------------------------------
# the app's programs: the CPU stand-in, then the card
# ---------------------------------------------------------------------------


def _frames(app, script):
    """Run ``script`` (events, or "frame"), return each frame's outputs and the launch counts."""
    out = []
    for ev in script:
        if ev == "frame":
            ic.reset_launch_counts()
            f = app.frame()
            film = None if app._film is None else (app._film.clone(), app._counts.clone())
            out.append((f, film, compiled.launch_counts()))
        else:
            _event(app, ev)
    return out


# EDIT preview, an orbit, the preview again; RENDER frames; a keyboard orbit in VISUALIZE and RENDER
# again with the same settings; a settings key; a mesh edit and its preview
PROGRAM_SCRIPT = [
    "frame", *MOUSE[:4], "frame", ("key", "r"), "frame", "frame", ("key", "v"), ("key", "q"), ("key", "r"),
    "frame", ("key", "<"), "frame", ("key", "e"), ("key", "u"), "frame",
]


def _hold_programs(cornell, device, graphs=None):
    """The script eagerly and replayed on ``device``: equal frames and launches; which steps capture."""
    with compiled.disabled():
        want = _frames(_port_app(cornell, device), PROGRAM_SCRIPT)
    app = _port_app(cornell, device)
    r = app.renderer
    programs, steps = [], []
    for ev in PROGRAM_SCRIPT:
        steps.append(_frames(app, [ev]))
        programs.append(len(r._programs))
    got = [s[0] for s in steps if s]
    assert len(got) == len(want) == PROGRAM_SCRIPT.count("frame")
    for (f, film, launches), (wf, wfilm, wlaunches) in zip(got, want):
        assert np.array_equal(f, wf)
        assert (film is None) == (wfilm is None)
        if film is not None:
            assert torch.equal(film[0], wfilm[0]) and torch.equal(film[1], wfilm[1])
        assert launches == wlaunches
    assert sum(w[2][k] for w in want for k in w[2]) > 0
    at = [i for i, ev in enumerate(PROGRAM_SCRIPT) if ev == "frame"]
    # the preview: one program; the orbit replays it
    assert programs[at[0]] == programs[at[1]] == 1
    # RENDER: one keys and one sample program per lane width (three 512-lane tiles, one 256-lane tail)
    assert programs[at[2]] == programs[at[3]] == programs[at[4]] == 5
    # '<' changes the settings: every program is dropped, and the frame captures its four anew
    assert programs[at[5]] == 4
    # the mesh edit rebuilt the scene: every program was dropped, the preview captured anew
    assert programs[at[6]] == 1
    return steps


def test_app_programs_on_the_cpu_stand_in(cornell, cpu_capture):
    """The captures the card makes, on the CPU: equal frames, an orbit and a restart replay, an edit drops."""
    _hold_programs(cornell, "cpu")
    # 1 preview, 4 RENDER (keys and sample at two widths) twice (before and after '<'), 1 after the edit
    assert len(cpu_capture) == 10


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_app_programs_on_card(cornell, cuda_device):
    steps = _hold_programs(cornell, "cuda")
    launches = [s[0][2] for s in steps if s]
    assert launches[0]["C"] == 0 and sum(launches[0].values()) > 0  # the preview: closest hits only
    assert launches[2]["C"] > 0  # RENDER frames trace shadow rays through C
