"""The port's COLLADA loader, scene flattening and camera placement against the JAX package's.

The .dae corpus is not in the repository, so the documents are written in
code by ``chip_smoke.py``'s writer (the one the card's smoke uses): a
Cornell box with every COLLADA light type (area, spot, point, directional,
ambient; CGL profile and technique_common), every material family
(profile_COMMON diffuse; CGL emission, mirror, microfacet, refraction,
glass), spheres, quads and triangles, nested nodes with rotate, scale and
translate; and a Z_UP terrain in four polylists whose camera is a
<matrix>.  Both packages load the same file.  Tolerance: none, every array
is compared exactly (dtype, shape, values), as the loaders are the same
NumPy code.
"""

import dataclasses

import numpy as np
import pytest

import chip_smoke
from lens_flare_tpu.renderer import Renderer as JaxRenderer
from lens_flare_tpu.scene import build as j_build
from lens_flare_tpu.scene import camera as j_camera
from lens_flare_tpu_torch.renderer import Renderer
from lens_flare_tpu_torch.scene import build, camera

ALL_LIGHTS = ("area", "spot", "point", "directional", "ambient")


def _documents(tmp_path):
    cb = chip_smoke.cornell_box(light_kinds=ALL_LIGHTS)
    cb.sphere(0.2, {"kind": "refraction", "transmittance": (0.9, 0.95, 1.0), "roughness": 0.0, "ior": 1.33},
              [("scale", (1.0, 1.0, 1.0)), ("translate", (-0.5, 0.2, 0.5))])
    cb.mesh([[-0.2, 1.9, -0.2], [0.2, 1.9, -0.2], [0.2, 1.9, 0.2], [-0.2, 1.9, 0.2]], [[0, 1, 2, 3]],
            {"kind": "diffuse", "albedo": (0.2, 0.3, 0.4)}, normals=[[0, -1, 0]] * 4)
    return {"cornell": cb.write(tmp_path / "cornell.dae"),
            "terrain": chip_smoke.terrain_dae(6).write(tmp_path / "terrain.dae")}


def _assert_same(a, b, where=""):
    """Every field of two dataclasses equal: arrays exactly (dtype too), nested dataclasses and lists field by field."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif a is None or b is None:
        assert a is None and b is None, where
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape, (where, x.dtype, y.dtype, x.shape, y.shape)
        np.testing.assert_array_equal(x, y, err_msg=where)


@pytest.mark.parametrize("doc", ["cornell", "terrain"])
def test_load_scene_matches_jax(doc, tmp_path):
    path = _documents(tmp_path)[doc]
    scene, info = build.load_scene(path)
    j_scene, j_info = j_build.load_scene(path)
    _assert_same(scene, j_scene, "FlatScene")
    _assert_same(info, j_info, "SceneInfo")
    if doc == "cornell":
        types = set(scene.lights.light_type.tolist())
        assert types == {build.LT_AREA, build.LT_SPOT, build.LT_POINT, build.LT_DIRECTIONAL, build.LT_HEMISPHERE}
        assert set(scene.bsdfs.bsdf_type.tolist()) == set(range(6))  # every family
        assert scene.num_spheres == 3
    # the lights the COLLADA subset cannot express, appended alike
    for table, mod in ((scene.lights, build), (j_scene.lights, j_build)):
        mod.add_sphere_light(table, (0.1, 1.5, 0.2), 0.15, (3.0, 3.0, 2.5))
        mod.add_mesh_light(table, scene.tri_p[:3], (1.0, 2.0, 3.0))
        mod.add_mesh_light(table, scene.tri_p[3:4], (0.5, 0.5, 0.5))
    _assert_same(scene.lights, j_scene.lights, "LightTable")


def test_camera_placement_matches_jax(tmp_path):
    """configure + place_from_scene_info give the same Camera.params(), before and after set_screen_size."""
    for path in _documents(tmp_path).values():
        scene, info = build.load_scene(path)
        cam, j_cam = camera.Camera(), j_camera.Camera()
        for c, mod in ((cam, camera), (j_cam, j_camera)):
            c.configure(info.camera, 320, 180)
            mod.place_from_scene_info(c, info, scene.bbox_min, scene.bbox_max)
        _assert_same(cam.params(), j_cam.params())
        cam.set_screen_size(200, 200)
        j_cam.set_screen_size(200, 200)
        _assert_same(cam.params(), j_cam.params())
        assert (cam.h_fov, cam.v_fov, cam.ar) == (j_cam.h_fov, j_cam.v_fov, j_cam.ar)


def test_settings_files(tmp_path):
    """A JAX dump_settings file loads into the port's camera field for field; the port writes the same text."""
    path = _documents(tmp_path)["cornell"]
    scene, info = j_build.load_scene(path)
    j_cam = j_camera.Camera()
    j_cam.configure(info.camera, 64, 48)
    j_camera.place_from_scene_info(j_cam, info, scene.bbox_min, scene.bbox_max)
    j_cam.rotate_by(0.2, -0.3)
    j_cam.move_forward(0.4)
    j_cam.lens_radius, j_cam.focal_distance = 0.05, 3.5
    j_cam.dump_settings(tmp_path / "cam.txt")
    cam = camera.Camera()
    cam.load_settings(tmp_path / "cam.txt")
    for f in ("h_fov", "v_fov", "ar", "n_clip", "f_clip", "pos", "target_pos", "phi", "theta", "r", "min_r", "max_r",
              "c2w", "screen_w", "screen_h", "screen_dist", "focal_distance", "lens_radius"):
        np.testing.assert_array_equal(np.asarray(getattr(cam, f)), np.asarray(getattr(j_cam, f)), err_msg=f)
    cam.dump_settings(tmp_path / "port.txt")
    j_again = j_camera.Camera()
    j_again.load_settings(tmp_path / "port.txt")
    j_again.dump_settings(tmp_path / "jax_again.txt")
    assert (tmp_path / "port.txt").read_text() == (tmp_path / "jax_again.txt").read_text()


@pytest.mark.parametrize("settings", [False, True], ids=["orbit", "settings_file"])
def test_renderer_load_matches_jax(settings, tmp_path):
    """Renderer.load places the camera as the JAX Renderer.load, the -c file's frame size ignored."""
    path = _documents(tmp_path)["cornell"]
    cam_file = None
    if settings:
        scene, info = j_build.load_scene(path)
        c = j_camera.Camera()
        c.configure(info.camera, 100, 30)  # another frame size than the render's
        j_camera.place_from_scene_info(c, info, scene.bbox_min, scene.bbox_max)
        c.rotate_by(-0.1, 0.4)
        cam_file = str(tmp_path / "cam.txt")
        c.dump_settings(cam_file)
    kw = dict(width=64, height=48, lens_radius=0.02, focal_distance=2.0, camera_settings=cam_file)
    r = Renderer(device="cpu", **kw)
    r.load(path)
    j = JaxRenderer(**kw)
    j.load(path)
    _assert_same(r.camera.params(), j.camera.params())
    assert (r.camera.screen_w, r.camera.screen_h) == (64, 48)
    r.set_frame_size(32, 24)
    j.set_frame_size(32, 24)
    _assert_same(r.camera.params(), j.camera.params())
    assert r.bundle.cscene is not None and r.bundle.cscene.brute  # 40 triangles: kernels C and A
