"""The port's copies of the JAX package's host modules give the same arrays.

``lens_flare_tpu_torch`` keeps its own ``make_terrain_scene``, ``FlatScene``,
``build_wide_bvh`` (native and NumPy builders), host ``Camera`` (its
viewer moves too), image
transforms and EXR reader and writer.  Each is held here to the JAX
package's original on the same inputs, exactly: they are the same NumPy
(or C++) code.  The port's EXR writer also writes HALF channels, which the
original reads.
"""

import dataclasses
import math

import numpy as np
import pytest

import lens_flare_tpu.accel.native as j_native
from lens_flare_tpu.accel import wide as j_wide
from lens_flare_tpu.scene import camera as j_camera
from lens_flare_tpu.scene import collada as j_collada
from lens_flare_tpu.scene.build import LT_DIRECTIONAL as J_LT_DIRECTIONAL
from lens_flare_tpu.scene.build import LT_POINT as J_LT_POINT
from lens_flare_tpu.scene.procedural import make_terrain_scene as j_terrain
from lens_flare_tpu.utils import exr as j_exr
from lens_flare_tpu.utils import image as j_image

from lens_flare_tpu_torch.accel import wide
from lens_flare_tpu_torch.scene import build, collada
from lens_flare_tpu_torch.scene.camera import Camera
from lens_flare_tpu_torch.scene.procedural import make_terrain_scene
from lens_flare_tpu_torch.utils import exr, image


def _assert_same_fields(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if dataclasses.is_dataclass(x):
            _assert_same_fields(x, y)
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=f.name)
            assert np.asarray(x).dtype == np.asarray(y).dtype, f.name


@pytest.mark.parametrize("nq", [8, 40, 64])
def test_terrain_scene_equals_jax(nq):
    _assert_same_fields(make_terrain_scene(nq), j_terrain(nq))


def test_constants_equal_jax():
    for name in ("BSDF_DIFFUSE", "BSDF_EMISSION", "BSDF_MIRROR", "BSDF_MICROFACET",
                 "BSDF_REFRACTION", "BSDF_GLASS"):
        assert getattr(collada, name) == getattr(j_collada, name)
    assert (build.LT_DIRECTIONAL, build.LT_POINT) == (J_LT_DIRECTIONAL, J_LT_POINT)
    _assert_same_fields(collada.MaterialInfo(), j_collada.MaterialInfo())


@pytest.mark.parametrize("nq,shape", [(8, None), (40, None), (64, (8, 32, 32))])
@pytest.mark.parametrize("native", [True, False])
def test_wide_bvh_equals_jax(nq, shape, native, monkeypatch):
    tri_p = make_terrain_scene(nq).tri_p
    args = () if shape is None else shape
    if native:
        got = wide.build_wide_bvh(tri_p, *args)
    else:
        got = wide._build_wide_numpy(tri_p, *(shape or wide.choose_shape(len(tri_p))))
        # the JAX package's builder falls back to NumPy when native returns None
        monkeypatch.setattr(j_native, "build_wide_native", lambda *a: None)
    want = j_wide.build_wide_bvh(tri_p, *args)
    _assert_same_fields(got, want)
    assert wide.choose_shape(len(tri_p)) == j_wide.choose_shape(len(tri_p))


def test_native_builder_is_used():
    from lens_flare_tpu_torch.accel import native

    assert native.get_lib() is not None, "g++ should build the port's wide builder"
    assert native._library_path().parent.name == "_build"


def test_camera_params_equal_jax():
    info = j_collada.CameraInfo(h_fov=40.0, v_fov=30.0, n_clip=0.01, f_clip=500.0)
    cams = []
    for cls in (Camera, j_camera.Camera):
        cam = cls()
        cam.configure(info, 320, 240)
        cam.place(np.array([0.5, -1.0, 2.0]), math.pi / 3, math.pi / 4, 30.0, 3.0, 300.0)
        cam.lens_radius, cam.focal_distance = 0.2, 25.0
        cams.append(cam)
    mine, ref = cams
    for f in j_camera.CameraParams._fields:
        a, b = getattr(mine.params(), f), getattr(ref.params(), f)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=f)
        assert np.asarray(a).dtype == np.asarray(b).dtype, f
    for p in ([4.0, -4.0, 8.0], [-6.0, 7.0, 9.0]):
        assert mine.analyze_world_coord(np.array(p)) == ref.analyze_world_coord(np.array(p))


def test_camera_moves_equal_jax():
    """The viewer's moves: pan (move_by), dolly (move_forward, clamped at min_r and max_r) and orbit
    (rotate_by, phi clamped to [0, pi]), in turn from the same placement."""
    info = j_collada.CameraInfo(h_fov=40.0, v_fov=30.0, n_clip=0.01, f_clip=500.0)
    moves = [("rotate_by", 0.3, -0.7), ("move_by", -12.0, 5.0, 30.0), ("move_forward", 4.5),
             ("move_forward", -1e3), ("rotate_by", -5.0, 0.2), ("move_forward", 1e3), ("rotate_by", 9.0, 3.0),
             ("move_by", 3.0, -8.0, 7.5), ("place", np.array([0.5, -1.0, 2.0]), 1.0, 0.5, 30.0, 3.0, 300.0)]
    cams = []
    for cls in (Camera, j_camera.Camera):
        cam = cls()
        cam.configure(info, 320, 240)
        cam.place(np.array([0.5, -1.0, 2.0]), math.pi / 3, math.pi / 4, 30.0, 3.0, 300.0)
        cams.append(cam)
    mine, ref = cams
    for name, *args in moves:
        getattr(mine, name)(*args)
        getattr(ref, name)(*args)
        for f in ("pos", "target_pos", "c2w", "phi", "theta", "r"):
            a, b = np.asarray(getattr(mine, f)), np.asarray(getattr(ref, f))
            np.testing.assert_array_equal(a, b, err_msg=f"{name}: {f}")
            assert a.dtype == b.dtype
    assert mine.r == 30.0 and mine.phi == 1.0


def test_image_transforms_equal_jax():
    rng = np.random.default_rng(0)
    hdr = rng.uniform(-0.2, 3.0, (6, 5, 3)).astype(np.float32)
    np.testing.assert_array_equal(image.to_color(hdr), j_image.to_color(hdr))
    counts = rng.integers(0, 17, (6, 5))
    np.testing.assert_array_equal(
        image.sampling_rate_heatmap(counts, 16), j_image.sampling_rate_heatmap(counts, 16)
    )


@pytest.mark.parametrize("compression", [exr.COMPRESSION_NONE, exr.COMPRESSION_ZIPS, exr.COMPRESSION_ZIP],
                         ids=["none", "zips", "zip"])
@pytest.mark.parametrize("pixel_type", [exr.PIXELTYPE_HALF, exr.PIXELTYPE_FLOAT], ids=["half", "float"])
def test_exr_files_read_both_ways(pixel_type, compression, tmp_path):
    """Each package reads the other's files: the port's writer (HALF or FLOAT) and the original's (FLOAT)."""
    rng = np.random.default_rng(pixel_type * 10 + compression)
    # 37 rows: a ZIP file's last block holds 5; a flat run keeps some blocks compressible
    img = rng.uniform(0.0, 6e4 if pixel_type == exr.PIXELTYPE_HALF else 1e6, (37, 29, 3)).astype(np.float32)
    img[5:20] = 0.5
    dtype = np.float16 if pixel_type == exr.PIXELTYPE_HALF else np.float32
    want = img.astype(dtype).astype(np.float32)
    exr.write(tmp_path / "port.exr", img, compression=compression, pixel_type=pixel_type)
    for read in (exr.read, j_exr.read):
        got = read(tmp_path / "port.exr")
        assert got.dtype == np.float32 and np.array_equal(got, want)
    if pixel_type == exr.PIXELTYPE_FLOAT:  # the original writes FLOAT only, and the same bytes
        j_exr.write(tmp_path / "jax.exr", img, compression=compression)
        assert np.array_equal(exr.read(tmp_path / "jax.exr"), img)
        assert (tmp_path / "jax.exr").read_bytes() == (tmp_path / "port.exr").read_bytes()
