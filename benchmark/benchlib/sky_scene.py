"""The config-3 scene, made from the seed: a four-BSDF terrain file, its lights and camera, and an HDR sky.

The terrain is :func:`benchlib.scene.terrain` (its heights drawn from the
seed, ``2 * n**2`` triangles whatever the seed), laid out as
``lens_flare_tpu_torch/scene/writer.py:terrain_dae`` lays it out: one
vertex array, four polylists by quadrant (diffuse, microfacet copper,
mirror, glass), a directional sun, an area light facing down and a camera
given by a ``<matrix>``.  The sky is an equirect gradient with a bright
disk, as ``writer.py:sky_map`` draws it, the disk's direction drawn from
the seed near the sun's.  :func:`make` returns the host arrays both sides
are given; :func:`write` writes the ``.dae`` and the EXR the program
loads.  What the program makes of the files is worked out here again from
the numbers written, with frozen copies of the loader's rules
(``scene/collada.py``, ``scene/build.py``, ``scene/camera.py:
place_from_scene_info`` and ``Camera.configure``), never from the
program's parse.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from . import dae_writer, exr_writer
from .driver import rng_for
from .scene import LT_DIRECTIONAL, OrbitCamera, terrain, vertex_normals

LT_AREA = 3
BSDF = {"diffuse": 0, "mirror": 2, "microfacet": 3, "glass": 5}


@dataclass
class SkyScene:
    """Host arrays of the config-3 scene, as the program holds them after ``Renderer.load``."""

    vertices: np.ndarray  # (V, 3) float32: the file's one vertex array
    quad_tris: list  # four (T_q, 3) int64 index arrays: the polylists by quadrant
    materials: list  # the four material dicts, in the polylists' order
    tri_p: np.ndarray  # (T, 3, 3) float32 corners, the polylists one after another
    tri_n: np.ndarray  # (T, 3, 3) float32 area-weighted vertex normals of each polylist
    tri_bsdf: np.ndarray  # (T,) int64 material row
    light_type: np.ndarray  # (2,) int32: the sun (directional), the area light
    light_radiance: np.ndarray  # (2, 3) float32
    light_position: np.ndarray  # (2, 3) float32: the sun's flare point; the area light's centre
    light_direction: np.ndarray  # (2, 3) float32: dirToLight; the area light's facing
    light_dim_x: np.ndarray  # (2, 3) float32
    light_dim_y: np.ndarray  # (2, 3) float32
    light_area: np.ndarray  # (2,) float32
    lights: list  # the light dicts the file holds
    camera: dict  # xfov, yfov, znear, zfar and the 4x4 matrix as written
    sky: np.ndarray  # (H, W, 3) float32: the sky's texels as written (HALF-rounded)
    bbox_min: np.ndarray  # (3,) float64
    bbox_max: np.ndarray


def _axis_angle(axis, angle) -> np.ndarray:
    """The loader's rotation matrix (copy of ``scene/collada.py:_axis_angle``)."""
    axis = np.asarray(axis, dtype=np.float64)
    x, y, z = axis / np.linalg.norm(axis)
    c, s = math.cos(angle), math.sin(angle)
    C = 1 - c
    m = np.eye(4)
    m[:3, :3] = [
        [x * x * C + c, x * y * C - z * s, x * z * C + y * s],
        [y * x * C + z * s, y * y * C + c, y * z * C - x * s],
        [z * x * C - y * s, z * y * C + x * s, z * z * C + c],
    ]
    return m


def node_transform(ops) -> np.ndarray:
    """A node's world transform from its (kind, values) list, each applied after the ones before it."""
    local = np.eye(4)
    for kind, vals in ops:
        v = dae_writer.parsed(vals)
        m = np.eye(4)
        if kind == "rotate":
            m = _axis_angle(v[:3], math.radians(v[3]))
        elif kind == "translate":
            m[:3, 3] = v[:3]
        elif kind == "scale":
            m[0, 0], m[1, 1], m[2, 2] = v[0], v[1], v[2]
        local = m @ local
    return local


def transform_points(m: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """A 4x4 applied to (N, 3) points with the perspective divide (copy of ``scene/build.py``)."""
    h = pts @ m[:3, :3].T + m[:3, 3]
    w = pts @ m[3, :3] + m[3, 3]
    return h / w[:, None]


def light_rows(lights: list) -> dict:
    """The light table the loader builds: a directional light's flare point is its transform applied to
    (0, 0, -1) as a point, dirToLight that point made unit; an area light's centre, facing and edges
    are its transform applied to the origin, (0, 0, -1) and the edges (-1, 0, 0) and (0, 1, 0)."""
    n = len(lights)
    out = {k: np.zeros((n, 3), np.float32) for k in ("radiance", "position", "direction", "dim_x", "dim_y")}
    out["type"], out["area"] = np.zeros(n, np.int32), np.zeros(n, np.float32)
    for i, li in enumerate(lights):
        t = node_transform(li["transforms"])
        out["radiance"][i] = dae_writer.parsed(li["color"])
        if li["kind"] == "directional":
            pos = transform_points(t, np.array([[0.0, 0.0, -1.0]]))[0]
            out["type"][i], out["position"][i], out["direction"][i] = LT_DIRECTIONAL, pos, pos / np.linalg.norm(pos)
        elif li["kind"] == "area":
            position, facing, up = np.zeros(3), np.array([0.0, 0.0, -1.0]), np.array([0.0, 1.0, 0.0])
            pos = transform_points(t, position[None])[0]
            direction = transform_points(t, (position + facing)[None])[0] - pos
            dim_x = transform_points(t, np.cross(up, facing)[None])[0] - pos
            dim_y = transform_points(t, up[None])[0] - pos
            out["type"][i], out["position"][i] = LT_AREA, pos
            out["direction"][i] = direction / np.linalg.norm(direction)
            out["dim_x"][i], out["dim_y"][i] = dim_x, dim_y
            out["area"][i] = np.linalg.norm(dim_x) * np.linalg.norm(dim_y)
        else:
            raise ValueError(f"the config-3 scene holds directional and area lights, not {li['kind']!r}")
    return out


def camera_matrix(view) -> np.ndarray:
    """The camera node's matrix: (0, 0, -1) turned to ``view`` (from the target toward the camera)."""
    view = np.asarray(view, np.float64)
    view = view / np.linalg.norm(view)
    x = np.cross([0.0, 0.0, 1.0], view)
    x /= np.linalg.norm(x)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2] = x, np.cross(view, x), -view
    return m


def home_camera(scene: SkyScene, width: int, height: int) -> OrbitCamera:
    """The camera ``Renderer.load`` places: the file's FOVs widened to the film's aspect
    (``Camera.configure``), then the bbox orbit whose angles the file's matrix gives
    (``place_from_scene_info``: (0, 0, -1) transformed as a point, r = 1.5 x the half diagonal x 2)."""
    c = scene.camera
    h_fov, v_fov = c["xfov"], c["yfov"]
    ar1 = math.tan(math.radians(h_fov) / 2) / math.tan(math.radians(v_fov) / 2)
    ar = width / height
    if ar1 < ar:
        h_fov = 2 * math.degrees(math.atan(math.tan(math.radians(v_fov) / 2) * ar))
    elif ar1 > ar:
        v_fov = 2 * math.degrees(math.atan(math.tan(math.radians(h_fov) / 2) / ar))
    c_dir = c["transform"] @ np.array([0.0, 0.0, -1.0, 1.0])
    c_dir = c_dir[:3] / np.linalg.norm(c_dir[:3])
    cam = OrbitCamera(h_fov=h_fov, v_fov=v_fov, n_clip=c["znear"], f_clip=c["zfar"])
    cam.target_pos = (np.asarray(scene.bbox_min) + np.asarray(scene.bbox_max)) / 2.0
    canonical = np.linalg.norm(np.asarray(scene.bbox_max) - np.asarray(scene.bbox_min)) / 2.0 * 1.5
    phi = math.acos(c_dir[1])
    cam.phi = phi + 1e-5 if math.sin(phi) == 0 else phi
    cam.theta = math.atan2(c_dir[0], c_dir[2])
    cam.r = min(max(canonical * 2.0, canonical / 10.0), canonical * 20.0)
    cam.compute_position()
    return cam


def sky_map(width: int, height: int, disk_dir, peak: float, disk_deg: float) -> np.ndarray:
    """An equirect sky (H, W, 3) float32: a zenith-to-horizon blue gradient, a dim ground below the
    horizon and a disk of ``disk_deg`` radius at ``peak`` around ``disk_dir`` (the envlight convention:
    (theta, phi) -> (cos(phi - pi) sin(theta), cos(theta), -sin(phi - pi) sin(theta)))."""
    theta = np.pi * (np.arange(height) + 0.5) / height
    phi = 2.0 * np.pi * (np.arange(width) + 0.5) / width
    t = np.clip(theta / (np.pi / 2), 0.0, 1.0)[:, None]
    rows = (1.0 - t) * np.array([0.25, 0.45, 1.0]) + t * np.array([0.9, 0.95, 1.0])
    rows = np.where((theta > np.pi / 2)[:, None], np.array([0.3, 0.25, 0.2]), rows)
    sky = np.broadcast_to(rows[:, None, :], (height, width, 3)).astype(np.float32)
    s = np.asarray(disk_dir, np.float64) / np.linalg.norm(disk_dir)
    cos_to_disk = (np.sin(theta)[:, None] * (np.cos(phi - np.pi)[None, :] * s[0] - np.sin(phi - np.pi)[None, :] * s[2])
                   + (np.cos(theta) * s[1])[:, None])
    sky[cos_to_disk > np.cos(np.radians(disk_deg))] = peak
    return sky


def disk_direction(sun_dir, seed: int, within_deg: float) -> np.ndarray:
    """A direction drawn from the seed, uniform over the cone of ``within_deg`` about ``sun_dir``."""
    g = rng_for(seed, 5)
    z = np.asarray(sun_dir, np.float64) / np.linalg.norm(sun_dir)
    x = np.cross(z, [1.0, 0.0, 0.0] if abs(z[0]) < 0.9 else [0.0, 1.0, 0.0])
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    cos_t = 1.0 - g.random() * (1.0 - math.cos(math.radians(within_deg)))
    sin_t, a = math.sqrt(max(1.0 - cos_t * cos_t, 0.0)), 2.0 * math.pi * g.random()
    return cos_t * z + sin_t * (math.cos(a) * x + math.sin(a) * y)


def make(cfg_scene: dict, cfg_sky: dict, seed: int) -> SkyScene:
    """The scene of a configuration's ``scene`` and ``sky`` under ``seed``."""
    tri_p = terrain(int(cfg_scene["n_quads"]), seed).tri_p  # float32, so the file holds these values exactly
    verts, inverse = np.unique(tri_p.reshape(-1, 3), axis=0, return_inverse=True)
    tris = inverse.reshape(-1, 3)
    centre = tri_p.mean(axis=1)
    quadrant = (centre[:, 0] > 0).astype(np.int64) + 2 * (centre[:, 1] > 0)
    quad_tris = [tris[quadrant == q] for q in range(4)]
    v64 = dae_writer.parsed(verts).reshape(-1, 3)  # what the loader parses: float32 values to 9 digits
    ps, ns, bs = [], [], []
    for q, tq in enumerate(quad_tris):
        normals = vertex_normals(v64, tq)  # per polylist, as the loader makes them
        ps.append(v64[tq])
        ns.append(normals[tq])
        bs.append(np.full(len(tq), q, np.int64))
    tri_p = np.concatenate(ps).astype(np.float32)
    lights = cfg_scene["lights"]
    rows = light_rows(lights)
    cam = cfg_scene["camera"]
    matrix = camera_matrix(cam["view"])
    sun = rows["direction"][[li["kind"] for li in lights].index("directional")]
    disk = disk_direction(sun, seed, float(cfg_sky["disk_within_deg"]))
    sky = sky_map(int(cfg_sky["width"]), int(cfg_sky["height"]), disk, float(cfg_sky["peak"]),
                  float(cfg_sky["disk_deg"]))
    return SkyScene(
        vertices=verts, quad_tris=quad_tris, materials=cfg_scene["materials"],
        tri_p=tri_p, tri_n=np.concatenate(ns).astype(np.float32), tri_bsdf=np.concatenate(bs),
        light_type=rows["type"], light_radiance=rows["radiance"], light_position=rows["position"],
        light_direction=rows["direction"], light_dim_x=rows["dim_x"], light_dim_y=rows["dim_y"],
        light_area=rows["area"], lights=lights,
        camera={"xfov": float(cam["xfov"]), "yfov": float(cam["yfov"]), "znear": float(cam["znear"]),
                "zfar": float(cam["zfar"]), "matrix": matrix,
                "transform": dae_writer.parsed(matrix).reshape(4, 4)},
        sky=sky.astype(np.float16).astype(np.float32),
        bbox_min=tri_p.min(axis=1).min(axis=0).astype(np.float64),
        bbox_max=tri_p.max(axis=1).max(axis=0).astype(np.float64),
    )


def write(scene: SkyScene, out_dir) -> tuple[Path, Path]:
    """The scene's ``.dae`` (Z_UP, as ``terrain_dae``) and its sky as a HALF, ZIP EXR under ``out_dir``."""
    out_dir = Path(out_dir)
    w = dae_writer.DaeWriter()
    for tq, mat in zip(scene.quad_tris, scene.materials):
        w.mesh(scene.vertices, tq, mat)
    for li in scene.lights:
        w.light(li["kind"], li["color"], li["transforms"])
    c = scene.camera
    w.camera(c["xfov"], c["yfov"], c["znear"], c["zfar"], c["matrix"])
    dae = w.write(out_dir / "scene.dae")
    sky = out_dir / "sky.exr"
    exr_writer.write(sky, scene.sky)
    return dae, sky
