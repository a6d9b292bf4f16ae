"""The benchmark's own inputs: the terrain, the aperture masks and the camera, made from the seed.

Frozen copies, so that the program under test can change without moving
the yardstick:

- :func:`terrain` is ``lens_flare_tpu_torch/scene/procedural.py:make_terrain_scene``
  with ``scene/build.py:vertex_normals``: a ridged heightfield of
  ``2 * n**2`` triangles whatever the seed, a directional sun and a point
  fill light, one diffuse material;
- :func:`polygon_mask` is ``lens_flare_tpu_torch/lens/aperture.py:polygon_mask``;
- :class:`OrbitCamera` is the orbit placement, frame and projection of
  ``lens_flare_tpu_torch/scene/camera.py:Camera`` (``place``,
  ``compute_position``, ``rotate_by``, ``analyze_world_coord``,
  ``params``) that ``Renderer.load_flat_scene`` gives a procedural scene.

The same arrays go to the program (as its ``FlatScene``) and to the plain
reference.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

EPS_F = 0.00001
LT_DIRECTIONAL = 1
LT_POINT = 2


@dataclass
class Terrain:
    """Host arrays of the terrain scene (float32 where the program uploads float32)."""

    tri_p: np.ndarray  # (T, 3, 3) corner positions
    tri_n: np.ndarray  # (T, 3, 3) corner normals
    albedo: np.ndarray  # (3,) the one diffuse material
    light_type: np.ndarray  # (2,) int32: directional sun, point fill light
    light_radiance: np.ndarray  # (2, 3)
    light_position: np.ndarray  # (2, 3)
    light_direction: np.ndarray  # (2, 3): the sun's direction to the light
    bbox_min: np.ndarray  # (3,) float64
    bbox_max: np.ndarray

    @property
    def num_triangles(self) -> int:
        return len(self.tri_p)


def vertex_normals(vertices: np.ndarray, tris: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals (copy of ``scene/build.py:vertex_normals``)."""
    a = vertices[tris[:, 0]]
    b = vertices[tris[:, 1]]
    c = vertices[tris[:, 2]]
    face_vec = np.cross(b - a, c - a)
    normals = np.zeros_like(vertices)
    for corner in range(3):
        np.add.at(normals, tris[:, corner], face_vec)
    lens = np.linalg.norm(normals, axis=1, keepdims=True)
    return normals / np.maximum(lens, 1e-30)


def terrain(n_quads: int, seed: int) -> Terrain:
    """Heightfield terrain with 2 * n_quads**2 triangles (copy of ``make_terrain_scene``)."""
    rng = np.random.default_rng(seed)
    n = n_quads + 1
    xs = np.linspace(-10, 10, n)
    ys = np.linspace(-10, 10, n)
    gx, gy = np.meshgrid(xs, ys)

    z = np.zeros((n, n))
    for octave in range(1, 6):
        freq = octave * 0.45
        phase = rng.uniform(0, 2 * np.pi, 4)
        amp = 1.2 / octave
        z += amp * np.abs(np.sin(gx * freq + phase[0]) * np.cos(gy * freq + phase[1]))
        z += 0.4 * amp * np.sin(gx * freq * 1.7 + phase[2]) * np.sin(gy * freq * 1.3 + phase[3])
    z *= 0.8

    verts = np.stack([gx, gy, z], axis=-1).reshape(-1, 3)
    idx = np.arange(n * n).reshape(n, n)
    a = idx[:-1, :-1].ravel()
    b = idx[:-1, 1:].ravel()
    c = idx[1:, :-1].ravel()
    d = idx[1:, 1:].ravel()
    tris = np.concatenate([np.stack([a, b, c], axis=1), np.stack([b, d, c], axis=1)])
    normals = vertex_normals(verts, tris)

    position = np.array([[-6.0, 7.0, 9.0], [4.0, -4.0, 8.0]], np.float32)
    direction = np.zeros((2, 3), np.float32)
    direction[0] = position[0] / np.linalg.norm(position[0])  # dirToLight = unit(posLight)
    tri_p = verts[tris].astype(np.float32)
    return Terrain(
        tri_p=tri_p,
        tri_n=normals[tris].astype(np.float32),
        albedo=np.array([0.55, 0.45, 0.32], np.float32),
        light_type=np.array([LT_DIRECTIONAL, LT_POINT], np.int32),
        light_radiance=np.array([[1.3, 1.1, 0.65], [9.0, 9.0, 10.0]], np.float32),
        light_position=position,
        light_direction=direction,
        bbox_min=tri_p.min(axis=1).min(axis=0).astype(np.float64),
        bbox_max=tri_p.max(axis=1).max(axis=0).astype(np.float64),
    )


def polygon_mask(size: int, sides: int, radius: float = 0.42, rotation: float = 0.0) -> np.ndarray:
    """(size, size) float32 mask of a regular polygon (copy of ``lens/aperture.py:polygon_mask``)."""
    c = (np.arange(size) + 0.5) / size - 0.5
    x, y = np.meshgrid(c, c)
    inside = np.ones((size, size), bool)
    apothem = radius * np.cos(np.pi / sides)
    for i in range(sides):
        a = rotation + 2 * np.pi * (i + 0.5) / sides
        inside &= x * np.cos(a) + y * np.sin(a) <= apothem
    return inside.astype(np.float32)


def mask(spec: dict) -> np.ndarray:
    """A mask from a configuration's ``{"size", "sides", "rotation"}``."""
    return polygon_mask(int(spec["size"]), int(spec["sides"]), rotation=float(spec.get("rotation", 0.0)))


@dataclass
class OrbitCamera:
    """The orbit camera a procedural scene gets, as float64 host state (``scene/camera.py``)."""

    h_fov: float = 50.0
    v_fov: float = 35.0
    n_clip: float = 0.001
    f_clip: float = 1000.0
    target_pos: np.ndarray = field(default_factory=lambda: np.zeros(3))
    pos: np.ndarray = field(default_factory=lambda: np.zeros(3))
    c2w: np.ndarray = field(default_factory=lambda: np.eye(3))
    phi: float = 0.0
    theta: float = 0.0
    r: float = 1.0
    lens_radius: float = 0.0
    focal_distance: float = 0.0

    @classmethod
    def for_scene(cls, bbox_min, bbox_max) -> "OrbitCamera":
        """``Renderer.load_flat_scene``'s placement: the bbox centre, phi pi/3, theta pi/4, r the extent."""
        cam = cls()
        center = (np.asarray(bbox_min) + np.asarray(bbox_max)) / 2
        extent = np.linalg.norm(np.asarray(bbox_max) - np.asarray(bbox_min))
        cam.target_pos = np.asarray(center, dtype=np.float64)
        phi = math.pi / 3
        cam.phi = phi + EPS_F if math.sin(phi) == 0 else phi
        cam.theta = math.pi / 4
        cam.r = min(max(extent, extent / 10), extent * 10)
        cam.compute_position()
        return cam

    def compute_position(self) -> None:
        sin_phi = math.sin(self.phi)
        if sin_phi == 0:
            self.phi += EPS_F
            sin_phi = math.sin(self.phi)
        dir_to_camera = np.array(
            [
                self.r * sin_phi * math.sin(self.theta),
                self.r * math.cos(self.phi),
                self.r * sin_phi * math.cos(self.theta),
            ]
        )
        self.pos = self.target_pos + dir_to_camera
        up_vec = np.array([0.0, 1.0 if sin_phi > 0 else -1.0, 0.0])
        screen_x = np.cross(up_vec, dir_to_camera)
        screen_x /= np.linalg.norm(screen_x)
        screen_y = np.cross(dir_to_camera, screen_x)
        screen_y /= np.linalg.norm(screen_y)
        c2w = np.empty((3, 3))
        c2w[:, 0] = screen_x
        c2w[:, 1] = screen_y
        c2w[:, 2] = dir_to_camera / np.linalg.norm(dir_to_camera)
        self.c2w = c2w

    def rotate_by(self, d_phi: float, d_theta: float) -> None:
        self.phi = min(max(self.phi + d_phi, 0.0), math.pi)
        self.theta += d_theta
        self.compute_position()

    def analyze_world_coord(self, pos_world) -> tuple[float, float]:
        """World point -> normalized screen coords in [0, 1]^2."""
        edge_x = math.tan(0.5 * math.radians(self.h_fov))
        edge_y = math.tan(0.5 * math.radians(self.v_fov))
        pos_camera = self.c2w.T @ (np.asarray(pos_world) - self.pos)
        pos_image = pos_camera / abs(pos_camera[2])
        return float(((pos_image[0] / edge_x) + 1) / 2.0), float(((pos_image[1] / edge_y) + 1) / 2.0)

    def params(self) -> dict:
        """The float32 values ray generation reads (``Camera.params``)."""
        f = np.float32
        return dict(
            c2w=self.c2w.astype(f), pos=self.pos.astype(f),
            tan_half_h=f(math.tan(0.5 * math.radians(self.h_fov))),
            tan_half_v=f(math.tan(0.5 * math.radians(self.v_fov))),
            n_clip=f(self.n_clip), f_clip=f(self.f_clip),
            lens_radius=f(self.lens_radius), focal_distance=f(self.focal_distance),
        )


def orbit_thetas(theta0: float, arc: tuple[float, float], step: float, start: float, n: int) -> list[float]:
    """The camera's theta for frames 0 .. n-1 of an orbit that sweeps ``theta0 + arc`` back and forth.

    Frame 0 sits at ``theta0 + start``; each frame moves by ``step``, and
    the sweep turns at the arc's ends, so the sun stays on screen for any
    number of frames.
    """
    lo, hi = arc
    span = hi - lo
    out = []
    for i in range(n):
        u = (start - lo + i * step) % (2 * span)
        out.append(theta0 + lo + (u if u <= span else 2 * span - u))
    return out
