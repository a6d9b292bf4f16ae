"""The host camera, camera parameters on the device and ray generation.

Counterpart of ``lens_flare_tpu/scene/camera.py``.  :class:`Camera` is a
copy of the JAX package's NumPy host class (orbit placement, the FOV
fix-up, ``set_screen_size``, the viewer's moves ``move_by``, ``move_forward``
and ``rotate_by``, world -> screen projection, the settings files and
``params()``, ``camera.py:42-240``), with ``place_from_scene_info``
(``:243``), the placement a loaded COLLADA scene gets;
the device half holds ``CameraParams`` as tensors, pinhole, thin-lens and
bokeh ray generation (``camera.py:242-306``) and
:func:`project_world_to_screen` (``:309``).  Matrix products are written
as explicit sums so that they round as XLA's three-term dot products do.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

EPS_F = 0.00001


class CameraParams(NamedTuple):
    """Camera state ray generation needs: float32 tensors on one device
    (:func:`camera_params`), or NumPy values (:meth:`Camera.params`)."""

    c2w: torch.Tensor  # (3, 3) columns = [screenX, screenY, dirToCamera]
    pos: torch.Tensor  # (3,)
    tan_half_h: torch.Tensor  # ()
    tan_half_v: torch.Tensor
    n_clip: torch.Tensor
    f_clip: torch.Tensor
    lens_radius: torch.Tensor
    focal_distance: torch.Tensor


@dataclass
class Camera:
    """Host-side orbit camera (camera.cpp:69-106, 171-273); NumPy only."""

    h_fov: float = 50.0  # degrees
    v_fov: float = 35.0
    n_clip: float = 0.001
    f_clip: float = 1000.0
    screen_w: int = 800
    screen_h: int = 600
    screen_dist: float = 1.0
    ar: float = 1.0
    pos: np.ndarray = field(default_factory=lambda: np.zeros(3))
    target_pos: np.ndarray = field(default_factory=lambda: np.zeros(3))
    c2w: np.ndarray = field(default_factory=lambda: np.eye(3))
    phi: float = 0.0
    theta: float = 0.0
    r: float = 1.0
    min_r: float = 0.0
    max_r: float = math.inf
    lens_radius: float = 0.0
    focal_distance: float = 0.0

    def configure(self, info, screen_w: int, screen_h: int) -> None:
        """Clip planes and FOVs from ``info``, widened to the screen's aspect (camera.cpp:69-88)."""
        self.screen_w = screen_w
        self.screen_h = screen_h
        self.n_clip = info.n_clip
        self.f_clip = info.f_clip
        self.h_fov = info.h_fov
        self.v_fov = info.v_fov
        ar1 = math.tan(math.radians(self.h_fov) / 2) / math.tan(math.radians(self.v_fov) / 2)
        self.ar = screen_w / screen_h
        if ar1 < self.ar:
            self.h_fov = 2 * math.degrees(math.atan(math.tan(math.radians(self.v_fov) / 2) * self.ar))
        elif ar1 > self.ar:
            self.v_fov = 2 * math.degrees(math.atan(math.tan(math.radians(self.h_fov) / 2) / self.ar))
        self.screen_dist = screen_h / (2.0 * math.tan(math.radians(self.v_fov) / 2))

    def set_screen_size(self, screen_w: int, screen_h: int) -> None:
        """A new frame size at the same screen distance: the FOVs follow (camera.cpp:88-96)."""
        self.screen_w = screen_w
        self.screen_h = screen_h
        self.ar = screen_w / screen_h
        self.h_fov = 2 * math.degrees(math.atan(screen_w / (2 * self.screen_dist)))
        self.v_fov = 2 * math.degrees(math.atan(screen_h / (2 * self.screen_dist)))

    def place(self, target_pos, phi, theta, r, min_r, max_r) -> None:
        """Orbit placement around ``target_pos`` (camera.cpp:94-106)."""
        self.target_pos = np.asarray(target_pos, dtype=np.float64)
        self.phi = phi + EPS_F if math.sin(phi) == 0 else phi
        self.theta = theta
        self.r = min(max(r, min_r), max_r)
        self.min_r = min_r
        self.max_r = max_r
        self.compute_position()

    def compute_position(self) -> None:
        """Position and camera-to-world frame from the orbit angles (camera.cpp:181-203)."""
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

    def move_by(self, dx: float, dy: float, d: float) -> None:
        """Pan the camera and its target in the screen plane, scaled to distance ``d`` (JAX ``camera.py:140``)."""
        scale = d / self.screen_dist
        disp = self.c2w[:, 0] * (dx * scale) + self.c2w[:, 1] * (dy * scale)
        self.pos = self.pos + disp
        self.target_pos = self.target_pos + disp

    def move_forward(self, dist: float) -> None:
        """Dolly toward the target, the orbit radius clamped to [min_r, max_r] (JAX ``camera.py:146``)."""
        new_r = min(max(self.r - dist, self.min_r), self.max_r)
        self.pos = self.target_pos + (self.pos - self.target_pos) * (new_r / self.r)
        self.r = new_r

    def rotate_by(self, d_phi: float, d_theta: float) -> None:
        """Orbit around the target, phi clamped to [0, pi] (JAX ``camera.py:151``)."""
        self.phi = min(max(self.phi + d_phi, 0.0), math.pi)
        self.theta += d_theta
        self.compute_position()

    def analyze_world_coord(self, pos_world) -> tuple[float, float]:
        """World point -> normalized screen coords in [0,1]^2 (camera.cpp:245-273)."""
        edge_x = math.tan(0.5 * math.radians(self.h_fov))
        edge_y = math.tan(0.5 * math.radians(self.v_fov))
        pos_camera = self.c2w.T @ (np.asarray(pos_world) - self.pos)
        pos_image = pos_camera / abs(pos_camera[2])
        ns_x = ((pos_image[0] / edge_x) + 1) / 2.0
        ns_y = ((pos_image[1] / edge_y) + 1) / 2.0
        return float(ns_x), float(ns_y)

    def dump_settings(self, filename) -> None:
        """Write the camera in the reference's text format (camera.cpp:208-225)."""
        with open(filename, "w") as f:
            f.write(f"{self.h_fov} {self.v_fov} {self.ar} {self.n_clip} {self.f_clip}\n")
            f.write(" ".join(str(v) for v in self.pos) + " ")
            f.write(" ".join(str(v) for v in self.target_pos) + " \n")
            f.write(f"{self.phi} {self.theta} {self.r} {self.min_r} {self.max_r}\n")
            f.write(" ".join(str(self.c2w[i // 3, i % 3]) for i in range(9)) + " \n")
            f.write(f"{self.screen_w} {self.screen_h} {self.screen_dist}\n")
            f.write(f"{self.focal_distance} {self.lens_radius}\n")

    def load_settings(self, filename) -> None:
        """Read a file of :meth:`dump_settings` (camera.cpp:227-242)."""
        with open(filename) as f:
            vals = f.read().split()
        it = iter(vals)

        def nxt():
            return float(next(it))

        self.h_fov, self.v_fov, self.ar, self.n_clip, self.f_clip = (nxt() for _ in range(5))
        self.pos = np.array([nxt() for _ in range(3)])
        self.target_pos = np.array([nxt() for _ in range(3)])
        self.phi, self.theta, self.r, self.min_r, self.max_r = (nxt() for _ in range(5))
        self.c2w = np.array([nxt() for _ in range(9)]).reshape(3, 3)
        self.screen_w, self.screen_h = int(nxt()), int(nxt())
        self.screen_dist = nxt()
        self.focal_distance, self.lens_radius = nxt(), nxt()

    def params(self, dtype=np.float32) -> CameraParams:
        """The traced camera state as NumPy values (``camera_params`` puts it on a device)."""
        return CameraParams(
            c2w=self.c2w.astype(dtype),
            pos=self.pos.astype(dtype),
            tan_half_h=dtype(math.tan(0.5 * math.radians(self.h_fov))),
            tan_half_v=dtype(math.tan(0.5 * math.radians(self.v_fov))),
            n_clip=dtype(self.n_clip),
            f_clip=dtype(self.f_clip),
            lens_radius=dtype(self.lens_radius),
            focal_distance=dtype(self.focal_distance),
        )


def place_from_scene_info(camera: Camera, scene_info, bbox_min, bbox_max) -> None:
    """Orbit placement from the scene's bbox (application.cpp:278-301).

    The COLLADA camera's transform only gives the view direction, and, as in
    the reference, as a point transform of (0, 0, -1) (application.cpp:252-253
    uses Vector4D(v, 1)); the position comes from the bbox orbit.
    """
    transform = scene_info.camera.transform
    c_dir = transform @ np.array([0.0, 0.0, -1.0, 1.0])
    c_dir = c_dir[:3] / np.linalg.norm(c_dir[:3])

    target = (np.asarray(bbox_min) + np.asarray(bbox_max)) / 2.0
    extent = np.asarray(bbox_max) - np.asarray(bbox_min)
    canonical = np.linalg.norm(extent) / 2.0 * 1.5
    camera.place(
        target,
        math.acos(c_dir[1]),
        math.atan2(c_dir[0], c_dir[2]),
        canonical * 2.0,
        canonical / 10.0,
        canonical * 20.0,
    )


def camera_params(camera: Camera, device) -> CameraParams:
    """``Camera.params()`` moved onto ``device``."""
    p = camera.params()
    return CameraParams(
        *(torch.as_tensor(v, dtype=torch.float32, device=device) for v in p)
    )


def _norm3(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2])


def _to_world(c: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """v @ c.T for v (N, 3): camera space -> world space."""
    return torch.stack(
        [v[:, 0] * c[i, 0] + v[:, 1] * c[i, 1] + v[:, 2] * c[i, 2] for i in range(3)], dim=-1
    )


def generate_rays(params: CameraParams, x: torch.Tensor, y: torch.Tensor):
    """Pinhole rays for normalized sensor coords x, y in [0, 1], shape (N,).

    Returns (origins (N, 3), directions (N, 3)), as ``generate_rays``.
    """
    cx = params.tan_half_h * (2.0 * x - 1.0)
    cy = params.tan_half_v * (2.0 * y - 1.0)
    d_cam = torch.stack([cx, cy, -torch.ones_like(cx)], dim=-1)
    d_cam = d_cam / _norm3(d_cam)[:, None]
    d_world = _to_world(params.c2w, d_cam)
    origins = params.pos.expand(d_world.shape)
    return origins, d_world


def _lens_rays(params: CameraParams, x, y, p_lens):
    """Rays from lens points p_lens (N, 3, camera space) through the focal plane."""
    cx = params.tan_half_h * (2.0 * x - 1.0)
    cy = params.tan_half_v * (2.0 * y - 1.0)
    # the point on the plane of focus along the pinhole direction
    p_focus = torch.stack([cx, cy, -torch.ones_like(cx)], dim=-1) * params.focal_distance
    d_cam = p_focus - p_lens
    d_cam = d_cam / _norm3(d_cam)[:, None]
    c = params.c2w
    return params.pos + _to_world(c, p_lens), _to_world(c, d_cam)


def generate_rays_thin_lens(params: CameraParams, x, y, rnd_r, rnd_theta):
    """Thin-lens rays (``camera.py:258``): a lens-disk point of radius
    ``lens_radius`` from the uniforms rnd_r, rnd_theta, aimed at the focal-plane
    point of the pinhole ray.  Returns (origins (N, 3), directions (N, 3)).
    """
    r = params.lens_radius * torch.sqrt(rnd_r)
    theta = 2.0 * math.pi * rnd_theta
    p_lens = torch.stack([r * torch.cos(theta), r * torch.sin(theta), torch.zeros_like(r)], dim=-1)
    return _lens_rays(params, x, y, p_lens)


def generate_rays_bokeh(params: CameraParams, x, y, lens_uv):
    """Thin-lens rays whose lens point is a bokeh-mask sample (``camera.py:284``).

    ``lens_uv``: (N, 2) points in [-0.5, 0.5]^2 (``BokehMask.sample``), scaled
    by 2 * lens_radius so that the mask spans the lens diameter.
    """
    scale = 2.0 * params.lens_radius
    p_lens = torch.stack(
        [lens_uv[:, 0] * scale, lens_uv[:, 1] * scale, torch.zeros_like(lens_uv[:, 0])], dim=-1
    )
    return _lens_rays(params, x, y, p_lens)


def project_world_to_screen(params: CameraParams, pos_world: torch.Tensor):
    """World points (N, 3) -> normalized screen coords (ns_x, ns_y) (``camera.py:309``)."""
    rel = pos_world - params.pos
    c = params.c2w
    pos_camera = torch.stack(  # rel @ c2w
        [rel[:, 0] * c[0, j] + rel[:, 1] * c[1, j] + rel[:, 2] * c[2, j] for j in range(3)], dim=-1
    )
    pos_image = pos_camera / torch.abs(pos_camera[:, 2:3])
    ns_x = ((pos_image[:, 0] / params.tan_half_h) + 1) / 2.0
    ns_y = ((pos_image[:, 1] / params.tan_half_v) + 1) / 2.0
    return ns_x, ns_y
