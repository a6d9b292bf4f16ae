"""World-space scene arrays on the host.

Counterpart of ``FlatScene``, ``LightTable``, ``BSDFTable``, the ``LT_*``
light codes and ``vertex_normals`` of ``lens_flare_tpu/scene/build.py``
(``:38-175``), copied so that the port needs nothing from the JAX package.
Flattening parsed COLLADA nodes (``build_scene``) is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .collada import MaterialInfo

# Light type codes in the flattened table (integrator/lights.py dispatches on these)
LT_HEMISPHERE = 0
LT_DIRECTIONAL = 1
LT_POINT = 2
LT_AREA = 3
LT_SPOT = 5  # (4 = LT_ENV in the JAX package's integrator.lights)
LT_SPHERE = 6
LT_MESH = 7


@dataclass
class BSDFTable:
    """Struct-of-arrays material table; row b holds every family's params."""

    bsdf_type: np.ndarray  # (B,) int32
    albedo: np.ndarray  # (B,3) diffuse reflectance
    radiance: np.ndarray  # (B,3) emission
    reflectance: np.ndarray  # (B,3) mirror/glass
    transmittance: np.ndarray  # (B,3) refraction/glass
    eta: np.ndarray  # (B,3) microfacet conductor eta
    k: np.ndarray  # (B,3) microfacet conductor k
    alpha: np.ndarray  # (B,) microfacet roughness
    roughness: np.ndarray  # (B,)
    ior: np.ndarray  # (B,)

    @staticmethod
    def from_materials(mats: list[MaterialInfo]) -> "BSDFTable":
        n = len(mats)
        t = BSDFTable(
            bsdf_type=np.zeros(n, np.int32),
            albedo=np.zeros((n, 3), np.float32),
            radiance=np.zeros((n, 3), np.float32),
            reflectance=np.zeros((n, 3), np.float32),
            transmittance=np.zeros((n, 3), np.float32),
            eta=np.zeros((n, 3), np.float32),
            k=np.zeros((n, 3), np.float32),
            alpha=np.zeros(n, np.float32),
            roughness=np.zeros(n, np.float32),
            ior=np.ones(n, np.float32),
        )
        for i, m in enumerate(mats):
            t.bsdf_type[i] = m.bsdf_type
            t.albedo[i] = m.albedo
            t.radiance[i] = m.radiance
            t.reflectance[i] = m.reflectance
            t.transmittance[i] = m.transmittance
            t.eta[i] = m.eta
            t.k[i] = m.k
            t.alpha[i] = m.alpha
            t.roughness[i] = m.roughness
            t.ior[i] = m.ior
        return t


@dataclass
class LightTable:
    """All scene lights in one padded struct-of-arrays (max 5 vectors each)."""

    light_type: np.ndarray  # (L,) int32, LT_* codes
    radiance: np.ndarray  # (L,3)
    position: np.ndarray  # (L,3)   point: position; area: center; sphere: center
    direction: np.ndarray  # (L,3)  directional: dirToLight; area: facing direction
    dim_x: np.ndarray  # (L,3)  area: x edge; spot: cone params; sphere: (radius,0,0)
    dim_y: np.ndarray  # (L,3)  area: y edge; mesh: (tri offset, tri count, 0)
    area: np.ndarray  # (L,)   area/mesh: total emitting area
    is_delta: np.ndarray  # (L,) bool
    # mesh-light triangle pool shared by all LT_MESH rows
    mesh_tri: np.ndarray = field(default_factory=lambda: np.zeros((0, 9), np.float32))
    mesh_tri_light: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    mesh_tri_cdf: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))


@dataclass
class FlatScene:
    """World-space scene arrays (host NumPy)."""

    # triangles
    tri_p: np.ndarray  # (T, 3, 3) corner positions
    tri_n: np.ndarray  # (T, 3, 3) corner normals
    tri_bsdf: np.ndarray  # (T,) int32
    # spheres
    sph_center: np.ndarray  # (S, 3)
    sph_radius: np.ndarray  # (S,)
    sph_bsdf: np.ndarray  # (S,) int32
    bsdfs: BSDFTable = None
    lights: LightTable = None
    bbox_min: np.ndarray = field(default_factory=lambda: np.zeros(3))
    bbox_max: np.ndarray = field(default_factory=lambda: np.zeros(3))

    @property
    def num_triangles(self) -> int:
        return len(self.tri_p)

    @property
    def num_spheres(self) -> int:
        return len(self.sph_center)

    def primitive_bboxes(self) -> tuple[np.ndarray, np.ndarray]:
        """Per-primitive AABBs (triangles then spheres)."""
        boxes_min = []
        boxes_max = []
        if self.num_triangles:
            boxes_min.append(self.tri_p.min(axis=1))
            boxes_max.append(self.tri_p.max(axis=1))
        if self.num_spheres:
            r = self.sph_radius[:, None]
            boxes_min.append(self.sph_center - r)
            boxes_max.append(self.sph_center + r)
        lo = np.concatenate(boxes_min) if boxes_min else np.zeros((0, 3))
        hi = np.concatenate(boxes_max) if boxes_max else np.zeros((0, 3))
        return lo, hi


def vertex_normals(vertices: np.ndarray, tris: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals (halfEdgeMesh.h computeNormal) via scatter-add.

    For each triangle the face area vector cross(b-a, c-a) is added to all
    three corner vertices, then normalized.
    """
    a = vertices[tris[:, 0]]
    b = vertices[tris[:, 1]]
    c = vertices[tris[:, 2]]
    face_vec = np.cross(b - a, c - a)
    normals = np.zeros_like(vertices)
    for corner in range(3):
        np.add.at(normals, tris[:, corner], face_vec)
    lens = np.linalg.norm(normals, axis=1, keepdims=True)
    return normals / np.maximum(lens, 1e-30)
