"""Scene flattening: parsed COLLADA nodes -> contiguous arrays for the device.

Counterpart of ``lens_flare_tpu/scene/build.py``, a copy (the port imports
nothing of the JAX package): the same ``SceneInfo`` gives the same
``FlatScene``, ``LightTable`` and ``BSDFTable``.  It collapses the reference's editable GL scene layer (``src/scene/gl_scene``) —
the new pipeline goes straight from parsed nodes to flat world-space arrays:

- meshes: world-transformed vertices (``gl_scene/mesh.cpp:29-32``),
  area-weighted vertex normals computed with scatter-adds instead of the
  halfedge walk (``halfEdgeMesh.h computeNormal``), triangles as index-free
  (T, 3, 3) corner arrays
- spheres: center = transform @ origin, radius scaled by |transform @ e_x|
  (``application.cpp:init_sphere``)
- lights: the gl_scene adapter quirks are reproduced exactly, most notably
  the directional light's flare position
  posLight = transform @ (0,0,-1,1) as a *point* transform
  (``gl_scene/directional_light.h:17-24``, ``light.cpp:11-17``)
- materials: one row per unique BSDF in a struct-of-arrays table
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import collada
from .collada import (
    BSDF_DIFFUSE,
    BSDF_EMISSION,
    LIGHT_AMBIENT,
    LIGHT_AREA,
    LIGHT_DIRECTIONAL,
    LIGHT_POINT,
    LIGHT_SPOT,
    MaterialInfo,
    SceneInfo,
)

# Light type codes in the flattened table (integrator/lights.py dispatches on these)
LT_HEMISPHERE = 0
LT_DIRECTIONAL = 1
LT_POINT = 2
LT_AREA = 3
LT_SPOT = 5  # (4 = LT_ENV, defined in integrator.lights)
LT_SPHERE = 6  # SphereLight (light.h:101-112; sample_L stub light.cpp:99-109)
LT_MESH = 7  # MeshLight (light.h:116-126; sample_L stub light.cpp:111-118)


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
    # mesh-light triangle pool shared by all LT_MESH rows: world-space
    # [p0 (3), e1 (3), e2 (3)] with per-tri owning light and in-light
    # cumulative area fraction
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
        """Per-primitive AABBs (triangles then spheres) for BVH build."""
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


def transform_points(m: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Apply a 4x4 to (N,3) points with perspective divide (Vector4D::projectTo3D)."""
    h = pts @ m[:3, :3].T + m[:3, 3]
    w = pts @ m[3, :3] + m[3, 3]
    return h / w[:, None]


def vertex_normals(vertices: np.ndarray, tris: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals (halfEdgeMesh.h computeNormal) via scatter-add.

    For each triangle the face area vector cross(b-a, c-a) is added to all
    three corner vertices, then normalized — identical to the halfedge
    area-weighted average for interior vertices.
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


def build_scene(info: SceneInfo) -> FlatScene:
    materials: list[MaterialInfo] = []

    def add_material(m: MaterialInfo | None) -> int:
        if m is None:
            m = MaterialInfo()  # default diffuse 0.5 (gl_scene/mesh.cpp:40)
        materials.append(m)
        return len(materials) - 1

    tri_p, tri_n, tri_b = [], [], []
    for mesh in info.meshes:
        bsdf_id = add_material(mesh.material)
        verts = transform_points(mesh.transform, np.asarray(mesh.vertices, dtype=np.float64))
        # fan-triangulate polygons (corpus scenes are all triangles already)
        tris = []
        for v_idx, _n_idx in mesh.polygons:
            for k in range(1, len(v_idx) - 1):
                tris.append((v_idx[0], v_idx[k], v_idx[k + 1]))
        tris = np.asarray(tris, dtype=np.int64)
        normals = vertex_normals(verts, tris)
        tri_p.append(verts[tris])  # (T, 3, 3)
        tri_n.append(normals[tris])
        tri_b.append(np.full(len(tris), bsdf_id, np.int32))

    sph_c, sph_r, sph_b = [], [], []
    for sph in info.spheres:
        bsdf_id = add_material(sph.material)
        center = transform_points(sph.transform, np.zeros((1, 3)))[0]
        scale = np.linalg.norm(sph.transform[:3, :3] @ np.array([1.0, 0.0, 0.0]))
        sph_c.append(center)
        sph_r.append(sph.radius * scale)
        sph_b.append(bsdf_id)

    lights = _build_lights(info)

    scene = FlatScene(
        tri_p=np.concatenate(tri_p).astype(np.float32) if tri_p else np.zeros((0, 3, 3), np.float32),
        tri_n=np.concatenate(tri_n).astype(np.float32) if tri_n else np.zeros((0, 3, 3), np.float32),
        tri_bsdf=np.concatenate(tri_b) if tri_b else np.zeros(0, np.int32),
        sph_center=np.asarray(sph_c, np.float32).reshape(-1, 3),
        sph_radius=np.asarray(sph_r, np.float32).reshape(-1),
        sph_bsdf=np.asarray(sph_b, np.int32).reshape(-1),
        bsdfs=BSDFTable.from_materials(materials),
        lights=lights,
    )
    lo, hi = scene.primitive_bboxes()
    if len(lo):
        scene.bbox_min = lo.min(axis=0).astype(np.float64)
        scene.bbox_max = hi.max(axis=0).astype(np.float64)
    return scene


def _build_lights(info: SceneInfo) -> LightTable:
    rows = []
    for li in info.lights:
        t = li.transform
        if li.light_type == LIGHT_AMBIENT:
            rows.append(
                dict(light_type=LT_HEMISPHERE, radiance=li.spectrum, is_delta=False)
            )
        elif li.light_type == LIGHT_DIRECTIONAL:
            # gl_scene/directional_light.h:17-24 + light.cpp:11-17 double negation:
            # pos_light = transform @ (0,0,-1) as a POINT; dirToLight = unit(pos_light)
            pos_light = transform_points(t, np.array([[0.0, 0.0, -1.0]]))[0]
            dir_to_light = pos_light / np.linalg.norm(pos_light)
            rows.append(
                dict(
                    light_type=LT_DIRECTIONAL,
                    radiance=li.spectrum,
                    position=pos_light,
                    direction=dir_to_light,
                    is_delta=True,
                )
            )
        elif li.light_type == LIGHT_POINT:
            pos = transform_points(t, li.position[None])[0]
            rows.append(
                dict(light_type=LT_POINT, radiance=li.spectrum, position=pos, is_delta=True)
            )
        elif li.light_type == LIGHT_AREA:
            # gl_scene/area_light.h:14-27
            pos = transform_points(t, li.position[None])[0]
            direction = transform_points(t, (li.position + li.direction)[None])[0] - pos
            direction /= np.linalg.norm(direction)
            dx0 = np.cross(li.up, li.direction)
            dim_x = transform_points(t, dx0[None])[0] - pos
            dim_y = transform_points(t, li.up[None])[0] - pos
            rows.append(
                dict(
                    light_type=LT_AREA,
                    radiance=li.spectrum,
                    position=pos,
                    direction=direction,
                    dim_x=dim_x,
                    dim_y=dim_y,
                    area=np.linalg.norm(dim_x) * np.linalg.norm(dim_y),
                    is_delta=False,
                )
            )
        elif li.light_type == LIGHT_SPOT:
            # The reference declares SpotLight but its sample_L is an empty
            # stub (light.cpp:63-71).  Implemented properly here: point light
            # with a smooth cone falloff (falloff_angle, falloff_exponent).
            pos = transform_points(t, li.position[None])[0]
            direction = transform_points(t, (li.position + li.direction)[None])[0] - pos
            direction /= np.linalg.norm(direction)
            rows.append(
                dict(
                    light_type=LT_SPOT,
                    radiance=li.spectrum,
                    position=pos,
                    direction=direction,
                    # stash cone params in dim_x: (cos(falloff), exponent, 0)
                    dim_x=np.array(
                        [
                            np.cos(np.radians(getattr(li, "falloff_deg", 45.0) or 45.0)),
                            getattr(li, "falloff_exp", 1.0) or 1.0,
                            0.0,
                        ]
                    ),
                    is_delta=True,
                )
            )

    n = len(rows)
    table = LightTable(
        light_type=np.zeros(n, np.int32),
        radiance=np.zeros((n, 3), np.float32),
        position=np.zeros((n, 3), np.float32),
        direction=np.zeros((n, 3), np.float32),
        dim_x=np.zeros((n, 3), np.float32),
        dim_y=np.zeros((n, 3), np.float32),
        area=np.zeros(n, np.float32),
        is_delta=np.zeros(n, bool),
    )
    for i, row in enumerate(rows):
        table.light_type[i] = row["light_type"]
        table.radiance[i] = row["radiance"]
        table.position[i] = row.get("position", np.zeros(3))
        table.direction[i] = row.get("direction", np.zeros(3))
        table.dim_x[i] = row.get("dim_x", np.zeros(3))
        table.dim_y[i] = row.get("dim_y", np.zeros(3))
        table.area[i] = row.get("area", 0.0)
        table.is_delta[i] = row["is_delta"]
    return table


def _append_light_row(table: LightTable, **row) -> int:
    """Append one light row (grows every column array); returns its index."""
    i = len(table.light_type)
    table.light_type = np.append(table.light_type, row["light_type"]).astype(np.int32)
    table.radiance = np.vstack([table.radiance, np.asarray(row["radiance"], np.float32)])
    table.position = np.vstack(
        [table.position, np.asarray(row.get("position", np.zeros(3)), np.float32)]
    )
    table.direction = np.vstack(
        [table.direction, np.asarray(row.get("direction", np.zeros(3)), np.float32)]
    )
    table.dim_x = np.vstack(
        [table.dim_x, np.asarray(row.get("dim_x", np.zeros(3)), np.float32)]
    )
    table.dim_y = np.vstack(
        [table.dim_y, np.asarray(row.get("dim_y", np.zeros(3)), np.float32)]
    )
    table.area = np.append(table.area, row.get("area", 0.0)).astype(np.float32)
    table.is_delta = np.append(table.is_delta, row["is_delta"])
    return i


def add_sphere_light(table: LightTable, center, radius: float, radiance) -> int:
    """Proper SphereLight (reference stub light.cpp:99-109): emitting sphere
    sampled uniformly over its subtended solid-angle cone."""
    return _append_light_row(
        table,
        light_type=LT_SPHERE,
        radiance=radiance,
        position=np.asarray(center, np.float32),
        dim_x=np.array([radius, 0.0, 0.0], np.float32),
        is_delta=False,
    )


def add_mesh_light(table: LightTable, tri_p, radiance) -> int:
    """Proper MeshLight (reference stub light.cpp:111-118): emitting triangle
    mesh, sampled uniformly by area (per-tri CDF + uniform barycentrics).

    tri_p: (M, 3, 3) world-space triangle corners.
    """
    tri_p = np.asarray(tri_p, np.float32)
    p0 = tri_p[:, 0]
    e1 = tri_p[:, 1] - tri_p[:, 0]
    e2 = tri_p[:, 2] - tri_p[:, 0]
    areas = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
    total = float(areas.sum())
    if total <= 0:
        raise ValueError("mesh light has zero area")
    offset = len(table.mesh_tri)
    li = _append_light_row(
        table,
        light_type=LT_MESH,
        radiance=radiance,
        position=tri_p.reshape(-1, 3).mean(axis=0),
        dim_y=np.array([offset, len(tri_p), 0.0], np.float32),
        area=total,
        is_delta=False,
    )
    table.mesh_tri = np.vstack(
        [table.mesh_tri, np.concatenate([p0, e1, e2], axis=1).astype(np.float32)]
    )
    table.mesh_tri_light = np.append(
        table.mesh_tri_light, np.full(len(tri_p), li, np.int32)
    )
    table.mesh_tri_cdf = np.append(
        table.mesh_tri_cdf, (np.cumsum(areas) / total).astype(np.float32)
    )
    return li


def load_scene(path) -> tuple[FlatScene, SceneInfo]:
    info = collada.load_dae(path)
    return build_scene(info), info
