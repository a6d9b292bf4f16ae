"""The config-1 scene, made from the seed: the Cornell box with a mirror and a glass sphere under four light kinds.

Laid out as ``lens_flare_tpu_torch/scene/writer.py:cornell_box`` lays it
out (Y up): white floor, ceiling and back wall, a red and a green side
wall (quads, the back wall as ``<triangles>``), a microfacet gold block
(five quads), an emitting panel under the ceiling, a mirror and a glass
sphere (CGL ``<sphere>`` geometries), an area light and a spot light (its
falloff angle and exponent) in the CGL profile, a point and a directional
light in ``technique_common``, and a camera turned 180 degrees about y.
The block is one node (scale, rotate, translate) where ``cornell_box``
nests it in a group.  Drawn from the seed: the two spheres' centres on the
floor, clear of the walls, the block's footprint and each other, and the
block's turn about y.

:func:`make` returns the host arrays both sides are given; :func:`write`
writes the ``.dae`` the program loads.  What the program makes of the file
is worked out here again from the numbers written, with frozen copies of
the loader's rules (``scene/collada.py``: transforms composed in document
order; ``scene/build.py``: polygons fanned into triangles, area-weighted
vertex normals per mesh, a sphere's centre and scaled radius, the light
table, the bounding box; the camera's bbox orbit of
``scene/camera.py:place_from_scene_info``), never from the program's parse.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from . import dae_writer
from .driver import rng_for
from .scene import LT_DIRECTIONAL, LT_POINT, vertex_normals
from .sky_scene import node_transform, transform_points

LT_AREA, LT_SPOT = 3, 5
BSDF = {"diffuse": 0, "emission": 1, "mirror": 2, "microfacet": 3, "glass": 5}
CUBE = [[-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1], [-1, 2, -1], [1, 2, -1], [1, 2, 1], [-1, 2, 1]]
# no bottom face: one on the floor's plane would have no defined closest hit
CUBE_FACES = [[4, 7, 6, 5], [0, 4, 5, 1], [1, 5, 6, 2], [2, 6, 7, 3], [3, 7, 4, 0]]
QUAD = [[0, 1, 2, 3]]


@dataclass
class CornellScene:
    """Host arrays of the config-1 scene, as the program holds them after ``Renderer.load``."""

    meshes: list  # (vertices, polygons, material, transforms, as <triangles>) in document order
    spheres: list  # (radius, material, centre) in document order
    lights: list  # the light dicts the file holds
    tri_p: np.ndarray  # (T, 3, 3) float32 corners, the meshes one after another
    tri_n: np.ndarray  # (T, 3, 3) float32 area-weighted vertex normals of each mesh
    tri_bsdf: np.ndarray  # (T,) int64 material row: one row per mesh, then one per sphere
    sph_center: np.ndarray  # (S, 3) float32
    sph_radius: np.ndarray  # (S,) float32
    sph_bsdf: np.ndarray  # (S,) int64
    materials: list  # the material dict of each row
    light_type: np.ndarray  # (L,) int32, in the file's order
    light_radiance: np.ndarray  # (L, 3) float32
    light_position: np.ndarray  # (L, 3) float32: point, spot, area centre; the sun's flare point
    light_direction: np.ndarray  # (L, 3) float32: dirToLight (sun); facing (area, spot)
    light_dim_x: np.ndarray  # (L, 3) float32: area x edge; spot (cos falloff, exponent, 0)
    light_dim_y: np.ndarray  # (L, 3) float32
    light_area: np.ndarray  # (L,) float32
    camera: dict  # xfov, yfov, znear, zfar, the transforms as written and the 4x4 transform parsed
    bbox_min: np.ndarray  # (3,) float64
    bbox_max: np.ndarray


class CornellWriter(dae_writer.DaeWriter):
    """The benchmark's COLLADA writer with what the box adds: polygons of any size or a ``<triangles>``
    list under a node's transforms, CGL spheres, light parameters (the spot's falloff) and lights in
    ``technique_common``, a camera placed by transforms, and the Y up axis."""

    def polygons(self, vertices, polygons, material: dict, transforms=(), triangles: bool = False) -> None:
        gid = self._id("geom")
        verts = np.asarray(vertices, np.float64).reshape(-1, 3)
        inputs = f"<input semantic=\"VERTEX\" source=\"#{gid}-vtx\" offset=\"0\"/>"
        idx = " ".join(str(int(i)) for p in polygons for i in p)
        if triangles:
            prim = f"<triangles count=\"{len(polygons)}\">{inputs}<p>{idx}</p></triangles>"
        else:
            vcount = " ".join(str(len(p)) for p in polygons)
            prim = f"<polylist count=\"{len(polygons)}\">{inputs}<vcount>{vcount}</vcount><p>{idx}</p></polylist>"
        self.libs["geometries"].append(
            f"<geometry id=\"{gid}\"><mesh><source id=\"{gid}-pos\"><float_array count=\"{verts.size}\">"
            f"{dae_writer.nums(verts)}</float_array></source><vertices id=\"{gid}-vtx\"><input semantic=\"POSITION\" "
            f"source=\"#{gid}-pos\"/></vertices>{prim}</mesh></geometry>")
        self._instance(gid, material, transforms)

    def sphere(self, radius: float, material: dict, transforms=()) -> None:
        gid = self._id("geom")
        self.libs["geometries"].append(
            f"<geometry id=\"{gid}\"><extra><technique profile=\"CGL\"><sphere><radius>{dae_writer.nums([radius])}"
            f"</radius></sphere></technique></extra></geometry>")
        self._instance(gid, material, transforms)

    def _instance(self, gid: str, material: dict, transforms) -> None:
        mid = self._material(material)
        self._node(f"<instance_geometry url=\"#{gid}\"><bind_material><technique_common><instance_material "
                   f"symbol=\"m\" target=\"#{mid}\"/></technique_common></bind_material></instance_geometry>",
                   transforms)

    def light(self, kind: str, color, transforms=(), cgl: bool = True, **params) -> None:
        lid = self._id("light")
        fields = f"<color>{dae_writer.nums(color)}</color>" + "".join(
            f"<{k}>{dae_writer.nums([v])}</{k}>" for k, v in params.items())
        tech = (f"<extra><technique profile=\"CGL\"><{kind}>{fields}</{kind}></technique></extra>" if cgl
                else f"<technique_common><{kind}>{fields}</{kind}></technique_common>")
        self.libs["lights"].append(f"<light id=\"{lid}\">{tech}</light>")
        self._node(f"<instance_light url=\"#{lid}\"/>", transforms)

    def placed_camera(self, xfov: float, yfov: float, znear: float, zfar: float, transforms) -> None:
        """A perspective camera on a node of ``transforms`` (the base class's ``camera`` takes a matrix)."""
        cid = self._id("camera")
        persp = "".join(f"<{k}>{dae_writer.nums([v])}</{k}>" for k, v in (("xfov", xfov), ("yfov", yfov),
                                                                         ("znear", znear), ("zfar", zfar)))
        self.libs["cameras"].append(f"<camera id=\"{cid}\"><optics><technique_common><perspective>{persp}"
                                    f"</perspective></technique_common></optics></camera>")
        self._node(f"<instance_camera url=\"#{cid}\"/>", transforms)

    def document(self) -> str:
        return super().document().replace("<up_axis>Z_UP</up_axis>", "<up_axis>Y_UP</up_axis>")


# -- the seeded parts --------------------------------------------------------------


def block_footprint(cfg: dict) -> float:
    """The radius about the block's centre on the floor that its footprint stays within at any turn."""
    sx, _, sz = cfg["block"]["scale"]
    return math.hypot(sx, sz)


def draw(cfg: dict, seed: int) -> tuple[float, list]:
    """(the block's turn in degrees, the spheres' floor centres [(x, y, z), ...]) drawn from ``seed``: each
    centre uniform over the floor's square less its radius and the clearance, redrawn until it keeps the
    clearance from the block's footprint and from the spheres placed before it."""
    g = rng_for(seed, 6)
    lo, hi = cfg["block"]["turn_deg"]
    turn = lo + (hi - lo) * float(g.random())
    gap = float(cfg["clearance"])
    bx, _, bz = cfg["block"]["translate"]
    foot = block_footprint(cfg)
    placed = []
    for s in cfg["spheres"]:
        r = float(s["radius"])
        edge = 1.0 - r - gap
        for _ in range(10_000):
            x, z = (float(v) for v in g.uniform(-edge, edge, size=2))
            if math.hypot(x - bx, z - bz) < foot + r + gap:
                continue
            if any(math.hypot(x - px, z - pz) < r + pr + gap for px, _, pz, pr in placed):
                continue
            break
        else:
            raise RuntimeError("no free place on the floor for the spheres")
        placed.append((x, r, z, r))
    return turn, [(x, y, z) for x, y, z, _ in placed]


# -- the loader's rules, frozen ------------------------------------------------------


def fan(polygons, triangles: bool) -> np.ndarray:
    """The loader's triangles of a mesh: a polygon (v0, v1, ..., vn) fanned into (v0, vk, vk+1)."""
    tris = [(p[0], p[k], p[k + 1]) for p in polygons for k in range(1, len(p) - 1)]
    return np.asarray(tris, np.int64)


def light_rows(lights: list) -> dict:
    """The light table the loader builds from the file's lights (``scene/build.py:_build_lights``):
    point and spot lights at their transform of the origin, a spot facing its transform of (0, 0, -1)
    with (cos falloff, exponent, 0) in ``dim_x``; a directional light's flare point its transform of
    (0, 0, -1) as a point, dirToLight that point made unit; an area light's centre, facing and edges
    its transforms of the origin, (0, 0, -1) and the edges (-1, 0, 0) and (0, 1, 0)."""
    n = len(lights)
    out = {k: np.zeros((n, 3), np.float32) for k in ("radiance", "position", "direction", "dim_x", "dim_y")}
    out["type"], out["area"] = np.zeros(n, np.int32), np.zeros(n, np.float32)
    origin, facing, up = np.zeros(3), np.array([0.0, 0.0, -1.0]), np.array([0.0, 1.0, 0.0])
    for i, li in enumerate(lights):
        t = node_transform(li["transforms"])
        out["radiance"][i] = dae_writer.parsed(li["color"])
        pos = transform_points(t, origin[None])[0]
        facing_w = transform_points(t, (origin + facing)[None])[0] - pos
        if li["kind"] == "directional":
            flare = transform_points(t, facing[None])[0]
            out["type"][i], out["position"][i], out["direction"][i] = LT_DIRECTIONAL, flare, flare / np.linalg.norm(flare)
        elif li["kind"] == "point":
            out["type"][i], out["position"][i] = LT_POINT, pos
        elif li["kind"] == "spot":
            angle = dae_writer.parsed([li["falloff_angle"]])[0]
            exponent = dae_writer.parsed([li["falloff_exponent"]])[0]
            out["type"][i], out["position"][i] = LT_SPOT, pos
            out["direction"][i] = facing_w / np.linalg.norm(facing_w)
            out["dim_x"][i] = [np.cos(np.radians(angle)), exponent, 0.0]
        elif li["kind"] == "area":
            dim_x = transform_points(t, np.cross(up, facing)[None])[0] - pos
            dim_y = transform_points(t, up[None])[0] - pos
            out["type"][i], out["position"][i] = LT_AREA, pos
            out["direction"][i] = facing_w / np.linalg.norm(facing_w)
            out["dim_x"][i], out["dim_y"][i] = dim_x, dim_y
            out["area"][i] = np.linalg.norm(dim_x) * np.linalg.norm(dim_y)
        else:
            raise ValueError(f"the config-1 scene holds area, spot, point and directional lights, not {li['kind']!r}")
    return out


def make(cfg: dict, seed: int) -> CornellScene:
    """The scene of a configuration's ``scene`` under ``seed``."""
    turn, centres = draw(cfg, seed)
    w = cfg["walls"]
    walls = [  # floor, ceiling, back (as <triangles>), left, right
        ([[-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1]], QUAD, w["white"], (), False),
        ([[-1, 2, -1], [-1, 2, 1], [1, 2, 1], [1, 2, -1]], QUAD, w["white"], (), False),
        ([[-1, 0, -1], [-1, 2, -1], [1, 2, -1], [1, 0, -1]], [[0, 1, 2], [0, 2, 3]], w["white"], (), True),
        ([[-1, 0, -1], [-1, 0, 1], [-1, 2, 1], [-1, 2, -1]], QUAD, w["red"], (), False),
        ([[1, 0, -1], [1, 2, -1], [1, 2, 1], [1, 0, 1]], QUAD, w["green"], (), False),
    ]
    b = cfg["block"]
    block = (CUBE, CUBE_FACES, b["material"],
             (("scale", b["scale"]), ("rotate", [0, 1, 0, turn]), ("translate", b["translate"])), False)
    emitter = (cfg["emitter"]["corners"], QUAD, cfg["emitter"]["material"], (), False)
    meshes = walls + [block, emitter]
    spheres = [(float(s["radius"]), s["material"], c) for s, c in zip(cfg["spheres"], centres)]

    ps, ns, bs = [], [], []
    for row, (verts, polys, _, transforms, tri) in enumerate(meshes):
        v = transform_points(node_transform(transforms), dae_writer.parsed(verts).reshape(-1, 3))
        tris = fan(polys, tri)
        ps.append(v[tris])
        ns.append(vertex_normals(v, tris)[tris])
        bs.append(np.full(len(tris), row, np.int64))
    centre, radius = [], []
    for r, _, c in spheres:
        t = node_transform([("translate", c)])
        centre.append(transform_points(t, np.zeros((1, 3)))[0])
        radius.append(dae_writer.parsed([r])[0] * np.linalg.norm(t[:3, :3] @ np.array([1.0, 0.0, 0.0])))
    tri_p = np.concatenate(ps).astype(np.float32)
    sph_center = np.asarray(centre, np.float32).reshape(-1, 3)
    sph_radius = np.asarray(radius, np.float32)
    lo = np.concatenate([tri_p.min(axis=1), sph_center - sph_radius[:, None]])
    hi = np.concatenate([tri_p.max(axis=1), sph_center + sph_radius[:, None]])
    rows = light_rows(cfg["lights"])
    cam = cfg["camera"]
    return CornellScene(
        meshes=meshes, spheres=spheres, lights=cfg["lights"],
        tri_p=tri_p, tri_n=np.concatenate(ns).astype(np.float32), tri_bsdf=np.concatenate(bs),
        sph_center=sph_center, sph_radius=sph_radius,
        sph_bsdf=np.arange(len(meshes), len(meshes) + len(spheres), dtype=np.int64),
        materials=[m for _, _, m, _, _ in meshes] + [m for _, m, _ in spheres],
        light_type=rows["type"], light_radiance=rows["radiance"], light_position=rows["position"],
        light_direction=rows["direction"], light_dim_x=rows["dim_x"], light_dim_y=rows["dim_y"],
        light_area=rows["area"],
        camera={"xfov": float(cam["xfov"]), "yfov": float(cam["yfov"]), "znear": float(cam["znear"]),
                "zfar": float(cam["zfar"]), "transforms": cam["transforms"],
                "transform": node_transform(cam["transforms"])},
        bbox_min=lo.min(axis=0).astype(np.float64), bbox_max=hi.max(axis=0).astype(np.float64),
    )


def write(scene: CornellScene, out_dir) -> Path:
    """The scene's ``.dae`` under ``out_dir``."""
    w = CornellWriter()
    for verts, polys, mat, transforms, tri in scene.meshes:
        w.polygons(verts, polys, mat, transforms, triangles=tri)
    for r, mat, c in scene.spheres:
        w.sphere(r, mat, [("translate", c)])
    for li in scene.lights:
        params = {k: li[k] for k in ("falloff_angle", "falloff_exponent") if k in li}
        w.light(li["kind"], li["color"], li["transforms"], cgl=li["cgl"], **params)
    c = scene.camera
    w.placed_camera(c["xfov"], c["yfov"], c["znear"], c["zfar"], c["transforms"])
    return w.write(Path(out_dir) / "scene.dae")
