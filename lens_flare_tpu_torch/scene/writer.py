"""Scenes written in code: COLLADA documents and an equirect sky.

The corpus of ``.dae`` files is not in the repository, so ``chip_smoke.py``,
the A/B scripts and the tests write what they load: :class:`DaeWriter`
(the subset ``scene/collada.py`` reads), the Cornell box, a terrain file
with a sun on screen, and :func:`sky_map`.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .procedural import make_terrain_scene


def _nums(values) -> str:
    return " ".join(f"{float(v):.9g}" for v in np.asarray(values, np.float64).ravel())


def _transforms(ops) -> str:
    """<translate>/<rotate>/<scale>/<matrix> elements: ops [(kind, values), ...].

    The loader composes a node's elements in document order, each applied
    after the ones before it (``collada.py:parse_node``): list them in the
    order they act on a point (scale, rotate, translate).
    """
    return "".join(f"<{kind}>{_nums(vals)}</{kind}>" for kind, vals in ops)


class DaeWriter:
    """A COLLADA 1.4 document with the subset ``scene/collada.py`` reads.

    Materials: ``{"kind": "diffuse", "albedo": rgb}`` (profile_COMMON
    lambert), or a CGL technique: ``emission`` (radiance), ``mirror``
    (reflectance), ``microfacet`` (alpha, eta, k), ``refraction``
    (transmittance, roughness, ior), ``glass`` (transmittance, reflectance,
    roughness, ior).  Lights: ``ambient``, ``directional``, ``point``,
    ``spot`` (falloff_angle, falloff_exponent) and ``area``, in the CGL
    profile or technique_common.  Every node takes a list of transforms and
    may hold child nodes (``group``).
    """

    def __init__(self, up_axis: str = "Y_UP"):
        self.up_axis = up_axis
        self.libs = {k: [] for k in ("cameras", "lights", "effects", "materials", "geometries")}
        self.nodes = []
        self._n = 0

    def _id(self, kind: str) -> str:
        self._n += 1
        return f"{kind}{self._n}"

    def _material(self, mat) -> str:
        eid, mid = self._id("effect"), self._id("material")
        kind = mat["kind"]
        if kind == "diffuse":
            body = (f"<profile_COMMON><technique sid=\"common\"><lambert><diffuse><color>"
                    f"{_nums(mat['albedo'])} 1</color></diffuse></lambert></technique></profile_COMMON>")
        else:
            fields = "".join(f"<{k}>{_nums(v)}</{k}>" for k, v in mat.items() if k != "kind")
            body = f"<extra><technique profile=\"CGL\"><{kind}>{fields}</{kind}></technique></extra>"
        self.libs["effects"].append(f"<effect id=\"{eid}\">{body}</effect>")
        self.libs["materials"].append(f"<material id=\"{mid}\"><instance_effect url=\"#{eid}\"/></material>")
        return mid

    def _node(self, inner: str, transforms=(), parent=None) -> str:
        node = f"<node id=\"{self._id('node')}\">{_transforms(transforms)}{inner}</node>"
        (self.nodes if parent is None else parent).append(node)
        return node

    def _geometry_node(self, gid, material, transforms, parent):
        bind = ""
        if material is not None:
            mid = self._material(material)
            bind = (f"<bind_material><technique_common><instance_material symbol=\"m\" target=\"#{mid}\"/>"
                    f"</technique_common></bind_material>")
        self._node(f"<instance_geometry url=\"#{gid}\">{bind}</instance_geometry>", transforms, parent)

    def camera(self, xfov=None, yfov=None, aspect_ratio=None, znear=0.01, zfar=1000.0, transforms=(), parent=None):
        cid = self._id("camera")
        persp = "".join(f"<{k}>{v:.9g}</{k}>" for k, v in (("xfov", xfov), ("yfov", yfov), ("aspect_ratio", aspect_ratio),
                                                        ("znear", znear), ("zfar", zfar)) if v is not None)
        self.libs["cameras"].append(
            f"<camera id=\"{cid}\"><optics><technique_common><perspective>{persp}</perspective>"
            f"</technique_common></optics></camera>")
        self._node(f"<instance_camera url=\"#{cid}\"/>", transforms, parent)

    def light(self, kind, color, transforms=(), cgl=True, parent=None, **params):
        lid = self._id("light")
        fields = f"<color>{_nums(color)}</color>" + "".join(f"<{k}>{v:.9g}</{k}>" for k, v in params.items())
        tech = (f"<extra><technique profile=\"CGL\"><{kind}>{fields}</{kind}></technique></extra>" if cgl
                else f"<technique_common><{kind}>{fields}</{kind}></technique_common>")
        self.libs["lights"].append(f"<light id=\"{lid}\">{tech}</light>")
        self._node(f"<instance_light url=\"#{lid}\"/>", transforms, parent)

    def mesh(self, vertices, polygons, material=None, transforms=(), normals=None, triangles=False, parent=None):
        """polygons: vertex index lists (all of 3 with triangles=True); normals (V, 3) share the indices."""
        gid = self._id("geom")
        verts = np.asarray(vertices, np.float64).reshape(-1, 3)
        src = (f"<source id=\"{gid}-pos\"><float_array count=\"{verts.size}\">{_nums(verts)}</float_array></source>")
        inputs = f"<input semantic=\"VERTEX\" source=\"#{gid}-vtx\" offset=\"0\"/>"
        stride = 1
        if normals is not None:
            nrm = np.asarray(normals, np.float64).reshape(-1, 3)
            src += f"<source id=\"{gid}-nrm\"><float_array count=\"{nrm.size}\">{_nums(nrm)}</float_array></source>"
            inputs += f"<input semantic=\"NORMAL\" source=\"#{gid}-nrm\" offset=\"1\"/>"
            stride = 2
        flat = np.concatenate([np.asarray(p, np.int64).ravel() for p in polygons])
        idx = " ".join(map(str, np.repeat(flat, stride)))
        if triangles:
            prim = f"<triangles count=\"{len(polygons)}\">{inputs}<p>{idx}</p></triangles>"
        else:
            vcount = " ".join(str(len(p)) for p in polygons)
            prim = f"<polylist count=\"{len(polygons)}\">{inputs}<vcount>{vcount}</vcount><p>{idx}</p></polylist>"
        self.libs["geometries"].append(
            f"<geometry id=\"{gid}\"><mesh>{src}<vertices id=\"{gid}-vtx\"><input semantic=\"POSITION\" "
            f"source=\"#{gid}-pos\"/></vertices>{prim}</mesh></geometry>")
        self._geometry_node(gid, material, transforms, parent)

    def sphere(self, radius, material=None, transforms=(), parent=None):
        gid = self._id("geom")
        self.libs["geometries"].append(
            f"<geometry id=\"{gid}\"><extra><technique profile=\"CGL\"><sphere><radius>{radius:.9g}</radius>"
            f"</sphere></technique></extra></geometry>")
        self._geometry_node(gid, material, transforms, parent)

    def group(self, transforms=()):
        """A node whose children are added by passing the returned list as ``parent``."""
        children = []
        self.nodes.append((transforms, children))
        return children

    def document(self) -> str:
        def render(node):
            if isinstance(node, str):
                return node
            transforms, children = node
            return f"<node id=\"{self._id('node')}\">{_transforms(transforms)}{''.join(map(render, children))}</node>"

        libs = "".join(f"<library_{k}>{''.join(v)}</library_{k}>" for k, v in self.libs.items())
        nodes = "".join(render(n) for n in self.nodes)
        return ("<?xml version=\"1.0\" encoding=\"utf-8\"?>"
                "<COLLADA xmlns=\"http://www.collada.org/2005/11/COLLADASchema\" version=\"1.4.1\">"
                f"<asset><up_axis>{self.up_axis}</up_axis></asset>{libs}"
                f"<library_visual_scenes><visual_scene id=\"scene\">{nodes}</visual_scene></library_visual_scenes>"
                "<scene><instance_visual_scene url=\"#scene\"/></scene></COLLADA>")

    def write(self, path) -> Path:
        Path(path).write_text(self.document())
        return Path(path)


def cornell_box(light_kinds=("area", "spot", "point", "directional"), spheres=True) -> DaeWriter:
    """A Cornell box open toward +z: diffuse walls (quads, one wall as triangles), a microfacet
    (gold) block, an emitting ceiling panel, mirror and glass spheres, and the lights
    ``light_kinds``; a camera looking in."""
    w = DaeWriter()
    white, red, green = ({"kind": "diffuse", "albedo": c} for c in ((0.73, 0.73, 0.73), (0.63, 0.065, 0.05),
                                                                   (0.14, 0.45, 0.091)))
    quad = [[0, 1, 2, 3]]

    def wall(corners, mat, parent=None, triangles=False):
        polys = [[0, 1, 2], [0, 2, 3]] if triangles else quad
        w.mesh(corners, polys, mat, parent=parent, triangles=triangles)

    wall([[-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1]], white)  # floor
    wall([[-1, 2, -1], [-1, 2, 1], [1, 2, 1], [1, 2, -1]], white)  # ceiling
    wall([[-1, 0, -1], [-1, 2, -1], [1, 2, -1], [1, 0, -1]], white, triangles=True)  # back
    wall([[-1, 0, -1], [-1, 0, 1], [-1, 2, 1], [-1, 2, -1]], red)  # left
    wall([[1, 0, -1], [1, 2, -1], [1, 2, 1], [1, 0, 1]], green)  # right
    # a gold block, nested: the child scales it, the group turns and places it
    block = w.group([("rotate", (0, 1, 0, 20)), ("translate", (-0.35, 0.0, -0.3))])
    cube = [[-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1], [-1, 2, -1], [1, 2, -1], [1, 2, 1], [-1, 2, 1]]
    # no bottom face: one on the floor's plane would have no defined closest hit
    faces = [[4, 7, 6, 5], [0, 4, 5, 1], [1, 5, 6, 2], [2, 6, 7, 3], [3, 7, 4, 0]]
    w.mesh(cube, faces, {"kind": "microfacet", "alpha": 0.25, "eta": (0.143, 0.375, 1.442),
                         "k": (3.983, 2.386, 1.603)},
           transforms=[("scale", (0.25, 0.35, 0.25))], parent=block)
    # an emitting panel on the ceiling: what -H (hemisphere direct light) sees
    w.mesh([[0.35, 1.995, -0.75], [0.35, 1.995, -0.45], [0.75, 1.995, -0.45], [0.75, 1.995, -0.75]], quad,
           {"kind": "emission", "radiance": (5.0, 4.6, 4.0)})
    if spheres:
        w.sphere(0.3, {"kind": "mirror", "reflectance": (0.95, 0.95, 0.95)}, [("translate", (0.45, 0.3, -0.35))])
        w.sphere(0.25, {"kind": "glass", "transmittance": (1, 1, 1), "reflectance": (1, 1, 1), "roughness": 0,
                        "ior": 1.5}, [("translate", (0.3, 0.25, 0.45))])
    if "area" in light_kinds:  # facing down, just under the ceiling, 0.5 x 0.5
        w.light("area", (6, 6, 6), [("scale", (0.5, 0.5, 0.5)), ("rotate", (1, 0, 0, -90)),
                                    ("translate", (0, 1.98, 0))])
    if "spot" in light_kinds:  # down and toward the back wall
        w.light("spot", (3, 2.6, 2), [("rotate", (1, 0, 0, -70)), ("translate", (0.6, 1.7, 0.6))],
                falloff_angle=40.0, falloff_exponent=2.0)
    if "point" in light_kinds:
        w.light("point", (0.6, 0.6, 0.8), [("translate", (-0.5, 1.5, 0.7))], cgl=False)
    if "directional" in light_kinds:  # a sun above and in front of the open side
        w.light("directional", (0.5, 0.45, 0.4), [("rotate", (1, 0, 0, 150)), ("rotate", (0, 1, 0, 20))],
                cgl=False)
    if "ambient" in light_kinds:
        w.light("ambient", (0.05, 0.05, 0.06), cgl=False)
    w.camera(xfov=50.0, yfov=40.0, znear=0.01, zfar=100.0, transforms=[("rotate", (0, 1, 0, 180))])
    return w



def terrain_dae(n_quads: int) -> DaeWriter:
    """Terrain ``n_quads`` (``make_terrain_scene``'s heightfield, z up) as four polylists by quadrant:
    diffuse, microfacet (copper), mirror and glass; a directional sun, a 4 x 4 area light facing
    down from z = 6, and a camera (a <matrix>) looking down at it from above one corner."""
    tri_p = make_terrain_scene(n_quads).tri_p
    verts, inverse = np.unique(tri_p.reshape(-1, 3), axis=0, return_inverse=True)
    tris = inverse.reshape(-1, 3)
    centre = tri_p.mean(axis=1)
    quadrant = (centre[:, 0] > 0).astype(np.int64) + 2 * (centre[:, 1] > 0)
    mats = [
        {"kind": "diffuse", "albedo": (0.55, 0.45, 0.32)},
        {"kind": "microfacet", "alpha": 0.3, "eta": (0.2, 0.92, 1.1), "k": (3.9, 2.45, 2.14)},
        {"kind": "mirror", "reflectance": (0.9, 0.9, 0.9)},
        {"kind": "glass", "transmittance": (1, 1, 1), "reflectance": (1, 1, 1), "roughness": 0, "ior": 1.5},
    ]
    w = DaeWriter(up_axis="Z_UP")
    for q, mat in enumerate(mats):
        w.mesh(verts, tris[quadrant == q], mat)
    w.light("directional", (1.3, 1.1, 0.65), [("rotate", (1, 0, 0, 140)), ("rotate", (0, 0, 1, 40))])
    w.light("area", (4, 4, 3.6), [("scale", (4, 4, 4)), ("translate", (0, 0, 6))])
    view = np.array([0.612, 0.5, 0.612])  # from the target toward the camera
    view /= np.linalg.norm(view)
    x = np.cross([0.0, 0.0, 1.0], view)
    x /= np.linalg.norm(x)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2] = x, np.cross(view, x), -view  # (0, 0, -1) -> view
    w.camera(xfov=35.0, yfov=20.0, znear=0.01, zfar=1000.0, transforms=[("matrix", m)])
    return w



def sky_map(width: int, height: int, peak: float = 6e4):
    """An equirect sky (H, W, 3) float32: a zenith-to-horizon blue gradient, a dim ground below the
    horizon and a sun disk of 2 degrees radius at ``peak`` (6e4 stays within HALF's 65504)."""
    theta = np.pi * (np.arange(height) + 0.5) / height  # from +y
    phi = 2.0 * np.pi * (np.arange(width) + 0.5) / width
    t = np.clip(theta / (np.pi / 2), 0.0, 1.0)[:, None, None]
    sky = (1.0 - t) * np.array([0.25, 0.45, 1.0]) + t * np.array([0.9, 0.95, 1.0])
    sky = np.where((theta > np.pi / 2)[:, None, None], np.array([0.3, 0.25, 0.2]), sky)
    sky = np.broadcast_to(sky, (height, width, 3)).copy()
    # the envlight convention: (theta, phi) -> (cos(phi - pi) sin(theta), cos(theta), -sin(phi - pi) sin(theta))
    st = np.sin(theta)[:, None]
    dirs = np.stack(np.broadcast_arrays(np.cos(phi - np.pi)[None, :] * st, np.cos(theta)[:, None],
                                        -np.sin(phi - np.pi)[None, :] * st), axis=-1)
    sun = np.array([0.45, 0.75, -0.48])
    sky[dirs @ (sun / np.linalg.norm(sun)) > np.cos(np.radians(2.0))] = peak
    return sky.astype(np.float32)
