"""The benchmark's own COLLADA writer: the subset ``Renderer.load`` reads, for the config-3 scene.

A frozen, cut-down copy of ``lens_flare_tpu_torch/scene/writer.py:DaeWriter``
(kept here so that the yardstick shares no code with what it measures):
polylist meshes of one vertex array, a profile_COMMON lambert or a CGL
technique per material, CGL lights, a perspective camera placed by a
``<matrix>``.  Numbers are written with 9 significant digits, which a
reader parses back to the same float32 value; the scene's arrays are
float32 before they are written, so the float32 arrays the program loads
are exactly what the reference is given, and what is computed in float64
from the parsed values (vertex normals, transforms) is computed from
:func:`parsed`.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def nums(values) -> str:
    """Numbers as the document holds them (9 significant digits)."""
    return " ".join(f"{float(v):.9g}" for v in np.asarray(values, np.float64).ravel())


def parsed(values) -> np.ndarray:
    """The float64 values a reader parses from :func:`nums` of ``values``."""
    return np.array(nums(values).split(), dtype=np.float64)


class DaeWriter:
    """A COLLADA 1.4 document, Z up (as ``terrain_dae``'s): meshes, materials, lights and one camera, each
    node at the root."""

    def __init__(self):
        self.libs = {k: [] for k in ("cameras", "lights", "effects", "materials", "geometries")}
        self.nodes = []
        self._n = 0

    def _id(self, kind: str) -> str:
        self._n += 1
        return f"{kind}{self._n}"

    @staticmethod
    def _transforms(ops) -> str:
        return "".join(f"<{kind}>{nums(vals)}</{kind}>" for kind, vals in ops)

    def _material(self, mat: dict) -> str:
        eid, mid = self._id("effect"), self._id("material")
        if mat["kind"] == "diffuse":
            body = (f"<profile_COMMON><technique sid=\"common\"><lambert><diffuse><color>"
                    f"{nums(mat['albedo'])} 1</color></diffuse></lambert></technique></profile_COMMON>")
        else:
            fields = "".join(f"<{k}>{nums(v)}</{k}>" for k, v in mat.items() if k != "kind")
            body = f"<extra><technique profile=\"CGL\"><{mat['kind']}>{fields}</{mat['kind']}></technique></extra>"
        self.libs["effects"].append(f"<effect id=\"{eid}\">{body}</effect>")
        self.libs["materials"].append(f"<material id=\"{mid}\"><instance_effect url=\"#{eid}\"/></material>")
        return mid

    def _node(self, inner: str, transforms=()) -> None:
        self.nodes.append(f"<node id=\"{self._id('node')}\">{self._transforms(transforms)}{inner}</node>")

    def mesh(self, vertices, triangles, material: dict) -> None:
        """One polylist of triangles (T, 3) into ``vertices`` (V, 3), no normals: the reader makes them."""
        gid = self._id("geom")
        verts = np.asarray(vertices).reshape(-1, 3)
        tris = np.asarray(triangles, np.int64).reshape(-1, 3)
        self.libs["geometries"].append(
            f"<geometry id=\"{gid}\"><mesh><source id=\"{gid}-pos\"><float_array count=\"{verts.size}\">"
            f"{nums(verts)}</float_array></source><vertices id=\"{gid}-vtx\"><input semantic=\"POSITION\" "
            f"source=\"#{gid}-pos\"/></vertices><polylist count=\"{len(tris)}\"><input semantic=\"VERTEX\" "
            f"source=\"#{gid}-vtx\" offset=\"0\"/><vcount>{' '.join(['3'] * len(tris))}</vcount>"
            f"<p>{' '.join(map(str, tris.ravel()))}</p></polylist></mesh></geometry>")
        mid = self._material(material)
        self._node(f"<instance_geometry url=\"#{gid}\"><bind_material><technique_common><instance_material "
                   f"symbol=\"m\" target=\"#{mid}\"/></technique_common></bind_material></instance_geometry>")

    def light(self, kind: str, color, transforms=()) -> None:
        lid = self._id("light")
        self.libs["lights"].append(f"<light id=\"{lid}\"><extra><technique profile=\"CGL\"><{kind}><color>"
                                   f"{nums(color)}</color></{kind}></technique></extra></light>")
        self._node(f"<instance_light url=\"#{lid}\"/>", transforms)

    def camera(self, xfov: float, yfov: float, znear: float, zfar: float, matrix) -> None:
        cid = self._id("camera")
        persp = "".join(f"<{k}>{nums([v])}</{k}>" for k, v in (("xfov", xfov), ("yfov", yfov), ("znear", znear),
                                                               ("zfar", zfar)))
        self.libs["cameras"].append(f"<camera id=\"{cid}\"><optics><technique_common><perspective>{persp}"
                                    f"</perspective></technique_common></optics></camera>")
        self._node(f"<instance_camera url=\"#{cid}\"/>", [("matrix", matrix)])

    def document(self) -> str:
        libs = "".join(f"<library_{k}>{''.join(v)}</library_{k}>" for k, v in self.libs.items())
        return ("<?xml version=\"1.0\" encoding=\"utf-8\"?>"
                "<COLLADA xmlns=\"http://www.collada.org/2005/11/COLLADASchema\" version=\"1.4.1\">"
                f"<asset><up_axis>Z_UP</up_axis></asset>{libs}"
                f"<library_visual_scenes><visual_scene id=\"scene\">{''.join(self.nodes)}</visual_scene>"
                "</library_visual_scenes><scene><instance_visual_scene url=\"#scene\"/></scene></COLLADA>")

    def write(self, path) -> Path:
        Path(path).write_text(self.document())
        return Path(path)
