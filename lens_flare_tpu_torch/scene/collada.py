"""Pure-Python COLLADA (.dae) subset parser.

Counterpart of ``lens_flare_tpu/scene/collada.py``, a copy (the port
imports nothing of the JAX package): the same file gives the same
``SceneInfo``.  It replaces the reference's tinyxml2-based ``ColladaParser``
(``src/scene/collada/collada.cpp``) with ``xml.etree`` over the same subset of
tags: visual-scene node hierarchies with matrix/rotate/translate/scale
transforms, perspective cameras, 5 light types (with the custom "CGL profile"
<extra><technique profile="CGL"> blocks taking precedence over
technique_common), polylist/triangles meshes (POSITION + NORMAL + TEXCOORD),
analytic spheres, and CGL-profile materials
(emission/mirror/microfacet/refraction/glass + common-profile
lambert/phong diffuse) — collada.cpp:236-954.

Output is a flat list of instanced nodes with world transforms, mirroring
``SceneInfo{nodes}``; array conversion happens in :mod:`lens_flare_tpu_torch.scene.build`.
"""

from __future__ import annotations

import math
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field

import numpy as np

NS = "{http://www.collada.org/2005/11/COLLADASchema}"

# Light types (collada/light_info.h)
LIGHT_NONE = 0
LIGHT_AMBIENT = 1
LIGHT_DIRECTIONAL = 2
LIGHT_AREA = 3
LIGHT_POINT = 4
LIGHT_SPOT = 5

# BSDF families (bsdf.h:119-288); indices shared with the shading tables.
BSDF_DIFFUSE = 0
BSDF_EMISSION = 1
BSDF_MIRROR = 2
BSDF_MICROFACET = 3
BSDF_REFRACTION = 4
BSDF_GLASS = 5


@dataclass
class CameraInfo:
    """Perspective camera (collada/camera_info.h); FOVs in degrees."""

    h_fov: float = 50.0
    v_fov: float = 35.0
    n_clip: float = 0.001
    f_clip: float = 1000.0
    transform: np.ndarray = field(default_factory=lambda: np.eye(4))
    # default look direction, down -z (collada.cpp:441-443)
    view_dir: np.ndarray = field(default_factory=lambda: np.array([0.0, 0.0, -1.0]))


@dataclass
class LightInfo:
    """One light instance (collada/light_info.h defaults)."""

    light_type: int = LIGHT_NONE
    spectrum: np.ndarray = field(default_factory=lambda: np.ones(3))
    position: np.ndarray = field(default_factory=lambda: np.zeros(3))
    direction: np.ndarray = field(default_factory=lambda: np.array([0.0, 0.0, -1.0]))
    up: np.ndarray = field(default_factory=lambda: np.array([0.0, 1.0, 0.0]))
    constant_att: float = 1.0
    linear_att: float = 0.0
    quadratic_att: float = 0.0
    falloff_deg: float = 45.0
    falloff_exp: float = 1.0
    transform: np.ndarray = field(default_factory=lambda: np.eye(4))


@dataclass
class MaterialInfo:
    """Material resolved to a BSDF family + parameters (collada.cpp:863-954)."""

    bsdf_type: int = BSDF_DIFFUSE
    albedo: np.ndarray = field(default_factory=lambda: np.full(3, 0.5))  # diffuse reflectance
    radiance: np.ndarray = field(default_factory=lambda: np.zeros(3))  # emission
    reflectance: np.ndarray = field(default_factory=lambda: np.zeros(3))  # mirror/glass
    transmittance: np.ndarray = field(default_factory=lambda: np.zeros(3))  # refraction/glass
    eta: np.ndarray = field(default_factory=lambda: np.zeros(3))  # microfacet
    k: np.ndarray = field(default_factory=lambda: np.zeros(3))  # microfacet
    alpha: float = 0.0  # microfacet roughness
    roughness: float = 0.0  # refraction/glass
    ior: float = 1.0  # refraction/glass


@dataclass
class PolymeshInfo:
    vertices: np.ndarray = None  # (V, 3) float64, object space
    normals: np.ndarray | None = None  # (Vn, 3) or None
    texcoords: np.ndarray | None = None
    polygons: list = field(default_factory=list)  # list of (vertex_idx list, normal_idx list|None)
    material: MaterialInfo | None = None
    transform: np.ndarray = field(default_factory=lambda: np.eye(4))


@dataclass
class SphereInfo:
    radius: float = 1.0
    material: MaterialInfo | None = None
    transform: np.ndarray = field(default_factory=lambda: np.eye(4))


@dataclass
class SceneInfo:
    camera: CameraInfo | None = None
    lights: list = field(default_factory=list)
    meshes: list = field(default_factory=list)
    spheres: list = field(default_factory=list)
    up: np.ndarray = field(default_factory=lambda: np.array([0.0, 1.0, 0.0]))


def _floats(text: str) -> np.ndarray:
    return np.array(text.split(), dtype=np.float64)


def _tag(e) -> str:
    return e.tag.split("}")[-1]


class _Parser:
    def __init__(self, root):
        self.root = root
        self.scene = SceneInfo()
        # id -> element index for uri lookups
        self.by_id = {}
        for e in root.iter():
            eid = e.get("id")
            if eid is not None:
                self.by_id[eid] = e

    # -- helpers ---------------------------------------------------------

    def find(self, parent, path: str):
        return parent.find("/".join(NS + p for p in path.split("/")))

    def findall(self, parent, path: str):
        return parent.findall("/".join(NS + p for p in path.split("/")))

    def uri_find(self, uri: str):
        return self.by_id.get(uri.lstrip("#"))

    def technique_cgl(self, elem):
        """<extra><technique profile="CGL"> lookup (collada.cpp get_technique_CGL)."""
        for extra in elem.iter(NS + "extra"):
            for tech in extra.findall(NS + "technique"):
                if tech.get("profile") == "CGL":
                    return tech
        return None

    def technique_common(self, elem):
        for tc in elem.iter(NS + "technique_common"):
            return tc
        return None

    # -- top level -------------------------------------------------------

    def parse(self) -> SceneInfo:
        up_axis = self.find(self.root, "asset/up_axis")
        if up_axis is not None:
            txt = up_axis.text.strip()
            if txt == "X_UP":
                self.scene.up = np.array([1.0, 0.0, 0.0])
            elif txt == "Z_UP":
                self.scene.up = np.array([0.0, 0.0, 1.0])

        vscene_inst = self.find(self.root, "scene/instance_visual_scene")
        vscene = self.uri_find(vscene_inst.get("url"))
        for node in vscene.findall(NS + "node"):
            self.parse_node(node, np.eye(4))
        return self.scene

    def parse_node(self, xml, parent_transform):
        local = np.eye(4)
        for e in xml:
            name = _tag(e)
            if name == "matrix":
                vals = _floats(e.text)
                if len(vals) < 16:
                    # CBgems.dae ships a malformed 15-value matrix; the
                    # reference's stringstream silently leaves the tail
                    # uninitialized — pad with identity entries instead
                    pad = np.eye(4).ravel()[len(vals) :]
                    vals = np.concatenate([vals, pad])
                local = vals[:16].reshape(4, 4)
                break  # matrix overrides the transform list (collada.cpp:255-269)
            elif name == "rotate":
                vals = _floats(e.text)  # x y z angle_deg
                axis, angle = vals[:3], math.radians(vals[3])
                local = _axis_angle(axis, angle) @ local
            elif name == "translate":
                m = np.eye(4)
                m[:3, 3] = _floats(e.text)[:3]
                local = m @ local
            elif name == "scale":
                m = np.eye(4)
                s = _floats(e.text)
                m[0, 0], m[1, 1], m[2, 2] = s[0], s[1], s[2]
                local = m @ local

        transform = parent_transform @ local

        for child in xml.findall(NS + "node"):
            self.parse_node(child, transform)

        e_camera = self.find(xml, "instance_camera")
        e_light = self.find(xml, "instance_light")
        e_geometry = self.find(xml, "instance_geometry")

        if e_camera is not None:
            cam = self.parse_camera(self.uri_find(e_camera.get("url")))
            cam.transform = transform
            self.scene.camera = cam
        elif e_light is not None:
            light = self.parse_light(self.uri_find(e_light.get("url")))
            light.transform = transform
            self.scene.lights.append(light)
        elif e_geometry is not None:
            geom = self.uri_find(e_geometry.get("url"))
            material = None
            e_mat_inst = self.find(
                xml, "instance_geometry/bind_material/technique_common/instance_material"
            )
            if e_mat_inst is not None:
                material = self.parse_material(self.uri_find(e_mat_inst.get("target")))
            if self.find(geom, "mesh") is not None:
                mesh = self.parse_polymesh(geom)
                mesh.material = material
                mesh.transform = transform
                self.scene.meshes.append(mesh)
            elif self.find(geom, "extra") is not None:
                sph = self.parse_sphere(geom)
                sph.material = material
                sph.transform = transform
                self.scene.spheres.append(sph)

    # -- instances -------------------------------------------------------

    def parse_camera(self, xml) -> CameraInfo:
        cam = CameraInfo()
        persp = self.find(xml, "optics/technique_common/perspective")
        if persp is None:
            raise ValueError("only perspective cameras are supported")
        xfov = persp.find(NS + "xfov")
        yfov = persp.find(NS + "yfov")
        znear = persp.find(NS + "znear")
        zfar = persp.find(NS + "zfar")
        cam.h_fov = float(xfov.text) if xfov is not None else 50.0
        cam.v_fov = float(yfov.text) if yfov is not None else 35.0
        cam.n_clip = float(znear.text) if znear is not None else 0.001
        cam.f_clip = float(zfar.text) if zfar is not None else 1000.0
        if yfov is None:
            ar_e = persp.find(NS + "aspect_ratio")
            if ar_e is None:
                raise ValueError("incomplete perspective definition")
            ar = float(ar_e.text)
            cam.v_fov = math.degrees(
                2 * math.atan(math.tan(math.radians(0.5 * cam.h_fov)) / ar)
            )
        return cam

    def parse_light(self, xml) -> LightInfo:
        light = LightInfo()
        tech = self.technique_cgl(xml)
        if tech is None:
            tech = self.technique_common(xml)
        if tech is None:
            raise ValueError("no supported light technique")
        e = next(iter(tech), None)
        if e is None:
            return light
        ltype = _tag(e)
        light.light_type = {
            "ambient": LIGHT_AMBIENT,
            "directional": LIGHT_DIRECTIONAL,
            "area": LIGHT_AREA,
            "point": LIGHT_POINT,
            "spot": LIGHT_SPOT,
        }.get(ltype, LIGHT_NONE)
        color = e.find(NS + "color")
        if color is not None:
            light.spectrum = _floats(color.text)[:3]
        for attr, tag in (
            ("constant_att", "constant_attenuation"),
            ("linear_att", "linear_attenuation"),
            ("quadratic_att", "quadratic_attenuation"),
            ("falloff_deg", "falloff_angle"),
            ("falloff_exp", "falloff_exponent"),
        ):
            sub = e.find(NS + tag)
            if sub is not None:
                setattr(light, attr, float(sub.text))
        return light

    def parse_sphere(self, xml) -> SphereInfo:
        tech = self.technique_cgl(xml)
        radius_e = self.find(tech, "sphere/radius") if tech is not None else None
        if radius_e is None:
            raise ValueError("invalid sphere definition")
        return SphereInfo(radius=float(radius_e.text))

    def parse_polymesh(self, xml) -> PolymeshInfo:
        mesh = PolymeshInfo()
        e_mesh = self.find(xml, "mesh")

        sources = {}
        for src in e_mesh.findall(NS + "source"):
            arr = src.find(NS + "float_array")
            if arr is not None:
                sources[src.get("id")] = _floats(arr.text)

        e_vertices = e_mesh.find(NS + "vertices")
        vertices_id = e_vertices.get("id")
        positions = None
        for inp in e_vertices.findall(NS + "input"):
            if inp.get("semantic") == "POSITION":
                positions = sources[inp.get("source").lstrip("#")].reshape(-1, 3)
        mesh.vertices = positions

        e_poly = e_mesh.find(NS + "polylist")
        is_triangles = False
        if e_poly is None:
            e_poly = e_mesh.find(NS + "triangles")
            is_triangles = True
        if e_poly is None:
            return mesh

        vertex_offset = normal_offset = texcoord_offset = None
        for inp in e_poly.findall(NS + "input"):
            semantic = inp.get("semantic")
            offset = int(inp.get("offset", 0))
            source = inp.get("source").lstrip("#")
            if semantic == "VERTEX":
                vertex_offset = offset
                if source != vertices_id:
                    raise ValueError("VERTEX input does not reference <vertices>")
            elif semantic == "NORMAL":
                normal_offset = offset
                mesh.normals = sources[source].reshape(-1, 3)
            elif semantic == "TEXCOORD":
                texcoord_offset = offset
                mesh.texcoords = sources[source].reshape(-1, 2)

        stride = sum(x is not None for x in (vertex_offset, normal_offset, texcoord_offset))
        num_polygons = int(e_poly.get("count"))
        if is_triangles:
            sizes = [3] * num_polygons
        else:
            sizes = [int(s) for s in e_poly.find(NS + "vcount").text.split()]

        indices = np.array([int(i) for i in e_poly.find(NS + "p").text.split()], dtype=np.int64)
        k = 0
        for size in sizes:
            poly = indices[k * stride : (k + size) * stride].reshape(size, stride)
            v_idx = poly[:, vertex_offset] if vertex_offset is not None else None
            n_idx = poly[:, normal_offset] if normal_offset is not None else None
            mesh.polygons.append((v_idx, n_idx))
            k += size
        return mesh

    def parse_material(self, xml) -> MaterialInfo:
        mat = MaterialInfo()
        e_effect_inst = self.find(xml, "instance_effect")
        if e_effect_inst is None:
            raise ValueError("material without instance_effect")
        effect = self.uri_find(e_effect_inst.get("url"))

        tech_cgl = self.technique_cgl(effect)
        if tech_cgl is not None:
            for e_bsdf in tech_cgl:
                btype = _tag(e_bsdf)

                def vec(tag):
                    sub = e_bsdf.find(NS + tag)
                    return _floats(sub.text)[:3] if sub is not None else None

                def scal(tag, default=0.0):
                    sub = e_bsdf.find(NS + tag)
                    return float(sub.text) if sub is not None else default

                if btype == "emission":
                    mat.bsdf_type = BSDF_EMISSION
                    mat.radiance = vec("radiance")
                elif btype == "mirror":
                    mat.bsdf_type = BSDF_MIRROR
                    mat.reflectance = vec("reflectance")
                elif btype == "microfacet":
                    mat.bsdf_type = BSDF_MICROFACET
                    mat.alpha = scal("alpha")
                    mat.eta = vec("eta")
                    mat.k = vec("k")
                elif btype == "refraction":
                    mat.bsdf_type = BSDF_REFRACTION
                    mat.transmittance = vec("transmittance")
                    mat.roughness = scal("roughness")
                    mat.ior = scal("ior", 1.0)
                elif btype == "glass":
                    mat.bsdf_type = BSDF_GLASS
                    mat.transmittance = vec("transmittance")
                    mat.reflectance = vec("reflectance")
                    mat.roughness = scal("roughness")
                    mat.ior = scal("ior", 1.0)
            return mat

        tech_common = None
        profile = self.find(effect, "profile_COMMON")
        if profile is not None:
            tech_common = profile.find(NS + "technique")
        if tech_common is not None:
            diffuse = self.find(tech_common, "lambert/diffuse/color")
            if diffuse is None:
                diffuse = self.find(tech_common, "phong/diffuse/color")
            if diffuse is not None:
                mat.albedo = _floats(diffuse.text)[:3]
        return mat


def _axis_angle(axis, angle) -> np.ndarray:
    axis = np.asarray(axis, dtype=np.float64)
    n = np.linalg.norm(axis)
    if n == 0:
        return np.eye(4)
    x, y, z = axis / n
    c, s = math.cos(angle), math.sin(angle)
    C = 1 - c
    m = np.eye(4)
    m[:3, :3] = [
        [x * x * C + c, x * y * C - z * s, x * z * C + y * s],
        [y * x * C + z * s, y * y * C + c, y * z * C - x * s],
        [z * x * C - y * s, z * y * C + x * s, z * z * C + c],
    ]
    return m


def load_dae(path) -> SceneInfo:
    """Parse a .dae file into a :class:`SceneInfo` (flat node list, world transforms)."""
    tree = ET.parse(path)
    return _Parser(tree.getroot()).parse()
