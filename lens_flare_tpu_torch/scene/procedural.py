"""Procedural test scenes.

Counterpart of ``lens_flare_tpu/scene/procedural.py``: a ridged-noise
terrain with a directional sun (for the flare) and a point fill light, at
about 2 * n_quads^2 triangles.  The same ``n_quads`` and ``seed`` give the
same arrays as the JAX package's ``make_terrain_scene``.
"""

from __future__ import annotations

import numpy as np

from .build import LT_DIRECTIONAL, LT_POINT, BSDFTable, FlatScene, LightTable, vertex_normals
from .collada import MaterialInfo


def make_terrain_scene(n_quads: int = 352, seed: int = 0) -> FlatScene:
    """Heightfield terrain with 2*n_quads^2 triangles, sun + fill light."""
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

    # two triangles per quad
    idx = np.arange(n * n).reshape(n, n)
    a = idx[:-1, :-1].ravel()
    b = idx[:-1, 1:].ravel()
    c = idx[1:, :-1].ravel()
    d = idx[1:, 1:].ravel()
    tris = np.concatenate([np.stack([a, b, c], axis=1), np.stack([b, d, c], axis=1)])
    normals = vertex_normals(verts, tris)

    mats = [MaterialInfo(albedo=np.array([0.55, 0.45, 0.32]))]
    lights = LightTable(
        light_type=np.array([LT_DIRECTIONAL, LT_POINT], np.int32),
        radiance=np.array([[1.3, 1.1, 0.65], [9.0, 9.0, 10.0]], np.float32),
        position=np.array([[-6.0, 7.0, 9.0], [4.0, -4.0, 8.0]], np.float32),
        direction=np.array([[-0.49, 0.57, 0.66], [0.0, 0.0, 0.0]], np.float32),
        dim_x=np.zeros((2, 3), np.float32),
        dim_y=np.zeros((2, 3), np.float32),
        area=np.zeros(2, np.float32),
        is_delta=np.array([True, True]),
    )
    # dirToLight = unit(posLight)
    lights.direction[0] = lights.position[0] / np.linalg.norm(lights.position[0])

    scene = FlatScene(
        tri_p=verts[tris].astype(np.float32),
        tri_n=normals[tris].astype(np.float32),
        tri_bsdf=np.zeros(len(tris), np.int32),
        sph_center=np.zeros((0, 3), np.float32),
        sph_radius=np.zeros(0, np.float32),
        sph_bsdf=np.zeros(0, np.int32),
        bsdfs=BSDFTable.from_materials(mats),
        lights=lights,
    )
    lo, hi = scene.primitive_bboxes()
    scene.bbox_min = lo.min(axis=0).astype(np.float64)
    scene.bbox_max = hi.max(axis=0).astype(np.float64)
    return scene
