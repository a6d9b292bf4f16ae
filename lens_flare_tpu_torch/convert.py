"""Carry the JAX package's state across as the port's tensors.

Each function takes the JAX side's objects (NamedTuples or dataclasses whose
fields are arrays) and calls ``np.asarray`` on the fields it needs, so JAX
arrays and NumPy arrays both work and this module never imports JAX.  With
these, the tests run both packages on identical inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from .integrator.envlight import EnvLightArrays
from .integrator.lights import LightArrays
from .integrator.path import BokehMask, SceneBundle
from .integrator.shading import BSDFArrays
from .lens.prescription import LensPrescription
from .ops.intersect import SceneArrays
from .ops.intersect_cuda import CudaScene
from .scene.camera import CameraParams


def _fields(obj, cls, device):
    out = {}
    for name in cls._fields:
        a = np.array(getattr(obj, name))  # a writable copy
        if a.dtype == np.float64:
            a = a.astype(np.float32)
        out[name] = torch.as_tensor(a, device=device)
    return cls(**out)


def scene_bundle_from_numpy(scene, bsdfs, lights, cscene: CudaScene, device="cpu", bokeh=None) -> SceneBundle:
    """A SceneBundle from the fields of the JAX SceneArrays, BSDFArrays and LightArrays.

    ``cscene`` is the port's cluster tree, e.g. from :func:`cuda_scene_from_wide_bvh`;
    ``bokeh`` an optional JAX ``BokehMask`` (see :func:`bokeh_mask_from_numpy`).
    """
    return SceneBundle(
        scene=_fields(scene, SceneArrays, device),
        bsdfs=_fields(bsdfs, BSDFArrays, device),
        lights=_fields(lights, LightArrays, device),
        cscene=cscene,
        bokeh=None if bokeh is None else bokeh_mask_from_numpy(bokeh, device),
    )


def env_from_numpy(env, device="cpu") -> EnvLightArrays:
    """The port's EnvLightArrays from the fields of a JAX one: its map and its three float32 tables."""
    return _fields(env, EnvLightArrays, device)


def bokeh_mask_from_numpy(bokeh, device="cpu") -> BokehMask:
    """The port's BokehMask from a JAX one: its float32 CDF, width and height."""
    cdf = torch.as_tensor(np.array(bokeh.cdf, np.float32), device=device)
    return BokehMask(cdf, int(bokeh.width), int(bokeh.height))


def cuda_scene_from_wide_bvh(
    wb, sph_center, sph_radius, num_tris: int, device="cpu",
    shade_rows=None, force_stream=None, stream_shade=False, mxu=False,
) -> CudaScene:
    """The port's cluster tree from the WideBVH a JAX ``PallasScene`` is built from.

    ``shade_rows``, ``force_stream``, ``stream_shade`` and ``mxu`` as ``PallasScene`` takes them.
    """
    return CudaScene.from_wide_bvh(
        wb, np.asarray(sph_center, np.float32).reshape(-1, 3),
        np.asarray(sph_radius, np.float32), num_tris, device,
        shade_rows=None if shade_rows is None else np.asarray(shade_rows, np.float32),
        force_stream=force_stream, stream_shade=stream_shade, mxu=mxu,
    )


def prescription_from_numpy(lens, device="cpu") -> LensPrescription:
    """A LensPrescription from the JAX one's fields."""

    def t(name):
        return torch.as_tensor(np.array(getattr(lens, name), np.float32), device=device)

    return LensPrescription(
        spacings=t("spacings"),
        curvatures=t("curvatures"),
        iors=t("iors"),
        aperture_height=t("aperture_height"),
        marginal_r=t("marginal_r"),
        aperture_index=int(lens.aperture_index),
    )


def camera_params_from_numpy(params, device="cpu") -> CameraParams:
    """CameraParams from the JAX (or host ``Camera.params()``) fields."""
    return CameraParams(
        *(torch.as_tensor(np.array(getattr(params, f), np.float32), device=device) for f in CameraParams._fields)
    )
