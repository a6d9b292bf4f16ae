"""Differentiable path-traced radiance: scene parameters from pixels.

Counterpart of ``lens_flare_tpu/diff/render.py``.  Autograd of a rendered
image with respect to scene parameters (emitter radiance, albedos, light
radiance, environment-map texels) runs through the whole wavefront integrator, with the trace
detached: the hits are constants of the backward pass
(:func:`lens_flare_tpu_torch.integrator.path.trace_closest`), so the CUDA
kernels run forward only, as the JAX package keeps its Pallas call out of
the backward pass.  The hit structure is piecewise constant in radiometric
parameters, so the detached gradient of the fixed-RNG estimator is exact
(``tests/test_torch_diff.py`` checks it by central differences).  The
environment map's CDF tables are host constants, as in the JAX package:
a texel's gradient comes through the radiance the miss lookup and the
environment light's NEE samples read, not through where they sample.

:func:`recover_emitter` recovers an emitter's colour (its BSDF radiance row
and its NEE light-table row) from a target render with Adam.  On a CUDA
device its step (render, loss, backward, Adam's update) is one captured
program (:class:`lens_flare_tpu_torch.compiled.Step`), the counterpart of
the JAX package's jitted step.
"""

from __future__ import annotations

import torch

from .. import _rng
from ..compiled import Step
from ..integrator.path import RenderSettings, SceneBundle, render_batch


def replace_row(bundle: SceneBundle, group: str, field: str, row: int | None, value) -> SceneBundle:
    """``bundle`` with row ``row`` of ``bundle.<group>.<field>`` set to ``value``, out of place.

    The bundle's tensors are not written, and autograd sees ``value``: the
    ``.at[row].set`` of the JAX package.  ``row=None`` replaces the whole table.
    """
    g = getattr(bundle, group)
    table = getattr(g, field)
    if row is not None:
        mask = (torch.arange(table.shape[0], device=table.device) == row)[:, None]
        value = torch.where(mask, value, table)
    return bundle._replace(**{group: g._replace(**{field: value})})


def set_env_texels(bundle: SceneBundle, data) -> SceneBundle:
    """``bundle`` with its environment map's (H, W, 3) texels replaced by ``data``, out of place.

    The CDF tables stay those of the original map, as when the JAX package
    swaps ``env.data`` (``tests/test_diff_render.py:184``).
    """
    return replace_row(bundle, "env", "data", None, data)


def set_emitter_color(bundle: SceneBundle, bsdf_row: int, light_row: int, color) -> SceneBundle:
    """One physical emitter = one BSDF radiance row + one light-table row.

    The integrator reads the emitter twice, through ``get_emission`` when a
    path vertex lands on it and through the light table when NEE samples
    it, so both rows carry the same parameter.
    """
    color = torch.as_tensor(color, dtype=torch.float32, device=bundle.bsdfs.radiance.device)
    bundle = replace_row(bundle, "bsdfs", "radiance", bsdf_row, color)
    return replace_row(bundle, "lights", "radiance", light_row, color)


def render_image(bundle, settings: RenderSettings, cam, px, py, width, height, key, n_samples):
    """Fixed-sample-count differentiable render (no adaptive stop) -> (N, 3) mean radiance.

    The adaptive stop's masks change under finite parameter steps, so the
    gradient uses the unconditional estimator of ``render_batch``.
    """
    film, _s1, _s2, _stats = render_batch(bundle, settings, cam, px, py, width, height, key, 0, n_samples)
    return film / n_samples


def recover_emitter(
    bundle: SceneBundle,
    settings: RenderSettings,
    cam,
    px,
    py,
    width,
    height,
    target,
    bsdf_row: int,
    light_row: int,
    init_color=(1.0, 1.0, 1.0),
    n_samples: int = 4,
    steps: int = 60,
    learning_rate: float = 0.5,
    key=None,
):
    """Gradient-recover an emitter colour from a target render -> (color (3,), losses).

    The loss is the mean squared difference between the render and
    ``target`` with the same RNG key at every step, so its optimum is the
    true colour (no Monte-Carlo floor).  Adam with optax's defaults; on a
    CUDA device it keeps its step count there (``capturable=True``) and
    the step is a captured program (``compiled.Step``: step 1 warms up,
    step 2 captures, the rest replay), eager under ``compiled.disabled()``.
    """
    dev = bundle.bsdfs.radiance.device
    if key is None:
        key = _rng.prng_key(7, device=dev)
    color = torch.tensor(init_color, dtype=torch.float32, device=dev, requires_grad=True)
    optimizer = torch.optim.Adam([color], lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                                 capturable=dev.type == "cuda")

    def step():
        optimizer.zero_grad(set_to_none=True)
        img = render_image(
            set_emitter_color(bundle, bsdf_row, light_row, color),
            settings, cam, px, py, width, height, key, n_samples,
        )
        loss = torch.mean((img - target) ** 2)
        loss.backward()
        optimizer.step()
        return loss.detach()

    run = Step(step, color)
    losses = [run().item() for _ in range(steps)]
    return color.detach(), losses
