"""Differentiable lens design: fit the prescription to a target flare.

Counterpart of ``lens_flare_tpu/diff/optimize.py`` (BASELINE config 5).
Pixel gradients flow through the smooth ghost splat and the paraxial
matrix chains to the curvatures, element spacings, per-wavelength IORs,
the aperture height and the marginal ray height.  ``torch.optim.Adam``
(optax's defaults) drives the five float fields, as optax updates every
float leaf; ``aperture_index`` stays an int.  Checkpoints (the lens
fields, the optimizer's state and the step) go through ``torch.save``, so
an interrupted optimization resumes at the saved step with Adam's moments
intact.  On a CUDA device the step (ghost image, loss, backward, Adam's
update) is one captured program (:class:`lens_flare_tpu_torch.compiled.Step`),
the counterpart of the JAX package's jitted step, and Adam keeps its step
count on the device (``capturable=True``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path

import torch

from ..compiled import Step
from ..lens.ghosts import splat_ghosts
from ..lens.paraxial import ghost_pair_table, trace_all_ghosts
from ..lens.prescription import LensPrescription, reference_prescription

LENS_FIELDS = ("spacings", "curvatures", "iors", "aperture_height", "marginal_r")


@dataclass
class OptimizeConfig:
    steps: int = 200
    learning_rate: float = 1e-4
    width: int = 128
    height: int = 128
    checkpoint_dir: str | None = None
    checkpoint_every: int = 50
    log_every: int = 20


def ghost_image(lens: LensPrescription, ghost_tex, axis_ray, angle, width, height, pairs=None):
    """Differentiable forward model: prescription -> (H, W, 3) ghost buffer.

    ``pairs``: ``paraxial.ghost_pair_table`` on the lens's device, made here when None; a captured
    step makes it, and the angle as a tensor, ahead (host data cannot enter a capture).
    """
    r1, r2 = trace_all_ghosts(lens, angle, pairs)
    n_pairs = r1.shape[0]
    colors = torch.eye(3, dtype=r1.dtype, device=r1.device).repeat(n_pairs, 1)
    return splat_ghosts(ghost_tex, r1.reshape(-1), r2.reshape(-1), colors, axis_ray, width, height, smooth=True)


def adam_over(lens0: LensPrescription, device, learning_rate: float):
    """(lens, optimizer): a trainable copy of ``lens0`` on ``device`` (its float fields leaves that
    require a gradient) and ``torch.optim.Adam`` over them with optax's defaults; on a CUDA device
    its step count stays there (``capturable=True``), so that a captured step can update it."""
    device = torch.device(device)
    lens = LensPrescription(
        **{f: getattr(lens0, f).detach().to(device).clone().requires_grad_(True) for f in LENS_FIELDS},
        aperture_index=lens0.aperture_index,
    )
    params = [getattr(lens, f) for f in LENS_FIELDS]
    return lens, torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                                  capturable=device.type == "cuda")


def optimize_lens(
    target,
    ghost_tex,
    axis_ray,
    angle,
    config: OptimizeConfig | None = None,
    init_lens: LensPrescription | None = None,
    device="cuda",
):
    """Fit the lens prescription so its ghosts match ``target`` (H, W, 3).

    Runs on ``device`` (the card unless the caller asks for the CPU).  With
    ``config.checkpoint_dir`` it resumes from the directory's latest
    checkpoint, before the first step, and saves every ``checkpoint_every``
    steps and at the end.  On a CUDA device the steps replay one captured
    program (``compiled.Step``: the first step run warms up, the second
    captures), eager under ``compiled.disabled()``.  Returns (lens, losses),
    one loss per step run.
    """
    config = config or OptimizeConfig()
    dev = torch.device(device)
    target = torch.as_tensor(target, device=dev)
    ghost_tex = torch.as_tensor(ghost_tex, device=dev)
    axis_ray = torch.as_tensor(axis_ray, device=dev)
    height, width = target.shape[:2]
    lens0 = init_lens if init_lens is not None else reference_prescription(device=dev)
    lens, optimizer = adam_over(lens0, dev, config.learning_rate)

    ckpt_mgr = None
    start_step = 0
    if config.checkpoint_dir:
        ckpt_mgr = _CheckpointManager(config.checkpoint_dir)
        start_step = ckpt_mgr.restore(lens, optimizer)

    pairs = ghost_pair_table(dev)
    angle = torch.as_tensor(angle, dtype=lens.curvatures.dtype, device=dev)

    def step():
        optimizer.zero_grad(set_to_none=True)
        img = ghost_image(lens, ghost_tex, axis_ray, angle, width, height, pairs)
        loss = torch.mean((img - target) ** 2)
        loss.backward()
        optimizer.step()
        return loss.detach()

    run = Step(step, lens.curvatures)
    losses = []
    for s in range(start_step, config.steps):
        losses.append(run().item())
        if config.log_every and s % config.log_every == 0:
            print(f"[LensOpt] step {s}: loss {losses[-1]:.6e}")
        if ckpt_mgr and config.checkpoint_every and (s + 1) % config.checkpoint_every == 0:
            ckpt_mgr.save(lens, optimizer, s + 1)

    if ckpt_mgr:
        ckpt_mgr.save(lens, optimizer, config.steps)
    return LensPrescription(
        **{f: getattr(lens, f).detach() for f in LENS_FIELDS}, aperture_index=lens.aperture_index
    ), losses


class _CheckpointManager:
    """``step_{n}.pt`` files (lens fields, optimizer state, step) and a ``LATEST`` file naming the newest."""

    def __init__(self, directory):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)

    def save(self, lens: LensPrescription, optimizer: torch.optim.Optimizer, step: int) -> None:
        state = {
            "lens": {f: getattr(lens, f).detach().cpu() for f in LENS_FIELDS},
            "optimizer": optimizer.state_dict(),
            "step": step,
        }
        path = self.dir / f"step_{step}.pt"
        tmp = path.with_suffix(".pt.tmp")
        torch.save(state, tmp)
        os.replace(tmp, path)
        (self.dir / "LATEST").write_text(str(step))

    def restore(self, lens: LensPrescription, optimizer: torch.optim.Optimizer) -> int:
        """Load the latest checkpoint into ``lens`` and ``optimizer``; the step to resume at (0: none)."""
        latest = self.dir / "LATEST"
        if not latest.exists():
            return 0
        step = int(latest.read_text())
        state = torch.load(self.dir / f"step_{step}.pt", map_location="cpu", weights_only=True)
        with torch.no_grad():
            for f in LENS_FIELDS:
                getattr(lens, f).copy_(state["lens"][f])
        optimizer.load_state_dict(state["optimizer"])
        return int(state["step"])
