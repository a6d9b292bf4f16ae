"""Sharded rendering and the sharded lens-design step.

Counterpart of ``lens_flare_tpu/parallel/render.py``.  The JAX package
shards the pixel wavefront over a mesh under one jitted program, and XLA
all-reduces the stats and the lens gradients.  Here each shard is its own
call on its device (``parallel/mesh.py``): the lanes of shard i go to
``mesh[i]`` with that device's replica of the scene, the outputs are
gathered in shard order onto the first device, and the stats are summed.
No shard waits for another: nothing between the calls syncs with the host,
so on separate cards their work overlaps.  Under a ``torch.distributed``
group each rank takes its contiguous block of the lanes (or film rows) and
shards it over its own mesh; ``all_gather`` assembles the image on every
rank and ``all_reduce`` sums the stats and the lens gradients.

Every lane's radiance depends on its pixel and sample only, so a sharded
render equals the unsharded one bit for bit.  :func:`shard_call` holds
these rules; ``render_sharded`` and the ``Renderer`` both go through it.
"""

from __future__ import annotations

import functools

import torch

from ..compiled import Step
from ..diff.optimize import LENS_FIELDS, adam_over, ghost_image
from ..integrator.path import render_wavefront
from ..lens.ghosts import splat_eval
from ..lens.paraxial import ghost_pair_table, trace_all_ghosts
from .mesh import device_scope, distributed, group, make_mesh, replicate, shard_batch, to_device


def replica(replicas: dict, device: torch.device):
    """The scene placed on ``device``; a shard whose device has none raises."""
    try:
        return replicas[device]
    except KeyError:
        raise ValueError(f"no replica of the scene on {device} (replicas on {list(replicas)})") from None


def map_shards(mesh, fn, *lanes) -> list:
    """``fn(device, *pieces)`` for each shard, under its device, in shard order; the lanes split by
    :func:`~.mesh.shard_batch`."""
    pieces = [shard_batch(x, mesh) for x in lanes]
    outs = []
    for i, d in enumerate(mesh):
        with device_scope(d):
            outs.append(fn(d, *(p[i] for p in pieces)))
    return outs


def gather_lanes(pieces, device) -> torch.Tensor:
    """The shards' pieces concatenated in shard order on ``device``."""
    return torch.cat([p.to(device) for p in pieces])


def sum_stats(pieces, device) -> torch.Tensor:
    """The shards' stats summed on ``device``, in shard order."""
    return functools.reduce(torch.add, (p.to(device) for p in pieces))


def _all_gather(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` concatenated in rank order, on every rank."""
    parts = [torch.empty_like(x) for _ in range(group()[1])]
    torch.distributed.all_gather(parts, x.contiguous())
    return torch.cat(parts)


def _rank_block(n: int, n_shards: int):
    """This rank's contiguous block of ``n`` lanes (or rows), checked to divide over every shard."""
    rank, world = group()
    if n % (world * n_shards):
        raise ValueError(f"{n} must divide over {world * n_shards} devices")
    return slice(rank * n // world, (rank + 1) * n // world)


def shard_call(mesh, replicas: dict, call, cam, key, *lanes):
    """``call(bundle, cam, key, *pieces)`` over the mesh: the shards' outputs as one call's.

    Under a process group this rank takes its contiguous block of the
    lanes.  The block is split into one piece per shard, and each piece
    runs under its device with that device's replica, camera and key.
    ``call`` returns per-lane outputs and then the stats.  The per-lane
    outputs are gathered in shard order onto ``mesh[0]``, and then in rank
    order on every rank (``all_gather``); the stats are summed over the
    shards and all-reduced over the ranks.  Nothing syncs with the host
    between the shards.
    """
    block = _rank_block(lanes[0].shape[0], len(mesh))

    def shard(d, *pieces):
        return call(replica(replicas, d), to_device(cam, d), key.to(d), *pieces)

    *per_lane, stats = zip(*map_shards(mesh, shard, *(x[block] for x in lanes)))
    home = mesh[0]
    per_lane = [gather_lanes(o, home) for o in per_lane]
    stats = sum_stats(stats, home)
    if distributed():  # a group of one rank too: the collectives are the same calls
        per_lane = [_all_gather(x) for x in per_lane]
        torch.distributed.all_reduce(stats)
    return (*per_lane, stats)


def render_sharded(bundle, settings, cam, px, py, width, height, key, mesh=None):
    """Data-parallel ``render_wavefront``: the pixels sharded over ``mesh``, the scene replicated.

    ``mesh`` defaults to every CUDA device; ``px``, ``py`` must divide
    evenly over its shards (and the group's ranks).  Returns what
    ``render_wavefront`` returns, on the first device of the mesh.
    """
    mesh = make_mesh() if mesh is None else mesh
    return shard_call(
        mesh, replicate(bundle, mesh),
        lambda b, c, k, x, y: render_wavefront(b, settings, c, x, y, width, height, k), cam, key, px, py,
    )


def _ghost_rows(lens, ghost_tex, axis_ray, angle, width, height, mesh, pairs=None):
    """This rank's block of film rows of the smooth ghost buffer, each shard's slab on its device
    (``splat_eval`` on the slab's pixels only), concatenated on the first device; differentiable.
    ``pairs`` as in ``diff.optimize.ghost_image``."""
    rows = torch.arange(height, device=ghost_tex.device)[_rank_block(height, len(mesh))]
    r1, r2 = trace_all_ghosts(lens, angle, pairs)
    colors = torch.eye(3, dtype=r1.dtype, device=r1.device).repeat(r1.shape[0], 1)
    args = (ghost_tex, r1.reshape(-1), r2.reshape(-1), colors, axis_ray)

    def slab(d, rows_d):
        n_rows = rows_d.shape[0]
        ys = rows_d[:, None].expand(n_rows, width).reshape(-1)
        xs = torch.arange(width, device=d).repeat(n_rows)
        # the copies to d are differentiable: the backward sums every shard's cotangents
        tex, r1f, r2f, col, axis = (a.to(d) for a in args)
        return splat_eval(tex, r1f, r2f, col, axis, width, height, xs, ys, smooth=True).reshape(n_rows, width, 3)

    return gather_lanes(map_shards(mesh, slab, rows), mesh[0])


def ghost_image_from_lens(lens, ghost_tex, axis_ray, angle, width, height, mesh=None):
    """The differentiable ghost buffer (H, W, 3) of the lens-design loop, its rows sharded over ``mesh``.

    Each shard evaluates the per-pixel smooth splat on its slab of
    ``height / n`` rows only; the paraxial traces are tiny and made once.
    ``height`` must divide over the shards.  Without ``mesh`` it is
    ``diff.optimize.ghost_image``.  Under a process group the ranks' slabs
    are gathered onto every rank, with no gradient across ranks (the train
    step all-reduces gradients instead).
    """
    if mesh is None:
        return ghost_image(lens, ghost_tex, axis_ray, angle, width, height)
    img = _ghost_rows(lens, ghost_tex, axis_ray, angle, width, height, mesh)
    return _all_gather(img.detach()) if distributed() else img


def make_train_step(lens, ghost_tex, axis_ray, angle, width, height, mesh=None, learning_rate=1e-4):
    """The lens-design step (BASELINE config 5), its forward model row-sharded over ``mesh``.

    ``lens``: the prescription to start from.  Returns (params, step):
    ``params`` is the trainable copy that ``torch.optim.Adam`` updates
    (``diff/optimize.py``'s), and ``step(target)`` runs one step toward the
    (H, W, 3) target, loss = mean((image - target)^2), and returns the loss.
    With ``mesh`` each shard renders its slab of rows, and the backward
    through the device copies sums the lens cotangents; under a process
    group each rank takes its block of rows, and the loss and the gradients
    are all-reduced before Adam's update.

    On a CUDA device ``step`` is a captured program per target shape
    (``compiled.Step``, the counterpart of the JAX package's jitted step:
    the first call warms up and is step 1, the second captures), without a
    mesh and on a mesh whose shards are all one device (stand-ins).  Two
    cases run eagerly, by design and not on a failed capture: under a
    process group with a mesh (the gradients' ``all_reduce`` between the
    backward and Adam's update), and on a mesh of several devices (one
    graph records one device's work); both wait for a machine with more
    than one card (ROADMAP Queue 1 item 9).  The group and the mesh are
    read when the step is made.
    """
    dev = ghost_tex.device
    params, optimizer = adam_over(lens, dev, learning_rate)
    pairs = ghost_pair_table(dev)
    angle = torch.as_tensor(angle, dtype=params.curvatures.dtype, device=dev)
    # unsharded, every rank computes the whole image; sharded, each its rows, and the sums are all-reduced
    reduce = mesh is not None and distributed()
    ranks = group()[1] if reduce else 1

    def step(target):
        optimizer.zero_grad(set_to_none=True)
        if mesh is None:
            loss = torch.mean((ghost_image(params, ghost_tex, axis_ray, angle, width, height, pairs) - target) ** 2)
        else:
            img = _ghost_rows(params, ghost_tex, axis_ray, angle, width, height, mesh, pairs)
            err = (img - target[_rank_block(height, len(mesh))].to(img.device)) ** 2
            loss = torch.mean(err) if ranks == 1 else err.sum() / target.numel()
        loss.backward()
        loss = loss.detach()
        if reduce:
            for f in LENS_FIELDS:
                torch.distributed.all_reduce(getattr(params, f).grad)
            torch.distributed.all_reduce(loss)
        optimizer.step()
        return loss

    if reduce or len(set(mesh or ())) > 1:
        return params, step
    return params, Step(step, params.curvatures)
