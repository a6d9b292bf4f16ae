"""Device meshes and the placement of wavefronts and scenes on them.

Counterpart of ``lens_flare_tpu/parallel/mesh.py``.  The JAX package's
mesh is a 1-D ``jax.sharding.Mesh`` over the ray/film batch axis, with
the scene replicated and XLA inserting the collectives.  Here a mesh is an
ordered tuple of ``torch.device`` s, one per shard:

- :func:`shard_batch` splits a tensor's leading axis into one piece per
  shard, each on its device;
- :func:`replicate` places a ``SceneBundle`` once per distinct device of
  the mesh, its cluster tree or binary BVH included;
- the callers (``parallel/render.py``, the ``Renderer``) run each shard on
  its device and gather the pieces in shard order onto the first device;
  across processes, ``torch.distributed`` gathers and all-reduces.

A mesh may name one device more than once: its shards then run one after
the other on that device, which stands in for several devices on a
machine that has one (as the JAX tests' 8 virtual CPU devices do).
:func:`available_devices` is what the ``Renderer`` enumerates.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch


def init_distributed(coordinator: str | None = None, num_processes: int | None = None, process_id: int | None = None):
    """Join this process to a ``torch.distributed`` group over ``tcp://coordinator`` (``host:port``).

    Collectives on CUDA tensors go through NCCL, on CPU tensors through
    gloo.  With one process (or none given) it does nothing, as the JAX
    package does on a single host.
    """
    if num_processes is None or num_processes <= 1:
        return
    backend = "cpu:gloo,cuda:nccl" if torch.cuda.is_available() else "gloo"
    torch.distributed.init_process_group(
        backend, init_method=f"tcp://{coordinator}", world_size=num_processes, rank=process_id
    )


def distributed() -> bool:
    """Whether this process is in a ``torch.distributed`` group (one of a single rank included)."""
    return torch.distributed.is_available() and torch.distributed.is_initialized()


def group() -> tuple[int, int]:
    """(rank, world size) of this process's group; (0, 1) without one."""
    if distributed():
        return torch.distributed.get_rank(), torch.distributed.get_world_size()
    return 0, 1


def available_devices(device) -> list[torch.device]:
    """The devices a ``Renderer`` on ``device`` may shard over: every CUDA device, or the one CPU."""
    if torch.device(device).type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device(device)]


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(n_devices: int | None = None, devices=None) -> tuple[torch.device, ...]:
    """A 1-D mesh: the shards' devices in order, every CUDA device by default, or the first ``n_devices``."""
    devices = available_devices("cuda") if devices is None else devices
    if n_devices is not None:
        devices = devices[:n_devices]
    mesh = tuple(_device(d) for d in devices)
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


def device_scope(device: torch.device):
    """The device as the current CUDA device (kernel launches and captures go to its streams); a CPU needs none."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def shard_batch(x: torch.Tensor, mesh) -> list[torch.Tensor]:
    """``x``'s leading axis split into one contiguous piece per shard, each on its shard's device."""
    n = len(mesh)
    if x.shape[0] % n:
        raise ValueError(f"a leading axis of {x.shape[0]} does not divide over {n} shards")
    return [piece.to(d) for piece, d in zip(torch.chunk(x, n), mesh)]


def to_device(tree, device: torch.device):
    """Every tensor of a NamedTuple, dataclass or tensor (nested) on ``device``; other leaves as they are.

    A tensor already there is the same tensor: nothing is copied for it.
    """
    if tree is None:
        return None
    if torch.is_tensor(tree):
        return tree.to(device)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_device(x, device) for x in tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(
            tree, **{f.name: to_device(getattr(tree, f.name), device) for f in dataclasses.fields(tree) if f.init}
        )
    return tree


def replicate(bundle, mesh) -> dict:
    """{device: the bundle on it}, once per distinct device of ``mesh``: its tables, cluster tree
    (``CudaScene``) or binary BVH, bokeh mask and sky."""
    return {d: to_device(bundle, d) for d in dict.fromkeys(mesh)}

