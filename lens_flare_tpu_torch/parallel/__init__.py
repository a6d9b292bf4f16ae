"""Multi-device rendering: the counterpart of ``lens_flare_tpu/parallel``."""

from .mesh import make_mesh, replicate, shard_batch  # noqa: F401
