"""Counterpart of ``lens_flare_tpu.diff``."""

from .optimize import OptimizeConfig, optimize_lens  # noqa: F401
