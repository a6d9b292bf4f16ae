"""Counterpart of ``lens_flare_tpu.flare``."""
