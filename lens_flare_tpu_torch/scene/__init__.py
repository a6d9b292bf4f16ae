"""Counterpart of ``lens_flare_tpu.scene``."""
