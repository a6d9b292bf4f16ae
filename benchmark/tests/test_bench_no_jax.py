"""No run may hold JAX or the JAX package: top-level module names, compared whole."""

import subprocess
import sys

from conftest import BENCH

from benchlib.harness import forbidden_modules


def test_whole_top_level_names():
    assert forbidden_modules(["jax", "jax.numpy", "numpy"]) == ["jax"]
    assert forbidden_modules(["jaxlib.xla_client", "flax.linen"]) == ["flax", "jaxlib"]
    assert forbidden_modules(["lens_flare_tpu", "lens_flare_tpu.renderer"]) == ["lens_flare_tpu"]
    assert forbidden_modules(["lens_flare_tpu_torch", "lens_flare_tpu_torch.renderer", "jaxtyping", "benchlib"]) == []


def test_harness_and_program_load_no_jax():
    """Every module of the harness, its drivers and readers, and the program they load, in a fresh process."""
    code = f"""
import sys, pathlib
sys.path[:0] = [{str(BENCH)!r}, {str(BENCH.parent)!r}]
from benchlib import harness, manifest, reference, flare_ref, roofline, program
import lens_flare_tpu_torch.app, lens_flare_tpu_torch.renderer, lens_flare_tpu_torch.flare.pipeline
for p in sorted(pathlib.Path({str(BENCH)!r}).glob("drivers/*.py")):
    manifest.driver(p.stem)
for p in sorted(pathlib.Path({str(BENCH)!r}).glob("metrics/*.py")):
    manifest.reader(p.stem)
print(harness.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
