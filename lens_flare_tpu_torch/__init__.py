"""lens-flare-tpu on PyTorch and CUDA: the port of ``lens_flare_tpu`` to an NVIDIA H100.

The JAX package ``lens_flare_tpu`` stays the reference; this package mirrors
its layout so each module's counterpart sits at the same path:

- ``scene``       the host scene arrays, procedural terrain, the host camera,
                  camera parameters on the device and ray generation
- ``accel``       the two-level cluster tree and its native (g++) builder
- ``ops``         scene tables, hit finalization, and the hand-written CUDA
                  ray/triangle kernels (``ops/csrc``) with their plain
                  PyTorch versions
- ``integrator``  wavefront path tracing: BSDFs, lights, NEE, bounces
- ``lens``        aperture masks, the paraxial lens, ghost splatting
- ``flare``       FFT starburst, falloff glow, the compositing pipeline
- ``utils``       image transforms and PNG output
- ``bench_kernels``  the kernel bench: every trace kernel on terrain
                  wavefronts (``python -m lens_flare_tpu_torch.bench_kernels``)
- ``convert``     the JAX package's state as the port's tensors (tests)

It imports torch and NumPy, never JAX, and nothing of the JAX package: the
host modules it needs (scene arrays, terrain, camera, cluster-tree builder,
image transforms) are copies kept under the same module names.
"""

__version__ = "0.1.0"
