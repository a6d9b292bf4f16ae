"""lens-flare-tpu on PyTorch and CUDA: the port of ``lens_flare_tpu`` to an NVIDIA H100.

The JAX package ``lens_flare_tpu`` stays the reference; this package mirrors
its layout so each module's counterpart sits at the same path:

- ``scene``       camera parameters and ray generation on the device
- ``ops``         scene tables, hit finalization, and the hand-written CUDA
                  ray/triangle kernels (``ops/csrc``) with their plain
                  PyTorch versions
- ``integrator``  wavefront path tracing: BSDFs, lights, NEE, bounces
- ``lens``        aperture masks, the paraxial lens, ghost splatting
- ``flare``       FFT starburst, falloff glow, the compositing pipeline
- ``utils``       PNG output
- ``convert``     the JAX package's state as the port's tensors (tests)

It imports torch and NumPy and never JAX.  From the JAX package it uses
only NumPy host modules: scene parsing and building, the host ``Camera``,
the wide cluster-tree builder and the image transforms.
"""

__version__ = "0.1.0"
