"""lens-flare-tpu on PyTorch and CUDA: the port of ``lens_flare_tpu`` to an NVIDIA H100.

The JAX package ``lens_flare_tpu`` stays the reference; this package mirrors
its layout so each module's counterpart sits at the same path:

- ``scene``       the COLLADA loader, the host scene arrays, procedural
                  terrain, the host camera, camera parameters on the device
                  and ray generation; COLLADA files and skies written in
                  code (``writer``); the halfedge mesh, its edit operations
                  and Loop subdivision (``halfedge``)
- ``accel``       the two-level cluster tree, the binary SAH BVH, and their
                  native (g++) builder
- ``ops``         scene tables, hit finalization, and the hand-written CUDA
                  ray/triangle kernels (``ops/csrc``: A-F on the cluster
                  tree, G on the binary BVH) with their plain PyTorch
                  versions
- ``integrator``  wavefront path tracing: BSDFs, lights, NEE, bounces
- ``lens``        aperture masks, the paraxial lens, ghost splatting
- ``flare``       FFT starburst, falloff glow, the compositing pipeline,
                  the ghost buffers' moments (``moments``)
- ``diff``        differentiable rendering (emitter recovery) and paraxial
                  lens design with Adam and resumable checkpoints
- ``utils``       image transforms, PNG input and output
- ``renderer``    the tiled wavefront ``Renderer`` (``load`` a COLLADA file)
- ``parallel``    multi-device rendering: wavefronts sharded over a mesh of
                  devices, the scene replicated (``Renderer(devices=)``,
                  ``render_sharded``, the row-sharded lens-design step)
- ``compiled``    captured CUDA graphs of one sample of a tile or adaptive
                  chunk and of the ghost buffers, replayed per call (``compiled.disabled()``
                  runs eagerly)
- ``app``         the interactive Application: EDIT preview and mesh edits,
                  VISUALIZE, progressive RENDER (headless)
- ``term_viewer`` its terminal front end (``--view``)
- ``cli``         the command line (``python -m lens_flare_tpu_torch.cli``)
- ``bench_kernels``  the kernel bench: every trace kernel on terrain
                  wavefronts (``python -m lens_flare_tpu_torch.bench_kernels``)
- ``convert``     the JAX package's state as the port's tensors (tests)

It imports torch and NumPy, never JAX, and nothing of the JAX package: the
host modules it needs (COLLADA loader, scene arrays, terrain, camera, BVH
and cluster-tree builders, halfedge mesh, terminal viewer, image
transforms) are copies kept under the
same module names.
"""

__version__ = "0.1.0"
