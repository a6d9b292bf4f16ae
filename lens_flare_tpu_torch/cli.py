"""Command line of the port: a COLLADA scene file to a PNG.

Counterpart of ``lens_flare_tpu/cli.py``, with the same flags and defaults
(the reference's surface, main.cpp:24-157), plus ``--device``: the render
runs on the CUDA card unless ``--device cpu`` asks for the CPU.  Example::

    python -m lens_flare_tpu_torch.cli -s 16 -m 5 -r 480 360 -f out.png \\
        -x aperture.png -y ghost.png -i 1.5 -n 30 scene.dae

``-e sky.exr`` lights the scene with an equirect environment map read by
the port's ``utils/exr.py``; ``--lens-model realistic`` draws the ghosts
with the sequential Snell + Fresnel lens stack (``lens/realistic.py``), with
or without aperture PNGs; the two together are BASELINE config 3.
``--upsample N`` Loop-subdivides every mesh N levels before the render
(``scene/halfedge.py:subdivide_scene``); ``--view`` opens the terminal
viewer (``term_viewer.py``) on the configured, loaded renderer in place of
the render to ``-f``.  ``--devices N`` (or ``-t N``, the reference's
worker count; ``--devices`` takes precedence) shards every wavefront over
the first N CUDA devices, 0 (the default) over all of them: on a machine
with one card that is one device.  ``--trace DIR`` writes a
``torch.profiler`` Chrome trace of the render to ``DIR/trace.json``.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="lens-flare-tpu-torch",
        description="Path tracer with physically-based lens flare, on PyTorch and CUDA",
    )
    p.add_argument("scene", help="COLLADA (.dae) scene file")
    p.add_argument("-s", type=int, default=1, dest="ns_aa", help="camera rays per pixel")
    p.add_argument("-l", type=int, default=1, dest="ns_area_light", help="samples per area light")
    p.add_argument("-t", type=int, default=0, dest="num_threads",
                   help="worker parallelism (reference: thread-pool size; here: rendering devices, as --devices)")
    p.add_argument("-m", type=int, default=1, dest="max_ray_depth", help="maximum ray depth")
    p.add_argument("-e", dest="envmap", default=None, help="environment map (.exr)")
    p.add_argument("-b", type=float, default=0.0, dest="lens_radius", help="aperture (lens) radius")
    p.add_argument("-d", type=float, default=0.0, dest="focal_distance", help="focal distance")
    p.add_argument("-a", nargs=2, default=None, metavar=("BATCH", "TOL"), help="adaptive sampling: samples per batch + tolerance")
    p.add_argument("-f", dest="output", default="out.png", help="output PNG")
    p.add_argument("-r", nargs=2, type=int, default=[800, 600], metavar=("W", "H"), help="width height")
    p.add_argument("-p", nargs=4, type=int, default=None, metavar=("X", "Y", "DX", "DY"), help="render subwindow cell")
    p.add_argument("-c", dest="cam_settings", default=None, help="camera settings file")
    p.add_argument("-x", dest="aperture", default=None, help="aperture PNG (starburst)")
    p.add_argument("-y", dest="ghost_aperture", default=None, help="ghost-aperture PNG")
    p.add_argument("--bokeh", dest="bokeh", default=None, help="bokeh mask PNG for aperture-shaped DoF")
    p.add_argument("-i", type=float, default=0.0, dest="flare_intensity", help="lens flare intensity")
    p.add_argument("-n", type=float, default=0.0, dest="flare_radius", help="lens flare radius")
    p.add_argument("-H", action="store_true", dest="hemisphere", help="uniform hemisphere direct sampling")
    p.add_argument("--indirect", action="store_true", help="enable indirect bounces")
    p.add_argument(
        "--lens-model", choices=("paraxial", "realistic"), default="paraxial", dest="lens_model",
        help="ghost model: paraxial 2x2 matrices, or the realistic Snell + Fresnel lens stack",
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--upsample", type=int, default=0, metavar="N",
                   help="Loop-subdivide every scene mesh N levels before rendering (EDIT mode's 'u' key, offline)")
    p.add_argument("--devices", type=int, default=0, help="shard the render over the first N devices (0 = all available)")
    p.add_argument("--trace", dest="trace_dir", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of the render to DIR/trace.json")
    p.add_argument("--view", action="store_true",
                   help="open the interactive terminal viewer instead of rendering to -f (keys: r/v/e/s, "
                   "[ ] - = < > k l ; ' C d, space, arrows; mouse orbit/pan/autofocus)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="run on the CUDA card (default) or on the CPU")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from .renderer import Renderer

    envmap = None
    if args.envmap:
        from .utils import exr

        print(f"[PathTracer] Loading environment map {args.envmap}")
        envmap = exr.read(args.envmap)

    spb, tol = (64, 0.05)
    if args.a is not None:
        spb, tol = int(args.a[0]), float(args.a[1])
    r = Renderer(
        width=args.r[0],
        height=args.r[1],
        ns_aa=args.ns_aa,
        max_ray_depth=args.max_ray_depth,
        ns_area_light=args.ns_area_light,
        samples_per_batch=spb,
        max_tolerance=tol,
        direct_hemisphere_sample=args.hemisphere,
        indirect=args.indirect or args.max_ray_depth > 1,
        lens_radius=args.lens_radius,
        focal_distance=args.focal_distance,
        envmap=envmap,
        aperture_path=args.aperture,
        ghost_aperture_path=args.ghost_aperture,
        bokeh_path=args.bokeh,
        flare_intensity=args.flare_intensity,
        flare_radius=args.flare_radius,
        lens_model=args.lens_model,
        camera_settings=args.cam_settings,
        seed=args.seed,
        device=args.device,
        # -t is the reference's parallelism knob (its thread-pool size, main.cpp:106-108); both
        # flags drive the mesh the wavefronts are sharded over, --devices first, 0 = all
        devices=args.devices if args.devices > 0 else (args.num_threads or 0),
    )
    print(f"[PathTracer] Loading scene {args.scene}")
    t0 = time.perf_counter()
    r.load(args.scene, build=args.upsample == 0)  # a subdivided scene is built once, after the subdivision
    sub_s = 0.0
    if args.upsample > 0:
        from .scene.halfedge import subdivide_scene

        n_tris = r.scene.num_triangles
        t_sub = time.perf_counter()
        scene = subdivide_scene(r.scene, args.upsample)
        sub_s = time.perf_counter() - t_sub
        print(f"[PathTracer] Loop-subdivided x{args.upsample}: {n_tris} -> {scene.num_triangles} triangles")
        print(f"[PathTracer] Subdivided in {sub_s:.4f} sec")
        r.load_flat_scene(scene, camera=r.camera)
    route = "cluster tree" if r.bundle.cscene is not None else "binary BVH"
    print(
        f"[PathTracer] Scene loaded: {r.scene.num_triangles} triangles, {r.scene.num_spheres} spheres, "
        f"{len(r.scene.lights.light_type)} lights, {route}; parse + build {time.perf_counter() - t0 - sub_s:.4f} sec "
        f"(BVH build {r.stats.bvh_build_time:.4f} sec)"
    )
    mesh = r._mesh or (r.bundle.scene.tri_shade.device,)
    print(f"[PathTracer] Rendering on {r.n_shards} shard(s) over {len(set(mesh))} device(s): "
          f"{', '.join(str(d) for d in mesh)}")
    if args.view:
        # the viewer takes the configured, loaded renderer: every flag above applies
        if args.trace_dir:
            print("[PathTracer] --trace applies to offline renders only; ignoring it for the interactive viewer")
        from .app import Application
        from .term_viewer import run_viewer

        return run_viewer(Application(r, filename=str(Path(args.output).with_suffix(""))))
    cell = tuple(args.p) if args.p else None
    if args.trace_dir:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if args.device == "cuda" else [])
        with profile(activities=activities) as prof:
            r.render_to_file(args.output, cell=cell)
        out = Path(args.trace_dir)
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out / "trace.json"))
        print(f"[PathTracer] profiler trace written to {out / 'trace.json'}")
    else:
        r.render_to_file(args.output, cell=cell)
    return 0


if __name__ == "__main__":
    sys.exit(main())
