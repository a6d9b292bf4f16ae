"""Command line of the port: a COLLADA scene file to a PNG.

Counterpart of ``lens_flare_tpu/cli.py``, with the same flags and defaults
(the reference's surface, main.cpp:24-157), plus ``--device``: the render
runs on the CUDA card unless ``--device cpu`` asks for the CPU.  Example::

    python -m lens_flare_tpu_torch.cli -s 16 -m 5 -r 480 360 -f out.png \\
        -x aperture.png -y ghost.png -i 1.5 -n 30 scene.dae

``-e sky.exr`` lights the scene with an equirect environment map read by
the port's ``utils/exr.py``; ``--lens-model realistic`` draws the ghosts
with the sequential Snell + Fresnel lens stack (``lens/realistic.py``), with
or without aperture PNGs; the two together are BASELINE config 3.  Flags
whose features are not ported yet raise NotImplementedError naming their
ROADMAP Queue 1 item: ``--upsample`` and ``--view`` (item 10), and
``--devices`` or ``-t`` above 1 (item 9).  ``--trace DIR`` writes a
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
    p.add_argument("-t", type=int, default=0, dest="num_threads", help="rendering devices, as --devices (1 only)")
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
    p.add_argument("--upsample", type=int, default=0, metavar="N", help="Loop-subdivide meshes N levels; not ported yet")
    p.add_argument("--devices", type=int, default=0, help="rendering devices (0 = all available; 1 only)")
    p.add_argument("--trace", dest="trace_dir", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of the render to DIR/trace.json")
    p.add_argument("--view", action="store_true", help="interactive terminal viewer; not ported yet")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="run on the CUDA card (default) or on the CPU")
    return p


def _refuse_unported(args) -> None:
    """Raise for a flag whose feature the port does not have yet, naming its ROADMAP item."""
    refused = [
        (args.upsample > 0, "--upsample", 10),
        (args.view, "--view", 10),
        (max(args.devices, args.num_threads) > 1, "--devices / -t above 1", 9),
    ]
    for given, flag, item in refused:
        if given:
            raise NotImplementedError(f"{flag} is not ported yet (ROADMAP Queue 1, item {item})")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    _refuse_unported(args)

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
    )
    print(f"[PathTracer] Loading scene {args.scene}")
    t0 = time.perf_counter()
    r.load(args.scene)
    route = "cluster tree" if r.bundle.cscene is not None else "binary BVH"
    print(
        f"[PathTracer] Scene loaded: {r.scene.num_triangles} triangles, {r.scene.num_spheres} spheres, "
        f"{len(r.scene.lights.light_type)} lights, {route}; parse + build {time.perf_counter() - t0:.4f} sec "
        f"(BVH build {r.stats.bvh_build_time:.4f} sec)"
    )
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
