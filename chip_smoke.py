#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card, end to end.

    python3 chip_smoke.py

Phases (each prints one line with its numbers and seconds; any failure
raises, so the script exits non-zero and prints no result):

0. the device: torch's name for it, and name and power limit from nvidia-smi;
1. build the CUDA kernels from the sources in this checkout (nvcc, sm_90a);
2. each kernel against its plain PyTorch version on the card, on terrain
   scenes of 128, 450 (with 70 spheres, past the Pallas kernel's 64),
   3,200, 131,072 and 524,288 triangles with camera, bounce and shadow rays
   of random pixels, plus each one's time beside the plain version's at 64k
   lanes; every kernel must equal its plain version bit for bit on every
   set, A at chunk batch 2 on the single-level trees and at chunk batch 1
   on the others, C (any hit and the closest-hit flag) on both brute-mode
   scenes.  The
   walk is also timed on the first 64k pixels in the renderer's 32x32-block
   order (A camera and bounce on 524,288 triangles, D camera and bounce on
   131,072, B shadow on both), A on the single-level tree and on the
   131,072-triangle tree, B on the 131,072-triangle shadow rays, and C on
   both brute-mode scenes;
   kernel D (closest hit plus shading rows, on the two mid-size scenes) is
   also held to kernel A's outputs and timed against A plus
   ``finalize_hit``'s row gather; kernel F (the group walk, top_batch 2
   and 4, closest hit, any hit and shade) on the two mid-size scenes,
   exactly against its plain version and against A, B and D; kernel E (the
   coefficient walk) on the exact-fit trees of 8,192 and 32,768 triangles,
   exactly against its plain version and against A (hits and slots equal
   on all but at most 1 lane in 10,000, t within 1e-3 relative); kernel H
   (the threefry tape) bit for bit against its plain int64 version, a
   sample's fold_in and its uniform draw of U = 32 and 40 on 65,536 lanes,
   timed beside the plain version and its bound (the ``rng`` line); kernel I
   (the vertex shading) on a 65,536-lane camera and bounce vertex of each
   terrain cell, timed beside its byte bound and the plain vertex
   functions, every output of I-a and I-b on both vertices bit for bit
   against theirs (the ``vertex`` line, ``bench_kernels.bench_vertex``);
3. the slice: the 1920x1080 frame of the 524,288-triangle terrain at 1 spp,
   depth 4, NEE and RR bounces, then the paraxial flare composite, written
   as a PNG; launch counts show the frame went through kernels A, B, H and I;
4. a 320x240 frame of the 128-triangle terrain, which traces its shadow
   rays with kernel C and its closest hits with kernel A on a single-level
   tree (chunk batch 2), held against the same frame rendered on the CPU;
5. config2_frame: the thin-lens octagon-bokeh adaptive render (ns_aa 16,
   stages of 4, 4 and 8 samples) of the 131,072-triangle terrain at
   1920x1080, focused by autofocus; its closest hits go through kernel D;
6. config2_small: the same settings at 320x240 (ns_aa 8) on the
   3,200-triangle terrain, held against the same frame rendered on the CPU;
7. kernel_bench: ``python -m lens_flare_tpu_torch.bench_kernels`` at full
   width (262,144-lane wavefronts), the path that runs kernels E and F; its
   rows and launch counts, then every E and F call it timed (E on both
   exact-fit trees with primary and bounce rays; F at top_batch 2 and 4 on
   the bounce and shadow wavefronts) held exactly against its plain
   version, tests included, on the bench's own scenes and rays, with the
   bench's time beside the plain version's;
8. dae_small: a Cornell-box COLLADA file through the command line (C, A,
   and kernel I's general instance, no plain vertex), its PNG held to the
   frame and a cell of it to the CPU render; then the ``cornell_256_16spp``
   cell's frame (256x256, 16 spp, depth 5, ``Renderer.load``): its 80
   vertex wavefronts all on kernel I, its launches and seconds a replayed
   frame (the ``cornell_cell`` line);
9. dae_1080p: terrain 256 as a COLLADA file at 1920x1080 with aperture
   PNGs and the flare (D, B);
10. g_kernel: kernel G against its plain version on terrain 512's binary BVH
    (random camera and shadow rays), and against the cluster walk's hits;
    the tree's build and packing seconds;
11. past_capacity: 16,785,218 triangles, past the cluster tree, through G:
    the frame (64 launches of G, 4,166,786 rays, 5.62 tests per ray), the
    scene's device MiB and packing seconds, and G against its plain version
    bit for bit on random and on the frame's own blocked camera and shadow
    wavefronts (rows Gb-Ge);
12. diff_small (BASELINE config 5): the Cornell box at 320x240, 4 spp,
    depth 2, camera on the emitter; the render and its gradients in the
    emitter's BSDF row, the area light's row and a wall's albedo, through A
    and C, held to the CPU's plain path (1e-4 of their peak), then
    ``recover_emitter`` (80 steps from (2, 2, 2)) to the true colour, twice
    eager (``compiled.disabled()``) and once captured (``compiled.Step``:
    step 1 warms up, step 2 captures, the rest replay): the captured
    losses and colour bit-equal to the eager ones where the two eager runs
    are (else within 1e-4 relative, the eager spread printed beside it);
    eager and captured ms per step, the warm-up and capture steps, capture
    s, programs, launches per step and peak MiB (``step_numbers``);
13. diff_cell: a 512x512 cell of terrain 256's 1080p frame (262,144 lanes,
    1 spp, depth 4, D and B), the gradients in the area light's row and the
    diffuse albedo, each held to a central difference along itself (1e-4
    relative for the light row, 1e-3 for the albedo); forward and backward
    seconds and peak device memory; then ``recover_emitter`` of the area
    light's colour on the cell, 20 steps, eager twice and captured, held
    and reported as in phase 12;
14. lens_design: ``optimize_lens`` at 128x128 from a perturbed curvature,
    its forward model and gradient held to the CPU's (1e-6 and 5e-6 of
    their peak), 35 steps eager and 35 captured (bit-equal losses and
    lens; the numbers of phase 12), and a captured run
    checkpointed at 30 and resumed to 35 giving the same losses and lens;
15. render_resume: the small frame (tiled) and config2_small (adaptive),
    each interrupted after its first tile or stage and resumed from its
    checkpoint, bit-equal to the uninterrupted render;
16. env_small: terrain 8 as a COLLADA file under a 512x256 HALF ZIP sky
    (``sky_map``, written by the port's ``utils/exr.write``), the camera
    pulled back by a ``-c`` file, 320x240, ``-s 16 -m 5`` through the
    command line (C, A); its PNG held to the frame and a cell where terrain
    meets sky to the CPU render;
17. env_1080p: terrain 256's file under a 4096x2048 HALF ZIP sky (a sun
    disk at 6e4) at 1920x1080, ``-s 1 -m 4``, aperture PNGs and the flare
    (D, B): the EXR write and read, ``build_env`` and frame seconds, rays,
    launches and peak device memory above the phase's start, then the same
    render with and without the sky under ``torch.profiler``;
18. env_diff: the gradient in every texel of env_small's sky for a
    512x512 cell of terrain 8's 1080p frame (1 spp, depth 2; A, C), held
    to the CPU's plain path (the gradient to 1e-4 of its peak; every pixel
    to 1e-4 of its value plus what two ulps of the lookup's angles move it,
    all but 0.1% without that term) and to a central difference along
    itself (1e-4 relative);
19. realistic_1080p (BASELINE config 3 whole): env_1080p's file and sky
    with ``-x`` and ``--lens-model realistic`` (no ghost PNG: the Snell +
    Fresnel stack needs none) through the command line (D, B): frame
    seconds, launches and peak device memory; the same frame rendered
    unflared, its flare strictly additive and the PNG within one level of
    it; the realistic ghost buffer alone (seconds, device launches and
    kernel ms under ``torch.profiler``) beside the paraxial one of the same
    pipeline, held to the CPU's (1e-3 of the peak, the CPU test's
    tolerance against JAX, which covers ``index_add``'s accumulation
    order), each ghost that reaches the film, rendered alone, held to the
    CPU's in energy, centroid and radius (``ghost_checks``: float32 to
    ``GHOST_F32``, float64 to ``GHOST_F64``) and the whole buffer in
    float64 (1e-9 of the peak), and two card runs of the buffer, which
    must be equal (``ghost_two_card_runs_maxabs=0``: the taps are summed in
    a fixed order, ``realistic.ordered_sum``); the CLI's PNG equals the
    flared frame's; then
    ``realistic_design``: curvature 7 recovered from 1.25x through the
    stack by 150 Adam steps (64x64, 12x12 pupil, pairs (0, 1), (2, 4),
    (6, 8)), the loss below 1e-3 of its start and the curvature within 5%
    of the perturbation, ms per step, and the start gradient against the
    CPU's (1e-3 of its peak).

20. upsample_1080p: terrain 256's file (131,072 triangles, four polylists)
    through the command line with ``--upsample 1``: Loop-subdivided to
    524,288 triangles (``scene/halfedge.py:subdivide_scene``), 1920x1080,
    1 spp, depth 4, aperture PNGs and the flare (A, B); subdivide, load
    (the subdivided scene's one build), frame and command-line seconds,
    launches; the same renderer built
    in this process, its frame replayed against an eager one, and a 64x64
    cell at the centre held against the port's CPU path;
21. interactive: the viewer's ``Application`` on that renderer at
    1920x1080: the EDIT preview (256x144; its program replayed and eager,
    ms per frame, and an orbit that replays without a new capture, bit-equal
    to eager), VISUALIZE (the host binary BVH's first frame and later
    frames), RENDER with ``ns_aa`` 4 and ``progressive_batch`` 1 (each of
    the four frames replayed bit-equal to the eager one, launches equal,
    the finished film equal to ``Renderer.render`` within rtol 1e-5, atol
    1e-6), the ``=`` key (the settings change: the programs are dropped and
    the next frame captures four, with its seconds and the peak device
    MiB), ``frame_to_ansi`` of the last frame at 160x45 cells, and the
    mesh-edit keys u, d, i, f, s and c on the Cornell box's block, on the
    card and on the CPU: the same triangles after each key, the programs
    dropped by each edit, the previews and a RENDER frame alike; that
    scene's vertices take kernel I's general instance (four BSDF families,
    an area light), and a RENDER frame of terrain 512 at 800x600, the
    viewer cell's path, takes its diffuse instance (the ``viewer_frame``
    line);
22. compiled: every frame and ghost buffer above runs through captured CUDA
    graphs (``lens_flare_tpu_torch/compiled.py``) by default, so the CLI's
    one-shot frames (phases 8, 9, 16, 17, 19) include their capture in
    ``frame_s``, and the timed frames of phases 3, 5 and 11 follow a warm-up
    that captured.  ``terrain_1080p``, ``config2_frame``, ``dae_small``,
    ``past_capacity`` and ``env_1080p`` (the sky-lit render of phase 17's
    file) are each, at the start of their phase, rendered under
    ``compiled.disabled()`` and then replayed (``ab_compiled.compare``):
    film, counts, rays, tests and skipped lanes bit-equal, launches per
    frame equal, and equal to each kernel's calls in the trace of a
    replayed frame (a replay adds the launches its capture recorded; the
    trace shows what the graph ran); capture s, eager and replayed
    ``frame_s``, peak device MiB with and without capture, and the
    replay's busy share under ``torch.profiler``, one ``[compiled:<frame>]``
    line each; so are phase 20's frame and phase 21's preview and
    progressive frame (``upsample_1080p``, ``app_preview``,
    ``app_progressive``).  Phases 3, 5, 8 and 11 hold their main path's launches to
    those traced calls.  A flared film is held bit for bit too.  Phase
    19's realistic and paraxial ghost buffers are compared with their
    eager ones bit for bit (``bit_equal``; the realistic one must be) and
    per channel within ``GHOST_F32`` (energy, centroid, radius).  Phases 20 and 21
    hold the command line's and the progressive frame's launches to the
    traced calls too.  The phase's line sums the rows up;
23. sharded: ``terrain_1080p`` through ``Renderer(devices=0)`` on a mesh of
    two stand-in shards of ``cuda:0`` (``parallel.mesh.available_devices``
    replaced for the build; printed as stand-ins), and on every card where
    there are more than one: eager, capturing and replayed frames bit-equal
    to one device's, equal stats, each kernel launched once per shard;
    capture s and ``frame_s``; the command line's ``--devices 0`` on the
    stand-ins writes the PNG of ``--devices 1``; the lens-design step
    (``parallel.render.make_train_step``, 128x128) unsharded and
    row-sharded over the stand-ins, 10 steps each eager and captured
    (bit-equal; the numbers of phase 12), the sharded equal to the
    unsharded (rtol 1e-6); and a one-rank NCCL group
    (``torch.distributed.init_process_group``; ``nccl_world=1``: not
    two-card evidence)
    running ``render_sharded`` on the frame's first 65,536-lane wavefront,
    bit-equal to ``render_wavefront``, the train step (eager when sharded
    under the group: its gradients' ``all_reduce``), and the frame
    through ``Renderer(devices=0)`` on the stand-ins, bit-equal;
24. turntable: terrain 512's COLLADA file (524,288 triangles) through
    ``python -m lens_flare_tpu_torch.turntable`` at 1920x1080, ``-s 1 -m
    4``, 8 frames (A, B): seconds of frame 0 (with the capture) and of the
    later frames, the programs after frames 0, 1 and the last (equal: the
    camera is a program input), 8 PNGs and 8 dumped camera files; then the
    last frame rendered again through the command line with ``-c
    frames/frame_8.txt`` and the same size, ``-s`` and ``-m``: its PNG
    equal to ``frame_007.png``.

The last line is {"ok": true, "device": {...}}; before it come the card's
nvidia-smi line and a JSON line with every kernel's numbers: launches on
its path (0 for C's 450-triangle case, which no path traces), the largest error against its plain version, its time, the
plain version's, and its bound (the larger of the FLOPs the function needs
over 67 TFLOP/s, the H100's float32 peak without tensor cores, and the least
bytes it must move over 3.35 TB/s; see ``bench_kernels.bound``).  Phase 1
prints ptxas' registers and spilled bytes of kernel C's two instances and
kernel E on a line of their own.  TF32 is off for
matrix products and convolutions: the ghost products are float32.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

# the scenes and the ghost-moment checks that the smoke, the A/B scripts and the tests share
from lens_flare_tpu_torch.flare.moments import GHOST_F32, buffer_moments, ghost_errors
from lens_flare_tpu_torch.scene.writer import cornell_box, sky_map, terrain_dae

ROOT = Path(__file__).resolve().parent
LANES = 1 << 16  # wavefront width of the main path (Renderer.tile_pixels)
BENCH_LANES = 1 << 18  # wavefront width of the kernel bench (E's and F's path)
# (kernel, rays, terrain n_quads) of phase 2 that are timed -> their label;
# "random" rays are LANES random pixels of the 1920x1080 film, "blocked" the
# first LANES pixels in the renderer's 32x32-block order
TIMED = {
    ("A", "camera", 512): "A", ("B", "shadow", 512): "B", ("C", "shadow", 8): "C",
    ("D", "camera", 256): "D", ("A", "camera", 256): "A_vmem", ("C", "camera", 8): "C_closest",
    ("B", "shadow", 256): "B_t256",
    ("D", "camera_blocked", 256): "D_blocked_camera", ("D", "bounce_blocked", 256): "D_blocked_bounce",
    ("B", "shadow_blocked", 256): "B_blocked_t256", ("B", "shadow_blocked", 512): "B_blocked",
    ("A", "camera_blocked", 512): "A_blocked_camera", ("A", "bounce_blocked", 512): "A_blocked_bounce",
    ("A", "camera", 8): "A_single",
    ("C", "shadow", 15): "C_t450_spheres", ("C", "camera", 15): "C_closest_t450_spheres",
}
# the kernels line: each kernel at its PERF.md table shape, then the warp walk's other timed shapes
LINE_CASES = {
    "A": "terrain512_camera_random", "B": "terrain512_shadow_random", "C": "terrain8_shadow_random",
    "D": "terrain256_camera_random", "E": "bench_terrain128_bounce", "F": "bench_terrain256_bounce_tb2",
    "B_t256": "terrain256_shadow_random", "D_blocked_camera": "terrain256_camera_blocked",
    "D_blocked_bounce": "terrain256_bounce_blocked", "B_blocked_t256": "terrain256_shadow_blocked",
    "B_blocked": "terrain512_shadow_blocked",
    "A_blocked_camera": "terrain512_camera_blocked", "A_blocked_bounce": "terrain512_bounce_blocked",
    "A_single": "terrain8_camera_random", "C_t450_spheres": "terrain15_spheres70_shadow_random",
}
# kernel H's rows of the kernels line: one sample's tape on a 65,536-lane tile, U = 32 (depth 4 and
# two light slots: terrain_1080p) and U = 40 (three: realistic_1080p)
RNG_TAPES = {"H": 32, "H_u40": 40}
# kernel G's rows of the kernels line: terrain 512's binary BVH (phase 10)
# and the scene past the cluster tree's capacity (phase 11)
G_CASES = {
    "G": "terrain512_camera_random_binary_bvh", "G_any_hit": "terrain512_shadow_random_binary_bvh",
    "G_past_capacity": "terrain2897_camera_random", "G_any_hit_past_capacity": "terrain2897_shadow_random",
    "G_blocked_past_capacity": "terrain2897_camera_blocked",
    "G_any_hit_blocked_past_capacity": "terrain2897_shadow_blocked",
}
# the frames of the compiled phase: each replayed against a compiled.disabled() frame in its own phase
COMPILED_FRAMES = ("terrain_1080p", "config2_frame", "dae_small", "past_capacity", "env_1080p",
                   "ghost_realistic", "ghost_paraxial", "upsample_1080p", "app_preview", "app_progressive")
# past_capacity's frame (1920x1080, 1 spp, depth 1): 32 camera and 32 shadow wavefronts, all through G
PAST_CAPACITY_FRAME = {"launches": 64, "rays": 4_166_786, "isects_per_ray": "5.62"}
PAST_CAPACITY_QUADS = 2897  # 2 * 2897^2 = 16,785,218 triangles, past 512*128*256
SPHERE_SCENE = (15, 70)  # a brute-mode terrain near BRUTE_MAX_TRIS, with spheres built in code
BLOCKED_SCENES = (256, 512)  # config2_frame's tree and terrain_1080p's
# the card's realistic ghosts against the CPU's in float64 (``ghost_checks``; GHOST_F32, from
# flare/moments.py, holds float32): float64, which read <= 3.8e-14 on an H100, is the witness that
# the card computes what the CPU does
GHOST_F64 = {"energy": 1e-12, "centroid_px": 1e-11, "radius": 1e-12}


def aim_at_emitter(renderer) -> None:
    """Point a loaded renderer's camera from low in the box at light 0 (the Cornell box's area light),
    so that the emitter is in view, as ``tests/test_diff_render.py`` places it."""
    import numpy as np

    scene, cam = renderer.scene, renderer.camera
    lightp = np.asarray(scene.lights.position[0], np.float64)
    centre = (np.asarray(scene.bbox_min) + np.asarray(scene.bbox_max)) / 2.0
    cam.pos = centre - np.array([0.0, 0.4, 0.0]) * (scene.bbox_max[1] - scene.bbox_min[1])
    cam.target_pos = lightp
    d2c = cam.pos - lightp
    d2c /= np.linalg.norm(d2c)
    sx = np.array([1.0, 0.0, 0.0])
    cam.c2w = np.stack([sx, np.cross(d2c, sx), d2c], axis=1)


def pull_back(camera, factor) -> None:
    """Move a camera back along its view, away from its target, by ``factor`` times their distance."""
    camera.pos = camera.pos + (camera.pos - camera.target_pos) * factor


def miss_share(renderer, cell=None) -> float:
    """Share of the pixel-centre camera rays of ``cell`` (x0, y0, width, height; the film by default)
    that miss the scene."""
    import numpy as np
    import torch

    from lens_flare_tpu_torch.integrator.path import trace_closest
    from lens_flare_tpu_torch.scene.camera import camera_params, generate_rays

    w, h = renderer.width, renderer.height
    x0, y0, dx, dy = cell or (0, 0, w, h)
    ys, xs = np.mgrid[y0 : y0 + dy, x0 : x0 + dx]
    dev = torch.device(renderer.device)
    cam = camera_params(renderer.camera, dev)
    o, d = generate_rays(cam, torch.as_tensor((xs.ravel() + 0.5) / w, dtype=torch.float32, device=dev),
                         torch.as_tensor((ys.ravel() + 0.5) / h, dtype=torch.float32, device=dev))
    n = o.shape[0]
    hit, _ = trace_closest(renderer.bundle, o.contiguous(), d.contiguous(), cam.n_clip.expand(n).contiguous(),
                           cam.f_clip.expand(n).contiguous())
    return 1.0 - hit.hit.double().mean().item()


def diff_case(path, device, width, height, n_samples, depth, cell=None, aim=False, back=0.0, **renderer_kw):
    """``render_image``'s inputs for a COLLADA file on ``device``: the renderer (``r``) and its bundle,
    settings, camera, the pixels of ``cell`` (x0, y0, width, height; the whole film by default), a key
    and a loss window.  ``aim``: the camera on the emitter (``aim_at_emitter``); ``back``: the camera
    pulled back (``pull_back``), so that more rays miss."""
    from types import SimpleNamespace

    import numpy as np
    import torch

    from lens_flare_tpu_torch import _rng
    from lens_flare_tpu_torch.integrator.path import make_settings
    from lens_flare_tpu_torch.renderer import Renderer
    from lens_flare_tpu_torch.scene.camera import camera_params

    r = Renderer(device=device, width=width, height=height, **renderer_kw)
    r.load(path)
    if aim:
        aim_at_emitter(r)
    if back:
        pull_back(r.camera, back)
    x0, y0, dx, dy = cell or (0, 0, width, height)
    ys, xs = np.mgrid[y0 : y0 + dy, x0 : x0 + dx]
    window = np.random.default_rng(11).uniform(size=(dx * dy, 3)).astype(np.float32)
    dev = torch.device(device)
    return SimpleNamespace(
        r=r, bundle=r.bundle, cam=camera_params(r.camera, dev), width=width, height=height, n=n_samples,
        settings=make_settings(r.light_table(), bsdf_table=r.scene.bsdfs, ns_aa=n_samples, max_ray_depth=depth,
                               indirect=depth > 1, samples_per_batch=n_samples, max_tolerance=0.0),
        px=torch.as_tensor(xs.ravel(), device=dev), py=torch.as_tensor(ys.ravel(), device=dev),
        key=_rng.prng_key(3, device=dev), window=torch.as_tensor(window, device=dev),
    )


def emitter_params(scene) -> dict:
    """The Cornell box's rows that the gradients are taken in, as ``{name: (group, field, row)}``: the
    emitter's BSDF radiance row, the area light's light-table row and a wall's albedo."""
    import numpy as np

    radiance, albedo = np.asarray(scene.bsdfs.radiance), np.asarray(scene.bsdfs.albedo)
    wall = next(b for b in range(len(albedo))
                if np.linalg.norm(albedo[b]) > 0.1 and np.linalg.norm(radiance[b]) == 0.0)
    return {
        "emitter": ("bsdfs", "radiance", int(np.argmax(np.linalg.norm(radiance, axis=1)))),
        "light": ("lights", "radiance", int(np.argmax(np.linalg.norm(np.asarray(scene.lights.radiance), axis=1)))),
        "albedo": ("bsdfs", "albedo", wall),
    }


def diff_render(c, bundle):
    """``render_image`` of a ``diff_case`` with ``bundle`` in place of its own."""
    from lens_flare_tpu_torch.diff.render import render_image

    return render_image(bundle, c.settings, c.cam, c.px, c.py, c.width, c.height, c.key, c.n)


def diff_grads(c, params):
    """(image, {name: gradient of sum(window * image) in the row}, forward s, backward s) of a ``diff_case``,
    each row of ``params`` (``{name: (group, field, row)}``; row None: the whole table) made a leaf."""
    import torch

    from lens_flare_tpu_torch.diff.render import replace_row

    bundle, leaves = c.bundle, {}
    for name, (group, field, row) in params.items():
        table = getattr(getattr(bundle, group), field)
        leaves[name] = (table if row is None else table[row]).detach().clone().requires_grad_(True)
        bundle = replace_row(bundle, group, field, row, leaves[name])
    t_f = time.perf_counter()
    image = diff_render(c, bundle)
    loss = torch.sum(c.window * image)
    if image.is_cuda:
        torch.cuda.synchronize()
    t_b = time.perf_counter()
    loss.backward()
    if image.is_cuda:
        torch.cuda.synchronize()
    return image.detach(), {k: v.grad for k, v in leaves.items()}, t_b - t_f, time.perf_counter() - t_b


def float32_lens(device, dtype):
    """The reference lens rounded to float32, then cast to ``dtype``: a float64 run of it sees a float32
    run's inputs, so their difference is the arithmetic's alone."""
    import dataclasses

    from lens_flare_tpu_torch.diff.optimize import LENS_FIELDS
    from lens_flare_tpu_torch.lens.prescription import reference_prescription

    lens = reference_prescription(device=device)
    return dataclasses.replace(lens, **{f: getattr(lens, f).to(dtype) for f in LENS_FIELDS})


def ghost_moments(angle, radiance, axis, width, height, device, dtype):
    """Each ghost of ``render_ghosts_stack`` (one pair, one channel, rendered alone) on ``device`` in
    ``dtype``: its energy on the film, the centroid of that energy from the sun's pixel (x, y) and its
    RMS radius about the centroid, as {"i-j:c": (energy, (x, y), radius)} float64 tensors.  The inputs
    are rounded to float32 first (``float32_lens``), so a float64 run differs by its arithmetic alone."""
    import torch

    from lens_flare_tpu_torch.lens.paraxial import reference_ghost_pairs
    from lens_flare_tpu_torch.lens.realistic import render_ghosts_stack

    args = [torch.tensor(v, dtype=torch.float32).to(device, dtype) for v in (angle, radiance, axis)]
    out = {}
    for i, j in reference_ghost_pairs():
        buf = render_ghosts_stack(float32_lens(device, dtype), *args, width, height, pairs=[(i, j)])
        out.update(buffer_moments(buf, axis, f"{i}-{j}"))
    return out


def ghost_checks(angle, radiance, axis, width, height):
    """The card's ghosts against the CPU's in float32 and float64, and float32 against the CPU's float64
    on each side, as {comparison: {measure: [largest value, its ghost], "on_film": ghosts compared}}.
    Fails unless float32 holds to GHOST_F32 and float64 to GHOST_F64 on every ghost on the film."""
    import torch

    m = {(dev, dt): ghost_moments(angle, radiance, axis, width, height, dev, dt)
         for dev in ("cuda", "cpu") for dt in (torch.float32, torch.float64)}
    f32, f64 = torch.float32, torch.float64
    worst = {}
    for name, a, b in (("card_vs_cpu_f32", ("cuda", f32), ("cpu", f32)), ("card_vs_cpu_f64", ("cuda", f64), ("cpu", f64)),
                       ("card_f32_vs_cpu_f64", ("cuda", f32), ("cpu", f64)), ("cpu_f32_vs_f64", ("cpu", f32), ("cpu", f64))):
        errs = ghost_errors(m[a], m[b])
        assert errs["energy"], f"{name}: no ghost on the film"
        worst[name] = {k: [max(v.values()), max(v, key=v.get)] for k, v in errs.items()}
        worst[name]["on_film"] = len(errs["energy"])
    for name, limits in (("card_vs_cpu_f32", GHOST_F32), ("card_vs_cpu_f64", GHOST_F64)):
        for k, limit in limits.items():
            assert worst[name][k][0] <= limit, f"{name} {k}: {worst[name][k]} above {limit}"
    return worst


def phase(title, t0, **numbers):
    fields = " ".join(f"{k}={v}" for k, v in numbers.items())
    print(f"[{title}] {fields} seconds={time.perf_counter() - t0:.3f}", flush=True)


def compare(got, want):
    """CPU-test tolerances (tests/test_torch_intersect.py); returns (max_abs_err, exact)."""
    import torch

    t_g, s_g, b_g, n_g = got
    t_w, s_w, b_w, n_w = want
    hit_g, hit_w = s_g >= 0, s_w >= 0
    both = hit_g & hit_w
    assert (hit_g == hit_w).float().mean().item() >= 0.999, "hit masks differ"
    assert ((s_g == s_w) | ~both).float().mean().item() >= 0.999, "slots differ"
    assert (n_g == n_w).float().mean().item() >= 0.999, "test counts differ"
    assert abs(int(n_g.sum()) - int(n_w.sum())) <= 1e-3 * max(int(n_w.sum()), 1)
    err = 0.0
    if both.any():
        rel_t = (t_g[both] - t_w[both]).abs() / t_w[both].abs()
        assert (rel_t <= 1e-5).float().mean().item() >= 0.99 and rel_t.max().item() <= 1e-4
        db = (b_g[both] - b_w[both]).abs().max().item()
        assert db <= 1e-4
        err = max((t_g[both] - t_w[both]).abs().max().item(), db)
    exact = all(torch.equal(a, b) for a, b in zip(got, want))
    return err, exact


def step_clock():
    """A context in which the optimisation entry points' steps (``compiled.Step`` as ``diff/render.py``,
    ``diff/optimize.py`` and ``parallel/render.py`` make it) synchronize after each call and append its
    host seconds to the list it yields, and each step made is appended to that list's ``steps``.
    Every entry point reads each step's loss back to the host right after it anyway, so the sync adds
    nothing that a step does not wait for."""
    import contextlib

    import torch

    from lens_flare_tpu_torch import compiled
    from lens_flare_tpu_torch.diff import optimize, render
    from lens_flare_tpu_torch.parallel import render as prender

    class Seconds(list):
        steps: list

    seconds = Seconds()
    seconds.steps = []

    class Timed(compiled.Step):
        def __init__(self, *args):
            super().__init__(*args)
            seconds.steps.append(self)

        def __call__(self, *inputs):
            t = time.perf_counter()
            out = super().__call__(*inputs)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t)
            return out

    @contextlib.contextmanager
    def swapped():
        modules = (render, optimize, prender)
        for m in modules:
            m.Step = Timed
        try:
            yield seconds
        finally:
            for m in modules:
                m.Step = compiled.Step

    return swapped()


def step_run(call, eager: bool) -> dict:
    """One optimisation run, ``call()``, on the card: eager (``compiled.disabled()``) or captured.
    Returns its result (``out``), each step's seconds (``step_s``; captured: step 1 the warm-up, step 2
    the capture and its replay), the launches of A-G, the peak device MiB above the start, and the
    programs captured and their seconds."""
    import contextlib

    import torch

    from lens_flare_tpu_torch import compiled
    from lens_flare_tpu_torch.ops import intersect_cuda as ic

    with compiled.disabled() if eager else contextlib.nullcontext(), step_clock() as step_s:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        ic.reset_launch_counts()
        out = call()
        torch.cuda.synchronize()
    return {"out": out, "step_s": list(step_s), "launches": compiled.launch_counts(),
            "peak_mib": (torch.cuda.max_memory_allocated() - mem0) / 2**20,
            "programs": sum(len(st.programs) for st in step_s.steps),
            "capture_s": sum(st.programs.capture_s for st in step_s.steps)}


def step_numbers(eager: dict, captured: dict) -> dict:
    """The numbers a config-5 phase prints for its eager and captured runs of one step: ms per step
    (eager: every step; captured: steps 3 on, the replays), the warm-up and capture steps, capture s,
    programs, launches of A-G per step (equal on both) and peak MiB."""
    n = len(captured["step_s"])
    assert len(eager["step_s"]) == n >= 3 and eager["programs"] == 0 and captured["programs"] >= 1, (eager, captured)
    assert eager["launches"] == captured["launches"], (eager["launches"], captured["launches"])
    return {
        "eager_ms_per_step": f"{sum(eager['step_s']) / n * 1e3:.3f}",
        "captured_ms_per_step": f"{sum(captured['step_s'][2:]) / (n - 2) * 1e3:.3f}",
        "warm_up_step_ms": f"{captured['step_s'][0] * 1e3:.3f}",
        "capture_step_ms": f"{captured['step_s'][1] * 1e3:.3f}",
        "capture_s": f"{captured['capture_s']:.4f}", "programs": captured["programs"],
        "launches_per_step": json.dumps({k: v / n for k, v in captured["launches"].items() if v}),
        "eager_peak_mib": f"{eager['peak_mib']:.1f}", "captured_peak_mib": f"{captured['peak_mib']:.1f}",
    }


def main() -> int:
    import numpy as np
    import torch

    t0 = t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: this script measures the port on a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, str(ROOT))
    from lens_flare_tpu_torch import bench_kernels as bk
    from lens_flare_tpu_torch.ab_compiled import compare as compare_compiled

    kind = torch.cuda.get_device_name(0)
    smi = bk.nvidia_smi()
    assert smi, "nvidia-smi gave no name, power.limit line"
    phase("device", t0, name=json.dumps(kind), nvidia_smi=json.dumps(smi),
          torch=torch.__version__, cuda=torch.version.cuda, tf32="off")

    # -- 1. build ----------------------------------------------------------
    from lens_flare_tpu_torch.ops import _build

    t0 = time.perf_counter()
    so = _build.build()
    _build.load_library()
    ptxas = _build.ptxas_report(_build.build_log)
    phase("build", t0, library=so.name, compiled_now=bool(_build.build_log),
          nvcc_seconds=f"{_build.build_seconds:.3f}", ptxas=json.dumps(ptxas))
    redesigned = {k: v for k, v in ptxas.items() if k.startswith(("brute_kernel", "mxu_walk_kernel", "bvh_walk_kernel"))}
    assert len(redesigned) == 5 or not _build.build_log, f"ptxas did not report C's, E's and G's kernels: {ptxas}"
    print("[ptxas] " + " ".join(f"{k.replace(' ', '')}={json.dumps(v)}" for k, v in redesigned.items()), flush=True)

    # -- 2. kernels against their plain versions ---------------------------
    from lens_flare_tpu_torch.ops import intersect_cuda as ic
    from lens_flare_tpu_torch.ops.intersect import finalize_hit
    from lens_flare_tpu_torch.renderer import Renderer
    from lens_flare_tpu_torch.scene.procedural import make_terrain_scene

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    errs = {key: 0.0 for key in "ABCDEFGH"}
    times = {}
    bounds = {}
    for nq in (8, SPHERE_SCENE[0], 40, 256, 512):
        t0 = time.perf_counter()
        r = Renderer(width=1920, height=1080, max_ray_depth=4, device="cuda")
        scene = make_terrain_scene(nq)
        if nq == SPHERE_SCENE[0]:
            rng = np.random.default_rng(3)
            n_sph = SPHERE_SCENE[1]
            scene.sph_center = rng.uniform(-8, 8, (n_sph, 3)).astype(np.float32)
            scene.sph_center[:, 2] = rng.uniform(1, 3, n_sph)
            scene.sph_radius = rng.uniform(0.3, 1.0, n_sph).astype(np.float32)
            scene.sph_bsdf = np.zeros(n_sph, np.int32)
        r.load_flat_scene(scene)
        cs = r.bundle.cscene
        rays = bk.random_rays(r, LANES, gen)
        runs = [
            ("A", "camera", lambda o, d, a, b: ic.tree_closest_hit(cs, o, d, a, b),
             lambda o, d, a, b: ic.tree_plain(cs, o, d, a, b, False)),
            ("A", "bounce", lambda o, d, a, b: ic.tree_closest_hit(cs, o, d, a, b),
             lambda o, d, a, b: ic.tree_plain(cs, o, d, a, b, False)),
            ("B", "shadow", lambda o, d, a, b: ic.tree_any_hit(cs, o, d, a, b),
             lambda o, d, a, b: ic.tree_plain(cs, o, d, a, b, True)),
        ]
        if cs.brute:
            runs += [
                ("C", "shadow", lambda o, d, a, b: ic.brute_hit(cs, o, d, a, b),
                 lambda o, d, a, b: ic.brute_plain(cs, o, d, a, b)),
                ("C", "camera", lambda o, d, a, b: ic.brute_hit(cs, o, d, a, b, any_hit=False),
                 lambda o, d, a, b: ic.brute_plain(cs, o, d, a, b, any_hit=False)),
            ]
        if nq in BLOCKED_SCENES:
            blocked = bk.wavefronts(r, LANES)
            rays.update({f"{kind}_blocked": w for kind, w in zip(("camera", "bounce", "shadow"), blocked)})
            runs.append(("B", "shadow_blocked", lambda o, d, a, b: ic.tree_any_hit(cs, o, d, a, b),
                         lambda o, d, a, b: ic.tree_plain(cs, o, d, a, b, True)))
            if not cs.shade:  # terrain_1080p's closest hits: kernel A
                runs += [
                    ("A", kind_rays, lambda o, d, a, b: ic.tree_closest_hit(cs, o, d, a, b),
                     lambda o, d, a, b: ic.tree_plain(cs, o, d, a, b, False))
                    for kind_rays in ("camera_blocked", "bounce_blocked")
                ]
        if cs.shade:
            kinds = ("camera", "bounce") + (("camera_blocked", "bounce_blocked") if nq in BLOCKED_SCENES else ())
            runs += [
                ("D", kind_rays, lambda o, d, a, b: ic.tree_closest_shade(cs, o, d, a, b),
                 lambda o, d, a, b: ic.tree_plain(cs, o, d, a, b, False, shade=True))
                for kind_rays in kinds
            ]
        report = {}
        for key, kind_rays, kernel, plain in runs:
            args = rays[kind_rays]
            got = kernel(*args)
            torch.cuda.synchronize()
            want = plain(*args)
            err, exact = compare(got[:4], want[:4])
            if key == "D":
                # rows equal on triangle hits, and each is the slot's own row
                tri = (got[1] >= 0) & (got[1] == want[1])
                assert torch.equal(got[4][tri], want[4][tri]), "D's rows differ from the plain version's"
                assert torch.equal(got[4][tri], cs.slot_shade[got[1][tri].long()])
                assert (got[4][got[1] < 0] == 0).all()
                # the same walk as kernel A at chunk batch 1
                a_out = ic.tree_closest_hit(cs, *args)
                assert all(torch.equal(x, y) for x, y in zip(got[:4], a_out)), "D's walk differs from A's"
                exact = exact and torch.equal(got[4], want[4])
            if key in ("A", "B", "C", "D"):  # each gives its plain version's outputs bit for bit
                assert exact, f"{key} differs from its plain version: terrain{nq} {kind_rays}"
            errs[key] = max(errs[key], err)
            report[f"{key}_{kind_rays}"] = f"err={err:.3g},exact={exact},hits={int((got[1] >= 0).sum())}"
            # the main path's shapes: primary rays at 524k tris for A (the
            # JAX package's stream mode, PERF.md row 2), shadow rays at 524k
            # tris for B, shadow rays of the small scene for C and its
            # primary rays for A on the single-level tree, primary rays at
            # 131k tris for D (config2_frame's scene), B's shadow rays there,
            # and A's, D's and B's blocked-order wavefronts; and two rows no
            # path runs by default: A on the 131k VMEM-mode tree (row 1) and
            # C's closest-hit flag (row 5)
            label = TIMED.get((key, kind_rays, nq))
            if label:
                times[label] = (
                    bk.cuda_ms(lambda: kernel(*args), 20),
                    bk.cuda_ms(lambda: plain(*args), 3),
                )
                bounds[label] = bk.bound(cs, key, kind_rays.startswith("shadow"), args, got)
        if cs.shade and nq == 256:
            # D with its rows against A plus finalize_hit's row gather, to the Hit
            o, d, a, b = rays["camera"]

            def a_gather():
                return finalize_hit(r.bundle.scene, o, d, *ic.intersect(cs, o, d, a, b)[:5])

            def d_rows():
                t, prim, b1, b2, hit, _, rows = ic.intersect(cs, o, d, a, b, return_shade=True)
                return finalize_hit(r.bundle.scene, o, d, t, prim, b1, b2, hit, shade_rows=rows)

            hit_a, hit_d = a_gather(), d_rows()
            assert all(torch.equal(x, y) for x, y in zip(hit_a, hit_d)), "D's Hit differs from A's"
            times["A+gather"] = (bk.cuda_ms(a_gather, 20), bk.cuda_ms(d_rows, 20))
        if nq in (40, 256):
            # F, the group walk: exactly its plain version, and A's, B's or
            # D's t, slot, bary, hit and rows; only the tests differ
            assert cs.b1 > 1 and not cs.stream and cs.shade
            for tb in (2, 4):
                for kind_rays, any_hit, shade in (
                    ("camera", False, False), ("bounce", False, False), ("shadow", True, False),
                    ("bounce", False, True),
                ):
                    args = rays[kind_rays]
                    got = ic.tree_group(cs, *args, tb, any_hit=any_hit, shade=shade)
                    torch.cuda.synchronize()
                    want = ic.tree_plain(cs, *args, any_hit, shade=shade, top_batch=tb)
                    err, _ = compare(got[:4], want[:4])
                    exact = all(torch.equal(g, w) for g, w in zip(got, want))
                    assert exact, f"F differs from its plain version: {nq} tb={tb} {kind_rays} shade={shade}"
                    walk = ic.tree_closest_shade if shade else (ic.tree_any_hit if any_hit else ic.tree_closest_hit)
                    ref = walk(cs, *args)
                    assert all(torch.equal(g, w) for j, (g, w) in enumerate(zip(got, ref)) if j != 3), (
                        f"F's hits differ from the default walk's: {nq} tb={tb} {kind_rays} shade={shade}")
                    errs["F"] = max(errs["F"], err)
                    tag = f"F{tb}_{kind_rays}" + ("_shade" if shade else "")
                    report[tag] = f"exact={exact},tests={int(got[3].sum())}/{int(ref[3].sum())}"
        shape = f"{cs.b1}x{cs.b2}x{cs.k}"
        phase("kernels", t0, tris=r.scene.num_triangles, spheres=cs.n_spheres, tree=shape, brute=cs.brute,
              shade=cs.shade, lanes=LANES, **report)
    # E, the coefficient walk, on the exact-fit trees of tools/ab_mxu_mt.py
    from lens_flare_tpu_torch.accel.wide import build_wide_bvh

    none = (np.zeros((0, 3), np.float32), np.zeros(0, np.float32))
    for nq, shape in bk.MXU_SCENES:
        t0 = time.perf_counter()
        scene = make_terrain_scene(nq)
        cs = ic.CudaScene.from_wide_bvh(build_wide_bvh(scene.tri_p, *shape), *none, scene.num_triangles,
                                        "cuda", mxu=True)
        report = {}
        for kind_rays, args in bk.mxu_rays(scene, LANES, "cuda").items():
            got = ic.tree_closest_mxu(cs, *args)
            torch.cuda.synchronize()
            want = ic.tree_plain(cs, *args, False, mxu=True)
            err, exact = compare(got, want)
            assert exact, f"E differs from its plain version: terrain{nq} {kind_rays}"
            # against A: E's affine forms round otherwise than A's cross
            # products, so a grazing ray may flip (<= 1 lane in 10,000), and
            # t agrees to 1e-3 relative (the cancellation the per-top
            # re-centring bounds), as tests/test_pallas.py holds the two walks
            a_out = ic.tree_closest_hit(cs, *args)
            hit, hit_a = got[1] >= 0, a_out[1] >= 0
            both = hit & hit_a & (got[1] == a_out[1])
            n_hit_diff = int((hit != hit_a).sum())
            n_slot_diff = int((hit & hit_a).sum()) - int(both.sum())
            assert n_hit_diff + n_slot_diff <= 1e-4 * hit.numel(), ("E's hits differ from A's", n_hit_diff, n_slot_diff)
            t_rel = ((got[0][both] - a_out[0][both]).abs() / a_out[0][both].abs()).max().item() if both.any() else 0.0
            assert t_rel <= 1e-3, t_rel
            errs["E"] = max(errs["E"], err)
            report[f"E_{kind_rays}"] = (f"exact={exact},hits={int(hit.sum())},vs_A_hit_diff={n_hit_diff},"
                                        f"slot_diff={n_slot_diff},t_maxrel={t_rel:.3g}")
        phase("kernels_mxu", t0, tris=scene.num_triangles, tree="x".join(map(str, shape)), lanes=LANES, **report)
    for label in TIMED.values():
        (ms, plain_ms), (b_ms, b_by) = times[label], bounds[label]
        print(f"[timing] kernel={label} lanes={LANES} ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={b_ms:.5f} bound_by={b_by}", flush=True)
    a_gather_ms, d_rows_ms = times["A+gather"]
    print(f"[timing] tris=131072 lanes={LANES} camera rays to Hit: "
          f"A+finalize_hit_gather_ms={a_gather_ms:.4f} D+finalize_hit_rows_ms={d_rows_ms:.4f} "
          f"D_ms={times['D'][0]:.4f} D_plain_ms={times['D'][1]:.4f}", flush=True)
    # kernel H, the threefry tape: a sample's draw at the cells' tapes against the plain int64 code
    from lens_flare_tpu_torch import _rng

    t0 = time.perf_counter()
    pix = torch.arange(LANES, dtype=torch.int64, device="cuda") * 7919 % (1920 * 1080)
    s_idx = torch.tensor(3, dtype=torch.int64, device="cuda")
    base = _rng.prng_key(2_148_300_001, device="cuda").expand(LANES, 2)
    keys = _rng.fold_in(_rng.fold_in(base, pix), s_idx)
    want_keys = _rng.fold_in_plain(_rng.fold_in_plain(base, pix), s_idx)
    assert torch.equal(keys, want_keys), "H's fold_in differs from its plain version"
    report = {}
    for label, u in RNG_TAPES.items():
        got, want = _rng.uniform(keys, (u,)), _rng.uniform_plain(keys, (u,))
        exact = torch.equal(got.view(torch.int32), want.view(torch.int32))
        assert exact, f"H's uniform differs from its plain version at U = {u}"
        times[label] = (bk.cuda_ms(lambda u=u: _rng.uniform(keys, (u,)), 20),
                        bk.cuda_ms(lambda u=u: _rng.uniform_plain(keys, (u,)), 5))
        bounds[label] = bk.rng_bound(LANES, u)
        report[label] = f"exact={exact},ms={times[label][0]:.4f},plain_ms={times[label][1]:.4f}"
        print(f"[timing] kernel={label} lanes={LANES} draws={LANES * u} ms={times[label][0]:.4f} "
              f"plain_ms={times[label][1]:.4f} bound_ms={bounds[label][0]:.5f} bound_by={bounds[label][1]}",
              flush=True)
    phase("rng", t0, lanes=LANES, **report)

    # kernel I, the vertex shading: I-a and I-b alone on a 65,536-lane camera and bounce vertex of each
    # terrain cell, their byte bound and the plain vertex functions' device time; every output of both
    # vertices held bit-equal to the plain functions' (bench_vertex raises otherwise)
    t0 = time.perf_counter()
    vertex_rows = []
    bk.bench_vertex(vertex_rows, torch.device("cuda"))
    phase("vertex", t0, rows=len(vertex_rows), ia_ms=max(r["ia_ms"] for r in vertex_rows),
          ib_ms=max(r["ib_ms"] for r in vertex_rows), max_abs_err=max(r["max_abs_err"] for r in vertex_rows),
          outputs_compared=sum(r["outputs_compared"] for r in vertex_rows))

    # -- 3. the slice: the 1080p terrain frame with the flare --------------
    from lens_flare_tpu_torch.ab_walk import SMALL, config2_renderer, terrain_1080p
    from lens_flare_tpu_torch.utils import image as img

    from lens_flare_tpu_torch.ab_walk import frame_profile

    compiled_rows = {}

    def compiled_row(name, r, frame, ghosts=None):
        """The ``compiled`` phase's row of one frame (``ab_compiled.compare``: the replay against a
        ``compiled.disabled()`` frame, capture s, both frame_s, launches counted and traced, peak MiB,
        and the replayed frame's busy share, kernel ms and device launches under ``torch.profiler``)."""
        row = compare_compiled(r, frame, ghosts)
        compiled_rows[name] = row
        print(f"[compiled:{name}] " + " ".join(
            f"{k}={json.dumps(v) if isinstance(v, (dict, list, bool)) or v is None else f'{v:.4f}' if isinstance(v, float) else v}"
            for k, v in row.items()), flush=True)

    def held(name, launches):
        """The main path's launches of A-G, counted by the wrappers and added per replay, against the
        calls of each that the trace of the same frame replayed showed (``compiled_row``)."""
        traced = compiled_rows[name]["traced_launches"]
        assert {k: launches[k] for k in traced} == traced, (f"{name}: the counts are not the trace's", launches, traced)

    t0 = time.perf_counter()
    r, pipeline, frame = terrain_1080p("cuda")
    compiled_row("terrain_1080p", r, lambda: r.render(progress=False))
    frame()  # warm-up: cuFFT plans, allocator, first launches (the render's program is captured above)
    torch.cuda.synchronize()
    ic.reset_launch_counts()
    t_frame = time.perf_counter()
    hdr, counts, out = frame()
    torch.cuda.synchronize()
    frame_s = time.perf_counter() - t_frame
    launches = {k: v.launches for k, v in ic.KERNELS.items()}
    comp_ms = bk.cuda_ms(lambda: pipeline.composite(hdr), 5)
    st = r.stats
    assert out.shape == (1080, 1920, 3) and torch.isfinite(out).all(), "frame is not finite"
    assert (out >= hdr).all(), "the flare darkened a pixel"
    assert (out - hdr).sum() > 0 and hdr.sum() > 0 and (counts == 1).all()
    assert min(launches[k] for k in "ABHI") > 0, f"main path skipped a kernel: {launches}"
    assert launches["I_plain"] == 0, f"a vertex of the terrain took the plain route: {launches}"
    held("terrain_1080p", launches)
    png = ROOT / "lens_flare_tpu_torch" / "_build" / "terrain_1080p.png"
    img.save_hdr_png(png, out.cpu().numpy(), flip_y=True)
    phase(
        "frame", t0, tris=r.scene.num_triangles, width=1920, height=1080, spp=1, depth=4,
        frame_s=f"{frame_s:.4f}", rays_traced=st.total_rays,
        mrays_traced_per_s=f"{st.total_rays / frame_s / 1e6:.3f}",
        zero_rays_skipped=st.total_zero_skipped, isects_per_ray=f"{st.isects_per_ray:.2f}",
        flare_composite_s=f"{comp_ms / 1e3:.4f}", bvh_build_s=f"{st.bvh_build_time:.2f}",
        launches=json.dumps(launches), png=png.name,
    )

    # -- 4. small frame through kernel C, held against the CPU render ------
    t0 = time.perf_counter()
    rs = Renderer(device="cuda", **SMALL)
    rs.load_flat_scene(make_terrain_scene(8))
    ic.reset_launch_counts()
    got, _ = rs.render(progress=False)
    torch.cuda.synchronize()
    small_launches = {k: v.launches for k, v in ic.KERNELS.items()}
    assert small_launches["C"] > 0 and small_launches["A"] > 0, f"the small frame skipped C or A: {small_launches}"
    rc = Renderer(device="cpu", **SMALL)
    rc.load_flat_scene(make_terrain_scene(8))
    want, _ = rc.render(progress=False)
    got = got.cpu().double()
    want = want.double()
    ok = ((got - want).abs() <= 1e-4 + 1e-4 * want.abs()).all(dim=-1).double().mean().item()
    rel = ((got - want).abs().sum() / want.abs().sum()).item()
    assert torch.isfinite(got).all() and ok >= 0.99 and rel < 1e-3, (ok, rel)
    assert rs.stats.total_rays == rc.stats.total_rays
    phase("small_frame", t0, tris=rs.scene.num_triangles, width=320, height=240,
          pixels_within_tol=f"{ok:.5f}", mean_rel_diff=f"{rel:.3g}",
          rays_traced=rs.stats.total_rays, launches=json.dumps(small_launches))

    # -- 5. config2_frame: thin-lens bokeh adaptive render through kernel D -
    t0 = time.perf_counter()
    r2, _ = config2_renderer(256, "cuda", width=1920, height=1080, ns_aa=16, samples_per_batch=4)
    assert r2.bundle.cscene.shade and not r2.bundle.cscene.stream
    compiled_row("config2_frame", r2, lambda: r2.render(progress=False))
    r2.render(progress=False)  # warm-up
    torch.cuda.synchronize()
    ic.reset_launch_counts()
    t_frame = time.perf_counter()
    hdr2, counts2 = r2.render(progress=False)
    torch.cuda.synchronize()
    frame2_s = time.perf_counter() - t_frame
    c2_launches = {k: v.launches for k, v in ic.KERNELS.items()}
    st2 = r2.stats
    assert c2_launches["D"] > 0 and c2_launches["A"] == 0 and c2_launches["B"] > 0, c2_launches
    assert c2_launches["I"] > 0 and c2_launches["I_plain"] == 0, f"config 2 left kernel I: {c2_launches}"
    held("config2_frame", c2_launches)
    assert hdr2.shape == (1080, 1920, 3) and torch.isfinite(hdr2).all() and hdr2.sum() > 0
    assert counts2.min().item() >= 4 and counts2.max().item() <= 16
    hist2 = {n: int((counts2 == n).sum()) for n in (4, 8, 16)}
    assert sum(hist2.values()) == 1920 * 1080, hist2
    png2 = ROOT / "lens_flare_tpu_torch" / "_build" / "config2_1080p.png"
    img.save_hdr_png(png2, hdr2.cpu().numpy(), flip_y=True)
    assert png2.stat().st_size > 0
    phase(
        "config2_frame", t0, tris=r2.scene.num_triangles, width=1920, height=1080, ns_aa=16,
        stages="4,4,8", depth=4, lens_radius=f"{r2.lens_radius:.6g}",
        focal_distance=f"{r2.focal_distance:.6g}", frame_s=f"{frame2_s:.4f}",
        rays_traced=st2.total_rays, mrays_traced_per_s=f"{st2.total_rays / frame2_s / 1e6:.3f}",
        isects_per_ray=f"{st2.isects_per_ray:.2f}", zero_rays_skipped=st2.total_zero_skipped,
        active_after_stage=json.dumps(st2.active_per_stage),
        mean_spp=f"{counts2.double().mean().item():.4f}", counts_hist=json.dumps(hist2),
        launches=json.dumps(c2_launches), png=png2.name,
    )

    # -- 6. config2_small: the same settings, held against the CPU render --
    t0 = time.perf_counter()
    rs2, small2 = config2_renderer(40, "cuda", width=320, height=240, ns_aa=8, samples_per_batch=2)
    ic.reset_launch_counts()
    got, got_counts = rs2.render(progress=False)
    torch.cuda.synchronize()
    s2_launches = {k: v.launches for k, v in ic.KERNELS.items()}
    assert s2_launches["D"] > 0, f"config2_small skipped kernel D: {s2_launches}"
    rc2 = Renderer(device="cpu", **small2)
    rc2.load_flat_scene(make_terrain_scene(40))
    focal_cpu = rc2.autofocus(160, 120)
    assert abs(focal_cpu - rs2.focal_distance) <= 1e-6 * rs2.focal_distance, (focal_cpu, rs2.focal_distance)
    rc2.focal_distance = rc2.camera.focal_distance = rs2.focal_distance  # identical inputs
    want, want_counts = rc2.render(progress=False)
    same_counts = (got_counts.cpu() == want_counts).double().mean().item()
    got = got.cpu().double()
    want = want.double()
    ok = ((got - want).abs() <= 1e-4 + 1e-4 * want.abs()).all(dim=-1).double().mean().item()
    rel = ((got - want).abs().sum() / want.abs().sum()).item()
    assert torch.isfinite(got).all() and same_counts >= 0.995 and ok >= 0.99 and rel < 1e-3, (
        same_counts, ok, rel)
    phase("config2_small", t0, tris=rs2.scene.num_triangles, width=320, height=240, ns_aa=8,
          counts_equal=f"{same_counts:.5f}", pixels_within_tol=f"{ok:.5f}",
          mean_rel_diff=f"{rel:.3g}", rays_traced=rs2.stats.total_rays,
          rays_traced_cpu=rc2.stats.total_rays, launches=json.dumps(s2_launches))

    # -- 7. kernel_bench: the path of kernels E and F ----------------------
    t0 = time.perf_counter()
    bench_out = ROOT / "lens_flare_tpu_torch" / "_build" / "bench_kernels.json"
    cases = []
    ic.reset_launch_counts()
    art = bk.main(["--n", str(BENCH_LANES), "--out", str(bench_out)], cases=cases)
    torch.cuda.synchronize()
    bench_launches = {k: v.launches for k, v in ic.KERNELS.items()}
    assert bench_launches["E"] > 0 and bench_launches["F"] > 0, f"the bench skipped E or F: {bench_launches}"
    assert all(row["ok"] for row in art["rows"] if "check" in row)
    # every E and F call the bench timed, on its own scenes and rays:
    # exactly the plain version, tests included; the bound counts F's work
    # from the default walk's tests on the same rays
    report = {}
    for c in cases:
        got = c.kernel()
        torch.cuda.synchronize()
        want = c.plain()
        assert all(torch.equal(g, w) for g, w in zip(got, want)), f"{c.key} differs from its plain version: {c.label}"
        err, _ = compare(got, want)
        errs[c.key] = max(errs[c.key], err)
        plain_ms = bk.cuda_ms(c.plain, 2)
        b_ms, b_by = bk.bound(c.cs, c.key, c.any_hit, c.rays, got, tests=None if c.key == "E" else c.base_tests)
        # the kernels line takes E on terrain 128's bounce rays and F at
        # top_batch 2 on terrain 256's bounce wavefront
        if c.label in ("terrain128_bounce", "terrain256_bounce_tb2"):
            times[c.key], bounds[c.key] = (c.ms, plain_ms), (b_ms, b_by)
        report[f"{c.key}_{c.label}"] = f"exact=True,tests={int(got[3].sum())}/{int(c.base_tests.sum())}"
        print(f"[timing] kernel={c.key} case={c.label} lanes={c.rays[0].shape[0]} ms={c.ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.5f} bound_by={b_by}", flush=True)
    assert "E" in times and "F" in times, sorted(c.label for c in cases)
    phase("kernel_bench", t0, rows=len(art["rows"]), lanes=BENCH_LANES, cases=len(cases),
          launches=json.dumps(bench_launches), artifact=bench_out.name, **report)


    # -- 8. dae_small: a Cornell box file through the command line -------
    import contextlib
    import io

    from lens_flare_tpu_torch import cli
    from lens_flare_tpu_torch.integrator.path import vertex_routes
    from lens_flare_tpu_torch.ops.intersect_cuda import bvh_walk_plain
    from lens_flare_tpu_torch.utils.image import load_png

    build_dir = ROOT / "lens_flare_tpu_torch" / "_build"

    def run_cli(argv):
        """cli.main on ``argv``, its output echoed and returned: (seconds, stdout)."""
        buf = io.StringIO()
        t_cli = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            assert cli.main(argv) == 0
        seconds = time.perf_counter() - t_cli
        out = buf.getvalue()
        print(out.replace("\r", "\n").strip().splitlines()[-1], flush=True)
        return seconds, out

    def cli_numbers(out):
        import re

        render_s = float(re.search(r"Rendering complete: ([0-9.]+) sec", out).group(1))
        rays = int(re.search(r"Rays traced: (\d+)", out).group(1))
        load_s = float(re.search(r"parse \+ build ([0-9.]+) sec", out).group(1))
        bvh_s = float(re.search(r"BVH build ([0-9.]+) sec", out).group(1))
        return render_s, rays, load_s, bvh_s

    t0 = time.perf_counter()
    cornell = cornell_box().write(build_dir / "cornell.dae")
    small_png = build_dir / "cornell_320x240.png"
    dae_small_args = ["-r", "320", "240", "-s", "16", "-m", "5"]
    ic.reset_launch_counts()
    cli_s, out = run_cli([*dae_small_args, "-f", str(small_png), "--device", "cuda", str(cornell)])
    torch.cuda.synchronize()
    ds_launches = {k: v.launches for k, v in ic.KERNELS.items()}
    assert ds_launches["C"] > 0 and ds_launches["A"] > 0, f"the Cornell box skipped C or A: {ds_launches}"
    # four BSDF families, spot and area lights and spheres, no sky: kernel I's general instance, no plain vertex
    assert ds_launches["I"] > 0 and ds_launches["I_plain"] == 0, f"the Cornell box left kernel I: {ds_launches}"
    render_s, ds_rays, load_s, _ = cli_numbers(out)
    # the same frame through Renderer.load: its PNG is the command line's, and
    # a 96 x 72 cell of it (the box's centre) agrees with the CPU render
    kw = dict(width=320, height=240, ns_aa=16, max_ray_depth=5, indirect=True, seed=0)
    rg = Renderer(device="cuda", **kw)
    rg.load(cornell)
    compiled_row("dae_small", rg, lambda: rg.render(progress=False))
    held("dae_small", ds_launches)  # the command line's frame is this one (its PNG is checked below)
    hdr_small, _ = rg.render(progress=False)
    png_px = load_png(small_png)
    want_px = np.clip(np.round(img.to_color(hdr_small.cpu().numpy())[::-1] * 255.0), 0, 255).astype(np.uint8)
    assert png_px.shape == (240, 320, 3) and np.array_equal(png_px, want_px), "the PNG is not the frame's"
    cell = (112, 84, 96, 72)
    rcpu = Renderer(device="cpu", **kw)
    rcpu.load(cornell)
    want, _ = rcpu.render(cell=cell, progress=False)
    x0, y0, dx, dy = cell
    got = hdr_small.cpu().double()[y0 : y0 + dy, x0 : x0 + dx]
    want = want.double()[y0 : y0 + dy, x0 : x0 + dx]
    ok = ((got - want).abs() <= 1e-4 + 1e-4 * want.abs()).all(dim=-1).double().mean().item()
    rel = ((got - want).abs().sum() / want.abs().sum()).item()
    assert torch.isfinite(got).all() and got.sum() > 0 and ok >= 0.99 and rel < 1e-3, (ok, rel)
    phase("dae_small", t0, tris=rg.scene.num_triangles, spheres=rg.scene.num_spheres,
          lights=len(rg.scene.lights.light_type), width=320, height=240, spp=16, depth=5,
          cli_s=f"{cli_s:.4f}", frame_s_includes_capture="yes", load_s=f"{load_s:.4f}", render_s=f"{render_s:.4f}", rays_traced=ds_rays,
          cell_pixels_within_tol=f"{ok:.5f}", cell_mean_rel_diff=f"{rel:.3g}",
          launches=json.dumps(ds_launches), png=small_png.name)

    # the cornell_256_16spp cell's frame: the same file through Renderer.load at 256x256, 16 spp, depth 5, one
    # 65,536-lane tile; the launches of one replayed frame (the first captures its programs)
    t0 = time.perf_counter()
    rcc = Renderer(device="cuda", width=256, height=256, ns_aa=16, max_ray_depth=5, indirect=True, seed=0)
    rcc.load(cornell)
    rcc.render(progress=False)
    torch.cuda.synchronize()
    ic.reset_launch_counts()
    t_frame = time.perf_counter()
    rcc.render(progress=False)
    torch.cuda.synchronize()
    cc_frame_s = time.perf_counter() - t_frame
    cc_launches = {k: v.launches for k, v in ic.KERNELS.items()}
    cc_routes = vertex_routes()
    assert cc_launches["I"] > 0 and cc_launches["I_plain"] == 0, f"the Cornell cell left kernel I: {cc_launches}"
    assert cc_routes == {"kernel": 80, "plain": 0}, f"the Cornell cell's vertex wavefronts: {cc_routes}"
    phase("cornell_cell", t0, tris=rcc.scene.num_triangles, spheres=rcc.scene.num_spheres, width=256, height=256,
          spp=16, depth=5, frame_s=f"{cc_frame_s:.4f}", vertex_routes=json.dumps(cc_routes),
          launches=json.dumps(cc_launches))
    del rcc

    # -- 9. dae_1080p: terrain 256 as a COLLADA file, at full width --------
    from lens_flare_tpu_torch.lens.aperture import polygon_mask

    t0 = time.perf_counter()
    t_write = time.perf_counter()
    terrain_file = terrain_dae(256).write(build_dir / "terrain256.dae")
    write_s = time.perf_counter() - t_write
    ap_png, ghost_png = build_dir / "aperture.png", build_dir / "ghost_aperture.png"
    img.save_png(ap_png, polygon_mask(256, 5, rotation=0.3))
    img.save_png(ghost_png, polygon_mask(64, 6))
    big_png = build_dir / "terrain256_1080p.png"
    ic.reset_launch_counts()
    cli_s, out = run_cli(["-r", "1920", "1080", "-s", "1", "-m", "4", "-x", str(ap_png), "-y", str(ghost_png),
                          "-i", "1.5", "-n", "30", "-f", str(big_png), "--device", "cuda", str(terrain_file)])
    torch.cuda.synchronize()
    d1_launches = {k: v.launches for k, v in ic.KERNELS.items()}
    assert d1_launches["D"] > 0 and d1_launches["B"] > 0, f"the 1080p file skipped D or B: {d1_launches}"
    render_s, d1_rays, load_s, bvh_s = cli_numbers(out)
    frame = load_png(big_png)
    assert frame.shape == (1080, 1920, 3) and frame.max() > 0 and frame.std() > 0, "the 1080p PNG is blank"
    phase("dae_1080p", t0, tris=131072, polylists=4, width=1920, height=1080, spp=1, depth=4, flare="on",
          write_s=f"{write_s:.4f}", parse_build_s=f"{load_s:.4f}", bvh_build_s=f"{bvh_s:.4f}",
          frame_s=f"{render_s:.4f}", cli_s=f"{cli_s:.4f}", frame_s_includes_capture="yes", rays_traced=d1_rays,
          mrays_traced_per_s=f"{d1_rays / render_s / 1e6:.3f}", png_mean=f"{frame.mean():.3f}",
          launches=json.dumps(d1_launches), png=big_png.name)

    # -- 10. g_kernel: G against its plain version on terrain 512 ----------
    def g_check(bv, rays, any_hit):
        """G's outputs against bvh_walk_plain's, every one bit for bit; (outputs, visits)."""
        got = ic.bvh_walk(bv, *rays, any_hit=any_hit)
        torch.cuda.synchronize()
        visits = {}
        want = bvh_walk_plain(bv, *rays, any_hit=any_hit, visits=visits)
        names = ("t", "prim", "b1", "b2", "found", "tests")
        diff = [n for n, g, w in zip(names, got, want) if not torch.equal(g, w)]
        assert not diff, f"G differs from bvh_walk_plain in {diff} (any_hit={any_hit})"
        return got, visits

    t0 = time.perf_counter()
    rw = Renderer(width=1920, height=1080, max_ray_depth=4, device="cuda")
    rw.load_flat_scene(make_terrain_scene(512))
    rb = Renderer(width=1920, height=1080, max_ray_depth=4, device="cuda", use_wide_tree=False)
    rb.load_flat_scene(make_terrain_scene(512))
    bv = rb.bundle.bvh
    assert rb.bundle.cscene is None and bv is not None
    gen.manual_seed(1)
    g_rays = bk.random_rays(rb, LANES, gen)
    report = {}
    for kind_rays, any_hit in (("camera", False), ("shadow", True)):
        args = g_rays[kind_rays]
        got, visits = g_check(bv, args, any_hit)
        # the same hits as the cluster walk (A or B) on the same rays
        ref = ic.intersect(rw.bundle.cscene, *args, any_hit=any_hit)
        same_hit = (got[4] == ref[4]).double().mean().item()
        assert same_hit >= 0.999, f"G's hits differ from the cluster walk's on {1 - same_hit:.2%} of lanes"
        if not any_hit:
            both = got[4] & ref[4]
            assert (got[1][both] == ref[1][both]).double().mean().item() >= 0.999
            t_rel = ((got[0][both] - ref[0][both]).abs() / ref[0][both]).max().item()
            assert t_rel <= 1e-5, t_rel
        label = "G" if not any_hit else "G_any_hit"
        times[label] = (bk.cuda_ms(lambda: ic.bvh_walk(bv, *args, any_hit=any_hit), 20),
                        bk.cuda_ms(lambda: bvh_walk_plain(bv, *args, any_hit=any_hit), 2))
        bounds[label] = bk.bvh_bound(bv, args, got, visits)
        report[kind_rays] = (f"exact=True,hits={int(got[4].sum())},vs_cluster_walk={same_hit:.5f},"
                             f"tests={int(got[5].sum())},nodes={int(visits['nodes'].sum())}")
        print(f"[timing] kernel={label} tris=524288 lanes={LANES} ms={times[label][0]:.4f} "
              f"plain_ms={times[label][1]:.4f} bound_ms={bounds[label][0]:.5f} bound_by={bounds[label][1]}",
              flush=True)
    phase("g_kernel", t0, tris=524288, bvh_nodes=bv.num_nodes, bvh_records=bv.nodes.shape[0],
          bvh_depth=bv.max_depth, bvh_build_s=f"{rb.stats.bvh_build_time:.3f}",
          bvh_pack_s=f"{rb.stats.bvh_pack_time:.3f}", lanes=LANES, **report)
    del rw, rb, bv, g_rays

    # -- 11. past_capacity: 16,785,218 triangles through kernel G ----------
    from lens_flare_tpu_torch.accel.wide import MAX_TRIS

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    t_gen = time.perf_counter()
    big = make_terrain_scene(PAST_CAPACITY_QUADS)
    gen_s = time.perf_counter() - t_gen
    assert big.num_triangles > MAX_TRIS, big.num_triangles
    rp = Renderer(width=1920, height=1080, ns_aa=1, max_ray_depth=1, seed=0, device="cuda")
    t_build = time.perf_counter()
    rp.load_flat_scene(big)
    build_s = time.perf_counter() - t_build
    assert rp.bundle.cscene is None, "a scene past capacity did not take the binary BVH"
    scene_mb = (torch.cuda.memory_allocated() - mem0) / 2**20
    compiled_row("past_capacity", rp, lambda: rp.render(progress=False))
    rp.render(progress=False)  # warm-up
    torch.cuda.synchronize()
    ic.reset_launch_counts()
    t_frame = time.perf_counter()
    hdr_big, counts_big = rp.render(progress=False)
    torch.cuda.synchronize()
    frame_big_s = time.perf_counter() - t_frame
    pc_launches = {k: v.launches for k, v in ic.KERNELS.items()}
    walks = sum(pc_launches[k] for k in "ABCDEFG")
    assert walks == pc_launches["G"] == PAST_CAPACITY_FRAME["launches"] and pc_launches["H"] > 0, pc_launches
    held("past_capacity", pc_launches)
    assert rp.stats.total_rays == PAST_CAPACITY_FRAME["rays"], rp.stats.total_rays
    assert f"{rp.stats.isects_per_ray:.2f}" == PAST_CAPACITY_FRAME["isects_per_ray"], rp.stats.isects_per_ray
    assert hdr_big.shape == (1080, 1920, 3) and torch.isfinite(hdr_big).all() and hdr_big.sum() > 0
    peak_mb = (torch.cuda.max_memory_allocated() - mem0) / 2**20
    bv = rp.bundle.bvh
    bvh_mib = sum(x.numel() * x.element_size() for x in (bv.root, bv.nodes, bv.rows)) / 2**20
    gen.manual_seed(2)
    p_rays = bk.random_rays(rp, LANES, gen)
    # the frame's own wavefronts: its first LANES pixels in 32x32-block order (rows Gd and Ge)
    p_camera, _, p_shadow = bk.wavefronts(rp, LANES)
    report = {}
    for kind_rays, args, any_hit, label in (
        ("camera", p_rays["camera"], False, "G_past_capacity"),
        ("shadow", p_rays["shadow"], True, "G_any_hit_past_capacity"),
        ("camera_blocked", p_camera, False, "G_blocked_past_capacity"),
        ("shadow_blocked", p_shadow, True, "G_any_hit_blocked_past_capacity"),
    ):
        got, visits = g_check(bv, args, any_hit)
        times[label] = (bk.cuda_ms(lambda: ic.bvh_walk(bv, *args, any_hit=any_hit), 20),
                        bk.cuda_ms(lambda: bvh_walk_plain(bv, *args, any_hit=any_hit), 1))
        bounds[label] = bk.bvh_bound(bv, args, got, visits)
        report[kind_rays] = f"exact=True,hits={int(got[4].sum())},tests={int(got[5].sum())}"
        print(f"[timing] kernel={label} tris={big.num_triangles} lanes={LANES} ms={times[label][0]:.4f} "
              f"plain_ms={times[label][1]:.4f} bound_ms={bounds[label][0]:.5f} bound_by={bounds[label][1]}",
              flush=True)
    png_big = build_dir / "past_capacity_1080p.png"
    img.save_hdr_png(png_big, hdr_big.cpu().numpy(), flip_y=True)
    phase("past_capacity", t0, tris=big.num_triangles, width=1920, height=1080, spp=1, depth=1,
          scene_gen_s=f"{gen_s:.3f}", build_s=f"{build_s:.3f}", bvh_build_s=f"{rp.stats.bvh_build_time:.3f}",
          bvh_pack_s=f"{rp.stats.bvh_pack_time:.3f}", bvh_nodes=bv.num_nodes, bvh_records=bv.nodes.shape[0],
          bvh_depth=bv.max_depth, bvh_device_mib=f"{bvh_mib:.1f}", frame_s=f"{frame_big_s:.4f}",
          rays_traced=rp.stats.total_rays, isects_per_ray=f"{rp.stats.isects_per_ray:.2f}",
          scene_device_mib=f"{scene_mb:.1f}", peak_device_mib=f"{peak_mb:.1f}",
          launches=json.dumps(pc_launches), lanes=LANES, **report, png=png_big.name)
    del rp, big, bv, p_rays, p_camera, p_shadow, hdr_big

    # -- 12. diff_small: gradients of the Cornell box through kernels A and C
    from lens_flare_tpu_torch import renderer as rmod
    from lens_flare_tpu_torch.diff import render as dr
    from lens_flare_tpu_torch.diff.optimize import LENS_FIELDS, OptimizeConfig, ghost_image, optimize_lens
    from lens_flare_tpu_torch.lens.prescription import reference_prescription
    from lens_flare_tpu_torch.scene.build import LT_AREA
    from lens_flare_tpu_torch.scene.collada import BSDF_DIFFUSE

    def max_rel(got, want):
        return ((got.cpu().double() - want.double()).abs().max() / want.double().abs().max()).item()

    t0 = time.perf_counter()
    dgpu = diff_case(cornell, "cuda", 320, 240, 4, 2, aim=True)
    dcpu = diff_case(cornell, "cpu", 320, 240, 4, 2, aim=True)
    sc = dgpu.r.scene
    small_params = emitter_params(sc)
    emit_row, light_row = small_params["emitter"][2], small_params["light"][2]
    diff_grads(dgpu, small_params)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    ic.reset_launch_counts()
    img_gpu, g_gpu, fwd_s, bwd_s = diff_grads(dgpu, small_params)
    dsm_launches = {k: v.launches for k, v in ic.KERNELS.items()}
    assert dsm_launches["A"] > 0 and dsm_launches["C"] > 0, f"diff_small skipped A or C: {dsm_launches}"
    assert dsm_launches["I"] == 0 and dsm_launches["I_plain"] > 0, f"diff_small took kernel I: {dsm_launches}"
    peak_small = (torch.cuda.max_memory_allocated() - mem0) / 2**20  # above what the phase started with
    img_cpu, g_cpu, _, _ = diff_grads(dcpu, small_params)
    # the kernels give the plain versions' hits bit for bit; the shading math
    # rounds in another order and the gathers' backward adds with atomics
    assert torch.isfinite(img_gpu).all() and img_gpu.max() > 1.0, "the emitter is not in view"
    img_err = max_rel(img_gpu, img_cpu)
    grad_err = {k: max_rel(g_gpu[k], g_cpu[k]) for k in small_params}
    assert img_err <= 1e-4 and max(grad_err.values()) <= 1e-4, (img_err, grad_err)
    assert all(g.abs().max() > 1e-4 for g in g_cpu.values())
    true_color = (0.9, 0.55, 0.2)
    target = diff_render(dgpu, dr.set_emitter_color(dgpu.bundle, emit_row, light_row, true_color))

    def recover(c, tgt, bsdf_row, light, **kw):
        return lambda: dr.recover_emitter(c.bundle, c.settings, c.cam, c.px, c.py, c.width, c.height, tgt, bsdf_row,
                                          light, n_samples=c.n, key=c.key, **kw)

    def held_steps(name, eager, captured, rtol):
        """Captured recover_emitter against two eager runs: bit for bit where the eager runs are equal,
        else within ``rtol`` (the gathers' backward sums may reorder); the numbers a phase prints."""
        (c0, l0), (c1, l1), (cc, lc) = (r["out"] for r in (*eager, captured))
        eager_equal = l0 == l1 and torch.equal(c0, c1)
        spread = max(abs(a - b) / abs(b) for a, b in zip(l1, l0))
        if eager_equal:
            assert lc == l0 and torch.equal(cc, c0), f"{name}: the captured steps differ from the eager ones"
        else:
            worst = max(max(abs(a - b) / abs(b) for a, b in zip(lc, l0)), ((cc - c0).abs() / c0.abs()).max().item())
            assert worst <= rtol, (name, worst, spread)
        return {**step_numbers(eager[0], captured), "eager_runs_bit_equal": eager_equal,
                "eager_spread_maxrel": f"{spread:.3g}",
                "captured_vs_eager": "bit_equal" if lc == l0 and torch.equal(cc, c0) else
                f"{max(abs(a - b) / abs(b) for a, b in zip(lc, l0)):.3g}"}

    rec_call = recover(dgpu, target, emit_row, light_row, init_color=(2.0, 2.0, 2.0), steps=80, learning_rate=0.2)
    rec_eager = [step_run(rec_call, eager=True) for _ in range(2)]
    rec = step_run(rec_call, eager=False)
    color, rec_losses = rec["out"]
    rec_numbers = held_steps("diff_small", rec_eager, rec, 1e-4)
    color = color.cpu().numpy()
    assert rec_losses[-1] < rec_losses[0] * 1e-3, rec_losses[::20]
    assert np.abs(color - np.asarray(true_color)).max() <= 0.05, color
    phase("diff_small", t0, tris=sc.num_triangles, spheres=sc.num_spheres, width=320, height=240, spp=4, depth=2,
          forward_s=f"{fwd_s:.4f}", backward_s=f"{bwd_s:.4f}", peak_device_mib=f"{peak_small:.1f}",
          image_vs_cpu_maxrel=f"{img_err:.3g}", grads_vs_cpu_maxrel=json.dumps({k: float(f"{v:.3g}") for k, v in
                                                                                grad_err.items()}),
          recover_first_loss=f"{rec_losses[0]:.6g}", recover_last_loss=f"{rec_losses[-1]:.6g}",
          recovered_color=json.dumps([round(float(x), 5) for x in color]),
          recover_s_per_step=f"{sum(rec['step_s']) / 80:.4f}", recover_steps=80,
          **{f"recover_{k}": v for k, v in rec_numbers.items()}, launches=json.dumps(dsm_launches))
    del dcpu, img_cpu

    # -- 13. diff_cell: a 512x512 cell of the 1080p terrain file through D and B
    t0 = time.perf_counter()
    cell = ((1920 - 512) // 2, (1080 - 512) // 2, 512, 512)
    dcell = diff_case(terrain_file, "cuda", 1920, 1080, 1, 4, cell=cell)
    assert dcell.bundle.cscene.shade, "the 131,072-triangle file did not take the shade tree"
    sc = dcell.r.scene
    area_row = int(np.flatnonzero(sc.lights.light_type == LT_AREA)[0])
    diffuse_row = int(np.flatnonzero(sc.bsdfs.bsdf_type == BSDF_DIFFUSE)[0])
    cell_params = {"light": ("lights", "radiance", area_row), "albedo": ("bsdfs", "albedo", diffuse_row)}
    diff_grads(dcell, cell_params)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    ic.reset_launch_counts()
    img_cell, g_cell, fwd_s, bwd_s = diff_grads(dcell, cell_params)
    dcl_launches = {k: v.launches for k, v in ic.KERNELS.items()}
    assert dcl_launches["D"] > 0 and dcl_launches["B"] > 0, f"diff_cell skipped D or B: {dcl_launches}"
    peak_cell = (torch.cuda.max_memory_allocated() - mem0) / 2**20  # above what the phase started with
    assert img_cell.shape == (512 * 512, 3) and torch.isfinite(img_cell).all() and img_cell.sum() > 0
    # central differences along each gradient: the estimator is linear in the
    # light row and a polynomial in the albedo (RR does not read it); sound
    # runs read <= 1.9e-6 (light) and <= 5.5e-6 (albedo, the float32 loss's
    # rounding over the difference and the backward's atomic sums)
    fd_err = {}
    with torch.no_grad():
        for name, (group, field, row) in cell_params.items():
            g = g_cell[name]
            assert torch.isfinite(g).all() and g.norm() > 0, (name, g)
            eps = 0.1 if name == "light" else 0.02
            base = getattr(getattr(dcell.bundle, group), field)[row]
            step = eps * g / g.norm()
            hi, lo = (torch.sum(dcell.window * diff_render(dcell, dr.replace_row(dcell.bundle, group, field, row, v)))
                      for v in (base + step, base - step))
            fd = ((hi - lo) / (2 * eps)).item()
            fd_err[name] = abs(fd - g.norm().item()) / g.norm().item()
    assert fd_err["light"] <= 1e-4 and fd_err["albedo"] <= 1e-3, fd_err
    # where a step's time goes: one forward + backward under torch.profiler
    prof = frame_profile(lambda: diff_grads(dcell, cell_params))
    print(f"[diff_cell_profile] step_s={prof['frame_s']:.4f} traced_s={prof['traced_s']:.4f} "
          f"device_kernel_ms={prof['kernel_ms']:.3f} kernel_launches={prof['kernel_launches']} "
          f"busy_share={prof['busy_share_traced']:.4f} D_ms={prof['D_ms']:.3f} B_ms={prof['B_ms']:.3f} "
          f"top_kernels={json.dumps([[n[:60], round(ms, 3), c] for n, ms, c in prof['top_kernels'][:5]])}",
          flush=True)
    # recover_emitter on the cell: the area light's colour from the file's (4, 4, 3.6), 20 steps.  The
    # light has no emitting surface, so the BSDF row it names is the diffuse one, which no lane emits from
    light0 = dcell.bundle.lights.radiance[area_row].cpu().tolist()
    cell_target = diff_render(dcell, dr.set_emitter_color(dcell.bundle, diffuse_row, area_row,
                                                          [v * f for v, f in zip(light0, (0.8, 0.9, 1.1))]))
    cell_call = recover(dcell, cell_target, diffuse_row, area_row, init_color=tuple(light0), steps=20,
                        learning_rate=0.2)
    cell_eager = [step_run(cell_call, eager=True) for _ in range(2)]
    cell_rec = step_run(cell_call, eager=False)
    cell_losses = cell_rec["out"][1]
    cell_numbers = held_steps("diff_cell", cell_eager, cell_rec, 1e-4)
    assert cell_losses[-1] < cell_losses[0] and cell_rec["launches"]["D"] > 0, (cell_losses[::5], cell_rec["launches"])
    phase("diff_cell", t0, tris=sc.num_triangles, frame="1920x1080", cell=json.dumps(cell), lanes=512 * 512, spp=1,
          depth=4, forward_s=f"{fwd_s:.4f}", backward_s=f"{bwd_s:.4f}", peak_device_mib=f"{peak_cell:.1f}",
          grad_light=json.dumps([round(float(x), 4) for x in g_cell["light"]]),
          grad_albedo=json.dumps([round(float(x), 4) for x in g_cell["albedo"]]),
          fd_along_grad_relerr=json.dumps({k: float(f"{v:.3g}") for k, v in fd_err.items()}),
          recover_steps=20, recover_first_loss=f"{cell_losses[0]:.6g}", recover_last_loss=f"{cell_losses[-1]:.6g}",
          **{f"recover_{k}": v for k, v in cell_numbers.items()}, launches=json.dumps(dcl_launches))
    del dcell, img_cell, g_cell

    # -- 14. lens_design: optimize_lens at 128x128, checkpointed and resumed -
    t0 = time.perf_counter()
    cfg = OptimizeConfig()
    ghost_tex = torch.tensor(polygon_mask(64, 6), device="cuda")
    axis, angle = torch.tensor([0.6, 0.55], device="cuda"), 0.35
    target = ghost_image(reference_prescription(device="cuda"), ghost_tex, axis, angle, cfg.width, cfg.height)

    def perturbed(device):
        lens = reference_prescription(device=device)
        lens.curvatures = lens.curvatures * torch.tensor([1.03] + [1.0] * 9, device=device)
        return lens

    # the forward model and its gradient in every field, on the card and the CPU
    lens_err = {}
    outs = {}
    for device in ("cuda", "cpu"):
        lens = perturbed(device)
        for f in LENS_FIELDS:
            getattr(lens, f).requires_grad_(True)
        image = ghost_image(lens, ghost_tex.to(device), axis.to(device), angle, cfg.width, cfg.height)
        torch.sum((image - target.to(device)) ** 2).backward()
        outs[device] = (image.detach(), {f: getattr(lens, f).grad for f in LENS_FIELDS})
    lens_err["image"] = max_rel(outs["cuda"][0], outs["cpu"][0])
    lens_err.update({f: max_rel(outs["cuda"][1][f], outs["cpu"][1][f]) for f in LENS_FIELDS})
    # sound runs read 1.4e-7 (image) and <= 5.0e-7 (gradients) of each peak
    assert lens_err["image"] <= 1e-6 and max(lens_err.values()) <= 5e-6, lens_err
    run = dict(target=target, ghost_tex=ghost_tex, axis_ray=axis, angle=angle, init_lens=perturbed("cuda"),
               device="cuda")
    opt_eager = step_run(lambda: optimize_lens(config=OptimizeConfig(steps=35, log_every=0), **run), eager=True)
    opt = step_run(lambda: optimize_lens(config=OptimizeConfig(steps=35, log_every=0), **run), eager=False)
    lens_full, full = opt["out"]
    ms_step = sum(opt["step_s"]) / 35 * 1e3
    assert full[-1] < full[0], full
    # the smooth splat sums in a fixed order and Adam(capturable=True) runs the same kernels: bit for bit
    assert full == opt_eager["out"][1] and all(
        torch.equal(getattr(lens_full, f), getattr(opt_eager["out"][0], f)) for f in LENS_FIELDS), "captured != eager"
    ck_dir = build_dir / "lens_checkpoints"
    for old in ck_dir.glob("*"):
        old.unlink()
    _, first = optimize_lens(config=OptimizeConfig(steps=30, log_every=0, checkpoint_dir=str(ck_dir),
                                                   checkpoint_every=10), **run)
    lens_resumed, rest = optimize_lens(config=OptimizeConfig(steps=35, log_every=0, checkpoint_dir=str(ck_dir)), **run)
    assert first == full[:30] and rest == full[30:], (first[-2:], rest, full[28:])
    assert all(torch.equal(getattr(lens_resumed, f), getattr(lens_full, f)) for f in LENS_FIELDS)
    phase("lens_design", t0, width=cfg.width, height=cfg.height, ghosts=39, steps=35, resumed_at=30,
          ms_per_step=f"{ms_step:.3f}", **step_numbers(opt_eager, opt), captured_vs_eager="bit_equal",
          first_loss=f"{full[0]:.6g}", last_loss=f"{full[-1]:.6g}", resumed_losses_equal=True, vs_cpu_maxrel=json.dumps({k: float(f"{v:.3g}") for k, v in lens_err.items()}),
          curvature0=f"{float(lens_full.curvatures[0]):.7g}")

    # -- 15. render_resume: interrupted renders resume bit for bit ----------
    class Interrupted(Exception):
        pass

    def interrupted(r, call, after, path):
        """Render with a checkpoint, raising in ``call`` after ``after`` calls, as a crash would."""
        orig, calls = getattr(rmod, call), []

        def stop(*args, **kw):
            calls.append(1)
            if len(calls) > after:
                raise Interrupted
            return orig(*args, **kw)

        setattr(rmod, call, stop)
        try:
            r.render(progress=False, checkpoint_path=path)
            raise AssertionError("the render was not interrupted")
        except Interrupted:
            pass
        finally:
            setattr(rmod, call, orig)

    t0 = time.perf_counter()
    report = {}
    for name, r, call, after, kernels in (("tiled_small_frame", rs, "render_wavefront", 1, "AC"),
                                          ("adaptive_config2_small", rs2, "render_batch", 2, "DB")):
        path = build_dir / f"{name}.npz"
        path.unlink(missing_ok=True)
        want, want_counts = r.render(progress=False)
        interrupted(r, call, after, path)
        with np.load(path) as ck:
            at = int(ck["next_tile"]) if "next_tile" in ck else int(ck["stage"])
        assert at == 1, at
        ic.reset_launch_counts()
        got, got_counts = r.render(progress=False, checkpoint_path=path)
        torch.cuda.synchronize()
        rr_launches = {k: v.launches for k, v in ic.KERNELS.items()}
        assert all(rr_launches[k] > 0 for k in kernels), (name, rr_launches)
        assert torch.equal(got, want) and torch.equal(got_counts, want_counts), f"{name}: the resumed render differs"
        report[name] = f"resumed_at={at},bit_equal=True,launches={rr_launches[kernels[0]]}+{rr_launches[kernels[1]]}"
    phase("render_resume", t0, **report)

    # -- 16. env_small: terrain 8 under a sky through the command line (C, A)
    from lens_flare_tpu_torch.integrator.envlight import build_env
    from lens_flare_tpu_torch.integrator.lights import LT_ENV
    from lens_flare_tpu_torch.utils import exr

    t0 = time.perf_counter()
    env_file = terrain_dae(8).write(build_dir / "terrain8.dae")
    small_sky = build_dir / "sky_512x256.exr"
    exr.write(small_sky, sky_map(512, 256), pixel_type=exr.PIXELTYPE_HALF)
    sky_small = exr.read(small_sky)
    # the camera pulled back, as a camera settings file (-c)
    rcam = Renderer(device="cpu", width=320, height=240)
    rcam.load(env_file)
    pull_back(rcam.camera, 0.2)
    cam_file = build_dir / "terrain8_back.cam"
    rcam.camera.dump_settings(cam_file)
    env_png = build_dir / "terrain8_sky_320x240.png"
    ic.reset_launch_counts()
    cli_s, out = run_cli(["-r", "320", "240", "-s", "16", "-m", "5", "-e", str(small_sky), "-c", str(cam_file),
                          "-f", str(env_png), "--device", "cuda", str(env_file)])
    torch.cuda.synchronize()
    es_launches = {k: v.launches for k, v in ic.KERNELS.items()}
    assert es_launches["C"] > 0 and es_launches["A"] > 0, f"env_small skipped C or A: {es_launches}"
    assert f"Loading environment map {small_sky}" in out
    render_s, es_rays, _, _ = cli_numbers(out)
    # the same frame through Renderer.load: its PNG is the command line's, and
    # a cell where terrain meets sky agrees with the CPU render of the file
    kw = dict(width=320, height=240, ns_aa=16, max_ray_depth=5, indirect=True, seed=0, envmap=sky_small,
              camera_settings=str(cam_file))
    rg = Renderer(device="cuda", **kw)
    rg.load(env_file)
    assert int(rg.bundle.lights.light_type[-1]) == LT_ENV and rg.bundle.env is not None
    hdr_env, _ = rg.render(progress=False)
    want_px = np.clip(np.round(img.to_color(hdr_env.cpu().numpy())[::-1] * 255.0), 0, 255).astype(np.uint8)
    assert np.array_equal(load_png(env_png), want_px), "the PNG is not the frame's"
    cell = (64, 84, 96, 72)
    sky_share = miss_share(rg)
    cell_sky_share = miss_share(rg, cell)
    assert 0.2 <= sky_share <= 0.9 and 0.1 <= cell_sky_share <= 0.9, (sky_share, cell_sky_share)
    rcpu = Renderer(device="cpu", **kw)
    rcpu.load(env_file)
    want, _ = rcpu.render(cell=cell, progress=False)
    x0, y0, dx, dy = cell
    got = hdr_env.cpu().double()[y0 : y0 + dy, x0 : x0 + dx]
    want = want.double()[y0 : y0 + dy, x0 : x0 + dx]
    ok = ((got - want).abs() <= 1e-4 + 1e-4 * want.abs()).all(dim=-1).double().mean().item()
    rel = ((got - want).abs().sum() / want.abs().sum()).item()
    assert torch.isfinite(got).all() and got.sum() > 0 and ok >= 0.99 and rel < 1e-3, (ok, rel)
    phase("env_small", t0, tris=rg.scene.num_triangles, sky="512x256 HALF ZIP", width=320, height=240, spp=16,
          depth=5, sky_share=f"{sky_share:.4f}", cli_s=f"{cli_s:.4f}", frame_s_includes_capture="yes", render_s=f"{render_s:.4f}",
          rays_traced=es_rays, cell=json.dumps(cell), cell_sky_share=f"{cell_sky_share:.4f}",
          cell_pixels_within_tol=f"{ok:.5f}", cell_mean_rel_diff=f"{rel:.3g}", launches=json.dumps(es_launches),
          png=env_png.name)
    del rcam, rg, rcpu

    # -- 17. env_1080p: terrain 256 under a 4096x2048 HALF ZIP sky, with the flare (D, B)
    t0 = time.perf_counter()
    big_sky = build_dir / "sky_4096x2048.exr"
    t_write = time.perf_counter()
    exr.write(big_sky, sky_map(4096, 2048), compression=exr.COMPRESSION_ZIP, pixel_type=exr.PIXELTYPE_HALF)
    write_s = time.perf_counter() - t_write
    t_read = time.perf_counter()
    sky_big = exr.read(big_sky)
    read_s = time.perf_counter() - t_read
    assert sky_big.shape == (2048, 4096, 3) and sky_big.max() == 6e4
    torch.cuda.synchronize()
    t_env = time.perf_counter()
    env_big = build_env(sky_big, "cuda")
    torch.cuda.synchronize()
    build_env_s = time.perf_counter() - t_env
    del env_big
    env_big_png = build_dir / "terrain256_sky_1080p.png"
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    ic.reset_launch_counts()
    cli_s, out = run_cli(["-r", "1920", "1080", "-s", "1", "-m", "4", "-x", str(ap_png), "-y", str(ghost_png),
                          "-i", "1.5", "-n", "30", "-e", str(big_sky), "-f", str(env_big_png), "--device", "cuda",
                          str(terrain_file)])
    torch.cuda.synchronize()
    peak_env = (torch.cuda.max_memory_allocated() - mem0) / 2**20  # above what the phase started with
    eb_launches = {k: v.launches for k, v in ic.KERNELS.items()}
    assert eb_launches["D"] > 0 and eb_launches["B"] > 0, f"env_1080p skipped D or B: {eb_launches}"
    env_frame_s, eb_rays, load_s, _ = cli_numbers(out)
    sky_frame = load_png(env_big_png)
    # the sky lights the frame: brighter than dae_1080p's frame of the same file without it
    dark_mean = load_png(big_png).mean()
    assert sky_frame.shape == (1080, 1920, 3) and sky_frame.mean() > dark_mean + 5, (sky_frame.mean(), dark_mean)
    phase("env_1080p", t0, tris=131072, sky="4096x2048 HALF ZIP", width=1920, height=1080, spp=1, depth=4,
          flare="on", exr_write_s=f"{write_s:.4f}", exr_read_s=f"{read_s:.4f}", build_env_s=f"{build_env_s:.4f}",
          parse_build_s=f"{load_s:.4f}", frame_s=f"{env_frame_s:.4f}", cli_s=f"{cli_s:.4f}", frame_s_includes_capture="yes", rays_traced=eb_rays,
          mrays_traced_per_s=f"{eb_rays / env_frame_s / 1e6:.3f}", peak_device_mib=f"{peak_env:.1f}",
          png_mean=f"{sky_frame.mean():.3f}", png_mean_without_sky=f"{dark_mean:.3f}",
          launches=json.dumps(eb_launches), png=env_big_png.name)
    # where the sky's time goes: the same render with and without it, untraced and then under torch.profiler
    profiles = {}
    for name, env_map in (("sky", sky_big), ("no_sky", None)):
        rp = Renderer(device="cuda", width=1920, height=1080, max_ray_depth=4, indirect=True, envmap=env_map)
        rp.load(terrain_file)
        if env_map is not None:
            compiled_row("env_1080p", rp, lambda: rp.render(progress=False))
        profiles[name] = frame_profile(lambda: rp.render(progress=False))
    print("[env_1080p_profile] " + " ".join(
        f"{name}:frame_s={p['frame_s']:.4f},traced_s={p['traced_s']:.4f},device_kernel_ms={p['kernel_ms']:.3f},"
        f"kernel_launches={p['kernel_launches']},busy_share={p['busy_share_traced']:.4f},"
        f"D_ms={p['D_ms']:.3f},B_ms={p['B_ms']:.3f},"
        f"top_kernels={json.dumps([[n[:60], round(ms, 3), c] for n, ms, c in p['top_kernels'][:5]])}"
        for name, p in profiles.items()), flush=True)
    del sky_big, rp

    # -- 18. env_diff: the texel gradient of a 512x512 cell (A, C), against the CPU and a central difference
    t0 = time.perf_counter()
    cell = (400, (1080 - 512) // 2, 512, 512)  # left of the terrain's centre: part terrain, part sky
    texels = {"texels": ("env", "data", None)}
    denv = diff_case(env_file, "cuda", 1920, 1080, 1, 2, cell=cell, back=0.2, envmap=sky_small)
    cell_sky_share = miss_share(denv.r, cell)
    assert 0.2 <= cell_sky_share <= 0.8, cell_sky_share
    diff_grads(denv, texels)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    ic.reset_launch_counts()
    img_envd, g_envd, fwd_s, bwd_s = diff_grads(denv, texels)
    ed_launches = {k: v.launches for k, v in ic.KERNELS.items()}
    assert ed_launches["A"] > 0 and ed_launches["C"] > 0, f"env_diff skipped A or C: {ed_launches}"
    peak_envd = (torch.cuda.max_memory_allocated() - mem0) / 2**20
    g = g_envd["texels"]
    assert img_envd.shape == (512 * 512, 3) and torch.isfinite(img_envd).all() and torch.isfinite(g).all()
    texels_reached = int((g != 0).any(dim=-1).sum())
    assert texels_reached > 0 and g.norm() > 0
    dcpu_env = diff_case(env_file, "cpu", 1920, 1080, 1, 2, cell=cell, back=0.2, envmap=sky_small)
    img_cpu, g_cpu, _, _ = diff_grads(dcpu_env, texels)
    env_img_err = max_rel(img_envd, img_cpu)
    env_grad_err = max_rel(g, g_cpu["texels"])
    # a miss pixel's lookup moves by an ulp of arctan2 (arccos) times W / 2 pi (H / pi) texels, which
    # at the sun disk's edge (6e4 next to ~1) is up to 6e4 times that: every pixel is held to 1e-4 of
    # its value (+1e-5) plus two such ulps of each angle, all but 0.1% of them without that term,
    # and the gradient to 1e-4 of its peak
    sky_h, sky_w = sky_small.shape[:2]
    lookup_ulps = 2 * float(sky_small.max()) * (sky_w / (2 * np.pi) * np.spacing(np.float32(2 * np.pi))
                                                + sky_h / np.pi * np.spacing(np.float32(np.pi)))
    pix_err = (img_envd.cpu().double() - img_cpu.double()).abs()
    pix_tol = 1e-4 * img_cpu.double().abs() + 1e-5
    beyond = int((pix_err > pix_tol).any(dim=-1).sum())
    assert bool((pix_err <= pix_tol + lookup_ulps).all()) and beyond <= 1e-3 * pix_err.shape[0], (
        env_img_err, beyond, lookup_ulps)
    assert env_grad_err <= 1e-4, env_grad_err
    # a central difference along the gradient: the image is linear in the texels
    with torch.no_grad():
        step = 0.05 * g / g.norm()
        hi, lo = (torch.sum(denv.window * diff_render(denv, dr.set_env_texels(denv.bundle, denv.bundle.env.data + v)))
                  for v in (step, -step))
        fd = ((hi - lo) / (2 * 0.05)).item()
    env_fd_err = abs(fd - g.norm().item()) / g.norm().item()
    assert env_fd_err <= 1e-4, env_fd_err
    phase("env_diff", t0, tris=denv.r.scene.num_triangles, sky="512x256", frame="1920x1080", cell=json.dumps(cell),
          lanes=512 * 512, cell_sky_share=f"{cell_sky_share:.4f}", spp=1, depth=2, forward_s=f"{fwd_s:.4f}", backward_s=f"{bwd_s:.4f}",
          peak_device_mib=f"{peak_envd:.1f}", texels_reached=texels_reached,
          image_vs_cpu_maxrel=f"{env_img_err:.3g}", pixels_beyond_1e4_rel=beyond, lookup_ulps_abs=f"{lookup_ulps:.3g}",
          grad_vs_cpu_maxrel=f"{env_grad_err:.3g}",
          fd_along_grad_relerr=f"{env_fd_err:.3g}", launches=json.dumps(ed_launches))
    del denv, dcpu_env, img_cpu, g_cpu

    # -- 19. realistic_1080p: config 3 whole, the sky and the Snell + Fresnel ghosts (D, B)
    import dataclasses

    from lens_flare_tpu_torch.lens import realistic
    from lens_flare_tpu_torch.lens.aperture import ApertureTexture

    t0 = time.perf_counter()
    real_png = build_dir / "terrain256_sky_realistic_1080p.png"
    config3 = ["-r", "1920", "1080", "-s", "1", "-m", "4", "-x", str(ap_png), "-i", "1.5", "-n", "30",
               "-e", str(big_sky), "--lens-model", "realistic"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    ic.reset_launch_counts()
    cli_s, out = run_cli([*config3, "-f", str(real_png), "--device", "cuda", str(terrain_file)])
    torch.cuda.synchronize()
    peak_real = (torch.cuda.max_memory_allocated() - mem0) / 2**20
    rl_launches = {k: v.launches for k, v in ic.KERNELS.items()}
    assert rl_launches["D"] > 0 and rl_launches["B"] > 0 and rl_launches["H"] > 0, (
        f"realistic_1080p skipped D, B or H: {rl_launches}")
    assert rl_launches["I"] == 0 and rl_launches["I_plain"] > 0, f"config 3 took kernel I: {rl_launches}"
    real_frame_s, rl_rays, _, _ = cli_numbers(out)
    # the same frame unflared through Renderer.load, then its flare: strictly additive, and the PNG's
    rr = Renderer(device="cuda", width=1920, height=1080, max_ray_depth=4, indirect=True, envmap=exr.read(big_sky),
                  aperture_path=str(ap_png), flare_intensity=1.5, flare_radius=30.0, lens_model="realistic")
    rr.load(terrain_file)
    hdr_real, _ = rr.render(progress=False)
    pipe = rr.flare_pipeline()
    assert pipe is not None and pipe.lens_model == "realistic" and pipe.ghost_aperture is None
    assert 0 < pipe.axis_ray.min() and pipe.axis_ray.max() < 1, f"the sun is off screen: {pipe.axis_ray}"
    compiled_row("ghost_realistic", rr, pipe.ghost_buffer, ghosts=pipe.axis_ray)
    assert compiled_rows["ghost_realistic"]["bit_equal"], "the replayed realistic ghosts differ from the eager ones"
    ghost = pipe.ghost_buffer()
    flared = hdr_real + ghost + pipe.starburst() + pipe.falloff()
    assert bool((ghost >= 0).all()) and ghost.sum().item() > 0, "the realistic ghosts have no energy"
    assert bool(torch.isfinite(flared).all()) and bool((flared >= hdr_real).all()), "the flare is not additive"
    # the ghosts sum in a fixed order (realistic.ordered_sum): the CLI's ghosts are these, bit for bit
    want_px = np.clip(np.round(img.to_color(flared.cpu().numpy())[::-1] * 255.0), 0, 255).astype(np.int64)
    png_levels = int(np.abs(load_png(real_png).astype(np.int64) - want_px).max())
    assert png_levels == 0, f"the PNG is not the flared frame's: {png_levels} levels"
    # the ghost buffer alone against the paraxial one of the same pipeline, then the card against the CPU
    prof_real = frame_profile(pipe.ghost_buffer)
    paraxial_pipe = dataclasses.replace(pipe, lens_model="paraxial", ghost_aperture=ApertureTexture.load(ghost_png))
    compiled_row("ghost_paraxial", rr, paraxial_pipe.ghost_buffer, ghosts=pipe.axis_ray)
    prof_par = frame_profile(paraxial_pipe.ghost_buffer)
    ghost_again = pipe.ghost_buffer()
    ghost_cpu = dataclasses.replace(pipe, device="cpu", lens=reference_prescription(device="cpu")).ghost_buffer()
    # the CPU test's tolerance against JAX (1e-3 of the peak) covers the accumulation order too
    ghost_vs_cpu = ((ghost.cpu() - ghost_cpu).abs().max() / ghost_cpu.abs().max()).item()
    ghost_card_runs = (ghost_again - ghost).abs().max().item()
    assert ghost_vs_cpu <= 1e-3, ghost_vs_cpu
    assert ghost_card_runs == 0 and torch.equal(ghost_again, ghost), f"two card runs differ: {ghost_card_runs}"
    # ghost by ghost, so that a dim one can fail: float32 to GHOST_F32 and float64 to GHOST_F64, then
    # the whole buffer in float64 (the peak's reading above, without float32's rounding)
    ghost_args = (pipe.angle_to_sun, pipe.flare_radiances.sum(axis=0), pipe.axis_ray, 1920, 1080)
    ghost_worst = ghost_checks(*ghost_args)
    f64_bufs = [realistic.render_ghosts_stack(float32_lens(dev, torch.float64), *(
        torch.tensor(v, dtype=torch.float32).to(dev, torch.float64) for v in ghost_args[:3]), 1920, 1080).cpu()
        for dev in ("cuda", "cpu")]
    ghost_vs_cpu_f64 = ((f64_bufs[0] - f64_bufs[1]).abs().max() / f64_bufs[1].abs().max()).item()
    assert ghost_vs_cpu_f64 <= 1e-9, ghost_vs_cpu_f64
    # float32's own rounding at the peak, on either side: each float32 buffer against the CPU's float64
    f32_vs_f64 = {side: ((buf.cpu().double() - f64_bufs[1]).abs().max() / f64_bufs[1].abs().max()).item()
                  for side, buf in (("card", ghost), ("cpu", ghost_cpu))}
    del f64_bufs, rr, hdr_real, flared, ghost, ghost_again
    phase("realistic_1080p", t0, tris=131072, sky="4096x2048 HALF ZIP", width=1920, height=1080, spp=1, depth=4,
          lens_model="realistic", frame_s=f"{real_frame_s:.4f}", cli_s=f"{cli_s:.4f}", frame_s_includes_capture="yes", rays_traced=rl_rays,
          peak_device_mib=f"{peak_real:.1f}", png_levels_vs_flared_frame=png_levels,
          ghost_s=f"{prof_real['frame_s']:.4f}", ghost_device_launches=prof_real["kernel_launches"],
          ghost_kernel_ms=f"{prof_real['kernel_ms']:.3f}", ghost_busy_share=f"{prof_real['busy_share_traced']:.4f}",
          paraxial_ghost_s=f"{prof_par['frame_s']:.4f}", paraxial_ghost_device_launches=prof_par["kernel_launches"],
          paraxial_ghost_kernel_ms=f"{prof_par['kernel_ms']:.3f}", ghost_vs_cpu_maxrel=f"{ghost_vs_cpu:.3g}",
          ghost_vs_cpu_f64_maxrel=f"{ghost_vs_cpu_f64:.3g}", ghost_card_f32_vs_cpu_f64_maxrel=f"{f32_vs_f64['card']:.3g}",
          ghost_cpu_f32_vs_f64_maxrel=f"{f32_vs_f64['cpu']:.3g}",
          ghost_two_card_runs_maxabs=f"{ghost_card_runs:.3g}", ghost_peak=f"{ghost_cpu.abs().max().item():.4g}",
          launches=json.dumps(rl_launches), png=real_png.name)
    print(f"[realistic_1080p_ghosts] worst={json.dumps(ghost_worst)}", flush=True)
    print("[realistic_1080p_ghost_profile] " + " ".join(
        f"{name}:top_kernels={json.dumps([[n[:60], round(ms, 3), c] for n, ms, c in p['top_kernels'][:5]])}"
        for name, p in (("realistic", prof_real), ("paraxial", prof_par))), flush=True)

    # lens design through the stack (configs 3 + 5): curvature 7 recovered from 1.25x by Adam
    t0 = time.perf_counter()
    design_pairs = ((0, 1), (2, 4), (6, 8))

    def design_image(lens, dev):
        return realistic.render_ghosts_stack(lens, 0.3, torch.ones(3, device=dev), torch.tensor([0.6, 0.55], device=dev),
                                             64, 64, pupil_samples=12, pairs=design_pairs)

    def design_loss(curv, target, dev):
        lens = reference_prescription(device=dev)
        lens.curvatures = curv
        return ((design_image(lens, dev) - target) ** 2).mean() * 1e6

    c_true = reference_prescription().curvatures
    c_start = c_true.clone()
    c_start[7] *= 1.25
    targets = {dev: design_image(reference_prescription(device=dev), dev) for dev in ("cuda", "cpu")}
    start_grads = {}
    for dev in ("cuda", "cpu"):
        c = c_start.to(dev, copy=True).requires_grad_(True)
        design_loss(c, targets[dev], dev).backward()
        start_grads[dev] = c.grad.cpu()
    design_grad_err = ((start_grads["cuda"] - start_grads["cpu"]).abs().max() / start_grads["cpu"].abs().max()).item()
    assert torch.isfinite(start_grads["cuda"]).all() and design_grad_err <= 1e-3, design_grad_err
    curv = c_start.to("cuda", copy=True).requires_grad_(True)
    mask = torch.zeros_like(curv)
    mask[7] = 1.0
    opt = torch.optim.Adam([curv], lr=2e-4)
    with torch.no_grad():
        loss0 = design_loss(curv, targets["cuda"], "cuda").item()
    torch.cuda.synchronize()
    t_steps = time.perf_counter()
    design_steps = 150
    for _ in range(design_steps):
        opt.zero_grad()
        loss = design_loss(curv, targets["cuda"], "cuda")
        loss.backward()
        curv.grad *= mask
        opt.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t_steps) / design_steps * 1e3
    c7_err = abs(curv[7].item() - c_true[7].item()) / abs(c_start[7].item() - c_true[7].item())
    assert loss.item() < 1e-3 * loss0 and c7_err <= 0.05, (loss.item(), loss0, c7_err)
    phase("realistic_design", t0, film="64x64", pupil=12, pairs=json.dumps(design_pairs), steps=design_steps,
          ms_per_step=f"{step_ms:.3f}", loss0=f"{loss0:.6g}", loss_final=f"{loss.item():.6g}",
          curvature7_left_of_perturbation=f"{c7_err:.4g}", start_grad_vs_cpu_maxrel=f"{design_grad_err:.3g}")
    del targets, curv, opt

    # -- 20. upsample_1080p: --upsample 1 on terrain 256's file, 524,288 triangles at 1920x1080 (A, B)
    import copy

    from lens_flare_tpu_torch import compiled
    from lens_flare_tpu_torch.scene.halfedge import subdivide_scene

    def close_rule(got, want):
        """The CPU tests' rule (phase 4): share of pixels within 1e-4 + 1e-4 relative, mean relative diff."""
        got, want = got.reshape(-1, 3).double(), want.reshape(-1, 3).double()
        ok = ((got - want).abs() <= 1e-4 + 1e-4 * want.abs()).all(dim=-1).double().mean().item()
        return ok, ((got - want).abs().sum() / want.abs().sum()).item()

    t0 = time.perf_counter()
    up_png = build_dir / "terrain256_upsample1_1080p.png"
    up_flags = dict(width=1920, height=1080, ns_aa=1, max_ray_depth=4, indirect=True,
                    aperture_path=str(ap_png), ghost_aperture_path=str(ghost_png), flare_intensity=1.5,
                    flare_radius=30.0)
    ic.reset_launch_counts()
    cli_s, out = run_cli(["-r", "1920", "1080", "-s", "1", "-m", "4", "-x", str(ap_png), "-y", str(ghost_png),
                          "-i", "1.5", "-n", "30", "--upsample", "1", "-f", str(up_png), "--device", "cuda",
                          str(terrain_file)])
    torch.cuda.synchronize()
    up_launches = {k: v.launches for k, v in ic.KERNELS.items()}
    assert up_launches["A"] > 0 and up_launches["B"] > 0, f"the subdivided frame skipped A or B: {up_launches}"
    assert "Loop-subdivided x1: 131072 -> 524288 triangles" in out, out
    import re

    sub_s = float(re.search(r"Subdivided in ([0-9.]+) sec", out).group(1))
    up_render_s, up_rays, up_load_s, up_bvh_s = cli_numbers(out)
    up_frame = load_png(up_png)
    assert up_frame.shape == (1080, 1920, 3) and up_frame.max() > 0 and up_frame.std() > 0, "the PNG is blank"
    # the same renderer in this process, as the command line builds it, for the held frame and the viewer
    ru = Renderer(device="cuda", **up_flags)
    ru.load(terrain_file, build=False)
    t_sub = time.perf_counter()
    up_scene = subdivide_scene(ru.scene, 1)
    sub_here_s = time.perf_counter() - t_sub
    ru.load_flat_scene(up_scene, camera=ru.camera)
    assert ru.scene.num_triangles == 524_288 and ru.bundle.cscene is not None and not ru.bundle.cscene.shade
    compiled_row("upsample_1080p", ru, lambda: ru.render(progress=False))
    held("upsample_1080p", up_launches)  # the command line's one frame is this one
    # a 64x64 cell at the frame's centre, against the port's CPU path on the same scene and camera
    up_cell = (928, 508, 64, 64)
    got, _ = ru.render(cell=up_cell, progress=False)
    rcpu = Renderer(device="cpu", **{k: v for k, v in up_flags.items() if not k.startswith(("aperture", "ghost"))})
    rcpu.load_flat_scene(ru.scene, camera=copy.deepcopy(ru.camera))
    want, _ = rcpu.render(cell=up_cell, progress=False)
    x0, y0, dx, dy = up_cell
    got, want = got.cpu()[y0 : y0 + dy, x0 : x0 + dx], want[y0 : y0 + dy, x0 : x0 + dx]
    ok, rel = close_rule(got, want)
    assert torch.isfinite(got).all() and got.sum() > 0 and ok >= 0.99 and rel < 1e-3, (ok, rel)
    assert rcpu.stats.total_rays == ru.stats.total_rays, (rcpu.stats.total_rays, ru.stats.total_rays)
    del rcpu
    phase("upsample_1080p", t0, tris_in=131072, tris=ru.scene.num_triangles, width=1920, height=1080, spp=1,
          depth=4, flare="on", subdivide_s=f"{sub_s:.4f}", subdivide_s_in_process=f"{sub_here_s:.4f}",
          parse_build_s=f"{up_load_s:.4f}", bvh_build_s=f"{up_bvh_s:.4f}",
          frame_s=f"{up_render_s:.4f}", frame_s_includes_capture="yes", cli_s=f"{cli_s:.4f}",
          rays_traced=up_rays, mrays_traced_per_s=f"{up_rays / up_render_s / 1e6:.3f}",
          cell=json.dumps(up_cell), cell_pixels_within_tol=f"{ok:.5f}", cell_mean_rel_diff=f"{rel:.3g}",
          launches=json.dumps(up_launches), png=up_png.name)

    # -- 21. interactive: the viewer's Application on that renderer, the mesh-edit keys, a tty frame
    from lens_flare_tpu_torch.app import LEFT, Application, Mode
    from lens_flare_tpu_torch.term_viewer import frame_to_ansi

    def host_ms(fn, n):
        """Host ms per call of ``fn`` (each ends in a copy to the host, which waits for the device)."""
        t_fn = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t_fn) / n * 1e3

    t0 = time.perf_counter()
    ru.ns_aa = 4
    app = Application(ru, preview_width=256, progressive_batch=1)

    def preview():
        """A fresh EDIT frame (the preview program), as tensors: colour, then the hit mask."""
        app._preview_cache = None
        app.frame()
        return torch.as_tensor(app._preview_cache), torch.as_tensor(app._preview_hit)

    # EDIT: 256 x 144, eager and replayed; an orbit replays without a new capture
    compiled_row("app_preview", ru, preview)
    programs = len(ru._programs)
    first = preview()
    assert first[0].shape == (144, 256, 3) and first[1].float().mean() > 0.2
    preview_ms = host_ms(preview, 20)
    with compiled.disabled():
        preview_eager_ms = host_ms(preview, 5)
    app.mouse_pressed(LEFT, 900.0, 500.0)
    app.cursor_event(960.0, 470.0)  # a left drag: rotate_by
    app.mouse_released(LEFT)
    orbited = preview()
    assert len(ru._programs) == programs, "an orbit captured anew"
    assert not torch.equal(orbited[0], first[0]), "the orbit did not reach the replayed program"
    with compiled.disabled():
        orbited_eager = preview()
    assert all(torch.equal(a, b) for a, b in zip(orbited, orbited_eager)), "the orbited replay differs from eager"
    app.keyboard_event(" ")  # back to the canonical view
    # VISUALIZE: the host binary BVH (built once) under the dimmed preview
    app.keyboard_event("v")
    t_vis = time.perf_counter()
    vis = app.frame()
    vis_first_s = time.perf_counter() - t_vis
    for key in ("LEFT", "RIGHT"):
        app.keyboard_event(key)
    vis_ms = host_ms(app.frame, 5)
    assert vis.shape == (144, 256, 3) and app.mode == Mode.VISUALIZE and len(app.selection_history) == 3
    # RENDER: ns_aa 4, one sample per frame, eagerly and then replayed, frame for frame bit-equal
    app.keyboard_event("r")

    def progressive():
        """The first progressive frame from a fresh start: film and counts on the card."""
        app.start_raytracing()
        app.frame()
        return app._film, app._counts

    compiled_row("app_progressive", ru, progressive)
    # each program's capture seconds: the preview's, and a RENDER frame's keys and sample programs per lane width
    program_capture_s = {f"{key[0]}@{shapes[0][0]}": round(sec, 4) for key, shapes, sec in ru._programs.capture_seconds()}
    runs = {}
    for tag in ("eager", "replayed"):
        app.start_raytracing()
        films, frame_times, counted = [], [], []
        with compiled.disabled() if tag == "eager" else contextlib.nullcontext():
            while not app.render_done:
                ic.reset_launch_counts()
                t_f = time.perf_counter()
                last = app.frame()
                frame_times.append(time.perf_counter() - t_f)
                counted.append({k: v.launches for k, v in ic.KERNELS.items()})
                films.append((app._film.clone(), app._counts.clone()))
        runs[tag] = (films, frame_times, counted)
    assert len(runs["replayed"][0]) == 4
    for (f, c), (fe, ce) in zip(runs["replayed"][0], runs["eager"][0]):
        assert torch.equal(f, fe) and torch.equal(c, ce), "a replayed progressive frame differs from eager"
    assert runs["replayed"][2] == runs["eager"][2], "replayed progressive frames counted other launches"
    prog_launches = runs["replayed"][2][1]
    assert prog_launches["A"] > 0 and prog_launches["B"] > 0, f"the progressive frame skipped A or B: {prog_launches}"
    # this renderer holds terrain256.dae's scene: four BSDF families and an area light, no sky: kernel I's
    # general instance
    assert prog_launches["I"] > 0 and prog_launches["I_plain"] == 0, f"config 3's scene left kernel I: {prog_launches}"
    held("app_progressive", prog_launches)
    assert last.shape == (1080, 1920, 3) and np.isfinite(last).all() and (app._counts == 4).all()
    # sample for sample the offline render (rtol 1e-5, atol 1e-6: tests/test_app.py:96's limits)
    offline, _ = ru.render(progress=False)
    prog_hdr = app._hdr()
    assert torch.allclose(prog_hdr, offline, rtol=1e-5, atol=1e-6), "the progressive film is not the offline render"
    prog_vs_offline = (prog_hdr - offline).abs().max().item()
    # a key that changes the settings ('=': area-light samples x2) drops the programs; the next frame captures
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    c0 = ru._programs.capture_s
    app.keyboard_event("=")
    programs_dropped = len(ru._programs) == 0
    t_key = time.perf_counter()
    app.frame()
    key_frame_s = time.perf_counter() - t_key
    torch.cuda.synchronize()
    programs_after_key = len(ru._programs)
    key_program_capture_s = {f"{key[0]}@{shapes[0][0]}": round(sec, 4) for key, shapes, sec in ru._programs.capture_seconds()}
    key_capture_s = ru._programs.capture_s - c0
    key_peak = torch.cuda.max_memory_allocated() / 2**20
    key_peak_above = (torch.cuda.max_memory_allocated() - mem0) / 2**20
    assert programs_dropped and programs_after_key == 4, (programs_dropped, programs_after_key)
    # the tty front end's frame: 160 x 45 cells, two film rows per cell
    t_tty = time.perf_counter()
    tty = frame_to_ansi(last, 160, 45)
    tty_s = time.perf_counter() - t_tty
    assert tty.count("▀") == 160 * 45 and tty.count("\n") == 44
    # the mesh-edit keys on the Cornell box, on the card and on the CPU: the same scenes, previews alike
    def box_app(dev):
        rb = Renderer(device=dev, width=320, height=240, ns_aa=2, max_ray_depth=3, indirect=True, seed=0)
        rb.load(cornell)
        a = Application(rb, preview_width=256)
        a.selected_mesh = 5  # the open block
        a.frame()
        return a

    card, host = box_app("cuda"), box_app("cpu")
    edits = {}
    for key in "udifsc":
        for a in (card, host):
            a.keyboard_event(key)
        sc, scpu = card.renderer.scene, host.renderer.scene
        assert np.array_equal(sc.tri_p, scpu.tri_p) and np.array_equal(sc.tri_n, scpu.tri_n), key
        changed = not card.log[-1].endswith(("(non-manifold input)", "manifoldness guard)", "; ignored"))
        assert not changed or len(card.renderer._programs) == 0, f"{key}: the edit kept the old programs"
        got, want = torch.as_tensor(card.frame()), torch.as_tensor(host.frame())
        hit_same = torch.as_tensor(card._preview_hit) == torch.as_tensor(host._preview_hit)
        ok, rel = close_rule(got, want)
        assert hit_same.double().mean().item() >= 0.999 and ok >= 0.99 and rel < 1e-3, (key, ok, rel)
        edits[key] = f"{sc.num_triangles}:{'edited' if changed else 'declined'}:{ok:.4f}"
    assert sum(":edited:" in v for v in edits.values()) >= 3, edits
    for a in (card, host):
        a.keyboard_event("r")
    ok, rel = close_rule(torch.as_tensor(card.frame()), torch.as_tensor(host.frame()))
    assert ok >= 0.99 and rel < 1e-3, ("the edited box's RENDER frame", ok, rel)
    rows = {k: compiled_rows[k] for k in ("app_preview", "app_progressive")}
    phase("interactive", t0, tris=ru.scene.num_triangles, width=1920, height=1080, preview="256x144",
          preview_ms=f"{preview_ms:.3f}", preview_eager_ms=f"{preview_eager_ms:.3f}",
          preview_capture_s=f"{rows['app_preview']['capture_s']:.4f}",
          visualize_first_s=f"{vis_first_s:.4f}", visualize_ms=f"{vis_ms:.3f}", ns_aa=4, progressive_batch=1,
          progressive_ms=json.dumps([round(s * 1e3, 3) for s in runs["replayed"][1]]),
          progressive_eager_ms=json.dumps([round(s * 1e3, 3) for s in runs["eager"][1]]),
          progressive_capture_s=f"{rows['app_progressive']['capture_s']:.4f}",
          progressive_vs_offline_max_abs=f"{prog_vs_offline:.3g}",
          key_frame_s=f"{key_frame_s:.4f}", key_capture_s=f"{key_capture_s:.4f}",
          program_capture_s=json.dumps(program_capture_s), key_program_capture_s=json.dumps(key_program_capture_s),
          programs_after_key=programs_after_key, peak_mib_after_key=f"{key_peak:.1f}",
          peak_mib_above_key=f"{key_peak_above:.1f}", tty_s=f"{tty_s:.4f}",
          launches_per_progressive_frame=json.dumps(prog_launches),
          traced=json.dumps({k: v["traced_launches"] for k, v in rows.items()}),
          mesh_edits=json.dumps(edits))
    del app, ru, card, host

    # the viewer cell's path: a RENDER frame of terrain 512 at 800x600, one sample a frame, through kernel I
    t0 = time.perf_counter()
    rv = Renderer(device="cuda", width=800, height=600, ns_aa=16, max_ray_depth=4, indirect=True, seed=0)
    rv.load_flat_scene(make_terrain_scene(512))
    app_v = Application(rv, progressive_batch=1)
    app_v.keyboard_event("r")
    app_v.frame()  # captures the frame's programs
    ic.reset_launch_counts()
    app_v.frame()
    torch.cuda.synchronize()
    viewer_launches = {k: v.launches for k, v in ic.KERNELS.items()}
    assert viewer_launches["I"] > 0 and viewer_launches["I_plain"] == 0, f"the viewer left kernel I: {viewer_launches}"
    phase("viewer_frame", t0, tris=rv.scene.num_triangles, width=800, height=600, launches=json.dumps(viewer_launches))
    del app_v, rv

    # -- 22. compiled: the replayed frames against eager ones (rows printed in phases 3-21)
    assert sorted(compiled_rows) == sorted(COMPILED_FRAMES), sorted(compiled_rows)
    phase("compiled", t_start, frames=len(compiled_rows),
          bit_equal=json.dumps(sorted(k for k, v in compiled_rows.items() if v["bit_equal"])),
          ghost_checks_held=json.dumps(sorted(k for k, v in compiled_rows.items() if v["ghost_worst"])),
          **{f"{k}_frame_s": f"{v['frame_s']:.4f}" for k, v in compiled_rows.items()},
          **{f"{k}_eager_s": f"{v['eager_s']:.4f}" for k, v in compiled_rows.items()},
          **{f"{k}_capture_s": f"{v['capture_s']:.4f}" for k, v in compiled_rows.items()},
          **{f"{k}_busy": f"{v['busy_share']:.4f}" for k, v in compiled_rows.items()})

    # -- 23. sharded: terrain_1080p on a mesh of stand-in shards (and of every card, where there are more)
    import socket

    from lens_flare_tpu_torch import _rng
    from lens_flare_tpu_torch.diff.optimize import LENS_FIELDS
    from lens_flare_tpu_torch.integrator.path import render_wavefront
    from lens_flare_tpu_torch.lens.prescription import reference_prescription
    from lens_flare_tpu_torch.parallel import mesh as pmesh
    from lens_flare_tpu_torch.parallel import render as prender
    from lens_flare_tpu_torch.renderer import blocked_order
    from lens_flare_tpu_torch.scene.camera import camera_params

    def timed_frame(rr, eager=False):
        """One synchronized frame of ``rr``: (hdr, counts, (rays, tests, skipped), launches of A-G,
        frame_s); replayed unless ``eager``."""
        with compiled.disabled() if eager else contextlib.nullcontext():
            torch.cuda.synchronize()
            ic.reset_launch_counts()
            t_f = time.perf_counter()
            hdr, cnt = rr.render(progress=False)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t_f
        st = rr.stats
        return hdr, cnt, (st.total_rays, st.total_isects, st.total_zero_skipped), compiled.launch_counts(), seconds

    t0 = time.perf_counter()
    r, _, _ = terrain_1080p("cuda")  # phase 3's frame on a renderer of its own: the one-device frame
    timed_frame(r)  # captures the frame's programs
    want = timed_frame(r)
    want_eager = timed_frame(r, eager=True)
    assert torch.equal(want_eager[0], want[0]) and want_eager[2] == want[2]
    assert want[3]["A"] > 0 and want[3]["B"] > 0, f"the frame skipped A or B: {want[3]}"
    meshes = {"stand_in": [torch.device("cuda", 0)] * 2}
    if torch.cuda.device_count() > 1:
        meshes["devices"] = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    enumerate_devices = pmesh.available_devices
    sharded_report = {"device_count": torch.cuda.device_count()}
    for case, devices in meshes.items():
        pmesh.available_devices = lambda device, devices=devices: list(devices)  # what Renderer enumerates
        try:
            rm, _, _ = terrain_1080p("cuda", devices=0)
        finally:
            pmesh.available_devices = enumerate_devices
        assert rm.n_shards == len(devices) and len(rm._replicas) == len(set(devices))
        print(f"[sharded:{case}] {len(devices)} shards on {len(set(devices))} distinct device(s): "
              f"{', '.join(map(str, devices))}" + (" (stand-ins: one card, two shards)" if case == "stand_in" else ""),
              flush=True)
        eager = timed_frame(rm, eager=True)
        c0 = rm._programs.capture_s
        first = timed_frame(rm)
        capture_s = rm._programs.capture_s - c0
        replayed = timed_frame(rm)
        for got in (eager, first, replayed):
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), f"{case}: the frame differs"
            # every wavefront is split: each kernel launches once per shard
            assert got[2] == want[2] and got[3] == {k: n * len(devices) for k, n in want[3].items()}, (
                case, got[2:4], want[2:4])
        sharded_report.update({
            f"{case}_shards": len(devices), f"{case}_distinct_devices": len(set(devices)),
            f"{case}_capture_s": f"{capture_s:.4f}", f"{case}_frame_s": f"{replayed[4]:.4f}",
            f"{case}_eager_frame_s": f"{eager[4]:.4f}", f"{case}_programs": len(rm._programs),
            f"{case}_launches": json.dumps({k: replayed[3][k] for k in "AB"}),
        })
        del rm
    # the command line: --devices 0 over the stand-ins writes the PNG of --devices 1
    cli_pngs = {}
    for flag in ("1", "0"):
        png = build_dir / f"terrain256_devices{flag}.png"
        pmesh.available_devices = lambda device: [torch.device("cuda", 0)] * 2
        try:
            _, out = run_cli(["-r", "640", "360", "-s", "1", "-m", "4", "--devices", flag, "-f", str(png),
                              "--device", "cuda", str(terrain_file)])
        finally:
            pmesh.available_devices = enumerate_devices
        assert f"Rendering on {2 if flag == '0' else 1} shard(s) over 1 device(s)" in out, out
        cli_pngs[flag] = png.read_bytes()
    assert cli_pngs["0"] == cli_pngs["1"], "--devices 0 wrote another PNG"
    # the row-sharded lens-design step on the stand-ins against the unsharded one
    stand_in = pmesh.make_mesh(devices=meshes["stand_in"])
    tex = torch.as_tensor(polygon_mask(64, 6), dtype=torch.float32, device="cuda")
    axis = torch.tensor([0.6, 0.55], device="cuda")
    lens0 = reference_prescription(device="cuda")
    img_u = prender.ghost_image_from_lens(lens0, tex, axis, 0.4, 128, 128)
    img_s = prender.ghost_image_from_lens(lens0, tex, axis, 0.4, 128, 128, mesh=stand_in)
    target = img_u * 1.05

    def step_rel(lens_a, lens_b):
        return max(((getattr(lens_a, f) - getattr(lens_b, f)).abs().max()
                    / getattr(lens_b, f).abs().max().clamp_min(1e-30)).item() for f in LENS_FIELDS)

    def train(mesh, n_steps=10):
        """``n_steps`` of make_train_step toward ``target`` -> (lens, losses): a captured Step, eager
        under compiled.disabled()."""
        lens_t, step_t = prender.make_train_step(lens0, tex, axis, 0.4, 128, 128, mesh=mesh)
        assert isinstance(step_t, compiled.Step), "the train step is not captured"
        return lens_t, [step_t(target).item() for _ in range(n_steps)]

    train_numbers = {}
    trained = {}
    for name, mesh_t in (("unsharded", None), ("stand_ins", stand_in)):
        eager_t = step_run(lambda: train(mesh_t), eager=True)
        trained[name] = step_run(lambda: train(mesh_t), eager=False)
        (lens_e, loss_e), (lens_c, loss_c) = eager_t["out"], trained[name]["out"]
        assert loss_c == loss_e and all(torch.equal(getattr(lens_c, f), getattr(lens_e, f)) for f in LENS_FIELDS), (
            f"{name}: the captured train steps differ from the eager ones", loss_c, loss_e)
        train_numbers.update({f"train_{name}_{k}": v for k, v in step_numbers(eager_t, trained[name]).items()})
    (lens_u, losses_u), (lens_s, losses_s) = trained["unsharded"]["out"], trained["stand_ins"]["out"]
    assert max(abs(a - b) / abs(b) for a, b in zip(losses_s, losses_u)) <= 1e-6, (losses_s, losses_u)
    assert step_rel(lens_s, lens_u) <= 1e-6, step_rel(lens_s, lens_u)
    # a one-rank NCCL group: the collectives of render_sharded and the train step run (all_gather, all_reduce)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        nccl_port = sock.getsockname()[1]
    torch.distributed.init_process_group("cpu:gloo,cuda:nccl", init_method=f"tcp://127.0.0.1:{nccl_port}",
                                         world_size=1, rank=0)
    try:
        backend, world = torch.distributed.get_backend(), pmesh.group()[1]
        assert "cuda:nccl" in backend and world == 1, (backend, world)
        tile = r.tile_pixels
        ys_, xs_ = np.mgrid[0:1080, 0:1920]
        order = blocked_order(xs_.ravel(), ys_.ravel(), 1920)[:tile]
        px = torch.as_tensor(xs_.ravel()[order], device="cuda")
        py = torch.as_tensor(ys_.ravel()[order], device="cuda")
        cam, key = camera_params(r.camera, "cuda"), _rng.prng_key(0, device="cuda")
        one = render_wavefront(r.bundle, r.settings, cam, px, py, 1920, 1080, key)
        two = prender.render_sharded(r.bundle, r.settings, cam, px, py, 1920, 1080, key, mesh=stand_in)
        assert all(torch.equal(a, b) for a, b in zip(one, two)), "render_sharded under NCCL differs"
        # under the group the sharded step all-reduces its gradients, and runs eagerly (by design)
        lens_g, step_g = prender.make_train_step(lens0, tex, axis, 0.4, 128, 128, mesh=stand_in)
        lens_1, step_1 = prender.make_train_step(lens0, tex, axis, 0.4, 128, 128)
        assert not isinstance(step_g, compiled.Step) and isinstance(step_1, compiled.Step)
        loss_g, loss_1 = step_g(target), step_1(target)
        assert torch.isfinite(loss_g) and abs(loss_g.item() - loss_1.item()) <= 1e-6 * abs(loss_1.item())
        assert step_rel(lens_g, lens_1) <= 1e-6
        # the Renderer under the group: its shards' lanes gathered through the group's collectives too
        pmesh.available_devices = lambda device: list(meshes["stand_in"])
        try:
            rg, _, _ = terrain_1080p("cuda", devices=0)
        finally:
            pmesh.available_devices = enumerate_devices
        timed_frame(rg)  # captures
        got = timed_frame(rg)
        assert rg.n_shards == 2 and torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), "Renderer under NCCL"
        assert got[2] == want[2], (got[2], want[2])
        nccl_frame_s = got[4]
        del rg
    finally:
        torch.distributed.destroy_process_group()
    phase("sharded", t0, tris=r.scene.num_triangles, width=1920, height=1080, spp=1, depth=4,
          one_device_frame_s=f"{want[4]:.4f}", one_device_eager_frame_s=f"{want_eager[4]:.4f}",
          **sharded_report, cli_devices0_png_equal=True,
          ghost_image_bit_equal=torch.equal(img_u, img_s), train_steps=10, train_step_max_rel=f"{step_rel(lens_s, lens_u):.3g}",
          train_captured_vs_eager="bit_equal", **train_numbers,
          nccl_world=world, nccl_backend=json.dumps(backend), nccl_lanes=tile, nccl_render_bit_equal=True, nccl_loss=f"{loss_g.item():.6g}",
          nccl_renderer_frame_s=f"{nccl_frame_s:.4f}")

    # -- 24. turntable: terrain 512's file orbited in 8 frames at 1920x1080, the last rendered again with -c
    import re

    from lens_flare_tpu_torch import turntable

    t0 = time.perf_counter()
    t512_file = terrain_dae(512).write(build_dir / "terrain512.dae")
    turn_dir = build_dir / "turntable"
    for old in [*turn_dir.glob("*.png"), *turn_dir.glob("frames/*.txt")]:
        old.unlink()
    n_frames = 8
    buf = io.StringIO()
    ic.reset_launch_counts()
    t_turn = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        assert turntable.main([str(t512_file), "--frames", str(n_frames), "--out", str(turn_dir), "--size", "1920",
                               "1080", "-s", "1", "-m", "4", "--device", "cuda"]) == 0
    turn_s = time.perf_counter() - t_turn
    turn_launches = compiled.launch_counts()
    rows = re.findall(r"\[Turntable\] frame (\d+)/\d+: ([0-9.]+) sec, (\d+) programs, capture ([0-9.]+) sec",
                      buf.getvalue())
    assert len(rows) == n_frames, buf.getvalue()
    frame_secs = [float(r[1]) for r in rows]
    programs_after = [int(r[2]) for r in rows]
    capture_after = [float(r[3]) for r in rows]
    # the camera is a program input: frame 0 captures, every later frame replays
    assert programs_after[0] == programs_after[1] == programs_after[-1] > 0, programs_after
    assert capture_after[0] == capture_after[-1] > 0, capture_after
    assert turn_launches["A"] > 0 and turn_launches["B"] > 0, f"the turntable skipped A or B: {turn_launches}"
    pngs = sorted(turn_dir.glob("frame_*.png"))
    dumps = sorted((turn_dir / "frames").glob("frame_*.txt"))
    assert [p.name for p in pngs] == [f"frame_{i:03d}.png" for i in range(n_frames)], pngs
    assert sorted(p.name for p in dumps) == sorted(f"frame_{i}.txt" for i in range(1, n_frames + 1)), dumps
    frames_px = [load_png(p) for p in (pngs[0], pngs[-1])]
    assert all(f.shape == (1080, 1920, 3) and f.max() > 0 for f in frames_px)
    assert not np.array_equal(*frames_px), "the camera did not orbit"
    again_png = build_dir / "turntable_again.png"
    again_s, _ = run_cli(["-c", str(turn_dir / "frames" / f"frame_{n_frames}.txt"), "-r", "1920", "1080", "-s", "1",
                          "-m", "4", "-f", str(again_png), "--device", "cuda", str(t512_file)])
    assert np.array_equal(load_png(again_png), frames_px[-1]), "the last frame rendered again with -c differs"
    phase("turntable", t0, tris=524288, width=1920, height=1080, spp=1, depth=4, frames=n_frames,
          frame0_s=f"{frame_secs[0]:.4f}", frame_s=f"{sum(frame_secs[1:]) / (n_frames - 1):.4f}",
          frame_s_max=f"{max(frame_secs[1:]):.4f}", turntable_s=f"{turn_s:.4f}",
          programs_after_frame0=programs_after[0], programs_after_frame1=programs_after[1],
          programs_after_last=programs_after[-1], capture_s=f"{capture_after[-1]:.4f}",
          pngs=len(pngs), dumped_files=len(dumps), launches=json.dumps(turn_launches),
          again_with_c=f"frames/frame_{n_frames}.txt", again_cli_s=f"{again_s:.4f}", again_png_bit_equal=True)

    # -- 25. results -------------------------------------------------------
    # each kernel's launches from the main path that runs it; B's rows on
    # terrain 256 count config2_frame's launches, where that tree is traced
    count = {"A": launches["A"], "B": launches["B"], "C": small_launches["C"], "D": c2_launches["D"],
             "E": bench_launches["E"], "F": bench_launches["F"]}
    count.update({label: c2_launches["B"] for label in ("B_t256", "B_blocked_t256")})
    count["A_single"] = small_launches["A"]  # the small frame's closest hits
    count["C_t450_spheres"] = 0  # no path traces this scene: only phase 2's checks launch C on it
    # G's main path is the scene past capacity (phase 11); phase 10 forces it on terrain 512
    count.update({label: pc_launches["G"] for label in G_CASES})
    count.update({"H": launches["H"], "H_u40": rl_launches["H"]})  # terrain_1080p's, realistic_1080p's
    kernels = [
        {
            "name": ic.KERNELS[label[0]].name, "case": case, "route": "cuda", "source": ic.KERNELS[label[0]].source,
            "replaces": ic.KERNELS[label[0]].replaces, "launches": count.get(label, count[label[0]]),
            "max_abs_err": errs[label[0]], "ms": times[label][0], "plain_ms": times[label][1],
            "bound_ms": bounds[label][0], "bound_by": bounds[label][1],
            # no single PyTorch call computes a cluster-tree traversal, nor threefry
            "library_ms": None,
        }
        for label, case in {**LINE_CASES, **G_CASES,
                            **{label: f"tape_{LANES}x{u}" for label, u in RNG_TAPES.items()}}.items()
    ]
    # kernel I's rows: each cell's launches from its main path here (the orbit's from terrain_1080p, config
    # 2's from config2_frame, the viewer's from viewer_frame, the Cornell cell's from cornell_cell), the errors
    # bench_vertex measured
    i_launches = {"terrain_orbit_1080p": launches["I"], "config2_adaptive_1080p": c2_launches["I"],
                  "terrain_viewer_800x600": viewer_launches["I"], "cornell_256_16spp": cc_launches["I"]}
    kernels += [
        {
            "name": ic.KERNELS["I"].name, "case": f"{r['cell']}_vertex{r['vertex']}", "route": "cuda",
            "source": ic.KERNELS["I"].source, "replaces": ic.KERNELS["I"].replaces,
            "launches": i_launches[r["cell"]], "max_abs_err": r["max_abs_err"], "ms": r["ia_ms"] + r["ib_ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
        }
        for r in vertex_rows
    ]
    print(bk.nvidia_smi(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
