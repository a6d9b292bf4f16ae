"""Interactive application: mode state machine, keybindings, progressive preview.

Counterpart of ``lens_flare_tpu/app.py``, the reference's GLFW
``Application`` and CGL ``Viewer`` (``src/application/application.cpp:
150-166, 428-631``; ``CGL/src/viewer.cpp:138-174``) as a state machine
that produces framebuffers on demand, with the same modes, keys, mouse
surface and HUD line:

- **EDIT**: a normal-shaded preview of the scene (the integrator's
  ``normal_shading`` view, ``pathtracer.h:77-83``) at ``preview_width``,
  orbit/pan/dolly camera, and the mesh-edit keys u/d/i/f/s/c
  (``scene/halfedge.py``), each of which rebuilds the scene;
- **VISUALIZE**: the BVH visualizer (``raytraced_renderer.cpp:403-494``),
  box wireframes over the dimmed preview, arrow keys walk the tree, 'a'
  toggles the logged rays;
- **RENDER**: progressive path tracing, ``progressive_batch`` samples per
  ``frame()`` until ``ns_aa``, sample for sample the offline render's (the
  RNG is a function of pixel id and sample index).

Where the JAX package jits the preview (``app.py:57``) and the sample batch
(``:76``), the port runs both through the renderer's captured programs
(``compiled.py``) on a CUDA device: the preview is one program per preview
size, and a RENDER frame replays, per tile of its cell, the pixel-keys
program and the one-sample program of ``Renderer._sampler`` that offline
renders replay (``Renderer.render_chunk``, sharded as the offline render
over a renderer's ``devices``; the preview runs on its first device, as
in the JAX package).  The camera is an input of every program, so an orbit
between frames replays; the renderer drops its programs when its scene is
rebuilt (a mesh edit) or its settings change (a key such as ``]``).  On
the CPU, and under ``compiled.disabled()``, the same code runs eagerly.
The film and counts stay on the device; ``frame()`` returns a host
(H, W, 3) array for the front end (``term_viewer.py``).  Front-end
agnostic and drivable headless (``tests/test_torch_app.py``).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from enum import Enum

import numpy as np
import torch

from . import _rng
from .integrator.path import trace_closest
from .renderer import Renderer, pad_lanes
from .scene.camera import CameraParams, camera_params, generate_rays
from .utils.profiling import span


class Mode(Enum):
    EDIT = 0
    VISUALIZE = 1
    RENDER = 2


class _EditRejected(Exception):
    """A mesh-edit operation's manifoldness guard declined the edit."""


# key codes for special keys (GLFW arrow keys in the reference)
KEY_UP, KEY_DOWN, KEY_LEFT, KEY_RIGHT = "UP", "DOWN", "LEFT", "RIGHT"
LEFT, RIGHT, MIDDLE = 0, 1, 2


def preview_shade(bundle, cam: CameraParams, x, y):
    """Normal-shaded debug view (normal_shading, pathtracer.h:77-83); (colour, t, hit) per lane."""
    o, d = generate_rays(cam, x, y)
    n = x.shape[0]
    hit, _ = trace_closest(
        bundle, o.contiguous(), d.contiguous(), cam.n_clip.expand(n).contiguous(), cam.f_clip.expand(n).contiguous()
    )
    # headlight-modulated normal colour: shape readable from any angle
    ndv = torch.abs(hit.n[:, 0] * d[:, 0] + hit.n[:, 1] * d[:, 1] + hit.n[:, 2] * d[:, 2])[:, None]
    col = (hit.n * 0.5 + 0.5) * (0.35 + 0.65 * ndv)
    return torch.where(hit.hit[:, None], col, 0.05), hit.t, hit.hit


@dataclass
class Application:
    """Mode state machine + event surface (application.cpp parity)."""

    renderer: Renderer
    filename: str = "screenshot"
    preview_width: int = 256
    progressive_batch: int = 1  # samples added per frame() in RENDER mode

    mode: Mode = Mode.EDIT
    log: list = field(default_factory=list)

    # visualize state (raytraced_renderer.h selectionHistory + show_rays)
    selection_history: list = field(default_factory=lambda: [0])
    show_rays: bool = False
    logged_rays: np.ndarray | None = None  # (R, 7): o, dir, t (0 on a miss)

    # render-mode state
    render_cell: bool = False
    cell_tl: tuple = (0, 0)
    cell_br: tuple = (0, 0)

    # mouse state
    mouse_x: float = 0.0
    mouse_y: float = 0.0
    left_down: bool = False
    right_down: bool = False
    middle_down: bool = False

    def __post_init__(self):
        cam = self.renderer.camera
        scene = self.renderer.scene
        extent = float(np.linalg.norm(scene.bbox_max - scene.bbox_min))
        # canonical placement for space-bar reset (application.cpp:282-320)
        self.canonical_view_distance = extent / 2 * 1.5
        self.scroll_rate = self.canonical_view_distance / 10
        self._canonical = (
            np.array(cam.target_pos),
            cam.phi,
            cam.theta,
            cam.r,
            cam.min_r,
            cam.max_r,
        )
        self._bvh = None
        self._film = None  # (H, W, 3) float32 on the renderer's device
        self._counts = None  # (H, W) int32 on the renderer's device
        self._sample_idx = 0
        self._preview_cache = None
        self._lanes = {}  # "preview" and "cell": (size or cell, x, y), the current one of each only
        self.screen_w = self.renderer.width
        self.screen_h = self.renderer.height

    @property
    def _device(self) -> torch.device:
        return torch.device(self.renderer.device)

    # ------------------------------------------------------------------
    # info / messages

    def _msg(self, text):
        self.log.append(text)
        print(text)

    def info(self) -> str:
        """HUD line (Application::info + renderer state)."""
        r = self.renderer
        return (
            f"[{self.mode.name}] spp={r.ns_aa} light={r.ns_area_light} "
            f"depth={r.max_ray_depth} lens_r={r.camera.lens_radius:.2f} "
            f"focal_d={r.camera.focal_distance:.2f}"
            + (" [cell]" if self.render_cell else "")
        )

    # ------------------------------------------------------------------
    # keyboard (application.cpp:428-543 + raytraced_renderer.cpp:537-616)

    def keyboard_event(self, key: str) -> None:
        if self.mode == Mode.RENDER:
            if key in ("e", "E"):
                self.to_edit_mode()
            elif key in ("v", "V"):
                self.start_visualizing()
            elif key in ("s", "S"):
                self.save_image()
            elif key in list("[]+=-_.>,<hHkKlL;'"):
                self._renderer_key_press(key)
                self.start_raytracing()
            elif key == "C":
                self._renderer_key_press(key)
            elif key in ("r", "R"):
                self.start_raytracing()
            elif key in ("d", "D"):
                path = f"{self.filename}_cam_settings.txt"
                self.renderer.camera.dump_settings(path)
                self._msg(f"[Camera] dumped settings to {path}")
        elif self.mode == Mode.VISUALIZE:
            if key in ("e", "E"):
                self.to_edit_mode()
            elif key in ("r", "R"):
                self.start_raytracing()
                self.mode = Mode.RENDER
            elif key in ("q", "Q"):  # keyboard orbit (application.cpp:484-490)
                self._orbit(1.0, 0.0)
            elif key in ("w", "W"):
                self._orbit(-1.0, 0.0)
            elif key == " ":
                self.reset_camera()
            else:
                self._renderer_key_press(key)
        elif self.mode == Mode.EDIT:
            if key in ("r", "R"):
                self.start_raytracing()
                self.mode = Mode.RENDER
            elif key in ("v", "V"):
                self.start_visualizing()
            elif key == " ":
                self.reset_camera()
            # mesh-edit keys (application.cpp:515-536): u/d/i resample the
            # selected mesh, f/s/c apply a local operation to its selected edge
            elif key in ("u", "U"):
                self._edit_mesh(lambda m: m.upsample(), "upsampled")
            elif key in ("d", "D"):
                self._edit_mesh(lambda m: m.downsample(), "downsampled")
            elif key in ("i", "I"):
                self._edit_mesh(lambda m: m.resample(), "resampled")
            elif key in ("f", "F"):
                self._edit_selected_edge("flip_edge", "flipped edge")
            elif key in ("s", "S"):
                self._edit_selected_edge("split_edge", "split edge")
            elif key in ("c", "C"):
                self._edit_selected_edge("collapse_edge", "collapsed edge")

    def _renderer_key_press(self, key: str) -> None:
        """RaytracedRenderer::key_press (raytraced_renderer.cpp:537-616)."""
        r = self.renderer
        if key == "]":
            r.ns_aa *= 2
            self._msg(f"[PathTracer] Samples per pixel changed to {r.ns_aa}")
        elif key == "[":
            r.ns_aa = max(r.ns_aa // 2, 1)
            self._msg(f"[PathTracer] Samples per pixel changed to {r.ns_aa}")
        elif key in ("=", "+"):
            r.ns_area_light *= 2
            self._msg(f"[PathTracer] Area light sample count increased to {r.ns_area_light}.")
        elif key in ("-", "_"):
            if r.ns_area_light > 1:
                r.ns_area_light //= 2
            self._msg(f"[PathTracer] Area light sample count decreased to {r.ns_area_light}.")
        elif key in (".", ">"):
            r.max_ray_depth += 1
            self._msg(f"[PathTracer] Max ray depth increased to {r.max_ray_depth}.")
        elif key in (",", "<"):
            if r.max_ray_depth:
                r.max_ray_depth -= 1
            self._msg(f"[PathTracer] Max ray depth decreased to {r.max_ray_depth}.")
        elif key in ("h", "H"):
            r.direct_hemisphere_sample = not r.direct_hemisphere_sample
            self._msg(
                "[PathTracer] Toggled direct lighting to "
                + ("uniform hemisphere sampling" if r.direct_hemisphere_sample else "importance light sampling")
            )
        elif key in ("k", "K"):
            r.camera.lens_radius = max(r.camera.lens_radius - 0.05, 0.0)
            r.lens_radius = r.camera.lens_radius
            self._msg(f"[PathTracer] Camera lens radius reduced to {r.camera.lens_radius:f}.")
        elif key in ("l", "L"):
            r.camera.lens_radius = r.camera.lens_radius + 0.05
            r.lens_radius = r.camera.lens_radius
            self._msg(f"[PathTracer] Camera lens radius increased to {r.camera.lens_radius:f}.")
        elif key == ";":
            r.camera.focal_distance = max(r.camera.focal_distance - 0.1, 0.0)
            r.focal_distance = r.camera.focal_distance
            self._msg(f"[PathTracer] Camera focal distance reduced to {r.camera.focal_distance:f}.")
        elif key == "'":
            r.camera.focal_distance = r.camera.focal_distance + 0.1
            r.focal_distance = r.camera.focal_distance
            self._msg(f"[PathTracer] Camera focal distance increased to {r.camera.focal_distance:f}.")
        elif key == KEY_UP:
            if len(self.selection_history) > 1:
                self.selection_history.pop()
        elif key == KEY_LEFT:
            node = self.selection_history[-1]
            if self._host_bvh().node_left[node] >= 0:
                self.selection_history.append(int(self._host_bvh().node_left[node]))
        elif key == KEY_RIGHT:
            # reference quirk preserved: guarded on the LEFT child existing
            node = self.selection_history[-1]
            if self._host_bvh().node_left[node] >= 0:
                self.selection_history.append(int(self._host_bvh().node_right[node]))
        elif key == "C":
            self.render_cell = not self.render_cell
            self._msg(
                "[PathTracer] Now in cell render mode."
                if self.render_cell
                else "[PathTracer] No longer in cell render mode."
            )
        elif key in ("a", "A"):
            self.show_rays = not self.show_rays

    # ------------------------------------------------------------------
    # mouse (application.cpp:545-631)

    def mouse_pressed(self, button: int, x: float = None, y: float = None) -> None:
        if x is not None:
            self.mouse_x, self.mouse_y = x, y
        if button == LEFT:
            if self.mode == Mode.RENDER and self.render_cell:
                # screen (top-down cursor) -> film (bottom-up) coords: the
                # reference's screenH - y flip (application.cpp:556)
                self.cell_tl = (self.mouse_x, self.screen_h - self.mouse_y)
                self.cell_br = self.cell_tl
            self.left_down = True
        elif button == RIGHT:
            self.right_down = True
        elif button == MIDDLE:
            self.middle_down = True

    def mouse_released(self, button: int) -> None:
        if button == LEFT:
            self.left_down = False
            if self.mode == Mode.RENDER and self.render_cell:
                tl = (
                    max(0.0, min(self.cell_tl[0], self.cell_br[0])),
                    max(0.0, min(self.cell_tl[1], self.cell_br[1])),
                )
                br = (
                    min(float(self.screen_w), max(self.cell_tl[0], self.cell_br[0])),
                    min(float(self.screen_h), max(self.cell_tl[1], self.cell_br[1])),
                )
                self.cell_tl, self.cell_br = tl, br
                self._msg(
                    f"[PathTracer] Selected cell measures "
                    f"{int(br[0] - tl[0])}x{int(br[1] - tl[1])} pixels"
                )
                self.start_raytracing()
        elif button == RIGHT:
            if self.mode == Mode.RENDER:
                # screenH - y: screen -> film rows (application.cpp:587)
                self.autofocus(self.mouse_x, self.screen_h - self.mouse_y)
                self.start_raytracing()
            self.right_down = False
        elif button == MIDDLE:
            self.middle_down = False

    def cursor_event(self, x: float, y: float) -> None:
        if self.left_down and not self.middle_down and not self.right_down:
            self._mouse1_dragged(x, y)
        elif self.right_down and not self.left_down and not self.middle_down:
            self._mouse2_dragged(x, y)
        self.mouse_x, self.mouse_y = x, y

    def _mouse1_dragged(self, x, y):
        if self.mode == Mode.RENDER:
            # screenH - y: screen -> film rows (application.cpp:606)
            self.cell_br = (x, self.screen_h - y)
            return
        dx = x - self.mouse_x
        dy = y - self.mouse_y
        self.renderer.camera.rotate_by(
            -dy * (math.pi / self.screen_h), -dx * (math.pi / self.screen_w)
        )
        self._preview_cache = None

    def _mouse2_dragged(self, x, y):
        if self.mode == Mode.RENDER:
            return
        dx = x - self.mouse_x
        dy = y - self.mouse_y
        self.renderer.camera.move_by(-dx, dy, self.canonical_view_distance)
        self._preview_cache = None

    def _orbit(self, dx, dy):
        self.renderer.camera.rotate_by(
            -dy * (math.pi / self.screen_h), -dx * (math.pi / self.screen_w)
        )
        self._preview_cache = None

    def scroll_event(self, offset_y: float) -> None:
        if self.mode in (Mode.EDIT, Mode.VISUALIZE):
            self.renderer.camera.move_forward(-offset_y * self.scroll_rate)
            self._preview_cache = None

    def reset_camera(self) -> None:
        self.renderer.camera.place(*self._canonical)
        self._preview_cache = None

    # ------------------------------------------------------------------
    # mode transitions

    def to_edit_mode(self) -> None:
        self.mode = Mode.EDIT
        self._preview_cache = None

    def start_visualizing(self) -> None:
        self.mode = Mode.VISUALIZE

    def start_raytracing(self) -> None:
        """Reset progressive accumulation (renderer->stop(); start_raytracing())."""
        self.mode = Mode.RENDER
        r = self.renderer
        # settings knobs may have changed through key_press: rebuild the
        # RenderSettings (lens radius flows through camera params)
        r.ns_aa = max(r.ns_aa, 1)
        r.update_settings()
        self._film = torch.zeros((r.height, r.width, 3), device=self._device)
        self._counts = torch.zeros((r.height, r.width), dtype=torch.int32, device=self._device)
        self._sample_idx = 0

    def autofocus(self, x: float, y: float) -> float:
        d = self.renderer.autofocus(x, y)
        self._msg(f"[PathTracer] Autofocus: focal distance set to {d:f}")
        return d

    # ------------------------------------------------------------------
    # framebuffer production

    def frame(self) -> np.ndarray:
        """Current framebuffer (H, W, 3) float in [0, 1] (gamma-corrected), on the host.

        In RENDER mode each call also advances the progressive render by
        ``progressive_batch`` samples (until ns_aa is reached).
        """
        if self.mode == Mode.EDIT:
            return self._edit_frame()
        if self.mode == Mode.VISUALIZE:
            return self._visualize_frame()
        return self._render_frame()

    # -- EDIT: mesh-edit operations (application.cpp:515-536) -----------
    #
    # The reference edits the mesh under the mouse-selected element; this
    # headless application keeps an explicit selection instead:
    # ``selected_mesh`` (index into the scene's contiguous same-BSDF
    # triangle runs, one run per mesh) and ``selected_edge`` (edge id on the
    # welded halfedge mesh, settable by tests and tools; 0 like a fresh
    # click).  As in the JAX package, the edge ids are those of a mesh welded
    # anew on every key press, so successive f/s/c keys need not act on the
    # same region (ROADMAP Queue 3, ``app.py:489``).

    selected_mesh: int = 0
    selected_edge: int = 0

    def _mesh_ranges(self):
        b = np.asarray(self.renderer.scene.tri_bsdf)
        if len(b) == 0:
            return []
        cuts = np.flatnonzero(np.diff(b)) + 1
        starts = np.concatenate([[0], cuts])
        ends = np.concatenate([cuts, [len(b)]])
        return list(zip(starts, ends))

    def _edit_mesh(self, op, what):
        """Apply ``op(HalfedgeMesh)`` to the selected mesh and rebuild the scene (and its trees)."""
        from .scene.build import vertex_normals
        from .scene.halfedge import HalfedgeMesh, weld

        ranges = self._mesh_ranges()
        if not ranges:
            self._msg("[MeshEdit] no mesh to edit")
            return
        lo, hi = ranges[self.selected_mesh % len(ranges)]
        scene = self.renderer.scene
        pos, faces = weld(np.asarray(scene.tri_p[lo:hi], np.float64))
        try:
            mesh = HalfedgeMesh(pos, faces)
            op(mesh)
        except _EditRejected:
            raise
        except (ValueError, AssertionError, KeyError, IndexError, StopIteration):
            # non-manifold soup (duplicated/inverted faces) can't build a
            # halfedge structure or survive the op; a keypress must not
            # crash the viewer
            self._msg(f"[MeshEdit] {what}: rejected (non-manifold input)")
            return
        pos2, faces2 = mesh.to_arrays()
        if len(faces2) == 0:
            self._msg(f"[MeshEdit] {what}: would empty the mesh; ignored")
            return
        n2 = vertex_normals(pos2, faces2)
        bsdf_id = int(scene.tri_bsdf[lo])
        tri_p = np.concatenate([
            scene.tri_p[:lo], pos2[faces2].astype(np.float32), scene.tri_p[hi:]])
        tri_n = np.concatenate([
            scene.tri_n[:lo], n2[faces2].astype(np.float32), scene.tri_n[hi:]])
        tri_b = np.concatenate([
            scene.tri_bsdf[:lo],
            np.full(len(faces2), bsdf_id, np.int32),
            scene.tri_bsdf[hi:]])
        scene2 = dataclasses.replace(scene, tri_p=tri_p, tri_n=tri_n, tri_bsdf=tri_b)
        plo, phi = scene2.primitive_bboxes()
        if len(plo):
            scene2.bbox_min = plo.min(axis=0).astype(np.float64)
            scene2.bbox_max = phi.max(axis=0).astype(np.float64)
        # a new bundle and trees: the renderer drops every program captured on the old ones
        self.renderer.load_flat_scene(scene2, camera=self.renderer.camera)
        self._preview_cache = None
        self._bvh = None
        self._lanes.clear()
        self.selection_history = [0]
        self._msg(f"[MeshEdit] {what}: mesh {self.selected_mesh} -> "
                  f"{len(faces2)} tris ({len(tri_b)} total)")

    def _edit_selected_edge(self, op_name, what):
        def op(mesh):
            n_edges = len(mesh.e_alive)
            e = self.selected_edge % max(n_edges, 1)
            if not mesh.e_alive[e]:
                e = next(i for i in range(n_edges) if mesh.e_alive[i])
            if getattr(mesh, op_name)(e) is None:
                raise _EditRejected
        try:
            self._edit_mesh(op, what)
        except _EditRejected:
            self._msg(f"[MeshEdit] {what}: rejected "
                      "(boundary or manifoldness guard)")

    # -- EDIT ----------------------------------------------------------

    def _preview_res(self):
        pw = min(self.preview_width, self.screen_w)
        ph = max(1, int(round(pw * self.screen_h / self.screen_w)))
        return pw, ph

    def _held_lanes(self, kind, key, make):
        """Device lanes ``make()`` gives for ``key``, kept until ``kind``'s key changes."""
        held = self._lanes.get(kind)
        if held is None or held[0] != key:
            held = self._lanes[kind] = (key, *(torch.as_tensor(v, device=self._device) for v in make()))
        return held[1:]

    def _preview_lanes(self, pw, ph):
        """Sensor coordinates of the preview's pixel centres, on the device."""
        def make():
            ys, xs = np.mgrid[0:ph, 0:pw]
            return (((v.ravel() + 0.5) / n).astype(np.float32) for v, n in ((xs, pw), (ys, ph)))

        return self._held_lanes("preview", (pw, ph), make)

    def _edit_frame(self) -> np.ndarray:
        if self._preview_cache is not None:
            return self._preview_cache
        r = self.renderer
        pw, ph = self._preview_res()
        x, y = self._preview_lanes(pw, ph)
        cam = camera_params(r.camera, self._device)
        bundle = r.bundle  # the program holds the bundle, not the renderer (compiled.py)
        col, t, hit = r._programs.run(
            ("preview", pw, ph), lambda x, y, *cam: preview_shade(bundle, CameraParams(*cam), x, y), x, y, *cam
        )
        frame = col.cpu().numpy().reshape(ph, pw, 3)
        self._preview_t = t.cpu().numpy().reshape(ph, pw)
        self._preview_hit = hit.cpu().numpy().reshape(ph, pw)
        self._preview_cache = frame
        return frame

    # -- VISUALIZE ------------------------------------------------------

    def _host_bvh(self):
        if self._bvh is None:
            from .accel.bvh import build_bvh

            lo, hi = self.renderer.scene.primitive_bboxes()
            self._bvh = build_bvh(lo, hi)  # SAH, as the renderer's tree
        return self._bvh

    def log_ray(self, o, d, t, hit) -> None:
        """Record a debug ray for the visualizer (LoggedRay, ray.h:74-82)."""
        row = np.array([*o, *d, t if hit else 0.0], np.float32)
        rows = np.atleast_2d(row)
        self.logged_rays = (
            rows if self.logged_rays is None else np.vstack([self.logged_rays, rows])
        )

    def _visualize_frame(self) -> np.ndarray:
        frame = self._edit_frame() * 0.35  # dimmed scene under the wireframe
        frame = frame.copy()
        bvh = self._host_bvh()
        node = self.selection_history[-1]

        # selected node in white, children in cyan/yellow (visualize_accel)
        self._draw_box(frame, bvh.node_min[node], bvh.node_max[node], (1.0, 1.0, 1.0))
        for child, color in (
            (bvh.node_left[node], (0.2, 0.9, 1.0)),
            (bvh.node_right[node], (1.0, 0.9, 0.2)),
        ):
            if child >= 0:
                self._draw_box(frame, bvh.node_min[child], bvh.node_max[child], color)

        if self.show_rays and self.logged_rays is not None:
            for o_ray in self.logged_rays:
                o, d, t = o_ray[0:3], o_ray[3:6], o_ray[6]
                hit = t > 0
                end = o + d * (t if hit else self.canonical_view_distance * 2)
                self._draw_segment(
                    frame, o, end, (0.2, 1.0, 0.2) if hit else (1.0, 0.2, 0.2)
                )
        return frame

    def _project(self, pts: np.ndarray):
        """World points (N, 3) -> preview pixel coords + in-front mask."""
        cam = self.renderer.camera
        pw, ph = self._preview_res()
        rel = (pts - cam.pos) @ cam.c2w  # camera frame; -z is view dir
        z = -rel[:, 2]
        ok = z > max(cam.n_clip, 1e-6)
        zs = np.where(ok, z, 1.0)
        edge_x = math.tan(0.5 * math.radians(cam.h_fov))
        edge_y = math.tan(0.5 * math.radians(cam.v_fov))
        sx = (rel[:, 0] / zs / edge_x + 1) / 2 * pw
        # film rows grow WITH +camera-y (generate_rays: cy = tanv*(2y-1)),
        # so no flip here: the overlay must match _edit_frame's convention
        sy = (rel[:, 1] / zs / edge_y + 1) / 2 * ph
        return sx, sy, ok

    def _draw_segment(self, frame, p0, p1, color, samples=160):
        ts = np.linspace(0.0, 1.0, samples)
        pts = p0[None, :] * (1 - ts[:, None]) + p1[None, :] * ts[:, None]
        sx, sy, ok = self._project(pts)
        ph, pw = frame.shape[:2]
        xi = sx.astype(int)
        yi = sy.astype(int)
        keep = ok & (xi >= 0) & (xi < pw) & (yi >= 0) & (yi < ph)
        frame[yi[keep], xi[keep]] = color

    def _draw_box(self, frame, mn, mx, color):
        c = [np.array([(mx if i & 1 else mn)[0], (mx if i & 2 else mn)[1], (mx if i & 4 else mn)[2]]) for i in range(8)]
        edges = [
            (0, 1), (2, 3), (4, 5), (6, 7),
            (0, 2), (1, 3), (4, 6), (5, 7),
            (0, 4), (1, 5), (2, 6), (3, 7),
        ]
        for a, b in edges:
            self._draw_segment(frame, c[a], c[b], color)

    # -- RENDER ----------------------------------------------------------

    def _cell_bounds(self):
        if self.render_cell and self.cell_br != self.cell_tl:
            x0 = int(min(self.cell_tl[0], self.cell_br[0]))
            y0 = int(min(self.cell_tl[1], self.cell_br[1]))
            x1 = int(max(self.cell_tl[0], self.cell_br[0]))
            y1 = int(max(self.cell_tl[1], self.cell_br[1]))
            return x0, y0, max(x1 - x0, 1), max(y1 - y0, 1)
        return 0, 0, self.screen_w, self.screen_h

    def _cell_lanes(self, cell):
        """The cell's pixel coordinates in row-major order, on the device."""
        def make():
            x0, y0, dx, dy = cell
            ys, xs = np.mgrid[y0 : y0 + dy, x0 : x0 + dx]
            return xs.ravel(), ys.ravel()

        return self._held_lanes("cell", cell, make)

    @property
    def render_done(self) -> bool:
        return self._film is not None and self._sample_idx >= self.renderer.ns_aa

    def _render_frame(self) -> np.ndarray:
        from .utils import image as img

        if self._film is None:
            self.start_raytracing()
        r = self.renderer
        if not self.render_done:
            with span("renderer.render"):
                ns = min(self.progressive_batch, r.ns_aa - self._sample_idx)
                dev = self._device
                with span("renderer.prepare"):
                    xs, ys = self._cell_lanes(self._cell_bounds())
                    cam = camera_params(r.camera, dev)
                    key = _rng.prng_key(r.seed, device=dev)
                tile = r.tile_pixels
                grain = 4096 if tile > 8192 else 256  # the JAX package's buckets (app.py:627-638)
                for i in range(0, xs.shape[0], tile):
                    with span("renderer.tile"):
                        px, py, valid, m = pad_lanes(xs[i : i + tile], ys[i : i + tile], tile, grain, r.n_shards)
                        film, _, _, _ = r.render_chunk(cam, key, px, py, valid, self._sample_idx, ns)
                        with span("app.scatter"):
                            self._film[py[:m], px[:m]] += film[:m]
                            self._counts[py[:m], px[:m]] += ns
                self._sample_idx += ns
                # log a handful of primary rays for the visualizer ray overlay
                if self.logged_rays is None:
                    self._log_primary_rays()
        with span("app.to_host"):
            hdr = self._hdr().cpu().numpy()
        return img.to_color(hdr)

    def _hdr(self) -> torch.Tensor:
        return self._film / torch.clamp_min(self._counts, 1)[..., None]

    def _log_primary_rays(self, count=24):
        r = self.renderer
        dev = self._device
        cam = camera_params(r.camera, dev)
        rng = np.random.default_rng(0)
        x = torch.as_tensor(rng.uniform(0.2, 0.8, count).astype(np.float32), device=dev)
        y = torch.as_tensor(rng.uniform(0.2, 0.8, count).astype(np.float32), device=dev)
        o, d = generate_rays(cam, x, y)
        hit, _ = trace_closest(
            r.bundle, o.contiguous(), d.contiguous(),
            cam.n_clip.expand(count).contiguous(), cam.f_clip.expand(count).contiguous(),
        )
        o, d, t, h = (v.cpu().numpy() for v in (o, d, hit.t, hit.hit))
        for i in range(count):
            self.log_ray(o[i], d[i], float(t[i]), bool(h[i]))

    # ------------------------------------------------------------------

    def save_image(self) -> str:
        """Save the current RENDER framebuffer with the flare (save_image parity)."""
        from .utils import image as img

        if self._film is None:
            self._render_frame()
        hdr = self.renderer.composite_flare(self._hdr())
        path = f"{self.filename}.png"
        img.save_hdr_png(path, hdr.cpu().numpy(), flip_y=True)  # film is bottom-up
        self._msg(f"[PathTracer] saved to {path}")
        return path
