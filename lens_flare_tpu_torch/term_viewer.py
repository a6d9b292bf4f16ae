"""Terminal front-end for :mod:`lens_flare_tpu_torch.app` (ANSI truecolor).

Counterpart of ``lens_flare_tpu/term_viewer.py``, a copy of its NumPy and
standard-library code, in place of the reference's GLFW window
(``CGL/src/viewer.cpp``): the Application's framebuffer drawn as truecolor
half-blocks (two image rows per terminal row), raw keys (the bindings of
``Application::keyboard_event``) and xterm SGR mouse events (left-drag
orbit, right-drag pan, wheel dolly, right-click autofocus: the
``application.cpp:545-631`` surface) read straight from the tty.  Works
over any ssh session.  ``python -m lens_flare_tpu_torch.cli --view`` drives
it with the command line's whole flag surface.
"""

from __future__ import annotations

import os
import select
import sys
import time

import numpy as np


def frame_to_ansi(frame: np.ndarray, cols: int, rows: int) -> str:
    """(H, W, 3) float [0,1] -> truecolor half-block string (2 px per row).

    The film is bottom-up (utils/image.py:save_hdr_png); flip so the
    terminal shows the image right-side-up, like the reference's GL window
    (whose glDrawPixels consumes the bottom-up buffer natively).
    """
    frame = frame[::-1]
    h, w = frame.shape[:2]
    # nearest resample to (2*rows, cols)
    yi = (np.linspace(0, h - 1e-3, 2 * rows)).astype(int)
    xi = (np.linspace(0, w - 1e-3, cols)).astype(int)
    img = (np.clip(frame[yi][:, xi], 0.0, 1.0) * 255).astype(np.uint8)
    out = []
    for r in range(rows):
        top, bot = img[2 * r], img[2 * r + 1]
        line = []
        for c in range(cols):
            tr, tg, tb = top[c]
            br, bg, bb = bot[c]
            line.append(f"\x1b[38;2;{tr};{tg};{tb}m\x1b[48;2;{br};{bg};{bb}m▀")
        out.append("".join(line) + "\x1b[0m")
    return "\n".join(out)


class TerminalIO:
    """Raw-mode tty with SGR mouse reporting; parses keys + mouse events."""

    def __init__(self):
        import termios

        self.fd = sys.stdin.fileno()
        self.saved = termios.tcgetattr(self.fd)

    def __enter__(self):
        import tty

        tty.setcbreak(self.fd)
        sys.stdout.write("\x1b[?1002h\x1b[?1006h\x1b[?25l")  # mouse drag + SGR, hide cursor
        sys.stdout.flush()
        return self

    def __exit__(self, *exc):
        import termios

        sys.stdout.write("\x1b[?1002l\x1b[?1006l\x1b[?25h\x1b[0m\n")
        sys.stdout.flush()
        termios.tcsetattr(self.fd, termios.TCSADRAIN, self.saved)

    def events(self, timeout=0.0):
        """Yield ('key', ch) | ('mouse', kind, btn, x, y) parsed from stdin."""
        if not select.select([self.fd], [], [], timeout)[0]:
            return
        data = os.read(self.fd, 1024).decode("utf-8", "replace")
        i = 0
        while i < len(data):
            ch = data[i]
            if ch == "\x1b" and data[i : i + 2] == "\x1b[":
                seq = data[i + 2 :]
                if seq[:1] == "<":  # SGR mouse: \x1b[<b;x;y(M|m)
                    j = 0
                    while j < len(seq) and seq[j] not in "Mm":
                        j += 1
                    body, kind = seq[1:j], seq[j : j + 1]
                    i += 3 + j
                    try:
                        b, x, y = (int(v) for v in body.split(";"))
                    except ValueError:
                        continue
                    press = kind == "M"
                    if b & 64:  # wheel
                        yield ("mouse", "wheel", 1 if (b & 1) == 0 else -1, x, y)
                    elif b & 32:  # drag
                        yield ("mouse", "drag", b & 3, x, y)
                    else:
                        yield ("mouse", "press" if press else "release", b & 3, x, y)
                    continue
                arrow = {"A": "UP", "B": "DOWN", "C": "RIGHT", "D": "LEFT"}.get(seq[:1])
                if arrow:
                    yield ("key", arrow)
                    i += 3
                    continue
                i += 2
                continue
            yield ("key", ch)
            i += 1


def run_viewer(app) -> int:
    """Interactive loop: drive ``app`` from the tty until 'q'/ctrl-C."""
    from .app import LEFT, MIDDLE, RIGHT, Mode

    cols, rows = os.get_terminal_size()
    rows = max(rows - 2, 4)
    btn_map = {0: LEFT, 1: MIDDLE, 2: RIGHT}

    def term_to_px(x, y):
        # terminal cell -> top-down screen coords, like raw GLFW cursor
        # positions; the Application applies the reference's screenH - y
        # flip where film (bottom-up) coordinates are needed
        # (application.cpp:556,566,587)
        return (x - 1) * app.screen_w / cols, (y - 1) * app.screen_h / rows

    with TerminalIO() as io:
        dirty = True
        while True:
            for ev in io.events(timeout=0.02):
                if ev[0] == "key":
                    if ev[1] in ("q", "\x03", "\x04"):
                        return 0
                    app.keyboard_event(ev[1])
                    dirty = True
                else:
                    _, kind, b, x, y = ev
                    px, py = term_to_px(x, y)
                    if kind == "press":
                        app.mouse_pressed(btn_map.get(b, LEFT), px, py)
                    elif kind == "release":
                        app.mouse_released(btn_map.get(b, LEFT))
                    elif kind == "drag":
                        app.cursor_event(px, py)
                    elif kind == "wheel":
                        app.scroll_event(float(b))
                    dirty = True
            progressive = app.mode == Mode.RENDER and not app.render_done
            if dirty or progressive:
                t0 = time.perf_counter()
                frame = app.frame()
                dt = time.perf_counter() - t0
                sys.stdout.write("\x1b[H" + frame_to_ansi(frame, cols, rows) + "\n")
                sys.stdout.write(
                    "\x1b[K" + app.info() + f"  {1.0 / max(dt, 1e-6):.1f} fps  (q quits)"
                )
                sys.stdout.flush()
                dirty = False
