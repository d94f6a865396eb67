"""Interactive front end: live keyboard camera control around the frame
loop (reference: the GLUT keyboard and mouse state machine,
src/main.cu:303-395, and src/Input.cuh; the GL window becomes an
in-terminal ANSI framebuffer).

Port of ``tpu_raytracing/app/interactive.py`` (``RawTerminal``,
``ansi_preview``, ``interactive_loop``). The reference app is a live GLUT
window: WASD/QE and space fly the camera (src/Camera.cu:31-45), mouse-look
turns it (:47-51), the wheel zooms (:53-60) and 'm' cycles the render mode
(src/main.cu:329-332), with the FPS in the title (:194-213). This front end
keeps those over a raw-mode terminal:

  w/a/s/d/q/e/space  move (one impulse a keypress: a terminal has no key-up
                     events, so "held" becomes "repeated")
  arrow keys         look (mouse-look deltas at a fixed step)
  + / -              zoom in / out (wheel)
  m                  cycle the render mode
  p                  write the current frame to a numbered PNG
  x / ESC            quit

Each frame renders through the same pipeline as the offline loop, on the
app's device, and is shown as 24-bit-colour half blocks (two pixels a
character cell), downsampled to the terminal; the FPS and the camera print
in a status line. Needs a TTY on stdin. Unlike the reference's loop, each
frame is written in full even where the terminal takes a write in parts
(``_write_all``).
"""

from __future__ import annotations

import os
import select
import sys

import numpy as np

from tpu_raytracing_torch.scene import camera as cam
from tpu_raytracing_torch.trace.modes import RenderType
from tpu_raytracing_torch.utils.png import write_png
from tpu_raytracing_torch.utils.timing import FPSCounter


class RawTerminal:
    """cbreak-mode stdin with non-blocking drained reads."""

    def __enter__(self):
        import termios
        import tty

        self.fd = sys.stdin.fileno()
        self.saved = termios.tcgetattr(self.fd)
        tty.setcbreak(self.fd)
        return self

    def __exit__(self, *exc):
        import termios

        termios.tcsetattr(self.fd, termios.TCSADRAIN, self.saved)

    def drain(self) -> list:
        """Every pending key (escape sequences decoded to 'up', 'down', ...)."""
        keys = []
        buf = b""
        while select.select([self.fd], [], [], 0)[0]:
            buf += os.read(self.fd, 64)
        i = 0
        while i < len(buf):
            ch = buf[i:i + 1]
            if ch == b"\x1b" and buf[i + 1:i + 2] == b"[":
                code = buf[i + 2:i + 3]
                keys.append({b"A": "up", b"B": "down", b"C": "right",
                             b"D": "left"}.get(code, "esc"))
                i += 3
            elif ch == b"\x1b":
                keys.append("esc")
                i += 1
            else:
                keys.append(ch.decode("latin1"))
                i += 1
        return keys


def _write_all(text: str) -> None:
    """Write ``text`` to the terminal in full. A frame is ~300 KB of
    escape sequences, and a terminal write may take only part of it: an
    unbuffered stdout (``python -u``) hands the rest of the frame, the
    status line with it, to nobody (the reference's loop loses it so)."""
    sys.stdout.flush()
    data = text.encode(sys.stdout.encoding or "utf-8", "replace")
    fd = sys.stdout.fileno()
    while data:
        data = data[os.write(fd, data):]


def ansi_preview(img: np.ndarray, max_cols: int, max_rows: int) -> str:
    """An RGB(A) uint8 image as 24-bit half-block characters (one character
    = two vertically stacked pixels)."""
    h, w = img.shape[:2]
    cols = max(min(max_cols, w), 1)
    rows2 = max(min(max_rows * 2, h), 2)
    ys = (np.arange(rows2) * (h / rows2)).astype(int)
    xs = (np.arange(cols) * (w / cols)).astype(int)
    small = img[np.ix_(ys, xs)][:, :, :3].astype(int)
    if small.shape[0] % 2:
        small = small[:-1]
    top, bot = small[0::2], small[1::2]
    lines = []
    for r in range(top.shape[0]):
        row = []
        for c in range(cols):
            tr, tg, tb = top[r, c]
            br, bg, bb = bot[r, c]
            row.append(f"\x1b[38;2;{tr};{tg};{tb}m\x1b[48;2;{br};{bg};{bb}m▀")
        lines.append("".join(row) + "\x1b[0m")
    return "\n".join(lines)


def interactive_loop(args, camera, render_one):
    """Drive the frame loop from live key input.

    ``render_one(host camera, mode) -> np.uint8 image [H, W, 4]`` is the
    app's per-frame render (its trees and tracers captured inside).
    """
    if not sys.stdin.isatty():
        raise SystemExit("--interactive needs a TTY on stdin")
    mode = args.render_type
    fps = FPSCounter()
    shot = 0
    look_step = 6.0  # x0.01 rad via update_camera_look_delta
    os.makedirs(args.output, exist_ok=True)
    try:
        size = os.get_terminal_size()
        tcols, trows = size.columns, max(size.lines - 3, 8)
    except OSError:
        tcols, trows = 100, 40
    if tcols <= 0:  # a fresh pty can report a 0x0 window
        tcols = 100

    _write_all("\x1b[2J")  # clear once
    with RawTerminal() as term:
        running = True
        while running:
            moved = set()
            want_shot = False
            for key in term.drain():
                if key in ("x", "esc"):
                    running = False
                elif key == "m":
                    mode = RenderType((int(mode) + 1) % (len(RenderType) - 1))
                elif key in ("w", "a", "s", "d", "q", "e", " "):
                    moved.add(key)
                elif key == "up":
                    camera = cam.update_camera_look_delta(camera, 0.0, -look_step)
                elif key == "down":
                    camera = cam.update_camera_look_delta(camera, 0.0, look_step)
                elif key == "left":
                    camera = cam.update_camera_look_delta(camera, -look_step, 0.0)
                elif key == "right":
                    camera = cam.update_camera_look_delta(camera, look_step, 0.0)
                elif key == "+":
                    camera = cam.update_camera_zoom(camera, 1)
                elif key == "-":
                    camera = cam.update_camera_zoom(camera, -1)
                elif key == "p":
                    want_shot = True
            if moved:
                camera = cam.update_camera_position(camera, moved)
            camera = cam.update_camera(camera)

            img = render_one(camera, mode)
            if want_shot:
                write_png(os.path.join(args.output, f"shot{shot:04d}.png"), img)
                shot += 1

            frame_txt = ansi_preview(img, tcols, trows)
            rate = fps.tick()
            rate_txt = f"{rate:.1f}" if rate is not None else "..."
            status = (f"mode={mode.name}  fps={rate_txt}  "
                      f"pos=({camera.position[0]:.1f},{camera.position[1]:.1f},"
                      f"{camera.position[2]:.1f}) yaw={camera.yaw:.2f} "
                      f"pitch={camera.pitch:.2f}  [wasdqe/space move, arrows "
                      f"look, +/- zoom, m mode, p shot, x quit]")
            _write_all("\x1b[H" + frame_txt + "\n" + status[:tcols] + "\x1b[K\n")
    _write_all("\n")
    return camera
