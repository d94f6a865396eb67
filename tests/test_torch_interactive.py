"""The PyTorch port's interactive front end (``app/interactive.py``) vs the
JAX reference: ``ansi_preview`` gives the reference's string on seeded
images, and the port's app runs ``--interactive`` under a pseudo-terminal
on the CPU at 32x32: move, look, cycle the mode, write a PNG, quit.

Eager PyTorch compiles nothing, so the first frame comes within a few
seconds; every read of the terminal gives up after at most 30 s.
"""

import fcntl
import os
import re
import select
import struct
import subprocess
import sys
import termios
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_raytracing.app.interactive import ansi_preview as jansi  # noqa: E402
from tpu_raytracing_torch.app.interactive import ansi_preview  # noqa: E402
from tpu_raytracing_torch.utils.png import read_png  # noqa: E402

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
READ_S = 30.0


@pytest.mark.parametrize("shape,cols,rows", [
    ((64, 64, 4), 40, 10), ((4, 4, 3), 100, 50), ((33, 17, 4), 8, 7), ((768, 1024, 4), 120, 40)])
def test_ansi_preview_matches_reference(shape, cols, rows):
    rng = np.random.default_rng(sum(shape) + cols)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    out = ansi_preview(img, cols, rows)
    assert out == jansi(img, cols, rows)
    assert "▀" in out and out.endswith("\x1b[0m")


def test_frames_are_written_in_full(monkeypatch, capfd):
    """A terminal may take a large write in parts: every part of a frame
    reaches it, status line included."""
    from tpu_raytracing_torch.app import interactive

    real_write = os.write
    monkeypatch.setattr(interactive.os, "write", lambda fd, data: real_write(fd, data[:997]))
    img = np.random.default_rng(5).integers(0, 256, (192, 256, 4), dtype=np.uint8)
    text = "\x1b[H" + ansi_preview(img, 200, 37) + "\nmode=DEPTH  fps=1.0\x1b[K\n"
    interactive._write_all(text)
    assert capfd.readouterr().out == text and len(text) > 100_000


class PtyApp:
    """The port's app under a pseudo-terminal of 200 x 40 cells."""

    def __init__(self, argv, stderr_path):
        self.master, slave = os.openpty()
        fcntl.ioctl(slave, termios.TIOCSWINSZ, struct.pack("HHHH", 40, 200, 0, 0))
        env = dict(os.environ, PYTHONPATH=_REPO, OMP_NUM_THREADS="2")
        self.err = open(stderr_path, "wb")
        self.proc = subprocess.Popen(
            [sys.executable, "-u", "-m", "tpu_raytracing_torch.app.main"] + argv,
            stdin=slave, stdout=slave, stderr=self.err, env=env, cwd=_REPO)
        os.close(slave)
        self.buf = b""

    def until(self, what: str, pred=lambda m: True) -> re.Match:
        """Read until the output since the last call holds a status line
        that satisfies ``pred``; fail after READ_S seconds."""
        self.buf = b""
        end = time.monotonic() + READ_S
        while time.monotonic() < end:
            r, _, _ = select.select([self.master], [], [], 0.5)
            if r:
                try:
                    self.buf += os.read(self.master, 1 << 16)
                except OSError:
                    break
            for m in reversed(list(re.finditer(STATUS, self.buf))):
                if pred(m):
                    return m
            if self.proc.poll() is not None:
                break
        raise AssertionError(f"no {what} within {READ_S} s; last output "
                             f"{self.buf[-300:]!r}; stderr {self._stderr()!r}")

    def wait_exit(self) -> int:
        """Drain the terminal (a blocked write would keep the app from
        reading its keys) until the app exits; its exit code."""
        end = time.monotonic() + READ_S
        while self.proc.poll() is None and time.monotonic() < end:
            r, _, _ = select.select([self.master], [], [], 0.5)
            if r:
                try:
                    os.read(self.master, 1 << 16)
                except OSError:
                    pass
        assert self.proc.poll() is not None, f"no exit within {READ_S} s"
        return self.proc.returncode

    def _stderr(self) -> bytes:
        self.err.flush()
        with open(self.err.name, "rb") as f:
            return f.read()[-2000:]

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=READ_S)
        os.close(self.master)
        self.err.close()


STATUS = (rb"mode=(\w+)  fps=\S+  pos=\(([-\d.]+),([-\d.]+),([-\d.]+)\) yaw=([-\d.]+) "
          rb"pitch=([-\d.]+)")


def test_interactive_keys_through_a_pty(tmp_path):
    """w moves the camera, the right arrow turns it, m cycles DEPTH to
    BOX_TESTS, p writes shot0000.png (a 32x32 PNG that decodes), x quits
    with exit code 0; the frame shows as half blocks."""
    out_dir = tmp_path / "shots"
    s = PtyApp(["--scene", "cornell", "--type", "bottom-up", "--width", "32", "--height",
                 "32", "--tracer", "wide", "--interactive", "--device", "cpu", "--output",
                 str(out_dir)], tmp_path / "stderr.txt")
    try:
        first = s.until("first frame")
        assert first.group(1) == b"DEPTH"
        assert "▀".encode() in s.buf and b"\x1b[38;2;" in s.buf
        pos0, yaw0 = first.group(2, 3, 4), float(first.group(5))

        os.write(s.master, b"w\x1b[C")  # forward, then look right
        moved = s.until("moved frame", lambda m: m.group(2, 3, 4) != pos0
                        and float(m.group(5)) != yaw0)
        assert float(moved.group(5)) == pytest.approx(yaw0 + 0.06, abs=0.011)

        os.write(s.master, b"m")
        s.until("BOX_TESTS frame", lambda m: m.group(1) == b"BOX_TESTS")

        os.write(s.master, b"p")
        shot = out_dir / "shot0000.png"
        end = time.monotonic() + READ_S
        while not shot.is_file() and time.monotonic() < end:
            s.until("frame after the shot")
        img = read_png(str(shot))
        assert img.shape == (32, 32, 4) and img[..., :3].any()

        os.write(s.master, b"x")
        assert s.wait_exit() == 0, s._stderr()
    finally:
        s.close()


def test_interactive_needs_a_tty(tmp_path):
    """Without a TTY on stdin the app exits with the reference's message."""
    env = dict(os.environ, PYTHONPATH=_REPO, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_raytracing_torch.app.main", "--scene", "cornell",
         "--width", "16", "--height", "16", "--interactive", "--device", "cpu", "--output",
         str(tmp_path)], stdin=subprocess.DEVNULL, capture_output=True, text=True,
        cwd=_REPO, env=env, timeout=120)
    assert proc.returncode != 0
    assert "--interactive needs a TTY on stdin" in proc.stderr
