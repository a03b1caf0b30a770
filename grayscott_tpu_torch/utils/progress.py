"""Terminal progress bar with an ETA: the port's copy of
``grayscott_tpu/utils/progress.py``. It draws on stderr, and only on a
terminal unless told otherwise."""

from __future__ import annotations

import shutil
import sys
import threading
import time


def _fmt_duration(seconds: float) -> str:
    m, s = divmod(int(seconds), 60)
    h, m = divmod(m, 60)
    if h:
        return f"{h}h{m:02d}m{s:02d}s"
    if m:
        return f"{m}m{s:02d}s"
    return f"{s}s"


class ProgressBar:
    """``{msg} {pos}/{len} [####    ] {elapsed}/~{eta}`` on stderr."""

    def __init__(self, message: str, num_steps: int, stream=None,
                 enabled=None):
        self.message = message
        self.num_steps = max(num_steps, 1)
        self.pos = 0
        self._t0 = time.monotonic()
        self._stream = stream or sys.stderr
        self._lock = threading.Lock()
        self._last_draw = 0.0
        self._enabled = (self._stream.isatty() if enabled is None
                         else enabled)

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.pos += n
            now = time.monotonic()
            if self._enabled and (now - self._last_draw > 0.1
                                  or self.pos >= self.num_steps):
                self._draw(now)
                self._last_draw = now

    def _draw(self, now: float) -> None:
        elapsed = now - self._t0
        frac = self.pos / self.num_steps
        total = elapsed / frac if frac > 0 else 0.0
        head = f"{self.message} {self.pos}/{self.num_steps} "
        tail = f" {_fmt_duration(elapsed)}/~{_fmt_duration(total)}"
        width = shutil.get_terminal_size().columns
        bar_w = max(width - len(head) - len(tail) - 2, 4)
        filled = int(bar_w * frac)
        self._stream.write(
            f"\r{head}[{'#' * filled}{'-' * (bar_w - filled)}]{tail}")
        self._stream.flush()

    def finish(self) -> None:
        """Clear the bar."""
        if self._enabled:
            width = shutil.get_terminal_size().columns
            self._stream.write("\r" + " " * width + "\r")
            self._stream.flush()
