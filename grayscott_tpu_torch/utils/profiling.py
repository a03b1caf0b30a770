"""Profiling support: the port's ``grayscott_tpu/utils/profiling.py``, on
``torch.profiler`` in place of ``jax.profiler``.

- :func:`trace` records the enclosed block (host activity, and the card's
  kernels and copies when the device is ``cuda``) and writes it as a Chrome
  trace under ``GRAYSCOTT_TRACE_DIR`` (default ``grayscott_trace`` in the
  temporary directory), which Perfetto or ``chrome://tracing`` opens;
- :func:`annotate` names a host span on that timeline
  (``torch.profiler.record_function``), as JAX's ``TraceAnnotation`` does;
- :func:`device_events` reads the card's events back from a trace file
  (``bench/ladder.py`` reads its kernels, copies and idle share so).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import tempfile
from typing import Iterator, List, NamedTuple

import torch

#: trace files written by this process, numbered so none overwrites another
_traces = itertools.count()

#: the Chrome trace categories of the card's own work
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def trace_dir() -> str:
    """``GRAYSCOTT_TRACE_DIR``, else ``grayscott_trace`` in the temporary
    directory."""
    return os.environ.get("GRAYSCOTT_TRACE_DIR") or os.path.join(
        tempfile.gettempdir(), "grayscott_trace")


@contextlib.contextmanager
def trace(log_dir: str | None = None, device: str | torch.device = "cuda",
          host: bool = True) -> Iterator[str]:
    """Profile the enclosed block; yields the path of the Chrome trace it
    writes when the block ends. ``host=False`` records the card alone, so
    the host runs untraced (``bench/ladder.py``'s idle share)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] if host else []
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    log_dir = log_dir or trace_dir()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir,
                        f"trace-{os.getpid()}-{next(_traces)}.json")
    with profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)


def annotate(name: str):
    """A named span on the profiler's timeline."""
    return torch.profiler.record_function(name)


class DeviceEvent(NamedTuple):
    name: str
    category: str  # one of DEVICE_CATEGORIES
    start_us: float
    end_us: float


def device_events(path: str) -> List[DeviceEvent]:
    """The card's kernels, copies and fills in the Chrome trace ``path``."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [DeviceEvent(e["name"], e["cat"], float(e["ts"]),
                        float(e["ts"]) + float(e.get("dur", 0.0)))
            for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES]
