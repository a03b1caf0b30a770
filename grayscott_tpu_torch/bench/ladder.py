"""The backend ladder on the card: each plain rung (``naive``, ``regular``,
``fused``, ``conv``) and the ``cuda`` backend on ``auto``, through
``cli.simulate.run`` at the default run's shape and boundary (1080x1920,
naive, 32 steps an image), the port's counterpart of the reference's
ladder table.

    python -m grayscott_tpu_torch.bench.ladder [--images 4] [--rounds 2]

:func:`ladder_ms` times each backend in turns: one warm run each (the
kernels' build, the graphs' captures), then ``rounds`` rounds (the
backends in order, then reversed) of ``images`` images, ms an image on the
host clock ending in a device synchronise. :func:`profile_images` traces
``images`` more images of each with ``torch.profiler`` (CUDA activity
only, so the host runs untraced): the device kernels a step, the device's
busy time an image (the union of its kernels and copies), and the idle
share of the device between the trace's first and last device event.
Prints one JSON line with the card's name and power limit
(``nvidia-smi``). Needs the card: without one it exits 1 and prints no
result.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from typing import Dict, List, Sequence, Tuple

import torch

#: the rungs, then the hand-written kernels' backend
LABELS = ("naive", "regular", "fused", "conv", "cuda")

SHAPE = (1080, 1920)
STEPS = 32


def make_run(label: str, shape: Tuple[int, int] = SHAPE,
             boundary: str = "naive", device: str = "cuda"):
    """(simulation, species) of backend ``label`` with the default
    parameters and engine choice, on the standard initial state."""
    from ..backends import get_backend
    from ..params import Parameters

    sim = get_backend(label)(Parameters(), boundary=boundary, device=device)
    return sim, sim.make_species(shape)


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def ladder_ms(labels: Sequence[str] = LABELS, shape=SHAPE,
              steps: int = STEPS, images: int = 4, rounds: int = 2,
              boundary: str = "naive", device: str = "cuda"
              ) -> Dict[str, List[float]]:
    """ms an image of each backend's ``simulate.run`` of ``images`` images
    of ``steps`` steps, 2 x ``rounds`` runs each in turns, after one warm
    run of one image."""
    from ..cli import simulate

    runs = {label: make_run(label, shape, boundary, device)
            for label in labels}
    for sim, species in runs.values():
        simulate.run(sim, species, 1, steps, lambda frame: None)
    _sync(device)
    samples: Dict[str, List[float]] = {label: [] for label in labels}
    for _ in range(rounds):
        for label in [*labels, *reversed(labels)]:
            sim, species = runs[label]
            t0 = time.perf_counter()
            simulate.run(sim, species, images, steps, lambda frame: None)
            _sync(device)
            samples[label].append((time.perf_counter() - t0) / images * 1e3)
    return samples


def _union_us(intervals: List[Tuple[float, float]]) -> float:
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for start, stop in sorted(intervals):
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total


def profile_images(label: str, images: int = 4, shape=SHAPE,
                   steps: int = STEPS, boundary: str = "naive") -> dict:
    """``images`` images of backend ``label`` on the card under
    ``torch.profiler`` (after a warm image): ``kernels_per_step``,
    ``copies_per_image`` (memcpy and memset events), ``device_busy_ms``
    and ``device_span_ms`` an image (the span: first to last device event)
    and ``idle_share``; the times are None when the trace holds no device
    event."""
    from torch.profiler import ProfilerActivity, profile

    from ..cli import simulate

    sim, species = make_run(label, shape, boundary, "cuda")
    simulate.run(sim, species, 1, steps, lambda frame: None)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        simulate.run(sim, species, images, steps, lambda frame: None)
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    copies = [e for e in events if e.name.startswith(("Memcpy", "Memset"))]
    spans = [(e.time_range.start, e.time_range.end) for e in events]
    out = {"kernels_per_step": (len(events) - len(copies))
           / (images * steps), "copies_per_image": len(copies) / images,
           "device_busy_ms": None, "device_span_ms": None,
           "idle_share": None}
    if spans:
        busy = _union_us(spans)
        span = max(e for _, e in spans) - min(s for s, _ in spans)
        out.update(device_busy_ms=busy / 1e3 / images,
                   device_span_ms=span / 1e3 / images,
                   idle_share=1.0 - busy / span if span else 0.0)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--images", type=int, default=4)
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("ladder: PyTorch sees no CUDA GPU", file=sys.stderr)
        return 1
    from ..utils.device import nvidia_smi

    samples = ladder_ms(images=args.images, rounds=args.rounds)
    median = {label: statistics.median(s) for label, s in samples.items()}
    print(json.dumps({
        "card": nvidia_smi("name,power.limit").splitlines()[0],
        "shape": list(SHAPE), "steps_per_image": STEPS,
        "boundary": "naive", "ms_per_image": samples, "median": median,
        "x_cuda": {label: ms / median["cuda"]
                   for label, ms in median.items()},
        "profile": {label: profile_images(label, args.images)
                    for label in LABELS}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
