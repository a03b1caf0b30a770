"""Microbenchmark: the per-op cost of dependent full-array operations (K8).

The port of ``scripts/oplat.py``. Each measurement runs ``steps`` chains of
``n_ops`` dependent operations on a whole float32 array in one kernel
launch (:func:`grayscott_tpu_torch.ops.oplat.chain`): fused multiply-adds,
and with ``rolls`` a roll of the whole array every third op. Sweeping
(shape, n_ops) separates the per-op cost from the per-cell cost; on the
card the no-roll form gives the float32 pipe's dependent-chain cost per
cell, and the roll form adds a grid barrier and an L2 round trip of the
array per roll, the fixed cost that the resident kernels pay each step.

    python -m grayscott_tpu_torch.scripts.oplat               # on the card
    python -m grayscott_tpu_torch.scripts.oplat --device cpu  # plain version

Prints one ``RESULT {...}`` line per (shape, n_ops, rolls) with the keys
of the JAX script (``shape``, ``n_ops``, ``rolls``, ``us_per_step``,
``ns_per_op``, ``ps_per_cell_op``) plus ``device``, unrounded; then a
``FIT`` line per (shape, rolls): ``t = a + b * n_ops`` through the first
and last ``n_ops``. On the CPU the numbers are the plain PyTorch version's,
not a device's.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
from typing import Iterable, List

import torch

from ..cli.shared import require_device
from ..ops import oplat
from ..utils.device import device_name, time_call
from ..utils.runtime import PLATFORMS, default_device

SHAPES = [(1088, 1920), (272, 1920), (1088, 4096), (272, 4096),
          (2176, 3840)]
OPSS = [15, 45, 90]
STEPS = 256


def measure(shape, steps: int, n_ops: int, rolls: bool,
            device: str = "cuda") -> float:
    """Seconds per step of one ``steps``-step call, the best of 3 after a
    warm call (:func:`~grayscott_tpu_torch.utils.device.time_call`)."""
    require_device(device)
    x = torch.ones(shape, dtype=torch.float32, device=device)
    return time_call(lambda: oplat.chain(x, steps, n_ops, rolls),
                     device) / steps


def sweep(shapes: Iterable, opss: Iterable[int], steps: int = STEPS,
          device: str = "cuda") -> List[dict]:
    """One record per (shape, n_ops, rolls), each printed as a ``RESULT``
    line as it is measured."""
    name = device_name(device)
    out = []
    for shape, n_ops, rolls in itertools.product(shapes, opss,
                                                 (False, True)):
        t = measure(shape, steps, n_ops, rolls, device)
        rec = {
            "shape": list(shape), "n_ops": n_ops, "rolls": rolls,
            "us_per_step": t * 1e6,
            "ns_per_op": t / n_ops * 1e9,
            "ps_per_cell_op": t / n_ops / (shape[0] * shape[1]) * 1e12,
            "device": name,
        }
        out.append(rec)
        print("RESULT " + json.dumps(rec), flush=True)
    return out


def fits(records: List[dict]) -> List[str]:
    """Per (shape, rolls): ``t(n_ops) = a + b * n_ops`` through the first
    and last points (``oplat.py:89-99``)."""
    lines = []
    shapes = list(dict.fromkeys(tuple(r["shape"]) for r in records))
    for shape in shapes:
        for rolls in (False, True):
            pts = [(r["n_ops"], r["us_per_step"]) for r in records
                   if tuple(r["shape"]) == shape and r["rolls"] == rolls]
            if len(pts) >= 2:
                (x1, y1), (x2, y2) = pts[0], pts[-1]
                b = (y2 - y1) / (x2 - x1)
                a = y1 - b * x1
                lines.append(f"FIT shape={shape} rolls={rolls}: "
                             f"t = {a:.2f} us + {b * 1000:.1f} ns/op")
    return lines


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="oplat", description=__doc__.split("\n")[0])
    parser.add_argument(
        "--device", default=default_device(), choices=PLATFORMS,
        help="'cuda' (default) runs the CUDA kernel; 'cpu' its plain "
        "PyTorch version")
    args = parser.parse_args(argv)
    records = sweep(SHAPES, OPSS, STEPS, args.device)
    for line in fits(records):
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
