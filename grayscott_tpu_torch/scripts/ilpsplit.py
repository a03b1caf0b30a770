"""Experiment: the resident step split into row slabs (K9).

The port of ``scripts/ilpsplit.py``. The resident kernel K3 meets a grid
barrier every step. K9 computes the same steps in ``split`` row slabs, each
of which waits only for its own and its two neighbours' blocks; if the
barrier is what holds K3 back, a split beats it. Every split gives K3's
result bit for bit.

    python -m grayscott_tpu_torch.scripts.ilpsplit [--steps 1024] \\
        [--shape 1080x1920] [--boundary zero] [--splits 2,4]
    python -m grayscott_tpu_torch.scripts.ilpsplit --device cpu \\
        --shape 70x97 --steps 5 --splits 1,2,4       # plain version

From the reference's initial state, each split first runs 3 steps: every
split after the first is held bitwise against the first, and split 1
against K3 (``resident``), one line each. Then ``steps`` steps are timed
(the best of 3 after a warm call, CUDA events on the card, the host clock
on the CPU) and printed as ``RESULT {...}`` with the JAX script's keys plus
``device``; ``BASELINE {...}`` gives K3's time with the same keys (its
``split`` null). A split that fails, or does not match, raises: the script
exits non-zero. ``DONE`` ends a run that passed.

The JAX script's ``--lower-only`` (a TPU lowering gate) has no counterpart:
``grayscott_tpu_torch/ops/build.py`` compiles the kernel with nvcc on first
use and raises if it does not build. Its ``--unroll`` (the TPU kernel's
grouping of the steps, which changes neither the steps nor their order) is
accepted and ignored: the CUDA kernel runs the steps in one loop.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Sequence

import torch

from ..cli.shared import require_device
from ..ops import ilpsplit, resident
from ..params import Parameters, kernel_constants
from ..species import initial_uv
from ..utils.device import device_name, time_call
from ..utils.runtime import PLATFORMS, default_device

#: steps of the correctness check of each split (``ilpsplit.py:173-175``)
CHECK_STEPS = 3


def sweep(shape, boundary: str, splits: Sequence[int], steps: int,
          device: str = "cuda") -> List[dict]:
    """K3's record, then one per split; each line printed as it comes.
    Raises when a split does not match."""
    require_device(device)
    consts = kernel_constants(Parameters())
    u0, v0 = (torch.from_numpy(a).to(device) for a in initial_uv(shape))
    name = device_name(device)

    def fresh():
        return [u0.clone(), v0.clone(), torch.empty_like(u0),
                torch.empty_like(v0)]

    def record(split, seconds):
        rec = {"shape": list(shape), "split": split, "boundary": boundary,
               "steps": steps, "seconds": seconds,
               "gcells_per_sec": shape[0] * shape[1] * steps / seconds / 1e9,
               "device": name}
        print(("BASELINE " if split is None else "RESULT ") + json.dumps(rec),
              flush=True)
        return rec

    def equal(a, b) -> bool:
        return all(torch.equal(x, y) for x, y in zip(a, b))

    on_k3 = [x.cpu() for x in resident.multistep(
        *fresh(), CHECK_STEPS, consts, boundary)[:2]]
    bufs = fresh()

    def k3():
        bufs[:] = resident.multistep(*bufs, steps, consts, boundary)

    out = [record(None, time_call(k3, device))]
    ref = ref_split = None
    for split in splits:
        got = [x.cpu() for x in ilpsplit.split_multistep(
            *fresh(), CHECK_STEPS, consts, boundary, split)[:2]]
        if ref is None:
            ref, ref_split = got, split
        else:
            same = equal(ref, got)
            print(f"split={split}: bitwise match vs split={ref_split}: "
                  f"{same}", flush=True)
            if not same:
                raise RuntimeError(f"split={split} differs from "
                                   f"split={ref_split}")
        if split == 1:
            same = equal(on_k3, got)
            print(f"split=1: bitwise match vs resident: {same}", flush=True)
            if not same:
                raise RuntimeError("split=1 differs from the resident kernel")
        bufs = fresh()

        def k9():
            bufs[:] = ilpsplit.split_multistep(*bufs, steps, consts,
                                               boundary, split)

        out.append(record(split, time_call(k9, device)))
    return out


def parse_shape(text: str):
    r, c = (int(x) for x in text.lower().split("x"))
    return r, c


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="ilpsplit", description=__doc__.split("\n")[0])
    parser.add_argument("--steps", type=int, default=1024)
    parser.add_argument("--shape", default="1080x1920", type=parse_shape)
    parser.add_argument("--boundary", default="zero",
                        choices=["naive", "zero"])
    parser.add_argument("--splits", default="2,4",
                        type=lambda s: [int(x) for x in s.split(",")])
    parser.add_argument(
        "--unroll", type=int, default=2,
        help="accepted for the JAX script's command line and ignored: it "
        "groups the same steps in the same order, and the CUDA kernel runs "
        "them in one loop")
    parser.add_argument(
        "--device", default=default_device(), choices=PLATFORMS,
        help="'cuda' (default) runs the CUDA kernels; 'cpu' their plain "
        "PyTorch versions")
    args = parser.parse_args(argv)
    sweep(args.shape, args.boundary, args.splits, args.steps, args.device)
    print("DONE", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
