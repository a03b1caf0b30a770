"""Time the default ``simulate`` run of one checkout of the port, so that
two checkouts (a parent commit and a change) can be compared in turns on
one card:

    python grayscott_tpu_torch/bench/simulate_turns.py --tree DIR --label L

``grayscott_tpu_torch`` is imported from ``DIR`` (default: the checkout
this file lies in), so an older commit unpacked beside this one is timed by
the same code. Run it as a file, not with ``-m``, and alternate the trees
(parent, change, change, parent), one process each.

For each pin (``auto`` and ``--pallas-engine windowed``) it runs
``cli.simulate.run`` of the default run (1080x1920, naive, 32 steps an
image) for ``--images`` images, once to warm up, then ``--reps`` times in
turns (the pins in order, then reversed), each on the host clock and ending
in a device synchronise, as ``chip_smoke.py``'s phase 4 times it: frames
kept in memory, PyTorch's pinned-memory cache filled first. Then it times
the kernels alone with CUDA events: K1 (four 8-step launches) and K3 (one
32-step launch) on a random state. Prints one JSON line: ms an image per
run and pin with their median, the kernels' ms, and the card's name and
power limit (``nvidia-smi``).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

#: the pins timed, as ``simulate`` flags
PINS = {"auto": [], "windowed": ["--pallas-engine", "windowed"]}


def run_ms(flags: list, images: int, steps: int = 32,
           ablation: int | None = None) -> float:
    """ms an image of one ``simulate.run`` (with ``flags``, and
    ``ablation``: a part of its snapshot pipeline taken out) of ``images``
    images of ``steps`` steps, on the host clock ending in a device
    synchronise; PyTorch's pinned-memory cache is filled first, since the
    frames are kept."""
    import torch

    from grayscott_tpu_torch.cli import shared, simulate

    ns = simulate.build_parser().parse_args(flags)
    sim = shared.make_simulation(ns)
    species = sim.make_species(shared.domain_shape(ns))
    frames: list = []
    pinned = [torch.empty(shared.domain_shape(ns), pin_memory=True)
              for _ in range(images + 1)]
    del pinned
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    simulate.run(sim, species, images, steps, frames.append,
                 ablation=ablation)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / images * 1e3


def main(argv=None) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        here)), help="the checkout whose grayscott_tpu_torch is timed")
    parser.add_argument("--label", default="tree")
    parser.add_argument("--images", type=int, default=16)
    parser.add_argument("--reps", type=int, default=5)
    args = parser.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.tree))
    import numpy as np
    import torch

    from grayscott_tpu_torch.ops import resident, windowed
    from grayscott_tpu_torch.params import Parameters, kernel_constants
    from grayscott_tpu_torch.utils import device as gpu

    if not torch.cuda.is_available():
        print("simulate_turns: PyTorch sees no CUDA GPU", file=sys.stderr)
        return 1
    import grayscott_tpu_torch
    loaded = os.path.dirname(os.path.dirname(
        os.path.abspath(grayscott_tpu_torch.__file__)))
    if loaded != os.path.abspath(args.tree):
        print(f"simulate_turns: imported {loaded}, not {args.tree}",
              file=sys.stderr)
        return 1
    for flags in PINS.values():  # builds the kernels, first launches
        run_ms(flags, args.images)
    samples = {pin: [] for pin in PINS}
    order = [*PINS, *reversed(PINS)]
    for _ in range(args.reps):
        for pin in order:
            samples[pin].append(run_ms(PINS[pin], args.images))

    consts = kernel_constants(Parameters())
    rng = np.random.RandomState(0)
    u, v = (torch.from_numpy(rng.uniform(0, 1, (1080, 1920))
                             .astype(np.float32)).cuda() for _ in range(2))
    k1 = [u, v, torch.empty_like(u), torch.empty_like(v)]
    k3 = [u.clone(), v.clone(), torch.empty_like(u), torch.empty_like(v)]

    def f1():
        for _ in range(4):
            windowed.multistep(*k1, 8, consts, "naive")
            k1[:] = k1[2:] + k1[:2]

    def f3():
        k3[:] = resident.multistep(*k3, 32, consts, "naive")

    kernels = {name: gpu.time_call(fn, "cuda", 40) * 1e3
               for name, fn in (("K1 x4", f1), ("K3", f3))}
    print(json.dumps({
        "label": args.label, "tree": args.tree,
        "card": gpu.nvidia_smi("name,power.limit").splitlines()[0],
        "ms_per_image": samples,
        "median": {pin: statistics.median(s) for pin, s in samples.items()},
        "kernel_ms_32_steps": kernels}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
