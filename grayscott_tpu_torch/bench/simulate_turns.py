"""Time the default ``simulate`` run of one checkout of the port, so that
two checkouts (a parent commit and a change) can be compared in turns on
one card:

    python grayscott_tpu_torch/bench/simulate_turns.py --tree DIR --label L

``grayscott_tpu_torch`` is imported from ``DIR`` (default: the checkout
this file lies in), so an older commit unpacked beside this one is timed by
the same code. Run it as a file, not with ``-m``, and alternate the trees
(parent, change, change, parent), one process each.

For each pin (``auto``, ``--pallas-engine windowed``,
``--pallas-engine mega`` and the sharded windowed engine on a 2x2 mesh at
K = 8) it runs ``cli.simulate.run`` of the default run (1080x1920, naive, 32 steps an
image) for ``--images`` images, once to warm up, then ``--reps`` times in
turns (the pins in order, then reversed), each on the host clock and ending
in a device synchronise, as ``chip_smoke.py``'s phase 4 times it: frames
kept in memory, PyTorch's pinned-memory cache filled first. Then it times
the kernels alone with CUDA events, each 32 steps on a random state at
1080x1920: K1 (four 8-step launches), K3 (one launch), K2 and K6 (one
launch of 4 time blocks; also at 4096x4096), K7 on 2x2 and 4x1 (one
launch after the halo exchange) and K1's shard entry on the same meshes
(four 8-step launches after the halo exchange), through calls that every commit since
the sharded megakernel takes, so that the double buffer and the entry
gate of a parent are timed against a change. Prints one JSON line: ms an
image per run and pin with their median, the kernels' ms, and the card's
name and power limit (``nvidia-smi``).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

#: the pins timed, as ``simulate`` flags
PINS = {"auto": [], "windowed": ["--pallas-engine", "windowed"],
        "mega": ["--pallas-engine", "mega"],
        "sharded windowed": ["--backend", "sharded", "--sharded-devices", "4",
                             "--sharded-mesh-cols", "2",
                             "--sharded-engine", "windowed"]}


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

    from grayscott_tpu_torch.ops import (megakernel, packed, resident,
                                         sharded_mega, windowed)
    from grayscott_tpu_torch.parallel import halo
    from grayscott_tpu_torch.params import (Parameters, kernel_constants,
                                            packed_constants)
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

    calls = [("K1 x4", f1, 40), ("K3", f3, 40)]
    pc = packed_constants(Parameters())
    for shape, reps in (((1080, 1920), 40), ((4096, 4096), 8)):
        a, b = (torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32))
                .cuda() for _ in range(2))
        pu, pv = megakernel.pair_state(a), megakernel.pair_state(b)
        xp = megakernel.pair_state(packed.pack_state(a, b))
        label = "" if shape == (1080, 1920) else " 4096"
        calls.append((f"K2{label}", lambda pu=pu, pv=pv: megakernel.megastep(
            pu, pv, 4, 8, consts, "naive"), reps))
        calls.append((f"K6{label}", lambda xp=xp: megakernel.packed_megastep(
            xp, 4, 8, pc), reps))
    u_np, v_np = (rng.uniform(0, 1, (1080, 1920)).astype(np.float32)
                  for _ in range(2))
    for n_rows, n_cols in ((2, 2), (4, 1)):
        mesh = halo.make_mesh(n_rows * n_cols, n_cols, "cuda")
        pairs = halo.mega_shard_state(u_np, v_np, mesh)

        def f7(pairs=pairs, mesh=mesh):
            for p in pairs:
                halo.exchange_halos(p)
            sharded_mega.sharded_megastep(*pairs, mesh, 4, 8, consts, "naive",
                                          (1080, 1920))

        calls.append((f"K7 {n_rows}x{n_cols}", f7, 40))
        pairs1 = halo.mega_shard_state(u_np, v_np, mesh)
        for p in pairs1:
            halo.exchange_halos(p)

        def f1s(pairs=pairs1, mesh=mesh):
            for _ in range(4):
                windowed.shard_multistep(*pairs, mesh, 0, 8, consts, "naive",
                                         (1080, 1920))

        calls.append((f"K1 shard {n_rows}x{n_cols}", f1s, 40))
    kernels = {name: gpu.time_call(fn, "cuda", reps) * 1e3
               for name, fn, reps in calls}
    print(json.dumps({
        "label": args.label, "tree": args.tree,
        "card": gpu.nvidia_smi("name,power.limit").splitlines()[0],
        "ms_per_image": samples,
        "median": {pin: statistics.median(s) for pin, s in samples.items()},
        "kernel_ms_32_steps": kernels}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
