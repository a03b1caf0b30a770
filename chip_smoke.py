#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA GPU, and check it.

    python3 chip_smoke.py [--seed N]

1. Prints the environment: PyTorch and its CUDA, the card, its power limit
   (nvidia-smi) and nvcc.
2. Builds the kernels from ``grayscott_tpu_torch/csrc/`` into
   ``build/kernels/`` and prints the build time and ptxas's report.
3. Holds the windowed kernel against its plain PyTorch version on the card:
   1080x1920, 1000x1917 (ragged against the 32x32 tiles) and 4096x4096,
   both boundaries, 1 and 8 steps a launch and 32 steps through the
   backend, with the default parameters, the other stencils and dt = 0.5.
4. Runs the main path: the default ``simulate`` run (1080x1920, naive
   boundary, Oono-Puri, float32) built by ``cli.shared.make_simulation``
   for 16 images of 32 steps through ``cli.simulate.run``, counting the
   kernel's launches, and holds every frame against a replay of the plain
   version; then the same on a small domain against the plain version on
   the CPU, and ``simulate.main`` writing HDF5 when h5py is installed.
5. Times the kernel and the plain version with CUDA events at 1080x1920
   and 4096x4096, and the snapshot copy of the main path.
6. Prints the nvidia-smi line, one JSON line on the kernels, and last the
   JSON line ``{"ok": true, "device": {...}}``.

Every check runs; a failed one makes the script exit 1 without the two
JSON lines. With no CUDA GPU visible it exits 1 at once.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from grayscott_tpu_torch.backends.cuda import CudaSimulation
from grayscott_tpu_torch.cli import shared, simulate
from grayscott_tpu_torch.ops import build, windowed
from grayscott_tpu_torch.params import Parameters, kernel_constants
from grayscott_tpu_torch.species import initial_uv
from grayscott_tpu_torch.utils import device as gpu

#: kernel vs plain version, max |difference|: both run the same float32
#: expression tree with every operation rounded once (nvcc -fmad=false, no
#: flush to zero), so they agree bit for bit
TOL = 0.0

#: the card; every tensor of the checks lives there
DEVICE = "cuda"
SHAPES = [(1080, 1920), (1000, 1917), (4096, 4096)]
MAIN_SHAPE = (1080, 1920)
MAIN_IMAGES, MAIN_STEPS = 16, 32

KERNEL = {
    "name": "windowed_multistep",
    "route": "cuda",
    "source": "grayscott_tpu_torch/csrc/windowed.cu",
    "replaces": "grayscott_tpu/ops/pallas_stencil.py:929",
}


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a - b).abs().max().item()


def gcells(shape, steps: int, ms: float) -> float:
    return shape[0] * shape[1] * steps / (ms * 1e-3) / 1e9


class Checks:
    def __init__(self):
        self.failures: list[str] = []
        self.kernel_err = 0.0

    def expect(self, ok: bool, what: str) -> None:
        if not ok:
            self.failures.append(what)
            print(f"FAILED: {what}", flush=True)


def compare_kernel(checks: Checks, rng) -> None:
    stencils = {
        "default": Parameters(),
        "5points": Parameters.with_stencil("5points"),
        "pretty": Parameters.with_stencil("pretty"),
        "patra-karttunen": Parameters.with_stencil("patra-karttunen"),
        "dt=0.5": Parameters(time_step=0.5),
    }
    cases = []  # (shape, boundary, params label, steps)
    for shape in SHAPES:
        for boundary in ("naive", "zero"):
            cases += [(shape, boundary, "default", s) for s in (1, 8, 32)]
            cases.append((shape, boundary, "5points", 8))
    for label in ("pretty", "patra-karttunen", "dt=0.5"):
        for boundary in ("naive", "zero"):
            cases.append((SHAPES[1], boundary, label, 8))
    inputs = {}
    for shape in SHAPES:
        u = rng.uniform(0.0, 1.0, shape).astype(np.float32)
        v = rng.uniform(0.0, 1.0, shape).astype(np.float32)
        inputs[shape] = (u, v)
    for shape, boundary, label, steps in cases:
        params = stencils[label]
        consts = kernel_constants(params)
        u_np, v_np = inputs[shape]
        u0 = torch.from_numpy(u_np).to(DEVICE)
        v0 = torch.from_numpy(v_np).to(DEVICE)
        if steps <= windowed.K:
            path = "multistep"
            ku, kv = torch.empty_like(u0), torch.empty_like(v0)
            windowed.multistep(u0, v0, ku, kv, steps, consts, boundary)
        else:
            path = "backend"
            sim = CudaSimulation(params, boundary, device=DEVICE)
            storage = sim.run_steps(sim.build_storage(u_np, v_np), shape,
                                    steps)
            ku, kv = sim.extract_uv(storage, shape)
        ru, rv = windowed.multistep_reference(u0, v0, steps, consts,
                                              boundary)
        torch.cuda.synchronize()
        eu, ev = max_err(ku, ru), max_err(kv, rv)
        checks.kernel_err = max(checks.kernel_err, eu, ev)
        print(f"compare {shape[0]}x{shape[1]} boundary={boundary} "
              f"params={label} steps={steps} via={path}: "
              f"max|dU|={eu!r} max|dV|={ev!r}", flush=True)
        checks.expect(eu <= TOL and ev <= TOL,
                      f"kernel vs plain {shape} {boundary} {label} {steps}")


def replay_frames(shape, boundary, params, images, steps, device):
    """V after each batch, from the plain version on ``device``."""
    consts = kernel_constants(params)
    u, v = (torch.from_numpy(x).to(device) for x in initial_uv(shape))
    frames = []
    for _ in range(images):
        u, v = windowed.multistep_reference(u, v, steps, consts, boundary)
        frames.append(v)
    return frames


def main_path(checks: Checks) -> dict:
    ns = simulate.build_parser().parse_args([])  # the default user run
    checks.expect((ns.nbrow, ns.nbcol, ns.boundary, ns.device)
                  == (*MAIN_SHAPE, "naive", DEVICE), "default simulate args")
    sim = shared.make_simulation(ns)
    species = sim.make_species(shared.domain_shape(ns))
    frames: list[np.ndarray] = []
    # This sink keeps every frame, so each image would pay a fresh pinned
    # allocation (cudaHostAlloc, ~1.3 ms at this shape), which a long run
    # does not: simulate.main's writer drops each frame once written and
    # PyTorch's pinned-memory cache hands the block back. Fill that cache
    # first, so the rate below is the steady state's.
    pinned = [torch.empty(MAIN_SHAPE, pin_memory=True)
              for _ in range(MAIN_IMAGES + 1)]
    del pinned
    torch.cuda.synchronize()
    windowed.launches = 0
    t0 = time.perf_counter()
    simulate.run(sim, species, MAIN_IMAGES, MAIN_STEPS, frames.append)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = windowed.launches
    expected = MAIN_IMAGES * MAIN_STEPS // windowed.K
    print(f"main path: simulate.run {MAIN_IMAGES} images x {MAIN_STEPS} "
          f"steps at {MAIN_SHAPE[0]}x{MAIN_SHAPE[1]} naive: "
          f"{seconds!r} s, kernel launches {launches} "
          f"(expected {expected})", flush=True)
    checks.expect(launches == expected,
                  f"main path launched the kernel {launches} times, "
                  f"not {expected}")
    checks.expect(len(frames) == MAIN_IMAGES, "main path frame count")
    checks.expect(all(f.shape == MAIN_SHAPE and f.dtype == np.float32
                      and np.isfinite(f).all() for f in frames),
                  "main path frames: shape, dtype or finiteness")
    replay = replay_frames(MAIN_SHAPE, "naive", sim.params, MAIN_IMAGES,
                           MAIN_STEPS, DEVICE)
    errs = [float(np.abs(f - r.cpu().numpy()).max())
            for f, r in zip(frames, replay)]
    checks.kernel_err = max(checks.kernel_err, *errs)
    print(f"main path vs plain replay on the card, max|dV| per frame: "
          f"{errs}", flush=True)
    checks.expect(max(errs) <= TOL, "main path vs plain replay")
    print(f"main path final frame: V in [{float(frames[-1].min())!r}, "
          f"{float(frames[-1].max())!r}], sum {float(frames[-1].sum())!r}")

    # a small ragged domain, both boundaries, 9 steps an image (one full
    # and one remainder launch), against the plain version on the CPU,
    # which the CPU tests hold bitwise to the numpy oracle
    for boundary in ("naive", "zero"):
        small = simulate.build_parser().parse_args(
            ["-r", "70", "-c", "97", "--boundary", boundary])
        sim_s = shared.make_simulation(small)
        sp = sim_s.make_species(shared.domain_shape(small))
        got: list[np.ndarray] = []
        simulate.run(sim_s, sp, 3, 9, got.append)
        want = replay_frames((70, 97), boundary, sim_s.params, 3, 9, "cpu")
        err = max(float(np.abs(g - w.numpy()).max())
                  for g, w in zip(got, want))
        print(f"small 70x97 {boundary}, 3 images x 9 steps, vs plain on the "
              f"CPU: max|dV|={err!r}", flush=True)
        checks.expect(err <= TOL, f"small {boundary} vs plain on the CPU")

    result = {"seconds": seconds, "launches": launches,
              "gcells": MAIN_SHAPE[0] * MAIN_SHAPE[1] * MAIN_IMAGES
              * MAIN_STEPS / seconds / 1e9}
    if importlib.util.find_spec("h5py") is None:
        print("simulate.main: not run (h5py is not installed); "
              "simulate.run ran with an in-memory sink")
        return result
    import h5py

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "output.h5")
        before = windowed.launches
        t0 = time.perf_counter()
        rc = simulate.main(["-n", str(MAIN_IMAGES), "-o", out])
        h5_seconds = time.perf_counter() - t0
        with h5py.File(out, "r") as f:
            written = f["matrix"][:]
    n = windowed.launches - before
    print(f"simulate.main ran and wrote HDF5: rc={rc}, {h5_seconds!r} s, "
          f"{n} launches", flush=True)
    checks.expect(rc == 0 and n == expected, "simulate.main")
    checks.expect(written.shape == (MAIN_IMAGES, *MAIN_SHAPE)
                  and np.array_equal(written[-1], frames[-1]),
                  "simulate.main HDF5 frames vs simulate.run")
    result["hdf5_seconds"] = h5_seconds
    return result


def time_kernel(shape, boundary, reps: int, rng) -> float:
    consts = kernel_constants(Parameters())
    u, v = (torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32))
            .to(DEVICE) for _ in range(2))
    uo, vo = torch.empty_like(u), torch.empty_like(v)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for i in range(3 + reps):
        if i == 3:
            start.record()
        windowed.multistep(u, v, uo, vo, windowed.K, consts, boundary)
        u, v, uo, vo = uo, vo, u, v
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_plain(shape, boundary, reps: int, rng) -> float:
    consts = kernel_constants(Parameters())
    u, v = (torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32))
            .to(DEVICE) for _ in range(2))
    windowed.multistep_reference(u, v, windowed.K, consts, boundary)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        u, v = windowed.multistep_reference(u, v, windowed.K, consts,
                                            boundary)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_snapshot(shape, reps: int) -> float:
    """ms of the main path's per-image snapshot: a device clone of V and
    its non-blocking copy into pinned host memory."""
    v = torch.zeros(shape, device=DEVICE)
    host = torch.empty(shape, pin_memory=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        host.copy_(v.clone(), non_blocking=True)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=42,
                        help="seed of the random test fields")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: PyTorch sees no CUDA GPU "
              "(torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    rng = np.random.RandomState(args.seed)
    checks = Checks()

    # 1. environment
    card = gpu.nvidia_smi("name,power.limit").splitlines()[0]
    print(gpu.capability_dump(), flush=True)

    # 2. build
    t0 = time.perf_counter()
    built = build.build()
    build.load()
    print(f"build: {built.path.name} in {time.perf_counter() - t0!r} s "
          f"(nvcc {built.seconds!r} s)")
    print(built.log.strip(), flush=True)

    # 3. kernel vs plain version
    compare_kernel(checks, rng)

    # 4. the main path
    e2e = main_path(checks)

    # 5. times, beside the card
    print(f"timing on {card}")
    timings = {}
    for shape, k_reps, p_reps in ((MAIN_SHAPE, 200, 5), (SHAPES[-1], 50, 2)):
        for boundary in ("naive", "zero"):
            ms = time_kernel(shape, boundary, k_reps, rng)
            plain_ms = time_plain(shape, boundary, p_reps, rng)
            timings[shape, boundary] = (ms, plain_ms)
            print(f"time {shape[0]}x{shape[1]} {boundary} K={windowed.K}: "
                  f"kernel {ms!r} ms/launch = "
                  f"{gcells(shape, windowed.K, ms)!r} Gcell/s; "
                  f"plain {plain_ms!r} ms = "
                  f"{gcells(shape, windowed.K, plain_ms)!r} Gcell/s "
                  f"[{card}]", flush=True)
    snap_ms = time_snapshot(MAIN_SHAPE, 16)
    print(f"time snapshot {MAIN_SHAPE[0]}x{MAIN_SHAPE[1]} (clone + D2H to "
          f"pinned): {snap_ms!r} ms/image [{card}]")
    print(f"main path end to end: {e2e['gcells']!r} Gcell/s "
          f"({e2e['seconds'] / MAIN_IMAGES * 1e3!r} ms/image) [{card}]")
    if "hdf5_seconds" in e2e:
        print(f"simulate.main with HDF5: "
              f"{e2e['hdf5_seconds'] / MAIN_IMAGES * 1e3!r} ms/image, "
              f"set-up included [{card}]")
    print("nvidia-smi clocks.sm, power.draw, power.limit, temperature: "
          f"{gpu.nvidia_smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")

    if checks.failures:
        print(f"chip_smoke: {len(checks.failures)} check(s) failed: "
              f"{checks.failures}", file=sys.stderr)
        return 1
    ms, plain_ms = timings[MAIN_SHAPE, "naive"]
    print(card)
    print(json.dumps({"kernels": [dict(
        KERNEL, launches=e2e["launches"], max_abs_err=checks.kernel_err,
        ms=ms, plain_ms=plain_ms)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
