#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA GPU, and check them.

    python3 chip_smoke.py [--seed N]

1. Prints the environment: PyTorch and its CUDA, the card, its power limit
   (nvidia-smi) and nvcc.
2. Builds the kernels from ``grayscott_tpu_torch/csrc/`` into
   ``build/kernels/`` and prints the build time and ptxas's report.
3. Holds each kernel against its plain PyTorch version on the card at
   1080x1920, 1000x1917 (ragged against the 32x32 tiles) and 4096x4096,
   both boundaries: K1 (windowed) at 1 and 8 steps a launch and 32 steps
   through the backend, K3 (resident) at 1, 27 and 32 steps in one launch,
   K2 (mega) at 8, 27 and 32 steps through the backend (one time block;
   three and a remainder launch; four); K1 also with the other stencils
   and dt = 0.5.
4. Runs the default ``simulate`` run (1080x1920, naive boundary,
   Oono-Puri, float32) through ``cli.simulate.run`` for 16 images of 32
   steps on the engine that ``auto`` picks, then with ``--pallas-engine
   windowed``, ``--pallas-resident on`` and ``--pallas-engine mega``. Each
   run starts with every launch count at 0 and reads them after; every
   frame is held against a replay of the plain version. Then a small
   domain against the plain version on the CPU, and ``simulate.main``
   writing HDF5 when h5py is installed.
5. Runs the bench path at full size: ``bench.headline.measure`` for the
   4096x4096 x 1000-step zero and naive rows on the ``auto`` engine, then
   one fresh 1000-step run on the mega engine for each boundary, held
   against a 1000-step plain replay on the card.
6. Times each engine at 1080x1920 and 4096x4096 for both boundaries (the
   times the engine choice ``backends.cuda.auto_engine`` is set from), K1
   and its plain version at K = 8, K3's 32-step launch and its plain
   version, and the snapshot copy of the main path; each beside the card's
   bound for the same work.
7. Prints the nvidia-smi line, one JSON line on the kernels, and last the
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

from grayscott_tpu_torch.backends import cuda as cuda_backend
from grayscott_tpu_torch.backends.cuda import CudaSimulation
from grayscott_tpu_torch.bench import headline
from grayscott_tpu_torch.cli import shared, simulate
from grayscott_tpu_torch.ops import build, megakernel, resident, stencil, windowed
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
BENCH_SHAPE = (4096, 4096)
MAIN_IMAGES, MAIN_STEPS = 16, 32
BENCH_STEPS = 1000

#: NVIDIA's data sheet for the H100 SXM at its 700 W limit: HBM3 bytes/s
#: and float32 operations/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12

#: the kernels' wrapper modules, by engine
MODULES = {"windowed": windowed, "resident": resident, "mega": megakernel}

KERNELS = {
    "windowed": {
        "name": "windowed_multistep",
        "route": "cuda",
        "source": "grayscott_tpu_torch/csrc/windowed.cu",
        "replaces": "grayscott_tpu/ops/pallas_stencil.py:929",
    },
    "resident": {
        "name": "resident_multistep",
        "route": "cuda",
        "source": "grayscott_tpu_torch/csrc/resident.cu",
        "replaces": "grayscott_tpu/ops/pallas_stencil.py:1312",
    },
    "mega": {
        "name": "mega_multistep",
        "route": "cuda",
        "source": "grayscott_tpu_torch/csrc/mega.cu",
        "replaces": "grayscott_tpu/ops/megakernel.py:81",
    },
}


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a - b).abs().max().item()


def gcells(shape, steps: int, ms: float) -> float:
    return shape[0] * shape[1] * steps / (ms * 1e-3) / 1e9


def ops_per_cell_step(params: Parameters, boundary: str) -> int:
    """float32 operations of one cell-step as the kernels compute it: a
    subtract, a multiply and an add for each tap (the taps of nonzero
    weight, and the centre on the naive path), twice, and 15 in the
    reaction and the update."""
    w = params.weights_array()
    taps = int(np.count_nonzero(w))
    if boundary == "naive" and w[1, 1] == 0.0:
        taps += 1
    return 2 * 3 * taps + 15


def bound_ms(shape, steps: int, boundary: str,
             params: Parameters = Parameters()) -> tuple[float, str]:
    """The least time the card could take to advance ``shape`` by
    ``steps`` steps in one call: U and V read once and written once, and
    the operations at the float32 peak. Returns (ms, what bounds it)."""
    cells = shape[0] * shape[1]
    by_bytes = 16 * cells / PEAK_BYTES
    by_ops = cells * steps * ops_per_cell_step(params, boundary) / PEAK_F32
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations")


def reset_launches() -> None:
    for module in MODULES.values():
        module.launches = 0


def read_launches() -> dict:
    return {engine: module.launches for engine, module in MODULES.items()}


class Checks:
    def __init__(self):
        self.failures: list[str] = []
        self.kernel_err = {engine: 0.0 for engine in MODULES}

    def expect(self, ok: bool, what: str) -> None:
        if not ok:
            self.failures.append(what)
            print(f"FAILED: {what}", flush=True)

    def compare(self, engine: str, got, want, what: str) -> None:
        errs = [max_err(g, w) for g, w in zip(got, want)]
        self.kernel_err[engine] = max(self.kernel_err[engine], *errs)
        print(f"compare {engine} {what}: max|dU|={errs[0]!r} "
              f"max|dV|={errs[1]!r}", flush=True)
        self.expect(max(errs) <= TOL, f"{engine} vs plain {what}")


def engine_run(engine: str, params: Parameters, boundary: str, u_np, v_np,
               steps: int):
    """The backend's state after ``steps`` steps on ``engine``."""
    sim = CudaSimulation(params, boundary, device=DEVICE,
                         **engine_pins(engine))
    storage = sim.build_storage(u_np, v_np)
    storage = sim.run_steps(storage, u_np.shape, steps)
    return sim.extract_uv(storage, u_np.shape)


def compare_kernels(checks: Checks, rng) -> None:
    """Phase 3: every kernel against the plain version on the card."""
    default = Parameters()
    consts = kernel_constants(default)
    for shape in SHAPES:
        u_np = rng.uniform(0.0, 1.0, shape).astype(np.float32)
        v_np = rng.uniform(0.0, 1.0, shape).astype(np.float32)
        u0 = torch.from_numpy(u_np).to(DEVICE)
        v0 = torch.from_numpy(v_np).to(DEVICE)
        for boundary in ("naive", "zero"):
            # the plain states after 1, 8, 27 and 32 steps, one replay
            plain, u, v, done = {}, u0, v0, 0
            for n in (1, 8, 27, 32):
                u, v = stencil.run(u, v, n - done, consts, boundary)
                plain[n], done = (u, v), n
            tag = f"{shape[0]}x{shape[1]} {boundary}"
            for steps in (1, 8):
                ku, kv = torch.empty_like(u0), torch.empty_like(v0)
                windowed.multistep(u0, v0, ku, kv, steps, consts, boundary)
                checks.compare("windowed", (ku, kv), plain[steps],
                               f"{tag} steps={steps} (one launch)")
            checks.compare("windowed", engine_run(
                "windowed", default, boundary, u_np, v_np, 32), plain[32],
                f"{tag} steps=32 (backend)")
            for steps in (1, 27, 32):
                out = resident.multistep(u0.clone(), v0.clone(),
                                         torch.empty_like(u0),
                                         torch.empty_like(v0), steps,
                                         consts, boundary)
                checks.compare("resident", out[:2], plain[steps],
                               f"{tag} steps={steps} (one launch)")
            for steps in (8, 27, 32):
                checks.compare("mega", engine_run(
                    "mega", default, boundary, u_np, v_np, steps),
                    plain[steps], f"{tag} steps={steps} (backend)")
    # K1 with the other stencils and a time step, on the ragged shape
    shape = SHAPES[1]
    u_np = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    v_np = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    u0, v0 = (torch.from_numpy(x).to(DEVICE) for x in (u_np, v_np))
    for label, params in (("5points", Parameters.with_stencil("5points")),
                          ("pretty", Parameters.with_stencil("pretty")),
                          ("patra-karttunen",
                           Parameters.with_stencil("patra-karttunen")),
                          ("dt=0.5", Parameters(time_step=0.5))):
        consts = kernel_constants(params)
        for boundary in ("naive", "zero"):
            ku, kv = torch.empty_like(u0), torch.empty_like(v0)
            windowed.multistep(u0, v0, ku, kv, 8, consts, boundary)
            want = stencil.run(u0, v0, 8, consts, boundary)
            checks.compare("windowed", (ku, kv), want,
                           f"{shape[0]}x{shape[1]} {boundary} "
                           f"params={label} steps=8")


def replay_frames(shape, boundary, params, images, steps, device):
    """V after each batch, from the plain version on ``device``."""
    consts = kernel_constants(params)
    u, v = (torch.from_numpy(x).to(device) for x in initial_uv(shape))
    frames = []
    for _ in range(images):
        u, v = stencil.run(u, v, steps, consts, boundary)
        frames.append(v)
    return frames


def expected_launches(engine: str, images: int, steps: int) -> int:
    if engine == "windowed":
        return images * -(-steps // windowed.K)
    if engine == "resident":
        return images
    n_full, rem = divmod(steps, megakernel.MEGA_STEPS)
    return images * ((n_full > 0) + (rem > 0))


def simulate_path(checks: Checks, flags: list, replay) -> dict:
    """One default ``simulate`` run (with ``flags``) of MAIN_IMAGES images
    through ``simulate.run``, with the launch counts zeroed before it and
    read after; every frame against ``replay``."""
    ns = simulate.build_parser().parse_args(flags)
    sim = shared.make_simulation(ns)
    species = sim.make_species(shared.domain_shape(ns))
    engine = species.storage[0]
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
    reset_launches()
    t0 = time.perf_counter()
    simulate.run(sim, species, MAIN_IMAGES, MAIN_STEPS, frames.append)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    want = {e: 0 for e in MODULES}
    want[engine] = expected_launches(engine, MAIN_IMAGES, MAIN_STEPS)
    label = " ".join(flags) or "(auto)"
    print(f"path simulate {label}: engine {engine}, {MAIN_IMAGES} images x "
          f"{MAIN_STEPS} steps at {MAIN_SHAPE[0]}x{MAIN_SHAPE[1]} naive: "
          f"{seconds!r} s, launches {launches} (expected {want})",
          flush=True)
    checks.expect(launches == want and launches[engine] > 0,
                  f"simulate {label}: launches {launches}, not {want}")
    checks.expect(len(frames) == MAIN_IMAGES
                  and all(f.shape == MAIN_SHAPE and f.dtype == np.float32
                          and np.isfinite(f).all() for f in frames),
                  f"simulate {label}: frame count, shape, dtype or "
                  "finiteness")
    errs = [float(np.abs(f - r.cpu().numpy()).max())
            for f, r in zip(frames, replay)]
    checks.kernel_err[engine] = max(checks.kernel_err[engine], *errs)
    print(f"path simulate {label} vs plain replay on the card, max|dV| per "
          f"frame: {errs}", flush=True)
    checks.expect(max(errs) <= TOL, f"simulate {label} vs plain replay")
    return {"engine": engine, "seconds": seconds, "launches": launches,
            "frames": frames,
            "gcells": MAIN_SHAPE[0] * MAIN_SHAPE[1] * MAIN_IMAGES
            * MAIN_STEPS / seconds / 1e9}


def main_paths(checks: Checks) -> dict:
    """Phase 4: the default run on the auto engine and on each pin."""
    ns = simulate.build_parser().parse_args([])  # the default user run
    checks.expect((ns.nbrow, ns.nbcol, ns.boundary, ns.device)
                  == (*MAIN_SHAPE, "naive", DEVICE), "default simulate args")
    replay = replay_frames(MAIN_SHAPE, "naive", shared.simulation_parameters(
        ns), MAIN_IMAGES, MAIN_STEPS, DEVICE)
    runs = {}
    for flags in ([], ["--pallas-engine", "windowed"],
                  ["--pallas-resident", "on"], ["--pallas-engine", "mega"]):
        runs[" ".join(flags) or "auto"] = simulate_path(checks, flags, replay)
    auto = runs["auto"]
    print(f"main path final frame: V in [{float(auto['frames'][-1].min())!r}"
          f", {float(auto['frames'][-1].max())!r}], sum "
          f"{float(auto['frames'][-1].sum())!r}")

    # a small ragged domain, both boundaries, 9 steps an image (one full
    # and one remainder launch), each engine, against the plain version on
    # the CPU, which the CPU tests hold bitwise to the numpy oracle
    for boundary in ("naive", "zero"):
        want = replay_frames((70, 97), boundary, Parameters(), 3, 9, "cpu")
        for flags in ([], ["--pallas-engine", "windowed"],
                      ["--pallas-resident", "on"],
                      ["--pallas-engine", "mega"]):
            small = simulate.build_parser().parse_args(
                ["-r", "70", "-c", "97", "--boundary", boundary, *flags])
            sim_s = shared.make_simulation(small)
            sp = sim_s.make_species(shared.domain_shape(small))
            got: list[np.ndarray] = []
            simulate.run(sim_s, sp, 3, 9, got.append)
            err = max(float(np.abs(g - w.numpy()).max())
                      for g, w in zip(got, want))
            print(f"small 70x97 {boundary} {sp.storage[0]}, 3 images x 9 "
                  f"steps, vs plain on the CPU: max|dV|={err!r}", flush=True)
            checks.expect(err <= TOL, f"small {boundary} {flags} vs plain "
                          "on the CPU")

    if importlib.util.find_spec("h5py") is None:
        print("simulate.main: not run (h5py is not installed); "
              "simulate.run ran with an in-memory sink")
        return runs
    import h5py

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "output.h5")
        reset_launches()
        t0 = time.perf_counter()
        rc = simulate.main(["-n", str(MAIN_IMAGES), "-o", out])
        h5_seconds = time.perf_counter() - t0
        launches = read_launches()
        with h5py.File(out, "r") as f:
            written = f["matrix"][:]
    print(f"simulate.main ran and wrote HDF5: rc={rc}, {h5_seconds!r} s, "
          f"launches {launches}", flush=True)
    checks.expect(rc == 0 and launches == auto["launches"], "simulate.main")
    checks.expect(written.shape == (MAIN_IMAGES, *MAIN_SHAPE)
                  and np.array_equal(written[-1], auto["frames"][-1]),
                  "simulate.main HDF5 frames vs simulate.run")
    auto["hdf5_seconds"] = h5_seconds
    return runs


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of ``fn()`` on the card over ``reps`` calls after one
    warm-up, from CUDA events around the whole run."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bench_path(checks: Checks, card: str) -> dict:
    """Phase 5: the headline rows, and 1000-step mega runs checked."""
    reset_launches()
    rows = {b: headline.measure(*BENCH_SHAPE, BENCH_STEPS, boundary=b,
                                device=DEVICE)
            for b in ("zero", "naive")}
    launches = read_launches()
    engines = {b: cuda_backend.auto_engine(BENCH_SHAPE, b)
               for b in ("zero", "naive")}
    print(f"path bench.headline {BENCH_SHAPE[0]}x{BENCH_SHAPE[1]} x "
          f"{BENCH_STEPS} steps: engines {engines}, launches {launches} "
          f"[{card}]", flush=True)
    for engine in engines.values():
        checks.expect(launches[engine] > 0,
                      f"bench path launched {engine} no time")
    line = headline.headline(rows["zero"], rows["naive"], BENCH_SHAPE,
                             BENCH_STEPS, DEVICE)
    print(f"headline {json.dumps(line)}", flush=True)

    result = {"launches": launches}
    default = Parameters()
    consts = kernel_constants(default)
    u_np, v_np = initial_uv(BENCH_SHAPE)
    for boundary in ("naive", "zero"):
        sim = CudaSimulation(default, boundary, device=DEVICE, engine="mega")
        storage = sim.build_storage(u_np, v_np)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        reset_launches()
        start.record()
        storage = sim.run_steps(storage, BENCH_SHAPE, BENCH_STEPS)
        end.record()
        end.synchronize()
        mega_launches = read_launches()["mega"]
        ms = start.elapsed_time(end)
        u0, v0 = (torch.from_numpy(x).to(DEVICE) for x in (u_np, v_np))
        start.record()
        ru, rv = stencil.run(u0, v0, BENCH_STEPS, consts, boundary)
        end.record()
        end.synchronize()
        plain_ms = start.elapsed_time(end)
        checks.compare("mega", sim.extract_uv(storage, BENCH_SHAPE),
                       (ru, rv), f"{BENCH_SHAPE[0]}x{BENCH_SHAPE[1]} "
                       f"{boundary} steps={BENCH_STEPS} (one launch)")
        checks.expect(mega_launches == 1,
                      f"1000-step mega run made {mega_launches} launches")
        print(f"time mega {BENCH_SHAPE[0]}x{BENCH_SHAPE[1]} {boundary} "
              f"{BENCH_STEPS} steps in one launch: {ms!r} ms = "
              f"{gcells(BENCH_SHAPE, BENCH_STEPS, ms)!r} Gcell/s; plain "
              f"replay {plain_ms!r} ms [{card}]", flush=True)
        result[boundary] = (ms, plain_ms)
    return result


def engine_pins(engine: str) -> dict:
    """The backend knobs that pin ``engine``."""
    return {"resident": "on"} if engine == "resident" else {"engine": engine}


def time_engines(rng, card: str) -> dict:
    """Phase 6a: each engine through the backend, 32 steps a call, timed
    in turns (windowed, resident, mega, mega, resident, windowed) and
    averaged, so that a drift of the card's clock favours none."""
    times = {}
    for shape, reps in ((MAIN_SHAPE, 40), (BENCH_SHAPE, 8)):
        u_np = rng.uniform(0, 1, shape).astype(np.float32)
        v_np = rng.uniform(0, 1, shape).astype(np.float32)
        for boundary in ("naive", "zero"):
            samples = {engine: [] for engine in MODULES}
            for engine in [*MODULES, *reversed(MODULES)]:
                sim = CudaSimulation(Parameters(), boundary, device=DEVICE,
                                     **engine_pins(engine))
                box = [sim.build_storage(u_np, v_np)]

                def call():
                    box[0] = sim.run_steps(box[0], shape, MAIN_STEPS)

                samples[engine].append(cuda_ms(call, reps))
            bound, by = bound_ms(shape, MAIN_STEPS, boundary)
            for engine, pair in samples.items():
                ms = sum(pair) / len(pair)
                times[shape, boundary, engine] = ms
                print(f"time engine {engine} {shape[0]}x{shape[1]} "
                      f"{boundary}, {MAIN_STEPS} steps a call: {ms!r} ms "
                      f"(turns {pair!r}) = "
                      f"{gcells(shape, MAIN_STEPS, ms)!r} Gcell/s; bound "
                      f"{bound!r} ms ({by}) [{card}]", flush=True)
            ranked = sorted(MODULES, key=lambda e: times[shape, boundary, e])
            print(f"engines {shape[0]}x{shape[1]} {boundary} "
                  f"({cuda_backend.shape_class(shape)}), fastest first: "
                  f"{ranked}; auto picks "
                  f"{cuda_backend.auto_engine(shape, boundary)}", flush=True)
    return times


def time_snapshot(shape, reps: int) -> float:
    """ms of the main path's per-image snapshot: a device clone of V and
    its non-blocking copy into pinned host memory."""
    v = torch.zeros(shape, device=DEVICE)
    host = torch.empty(shape, pin_memory=True)
    return cuda_ms(lambda: host.copy_(v.clone(), non_blocking=True), reps)


def time_kernels(rng, card: str) -> dict:
    """Phase 6b: K1 (one K-step launch) and K3 (one 32-step launch) and
    their plain versions at the main path's shape."""
    consts = kernel_constants(Parameters())
    out = {}
    for shape in (MAIN_SHAPE, BENCH_SHAPE):
        u, v = (torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32))
                .to(DEVICE) for _ in range(2))
        bufs = [u, v, torch.empty_like(u), torch.empty_like(v)]
        for boundary in ("naive", "zero"):
            def k1():
                windowed.multistep(*bufs, windowed.K, consts, boundary)

            def k3():
                bufs[:] = resident.multistep(*bufs, MAIN_STEPS, consts,
                                             boundary)

            for engine, fn, steps in (("windowed", k1, windowed.K),
                                      ("resident", k3, MAIN_STEPS)):
                reps = 100 if shape == MAIN_SHAPE else 20
                ms = cuda_ms(fn, reps // (steps // windowed.K))
                plain_ms = cuda_ms(
                    lambda: stencil.run(u, v, steps, consts, boundary),
                    2 if shape == MAIN_SHAPE else 1)
                bound, by = bound_ms(shape, steps, boundary)
                out[engine, shape, boundary] = (ms, plain_ms, bound, by,
                                                steps)
                print(f"time {engine} {shape[0]}x{shape[1]} {boundary}, "
                      f"{steps} steps a launch: kernel {ms!r} ms = "
                      f"{gcells(shape, steps, ms)!r} Gcell/s; plain "
                      f"{plain_ms!r} ms = "
                      f"{gcells(shape, steps, plain_ms)!r} Gcell/s; bound "
                      f"{bound!r} ms ({by}), {100 * bound / ms!r} % of it "
                      f"[{card}]", flush=True)
    return out


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
    t_start = time.perf_counter()

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
    print(f"co-resident blocks: resident {resident.max_blocks(torch.device(DEVICE))}, "
          f"mega {megakernel.max_blocks(torch.device(DEVICE))}", flush=True)

    # 3. every kernel vs its plain version
    compare_kernels(checks, rng)

    # 4. the default simulate run, on auto and on each pin
    runs = main_paths(checks)

    # 5. the bench path
    bench = bench_path(checks, card)

    # 6. times, beside the card
    print(f"timing on {card}")
    time_engines(rng, card)
    kernel_times = time_kernels(rng, card)
    snap_ms = time_snapshot(MAIN_SHAPE, 16)
    print(f"time snapshot {MAIN_SHAPE[0]}x{MAIN_SHAPE[1]} (clone + D2H to "
          f"pinned): {snap_ms!r} ms/image [{card}]")
    for label, run in runs.items():
        print(f"path simulate {label} end to end ({run['engine']}): "
              f"{run['gcells']!r} Gcell/s "
              f"({run['seconds'] / MAIN_IMAGES * 1e3!r} ms/image) [{card}]")
    if "hdf5_seconds" in runs["auto"]:
        print(f"simulate.main with HDF5: "
              f"{runs['auto']['hdf5_seconds'] / MAIN_IMAGES * 1e3!r} "
              f"ms/image, set-up included [{card}]")
    print("nvidia-smi clocks.sm, power.draw, power.limit, temperature: "
          f"{gpu.nvidia_smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")
    print(f"chip_smoke ran {time.perf_counter() - t_start!r} s", flush=True)

    if checks.failures:
        print(f"chip_smoke: {len(checks.failures)} check(s) failed: "
              f"{checks.failures}", file=sys.stderr)
        return 1
    entries = []
    for engine, path in (("windowed", "--pallas-engine windowed"),
                         ("resident", "--pallas-resident on")):
        ms, plain_ms, bound, by, steps = kernel_times[engine, MAIN_SHAPE,
                                                      "naive"]
        entries.append(dict(
            KERNELS[engine], launches=runs[path]["launches"][engine],
            max_abs_err=checks.kernel_err[engine], ms=ms, plain_ms=plain_ms,
            bound_ms=bound, bound_by=by, library_ms=None,
            shape=list(MAIN_SHAPE), steps=steps, boundary="naive"))
    ms, plain_ms = bench["naive"]
    bound, by = bound_ms(BENCH_SHAPE, BENCH_STEPS, "naive")
    entries.append(dict(
        KERNELS["mega"],
        launches=runs["--pallas-engine mega"]["launches"]["mega"],
        max_abs_err=checks.kernel_err["mega"], ms=ms, plain_ms=plain_ms,
        bound_ms=bound, bound_by=by, library_ms=None,
        shape=list(BENCH_SHAPE), steps=BENCH_STEPS, boundary="naive"))
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
