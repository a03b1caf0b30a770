#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA GPU, and check them.

    python3 chip_smoke.py [--seed N]

1. Prints the environment: PyTorch and its CUDA, the card, its power limit
   (nvidia-smi) and nvcc.
2. Builds the kernels from ``grayscott_tpu_torch/csrc/`` into
   ``build/kernels/`` and prints the build time, ptxas's report, each K1
   and K3 instantiation's registers, spills and static shared memory, and
   how many of their tiles at 1080x1920 and 4096x4096 are interior tiles.
3. Holds each kernel against its plain PyTorch version on the card at
   1080x1920, 1000x1917 (ragged against the tiles; rows not 16-byte
   aligned) and 4096x4096, both boundaries: K1 (windowed) at 1 and 8 steps
   a launch and 32 steps through the backend, K3 (resident) at 1, 27 and 32
   steps in one launch, K2 (mega) at 8, 27 and 32 steps through the
   backend (one time block; three and a remainder launch; four) and at 8
   steps against K1. K1 and K3 also at 1001x1920 and 40x40 (no interior
   tile), and with the other three stencils and dt = 0.5 at every shape
   but 4096x4096; and bit for bit on states that hold NaN and +-Inf.
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
   times the engine choice ``backends.cuda.auto_engine`` is set from); K1
   and K3 (on the Hopper tile stepper) in turns with K2 and K9 at split 1,
   which run the former code shapes of K1 and K3, 32 steps each, and with
   each part of their design taken out, and K1's and K3's plain versions;
   and the snapshot copy of the main path; each beside the card's bound
   for the same work.
7. The species-packed path (``--pallas-pack on``, zero boundary) at the
   same sizes: K4 (packed windowed: one launch of 1 and 8 steps, 32 steps
   through the backend), K5 (packed resident: one launch of 1, 27 and 32
   steps) and K6 (packed mega: 8, 27 and 32 steps through the backend)
   against the plain packed version on the card, also with the other
   separable stencils and dt = 0.5; ``simulate --boundary zero
   --pallas-pack on`` on ``auto`` and each pin (every frame against the
   plain packed replay, and against the unpacked zero run on K1: within
   2e-6 after the first image and 1e-4 after the last), the 70x97 domain
   against the CPU; one 4096x4096 x
   1000-step run on the packed ``auto`` engine against a plain replay;
   each packed engine timed beside K1 on the zero boundary (the times
   ``backends.cuda.auto_packed_engine`` is set from), and each packed
   kernel and its plain version.
8. Prints the nvidia-smi line, one JSON line on the nine kernels, and
   last the JSON line ``{"ok": true, "device": {...}}``.
9. The two microbenchmarks' kernels. K8 (``ops/oplat.py``, the chain of
   dependent operations) against its plain version at 1088x1920 and
   2176x3840, 4 steps of 15 and 45 ops, with and without rolls, on inputs
   in [0.5, 2), and at the entry point's call (1088x1920, 256 steps of 90
   ops, both forms; on ones too, without rolls, as it is timed); K9 (``ops/ilpsplit.py``, the row-split resident step)
   against its plain version on the same slabs and against K3, at the
   three shapes of phase 3, both boundaries, split 1, 2, 4 and 8, 1, 27
   and 32 steps in one launch. Then their entry points' sweeps, each with
   the launch counts zeroed before it and read after:
   ``scripts.oplat.sweep`` at 1088x1920, 256 steps of 15 and 90 ops, both
   forms; ``scripts.ilpsplit.sweep`` at 1080x1920 and 4096x4096, both
   boundaries, 32 steps, split 1, 2, 4 and 8 beside K3; each time beside
   the card's bound.
10. The sharded megakernel K7 (``ops/sharded_mega.py``; all shards on the
   one card, one launch). Through the sharded backend against its plain
   version on the card and against K2: 1080x1920 and 1000x1917 on meshes
   1x1, 2x1, 4x1 and 2x2 at 8, 27 and 32 steps, 1001x1920 (its last shards
   partly past the domain) on 4x1 and 2x2 at 27, 4096x4096 on 4x1 and 2x2
   at 32, both boundaries. ``simulate --backend sharded --sharded-engine
   mega --sharded-devices 4`` on the default run (16 images of 32 steps),
   on the default mesh (2x2 at this shape) and with ``--sharded-mesh-cols
   1`` and ``2``, each with the launch counts zeroed before it (16 K7
   launches and no other) and every frame against the plain replay of the
   unsharded run. K7's 32-step launch on 1x1, 4x1 and 2x2 timed in turns
   with K2 at 1080x1920 and 4096x4096, both boundaries, beside its bound;
   the backend's call (exchange and launch); each mesh's tile counts; the
   plain version once.

Phases 3-6 run the unpacked kernels K1-K3 and phase 7 the packed ones
(in the order 3, 7a, 4, 7b, 5, 7c, 6, 7d); phases 9 and 10 run after
them, before phase 8's lines. Every check runs; a failed one makes the script exit 1
without the two JSON lines. With no CUDA GPU visible it exits 1 at once.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import re
import sys
import tempfile
import time

import numpy as np
import torch

from grayscott_tpu_torch.backends import cuda as cuda_backend
from grayscott_tpu_torch.backends.cuda import CudaSimulation
from grayscott_tpu_torch.backends.sharded import ShardedSimulation
from grayscott_tpu_torch.bench import headline
from grayscott_tpu_torch.cli import shared, simulate
from grayscott_tpu_torch.ops import (build, ilpsplit, megakernel, oplat,
                                     packed, resident, sharded_mega, stencil,
                                     windowed)
from grayscott_tpu_torch.parallel import halo
from grayscott_tpu_torch.params import (Parameters, kernel_constants,
                                        packed_constants)
from grayscott_tpu_torch.scripts import ilpsplit as ilpsplit_script
from grayscott_tpu_torch.scripts import oplat as oplat_script
from grayscott_tpu_torch.species import initial_uv
from grayscott_tpu_torch.utils import device as gpu

#: kernel vs plain version, max |difference|: both run the same float32
#: expression tree with every operation rounded once (nvcc -fmad=false, no
#: flush to zero), so they agree bit for bit
TOL = 0.0

#: the card; every tensor of the checks lives there
DEVICE = "cuda"
SHAPES = [(1080, 1920), (1000, 1917), (4096, 4096)]
#: phase 3's shapes for K1 and K3 (on the Hopper tile stepper): SHAPES, a
#: last tile row of one row (1001x1920), and a domain with no interior tile
#: (40x40)
REDESIGNED_SHAPES = [(1080, 1920), (1000, 1917), (1001, 1920), (4096, 4096),
                     (40, 40)]
#: the stencils other than the default, and a time step
OTHER_PARAMS = [("5points", Parameters.with_stencil("5points")),
                ("pretty", Parameters.with_stencil("pretty")),
                ("patra-karttunen",
                 Parameters.with_stencil("patra-karttunen")),
                ("dt=0.5", Parameters(time_step=0.5))]
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

#: every kernel's launch counter, by its storage tag: (module, attribute)
COUNTERS = {
    "windowed": (windowed, "launches"),
    "resident": (resident, "launches"),
    "mega": (megakernel, "launches"),
    "packed": (packed, "launches"),
    "respack": (packed, "resident_launches"),
    "megapack": (megakernel, "packed_launches"),
    "oplat": (oplat, "launches"),
    "ilpsplit": (ilpsplit, "launches"),
    "shmega": (sharded_mega, "launches"),
}

#: storage tags that share another tag's kernel (K7 on a 2-D mesh)
KERNEL_OF = {"shmega2d": "shmega"}

#: K8's shapes (the TPU script's first and largest) and K9's splits
OPLAT_SHAPES = [(1088, 1920), (2176, 3840)]
SPLITS = (1, 2, 4, 8)

#: the flags that pin each packed engine on the command line
PACKED_FLAGS = {"packed": ["--pallas-engine", "windowed"],
                "respack": ["--pallas-resident", "on"],
                "megapack": ["--pallas-engine", "mega"]}
ZERO_PACKED = ["--boundary", "zero", "--pallas-pack", "on"]

#: packed frames against the unpacked zero run on K1 at 1080x1920, max|dV|:
#: the two trees round differently (the separable pass and the linear fold
#: against the oracle's 9 taps) and drift apart by a few ulp a step, more as
#: the pattern grows. The plain versions on the CPU give 8.0e-7 after the
#: first image (32 steps) and 5.0e-5 after the last (512 steps); the limits
#: are about twice that
PACK_VS_UNPACKED_FIRST = 2e-6
PACK_VS_UNPACKED_LAST = 1e-4

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
    "packed": {
        "name": "packed_multistep",
        "route": "cuda",
        "source": "grayscott_tpu_torch/csrc/packed.cu",
        "replaces": "grayscott_tpu/ops/pallas_stencil.py:1624",
    },
    "respack": {
        "name": "packed_resident_multistep",
        "route": "cuda",
        "source": "grayscott_tpu_torch/csrc/packed_resident.cu",
        "replaces": "grayscott_tpu/ops/pallas_stencil.py:1745",
    },
    "megapack": {
        "name": "packed_mega_multistep",
        "route": "cuda",
        "source": "grayscott_tpu_torch/csrc/packed_mega.cu",
        "replaces": "grayscott_tpu/ops/megakernel.py:1112",
    },
    "oplat": {
        "name": "oplat_chain",
        "route": "cuda",
        "source": "grayscott_tpu_torch/csrc/oplat.cu",
        "replaces": "scripts/oplat.py:36",
    },
    "ilpsplit": {
        "name": "ilpsplit_multistep",
        "route": "cuda",
        "source": "grayscott_tpu_torch/csrc/ilpsplit.cu",
        "replaces": "scripts/ilpsplit.py:43",
    },
    "shmega": {
        "name": "sharded_mega_multistep",
        "route": "cuda",
        "source": "grayscott_tpu_torch/csrc/sharded_mega.cu",
        "replaces": "grayscott_tpu/ops/megakernel.py:81 (sharded, "
                    "grayscott_tpu/parallel/halo.py:487)",
    },
}

#: K7's meshes (rows, cols), and the flags of its simulate runs: the
#: default mesh of 4 shards (2x2 at 1080x1920: halo.choose_mesh_cols), and
#: each form pinned
SHARDED_MESHES = [(1, 1), (2, 1), (4, 1), (2, 2)]
#: 1001 rows in 4 shards of 256 (or 2 of 504): the last row of shards
#: reaches past the domain
PAST_EDGE_SHAPE = (1001, 1920)
SHARDED_FLAGS = ["--backend", "sharded", "--sharded-engine", "mega",
                 "--sharded-devices", "4"]
SHARDED_PATHS = [[], ["--sharded-mesh-cols", "1"],
                 ["--sharded-mesh-cols", "2"]]


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


def roofline_ms(shape, steps: int, ops: int) -> tuple[float, str]:
    """The least time the card could take to advance ``shape`` by
    ``steps`` steps of ``ops`` float32 operations a cell-step in one call:
    U and V read once and written once, and the operations at the float32
    peak. Returns (ms, what bounds it)."""
    cells = shape[0] * shape[1]
    by_bytes = 16 * cells / PEAK_BYTES
    by_ops = cells * steps * ops / PEAK_F32
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations")


def bound_ms(shape, steps: int, boundary: str,
             params: Parameters = Parameters()) -> tuple[float, str]:
    """:func:`roofline_ms` of the oracle's tree (K1-K3)."""
    return roofline_ms(shape, steps, ops_per_cell_step(params, boundary))


#: float32 operations of one cell-step of the species-packed step, both
#: species, for every separable stencil (ops/packed.py:packed_step): 4 in
#: each pass of the separable convolution, for two passes and two species,
#: 2 for uv^2, and 6 in each update (the V update's + 0.0 included)
PACKED_OPS = 2 * 2 * 4 + 2 + 2 * 6


def oplat_bound_ms(shape, steps: int, n_ops: int,
                   rolls: bool) -> tuple[float, str]:
    """The least time the card could take for one K8 call: the array read
    once and written once (8 B a cell), and 2 operations a fused
    multiply-add at the float32 peak; rolls add no operations."""
    by_bytes = 8 * shape[0] * shape[1] / PEAK_BYTES
    by_ops = 2 * oplat.fmas(shape, steps, n_ops, rolls) / PEAK_F32
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations")


def reset_launches() -> None:
    for module, attr in COUNTERS.values():
        setattr(module, attr, 0)


def read_launches() -> dict:
    return {tag: getattr(module, attr)
            for tag, (module, attr) in COUNTERS.items()}


class Checks:
    def __init__(self):
        self.failures: list[str] = []
        self.kernel_err = {tag: 0.0 for tag in COUNTERS}

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

    def compare_bits(self, engine: str, got, want, what: str) -> None:
        """Bit for bit, NaN included: max|d| is 0.0 when every bit agrees,
        else inf."""
        same = all(torch.equal(g.view(torch.int32), w.view(torch.int32))
                   for g, w in zip(got, want))
        err = 0.0 if same else float("inf")
        self.kernel_err[engine] = max(self.kernel_err[engine], err)
        print(f"compare {engine} {what}: bitwise {same}", flush=True)
        self.expect(same, f"{engine} vs plain {what}")

    def compare_one(self, engine: str, got, want, what: str) -> None:
        err = max_err(got, want)
        self.kernel_err[engine] = max(self.kernel_err[engine], err)
        print(f"compare {engine} {what}: max|d|={err!r}", flush=True)
        self.expect(err <= TOL, f"{engine} vs plain {what}")


def engine_run(engine: str, params: Parameters, boundary: str, u_np, v_np,
               steps: int, pack: str = "auto"):
    """The backend's state after ``steps`` steps on ``engine``."""
    sim = CudaSimulation(params, boundary, device=DEVICE, pack=pack,
                         **engine_pins(engine))
    storage = sim.build_storage(u_np, v_np)
    storage = sim.run_steps(storage, u_np.shape, steps)
    return sim.extract_uv(storage, u_np.shape)


def compare_kernels(checks: Checks, rng) -> None:
    """Phase 3: every kernel against the plain version on the card."""
    default = Parameters()
    consts = kernel_constants(default)
    for shape in REDESIGNED_SHAPES:
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
            k1 = {}
            for steps in (1, 8):
                ku, kv = torch.empty_like(u0), torch.empty_like(v0)
                windowed.multistep(u0, v0, ku, kv, steps, consts, boundary)
                k1[steps] = (ku, kv)
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
            if shape not in SHAPES:
                continue
            for steps in (8, 27, 32):
                got = engine_run("mega", default, boundary, u_np, v_np,
                                 steps)
                checks.compare("mega", got, plain[steps],
                               f"{tag} steps={steps} (backend)")
                if steps == 8:  # K2 (the first stepper) against K1
                    checks.compare("mega", got, k1[8],
                                   f"{tag} steps=8 (backend) vs K1")
    # K1 and K3 with the other stencils and a time step
    for shape in REDESIGNED_SHAPES:
        if shape == BENCH_SHAPE:
            continue
        u0, v0 = (torch.from_numpy(rng.uniform(0.0, 1.0, shape)
                                   .astype(np.float32)).to(DEVICE)
                  for _ in range(2))
        for label, params in OTHER_PARAMS:
            consts = kernel_constants(params)
            for boundary in ("naive", "zero"):
                want = stencil.run(u0, v0, 8, consts, boundary)
                what = (f"{shape[0]}x{shape[1]} {boundary} params={label} "
                        "steps=8 (one launch)")
                ku, kv = torch.empty_like(u0), torch.empty_like(v0)
                windowed.multistep(u0, v0, ku, kv, 8, consts, boundary)
                checks.compare("windowed", (ku, kv), want, what)
                out = resident.multistep(u0.clone(), v0.clone(),
                                         torch.empty_like(u0),
                                         torch.empty_like(v0), 8, consts,
                                         boundary)
                checks.compare("resident", out[:2], want, what)
    # states that hold NaN and +-Inf, in interior and edge tiles and on the
    # domain's edge: held bit for bit
    for shape in ((200, 300), MAIN_SHAPE):
        u0, v0 = (torch.from_numpy(rng.uniform(0.0, 1.0, shape)
                                   .astype(np.float32)).to(DEVICE)
                  for _ in range(2))
        u0[100, 150] = v0[0, 5] = float("nan")
        v0[90, 140] = u0[70, 200] = float("inf")
        u0[120, 7] = v0[-1, -1] = float("-inf")
        for label, params in (("oono-puri", default), *OTHER_PARAMS):
            consts = kernel_constants(params)
            for boundary in ("naive", "zero"):
                want = stencil.run(u0, v0, 3, consts, boundary)
                what = (f"{shape[0]}x{shape[1]} {boundary} params={label} "
                        "NaN and Inf, steps=3 (one launch)")
                ku, kv = torch.empty_like(u0), torch.empty_like(v0)
                windowed.multistep(u0, v0, ku, kv, 3, consts, boundary)
                checks.compare_bits("windowed", (ku, kv), want, what)
                out = resident.multistep(u0.clone(), v0.clone(),
                                         torch.empty_like(u0),
                                         torch.empty_like(v0), 3, consts,
                                         boundary)
                checks.compare_bits("resident", out[:2], want, what)


def compare_packed_kernels(checks: Checks, rng) -> None:
    """Phase 3b: K4, K5 and K6 against the plain packed version on the
    card, zero boundary."""
    default = Parameters()
    pc = packed_constants(default)

    def compare(tag, got, want, what):
        c = want.shape[-1] // 2
        checks.compare(tag, packed.unpack_state(got, c),
                       packed.unpack_state(want, c), what)

    for shape in SHAPES:
        u_np = rng.uniform(0.0, 1.0, shape).astype(np.float32)
        v_np = rng.uniform(0.0, 1.0, shape).astype(np.float32)
        x0 = packed.pack_state(*(torch.from_numpy(a).to(DEVICE)
                                 for a in (u_np, v_np)))
        plain, x, done = {}, x0, 0
        for n in (1, 8, 27, 32):
            x = packed.packed_run(x, n - done, pc)
            plain[n], done = x, n
        tag = f"{shape[0]}x{shape[1]} zero packed"
        for steps in (1, 8):
            out = torch.empty_like(x0)
            packed.multistep(x0, out, steps, pc)
            compare("packed", out, plain[steps],
                    f"{tag} steps={steps} (one launch)")
        checks.compare("packed", engine_run(
            "windowed", default, "zero", u_np, v_np, 32, pack="on"),
            packed.unpack_state(plain[32], shape[1]),
            f"{tag} steps=32 (backend)")
        for steps in (1, 27, 32):
            out = packed.resident_multistep(x0.clone(), torch.empty_like(x0),
                                            steps, pc)
            compare("respack", out[0], plain[steps],
                    f"{tag} steps={steps} (one launch)")
        for steps in (8, 27, 32):
            checks.compare("megapack", engine_run(
                "mega", default, "zero", u_np, v_np, steps, pack="on"),
                packed.unpack_state(plain[steps], shape[1]),
                f"{tag} steps={steps} (backend)")
    # the other separable stencils and a time step, on the ragged shape
    shape = SHAPES[1]
    u_np = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    v_np = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    x0 = packed.pack_state(*(torch.from_numpy(a).to(DEVICE)
                             for a in (u_np, v_np)))
    for label, params in (("pretty", Parameters.with_stencil("pretty")),
                          ("patra-karttunen",
                           Parameters.with_stencil("patra-karttunen")),
                          ("dt=0.5", Parameters(time_step=0.5))):
        pc = packed_constants(params)
        tag = f"{shape[0]}x{shape[1]} zero packed params={label}"
        out = torch.empty_like(x0)
        packed.multistep(x0, out, 8, pc)
        compare("packed", out, packed.packed_run(x0, 8, pc),
                f"{tag} steps=8 (one launch)")
        want = packed.packed_run(x0, 27, pc)
        out = packed.resident_multistep(x0.clone(), torch.empty_like(x0), 27,
                                        pc)
        compare("respack", out[0], want, f"{tag} steps=27 (one launch)")
        checks.compare("megapack", engine_run(
            "mega", params, "zero", u_np, v_np, 27, pack="on"),
            packed.unpack_state(want, shape[1]), f"{tag} steps=27 (backend)")


def replay_frames(shape, boundary, params, images, steps, device):
    """V after each batch, from the plain version on ``device``."""
    consts = kernel_constants(params)
    u, v = (torch.from_numpy(x).to(device) for x in initial_uv(shape))
    frames = []
    for _ in range(images):
        u, v = stencil.run(u, v, steps, consts, boundary)
        frames.append(v)
    return frames


def replay_packed_frames(shape, params, images, steps, device):
    """V after each batch, from the plain packed version on ``device``."""
    pc = packed_constants(params)
    x = packed.pack_state(*(torch.from_numpy(a).to(device)
                            for a in initial_uv(shape)))
    frames = []
    for _ in range(images):
        x = packed.packed_run(x, steps, pc)
        frames.append(packed.unpack_state(x, shape[1])[1])
    return frames


def expected_launches(engine: str, images: int, steps: int) -> int:
    if engine in ("windowed", "packed"):
        return images * -(-steps // windowed.K)
    if engine in ("resident", "respack"):
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
    engine = KERNEL_OF.get(species.storage[0], species.storage[0])
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
    want = {tag: 0 for tag in COUNTERS}
    want[engine] = expected_launches(engine, MAIN_IMAGES, MAIN_STEPS)
    label = " ".join(flags) or "(auto)"
    print(f"path simulate {label}: engine {engine}, {MAIN_IMAGES} images x "
          f"{MAIN_STEPS} steps at {MAIN_SHAPE[0]}x{MAIN_SHAPE[1]} "
          f"{ns.boundary}: {seconds!r} s, launches {launches} (expected "
          f"{want})", flush=True)
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
            "frames": frames, "tag": species.storage[0],
            "mesh": getattr(getattr(sim, "mesh", None), "shape", None),
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


def packed_paths(checks: Checks) -> dict:
    """Phase 4b: ``simulate --boundary zero --pallas-pack on`` on the auto
    engine and on each pin, every frame against the plain packed replay;
    the last frame against the unpacked zero run on K1; a small domain
    against the plain packed version on the CPU."""
    params = Parameters()
    replay = replay_packed_frames(MAIN_SHAPE, params, MAIN_IMAGES,
                                  MAIN_STEPS, DEVICE)
    runs = {}
    for flags in ([], *PACKED_FLAGS.values()):
        runs[" ".join(flags) or "auto"] = simulate_path(
            checks, ZERO_PACKED + flags, replay)

    # the same run unpacked, on K1 (the oracle's tree)
    sim = CudaSimulation(params, "zero", device=DEVICE, engine="windowed")
    species = sim.make_species(MAIN_SHAPE)
    reset_launches()
    unpacked = []
    for _ in range(MAIN_IMAGES):
        sim.prepare_steps(species, MAIN_STEPS)
        unpacked.append(species.result().clone())
    k1 = read_launches()["windowed"]
    errs = [float(np.abs(f - w.cpu().numpy()).max())
            for f, w in zip(runs["auto"]["frames"], unpacked)]
    print(f"packed frames ({runs['auto']['engine']}) vs the unpacked zero "
          f"run on K1 ({k1} launches) at {MAIN_SHAPE[0]}x{MAIN_SHAPE[1]}, "
          f"max|dV| per frame: {errs} (limits: first "
          f"{PACK_VS_UNPACKED_FIRST!r}, last {PACK_VS_UNPACKED_LAST!r})",
          flush=True)
    checks.expect(k1 == expected_launches("windowed", MAIN_IMAGES,
                                          MAIN_STEPS), "unpacked K1 run")
    checks.expect(errs[0] <= PACK_VS_UNPACKED_FIRST
                  and errs[-1] <= PACK_VS_UNPACKED_LAST,
                  "packed vs unpacked zero run")
    runs["vs_unpacked"] = errs

    want = replay_packed_frames((70, 97), params, 3, 9, "cpu")
    for flags in ([], *PACKED_FLAGS.values()):
        small = simulate.build_parser().parse_args(
            ["-r", "70", "-c", "97", *ZERO_PACKED, *flags])
        sim_s = shared.make_simulation(small)
        sp = sim_s.make_species(shared.domain_shape(small))
        got: list[np.ndarray] = []
        simulate.run(sim_s, sp, 3, 9, got.append)
        err = max(float(np.abs(g - w.numpy()).max())
                  for g, w in zip(got, want))
        print(f"small 70x97 zero {sp.storage[0]}, 3 images x 9 steps, vs "
              f"plain packed on the CPU: max|dV|={err!r}", flush=True)
        checks.expect(err <= TOL, f"small packed {flags} vs plain on the "
                      "CPU")
    return runs


def packed_bench(checks: Checks, card: str) -> dict:
    """Phase 5b: one 4096x4096 x 1000-step run on the packed auto engine,
    against a 1000-step plain packed replay on the card."""
    params = Parameters()
    u_np, v_np = initial_uv(BENCH_SHAPE)
    sim = CudaSimulation(params, "zero", device=DEVICE, pack="on")
    storage = sim.build_storage(u_np, v_np)
    tag = storage[0]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    reset_launches()
    start.record()
    storage = sim.run_steps(storage, BENCH_SHAPE, BENCH_STEPS)
    end.record()
    end.synchronize()
    launches = read_launches()[tag]
    ms = start.elapsed_time(end)
    x = packed.pack_state(*(torch.from_numpy(a).to(DEVICE)
                            for a in (u_np, v_np)))
    start.record()
    x = packed.packed_run(x, BENCH_STEPS, packed_constants(params))
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    checks.compare(tag, sim.extract_uv(storage, BENCH_SHAPE),
                   packed.unpack_state(x, BENCH_SHAPE[1]),
                   f"{BENCH_SHAPE[0]}x{BENCH_SHAPE[1]} zero packed "
                   f"steps={BENCH_STEPS} (auto)")
    want = expected_launches(tag, 1, BENCH_STEPS)
    checks.expect(launches == want, f"1000-step packed {tag} run made "
                  f"{launches} launches, not {want}")
    print(f"time packed auto ({tag}) {BENCH_SHAPE[0]}x{BENCH_SHAPE[1]} "
          f"zero {BENCH_STEPS} steps, {launches} launches: {ms!r} ms = "
          f"{gcells(BENCH_SHAPE, BENCH_STEPS, ms)!r} Gcell/s; plain replay "
          f"{plain_ms!r} ms [{card}]", flush=True)
    return {"engine": tag, "ms": ms, "plain_ms": plain_ms,
            "launches": launches}


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of ``fn()`` on the card over ``reps`` calls after one
    warm-up, from CUDA events around the whole run."""
    return gpu.time_call(fn, DEVICE, reps, best_of=1) * 1e3


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


def time_packed_engines(rng, card: str) -> dict:
    """Phase 6c: each packed engine through the backend, 32 steps a call,
    beside K1 on the zero boundary, timed in turns (K1, K4, K5, K6, K6,
    K5, K4, K1) and averaged; the times ``auto_packed_engine`` is set
    from."""
    tags = cuda_backend.PACKED_TAGS
    order = ["windowed", *tags.values()]
    engine_of = {tag: engine for engine, tag in tags.items()}
    times = {}
    for shape, reps in ((MAIN_SHAPE, 40), (BENCH_SHAPE, 8)):
        u_np = rng.uniform(0, 1, shape).astype(np.float32)
        v_np = rng.uniform(0, 1, shape).astype(np.float32)
        samples = {tag: [] for tag in order}
        for tag in [*order, *reversed(order)]:
            if tag == "windowed":
                sim = CudaSimulation(Parameters(), "zero", device=DEVICE,
                                     engine="windowed")
            else:
                sim = CudaSimulation(Parameters(), "zero", device=DEVICE,
                                     pack="on",
                                     **engine_pins(engine_of[tag]))
            box = [sim.build_storage(u_np, v_np)]
            assert box[0][0] == tag

            def call():
                box[0] = sim.run_steps(box[0], shape, MAIN_STEPS)

            samples[tag].append(cuda_ms(call, reps))
        for tag, pair in samples.items():
            ms = sum(pair) / len(pair)
            times[shape, tag] = ms
            bound, by = (bound_ms(shape, MAIN_STEPS, "zero")
                         if tag == "windowed"
                         else roofline_ms(shape, MAIN_STEPS, PACKED_OPS))
            print(f"time engine {tag} {shape[0]}x{shape[1]} zero, "
                  f"{MAIN_STEPS} steps a call: {ms!r} ms (turns {pair!r}) "
                  f"= {gcells(shape, MAIN_STEPS, ms)!r} Gcell/s; bound "
                  f"{bound!r} ms ({by}) [{card}]", flush=True)
        ranked = sorted(tags, key=lambda e: times[shape, tags[e]])
        print(f"packed engines {shape[0]}x{shape[1]} "
              f"({cuda_backend.shape_class(shape)}), fastest first: "
              f"{ranked}; auto picks "
              f"{cuda_backend.auto_packed_engine(shape)}; K1 unpacked "
              f"{times[shape, 'windowed']!r} ms", flush=True)
    return times


def time_packed_kernels(rng, card: str) -> dict:
    """Phase 6d: K4 (one 8-step launch), K5 and K6 (one 32-step launch
    each) and the plain packed version of the same steps."""
    pc = packed_constants(Parameters())
    out = {}
    for shape in (MAIN_SHAPE, BENCH_SHAPE):
        x = packed.pack_state(*(
            torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32))
            .to(DEVICE) for _ in range(2)))
        bufs = [x.clone(), torch.empty_like(x)]
        pair = megakernel.pair_state(x)
        x_out = torch.empty_like(x)

        def k4():
            packed.multistep(x, x_out, packed.K, pc)

        def k5():
            bufs[:] = packed.resident_multistep(*bufs, MAIN_STEPS, pc)

        def k6():
            megakernel.packed_megastep(pair, MAIN_STEPS // 8, 8, pc)

        for tag, fn, steps in (("packed", k4, packed.K),
                               ("respack", k5, MAIN_STEPS),
                               ("megapack", k6, MAIN_STEPS)):
            reps = 100 if shape == MAIN_SHAPE else 20
            ms = cuda_ms(fn, reps // (steps // packed.K))
            plain_ms = cuda_ms(lambda: packed.packed_run(x, steps, pc),
                               2 if shape == MAIN_SHAPE else 1)
            bound, by = roofline_ms(shape, steps, PACKED_OPS)
            out[tag, shape] = (ms, plain_ms, bound, by, steps)
            print(f"time {tag} {shape[0]}x{shape[1]} zero, {steps} steps "
                  f"a launch: kernel {ms!r} ms = "
                  f"{gcells(shape, steps, ms)!r} Gcell/s; plain "
                  f"{plain_ms!r} ms = {gcells(shape, steps, plain_ms)!r} "
                  f"Gcell/s; bound {bound!r} ms ({by}), "
                  f"{100 * bound / ms!r} % of it [{card}]", flush=True)
    return out


def time_snapshot(shape, reps: int) -> float:
    """ms of the main path's per-image snapshot: a device clone of V and
    its non-blocking copy into pinned host memory."""
    v = torch.zeros(shape, device=DEVICE)
    host = torch.empty(shape, pin_memory=True)
    return cuda_ms(lambda: host.copy_(v.clone(), non_blocking=True), reps)


def time_kernels(checks: Checks, rng, card: str) -> dict:
    """Phase 6b: the redesigned K1 (four 8-step launches) and K3 (one
    32-step launch) timed in turns with the first stepper's code in K2 (one
    launch of 4 time blocks of 8 steps; K1's former code shape) and K9 at
    split 1 (K3's former code shape), 32 steps each (K1, K3, K2, K9, K9, K2,
    K3, K1), at 1080x1920 and 4096x4096, both boundaries; then each with
    one part of its design taken out (:func:`time_ablations`); then K1's
    and K3's plain versions. Each beside the card's bound for 32 steps."""
    consts = kernel_constants(Parameters())
    out = {}
    for shape, reps in ((MAIN_SHAPE, 40), (BENCH_SHAPE, 8)):
        u, v = (torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32))
                .to(DEVICE) for _ in range(2))
        for boundary in ("naive", "zero"):
            k1_bufs = [u, v, torch.empty_like(u), torch.empty_like(v)]
            k3_bufs = [u.clone(), v.clone(), torch.empty_like(u),
                       torch.empty_like(v)]
            k9_bufs = [u.clone(), v.clone(), torch.empty_like(u),
                       torch.empty_like(v)]
            pair_u, pair_v = megakernel.pair_state(u), megakernel.pair_state(v)

            def k1():
                for _ in range(MAIN_STEPS // windowed.K):
                    windowed.multistep(*k1_bufs, windowed.K, consts, boundary)
                    k1_bufs[:] = k1_bufs[2:] + k1_bufs[:2]

            def k3():
                k3_bufs[:] = resident.multistep(*k3_bufs, MAIN_STEPS, consts,
                                                boundary)

            def k2():
                megakernel.megastep(pair_u, pair_v, MAIN_STEPS // 8, 8,
                                    consts, boundary)

            def k9():
                k9_bufs[:] = ilpsplit.split_multistep(
                    *k9_bufs, MAIN_STEPS, consts, boundary, 1)

            calls = {"windowed": k1, "resident": k3, "mega": k2,
                     "ilpsplit": k9}
            samples = {name: [] for name in calls}
            for name in [*calls, *reversed(calls)]:
                samples[name].append(cuda_ms(calls[name], reps))
            bound, by = bound_ms(shape, MAIN_STEPS, boundary)
            ms = {name: sum(p) / len(p) for name, p in samples.items()}
            for name, pair in samples.items():
                out[name, shape, boundary, "ms32"] = ms[name]
                print(f"time {name} {shape[0]}x{shape[1]} {boundary}, "
                      f"{MAIN_STEPS} steps: {ms[name]!r} ms (turns "
                      f"{pair!r}) = {gcells(shape, MAIN_STEPS, ms[name])!r} "
                      f"Gcell/s; bound {bound!r} ms ({by}), "
                      f"{100 * bound / ms[name]!r} % of it [{card}]",
                      flush=True)
            print(f"redesigned {shape[0]}x{shape[1]} {boundary}: K1 "
                  f"{ms['mega'] / ms['windowed']!r}x faster than K2 (K1's "
                  f"former code shape), K3 "
                  f"{ms['ilpsplit'] / ms['resident']!r}x faster than K9 at "
                  f"split 1 (K3's former code shape) [{card}]", flush=True)
            time_ablations(checks, shape, boundary, u, v, reps, ms, card)
            for engine, steps in (("windowed", windowed.K),
                                  ("resident", MAIN_STEPS)):
                plain_ms = cuda_ms(
                    lambda: stencil.run(u, v, steps, consts, boundary),
                    2 if shape == MAIN_SHAPE else 1)
                kernel_ms = ms[engine] * steps / MAIN_STEPS
                bound, by = bound_ms(shape, steps, boundary)
                out[engine, shape, boundary] = (kernel_ms, plain_ms, bound,
                                                by, steps)
                print(f"time {engine} {shape[0]}x{shape[1]} {boundary}, "
                      f"{steps} steps a launch: kernel {kernel_ms!r} ms; "
                      f"plain {plain_ms!r} ms = "
                      f"{gcells(shape, steps, plain_ms)!r} Gcell/s; bound "
                      f"{bound!r} ms ({by}) [{card}]", flush=True)
    return out


#: the parts of K1's and K3's design that their ablation entries take out
#: (csrc/windowed.cu: gs_windowed_ablation, csrc/resident.cu:
#: gs_resident_ablation)
ABLATIONS = {
    "windowed": {1: "every tile an edge tile",
                 2: "the tap set tested at run time",
                 3: "32x32 tiles in 48x48 windows",
                 4: "32x128 tiles in 48x144 windows"},
    "resident": {1: "every tile an edge tile",
                 2: "the tap set tested at run time",
                 3: "no prefetch of the next window"},
}


def time_ablations(checks: Checks, shape, boundary: str, u, v, reps: int,
                   ms: dict, card: str) -> None:
    """Phase 6b's ablations: K1 (four 8-step launches) and K3 (one 32-step
    launch) of the default stencil, each with one part of its design taken
    out or with another tile shape (ABLATIONS), timed in turns with the
    whole kernel (whole, parts..., parts reversed, whole) and held bit for
    bit against it; each time also as a ratio to the whole kernel's (and
    beside phase 6b's, ``ms``)."""
    consts = kernel_constants(Parameters())
    naive = int(boundary == "naive")
    stream = torch.cuda.current_stream().cuda_stream
    floats = [ctypes.c_float] * 14
    k1_fn = build.bind("gs_windowed_ablation",
                       [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + floats
                       + [ctypes.c_void_p, ctypes.c_int])
    k3_fn = build.bind("gs_resident_ablation",
                       [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + floats
                       + [ctypes.c_int] + [ctypes.c_void_p] * 2
                       + [ctypes.c_int])
    barrier = torch.zeros(1, dtype=torch.int64, device=DEVICE)

    def k1(bufs, part, steps=windowed.K):
        if part is None:
            windowed.multistep(*bufs, steps, consts, boundary)
            return
        err = k1_fn(*(b.data_ptr() for b in bufs), *shape, steps, naive,
                    u.device.index or 0, *consts.weights, *consts.reaction,
                    stream, part)
        if err:
            raise RuntimeError(f"K1 ablation {part}: CUDA error {err} "
                               f"({build.error_name(err)})")

    def k3(bufs, part, steps=MAIN_STEPS):
        if part is None:
            return resident.multistep(*bufs, steps, consts, boundary)
        barrier.zero_()
        err = k3_fn(*(b.data_ptr() for b in bufs), *shape, steps, naive,
                    u.device.index or 0, *consts.weights, *consts.reaction,
                    0, barrier.data_ptr(), stream, part)
        if err:
            raise RuntimeError(f"K3 ablation {part}: CUDA error {err} "
                               f"({build.error_name(err)})")
        return bufs if steps % 2 == 0 else (*bufs[2:], *bufs[:2])

    for engine, run in (("windowed", k1), ("resident", k3)):
        parts = [None, *ABLATIONS[engine]]
        bufs = {p: [u.clone(), v.clone(), torch.empty_like(u),
                    torch.empty_like(v)] for p in parts}
        want = None
        for part in parts:  # one launch of 8 steps, held against the whole
            b = [u.clone(), v.clone(), torch.empty_like(u),
                 torch.empty_like(v)]
            out = run(b, part, steps=8)
            got = (b[2], b[3]) if engine == "windowed" else tuple(out[:2])
            if part is None:
                want = got
            else:
                checks.compare(engine, got, want, f"{shape[0]}x{shape[1]} "
                               f"{boundary} steps=8 with "
                               f"{ABLATIONS[engine][part]} vs the whole")
        calls = {}
        for part in parts:
            def call(part=part, b=bufs[part]):
                if engine == "windowed":
                    for _ in range(MAIN_STEPS // windowed.K):
                        run(b, part)
                else:
                    b[:] = run(b, part)
            calls[part] = call
        samples = {p: [] for p in parts}
        for part in [*parts, *reversed(parts)]:
            samples[part].append(cuda_ms(calls[part], reps))
        whole = sum(samples[None]) / 2
        for part in parts[1:]:
            t = sum(samples[part]) / 2
            print(f"time {engine} {shape[0]}x{shape[1]} {boundary}, "
                  f"{MAIN_STEPS} steps, with {ABLATIONS[engine][part]}: "
                  f"{t!r} ms (turns {samples[part]!r}) = {t / whole!r}x the "
                  f"whole kernel's {whole!r} ms (phase 6b's turns: "
                  f"{ms[engine]!r}) [{card}]", flush=True)


PTXAS_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
PTXAS_SPILLS = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads")
PTXAS_USED = re.compile(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?")
#: K1's and K3's kernels, as their mangled names spell them (the name's
#: length, then the name: not packed_resident_kernel)
REDESIGNED_KERNELS = ("15windowed_kernel", "15resident_kernel")


def ptxas_report(log: str, kernels=REDESIGNED_KERNELS) -> list:
    """(function, registers, spill store bytes, spill load bytes, static
    shared bytes) of each instantiation of ``kernels`` in ptxas's report;
    the function from its kernel's name on (its template arguments
    mangled)."""
    rows, entry = [], None
    spills = (None, None)
    for line in log.splitlines():
        m = PTXAS_ENTRY.search(line)
        if m:
            entry = next((m.group(1)[m.group(1).index(k) + 2:]
                          for k in kernels if k in m.group(1)), None)
            spills = (None, None)
            continue
        if entry is None:
            continue
        m = PTXAS_SPILLS.search(line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = PTXAS_USED.search(line)
        if m:
            rows.append((entry, int(m.group(1)), *spills,
                         int(m.group(2) or 0)))
            entry = None
    return rows


def compare_microbench_kernels(checks: Checks, rng) -> None:
    """Phase 9a: K8 and K9 against their plain versions on the card, K9
    also against K3. K8 also at the entry point's call, 256 steps of 90
    ops at 1088x1920, both forms (the pass sequence of 30 rolls a step and
    its buffer parity); the ones that the entry point times are held in
    phase 9c."""
    for shape in OPLAT_SHAPES:
        x = torch.from_numpy(rng.uniform(0.5, 2.0, shape).astype(np.float32)
                             ).to(DEVICE)
        calls = [(4, n_ops) for n_ops in (15, 45)]
        if shape == OPLAT_SHAPES[0]:
            calls.append((oplat_script.STEPS, 90))
        for steps, n_ops in calls:
            for rolls in (False, True):
                checks.compare_one(
                    "oplat", oplat.chain(x, steps, n_ops, rolls),
                    oplat.chain_reference(x, steps, n_ops, rolls),
                    f"{shape[0]}x{shape[1]} steps={steps} n_ops={n_ops} "
                    f"rolls={rolls} (one launch)")
    consts = kernel_constants(Parameters())
    for shape in SHAPES:
        u0, v0 = (torch.from_numpy(rng.uniform(0.0, 1.0, shape)
                                   .astype(np.float32)).to(DEVICE)
                  for _ in range(2))
        for boundary in ("naive", "zero"):
            tag = f"{shape[0]}x{shape[1]} {boundary}"
            k3 = {steps: resident.multistep(
                u0.clone(), v0.clone(), torch.empty_like(u0),
                torch.empty_like(v0), steps, consts, boundary)[:2]
                for steps in (1, 27, 32)}
            for split in SPLITS:
                u, v, done = u0, v0, 0
                for steps in (1, 27, 32):
                    u, v = ilpsplit.split_reference(
                        u, v, steps - done, consts, boundary, split,
                        quantum=ilpsplit.TILE)
                    done = steps
                    out = ilpsplit.split_multistep(
                        u0.clone(), v0.clone(), torch.empty_like(u0),
                        torch.empty_like(v0), steps, consts, boundary, split)
                    what = f"{tag} split={split} steps={steps} (one launch)"
                    checks.compare("ilpsplit", out[:2], (u, v), what)
                    checks.compare("ilpsplit", out[:2], k3[steps],
                                   f"{what} vs K3")


def microbench_paths(checks: Checks, card: str) -> dict:
    """Phase 9b: the two entry points' sweeps, each with the launch counts
    zeroed before it and read after; every time beside the card's bound."""
    out = {}
    shape = OPLAT_SHAPES[0]
    reset_launches()
    records = oplat_script.sweep([shape], (15, 90), oplat_script.STEPS,
                                 DEVICE)
    launches = read_launches()
    want = {tag: 0 for tag in COUNTERS}
    want["oplat"] = 4 * len(records)  # a warm call and 3 timed ones each
    print(f"path scripts.oplat {shape[0]}x{shape[1]}: launches {launches} "
          f"(expected {want})", flush=True)
    checks.expect(launches == want, f"oplat sweep: launches {launches}, "
                  f"not {want}")
    out["oplat_launches"] = launches["oplat"]
    for rec in records:
        steps = oplat_script.STEPS
        ms = rec["us_per_step"] * steps * 1e-3
        bound, by = oplat_bound_ms(shape, steps, rec["n_ops"], rec["rolls"])
        out["oplat", rec["n_ops"], rec["rolls"]] = (ms, bound, by)
        print(f"time oplat {shape[0]}x{shape[1]} n_ops={rec['n_ops']} "
              f"rolls={rec['rolls']}, {steps} steps a launch: {ms!r} ms, "
              f"{rec['ns_per_op']!r} ns/op, {rec['ps_per_cell_op']!r} "
              f"ps/cell-op; bound {bound!r} ms ({by}), "
              f"{100 * bound / ms!r} % of it [{card}]", flush=True)
    for line in oplat_script.fits(records):
        print(f"{line} [{card}]", flush=True)

    reset_launches()
    runs = 0
    for shape in (MAIN_SHAPE, BENCH_SHAPE):
        for boundary in ("zero", "naive"):
            recs = ilpsplit_script.sweep(shape, boundary, SPLITS, MAIN_STEPS,
                                         DEVICE)
            runs += 1
            bound, by = bound_ms(shape, MAIN_STEPS, boundary)
            k3_ms = recs[0]["seconds"] * 1e3
            for rec in recs:
                ms = rec["seconds"] * 1e3
                label = ("resident (K3)" if rec["split"] is None
                         else f"split={rec['split']}")
                out["ilpsplit", shape, boundary, rec["split"]] = ms
                print(f"time ilpsplit {shape[0]}x{shape[1]} {boundary} "
                      f"{label}, {MAIN_STEPS} steps a launch: {ms!r} ms = "
                      f"{rec['gcells_per_sec']!r} Gcell/s, {k3_ms / ms!r}x "
                      f"K3; bound {bound!r} ms ({by}) [{card}]", flush=True)
    launches = read_launches()
    want = {tag: 0 for tag in COUNTERS}
    # each split: a 3-step check, a warm call and 3 timed ones; K3 the same
    want["ilpsplit"] = runs * len(SPLITS) * 5
    want["resident"] = runs * 5
    print(f"path scripts.ilpsplit: launches {launches} (expected {want})",
          flush=True)
    checks.expect(launches == want, f"ilpsplit sweep: launches {launches}, "
                  f"not {want}")
    out["ilpsplit_launches"] = launches["ilpsplit"]
    return out


def time_microbench_plain(checks: Checks, rng) -> dict:
    """Phase 9c: the plain versions of the calls that the kernels line
    reports: K8's 256 steps of 90 ops without rolls at 1088x1920 on the
    entry point's ones, whose result the kernel is held against, and K9's
    32 steps in 2 slabs at 1080x1920, zero boundary."""
    x = torch.ones(OPLAT_SHAPES[0], device=DEVICE)
    u, v = (torch.from_numpy(rng.uniform(0, 1, MAIN_SHAPE).astype(np.float32))
            .to(DEVICE) for _ in range(2))
    consts = kernel_constants(Parameters())
    plain = []
    out = {
        "oplat": cuda_ms(lambda: plain.append(oplat.chain_reference(
            x, oplat_script.STEPS, 90, False)), 1),
        "ilpsplit": cuda_ms(lambda: ilpsplit.split_reference(
            u, v, MAIN_STEPS, consts, "zero", 2, quantum=ilpsplit.TILE), 1),
    }
    checks.compare_one(
        "oplat", oplat.chain(x, oplat_script.STEPS, 90, False), plain[-1],
        f"{OPLAT_SHAPES[0][0]}x{OPLAT_SHAPES[0][1]} ones "
        f"steps={oplat_script.STEPS} n_ops=90 rolls=False (the timed call)")
    return out


def sharded_run(params: Parameters, boundary: str, u_np, v_np, mesh_shape,
                steps: int):
    """The sharded backend's state after ``steps`` steps on K7."""
    n_r, n_c = mesh_shape
    sim = ShardedSimulation(params, boundary, device=DEVICE, engine="mega",
                            n_devices=n_r * n_c, mesh_cols=n_c)
    storage = sim.build_storage(u_np, v_np)
    assert sim.mesh.shape == tuple(mesh_shape)
    storage = sim.run_steps(storage, u_np.shape, steps)
    return sim.extract_uv(storage, u_np.shape)


def sharded_plain(params: Parameters, boundary: str, u_np, v_np, mesh_shape,
                  steps: int):
    """The plain version of K7 on the card, launch by launch as the backend
    makes them (the halo exchange, then ``steps // 8`` time blocks, then
    the remainder)."""
    shape = u_np.shape
    mesh = halo.make_mesh(mesh_shape[0] * mesh_shape[1], mesh_shape[1],
                          DEVICE)
    pairs = halo.mega_shard_state(u_np, v_np, mesh)
    for n_blocks, k in sharded_mega.launch_plan(steps):
        for p in pairs:
            halo.exchange_halos(p)
        sharded_mega.sharded_megastep_reference(
            *pairs, n_blocks, k, kernel_constants(params), boundary, shape)
    return tuple(halo.mega_unshard_result(p, shape) for p in pairs)


def compare_sharded(checks: Checks, rng) -> int:
    """Phase 10a: K7 through the sharded backend against its plain version
    on the card and against K2, on every mesh of SHARDED_MESHES at
    1080x1920 and 1000x1917 (8, 27 and 32 steps), on 1001x1920 (its last
    row of shards partly past the domain; 27 steps) and at 4096x4096 (32
    steps) on 4x1 and 2x2, both boundaries. Returns the comparisons."""
    default = Parameters()
    cases = [(shape, mesh, (8, 27, 32)) for shape in SHAPES[:2]
             for mesh in SHARDED_MESHES]
    cases += [(PAST_EDGE_SHAPE, mesh, (27,)) for mesh in ((4, 1), (2, 2))]
    cases += [(BENCH_SHAPE, mesh, (MAIN_STEPS,)) for mesh in ((4, 1), (2, 2))]
    inputs, k2, n = {}, {}, 0
    for shape, mesh_shape, step_counts in cases:
        if shape not in inputs:
            inputs[shape] = tuple(rng.uniform(0.0, 1.0, shape)
                                  .astype(np.float32) for _ in range(2))
        u_np, v_np = inputs[shape]
        for boundary in ("naive", "zero"):
            for steps in step_counts:
                got = sharded_run(default, boundary, u_np, v_np, mesh_shape,
                                  steps)
                what = (f"{shape[0]}x{shape[1]} {boundary} mesh "
                        f"{mesh_shape[0]}x{mesh_shape[1]} steps={steps} "
                        "(backend)")
                checks.compare("shmega", got, sharded_plain(
                    default, boundary, u_np, v_np, mesh_shape, steps), what)
                key = (shape, boundary, steps)
                if key not in k2:
                    k2[key] = engine_run("mega", default, boundary, u_np,
                                         v_np, steps)
                checks.compare("shmega", got, k2[key], f"{what} vs K2")
                n += 2
    return n


def sharded_paths(checks: Checks) -> dict:
    """Phase 10b: ``simulate --backend sharded --sharded-engine mega
    --sharded-devices 4`` on the default run, on the default mesh and on
    each form pinned, with the launch counts zeroed before each and read
    after; every frame against the plain replay of the unsharded run."""
    ns = simulate.build_parser().parse_args([])
    replay = replay_frames(MAIN_SHAPE, "naive", shared.simulation_parameters(
        ns), MAIN_IMAGES, MAIN_STEPS, DEVICE)
    runs = {}
    for flags in SHARDED_PATHS:
        run = simulate_path(checks, SHARDED_FLAGS + flags, replay)
        print(f"path simulate {' '.join(SHARDED_FLAGS + flags)}: storage "
              f"{run['tag']}, mesh {run['mesh']}", flush=True)
        runs[" ".join(flags) or "auto"] = run
    checks.expect(runs["auto"]["mesh"] == (2, 2)
                  and runs["--sharded-mesh-cols 1"]["mesh"] == (4, 1),
                  "sharded simulate meshes")
    return runs


def exchange_cells(shape, mesh_shape) -> int:
    """Cells one time block of K7 pushes, both species: every present
    neighbour's band (HALO rows across the interior columns, COL_HALO
    columns across the interior rows, HALO x COL_HALO corners)."""
    n_r, n_c = mesh_shape
    mesh = halo.Mesh(n_r, n_c, torch.device("cpu"))
    r_loc, c_loc = halo.shard_extents(shape, mesh)
    cells = 0
    for i in range(n_r):
        for j in range(n_c):
            for dr, dc in halo.DIRECTIONS:
                if 0 <= i + dr < n_r and 0 <= j + dc < n_c:
                    cells += ((halo.HALO if dr else r_loc)
                              * (mesh.chalo if dc else c_loc))
    return 2 * cells


def sharded_bound_ms(shape, mesh_shape, steps: int,
                     boundary: str) -> tuple[float, str]:
    """The least time for K7's call: K2's (the state read and written once,
    the oracle's operations) plus the pushes' bytes, each cell read and
    written once (8 B) a time block."""
    cells = shape[0] * shape[1]
    pushed = exchange_cells(shape, mesh_shape) * -(-steps // 8)
    by_bytes = (16 * cells + 8 * pushed) / PEAK_BYTES
    by_ops = cells * steps * ops_per_cell_step(Parameters(), boundary) \
        / PEAK_F32
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations")


def time_sharded(rng, card: str) -> dict:
    """Phase 10c: one K7 launch of 32 steps (4 time blocks) on 1x1, 4x1 and
    2x2 meshes, timed in turns with K2 through its backend (K2, K7 1x1,
    4x1, 2x2, then back), at 1080x1920 and 4096x4096, both boundaries;
    the sharded backend's call (the exchange and the launch) on each mesh;
    the tile quantisation of each mesh; the plain version once."""
    consts = kernel_constants(Parameters())
    out = {}
    meshes = [(1, 1), (4, 1), (2, 2)]
    for shape, reps in ((MAIN_SHAPE, 40), (BENCH_SHAPE, 8)):
        u_np, v_np = (rng.uniform(0, 1, shape).astype(np.float32)
                      for _ in range(2))
        k2_tiles = -(-shape[0] // 32) * -(-shape[1] // 32)
        for n_r, n_c in meshes:
            mesh = halo.Mesh(n_r, n_c, torch.device("cpu"))
            r_loc, c_loc = halo.shard_extents(shape, mesh)
            tiles = -(-r_loc // 32) * -(-c_loc // 32)
            print(f"tiles {shape[0]}x{shape[1]} mesh {n_r}x{n_c}: shards "
                  f"{r_loc}x{c_loc}, {tiles} tiles a shard, "
                  f"{n_r * n_c * tiles} in all (K2: {k2_tiles}); cells "
                  f"stepped past the domain "
                  f"{100 * (1 - shape[0] * shape[1] / (n_r * n_c * tiles * 1024))!r} "
                  f"% (K2: {100 * (1 - shape[0] * shape[1] / (k2_tiles * 1024))!r} %); "
                  f"pushed {exchange_cells(shape, (n_r, n_c))} cells a time "
                  "block", flush=True)
        for boundary in ("naive", "zero"):
            k2 = CudaSimulation(Parameters(), boundary, device=DEVICE,
                                engine="mega")
            box = [k2.build_storage(u_np, v_np)]

            def k2_call(k2=k2, box=box):
                box[0] = k2.run_steps(box[0], shape, MAIN_STEPS)

            calls, sims = {"K2": k2_call}, {}
            for n_r, n_c in meshes:
                mesh = halo.make_mesh(n_r * n_c, n_c, DEVICE)
                pairs = halo.mega_shard_state(u_np, v_np, mesh)
                for p in pairs:
                    halo.exchange_halos(p)

                def k7_call(pairs=pairs, mesh=mesh, boundary=boundary):
                    sharded_mega.sharded_megastep(
                        *pairs, mesh, MAIN_STEPS // 8, 8, consts, boundary,
                        shape)

                calls[f"K7 {n_r}x{n_c}"] = k7_call
                sims[n_r, n_c] = ShardedSimulation(
                    Parameters(), boundary, device=DEVICE, engine="mega",
                    n_devices=n_r * n_c, mesh_cols=n_c)
            samples = {name: [] for name in calls}
            for name in [*calls, *reversed(calls)]:
                samples[name].append(cuda_ms(calls[name], reps))
            for name, pair in samples.items():
                ms = sum(pair) / len(pair)
                mesh_shape = (1, 1) if name == "K2" else tuple(
                    int(x) for x in name.split()[1].split("x"))
                bound, by = (bound_ms(shape, MAIN_STEPS, boundary)
                             if name == "K2" else sharded_bound_ms(
                                 shape, mesh_shape, MAIN_STEPS, boundary))
                out[shape, boundary, name] = (ms, bound, by)
                print(f"time {name} {shape[0]}x{shape[1]} {boundary}, "
                      f"{MAIN_STEPS} steps a launch: {ms!r} ms (turns "
                      f"{pair!r}) = {gcells(shape, MAIN_STEPS, ms)!r} "
                      f"Gcell/s, {ms / out[shape, boundary, 'K2'][0]!r}x "
                      f"K2; bound {bound!r} ms ({by}) [{card}]", flush=True)
            for mesh_shape, sim in sims.items():
                box = [sim.build_storage(u_np, v_np)]

                def call(sim=sim, box=box):
                    box[0] = sim.run_steps(box[0], shape, MAIN_STEPS)

                ms = cuda_ms(call, reps)
                out[shape, boundary, "backend", mesh_shape] = ms
                print(f"time sharded backend {shape[0]}x{shape[1]} "
                      f"{boundary} mesh {mesh_shape[0]}x{mesh_shape[1]}, "
                      f"{MAIN_STEPS} steps a call (exchange + K7): {ms!r} "
                      f"ms [{card}]", flush=True)
    mesh = halo.make_mesh(4, 2, DEVICE)
    pairs = halo.mega_shard_state(*initial_uv(MAIN_SHAPE), mesh)
    for p in pairs:
        halo.exchange_halos(p)
    out["plain"] = cuda_ms(lambda: sharded_mega.sharded_megastep_reference(
        *pairs, MAIN_STEPS // 8, 8, consts, "naive", MAIN_SHAPE), 1)
    print(f"time plain sharded {MAIN_SHAPE[0]}x{MAIN_SHAPE[1]} naive mesh "
          f"2x2, {MAIN_STEPS} steps: {out['plain']!r} ms [{card}]",
          flush=True)
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
    for name, regs, stores, loads, smem in ptxas_report(built.log):
        print(f"ptxas {name}: {regs} registers, spill stores {stores} B, "
              f"spill loads {loads} B, static shared {smem} B", flush=True)
    for label, tile, halo in (("K1", windowed.TILE, windowed.K),
                              ("K3", resident.TILE, resident.HALO)):
        for shape in (MAIN_SHAPE, BENCH_SHAPE):
            n = -(-shape[0] // tile[0]) * -(-shape[1] // tile[1])
            print(f"interior tiles {label} ({tile[0]}x{tile[1]} tiles, "
                  f"windows {halo} cells wider on every side) at "
                  f"{shape[0]}x{shape[1]}: "
                  f"{stencil.interior_tiles(shape, tile, halo)} of {n}",
                  flush=True)
    dev = torch.device(DEVICE)
    print(f"co-resident blocks: resident {resident.max_blocks(dev)}, mega "
          f"{megakernel.max_blocks(dev)}, packed resident "
          f"{packed.resident_max_blocks(dev)}, packed mega "
          f"{megakernel.packed_max_blocks(dev)}, oplat "
          f"{oplat.max_blocks(dev)}, ilpsplit {ilpsplit.max_blocks(dev)}, "
          f"sharded mega {sharded_mega.max_blocks(dev)}", flush=True)

    # 3. every kernel vs its plain version
    compare_kernels(checks, rng)
    compare_packed_kernels(checks, rng)

    # 4. the default simulate run, on auto and on each pin; then the
    # packed zero-boundary run
    runs = main_paths(checks)
    packed_runs = packed_paths(checks)

    # 5. the bench path, and the packed 1000-step run
    bench = bench_path(checks, card)
    packed_bench(checks, card)

    # 6. times, beside the card
    print(f"timing on {card}")
    time_engines(rng, card)
    kernel_times = time_kernels(checks, rng, card)
    time_packed_engines(rng, card)
    kernel_times.update(time_packed_kernels(rng, card))

    # 9. the microbenchmarks' kernels: checks, then their entry points
    compare_microbench_kernels(checks, rng)
    micro = microbench_paths(checks, card)
    micro_plain = time_microbench_plain(checks, rng)
    print(f"time plain oplat {OPLAT_SHAPES[0][0]}x{OPLAT_SHAPES[0][1]} "
          f"n_ops=90 rolls=False, {oplat_script.STEPS} steps: "
          f"{micro_plain['oplat']!r} ms; plain ilpsplit "
          f"{MAIN_SHAPE[0]}x{MAIN_SHAPE[1]} zero split=2, {MAIN_STEPS} "
          f"steps: {micro_plain['ilpsplit']!r} ms [{card}]", flush=True)
    # 10. the sharded megakernel K7: checks, the sharded simulate runs,
    # times
    t10 = time.perf_counter()
    n10 = compare_sharded(checks, rng)
    sharded_runs = sharded_paths(checks)
    k7 = time_sharded(rng, card)
    print(f"phase 10: {n10} comparisons of K7, {time.perf_counter() - t10!r}"
          " s", flush=True)
    snap_ms = time_snapshot(MAIN_SHAPE, 16)
    print(f"time snapshot {MAIN_SHAPE[0]}x{MAIN_SHAPE[1]} (clone + D2H to "
          f"pinned): {snap_ms!r} ms/image [{card}]")
    for label, run in runs.items():
        print(f"path simulate {label} end to end ({run['engine']}): "
              f"{run['gcells']!r} Gcell/s "
              f"({run['seconds'] / MAIN_IMAGES * 1e3!r} ms/image) [{card}]")
    for label, run in packed_runs.items():
        if label == "vs_unpacked":
            continue
        print(f"path simulate {' '.join(ZERO_PACKED)} {label} end to end "
              f"({run['engine']}): {run['gcells']!r} Gcell/s "
              f"({run['seconds'] / MAIN_IMAGES * 1e3!r} ms/image) [{card}]")
    for label, run in sharded_runs.items():
        print(f"path simulate {' '.join(SHARDED_FLAGS)} {label} end to end "
              f"({run['tag']}, mesh {run['mesh']}): {run['gcells']!r} "
              f"Gcell/s ({run['seconds'] / MAIN_IMAGES * 1e3!r} ms/image) "
              f"[{card}]")
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
            shape=list(MAIN_SHAPE), steps=steps, boundary="naive",
            redesigned="csrc/gs_tile_sm90.cuh"))
    ms, plain_ms = bench["naive"]
    bound, by = bound_ms(BENCH_SHAPE, BENCH_STEPS, "naive")
    entries.append(dict(
        KERNELS["mega"],
        launches=runs["--pallas-engine mega"]["launches"]["mega"],
        max_abs_err=checks.kernel_err["mega"], ms=ms, plain_ms=plain_ms,
        bound_ms=bound, bound_by=by, library_ms=None,
        shape=list(BENCH_SHAPE), steps=BENCH_STEPS, boundary="naive"))
    for tag, flags in PACKED_FLAGS.items():
        ms, plain_ms, bound, by, steps = kernel_times[tag, MAIN_SHAPE]
        entries.append(dict(
            KERNELS[tag],
            launches=packed_runs[" ".join(flags)]["launches"][tag],
            max_abs_err=checks.kernel_err[tag], ms=ms, plain_ms=plain_ms,
            bound_ms=bound, bound_by=by, library_ms=None,
            shape=list(MAIN_SHAPE), steps=steps, boundary="zero"))
    ms, bound, by = micro["oplat", 90, False]
    entries.append(dict(
        KERNELS["oplat"], launches=micro["oplat_launches"],
        max_abs_err=checks.kernel_err["oplat"], ms=ms,
        plain_ms=micro_plain["oplat"], bound_ms=bound, bound_by=by,
        library_ms=None, shape=list(OPLAT_SHAPES[0]),
        steps=oplat_script.STEPS, n_ops=90, rolls=False))
    bound, by = bound_ms(MAIN_SHAPE, MAIN_STEPS, "zero")
    entries.append(dict(
        KERNELS["ilpsplit"], launches=micro["ilpsplit_launches"],
        max_abs_err=checks.kernel_err["ilpsplit"],
        ms=micro["ilpsplit", MAIN_SHAPE, "zero", 2],
        plain_ms=micro_plain["ilpsplit"], bound_ms=bound, bound_by=by,
        library_ms=None, shape=list(MAIN_SHAPE), steps=MAIN_STEPS,
        boundary="zero", split=2))
    auto = sharded_runs["auto"]
    ms, bound, by = k7[MAIN_SHAPE, "naive", "K7 2x2"]
    entries.append(dict(
        KERNELS["shmega"], launches=auto["launches"]["shmega"],
        max_abs_err=checks.kernel_err["shmega"], ms=ms,
        plain_ms=k7["plain"], bound_ms=bound, bound_by=by, library_ms=None,
        shape=list(MAIN_SHAPE), steps=MAIN_STEPS, boundary="naive",
        mesh=list(auto["mesh"])))
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
