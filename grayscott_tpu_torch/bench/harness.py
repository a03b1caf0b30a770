"""Throughput sweep: the port of ``grayscott_tpu/bench/harness.py``.

The reference's criterion method: domains ``[2^s, 2^(s+1)]`` for s in
``smin..smax`` and step batches ``2^0..2^8``, throughput in cell-updates
per second, several samples per point summarised by ``bench/stats.py``.
Four workloads:

- ``compute``: the steps, then a tiny readback that waits for them;
- ``full_sync``: the steps, then V copied to the host;
- ``full_future``: the steps and a device copy of V enqueued together,
  then the copy brought to the host once;
- ``device``: the device time of the ``prepare_steps`` call alone, from
  CUDA events on the launch stream (the JAX harness reads it from a
  profiler trace). It needs the card and raises on the CPU.

    python -m grayscott_tpu_torch.bench.harness --smin 3 --smax 5 \\
        --steps 1,8 --workloads compute,device
    python -m grayscott_tpu_torch.bench.harness --device cpu --smax 4
    python -m grayscott_tpu_torch.bench.harness --backends sharded \
        --engine windowed --smax 10 --steps 32   # or --engine mega

``--engine`` pins the engine of the backends swept (``cuda``: windowed or
mega; ``sharded``: the windowed engine or the megakernel K7, one shard a
visible card). ``--dtype bfloat16`` runs ``cuda`` and ``sharded`` on bf16
storage; another backend prints a note and runs float32, as JAX's harness
does. ``--block-rows`` and ``--steps-per-call`` pin K1's (and K4's) tile
height and depth on ``cuda`` (``ops/geometry.py``; with ``--engine mega``
the megakernels' row tile, and K 8 alone), as JAX's harness pins its Pallas
kernel's (``grayscott_tpu/bench/harness.py:242-245``, ``:286-296``): every
backend swept gets them, the plain rungs ignore them, and the sharded
backend runs them (the windowed engine's K and row tile, K7's row tile).
Every run is on the card unless ``--device cpu`` is given.
``--report SWEEP_JSON`` renders a sweep instead of measuring
(``bench/report.py``; ``--format markdown|html|svg``), against
``--baseline SWEEP_JSON`` when given; ``--gate`` then exits 1 on any
significant regression (CI95s that do not overlap). A report touches no
device, so it runs on a host without a GPU.

    python -m grayscott_tpu_torch.bench.harness --report new.json \
        --baseline old.json --gate
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Iterable, List, Sequence

import torch

from ..utils.runtime import PLATFORMS, default_device
from . import stats

WORKLOADS = ("compute", "full_sync", "full_future", "device")

#: the backends that take a storage dtype (``--dtype``)
DTYPE_BACKENDS = ("cuda", "sharded")


@dataclasses.dataclass
class Result:
    backend: str
    workload: str
    shape: tuple
    steps: int
    seconds: float
    #: best-sample rate
    gcells_per_sec: float
    #: run labels (boundary, device, pinned knobs)
    extra: dict = dataclasses.field(default_factory=dict)
    #: raw per-sample rates and their summary (bench/stats.py)
    samples_gcells: list = dataclasses.field(default_factory=list)
    stats: dict = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(d.pop("extra"))
        return d


def default_domains(smin: int = 3, smax: int = 11) -> List[tuple]:
    """[2^s, 2^(s+1)] for s in smin..smax."""
    return [(1 << s, 1 << (s + 1)) for s in range(smin, smax + 1)]


def default_step_counts() -> List[int]:
    return [1 << n for n in range(9)]  # 2^0 .. 2^8


def _sync_tiny(species) -> float:
    """A readback of a few cells, which waits for the steps before it."""
    return species.result()[:1, :128].sum().item()


def _device_seconds(sim, species, steps: int) -> float:
    """Device time of one ``prepare_steps`` call, from CUDA events."""
    if sim.device.type != "cuda":
        raise RuntimeError(
            "the 'device' workload times the card with CUDA events; it "
            f"needs a CUDA device, not {sim.device}")
    stream = torch.cuda.current_stream(sim.device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record(stream)
    sim.prepare_steps(species, steps)
    end.record(stream)
    end.synchronize()
    return start.elapsed_time(end) * 1e-3


def run_one(sim, shape, steps: int, workload: str = "compute",
            reps: int = 5, extra: dict | None = None) -> Result:
    if workload not in WORKLOADS:
        raise ValueError(f"unknown workload {workload!r}; expected one of "
                         f"{WORKLOADS}")
    species = sim.make_species(shape)
    sim.prepare_steps(species, steps)  # warm-up: kernel build and caches
    _sync_tiny(species)
    times = []
    for _ in range(reps):
        if workload == "device":
            times.append(_device_seconds(sim, species, steps))
            continue
        t0 = time.perf_counter()
        sim.prepare_steps(species, steps)
        if workload == "compute":
            _sync_tiny(species)
        elif workload == "full_sync":
            species.result_host()
        else:  # full_future
            species.result().clone().cpu()
        times.append(time.perf_counter() - t0)
    cells = shape[0] * shape[1] * steps
    best = min(times)
    rates = [cells / t / 1e9 for t in times]
    return Result(
        backend=sim.name, workload=workload, shape=tuple(shape), steps=steps,
        seconds=best, gcells_per_sec=cells / best / 1e9,
        extra=dict(extra or {}), samples_gcells=rates,
        stats=stats.summarize(rates),
    )


def sweep(
    backend_names: Sequence[str],
    domains: Iterable[tuple] | None = None,
    step_counts: Iterable[int] | None = None,
    workloads: Sequence[str] = ("compute",),
    boundary: str = "naive",
    reps: int = 5,
    out_path: str | None = None,
    verbose: bool = True,
    backend_kwargs: dict | None = None,
    device: str = "cuda",
) -> List[Result]:
    from ..backends import get_backend
    from ..params import Parameters

    domains = list(domains or default_domains())
    step_counts = list(step_counts or default_step_counts())
    device_name = (torch.cuda.get_device_name() if device == "cuda"
                   else None)
    results = []
    for name in backend_names:
        kwargs = dict(backend_kwargs or {})
        if kwargs.get("dtype") not in (None, "float32", "f32") and \
                name not in DTYPE_BACKENDS:
            # the rungs accept and ignore dtype; dropping it keeps the
            # labels honest (grayscott_tpu/bench/harness.py:170-177)
            print(f"{name}: dtype={kwargs['dtype']} unsupported, "
                  "running float32", flush=True)
            kwargs.pop("dtype")
        labels = {"boundary": boundary, "device": device, **kwargs}
        if device_name:
            labels["device_name"] = device_name
        sim = get_backend(name)(Parameters(), boundary=boundary,
                                device=device, **kwargs)
        for shape in domains:
            for steps in step_counts:
                for workload in workloads:
                    res = run_one(sim, shape, steps, workload, reps,
                                  extra=labels)
                    results.append(res)
                    if verbose:
                        print(f"{name:8s} {workload:11s} "
                              f"{shape[0]:5d}x{shape[1]:<5d} "
                              f"steps={steps:3d}  "
                              f"{res.gcells_per_sec!r} Gcell/s", flush=True)
    if out_path:
        with open(out_path, "w") as f:
            json.dump([r.to_json() for r in results], f, indent=1)
    return results


def main(argv=None) -> int:
    from ..backends import best_backend_name
    from ..cli.shared import require_device

    parser = argparse.ArgumentParser(
        prog="grayscott-torch-bench",
        description="Throughput sweep of the PyTorch port (criterion "
        "benchmark analog)")
    parser.add_argument("--report", metavar="SWEEP_JSON", default=None,
                        help="render a report from a sweep JSON file "
                        "instead of measuring (criterion-HTML-report "
                        "analog)")
    parser.add_argument("--baseline", metavar="SWEEP_JSON", default=None,
                        help="with --report: baseline sweep to diff "
                        "against (adds a vs-baseline delta column)")
    parser.add_argument("--format", default="markdown",
                        choices=["markdown", "html", "svg"],
                        help="report output format (html embeds the "
                        "throughput-vs-size SVG plot; svg emits it alone)")
    parser.add_argument("--gate", action="store_true",
                        help="with --report and --baseline: exit 1 on any "
                        "SIGNIFICANT regression (CI95 non-overlap, not "
                        "point delta — within-noise deltas never fail)")
    parser.add_argument("--backends", default="auto",
                        help="comma-separated backend names, or 'auto'")
    parser.add_argument("--smin", type=int, default=3)
    parser.add_argument("--smax", type=int, default=11)
    parser.add_argument("--steps", default=None,
                        help="comma-separated step counts (default 1..256 "
                        "pow2)")
    parser.add_argument("--workloads", default="compute",
                        help="comma-separated: " + ",".join(WORKLOADS))
    parser.add_argument("--boundary", default="naive",
                        choices=["naive", "zero"])
    parser.add_argument("--reps", type=int, default=5,
                        help="samples per measurement")
    parser.add_argument("-o", "--output", default=None,
                        help="JSON output path")
    parser.add_argument("--engine", default=None,
                        choices=["auto", "windowed", "mega"],
                        help="pin the kernel engine")
    parser.add_argument("--device", default=default_device(),
                        choices=PLATFORMS,
                        help="'cuda' (default) times the CUDA kernels; "
                        "'cpu' their plain PyTorch versions")
    parser.add_argument("--dtype", default=None,
                        choices=["float32", "bfloat16"],
                        help="storage precision for backends that support "
                        "it (cuda, sharded; bfloat16 = the opt-in bf16 "
                        "storage)")
    parser.add_argument("--block-rows", type=int, default=None,
                        help="pin the row-tile size (cuda: the height of "
                        "K1's and K4's tiles, or K2's and K6's with --engine "
                        "mega; sharded: the windowed engine's and K7's)")
    parser.add_argument("--steps-per-call", type=int, default=None,
                        help="pin the temporal-blocking depth (cuda: K "
                        "steps a launch of K1 and K4, 1..32; sharded: of "
                        "the windowed engine)")
    args = parser.parse_args(argv)
    if args.report:
        return _report(args)
    require_device(args.device)
    names = ([best_backend_name()] if args.backends == "auto"
             else args.backends.split(","))
    sweep(
        names,
        domains=default_domains(args.smin, args.smax),
        step_counts=([int(s) for s in args.steps.split(",")]
                     if args.steps else None),
        workloads=args.workloads.split(","),
        boundary=args.boundary,
        reps=args.reps,
        out_path=args.output,
        backend_kwargs={k: v for k, v in (
            ("dtype", args.dtype), ("block_rows", args.block_rows),
            ("steps_per_call", args.steps_per_call),
            ("engine", args.engine)) if v is not None},
        device=args.device,
    )
    return 0


def _report(args: argparse.Namespace) -> int:
    """``--report``: render the sweep (to ``-o`` or stdout); with
    ``--gate`` and ``--baseline``, 1 on a significant regression
    (``grayscott_tpu/bench/harness.py:252-272``)."""
    from . import report

    text = report.report(args.report, args.baseline, args.format)
    if args.output:
        with open(args.output, "w") as f:
            f.write(text)
    else:
        print(text, end="")
    if args.gate and args.baseline:
        rows = report.build_rows(report.load_results(args.report),
                                 report.load_results(args.baseline))
        bad = report.gate(rows)
        for r in bad:
            print(f"REGRESSION {r['backend']} {r['shape']} "
                  f"steps={r['steps']}: {r['delta_pct']:+.1f}% "
                  "(CI95s do not overlap)", flush=True)
        return 1 if bad else 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
