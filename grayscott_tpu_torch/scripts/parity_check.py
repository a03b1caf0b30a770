"""Long-run numerical parity report: the port of ``scripts/parity_check.py``.

Runs the 256x384 / f=0.014 / k=0.054 / 1000-step simulation on each backend
given and reports its drift from the reference at every snapshot: max|dU|,
max|dV| and the RMS of dV. The reference is the port's ``naive`` rung on
the same device, which is bitwise to the numpy oracle (the bit-faithful
transcription of the reference's naive backend) on both boundaries. The
report's JSON schema and the exit rule are JAX's: 0 when the worst max|dV|
over the run is below 1e-3, else 1.

    python -m grayscott_tpu_torch.scripts.parity_check [--steps 1000] \\
        [--backends fused,cuda] [--boundary zero] [--device cpu] [-o r.json]

A backend is a registry name (``naive``, ``regular``, ``fused``, ``conv``,
``cuda``, ``sharded``), optionally with the backend's pins after colons:
``cuda:engine=mega``, ``cuda:resident=on``, ``cuda:pack=on:engine=windowed``
(``sharded`` needs ``sharded:engine=mega``). Each spec is a row of the
report under its own name. Every run is on the card unless ``--device
cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from ..utils.runtime import PLATFORMS, default_device
from ._sweep_util import parse_pins

#: the acceptance bound on max|dV| over the run (BASELINE.md)
TOLERANCE = 1e-3


def parse_backend(spec: str) -> tuple[str, dict]:
    """``"cuda:pack=on:engine=mega"`` -> ``("cuda", {"pack": "on",
    "engine": "mega"})``."""
    name, _, pins = spec.partition(":")
    return name, parse_pins(pins)


def run(backends, steps: int = 1000, snapshot_every: int = 100,
        boundary: str = "naive", shape=(256, 384), stencil: str = "oono-puri",
        device: str = "cuda", verbose: bool = True) -> dict:
    """The report: each backend spec of ``backends`` against the ``naive``
    rung, every ``snapshot_every`` steps up to ``steps``."""
    from ..backends import get_backend
    from ..cli.shared import require_device
    from ..params import Parameters
    from ..utils.device import device_name

    require_device(device)
    shape = tuple(shape)
    params = Parameters.with_stencil(stencil)
    ref_sim = get_backend("naive")(params, boundary=boundary, device=device)
    ref = ref_sim.make_species(shape)
    sims = {}
    for spec in backends:
        name, pins = parse_backend(spec)
        sim = get_backend(name)(params, boundary=boundary, device=device,
                                **pins)
        sims[spec] = (sim, sim.make_species(shape))
    report = {"shape": shape, "boundary": boundary, "stencil": stencil,
              "reference": "naive", "device": device_name(device),
              "rows": []}
    t0 = time.time()
    done = 0
    while done < steps:
        n = min(snapshot_every, steps - done)
        ref_sim.perform_steps(ref, n)
        u_ref, v_ref = ref.uv_host()
        done += n
        row = {"step": done}
        for spec, (sim, species) in sims.items():
            sim.perform_steps(species, n)
            gu, gv = species.uv_host()
            row[spec] = {
                "max_abs_u": float(np.abs(gu - u_ref).max()),
                "max_abs_v": float(np.abs(gv - v_ref).max()),
                "rms_v": float(np.sqrt(np.mean((gv - v_ref) ** 2))),
            }
        report["rows"].append(row)
        if verbose:
            print(f"step {done:5d}: " + "  ".join(
                f"{s}: max|dV|={row[s]['max_abs_v']:.3e}" for s in sims),
                flush=True)
    report["seconds"] = time.time() - t0
    report["naive_v_checksum"] = float(v_ref.sum())
    return report


def worst_v(report: dict) -> float:
    """The largest max|dV| of any backend at any snapshot."""
    return max((cell["max_abs_v"] for row in report["rows"]
                for key, cell in row.items() if key != "step"),
               default=0.0)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=1000)
    parser.add_argument("--snapshot-every", type=int, default=100)
    parser.add_argument("--backends", default="fused,cuda")
    parser.add_argument("--boundary", default="naive",
                        choices=["naive", "zero"])
    parser.add_argument("--shape", default="256x384")
    parser.add_argument("--stencil", default="oono-puri",
                        help="Laplacian stencil; '5points' exercises the "
                        "kernels' DIRECT (non-separable) path")
    parser.add_argument("--device", default=default_device(),
                        choices=PLATFORMS,
                        help="'cuda' (default) runs on the card; 'cpu' the "
                        "plain versions")
    parser.add_argument("-o", "--output", default=None)
    args = parser.parse_args(argv)
    shape = tuple(int(x) for x in args.shape.split("x"))
    report = run(args.backends.split(","), args.steps, args.snapshot_every,
                 args.boundary, shape, args.stencil, args.device)
    print(f"naive V checksum after {args.steps} steps: "
          f"{report['naive_v_checksum']:.6f}")
    if args.output:
        with open(args.output, "w") as f:
            json.dump(report, f, indent=1)
    worst = worst_v(report)
    print(f"worst max|dV| over run: {worst:.3e}")
    return 0 if worst < TOLERANCE else 1


if __name__ == "__main__":
    sys.exit(main())
