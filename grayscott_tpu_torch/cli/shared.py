"""CLI arguments shared by the port's programs: the port's
``grayscott_tpu/cli/shared.py``.

The same ``-k -f -e -r -c -t --preset --stencil --boundary`` arguments
with the same defaults and environment fallbacks, plus ``--device``; the
backend is the selector's choice (the port has one). ``--device cuda``
(the default) on a host where PyTorch sees no GPU stops with a message;
the port never falls back to the CPU.
The JAX CLI's numpy-only helpers are reused as they are.
"""

from __future__ import annotations

import argparse
import os

import torch

from grayscott_tpu.cli.shared import (  # noqa: F401  (re-exports)
    bounded_put,
    domain_shape,
    simulation_output_path,
    simulation_parameters,
)

from ..backends import best_backend_name, get_backend
from ..params import DEFAULT_STENCIL, PRESETS, STENCILS


def add_shared_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "-k", "--killrate", type=float, default=None,
        help="Rate of the process which converts V into P",
    )
    parser.add_argument(
        "-f", "--feedrate", type=float, default=None,
        help="Rate of the process which feeds U and drains U, V and P",
    )
    parser.add_argument(
        "-e", "--nbextrastep", type=int, default=None,
        help="Number of simulation steps to perform between images",
    )
    parser.add_argument(
        "-r", "--nbrow", type=int, default=1080,
        help="Number of rows of the images to be created",
    )
    parser.add_argument(
        "-c", "--nbcol", type=int, default=1920,
        help="Number of columns of the images to be created",
    )
    parser.add_argument(
        "-t", "--deltat", type=float, default=None,
        help="Simulated time interval on each simulation step",
    )
    parser.add_argument(
        "--preset",
        default=os.environ.get("GRAYSCOTT_PRESET") or None,
        choices=sorted(PRESETS),
        help="Named (feed, kill) pattern preset; explicit -f/-k override it",
    )
    parser.add_argument(
        "--stencil",
        default=os.environ.get("GRAYSCOTT_STENCIL", DEFAULT_STENCIL),
        choices=sorted(STENCILS),
        help="Laplacian stencil",
    )
    parser.add_argument(
        "--boundary",
        default=os.environ.get("GRAYSCOTT_BOUNDARY", "naive"),
        choices=["naive", "zero"],
        help="Boundary semantics: 'naive' = clamped window, "
        "'zero' = zero border",
    )
    parser.add_argument(
        "--device", default="cuda", choices=["cuda", "cpu"],
        help="'cuda' (default) runs the hand-written CUDA kernels; 'cpu' "
        "runs their plain PyTorch versions",
    )


def make_simulation(ns: argparse.Namespace):
    if ns.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "--device cuda: PyTorch sees no CUDA GPU "
            "(torch.cuda.is_available() is false); pass --device cpu to "
            "run the plain PyTorch version on the CPU")
    cls = get_backend(best_backend_name())
    return cls(simulation_parameters(ns), boundary=ns.boundary,
               device=ns.device)
