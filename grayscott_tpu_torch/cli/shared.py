"""CLI arguments shared by the port's programs: the port's
``grayscott_tpu/cli/shared.py``.

The same ``-k -f -e -r -c -t --preset --backend --stencil --boundary
--autotune`` arguments with the same defaults and environment fallbacks,
each backend's own arguments (the eleven ``--pallas-*`` flags;
``--sharded-engine``, ``--sharded-devices``, ``--sharded-mesh-cols``,
``--sharded-overlap``), plus ``--device`` (default ``GRAYSCOTT_PLATFORM``,
else ``cuda``: ``utils/runtime.py``). ``--backend auto`` (the
default) is the selector's choice. ``--device cuda`` (the default) on a
host where PyTorch sees no GPU stops with a message; the port never falls
back to the CPU.

``--autotune`` (or ``GRAYSCOTT_AUTOTUNE``) with the ``cuda`` backend
measures its engines and layouts on the device before the run
(``bench/autotune.py:autotune``; under ``--pallas-steps-per-call``,
``--pallas-block-rows`` or ``--pallas-block-cols``, K1's candidates under
those pins) unless the store already holds a record for the domain and
pins, and the simulation follows the winner; with ``sharded``
it measures the sharded candidates under every pin of the command line
(``bench/autotune.py:sharded_autotune``, as JAX's ``cli/shared.py:
141-153``); the plain rungs ignore it, as JAX's do.

:func:`make_simulation` starts no process group: ``simulate`` joins the
one that ``GRAYSCOTT_COORDINATOR`` asks for before it (as JAX's
``simulate.main`` does, ``grayscott_tpu/cli/simulate.py:91``), and
``livesim`` and the bench run one process whatever the variable says, as
JAX's ``livesim`` does. In a process group, ``--backend auto`` runs
``sharded``, whose mesh spans the processes; every other backend would run
the whole domain on every process, and ``--autotune`` would measure and
keep a record on each, so both raise :class:`UnsupportedConfigError`
(JAX runs them, and its ``fetch`` then tiles every process's whole domain
into one array; ROADMAP.md Queue 3).
"""

from __future__ import annotations

import argparse
import logging
import os
import queue
from typing import Tuple

import torch

from ..backends import BACKENDS, best_backend_name, get_backend
from ..backends.base import env_flag
from ..errors import UnsupportedConfigError
from ..params import DEFAULT_STENCIL, PRESETS, STENCILS, Parameters
from ..utils import distributed
from ..utils.runtime import PLATFORMS, default_device


def add_shared_args(parser: argparse.ArgumentParser) -> None:
    # the port's support matrix (support.py), the table the README renders,
    # as the --help epilog (grayscott_tpu/cli/shared.py:22-28)
    from .. import support

    if parser.epilog is None:
        parser.epilog = support.render("text")
        parser.formatter_class = argparse.RawDescriptionHelpFormatter
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
        "--backend",
        default=os.environ.get("GRAYSCOTT_BACKEND", "auto"),
        help="Compute backend: 'naive', 'regular', 'fused' or 'conv' (the "
        "plain rungs of the ladder: PyTorch operations), 'cuda' (one card, "
        "the hand-written kernels) or 'sharded' (a mesh of shards); "
        "default: 'cuda', never a rung; env GRAYSCOTT_BACKEND",
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
        "--autotune", action="store_true",
        default=env_flag("GRAYSCOTT_AUTOTUNE"),
        help="Measure the engines and layouts for this domain on the "
        "device before starting and follow the winner (persisted in "
        "autotune.json under GRAYSCOTT_CACHE_DIR, default "
        "~/.cache/grayscott_tpu_torch; the cuda backend). A later run of "
        "the same domain finds the record and measures nothing",
    )
    parser.add_argument(
        "--device", default=default_device(), choices=PLATFORMS,
        help="'cuda' (default; env GRAYSCOTT_PLATFORM) runs the "
        "hand-written CUDA kernels; 'cpu' runs their plain PyTorch versions",
    )
    for cls in BACKENDS.values():
        cls.add_cli_args(parser)


def require_device(device: str) -> None:
    """Stop with a message when ``device`` is ``cuda`` and PyTorch sees no
    GPU: nothing falls back to the CPU."""
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "--device cuda: PyTorch sees no CUDA GPU "
            "(torch.cuda.is_available() is false); pass --device cpu to "
            "run the plain PyTorch version on the CPU")


def make_simulation(ns: argparse.Namespace):
    """The backend of ``ns``, built (its flags checked) before
    ``--autotune`` measures anything; the autotune winner persists, and the
    simulation follows it when it builds its storage. In a process group
    (``utils/distributed.py``) only ``sharded`` runs, without
    ``--autotune``."""
    require_device(ns.device)
    name = ns.backend
    procs = distributed.process_count()
    if name in (None, "", "auto"):
        name = ("sharded" if procs > 1
                else best_backend_name(shape=domain_shape(ns)))
    if procs > 1 and name != "sharded":
        raise UnsupportedConfigError(
            f"--backend {name} runs the whole domain in each of the "
            f"{procs} processes; a multi-process run takes --backend "
            "sharded (or auto), whose mesh spans them",
            combo="distributed+backend")
    if procs > 1 and getattr(ns, "autotune", False):
        raise UnsupportedConfigError(
            f"--autotune would measure and keep a record in each of the "
            f"{procs} processes, which may pick different engines; tune "
            "in one process and let the record steer the run",
            combo="distributed+autotune")
    cls = get_backend(name)
    logger = logging.getLogger("grayscott_tpu_torch")
    if logger.isEnabledFor(logging.DEBUG):
        from ..utils.device import capability_dump

        logger.debug("device capabilities:\n%s", capability_dump())
    params = simulation_parameters(ns)
    kwargs = cls.args_from_namespace(ns)
    sim = cls(params, boundary=ns.boundary, device=ns.device, **kwargs)
    if getattr(ns, "autotune", False) and name == "cuda":
        from ..bench import autotune

        # the K and tile pins restrict the candidates and key the record
        autotune.autotune(params, domain_shape(ns), ns.boundary,
                          verbose=True, dtype=sim.dtype, device=ns.device,
                          **sim.pins())
    elif getattr(ns, "autotune", False) and name == "sharded":
        from ..bench import autotune

        # every pin restricts the candidates and keys the record
        autotune.sharded_autotune(
            params, domain_shape(ns), ns.boundary, verbose=True,
            dtype=sim.dtype, n_devices=kwargs["n_devices"],
            mesh_cols=kwargs["mesh_cols"], engine=kwargs["engine"],
            overlap=kwargs["overlap"],
            steps_per_call=kwargs["steps_per_call"],
            block_rows=kwargs["block_rows"],
            block_cols=kwargs["block_cols"], device=ns.device)
    return sim


def simulation_parameters(ns: argparse.Namespace) -> Parameters:
    """The defaults overlaid with the CLI's values; a --preset gives the
    (feed, kill) pair, and explicit -f/-k override it."""
    kwargs = {}
    if ns.killrate is not None:
        kwargs["kill_rate"] = ns.killrate
    if ns.feedrate is not None:
        kwargs["feed_rate"] = ns.feedrate
    if ns.deltat is not None:
        kwargs["time_step"] = ns.deltat
    preset = getattr(ns, "preset", None)
    if preset:
        return Parameters.with_preset(preset, stencil=ns.stencil, **kwargs)
    return Parameters.with_stencil(ns.stencil, **kwargs)


def domain_shape(ns: argparse.Namespace) -> Tuple[int, int]:
    return (ns.nbrow, ns.nbcol)


def simulation_output_path(path) -> str:
    """The output file name, ``output.h5`` by default."""
    return str(path) if path else "output.h5"


def bounded_put(q: queue.Queue, item, dead, timeout: float = 1.0) -> bool:
    """Put ``item`` on the bounded queue ``q``, checking ``dead()`` while
    it is full: a plain ``q.put`` would hang forever once the consumer
    thread died (full disk, unwritable file). False when ``dead()`` says
    no consumer remains."""
    while True:
        try:
            q.put(item, timeout=timeout)
            return True
        except queue.Full:
            if dead():
                return False
