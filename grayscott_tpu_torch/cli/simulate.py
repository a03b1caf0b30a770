"""Batch simulation CLI: the port's ``grayscott_tpu/cli/simulate.py``.

Argument-compatible with the JAX ``simulate`` (``-n/--nbimage`` default
1000, ``-o/--output`` default ``output.h5``, ``--output-buffer`` default
2, 32 steps per image), without its ``--snapshot-dtype``, ``--checkpoint``
and ``--resume``, which are not ported yet.

:func:`run` is the stepping loop and keeps the JAX pipeline's overlap
(``grayscott_tpu/cli/simulate.py:175-188``): it enqueues a batch, clones V
into a fresh device buffer (the ping-pong pair is overwritten by the next
batch), copies the clone into pinned host memory without blocking and
records an event, all on the launch stream; it then waits only for the
*previous* image's event before handing that image to the sink, so the
host never waits on the batch it just enqueued. :func:`main` passes a
sink that feeds the bounded queue of the HDF5 writer thread.
"""

from __future__ import annotations

import argparse
import queue
import sys
import threading
from typing import Callable

import numpy as np
import torch

from ..backends.base import Simulation
from ..io.hdf5 import Writer
from ..species import Species
from ..utils.logs import init_logging
from ..utils.progress import ProgressBar
from . import shared


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="simulate", description="Perform Gray-Scott simulation"
    )
    shared.add_shared_args(parser)
    parser.add_argument(
        "-n", "--nbimage", type=int, default=1000,
        help="Number of images to be created",
    )
    parser.add_argument(
        "-o", "--output", default=None, help="Path to the results output file"
    )
    parser.add_argument(
        "--output-buffer", type=int, default=2,
        help="Size of the image buffer between the compute and I/O thread",
    )
    return parser


def run(sim: Simulation, species: Species, nbimage: int,
        steps_per_image: int, sink: Callable[[np.ndarray], None]) -> None:
    """Advance ``nbimage`` batches of ``steps_per_image`` steps and hand V
    after each batch to ``sink``, in order, as a host array of its own."""
    cuda = sim.device.type == "cuda"
    pending = None  # (host frame, its copy's event) of the previous image
    for _ in range(nbimage):
        sim.prepare_steps(species, steps_per_image)
        snapshot = species.result().clone()
        if cuda:
            frame = torch.empty(snapshot.shape, dtype=snapshot.dtype,
                                pin_memory=True)
            frame.copy_(snapshot, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(torch.cuda.current_stream(sim.device))
        else:
            frame, copied = snapshot, None
        if pending is not None:
            _deliver(*pending, sink)
        pending = (frame, copied)
    if pending is not None:
        _deliver(*pending, sink)


def _deliver(frame: torch.Tensor, copied, sink) -> None:
    if copied is not None:
        copied.synchronize()
    sink(frame.numpy())


def main(argv=None) -> int:
    logger = init_logging()
    args = build_parser().parse_args(argv)
    steps_per_image = args.nbextrastep if args.nbextrastep is not None else 32
    file_name = shared.simulation_output_path(args.output)

    sim = shared.make_simulation(args)
    species = sim.make_species(shared.domain_shape(args))
    logger.info(
        "backend=%s engine=%s device=%s boundary=%s stencil=%s "
        "domain=%dx%d", sim.name, species.storage[0], sim.device,
        sim.boundary, sim.params.stencil_name(), species.shape[0],
        species.shape[1],
    )
    writer = Writer(file_name, species.shape, args.nbimage)
    progress = ProgressBar("Running simulation step", args.nbimage)
    error: list[BaseException] = []
    q: queue.Queue = queue.Queue(maxsize=max(args.output_buffer, 1))

    def io_thread() -> None:
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                writer.write(item)
                progress.inc(1)
        except BaseException as e:  # raised again on the main thread
            error.append(e)

    def sink(frame: np.ndarray) -> None:
        # a dead writer (full disk, unwritable file) stops the run
        if error or not shared.bounded_put(q, frame, lambda: bool(error)):
            raise error[0]

    t = threading.Thread(target=io_thread, name="hdf5-writer", daemon=True)
    t.start()
    try:
        run(sim, species, args.nbimage, steps_per_image, sink)
    finally:
        shared.bounded_put(q, None, lambda: bool(error))
        t.join()
        progress.finish()
        writer.close()
    if error:
        raise error[0]
    logger.info("wrote %d images to %s", args.nbimage, file_name)
    return 0


if __name__ == "__main__":
    sys.exit(main())
