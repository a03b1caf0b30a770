"""Batch simulation CLI: the port's ``grayscott_tpu/cli/simulate.py``.

Argument-compatible with the JAX ``simulate`` (``-n/--nbimage`` default
1000, ``-o/--output`` default ``output.h5``, ``--output-buffer`` default
2, 32 steps per image, ``--snapshot-dtype``, ``--checkpoint``,
``--resume``), plus ``--device``.

:func:`run` is the stepping loop, with the JAX pipeline's overlap
(``grayscott_tpu/cli/simulate.py:160-188``): after each batch it copies V
into a fresh device buffer on the launch stream (the next batch overwrites
the state; a result that is a tensor of its own already, bf16 storage
widened to float32 or the shards reassembled, is not copied again) and
records an event; a copy stream of its own waits on that
event and copies the buffer into pinned host memory while the next batch
runs on the launch stream. The host waits only for the *previous* image's
copy before handing that image to the sink, in order, so it never waits
on the batch it just enqueued. Each image has a pinned frame of its own
(PyTorch's pinned-memory cache recycles them once the sink lets go): the
sink may keep a frame, or queue it for a writer thread, and no later copy
writes into it. With ``--snapshot-dtype bfloat16`` the fresh buffer is V
cast to bfloat16 on the device (a cast that changes the dtype makes a
buffer of its own; with bf16 storage it holds exactly the stored bits),
the host frame is bfloat16 and is widened to float32 on the host; the
HDF5 file stays float32. :func:`main` passes a sink that
feeds the bounded queue of the HDF5 writer thread.

``--resume PATH`` starts from a checkpoint (``io/checkpoint.py``) through
the backend's ``build_storage``, with its step count; ``--checkpoint
PATH`` writes U, V, the parameters and the step count once the writer
thread has finished.

Several processes (``grayscott_tpu/cli/simulate.py:89-200``): :func:`main`
first joins the process group that ``GRAYSCOTT_COORDINATOR`` asks for
(``utils/distributed.py``); each process then steps its own shards of the
``sharded`` backend, and :func:`run` gathers each image from every
process's block (``distributed.fetch``, collective) where it hands the
previous image to the sink, so the host still never waits on the batch it
just enqueued. Process 0 alone holds the HDF5 writer and the progress bar
and writes the checkpoint, which every process gathers; with ``--resume``
every process reads the file and builds its own shards.
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
from ..utils import distributed
from ..utils.logs import init_logging
from ..utils.progress import ProgressBar
from ..utils.runtime import apply_env_config
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
    parser.add_argument(
        "--snapshot-dtype", choices=["float32", "bfloat16"],
        default="float32",
        help="Precision of the device->host snapshot TRANSFER. bfloat16 "
        "halves the bytes over bandwidth-starved links (tunneled or "
        "remote chips); the HDF5 file stays float32 (upcast host-side), "
        "at ~3 significant digits — visualization-grade, not "
        "parity-grade",
    )
    parser.add_argument(
        "--checkpoint", default=None,
        help="Write full simulation state (U and V) here when done, "
        "for later --resume (capability the reference lacks)",
    )
    parser.add_argument(
        "--resume", default=None,
        help="Initialize state from a checkpoint instead of the standard box",
    )
    return parser


#: --snapshot-dtype -> the dtype of the device-to-host copy
SNAPSHOT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


#: ``run``'s snapshot pipeline with one part taken out (``ablation=``), for
#: timing in turns: part 0 is its first form, the device-to-host copy on
#: the launch stream, so the next batch waits for it
ABLATIONS = {0: "the copy on the launch stream (the first form)"}


def run(sim: Simulation, species: Species, nbimage: int,
        steps_per_image: int, sink: Callable[[np.ndarray], None],
        snapshot_dtype: str = "float32", ablation: int | None = None
        ) -> None:
    """Advance ``nbimage`` batches of ``steps_per_image`` steps and hand V
    after each batch to ``sink``, in order, as a float32 host array of its
    own, copied from the device in ``snapshot_dtype``; on the card the copy
    overlaps the next batch (``ablation=0``: it does not). With several
    processes every process runs it, and each image reaches every sink
    whole (a collective gather of the processes' blocks)."""
    if ablation not in (None, *ABLATIONS):
        raise ValueError(f"ablation must be None or one of "
                         f"{sorted(ABLATIONS)}, got {ablation!r}")
    cuda = sim.device.type == "cuda"
    dtype = SNAPSHOT_DTYPES[snapshot_dtype]
    blocks = species.blocks()
    if cuda:
        launch = torch.cuda.current_stream(sim.device)
        copy = launch if ablation == 0 else torch.cuda.Stream(sim.device)
    pending = None  # (host frame, its copy's event) of the previous image
    for _ in range(nbimage):
        sim.prepare_steps(species, steps_per_image)
        v = species.result()
        if v.dtype != dtype:
            snapshot = v.to(dtype)
        else:  # a fresh result (bf16 storage widened, shards reassembled)
            snapshot = v if sim.fresh_result else v.clone()
        if cuda:
            frame = torch.empty(snapshot.shape, dtype=snapshot.dtype,
                                pin_memory=True)
            cloned = torch.cuda.Event()
            cloned.record(launch)
            copy.wait_event(cloned)
            with torch.cuda.stream(copy):
                frame.copy_(snapshot, non_blocking=True)
                copied = torch.cuda.Event()
                copied.record(copy)
            # the allocator may hand the snapshot's memory to the next batch
            # only once the copy stream has read it
            snapshot.record_stream(copy)
        else:
            frame, copied = snapshot, None
        if pending is not None:
            _deliver(*pending, sink, blocks)
        pending = (frame, copied)
    if pending is not None:
        _deliver(*pending, sink, blocks)


def _deliver(frame: torch.Tensor, copied, sink, blocks) -> None:
    if copied is not None:
        copied.synchronize()
    if blocks is not None:
        frame = distributed.gather(frame, blocks)
    sink(frame.float().numpy())


def main(argv=None) -> int:
    logger = init_logging()
    apply_env_config()
    distributed.maybe_initialize(logger)
    args = build_parser().parse_args(argv)
    steps_per_image = args.nbextrastep if args.nbextrastep is not None else 32
    file_name = shared.simulation_output_path(args.output)

    sim = shared.make_simulation(args)
    if args.resume:
        from ..io.checkpoint import load_state

        u0, v0, ck_params, ck_steps = load_state(args.resume)
        if ck_params != sim.params:
            logger.warning(
                "checkpoint parameters differ from CLI parameters; "
                "using CLI parameters"
            )
        species = Species(u0.shape, sim.build_storage(u0, v0), sim)
        species.steps_performed = ck_steps
        logger.info("resumed from %s at step %d", args.resume, ck_steps)
    else:
        species = sim.make_species(shared.domain_shape(args))
    # the shape the run simulates: a resumed checkpoint's domain wins over
    # the -r/-c defaults
    tag = species.storage[0]
    logger.info(
        "backend=%s engine=%s device=%s boundary=%s stencil=%s "
        "domain=%dx%d", sim.name, tag if isinstance(tag, str) else "-",
        sim.device, sim.boundary, sim.params.stencil_name(),
        species.shape[0], species.shape[1],
    )
    # one process owns the output file and the progress bar; the others
    # still run the compute and the collective gather of every image
    primary = distributed.is_primary()
    writer = (Writer(file_name, species.shape, args.nbimage) if primary
              else None)
    progress = (ProgressBar("Running simulation step", args.nbimage)
                if primary else None)
    error: list[BaseException] = []
    q: queue.Queue = queue.Queue(maxsize=max(args.output_buffer, 1))

    def io_thread() -> None:
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if writer is not None:
                    writer.write(item)
                    progress.inc(1)
        except BaseException as e:  # raised again on the main thread
            error.append(e)

    gathered = []

    def sink(frame: np.ndarray) -> None:
        # a dead writer (full disk, unwritable file) stops the run
        if error or not shared.bounded_put(q, frame, lambda: bool(error)):
            raise error[0]
        if not gathered:
            gathered.append(True)
            logger.info("process %d has image 1 of %d",
                        distributed.process_index(), args.nbimage)

    t = threading.Thread(target=io_thread, name="hdf5-writer", daemon=True)
    t.start()
    try:
        run(sim, species, args.nbimage, steps_per_image, sink,
            args.snapshot_dtype)
    finally:
        shared.bounded_put(q, None, lambda: bool(error))
        t.join()
        if writer is not None:
            progress.finish()
            writer.close()
    if error:
        raise error[0]
    if args.checkpoint:
        from ..io.checkpoint import save_state

        u, v = species.uv_host()  # collective: every process gathers
        if primary:
            save_state(args.checkpoint, u, v, sim.params,
                       species.steps_performed)
            logger.info("checkpoint written to %s", args.checkpoint)
    if primary:
        logger.info("wrote %d images to %s", args.nbimage, file_name)
    return 0


if __name__ == "__main__":
    sys.exit(main())
