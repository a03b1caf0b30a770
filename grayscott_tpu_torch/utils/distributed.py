"""Several processes: the port's ``grayscott_tpu/utils/distributed.py``,
on ``torch.distributed``.

JAX's ``simulate`` calls ``maybe_initialize`` first
(``grayscott_tpu/cli/simulate.py:91``): with ``GRAYSCOTT_COORDINATOR``
set, every process joins one program, the sharded backend's mesh spans
every process, and process 0 alone writes the output. The port does the
same over a gloo process group:

- :func:`maybe_initialize` reads JAX's variables (``GRAYSCOTT_COORDINATOR
  =host:port``, ``GRAYSCOTT_NUM_PROCESSES``, ``GRAYSCOTT_PROCESS_ID``,
  ``GRAYSCOTT_HEARTBEAT_S``), or, for ``GRAYSCOTT_COORDINATOR=auto``,
  torch's own ``env://`` (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
  ``WORLD_SIZE``, as ``torchrun`` sets them), which plays the part of
  JAX's cluster auto-detection; a no-op with the variable unset;
- :func:`fetch` is collective, as JAX's is: every process calls it and
  every process gets the whole array, which the processes' equal blocks
  (:class:`Blocks`) tile;
- :func:`is_primary` names the process that writes files (process 0).

Each process steps its own shards on its own card, ``cuda:{LOCAL_RANK}``,
else ``cuda:{process_index % device_count()}``: processes may share one
card. The transport is gloo: the halo bands that cross processes go
through pinned host buffers (``parallel/halo.py``). NCCL, one rank a card,
and K7 across processes are ROADMAP.md Queue 1 item 7.3.

The group forms on the TCP store of torch's own rendezvous for the
variables' URL (process 0 hosts it, or, under ``torchrun``, the elastic
agent does), which waits :data:`STARTUP_TIMEOUT_S` (300 s, the default
``initialization_timeout`` of ``jax.distributed.initialize``) for every
peer to join, so a process may start that long after the others. A dead peer fails the survivors'
next send, receive or gather (gloo's connection closes; else the group's
timeout, ``GRAYSCOTT_HEARTBEAT_S``, default 100 s, ends the wait): they
raise and exit non-zero, never hang.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Tuple

import numpy as np
import torch

#: the variable that asks for a multi-process run
COORDINATOR_VAR = "GRAYSCOTT_COORDINATOR"
#: JAX's default peer-failure bound, seconds
DEFAULT_HEARTBEAT_S = 100
#: how long the store waits for every peer to join, seconds: JAX's
#: ``initialization_timeout`` default (it exposes no variable for it)
STARTUP_TIMEOUT_S = 300


def _positive_int(name: str, raw: str | None, low: int = 1) -> int:
    """The integer of variable ``name`` (at least ``low``), else stop with a
    message that names it."""
    if raw is None or raw == "":
        raise ValueError(f"{name} is not set, and a multi-process run "
                         f"({COORDINATOR_VAR}) needs it")
    try:
        value = int(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r} is not an integer") from None
    if value < low:
        raise ValueError(f"{name}={raw!r} must be at least {low}")
    return value


def config(env=None) -> dict | None:
    """The process group that the variables of ``env`` (default
    ``os.environ``) ask for: ``init_method``, ``world_size``, ``rank`` and
    ``timeout`` (seconds), or None when ``GRAYSCOTT_COORDINATOR`` is unset
    or empty. A missing or malformed variable raises ``ValueError`` naming
    it."""
    env = os.environ if env is None else env
    coord = env.get(COORDINATOR_VAR)
    if not coord:
        return None
    heartbeat = _positive_int("GRAYSCOTT_HEARTBEAT_S",
                              env.get("GRAYSCOTT_HEARTBEAT_S",
                                      str(DEFAULT_HEARTBEAT_S)))
    if coord == "auto":
        for name in ("MASTER_ADDR", "MASTER_PORT"):
            if not env.get(name):
                raise ValueError(f"{COORDINATOR_VAR}=auto reads torch's "
                                 f"env:// variables, and {name} is not set")
        _positive_int("MASTER_PORT", env["MASTER_PORT"])
        world = _positive_int("WORLD_SIZE", env.get("WORLD_SIZE"))
        rank = _positive_int("RANK", env.get("RANK"), low=0)
        init = "env://"
    else:
        host, sep, port = coord.rpartition(":")
        if not sep or not host:
            raise ValueError(f"{COORDINATOR_VAR}={coord!r} is not host:port "
                             "(or auto)")
        _positive_int(f"the port of {COORDINATOR_VAR}", port)
        world = _positive_int("GRAYSCOTT_NUM_PROCESSES",
                              env.get("GRAYSCOTT_NUM_PROCESSES"))
        rank = _positive_int("GRAYSCOTT_PROCESS_ID",
                             env.get("GRAYSCOTT_PROCESS_ID"), low=0)
        init = f"tcp://{coord}"
    if rank >= world:
        raise ValueError(f"process id {rank} is outside the {world} "
                         "processes of the run")
    return {"init_method": init, "world_size": world, "rank": rank,
            "timeout": heartbeat}


def maybe_initialize(logger=None) -> bool:
    """Join the gloo process group that the variables ask for
    (:func:`config`), and make this process's card the current one; False,
    with nothing started, when ``GRAYSCOTT_COORDINATOR`` is unset or empty.
    The peers have :data:`STARTUP_TIMEOUT_S` to join, and the heartbeat
    bounds every collective after that; a group that does not form
    raises."""
    cfg = config()
    if cfg is None:
        return False
    import torch.distributed as dist

    # torch's own rendezvous, with the longer wait: it parses the URL,
    # makes process 0 the store's host (or, under torchrun, every process
    # a client of the agent's store) and waits for the peers to join
    store, _, _ = next(dist.rendezvous(
        cfg["init_method"], cfg["rank"], cfg["world_size"],
        timeout=datetime.timedelta(seconds=STARTUP_TIMEOUT_S)))
    dist.init_process_group(
        "gloo", store=store, world_size=cfg["world_size"],
        rank=cfg["rank"], timeout=datetime.timedelta(seconds=cfg["timeout"]))
    device = local_device()
    if device is not None:
        torch.cuda.set_device(device)
    if logger is not None:
        logger.info(
            "distributed: process %d/%d over gloo, device %s (halo bands "
            "through pinned host memory; NCCL with one rank a card is "
            "ROADMAP.md Queue 1 item 7.3)", process_index(), process_count(),
            device if device is not None else "cpu")
    return True


def _group() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    """The processes of the run (1 without a process group)."""
    if not _group():
        return 1
    import torch.distributed as dist

    return dist.get_world_size()


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    if not _group():
        return 0
    import torch.distributed as dist

    return dist.get_rank()


def is_primary() -> bool:
    """True on the process that owns file output (process 0)."""
    return process_index() == 0


def local_device() -> torch.device | None:
    """This process's card: ``cuda:{LOCAL_RANK}``, else
    ``cuda:{process_index % device_count()}``; None without a card."""
    if not torch.cuda.is_available():
        return None
    local = os.environ.get("LOCAL_RANK")
    index = (int(local) if local not in (None, "")
             else process_index() % torch.cuda.device_count())
    return torch.device("cuda", index)


@dataclasses.dataclass(frozen=True)
class Blocks:
    """How the processes' equal blocks tile a domain: a ``grid`` of
    (rows, cols) blocks, process ``p`` at ``divmod(p, cols)``, the whole
    cropped to ``shape`` (cells past it belong to no domain)."""

    grid: Tuple[int, int]
    shape: Tuple[int, int]


def gather(x: torch.Tensor, blocks: Blocks) -> torch.Tensor:
    """The whole domain on the host from every process's block ``x``
    (all of one shape and dtype): an all-gather over the group, so every
    process must call it, in the same order."""
    import torch.distributed as dist

    x = x.detach().to("cpu").contiguous()
    parts = [torch.empty_like(x) for _ in range(process_count())]
    dist.all_gather(parts, x)
    n_r, n_c = blocks.grid
    rows = [torch.cat(parts[i * n_c:(i + 1) * n_c], dim=1)
            for i in range(n_r)]
    r, c = blocks.shape
    return torch.cat(rows, dim=0)[:r, :c].contiguous()


def fetch(x: torch.Tensor, blocks: Blocks | None = None) -> np.ndarray:
    """A host copy of ``x`` that later steps cannot overwrite, as a numpy
    array (bfloat16 widened to float32, which is exact). ``blocks``: ``x``
    is this process's block of a domain that the processes hold between
    them, and the copy is the whole domain (:func:`gather`: collective,
    every process calls it). None: ``x`` is whole on this process."""
    if blocks is not None:
        out = gather(x, blocks)
    else:
        if x.device.type == "cuda":
            torch.cuda.synchronize(x.device)
        out = x.to("cpu", copy=True)
    return (out.float() if out.dtype == torch.bfloat16 else out).numpy()
