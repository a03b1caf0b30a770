"""K9, the row-split resident multistep: the wrapper of ``csrc/ilpsplit.cu``.

The port of ``scripts/ilpsplit.py:run_split``: the resident step (K3,
:mod:`.resident`) for a run-time number of steps, computed as ``split`` row
slabs, each with one overlap row into each interior neighbour. The result
is bitwise K3's at every split: the split changes how the work is
scheduled, never what is computed.

:func:`split_multistep` has :func:`.resident.multistep`'s contract. On a
CUDA tensor it makes one cooperative launch on the current stream, or
raises. On a CPU tensor it runs the plain PyTorch version,
:func:`split_reference`, since there is no kernel to launch on the CPU.
``launches`` counts the kernel launches, and only them.

Slab heights come in quanta (:func:`slab_heights`): on the card a quantum
is a row of 32x32 tiles (``TILE`` rows), since each tile is stepped whole;
on the CPU, where nothing is tiled, one row. The heights change only which
slab computes a row, never its value.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import torch

from ..params import KernelConstants
from . import build, checks, stencil

#: kernel launches so far (CPU calls run the plain version and add nothing)
launches = 0

#: rows of a slab quantum on the card: the kernels' tile edge
TILE = 32

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        _fn = build.bind("gs_ilpsplit_multistep",
                         [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                         + [ctypes.c_float] * 14 + [ctypes.c_int]
                         + [ctypes.c_void_p] * 2)
    return _fn


def slab_heights(rows: int, split: int, quantum: int = 1) -> List[int]:
    """The rows of each of ``split`` slabs (``ilpsplit.py:49-56``): the
    rows' ``ceil(rows / quantum)`` quanta shared equally, the remainder one
    quantum each to the leading slabs, and the last slab short by the part
    of its last quantum that lies past ``rows``. Raises when there are
    fewer quanta than slabs."""
    checks.check_count("quantum", quantum, 1)
    n = -(-rows // quantum)
    checks.check_count("split", split, 1, n)
    base, extra = divmod(n, split)
    heights = [(base + (k < extra)) * quantum for k in range(split)]
    heights[-1] -= n * quantum - rows
    return heights


def split_reference(u: torch.Tensor, v: torch.Tensor, steps: int,
                    consts: KernelConstants, boundary: str, split: int,
                    quantum: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version (``ilpsplit.py:57-93``): each step runs
    ``stencil.step`` on each slab's rows plus one overlap row into each
    interior neighbour, keeps the slab's own rows and stacks them; the
    overlap rows, which see a false edge, are dropped. The TPU kernel's
    ``unroll`` groups the same steps in the same order, so it has no
    counterpart here."""
    rows = u.shape[0]
    slabs, lo = [], 0
    for h in slab_heights(rows, split, quantum):
        a, b = max(lo - 1, 0), min(lo + h + 1, rows)
        slabs.append((a, b, lo - a, h))
        lo += h
    for _ in range(steps):
        outs = [stencil.step(u[a:b], v[a:b], consts, boundary)
                for a, b, _, _ in slabs]
        u, v = (torch.cat([o[i][off:off + h] for o, (_, _, off, h)
                           in zip(outs, slabs)])
                for i in (0, 1))
    return u, v


def max_blocks(device: torch.device) -> int:
    """The most blocks of one launch that are co-resident on ``device``."""
    index = torch.device(device).index
    n = build.bind("gs_ilpsplit_max_blocks", [ctypes.c_int])(
        torch.cuda.current_device() if index is None else index)
    if n <= 0:
        raise RuntimeError(f"ilpsplit kernel occupancy query failed: CUDA "
                           f"error {-n} ({build.error_name(-n)})")
    return n


def split_multistep(u: torch.Tensor, v: torch.Tensor, u_next: torch.Tensor,
                    v_next: torch.Tensor, steps: int,
                    consts: KernelConstants, boundary: str, split: int,
                    grid: int = 0) -> Tuple[torch.Tensor, ...]:
    """Advance ``(u, v)`` by ``steps`` (>= 1) steps in ``split`` row slabs
    through the buffer pairs ``(u, v)`` and ``(u_next, v_next)``. Returns
    the four buffers with the result first, as
    :func:`.resident.multistep`. ``grid``: the blocks of the launch, 0 for
    the co-resident maximum; at least ``split``. On a CUDA device the
    launch is enqueued on the current stream and not waited for."""
    global launches
    checks.check_count("steps", steps, 1)
    checks.check_count("split", split, 1)
    checks.check_count("grid", grid, 0)
    if 0 < grid < split:
        raise ValueError(f"a grid of {grid} blocks cannot hold {split} "
                         "slabs of at least one block each")
    checks.check_boundary(boundary)
    checks.check_state((), (u, v, u_next, v_next))
    on_cpu = u.device.type == "cpu"
    slab_heights(u.shape[0], split, 1 if on_cpu else TILE)
    order = (u, v, u_next, v_next) if steps % 2 == 0 else \
        (u_next, v_next, u, v)
    if on_cpu:
        ru, rv = split_reference(u, v, steps, consts, boundary, split)
        order[0].copy_(ru)
        order[1].copy_(rv)
        return order
    fn = _kernel()
    rows, cols = u.shape
    arrivals = torch.zeros(split, dtype=torch.int64, device=u.device)
    stream = torch.cuda.current_stream(u.device).cuda_stream
    err = fn(u.data_ptr(), v.data_ptr(), u_next.data_ptr(),
             v_next.data_ptr(), rows, cols, steps, int(boundary == "naive"),
             split, u.device.index, *consts.weights,
             *consts.reaction, grid, arrivals.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"ilpsplit kernel launch failed: CUDA error {err} "
                           f"({build.error_name(err)})")
    launches += 1
    return order
