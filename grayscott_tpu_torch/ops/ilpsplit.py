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

The kernel steps K3's tiles on the Hopper tile stepper
(``csrc/gs_tile_sm90.cuh``: 32x32 tiles in 34x34 windows, register strips,
interior tiles, the tap set at compile time, the next window prefetched
while a tile steps). :func:`split_ablation` runs it with one part of that
design taken out, or in its first form (``ABLATIONS``), for timing what
each part buys; its launches are not the main path's and are not counted.

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

#: the parts of the design that ``split_ablation`` takes out
#: (csrc/ilpsplit.cu: gs_ilpsplit_ablation); each gives the whole kernel's
#: result. Parts 1-4 take the default stencil's tap set only.
ABLATIONS = {
    0: "the first form's kernel (gs_tile.cuh)",
    1: "every tile an edge tile",
    2: "the tap set tested at run time",
    3: "no prefetch of the next window",
    4: "the co-resident maximum grid instead of the even one",
}

_fn = None
_ablation_fn = None

#: the C arguments of gs_ilpsplit_multistep
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
             + [ctypes.c_float] * 14 + [ctypes.c_int]
             + [ctypes.c_void_p] * 2)


def _kernel():
    global _fn
    if _fn is None:
        _fn = build.bind("gs_ilpsplit_multistep", _ARGTYPES)
    return _fn


def _ablation_kernel():
    global _ablation_fn
    if _ablation_fn is None:
        _ablation_fn = build.bind("gs_ilpsplit_ablation",
                                  _ARGTYPES + [ctypes.c_int])
    return _ablation_fn


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
    order = _check(u, v, u_next, v_next, steps, boundary, split, grid)
    if u.device.type == "cpu":
        ru, rv = split_reference(u, v, steps, consts, boundary, split)
        order[0].copy_(ru)
        order[1].copy_(rv)
        return order
    _launch(_kernel(), (u, v, u_next, v_next), steps, consts, boundary,
            split, grid)
    launches += 1
    return order


def split_ablation(u: torch.Tensor, v: torch.Tensor, u_next: torch.Tensor,
                   v_next: torch.Tensor, steps: int, consts: KernelConstants,
                   boundary: str, split: int, part: int, grid: int = 0
                   ) -> Tuple[torch.Tensor, ...]:
    """:func:`split_multistep` on the card with one part of K9's design
    taken out (``ABLATIONS[part]``). The result, and the order of the
    returned buffers, are the whole kernel's. Not counted in
    ``launches``."""
    order = _check(u, v, u_next, v_next, steps, boundary, split, grid)
    if part not in ABLATIONS:
        raise ValueError(f"part must be one of {sorted(ABLATIONS)}, got "
                         f"{part!r}")
    if u.device.type != "cuda":
        raise ValueError("an ablation runs the kernel: the buffers must lie "
                         f"on a CUDA device, not {u.device}")
    fn = _ablation_kernel()
    _launch(lambda *args: fn(*args, part), (u, v, u_next, v_next), steps,
            consts, boundary, split, grid)
    return order


def _check(u, v, u_next, v_next, steps, boundary, split, grid):
    """The checks of K9's wrappers; the buffers with the result first."""
    checks.check_count("steps", steps, 1)
    checks.check_count("split", split, 1)
    checks.check_count("grid", grid, 0)
    if 0 < grid < split:
        raise ValueError(f"a grid of {grid} blocks cannot hold {split} "
                         "slabs of at least one block each")
    checks.check_boundary(boundary)
    checks.check_state((), (u, v, u_next, v_next))
    slab_heights(u.shape[0], split, 1 if u.device.type == "cpu" else TILE)
    return (u, v, u_next, v_next) if steps % 2 == 0 else \
        (u_next, v_next, u, v)


def _launch(fn, bufs, steps, consts, boundary, split, grid):
    """One launch of ``fn`` (a bound ``gs_ilpsplit_*`` entry) on the
    current stream; raises on a refusal."""
    u = bufs[0]
    rows, cols = u.shape
    arrivals = torch.zeros(split, dtype=torch.int64, device=u.device)
    stream = torch.cuda.current_stream(u.device).cuda_stream
    err = fn(*(b.data_ptr() for b in bufs), rows, cols, steps,
             int(boundary == "naive"), split, u.device.index,
             *consts.weights, *consts.reaction, grid, arrivals.data_ptr(),
             stream)
    if err != 0:
        raise RuntimeError(f"ilpsplit kernel launch failed: CUDA error {err} "
                           f"({build.error_name(err)})")
