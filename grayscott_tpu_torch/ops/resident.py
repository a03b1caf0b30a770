"""K3, the resident multistep: the wrapper of ``csrc/resident.cu``.

The port's ``resident_multistep`` of ``grayscott_tpu/ops/pallas_stencil.py``
(``:1405-1460``): one call advances the whole ``(R, C)`` state by any
number of steps, a run-time count, in one launch. The state is a pair of
buffer pairs, ``(u, v)`` and ``(u_next, v_next)``, that the steps take
turns to write; :func:`multistep` returns the four in the order in which
the first pair holds the result. On a CUDA tensor it makes one cooperative
launch on the current stream, or raises. On a CPU tensor it runs the plain
PyTorch version, :func:`resident_reference`, since there is no kernel to
launch on the CPU.

``launches`` counts the kernel launches, and only them, so that a run can
show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..params import KernelConstants
from . import build, checks, stencil

#: kernel launches so far (CPU calls run the plain version and add nothing)
launches = 0

_fn = None


#: the plain PyTorch version: ``steps`` calls of ``stencil.step``
resident_reference = stencil.run


def _kernel():
    global _fn
    if _fn is None:
        _fn = build.bind("gs_resident_multistep",
                         [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                         + [ctypes.c_float] * 14 + [ctypes.c_int]
                         + [ctypes.c_void_p] * 2)
    return _fn


def max_blocks(device: torch.device) -> int:
    """The most blocks of one launch that are co-resident on ``device``."""
    index = torch.device(device).index
    n = build.bind("gs_resident_max_blocks", [ctypes.c_int])(
        torch.cuda.current_device() if index is None else index)
    if n <= 0:
        raise RuntimeError(f"resident kernel occupancy query failed: CUDA "
                           f"error {-n} ({build.error_name(-n)})")
    return n


def multistep(u: torch.Tensor, v: torch.Tensor, u_next: torch.Tensor,
              v_next: torch.Tensor, steps: int, consts: KernelConstants,
              boundary: str, grid: int = 0
              ) -> Tuple[torch.Tensor, ...]:
    """Advance ``(u, v)`` by ``steps`` (>= 1) steps through the buffer
    pairs ``(u, v)`` and ``(u_next, v_next)``. Returns the four buffers
    with the result first: ``(u, v, u_next, v_next)`` for an even step
    count, ``(u_next, v_next, u, v)`` for an odd one. ``grid``: the blocks
    of the launch, 0 for the co-resident maximum. On a CUDA device the
    launch is enqueued on the current stream and not waited for."""
    global launches
    checks.check_count("steps", steps, 1)
    checks.check_count("grid", grid, 0)
    checks.check_boundary(boundary)
    checks.check_state((), (u, v, u_next, v_next))
    order = (u, v, u_next, v_next) if steps % 2 == 0 else \
        (u_next, v_next, u, v)
    if u.device.type == "cpu":
        ru, rv = resident_reference(u, v, steps, consts, boundary)
        order[0].copy_(ru)
        order[1].copy_(rv)
        return order
    fn = _kernel()
    rows, cols = u.shape
    barrier = torch.zeros(1, dtype=torch.int64, device=u.device)
    stream = torch.cuda.current_stream(u.device).cuda_stream
    err = fn(u.data_ptr(), v.data_ptr(), u_next.data_ptr(),
             v_next.data_ptr(), rows, cols, steps, int(boundary == "naive"),
             u.device.index, *consts.weights, *consts.reaction, grid,
             barrier.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"resident kernel launch failed: CUDA error {err} "
                           f"({build.error_name(err)})")
    launches += 1
    return order
