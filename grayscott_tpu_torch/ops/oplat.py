"""K8, the dependent-op chain: the wrapper of ``csrc/oplat.cu``.

The port of ``scripts/oplat.py:run``: ``steps`` times a chain of ``n_ops``
dependent operations on a whole float32 array. Op ``j`` of a chain is
``x * 1.0000001 + 1e-7`` rounded once (a fused multiply-add, as the TPU
kernel's interpret run computes it) or, with ``rolls``, for ``j % 3 == 2``,
``roll(x, 1, axis=(j // 3) % 2)``. It measures per-op cost, so the kernel
does all the work that the chain names: every FMA, and every roll as a
whole-array data movement.

:func:`chain` launches the kernel on a CUDA tensor, or raises. On a CPU
tensor it runs the plain PyTorch version, :func:`chain_reference`, since
there is no kernel to launch on the CPU. ``launches`` counts the kernel
launches, and only them.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build, checks

#: kernel launches so far (CPU calls run the plain version and add nothing)
launches = 0

#: the chain's multiply-add constants, as float32 values
MUL = float(np.float32(1.0000001))
ADD = float(np.float32(1e-7))

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        _fn = build.bind("gs_oplat_chain",
                         [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
                         + [ctypes.c_void_p] * 2)
    return _fn


def is_roll(j: int, rolls: bool) -> bool:
    """Whether op ``j`` of a chain is a roll (``oplat.py:40``)."""
    return rolls and j % 3 == 2


def rolls_per_chain(n_ops: int, rolls: bool) -> int:
    return sum(is_roll(j, rolls) for j in range(n_ops))


def fmas(shape, steps: int, n_ops: int, rolls: bool) -> int:
    """The fused multiply-adds of one call: the ops that are no roll, on
    every cell."""
    return (shape[0] * shape[1] * steps
            * (n_ops - rolls_per_chain(n_ops, rolls)))


def chain_reference(x: torch.Tensor, steps: int, n_ops: int,
                    rolls: bool) -> torch.Tensor:
    """The plain version. Each multiply-add is computed in float64 and
    rounded once to float32: for float32 ``x`` with ``0.5 <= |x| < 2`` the
    float64 ``x * MUL + ADD`` is exact (it spans fewer than 53 bits), so
    this is the fused multiply-add bit for bit."""
    for _ in range(steps):
        for j in range(n_ops):
            if is_roll(j, rolls):
                x = torch.roll(x, 1, dims=(j // 3) % 2)
            else:
                x = (x.double() * MUL + ADD).float()
    return x


def max_blocks(device: torch.device) -> int:
    """The most blocks of one launch that are co-resident on ``device``."""
    index = torch.device(device).index
    n = build.bind("gs_oplat_max_blocks", [ctypes.c_int])(
        torch.cuda.current_device() if index is None else index)
    if n <= 0:
        raise RuntimeError(f"oplat kernel occupancy query failed: CUDA "
                           f"error {-n} ({build.error_name(-n)})")
    return n


def chain(x: torch.Tensor, steps: int, n_ops: int, rolls: bool,
          grid: int = 0) -> torch.Tensor:
    """``x`` after ``steps`` (>= 1) chains of ``n_ops`` (>= 1) ops, a new
    tensor (``oplat.run``). ``grid``: the blocks of the launch, 0 for the
    co-resident maximum. On a CUDA device one cooperative launch is
    enqueued on the current stream and not waited for."""
    global launches
    checks.check_count("steps", steps, 1)
    checks.check_count("n_ops", n_ops, 1)
    checks.check_count("grid", grid, 0)
    if not isinstance(rolls, bool):
        raise ValueError(f"rolls must be a bool, got {rolls!r}")
    out = torch.empty_like(x)
    checks.check_state((x,), (out,))
    if x.device.type == "cpu":
        return out.copy_(chain_reference(x, steps, n_ops, rolls))
    fn = _kernel()
    tmp = torch.empty_like(x)
    barrier = torch.zeros(1, dtype=torch.int64, device=x.device)
    rows, cols = x.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), out.data_ptr(), tmp.data_ptr(), rows, cols, steps,
             n_ops, int(rolls), x.device.index, grid, barrier.data_ptr(),
             stream)
    if err != 0:
        raise RuntimeError(f"oplat kernel launch failed: CUDA error {err} "
                           f"({build.error_name(err)})")
    launches += 1
    return out
