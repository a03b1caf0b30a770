"""K2, the single-card megakernel: the wrapper of ``csrc/mega.cu``.

The port's ``megastep`` of ``grayscott_tpu/ops/megakernel.py``
(``:888-1110``, single-chip mode): one call advances the state by
``n_blocks`` time blocks of ``steps`` (1..MEGA_STEPS) steps in one launch.
The state is one ``(2, R, C)`` pair per species, updated in place; slot 0
holds the state before and after the call (:func:`pair_state` builds
one). On a CUDA tensor it makes one cooperative launch on the current
stream, or raises. On a CPU tensor it runs the plain PyTorch version,
:func:`megastep_reference`, since there is no kernel to launch on the CPU.

``launches`` counts the kernel launches, and only them, so that a run can
show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from ..params import KernelConstants
from . import build, checks, stencil

#: most steps of one time block: the kernel's compile-time halo depth
MEGA_STEPS = 8

#: kernel launches so far (CPU calls run the plain version and add nothing)
launches = 0

_fn = None


#: the plain PyTorch version: ``steps`` calls of ``stencil.step``
megastep_reference = stencil.run


def pair_state(x: torch.Tensor) -> torch.Tensor:
    """An ``(R, C)`` state as a ``(2, R, C)`` pair: slot 0 holds ``x``,
    slot 1 is scratch (every cell is written before it is read)."""
    pair = torch.empty((2, *x.shape), dtype=x.dtype, device=x.device)
    pair[0].copy_(x)
    return pair


def _kernel():
    global _fn
    if _fn is None:
        max_steps = build.bind("gs_mega_max_steps", [])()
        if max_steps != MEGA_STEPS:
            raise RuntimeError(
                f"mega kernel takes at most {max_steps} steps a time block; "
                f"this wrapper expects {MEGA_STEPS}")
        _fn = build.bind("gs_mega_multistep",
                         [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
                         + [ctypes.c_float] * 14 + [ctypes.c_int]
                         + [ctypes.c_void_p] * 2)
    return _fn


def max_blocks(device: torch.device) -> int:
    """The most blocks of one launch that are co-resident on ``device``."""
    index = torch.device(device).index
    n = build.bind("gs_mega_max_blocks", [ctypes.c_int])(
        torch.cuda.current_device() if index is None else index)
    if n <= 0:
        raise RuntimeError(f"mega kernel occupancy query failed: CUDA "
                           f"error {-n} ({build.error_name(-n)})")
    return n


def megastep(u_pair: torch.Tensor, v_pair: torch.Tensor, n_blocks: int,
             steps: int, consts: KernelConstants, boundary: str,
             grid: int = 0) -> None:
    """Advance slot 0 of the pairs by ``n_blocks`` x ``steps`` steps, in
    place. ``grid``: the blocks of the launch, 0 for the co-resident
    maximum. On a CUDA device the launch is enqueued on the current stream
    and not waited for."""
    global launches
    checks.check_count("n_blocks", n_blocks, 1)
    checks.check_count("steps", steps, 1, MEGA_STEPS)
    checks.check_count("grid", grid, 0)
    checks.check_boundary(boundary)
    checks.check_state((), (u_pair, v_pair), ndim=3)
    if u_pair.shape[0] != 2:
        raise ValueError(f"the pairs must be (2, R, C), got "
                         f"{tuple(u_pair.shape)}")
    if u_pair.device.type == "cpu":
        ru, rv = megastep_reference(u_pair[0], v_pair[0], n_blocks * steps,
                                    consts, boundary)
        u_pair[0].copy_(ru)
        v_pair[0].copy_(rv)
        return
    fn = _kernel()
    _, rows, cols = u_pair.shape
    barrier = torch.zeros(1, dtype=torch.int64, device=u_pair.device)
    stream = torch.cuda.current_stream(u_pair.device).cuda_stream
    err = fn(u_pair.data_ptr(), v_pair.data_ptr(), rows, cols, n_blocks,
             steps, int(boundary == "naive"), u_pair.device.index,
             *consts.weights, *consts.reaction, grid, barrier.data_ptr(),
             stream)
    if err != 0:
        raise RuntimeError(f"mega kernel launch failed: CUDA error {err} "
                           f"({build.error_name(err)})")
    launches += 1
