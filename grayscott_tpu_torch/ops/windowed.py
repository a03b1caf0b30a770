"""K1, the windowed multistep: the wrapper of ``csrc/windowed.cu``.

The port's ``multistep`` of ``grayscott_tpu/ops/pallas_stencil.py``
(``multistep``/``run_blocks``, ``:1256-1309``): one call advances the whole
``(R, C)`` state by ``steps <= K`` Gray-Scott steps. On a CUDA tensor it
launches the hand-written kernel on the current stream, or raises. On a
CPU tensor it runs the plain PyTorch version, :func:`multistep_reference`,
since there is no kernel to launch on the CPU.

``launches`` counts the kernel launches, and only them, so that a run can
show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from ..params import KernelConstants
from . import build, checks, stencil

#: most steps one launch may take: the kernel's compile-time halo depth
K = 8

#: the kernel's output tile (rows, cols); each block steps it in a window of
#: K cells more on every side (csrc/windowed.cu: Main)
TILE = (64, 64)

#: kernel launches so far (CPU calls run the plain version and add nothing)
launches = 0

_fn = None


#: the plain PyTorch version: ``steps`` calls of ``stencil.step``
multistep_reference = stencil.run


def _kernel():
    global _fn
    if _fn is None:
        max_steps = build.bind("gs_windowed_max_steps", [])()
        if max_steps != K:
            raise RuntimeError(f"windowed kernel takes at most {max_steps} "
                               f"steps a launch; this wrapper expects {K}")
        _fn = build.bind("gs_windowed_multistep",
                         [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                         + [ctypes.c_float] * 14 + [ctypes.c_void_p])
    return _fn


def multistep(u: torch.Tensor, v: torch.Tensor, u_out: torch.Tensor,
              v_out: torch.Tensor, steps: int, consts: KernelConstants,
              boundary: str) -> None:
    """Write the state ``steps`` (1..K) steps after ``(u, v)`` into
    ``(u_out, v_out)``. On a CUDA device the launch is enqueued on the
    current stream and not waited for."""
    global launches
    checks.check_count("steps", steps, 1, K)
    checks.check_boundary(boundary)
    checks.check_state((u, v), (u_out, v_out))
    if u.device.type == "cpu":
        ru, rv = multistep_reference(u, v, steps, consts, boundary)
        u_out.copy_(ru)
        v_out.copy_(rv)
        return
    fn = _kernel()
    rows, cols = u.shape
    stream = torch.cuda.current_stream(u.device).cuda_stream
    err = fn(u.data_ptr(), v.data_ptr(), u_out.data_ptr(), v_out.data_ptr(),
             rows, cols, steps, int(boundary == "naive"), u.device.index,
             *consts.weights, *consts.reaction, stream)
    if err != 0:
        raise RuntimeError(f"windowed kernel launch failed: CUDA error {err} "
                           f"({build.error_name(err)})")
    launches += 1
