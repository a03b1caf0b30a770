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
from typing import Tuple

import torch

from ..params import KernelConstants
from . import build, stencil

#: most steps one launch may take: the kernel's compile-time halo depth
K = 8

#: kernel launches so far (CPU calls run the plain version and add nothing)
launches = 0

_fn = None


def multistep_reference(u: torch.Tensor, v: torch.Tensor, steps: int,
                        consts: KernelConstants, boundary: str
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: ``steps`` calls of ``stencil.step``."""
    for _ in range(steps):
        u, v = stencil.step(u, v, consts, boundary)
    return u, v


def _kernel():
    global _fn
    if _fn is None:
        lib = build.load()
        lib.gs_windowed_max_steps.argtypes = []
        lib.gs_windowed_max_steps.restype = ctypes.c_int
        if lib.gs_windowed_max_steps() != K:
            raise RuntimeError(
                f"windowed kernel takes at most {lib.gs_windowed_max_steps()}"
                f" steps a launch; this wrapper expects {K}")
        lib.gs_cuda_error_string.argtypes = [ctypes.c_int]
        lib.gs_cuda_error_string.restype = ctypes.c_char_p
        fn = lib.gs_windowed_multistep
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                       + [ctypes.c_float] * 14 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(u, v, u_out, v_out, steps, boundary) -> None:
    tensors = (u, v, u_out, v_out)
    if boundary not in stencil.BOUNDARIES:
        raise ValueError(f"unknown boundary {boundary!r}; "
                         f"expected {stencil.BOUNDARIES}")
    if not (isinstance(steps, int) and 1 <= steps <= K):
        raise ValueError(f"steps must be an int in [1, {K}], got {steps!r}")
    if u.device.type not in ("cpu", "cuda"):
        raise ValueError(f"tensors must lie on the CPU or a CUDA device, "
                         f"not {u.device}")
    if any(t.device != u.device for t in tensors):
        raise ValueError("u, v, u_out and v_out must share one device, got "
                         f"{[str(t.device) for t in tensors]}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError("u, v, u_out and v_out must be float32, got "
                         f"{[t.dtype for t in tensors]}")
    if u.dim() != 2 or any(t.shape != u.shape for t in tensors):
        raise ValueError("u, v, u_out and v_out must be 2-D of one shape, "
                         f"got {[tuple(t.shape) for t in tensors]}")
    if u.numel() == 0 or max(u.shape) >= 2 ** 31:
        raise ValueError(f"unsupported domain shape {tuple(u.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("u, v, u_out and v_out must be contiguous")
    # other tiles read the input's halo while this one writes its output
    if {u_out.data_ptr(), v_out.data_ptr()} & {u.data_ptr(), v.data_ptr()} \
            or u_out.data_ptr() == v_out.data_ptr():
        raise ValueError("u_out and v_out must be distinct buffers, apart "
                         "from u and v")


def multistep(u: torch.Tensor, v: torch.Tensor, u_out: torch.Tensor,
              v_out: torch.Tensor, steps: int, consts: KernelConstants,
              boundary: str) -> None:
    """Write the state ``steps`` (1..K) steps after ``(u, v)`` into
    ``(u_out, v_out)``. On a CUDA device the launch is enqueued on the
    current stream and not waited for."""
    global launches
    _check(u, v, u_out, v_out, steps, boundary)
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
        name = build.load().gs_cuda_error_string(err).decode()
        raise RuntimeError(
            f"windowed kernel launch failed: CUDA error {err} ({name})")
    launches += 1
