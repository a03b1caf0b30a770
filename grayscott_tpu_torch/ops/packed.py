"""The species-packed layout, its plain PyTorch step, and the wrappers of
K4 (``csrc/packed.cu``) and K5 (``csrc/packed_resident.cu``).

The port's "species-packed layout" section of
``grayscott_tpu/ops/pallas_stencil.py`` (``:1586-1829``): U and V side by
side in one ``(R, 2C)`` float32 array ``[U | V]``, U in columns ``[0, C)``
and V in ``[C, 2C)``, with no halo rows and no padding (the kernels mask
the domain edge themselves, as K1 does). Zero boundary and a separable
stencil only; the constants come from ``params.packed_constants``.

The step is the JAX zero path's algebra, the separable plan and the linear
fold, not the oracle's 9-tap tree; :func:`packed_step` has it. It is a few
ulp off the oracle and drifts from it over long runs as the JAX packed
path does; the JAX packed kernels are its reference.

On a CUDA tensor each wrapper launches its hand-written kernel on the
current stream, or raises. On a CPU tensor it runs the plain version,
since there is no kernel to launch on the CPU. ``launches`` (K4) and
``resident_launches`` (K5) count the kernel launches, and only them, so
that a run can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from ..params import PackedConstants
from . import build, checks

#: most steps one K4 launch may take: the kernel's compile-time halo depth
K = 8

#: K4 launches so far (CPU calls run the plain version and add nothing)
launches = 0

#: K5 launches so far
resident_launches = 0

_fn = None
_resident_fn = None


def pack_state(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``(R, C)`` concentrations as one contiguous ``(R, 2C)`` float32
    tensor ``[U | V]`` on their device."""
    if u.shape != v.shape or u.dim() != 2:
        raise ValueError(f"u and v must be 2-D of one shape, got "
                         f"{tuple(u.shape)} and {tuple(v.shape)}")
    return torch.cat((u, v), dim=1).to(torch.float32)


def unpack_state(x: torch.Tensor, c: int) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """The ``(U, V)`` views of packed state of species width ``c``: column
    slices of ``x``, so not contiguous."""
    return x[..., :c], x[..., c:2 * c]


def packed_step(x: torch.Tensor, pc: PackedConstants) -> torch.Tensor:
    """One zero-boundary step of packed state (``step_packed``,
    ``pallas_stencil.py:907-924``, with ``make_window_stepper``'s separable
    ``laplacian`` and packed coefficients). Returns new ``(R, 2C)`` state.

    Each operation is rounded once, in this tree::

        t  = h1*x + h0*(x[c-1] + x[c+1])   # per species; columns outside
                                           # [0, C) read 0
        s  = h1*t + h0*(t[r-1] + t[r+1])   # rows outside [0, R) read 0
        q  = (u*v)*v                       # one value, both halves
        u' = ((cu*s_u + qu*q) + e) + au*u  # qu = -1 if dt_is_one else -dt
        v' = ((cv*s_v + qv*q) + 0.0) + bv*v  # qv = 1 if dt_is_one else dt

    Why this is the JAX packed kernel's tree: there, one lane roll gives
    ``y = [V | U]``, ``p = x*y = [uv | vu]`` and ``q = p*select(half, y,
    x) = [(uv)v | (vu)v]``; float32 multiplication is commutative bit for
    bit, so both halves hold ``(u*v)*v``. Its per-lane update is ``((Cvec*s
    + Qvec*q) + Evec) + Avec*x`` with ``Qvec = -1 | 1`` when dt is 1 (else
    ``-dt | dt``) and ``Evec = E | 0``. ``(-1)*q == -q`` and ``(-dt)*q ==
    -(dt*q)`` bit for bit, so U's update rounds as the unpacked zero path's
    subtraction. V's ``+ 0.0`` is exact: it rounds nothing, and changes no
    value but the sign of a zero. The compiler may contract this tree into
    fused multiply-adds differently on the CPU and the TPU (XLA does), so
    JAX's result is 1-2 ulp a step off this one; the CUDA kernels, built
    with ``-fmad=false``, equal it bit for bit.
    """
    rows, width = x.shape
    c = width // 2
    xs = x.reshape(rows, 2, c)  # (row, species, col)
    xp = F.pad(xs, (1, 1))
    t = pc.h1 * xs + pc.h0 * (xp[..., :-2] + xp[..., 2:])
    tp = F.pad(t, (0, 0, 0, 0, 1, 1))
    s = pc.h1 * t + pc.h0 * (tp[:-2] + tp[2:])
    u, v = xs[:, 0], xs[:, 1]
    q = (u * v) * v
    qu, qv = pc.quadratic()
    un = ((pc.cu * s[:, 0] + qu * q) + pc.e) + pc.au * u
    vn = ((pc.cv * s[:, 1] + qv * q) + 0.0) + pc.bv * v
    return torch.cat((un, vn), dim=1)


def packed_run(x: torch.Tensor, steps: int,
               pc: PackedConstants) -> torch.Tensor:
    """``steps`` calls of :func:`packed_step`: the plain version of every
    packed kernel."""
    for _ in range(steps):
        x = packed_step(x, pc)
    return x


def kernel_args(pc: PackedConstants) -> tuple:
    """The nine float arguments of every packed kernel: ``h0, h1, cu, cv,
    e, au, bv, qu, qv``."""
    return (pc.h0, pc.h1, pc.cu, pc.cv, pc.e, pc.au, pc.bv, *pc.quadratic())


def check_packed(inputs: Sequence[torch.Tensor],
                 outputs: Sequence[torch.Tensor], ndim: int = 2) -> None:
    """:func:`checks.check_state`, and an even last dimension."""
    checks.check_state(inputs, outputs, ndim=ndim)
    if (inputs or outputs)[0].shape[-1] % 2:
        raise ValueError(f"packed state must have an even width, got "
                         f"{tuple((inputs or outputs)[0].shape)}")


def _kernel():
    global _fn
    if _fn is None:
        max_steps = build.bind("gs_packed_max_steps", [])()
        if max_steps != K:
            raise RuntimeError(f"packed kernel takes at most {max_steps} "
                               f"steps a launch; this wrapper expects {K}")
        _fn = build.bind("gs_packed_multistep",
                         [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                         + [ctypes.c_float] * 9 + [ctypes.c_void_p])
    return _fn


def _resident_kernel():
    global _resident_fn
    if _resident_fn is None:
        _resident_fn = build.bind(
            "gs_packed_resident_multistep",
            [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
            + [ctypes.c_float] * 9 + [ctypes.c_int] + [ctypes.c_void_p] * 2)
    return _resident_fn


def resident_max_blocks(device: torch.device) -> int:
    """The most blocks of one K5 launch that are co-resident on
    ``device``."""
    index = torch.device(device).index
    n = build.bind("gs_packed_resident_max_blocks", [ctypes.c_int])(
        torch.cuda.current_device() if index is None else index)
    if n <= 0:
        raise RuntimeError(f"packed resident kernel occupancy query failed: "
                           f"CUDA error {-n} ({build.error_name(-n)})")
    return n


def multistep(x: torch.Tensor, x_out: torch.Tensor, steps: int,
              pc: PackedConstants) -> None:
    """K4: write the packed state ``steps`` (1..K) steps after ``x`` into
    ``x_out``. On a CUDA device the launch is enqueued on the current
    stream and not waited for."""
    global launches
    checks.check_count("steps", steps, 1, K)
    check_packed((x,), (x_out,))
    if x.device.type == "cpu":
        x_out.copy_(packed_run(x, steps, pc))
        return
    fn = _kernel()
    rows, width = x.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), x_out.data_ptr(), rows, width // 2, steps,
             x.device.index, *kernel_args(pc), stream)
    if err != 0:
        raise RuntimeError(f"packed kernel launch failed: CUDA error {err} "
                           f"({build.error_name(err)})")
    launches += 1


def resident_multistep(x: torch.Tensor, x_next: torch.Tensor, steps: int,
                       pc: PackedConstants, grid: int = 0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5: advance packed ``x`` by ``steps`` (>= 1) steps through the
    buffers ``x`` and ``x_next``, which the steps take turns to write.
    Returns the two with the result first: ``(x, x_next)`` for an even
    step count, ``(x_next, x)`` for an odd one. ``grid``: the blocks of the
    launch, 0 for the co-resident maximum. On a CUDA device the launch is
    enqueued on the current stream and not waited for."""
    global resident_launches
    checks.check_count("steps", steps, 1)
    checks.check_count("grid", grid, 0)
    check_packed((), (x, x_next))
    order = (x, x_next) if steps % 2 == 0 else (x_next, x)
    if x.device.type == "cpu":
        order[0].copy_(packed_run(x, steps, pc))
        return order
    fn = _resident_kernel()
    rows, width = x.shape
    barrier = torch.zeros(1, dtype=torch.int64, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), x_next.data_ptr(), rows, width // 2, steps,
             x.device.index, *kernel_args(pc), grid, barrier.data_ptr(),
             stream)
    if err != 0:
        raise RuntimeError(f"packed resident kernel launch failed: CUDA "
                           f"error {err} ({build.error_name(err)})")
    resident_launches += 1
    return order
