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

K4 and K5 step on the packed Hopper stepper (``csrc/gs_packed_sm90.cuh``:
register strips that keep the row pass out of shared memory, one
``__syncthreads()`` a step, interior tiles with no domain test,
``cp.async`` windows). K4 is in K1's code shape: one 64x64 tile a block
(``TILE``) in an 80x80 window, stepped up to ``K`` times as its valid
region shrinks; :func:`packed_windowed_run` is the CPU twin of that
launch. K5 is in K3's code shape: 32x32 tiles in 34x34 windows
(``RESIDENT_TILE``, ``RESIDENT_HALO``), the next tile's window loading
while a tile steps; :func:`packed_tiled_step` is the CPU twin of that
dispatch, for K5's and K6's geometries. Both twins are bit for bit
:func:`packed_step`.

On a CUDA tensor each wrapper launches its hand-written kernel on the
current stream, or raises. On a CPU tensor it runs the plain version,
since there is no kernel to launch on the CPU. ``launches`` (K4) and
``resident_launches`` (K5) count the kernel launches, and only them, so
that a run can show that its main path went through the kernels.
:func:`packed_windowed_ablation` and :func:`packed_resident_ablation` run
K4 and K5 with one part of their design taken out
(``WINDOWED_ABLATIONS``, ``RESIDENT_ABLATIONS``), for timing what each
part buys; their launches are not the main path's and are not counted.

``multistep(..., geometry=g)`` is K4 under JAX's ``block_rows`` and
``steps_per_call`` pins on the packed layout (``grayscott_tpu/backends/
pallas.py:554-583``; ``ops/geometry.py``): on a geometry other than the
compiled one it launches ``gs_packed_pinned_multistep`` (up to
``g.halo``, at most 32, steps a launch), counted in ``pinned_launches``;
its plain version is :func:`packed_run`, whatever the tiles.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from ..params import PackedConstants
from . import build, checks
from .geometry import Geometry, tile_shape

#: most steps one K4 launch may take: the kernel's compile-time halo depth
K = 8

#: K4's output tile (rows, cols); each block steps it in a window of K
#: cells more on every side (csrc/packed.cu: Main)
TILE = (64, 64)

#: K4 launches so far (CPU calls run the plain version and add nothing)
launches = 0
#: K4's pinned launches (a geometry other than the compiled one)
pinned_launches = 0

#: K5 launches so far
resident_launches = 0

#: K5's output tile (rows, cols) and the ring of its window: one step a
#: pass (csrc/packed_resident.cu)
RESIDENT_TILE = (32, 32)
RESIDENT_HALO = 1

#: the parts of K4's design that ``packed_windowed_ablation`` takes out
#: (csrc/packed.cu: gs_packed_ablation); each gives the whole kernel's
#: result
WINDOWED_ABLATIONS = {
    0: "the first form's kernel (32x32 tiles, two passes through shared "
       "memory, gs_packed.cuh)",
    1: "every tile an edge tile",
    2: "32x32 tiles in 48x48 windows",
}

#: the parts of K5's design that ``packed_resident_ablation`` takes out
#: (csrc/packed_resident.cu: gs_packed_resident_ablation); each gives the
#: whole kernel's result
RESIDENT_ABLATIONS = {
    0: "the first form's kernel (two passes through shared memory, "
       "gs_packed.cuh)",
    1: "every tile an edge tile",
    2: "no prefetch of the next window",
}

_fn = None
_pinned_fn = None
_ablation_fn = None
_resident_fn = None
_resident_ablation_fn = None


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


def _window_step(w: torch.Tensor, pc: PackedConstants
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One packed step of the inner cells ``[1, W-1)`` of a window ``w``
    (row, species, col) in the strips' order: the row pass of every window
    row, then the column pass from three rows of it, ``q`` and the fold;
    :func:`packed_step`'s tree. Returns ``(U', V')``."""
    t = pc.h1 * w[..., 1:-1] + pc.h0 * (w[..., :-2] + w[..., 2:])
    s = pc.h1 * t[1:-1] + pc.h0 * (t[:-2] + t[2:])
    u, v = w[1:-1, 0, 1:-1], w[1:-1, 1, 1:-1]
    q = (u * v) * v
    qu, qv = pc.quadratic()
    un = ((pc.cu * s[:, 0] + qu * q) + pc.e) + pc.au * u
    vn = ((pc.cv * s[:, 1] + qv * q) + 0.0) + pc.bv * v
    return un, vn


def packed_tiles(shape: Tuple[int, int], tile, halo: int
                 ) -> list[Tuple[int, int, bool]]:
    """``(r0, c0, interior)`` of each ``tr`` x ``tc`` tile (``tile``: one
    edge, or ``(tr, tc)``) of a ``shape`` domain, row by row: its window's
    global origin (``halo`` cells above and left of the tile) and whether
    the window lies inside the domain, as K5 and K6 decide it once a tile
    (``gs_packed_sm90.cuh``). The interior ones are those that
    ``stencil.interior_tiles`` counts."""
    rows, cols = shape
    tr, tc = tile_shape(tile)
    wr, wc = tr + 2 * halo, tc + 2 * halo
    return [(i * tr - halo, j * tc - halo,
             i * tr - halo >= 0 and j * tc - halo >= 0
             and i * tr - halo + wr <= rows and j * tc - halo + wc <= cols)
            for i in range(-(-rows // tr)) for j in range(-(-cols // tc))]


def packed_tiled_step(x: torch.Tensor, pc: PackedConstants, tile,
                      halo: int) -> torch.Tensor:
    """:func:`packed_step` tile by tile, as K5 (``tile`` 32, ``halo`` 1) and
    K6 (64 and 8, or the ``(tr, tc)`` of its row-tile pin, and 8) dispatch
    it: each tile steps its window (the tile and ``halo`` >= 1 cells around
    it, cells outside the domain 0.0) in the strips' order. An interior
    tile's window is cut from the state with no domain test; an edge tile's
    comes from the zero-padded state and its cells outside the domain are
    written as 0.0. Equal to :func:`packed_step` bit for bit, NaN and Inf
    included: every cell the tile keeps reads only cells of its window, and
    a row outside the domain gives ``t = +0.0`` as the padding of ``t``
    does."""
    if halo < 1:
        raise ValueError(f"halo must be >= 1, got {halo!r}")
    tr, tc = tile_shape(tile)
    rows, width = x.shape
    c = width // 2
    xs = x.reshape(rows, 2, c)
    xp = F.pad(xs, (halo, halo + tc, 0, 0, halo, halo + tr))
    out = torch.empty_like(xs)
    wr, wc = tr + 2 * halo, tc + 2 * halo
    for r0, c0, interior in packed_tiles((rows, c), (tr, tc), halo):
        if interior:
            un, vn = _window_step(xs[r0:r0 + wr, :, c0:c0 + wc], pc)
        else:
            un, vn = _window_step(
                xp[r0 + halo:r0 + halo + wr, :, c0 + halo:c0 + halo + wc],
                pc)
            rr = torch.arange(r0 + 1, r0 + wr - 1)
            cc = torch.arange(c0 + 1, c0 + wc - 1)
            inside = (((rr >= 0) & (rr < rows))[:, None]
                      & ((cc >= 0) & (cc < c))[None, :])
            un = torch.where(inside, un, 0.0)
            vn = torch.where(inside, vn, 0.0)
        # the tile's cells in the domain: window cells [halo, halo + tile)
        gr, gc = r0 + halo, c0 + halo
        nr, nc = min(tr, rows - gr), min(tc, c - gc)
        out[gr:gr + nr, 0, gc:gc + nc] = un[halo - 1:halo - 1 + nr,
                                            halo - 1:halo - 1 + nc]
        out[gr:gr + nr, 1, gc:gc + nc] = vn[halo - 1:halo - 1 + nr,
                                            halo - 1:halo - 1 + nc]
    return out.reshape(rows, width)


def packed_windowed_run(x: torch.Tensor, steps: int, pc: PackedConstants,
                        tile=TILE[0], halo: int = K) -> torch.Tensor:
    """:func:`packed_run` tile by tile, as K4 launches it: each ``tr`` x
    ``tc`` tile (``tile``: one edge, or ``(tr, tc)``) steps its window (the
    tile and ``halo`` cells around it, cells outside the domain 0.0)
    ``steps`` <= ``halo`` times, the valid region shrinking by one cell a
    step, and writes its cells that lie in the domain. An interior tile's
    window is cut from the state with no domain test; an edge tile's comes
    from the zero-padded state and its cells outside the domain are written
    as 0.0 every step. Equal to :func:`packed_run` bit for bit, NaN and Inf
    included, for the reasons :func:`packed_tiled_step` gives."""
    checks.check_count("steps", steps, 1, halo)
    tr, tc = tile_shape(tile)
    rows, width = x.shape
    c = width // 2
    xs = x.reshape(rows, 2, c)
    xp = F.pad(xs, (halo, halo + tc, 0, 0, halo, halo + tr))
    out = torch.empty_like(xs)
    wr, wc = tr + 2 * halo, tc + 2 * halo
    for r0, c0, interior in packed_tiles((rows, c), (tr, tc), halo):
        if interior:
            win = xs[r0:r0 + wr, :, c0:c0 + wc]
        else:
            win = xp[r0 + halo:r0 + halo + wr, :, c0 + halo:c0 + halo + wc]
            rr = torch.arange(r0, r0 + wr, device=x.device)
            cc = torch.arange(c0, c0 + wc, device=x.device)
            inside = (((rr >= 0) & (rr < rows))[:, None]
                      & ((cc >= 0) & (cc < c))[None, :])
        for _ in range(steps):  # window cells [s + 1, w - s - 1) at step s
            un, vn = _window_step(win, pc)
            if not interior:
                inside = inside[1:-1, 1:-1]
                un = torch.where(inside, un, 0.0)
                vn = torch.where(inside, vn, 0.0)
            win = torch.stack((un, vn), dim=1)
        # the tile's cells in the domain: window cells [halo, halo + tile)
        gr, gc, at = r0 + halo, c0 + halo, halo - steps
        nr, nc = min(tr, rows - gr), min(tc, c - gc)
        out[gr:gr + nr, :, gc:gc + nc] = win[at:at + nr, :, at:at + nc]
    return out.reshape(rows, width)


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


def _pinned_kernel():
    global _pinned_fn
    if _pinned_fn is None:
        _pinned_fn = build.bind("gs_packed_pinned_multistep",
                                [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7
                                + [ctypes.c_float] * 9 + [ctypes.c_void_p])
    return _pinned_fn


def _ablation_kernel():
    global _ablation_fn
    if _ablation_fn is None:
        _ablation_fn = build.bind("gs_packed_ablation",
                                  [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                                  + [ctypes.c_float] * 9
                                  + [ctypes.c_void_p, ctypes.c_int])
    return _ablation_fn


def _resident_kernel():
    global _resident_fn
    if _resident_fn is None:
        _resident_fn = build.bind(
            "gs_packed_resident_multistep",
            [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
            + [ctypes.c_float] * 9 + [ctypes.c_int] + [ctypes.c_void_p] * 2)
    return _resident_fn


def _resident_ablation_kernel():
    global _resident_ablation_fn
    if _resident_ablation_fn is None:
        _resident_ablation_fn = build.bind(
            "gs_packed_resident_ablation",
            [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
            + [ctypes.c_float] * 9 + [ctypes.c_int] + [ctypes.c_void_p] * 2
            + [ctypes.c_int])
    return _resident_ablation_fn


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
              pc: PackedConstants,
              geometry: Geometry | None = None) -> None:
    """K4: write the packed state ``steps`` (1..K, or 1..``geometry.halo``)
    steps after ``x`` into ``x_out``. ``geometry``: the tiles and halo of
    the launch (None: the compiled ones). On a CUDA device the launch is
    enqueued on the current stream and not waited for."""
    global launches, pinned_launches
    pinned = geometry is not None and not geometry.compiled
    checks.check_count("steps", steps, 1, geometry.halo if pinned else K)
    check_packed((x,), (x_out,))
    if x.device.type == "cpu":
        x_out.copy_(packed_run(x, steps, pc))
        return
    if not pinned:
        _launch(_kernel(), x, x_out, steps, pc)
        launches += 1
        return
    rows, width = x.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _pinned_kernel()(x.data_ptr(), x_out.data_ptr(), rows, width // 2,
                           steps, *geometry, x.device.index,
                           *kernel_args(pc), stream)
    if err != 0:
        raise RuntimeError(f"pinned packed kernel launch failed "
                           f"({geometry.label()}): CUDA error {err} "
                           f"({build.error_name(err)})")
    pinned_launches += 1


def packed_windowed_ablation(x: torch.Tensor, x_out: torch.Tensor,
                             steps: int, pc: PackedConstants,
                             part: int) -> None:
    """:func:`multistep` on the card with one part of K4's design taken out
    (``WINDOWED_ABLATIONS[part]``). The result is the whole kernel's. Not
    counted in ``launches``."""
    checks.check_count("steps", steps, 1, K)
    check_packed((x,), (x_out,))
    if part not in WINDOWED_ABLATIONS:
        raise ValueError(f"part must be one of {sorted(WINDOWED_ABLATIONS)},"
                         f" got {part!r}")
    if x.device.type != "cuda":
        raise ValueError("an ablation runs the kernel: the state must lie "
                         f"on a CUDA device, not {x.device}")
    fn = _ablation_kernel()
    _launch(lambda *args: fn(*args, part), x, x_out, steps, pc)


def _launch(fn, x, x_out, steps, pc):
    """One launch of ``fn`` (a bound ``gs_packed_*`` entry of K4) on the
    current stream; raises on a refusal."""
    rows, width = x.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), x_out.data_ptr(), rows, width // 2, steps,
             x.device.index, *kernel_args(pc), stream)
    if err != 0:
        raise RuntimeError(f"packed kernel launch failed: CUDA error {err} "
                           f"({build.error_name(err)})")


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
    order = _check_resident(x, x_next, steps, grid)
    if x.device.type == "cpu":
        order[0].copy_(packed_run(x, steps, pc))
        return order
    _launch_resident(_resident_kernel(), x, x_next, steps, pc, grid)
    resident_launches += 1
    return order


def packed_resident_ablation(x: torch.Tensor, x_next: torch.Tensor,
                             steps: int, pc: PackedConstants, part: int,
                             grid: int = 0
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`resident_multistep` on the card with one part of K5's design
    taken out (``RESIDENT_ABLATIONS[part]``). The result, and the order of
    the returned buffers, are the whole kernel's. Not counted in
    ``resident_launches``."""
    order = _check_resident(x, x_next, steps, grid)
    if part not in RESIDENT_ABLATIONS:
        raise ValueError(f"part must be one of {sorted(RESIDENT_ABLATIONS)},"
                         f" got {part!r}")
    if x.device.type != "cuda":
        raise ValueError("an ablation runs the kernel: the buffers must lie "
                         f"on a CUDA device, not {x.device}")
    fn = _resident_ablation_kernel()
    _launch_resident(lambda *args: fn(*args, part), x, x_next, steps, pc,
                     grid)
    return order


def _check_resident(x, x_next, steps, grid):
    """The checks of K5's wrappers; the buffers with the result first."""
    checks.check_count("steps", steps, 1)
    checks.check_count("grid", grid, 0)
    check_packed((), (x, x_next))
    return (x, x_next) if steps % 2 == 0 else (x_next, x)


def _launch_resident(fn, x, x_next, steps, pc, grid):
    """One launch of ``fn`` (a bound ``gs_packed_resident_*`` entry) on the
    current stream; raises on a refusal."""
    rows, width = x.shape
    barrier = torch.zeros(1, dtype=torch.int64, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), x_next.data_ptr(), rows, width // 2, steps,
             x.device.index, *kernel_args(pc), grid, barrier.data_ptr(),
             stream)
    if err != 0:
        raise RuntimeError(f"packed resident kernel launch failed: CUDA "
                           f"error {err} ({build.error_name(err)})")
