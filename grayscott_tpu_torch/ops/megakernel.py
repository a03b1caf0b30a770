"""K2, the single-card megakernel: the wrapper of ``csrc/mega.cu``.

The port's ``megastep`` of ``grayscott_tpu/ops/megakernel.py``
(``:888-1110``, single-chip mode): one call advances the state by
``n_blocks`` time blocks of ``steps`` (1..MEGA_STEPS) steps in one launch.
The state is one ``(2, R, C)`` pair per species, updated in place; slot 0
holds the state before and after the call (:func:`pair_state` builds
one). On a CUDA tensor it makes one cooperative launch on the current
stream, or raises. On a CPU tensor it runs the plain PyTorch version,
:func:`megastep_reference`, since there is no kernel to launch on the CPU.

K2 takes bfloat16 pairs too (``megakernel.py:_mega_kernel`` with a
bfloat16 dtype, ``:166-169``, ``:481``, ``:615``): each window widened to
float32 on load, each time block's steps in float32, the cells rounded to
bfloat16 once a time block. Its plain version there is
:func:`megastep_reference_bf16`.

``launches`` counts the kernel launches, and only them (the bf16 entry's
apart, in ``bf16_launches``), so that a run can show that its main path
went through the kernel. :func:`megastep_ablation`
runs the kernel with one part of its design taken out (``ABLATIONS``), for
timing what each part buys; its launches are not the main path's and are
not counted.

K6, the species-packed megakernel (``csrc/packed_mega.cu``), is the
port's ``packed_megastep`` (``megakernel.py:1112``): the same time-block
loop on one ``(2, R, 2C)`` pair of packed state ``[U | V]``
(``ops/packed.py``), zero boundary and a separable stencil only, on the
packed Hopper stepper (``csrc/gs_packed_sm90.cuh``): K2's 64x64 tiles in
80x80 windows of dynamic shared memory (``PACKED_TILE``), walked as K2
walks them, with register strips that keep the row pass out of shared
memory. Its launches are counted in ``packed_launches``;
:func:`packed_mega_ablation` (``PACKED_ABLATIONS``) runs it with one part
of its design taken out, uncounted.
"""

from __future__ import annotations

import ctypes

import torch

from ..params import KernelConstants, PackedConstants
from . import build, checks, packed, stencil

#: most steps of one time block: the kernel's compile-time halo depth
MEGA_STEPS = 8

#: kernel launches so far (CPU calls run the plain version and add nothing)
launches = 0
#: the bf16 entry's launches so far (bfloat16 pairs)
bf16_launches = 0

#: K6 launches so far
packed_launches = 0

#: the parts of K2's design that ``megastep_ablation`` takes out
#: (csrc/mega.cu: gs_mega_ablation); each gives the whole kernel's result
ABLATIONS = {
    0: "the first stepper's kernel (32x32 tiles, gs_tile.cuh)",
    1: "every tile an edge tile",
    2: "the tap set tested at run time",
    3: "no prefetch of the next window",
    4: "32x32 tiles in 48x48 windows",
}

#: K6's output tile (rows, cols); its windows are MEGA_STEPS cells wider
#: on every side
PACKED_TILE = (64, 64)

#: the parts of K6's design that ``packed_mega_ablation`` takes out
#: (csrc/packed_mega.cu: gs_packed_mega_ablation); each gives the whole
#: kernel's result
PACKED_ABLATIONS = {
    0: "the first form's kernel (32x32 tiles, two passes through shared "
       "memory, gs_packed.cuh)",
    1: "every tile an edge tile",
    2: "no prefetch of the next window",
    3: "32x32 tiles in 48x48 windows",
}

_fn = None
_bf16_fn = None
_ablation_fn = None
_packed_fn = None
_packed_ablation_fn = None


#: the plain PyTorch version: ``steps`` calls of ``stencil.step``
megastep_reference = stencil.run


def megastep_reference_bf16(u: torch.Tensor, v: torch.Tensor, n_blocks: int,
                            steps: int, consts: KernelConstants,
                            boundary: str):
    """The plain version on bfloat16 storage: ``n_blocks`` time blocks of
    ``steps`` (<= MEGA_STEPS) float32 steps, the state rounded to bfloat16
    after each (``stencil.run_bf16`` a block)."""
    for _ in range(n_blocks):
        u, v = stencil.run_bf16(u, v, steps, consts, boundary)
    return u, v


def pair_state(x: torch.Tensor) -> torch.Tensor:
    """An ``(R, C)`` state as a ``(2, R, C)`` pair of ``x``'s dtype
    (float32, or bfloat16 storage): slot 0 holds ``x``, slot 1 is scratch
    (every cell is written before it is read)."""
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


def _bf16_kernel():
    global _bf16_fn
    if _bf16_fn is None:
        _kernel()  # checks the time-block depth
        _bf16_fn = build.bind("gs_mega_multistep_bf16",
                              [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
                              + [ctypes.c_float] * 14 + [ctypes.c_int]
                              + [ctypes.c_void_p] * 2)
    return _bf16_fn


def _ablation_kernel():
    global _ablation_fn
    if _ablation_fn is None:
        _kernel()  # checks the time-block depth
        _ablation_fn = build.bind("gs_mega_ablation",
                                  [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
                                  + [ctypes.c_float] * 14 + [ctypes.c_int]
                                  + [ctypes.c_void_p] * 2 + [ctypes.c_int])
    return _ablation_fn


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
    """Advance slot 0 of the pairs (both float32 or both bfloat16) by
    ``n_blocks`` x ``steps`` steps, in place. ``grid``: the blocks of the
    launch, 0 for the co-resident maximum. On a CUDA device the launch is
    enqueued on the current stream and not waited for."""
    global launches, bf16_launches
    _check(u_pair, v_pair, n_blocks, steps, boundary, grid,
           checks.STORAGE_DTYPES)
    bf16 = u_pair.dtype == torch.bfloat16
    if u_pair.device.type == "cpu":
        if bf16:
            ru, rv = megastep_reference_bf16(u_pair[0], v_pair[0], n_blocks,
                                             steps, consts, boundary)
        else:
            ru, rv = megastep_reference(u_pair[0], v_pair[0],
                                        n_blocks * steps, consts, boundary)
        u_pair[0].copy_(ru)
        v_pair[0].copy_(rv)
        return
    _launch(_bf16_kernel() if bf16 else _kernel(), u_pair, v_pair, n_blocks,
            steps, consts, boundary, grid)
    if bf16:
        bf16_launches += 1
    else:
        launches += 1


def megastep_ablation(u_pair: torch.Tensor, v_pair: torch.Tensor,
                      n_blocks: int, steps: int, consts: KernelConstants,
                      boundary: str, part: int, grid: int = 0) -> None:
    """:func:`megastep` on the card with one part of the kernel's design
    taken out (``ABLATIONS[part]``); the default stencil's tap set only.
    The result is the whole kernel's. Not counted in ``launches``."""
    _check(u_pair, v_pair, n_blocks, steps, boundary, grid)
    if part not in ABLATIONS:
        raise ValueError(f"part must be one of {sorted(ABLATIONS)}, got "
                         f"{part!r}")
    if u_pair.device.type != "cuda":
        raise ValueError("an ablation runs the kernel: the pairs must lie on "
                         f"a CUDA device, not {u_pair.device}")
    fn = _ablation_kernel()
    _launch(lambda *args: fn(*args, part), u_pair, v_pair, n_blocks, steps,
            consts, boundary, grid)


def _check(u_pair, v_pair, n_blocks, steps, boundary, grid,
           dtypes=(torch.float32,)):
    checks.check_count("n_blocks", n_blocks, 1)
    checks.check_count("steps", steps, 1, MEGA_STEPS)
    checks.check_count("grid", grid, 0)
    checks.check_boundary(boundary)
    checks.check_state((), (u_pair, v_pair), ndim=3, dtypes=dtypes)
    if u_pair.shape[0] != 2:
        raise ValueError(f"the pairs must be (2, R, C), got "
                         f"{tuple(u_pair.shape)}")


def _launch(fn, u_pair, v_pair, n_blocks, steps, consts, boundary, grid):
    """One launch of ``fn`` (a bound ``gs_mega_*`` entry) on the pairs, on
    the current stream; raises on a refusal."""
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


def _packed_kernel():
    global _packed_fn
    if _packed_fn is None:
        max_steps = build.bind("gs_packed_mega_max_steps", [])()
        if max_steps != MEGA_STEPS:
            raise RuntimeError(
                f"packed mega kernel takes at most {max_steps} steps a time "
                f"block; this wrapper expects {MEGA_STEPS}")
        _packed_fn = build.bind("gs_packed_mega_multistep",
                                [ctypes.c_void_p] + [ctypes.c_int] * 5
                                + [ctypes.c_float] * 9 + [ctypes.c_int]
                                + [ctypes.c_void_p] * 2)
    return _packed_fn


def _packed_ablation_kernel():
    global _packed_ablation_fn
    if _packed_ablation_fn is None:
        _packed_kernel()  # checks the time-block depth
        _packed_ablation_fn = build.bind(
            "gs_packed_mega_ablation",
            [ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_float] * 9
            + [ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_int])
    return _packed_ablation_fn


def packed_max_blocks(device: torch.device) -> int:
    """The most blocks of one K6 launch that are co-resident on
    ``device``."""
    index = torch.device(device).index
    n = build.bind("gs_packed_mega_max_blocks", [ctypes.c_int])(
        torch.cuda.current_device() if index is None else index)
    if n <= 0:
        raise RuntimeError(f"packed mega kernel occupancy query failed: CUDA "
                           f"error {-n} ({build.error_name(-n)})")
    return n


def packed_megastep(x_pair: torch.Tensor, n_blocks: int, steps: int,
                    pc: PackedConstants, grid: int = 0) -> None:
    """K6: advance slot 0 of the packed pair ``x_pair`` (``(2, R, 2C)``)
    by ``n_blocks`` x ``steps`` (1..MEGA_STEPS) steps, in place. ``grid``:
    the blocks of the launch, 0 for the co-resident maximum. On a CUDA
    device the launch is enqueued on the current stream and not waited
    for."""
    global packed_launches
    _check_packed(x_pair, n_blocks, steps, grid)
    if x_pair.device.type == "cpu":
        x_pair[0].copy_(packed.packed_run(x_pair[0], n_blocks * steps, pc))
        return
    _launch_packed(_packed_kernel(), x_pair, n_blocks, steps, pc, grid)
    packed_launches += 1


def packed_mega_ablation(x_pair: torch.Tensor, n_blocks: int, steps: int,
                         pc: PackedConstants, part: int,
                         grid: int = 0) -> None:
    """:func:`packed_megastep` on the card with one part of K6's design
    taken out (``PACKED_ABLATIONS[part]``). The result is the whole
    kernel's. Not counted in ``packed_launches``."""
    _check_packed(x_pair, n_blocks, steps, grid)
    if part not in PACKED_ABLATIONS:
        raise ValueError(f"part must be one of {sorted(PACKED_ABLATIONS)}, "
                         f"got {part!r}")
    if x_pair.device.type != "cuda":
        raise ValueError("an ablation runs the kernel: the pair must lie on "
                         f"a CUDA device, not {x_pair.device}")
    fn = _packed_ablation_kernel()
    _launch_packed(lambda *args: fn(*args, part), x_pair, n_blocks, steps,
                   pc, grid)


def _check_packed(x_pair, n_blocks, steps, grid):
    checks.check_count("n_blocks", n_blocks, 1)
    checks.check_count("steps", steps, 1, MEGA_STEPS)
    checks.check_count("grid", grid, 0)
    packed.check_packed((), (x_pair,), ndim=3)
    if x_pair.shape[0] != 2:
        raise ValueError(f"the pair must be (2, R, 2C), got "
                         f"{tuple(x_pair.shape)}")


def _launch_packed(fn, x_pair, n_blocks, steps, pc, grid):
    """One launch of ``fn`` (a bound ``gs_packed_mega_*`` entry) on the
    pair, on the current stream; raises on a refusal."""
    _, rows, width = x_pair.shape
    barrier = torch.zeros(1, dtype=torch.int64, device=x_pair.device)
    stream = torch.cuda.current_stream(x_pair.device).cuda_stream
    err = fn(x_pair.data_ptr(), rows, width // 2, n_blocks, steps,
             x_pair.device.index, *packed.kernel_args(pc), grid,
             barrier.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"packed mega kernel launch failed: CUDA error "
                           f"{err} ({build.error_name(err)})")
