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

``megastep(..., fold=True)`` runs the folded naive reaction
(``megakernel.py:_mega_kernel`` with ``fast_fold``) on either storage: the
fold entries, whose plain version is :func:`megastep_reference_fold`; their
launches are counted in ``fold_launches`` and ``fold_bf16_launches``.

``launches`` counts the kernel launches, and only them (the bf16 entry's
apart, in ``bf16_launches``), so that a run can show that its main path
went through the kernel. :func:`megastep_ablation`
runs the kernel with one part of its design taken out (``ABLATIONS``), for
timing what each part buys; its launches are not the main path's and are
not counted.

``depth`` (``mega_depth``, 2..8; ``megakernel.py:_mega_kernel(depth=)``,
the ring at ``:562-630``) runs the window ring: ``depth`` window slots and
the step's scratch, ``depth - 1`` window loads in flight while a tile
steps (``csrc/mega_ring.cu``, ``gs_tile_sm90.cuh:ring_walk``).
:func:`ring_geometry` gives the tile and the depth that run: JAX's clamp to
2 under ``2 * depth`` tiles, then 64x64 tiles while the ring fits a block's
shared memory, else 32x32 (the port's counterpart of
``choose_mega_geometry`` shrinking its tile with depth, ``:819-860``).
Depth 2 on 64x64 tiles is the double buffer, the entries above; every other
geometry runs the ring entries, counted in ``ring_launches``,
``ring_bf16_launches``, ``ring_fold_launches`` and
``ring_fold_bf16_launches``. The ring changes when a window loads, not what
a step computes: every depth gives depth 2's result bit for bit, and the
plain versions are the same.

``geometry`` (``ops/geometry.py:mega_resolve``: the tile pins,
``--pallas-engine mega --pallas-block-rows/--pallas-block-cols``; JAX's
``_mega_tiles``, ``grayscott_tpu/backends/pallas.py:384-411``) runs the
double buffer on ``tr`` x ``tc`` tiles known at run time: the pinned
entries of ``csrc/mega_pins.cu``, on the compiled kernel's block body, their
grid the co-resident blocks at the pinned window's bytes
(:func:`pinned_max_blocks`). The compiled geometry (64x64, ``geometry.
DEFAULT``) runs the entries above. Their launches are counted in
``pinned_launches``, ``pinned_bf16_launches``, ``pinned_fold_launches`` and
``pinned_fold_bf16_launches``; the tiles change where a window loads, not
what a step computes, so the plain versions are the same. A pinned tile
takes no ring: ``depth`` above 2 with a pinned geometry raises.

K6, the species-packed megakernel (``csrc/packed_mega.cu``), is the
port's ``packed_megastep`` (``megakernel.py:1112``): the same time-block
loop on one ``(2, R, 2C)`` pair of packed state ``[U | V]``
(``ops/packed.py``), zero boundary and a separable stencil only, on the
packed Hopper stepper (``csrc/gs_packed_sm90.cuh``): K2's 64x64 tiles in
80x80 windows of dynamic shared memory (``PACKED_TILE``), walked as K2
walks them, with register strips that keep the row pass out of shared
memory. Its launches are counted in ``packed_launches``;
:func:`packed_mega_ablation` (``PACKED_ABLATIONS``) runs it with one part
of its design taken out, uncounted. Like JAX's ``packed_megastep``, it
takes no depth: K6 always runs the double buffer, and a ``mega_depth`` pin
does not reach the packed layout. ``packed_megastep(..., geometry=g)`` runs
its row-tile pin (``--pallas-pack on --pallas-engine mega
--pallas-block-rows``; ``backends/pallas.py:554-576``) on the pinned entry
of ``csrc/mega_pins.cu``, counted in ``packed_pinned_launches``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from ..params import FoldConstants, KernelConstants, PackedConstants
from . import build, checks, packed, stencil

#: most steps of one time block: the kernel's compile-time halo depth
MEGA_STEPS = 8

#: kernel launches so far (CPU calls run the plain version and add nothing)
launches = 0
#: the bf16 entry's launches so far (bfloat16 pairs)
bf16_launches = 0
#: the fold entries' launches so far (float32, bfloat16 pairs)
fold_launches = 0
fold_bf16_launches = 0

#: K6 launches so far
packed_launches = 0

#: the ring entries' launches so far (``depth`` other than the double
#: buffer): K2 on float32 and bfloat16 pairs, and its fold entries
ring_launches = 0
ring_bf16_launches = 0
ring_fold_launches = 0
ring_fold_bf16_launches = 0

#: the pinned entries' launches (a tile geometry other than the compiled
#: one): K2 by storage and mode, and K6
pinned_launches = 0
pinned_bf16_launches = 0
pinned_fold_launches = 0
pinned_fold_bf16_launches = 0
packed_pinned_launches = 0

#: JAX's ``mega_depth`` values (``backends/pallas.py:224-225``)
DEPTHS = range(2, 9)

#: the most dynamic shared memory one block may opt into on an H100
#: (227 KB), and what one SM holds (228 KB) with the 1 KB it reserves a
#: block (csrc/gs_tile_sm90.cuh: SMEM_OPTIN)
SMEM_OPTIN = 232_448
SMEM_SM = 233_472
SMEM_RESERVED = 1_024

#: tile edge -> bytes of one window buffer of both species (the tile and
#: MEGA_STEPS cells on every side, float32; Geometry::PAIR_BYTES)
PAIR_BYTES = {64: 2 * 4 * (64 + 2 * 8) ** 2, 32: 2 * 4 * (32 + 2 * 8) ** 2}

#: the most buffers of a ring: depth 8's slots and the scratch
RING_MAX_BUFFERS = 9


class RingGeometry(NamedTuple):
    """What a megakernel launch of a ``depth`` pin runs (ring_geometry)."""

    tile: int  #: tile edge: 64 (64x64 tiles in 80x80 windows) or 32
    depth: int  #: the depth after JAX's clamp
    buffers: int  #: window buffers: 2 at depth 2, else depth + 1
    bytes: int  #: dynamic shared memory of a block
    blocks_per_sm: int  #: blocks an SM that the bytes leave room for

    @property
    def ring(self) -> bool:
        """Whether the ring entries run it (else the double buffer)."""
        return (self.tile, self.buffers) != (64, 2)


def ring_buffers(depth: int) -> int:
    """Window buffers of a ring of ``depth`` slots: the slots and the
    step's scratch; depth 2 is the double buffer (two)."""
    return 2 if depth == 2 else depth + 1


def ring_max_buffers(tile: int) -> int:
    """The most ring buffers of ``tile`` x ``tile`` tiles that one block's
    shared memory holds (``gs_mega_ring_max_buffers``)."""
    return min(RING_MAX_BUFFERS, SMEM_OPTIN // PAIR_BYTES[tile])


def check_depth(depth) -> int:
    """``depth`` (None: the double buffer, 2), or ValueError outside 2..8
    (``grayscott_tpu/ops/megakernel.py:920-921``)."""
    if depth is None:
        return 2
    if isinstance(depth, bool) or not isinstance(depth, int) \
            or depth not in DEPTHS:
        raise ValueError(f"mega_depth must be in [2, 8], got {depth}")
    return depth


def ring_geometry(shape: Tuple[int, int], depth: int | None = None,
                  sharded: bool = False) -> RingGeometry:
    """(tile, depth, buffers, bytes, blocks an SM) of a megakernel run of
    a ``shape`` (R, C) domain under a ``depth`` pin.

    The tile follows the pinned depth: 64x64 tiles while the ring fits the
    shared memory a block may opt into (depths 2 and 3), else 32x32 (4-8).
    Then JAX's clamp (``grayscott_tpu/ops/megakernel.py:1022-1028``,
    ``:755-763``): depth 2 when sharded (K7 takes no depth) or when the
    windows, here the tiles, number fewer than ``2 * depth``; the tile
    stays the one the pin chose, as JAX's row tile does. ``blocks_per_sm``
    counts the blocks that shared memory leaves room for (228 KB an SM, 1
    KB reserved a block); the launch takes the occupancy API's count,
    which registers may lower."""
    d = check_depth(depth)
    tile = 64 if ring_buffers(d) * PAIR_BYTES[64] <= SMEM_OPTIN else 32
    r, c = shape
    if sharded or -(-r // tile) * -(-c // tile) < 2 * d:
        d = 2
    buffers = ring_buffers(d)
    nbytes = buffers * PAIR_BYTES[tile]
    return RingGeometry(tile, d, buffers, nbytes,
                        SMEM_SM // (nbytes + SMEM_RESERVED))

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
_fold_fns: dict = {}
_ablation_fn = None
_packed_fn = None
_packed_ablation_fn = None
_ring_fns: dict = {}
_pinned_fns: dict = {}


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


def megastep_reference_fold(u: torch.Tensor, v: torch.Tensor, n_blocks: int,
                            steps: int, fc: FoldConstants):
    """The plain version of the fold entries: ``n_blocks * steps`` folded
    steps (``stencil.run_naive_fold``); on bfloat16 storage ``n_blocks``
    time blocks of ``steps`` (<= MEGA_STEPS) steps, each rounded to
    bfloat16 once (``stencil.run_naive_fold_bf16`` a block)."""
    if u.dtype != torch.bfloat16:
        return stencil.run_naive_fold(u, v, n_blocks * steps, fc)
    for _ in range(n_blocks):
        u, v = stencil.run_naive_fold_bf16(u, v, steps, fc)
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


def _fold_kernel(dtype):
    if dtype not in _fold_fns:
        _kernel()  # checks the time-block depth
        name = "gs_mega_multistep_fold" + (
            "_bf16" if dtype == torch.bfloat16 else "")
        _fold_fns[dtype] = build.bind(
            name, [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
            + [ctypes.c_void_p] + [ctypes.c_int] * 3
            + [ctypes.c_void_p] * 2)
    return _fold_fns[dtype]


def _check_ring_buffers():
    """The library's most ring buffers a geometry equal this wrapper's."""
    fn = build.bind("gs_mega_ring_max_buffers", [ctypes.c_int])
    for tile in PAIR_BYTES:
        if fn(tile) != ring_max_buffers(tile):
            raise RuntimeError(
                f"the ring kernels hold {fn(tile)} buffers of {tile}x{tile} "
                f"tiles; this wrapper expects {ring_max_buffers(tile)}")


def _ring_kernel(dtype, fold: bool):
    """The ring entry of K2 for ``dtype`` pairs (``fold``: its fold
    entry): the double buffer's arguments, then the tile and the buffers."""
    key = (dtype, fold)
    if key not in _ring_fns:
        base = _fold_kernel(dtype) if fold else (
            _bf16_kernel() if dtype == torch.bfloat16 else _kernel())
        _check_ring_buffers()
        name = "gs_mega_ring_multistep" + ("_fold" if fold else "") + (
            "_bf16" if dtype == torch.bfloat16 else "")
        _ring_fns[key] = build.bind(name, base.argtypes + [ctypes.c_int] * 2)
    return _ring_fns[key]


def _pinned_kernel(dtype, fold: bool):
    """The pinned entry of K2 for ``dtype`` pairs (``fold``: its fold
    entry): the double buffer's arguments, then ``tr`` and ``tc``."""
    key = (dtype, fold)
    if key not in _pinned_fns:
        base = _fold_kernel(dtype) if fold else (
            _bf16_kernel() if dtype == torch.bfloat16 else _kernel())
        name = "gs_mega_pinned_multistep" + ("_fold" if fold else "") + (
            "_bf16" if dtype == torch.bfloat16 else "")
        _pinned_fns[key] = build.bind(name,
                                      base.argtypes + [ctypes.c_int] * 2)
    return _pinned_fns[key]


def _is_pinned(geometry) -> bool:
    """Whether ``geometry`` runs the pinned entries (not the compiled
    64x64 tiles)."""
    if geometry is None or geometry.compiled:
        return False
    if geometry.halo != MEGA_STEPS:
        raise ValueError(f"a megakernel's halo is its time block, "
                         f"{MEGA_STEPS}; got {geometry.label()}")
    return True


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


def ring_max_blocks(device: torch.device, geometry: RingGeometry) -> int:
    """The most blocks of one K2 ring launch of ``geometry`` that are
    co-resident on ``device`` (the occupancy API's count at its bytes)."""
    index = torch.device(device).index
    n = build.bind("gs_mega_ring_max_blocks", [ctypes.c_int] * 3)(
        torch.cuda.current_device() if index is None else index,
        geometry.tile, geometry.buffers)
    if n <= 0:
        raise RuntimeError(f"mega ring kernel occupancy query failed: CUDA "
                           f"error {-n} ({build.error_name(-n)})")
    return n


def pinned_max_blocks(device: torch.device, geometry) -> int:
    """The most blocks of one pinned K2 launch on ``geometry``'s tiles that
    are co-resident on ``device`` (the occupancy API's count at its
    bytes and registers, the fewest over the instantiations)."""
    return _occupancy("gs_mega_pinned_max_blocks", device, geometry)


def packed_pinned_max_blocks(device: torch.device, geometry) -> int:
    """:func:`pinned_max_blocks` of K6's pinned entry."""
    return _occupancy("gs_packed_mega_pinned_max_blocks", device, geometry)


def _occupancy(name: str, device, geometry) -> int:
    index = torch.device(device).index
    n = build.bind(name, [ctypes.c_int] * 3)(
        torch.cuda.current_device() if index is None else index,
        geometry.tr, geometry.tc)
    if n <= 0:
        raise RuntimeError(f"{name} on {geometry.label()}: CUDA error {-n} "
                           f"({build.error_name(-n)})" if n < 0 else
                           f"{name}: no block of {geometry.label()} fits an "
                           "SM")
    return n


def megastep(u_pair: torch.Tensor, v_pair: torch.Tensor, n_blocks: int,
             steps: int, consts: KernelConstants | FoldConstants,
             boundary: str, grid: int = 0, fold: bool = False,
             depth: int | None = None, geometry=None) -> None:
    """Advance slot 0 of the pairs (both float32 or both bfloat16) by
    ``n_blocks`` x ``steps`` steps, in place. ``grid``: the blocks of the
    launch, 0 for the co-resident maximum. ``fold``: the folded naive
    reaction, ``consts`` a ``FoldConstants`` and the boundary naive.
    ``depth``: the window ring's depth (None: the double buffer; the
    geometry that runs is :func:`ring_geometry`'s). ``geometry``: the
    tiles (``ops/geometry.py:mega_resolve``; None: the compiled 64x64),
    which takes no ring. On a CUDA device the launch is enqueued on the
    current stream and not waited for."""
    global launches, bf16_launches, ring_launches, ring_bf16_launches
    global pinned_launches, pinned_bf16_launches
    _check(u_pair, v_pair, n_blocks, steps, boundary, grid,
           checks.STORAGE_DTYPES)
    pinned = _is_pinned(geometry)
    if pinned and check_depth(depth) != 2:
        raise ValueError(f"a pinned tile ({geometry.label()}) takes no "
                         f"window ring; got depth {depth}")
    ring = ring_geometry(tuple(u_pair.shape[1:]), depth)
    if fold:
        _fold_megastep(u_pair, v_pair, n_blocks, steps, consts, boundary,
                       grid, ring, geometry if pinned else None)
        return
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
    if pinned:
        fn = _pinned_kernel(u_pair.dtype, False)
        _launch(lambda *args: fn(*args, geometry.tr, geometry.tc), u_pair,
                v_pair, n_blocks, steps, consts, boundary, grid)
        if bf16:
            pinned_bf16_launches += 1
        else:
            pinned_launches += 1
        return
    if ring.ring:
        fn = _ring_kernel(u_pair.dtype, False)
        _launch(lambda *args: fn(*args, ring.tile, ring.buffers),
                u_pair, v_pair, n_blocks, steps, consts, boundary, grid)
        if bf16:
            ring_bf16_launches += 1
        else:
            ring_launches += 1
        return
    _launch(_bf16_kernel() if bf16 else _kernel(), u_pair, v_pair, n_blocks,
            steps, consts, boundary, grid)
    if bf16:
        bf16_launches += 1
    else:
        launches += 1


def _fold_megastep(u_pair, v_pair, n_blocks, steps, fc, boundary, grid,
                   geometry: RingGeometry, tiles=None) -> None:
    """:func:`megastep` with ``fold=True`` (``tiles``: a pinned geometry,
    or None)."""
    global fold_launches, fold_bf16_launches
    global ring_fold_launches, ring_fold_bf16_launches
    global pinned_fold_launches, pinned_fold_bf16_launches
    checks.check_fold(fc, boundary)
    if u_pair.device.type == "cpu":
        ru, rv = megastep_reference_fold(u_pair[0], v_pair[0], n_blocks,
                                         steps, fc)
        u_pair[0].copy_(ru)
        v_pair[0].copy_(rv)
        return
    _, rows, cols = u_pair.shape
    barrier = torch.zeros(1, dtype=torch.int64, device=u_pair.device)
    stream = torch.cuda.current_stream(u_pair.device).cuda_stream
    ring = (geometry.tile, geometry.buffers) if geometry.ring else ()
    if tiles is not None:
        fn, tail = _pinned_kernel(u_pair.dtype, True), (tiles.tr, tiles.tc)
    elif ring:
        fn, tail = _ring_kernel(u_pair.dtype, True), ring
    else:
        fn, tail = _fold_kernel(u_pair.dtype), ()
    err = fn(u_pair.data_ptr(), v_pair.data_ptr(), rows, cols, n_blocks,
             steps, u_pair.device.index, *build.fold_args(fc), grid,
             barrier.data_ptr(), stream, *tail)
    if err != 0:
        raise RuntimeError(f"mega fold kernel launch failed: CUDA error "
                           f"{err} ({build.error_name(err)})")
    bf16 = u_pair.dtype == torch.bfloat16
    if tiles is not None and bf16:
        pinned_fold_bf16_launches += 1
    elif tiles is not None:
        pinned_fold_launches += 1
    elif ring and bf16:
        ring_fold_bf16_launches += 1
    elif ring:
        ring_fold_launches += 1
    elif bf16:
        fold_bf16_launches += 1
    else:
        fold_launches += 1


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
                    pc: PackedConstants, grid: int = 0,
                    geometry=None) -> None:
    """K6: advance slot 0 of the packed pair ``x_pair`` (``(2, R, 2C)``)
    by ``n_blocks`` x ``steps`` (1..MEGA_STEPS) steps, in place. ``grid``:
    the blocks of the launch, 0 for the co-resident maximum. ``geometry``:
    the tiles of one species (``ops/geometry.py:mega_resolve``; None: the
    compiled 64x64). On a CUDA device the launch is enqueued on the
    current stream and not waited for."""
    global packed_launches, packed_pinned_launches
    _check_packed(x_pair, n_blocks, steps, grid)
    pinned = _is_pinned(geometry)
    if x_pair.device.type == "cpu":
        x_pair[0].copy_(packed.packed_run(x_pair[0], n_blocks * steps, pc))
        return
    if pinned:
        if "packed" not in _pinned_fns:
            _pinned_fns["packed"] = build.bind(
                "gs_packed_mega_pinned_multistep",
                _packed_kernel().argtypes + [ctypes.c_int] * 2)
        fn = _pinned_fns["packed"]
        _launch_packed(lambda *args: fn(*args, geometry.tr, geometry.tc),
                       x_pair, n_blocks, steps, pc, grid)
        packed_pinned_launches += 1
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
