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
launches are counted in ``fold_launches`` and ``fold_bf16_launches``. They
run the fold's second form, as K1's do (``ops/windowed.py``: a float32
pair loads its windows through TMA where ``windowed.fold_load`` says so,
those launches also counted in ``fold_tma_launches``);
:func:`fold_ablation` runs the first form and the parts of the split
(:data:`FOLD_ABLATIONS`, K1's numbering), on the card only.

``launches`` counts the kernel launches, and only them (the bf16 entry's
apart, in ``bf16_launches``), so that a run can show that its main path
went through the kernel. :func:`megastep_ablation`
runs the kernel with one part of its design taken out (``ABLATIONS``), for
timing what each part buys; its launches are not the main path's and are
not counted.

``depth`` (``mega_depth``, 2..8; ``megakernel.py:_mega_kernel(depth=)``,
the ring at ``:562-630``) runs the window ring: ``depth`` window slots and
the step's scratch, ``depth - 1`` window loads in flight while a tile
steps (``csrc/mega_ring.cu``, ``gs_tile_sm90.cuh:ring_walk``;
:func:`ring_walk_plan` is the walk's CPU twin), on twice the double
buffer's threads at 64 registers a thread, so that the SM keeps 32 warps
where the ring's bytes leave one block.
:func:`ring_geometry` gives the tile and the depth that run: JAX's clamp to
2 under ``2 * depth`` tiles, then 64x64 tiles while the ring fits a block's
shared memory, else 32x32 (the port's counterpart of
``choose_mega_geometry`` shrinking its tile with depth, ``:819-860``).
:func:`ring_ablation` runs the ring's first form (half the threads at 128
registers) and the other parts of its split (:data:`RING_ABLATIONS`), on
the card only.
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
what a step computes, so the plain versions are the same. ``depth`` above
2 on a pinned geometry runs the window ring on its tiles
(:func:`ring_geometry` with ``tiles``: JAX's clamp to depth 2 on few
windows, ``grayscott_tpu/ops/megakernel.py:544-545``, ``:755-763``; a ring
past the shared memory a block may use raises naming its bytes): the
pinned ring entries of ``csrc/mega_pins_ring.cu``, counted in
``pinned_ring_launches``, ``pinned_ring_bf16_launches``,
``pinned_ring_fold_launches`` and ``pinned_ring_fold_bf16_launches``.

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

from ..errors import UnsupportedConfigError
from ..params import FoldConstants, KernelConstants, PackedConstants
from . import build, checks, geometry as geo, packed, stencil, windowed

#: most steps of one time block: the kernel's compile-time halo depth
MEGA_STEPS = 8

#: kernel launches so far (CPU calls run the plain version and add nothing)
launches = 0
#: the bf16 entry's launches so far (bfloat16 pairs)
bf16_launches = 0
#: the fold entries' launches so far (float32, bfloat16 pairs)
fold_launches = 0
fold_bf16_launches = 0
#: the float32 fold launches whose windows loaded through TMA (also counted
#: in ``fold_launches``)
fold_tma_launches = 0

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
#: the pinned ring entries' launches (a ``depth`` ring on a pinned
#: geometry), by storage and mode
pinned_ring_launches = 0
pinned_ring_bf16_launches = 0
pinned_ring_fold_launches = 0
pinned_ring_fold_bf16_launches = 0

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

#: threads of a block of the double buffer on 64x64 and pinned tiles, and
#: the strip of rows a thread steps (``Main``); 32x32 tiles take half the
#: threads, the ring's kernels twice (the pinned ring's where its bytes
#: leave room for one block an SM)
RING_THREADS = 512
STRIP = 4

#: a thread's strips of a pinned ring's widest in-place step in the
#: ablation parts bound to two blocks an SM (``PIN_RING_ITEMS_2``)
PIN_RING_ITEMS_2 = 3


class RingGeometry(NamedTuple):
    """What a megakernel launch of a ``depth`` pin runs (ring_geometry)."""

    #: tile edge: 64 (64x64 tiles in 80x80 windows) or 32; None on pinned
    #: tiles
    tile: int | None
    depth: int  #: the depth after JAX's clamp
    buffers: int  #: window buffers: 2 at depth 2, else depth + 1
    bytes: int  #: dynamic shared memory of a block
    blocks_per_sm: int  #: blocks an SM that the bytes leave room for
    #: the pinned tiles (``ops/geometry.py``), or None
    tiles: "geo.Geometry | None" = None

    @property
    def ring(self) -> bool:
        """Whether the ring entries run it (else the double buffer)."""
        if self.tiles is not None:
            return self.buffers > 2
        return (self.tile, self.buffers) != (64, 2)


def ring_buffers(depth: int) -> int:
    """Window buffers of a ring of ``depth`` slots: the slots and the
    step's scratch; depth 2 is the double buffer (two)."""
    return 2 if depth == 2 else depth + 1


def ring_items(tr: int, tc: int, threads: int = RING_THREADS) -> int:
    """A thread's strips of the widest in-place step of a window of a
    ``tr`` x ``tc`` tile (its first step: the window less its outer ring,
    in strips of STRIP rows), ``threads`` to a block
    (``gs_tile_sm90.cuh:ring_items``)."""
    wr, wc = tr + 2 * MEGA_STEPS, tc + 2 * MEGA_STEPS
    return -(-(wc - 2) * -(-(wr - 2) // STRIP) // threads)


def pinned_two_blocks(nbytes: int) -> bool:
    """Whether a pinned ring of ``nbytes`` runs the kernels of 512 threads
    bound to two blocks an SM (else 1024 threads bound to one): its bytes
    leave room for two (``csrc/mega_pins_ring.cu:two_blocks``)."""
    return 2 * (nbytes + SMEM_RESERVED) <= SMEM_SM


def ring_walk_plan(n_tiles: int, nbuf: int, steps: int,
                   in_place: bool = False) -> list:
    """The CPU twin of one block's walk of ``n_tiles`` tiles through a
    ring of ``nbuf`` (2..RING_MAX_BUFFERS) buffers, ``steps`` steps a tile
    (``gs_tile_sm90.cuh:ring_walk``: RING_SCRATCH, the entries' walk, each
    step writing the other of two buffers; ``in_place``: RING_IN_PLACE, the
    ablation parts 5-7, each tile stepped in its own buffer). One dict a
    tile j, in order:

    - ``load``: the buffer its window loads into;
    - ``issued_at``: the tile whose step (RING_SCRATCH: issued after that
      tile's last step's barrier) or opening barrier (RING_IN_PLACE) it
      loads after; -1: when the time block begins;
    - ``wait``: the loads the wait before its steps may leave in flight;
    - ``steps``: (read, written) buffers of each of its steps;
    - ``store``: the buffer its write-out reads;
    - ``in_flight``: the loads in flight while it steps (issued, not yet
      waited for).
    """
    if not 2 <= nbuf <= RING_MAX_BUFFERS:
        raise ValueError(f"nbuf must be in [2, {RING_MAX_BUFFERS}], got "
                         f"{nbuf}")
    odd = 0 if in_place else steps & 1
    m = nbuf - odd
    plan = []
    for j in range(n_tiles):
        b = j % m if not in_place else j % nbuf
        if in_place:
            scratch, loads_into = b, (b - 1) % nbuf
        else:
            scratch = m if odd else (b - 1) % m
            loads_into = b if odd else scratch
        seq, cur, other = [], b, scratch
        for _ in range(steps):
            seq.append((cur, cur if in_place else other))
            if not in_place:
                cur, other = other, cur
        plan.append({"steps": seq, "store": seq[-1][1], "frees": loads_into})
    for j, tile in enumerate(plan):
        tile["load"] = (j if j < nbuf - 1
                        else plan[j - nbuf + 1]["frees"])
        tile["issued_at"] = -1 if j < nbuf - 1 else j - nbuf + 1
        tile["wait"] = min(nbuf - 2, n_tiles - 1 - j)
    for j, tile in enumerate(plan):
        # RING_SCRATCH issues after tile j's steps, RING_IN_PLACE before
        tile["in_flight"] = sum(
            1 for k in range(j + 1, n_tiles)
            if plan[k]["issued_at"] < j
            or (in_place and plan[k]["issued_at"] == j))
        del tile["frees"]
    return plan


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
                  sharded: bool = False,
                  tiles: "geo.Geometry | None" = None) -> RingGeometry:
    """(tile, depth, buffers, bytes, blocks an SM) of a megakernel run of
    a ``shape`` (R, C) domain under a ``depth`` pin.

    The tile follows the pinned depth: 64x64 tiles while the ring fits the
    shared memory a block may opt into (depths 2 and 3), else 32x32 (4-8).
    Then JAX's clamp (``grayscott_tpu/ops/megakernel.py:1022-1028``,
    ``:755-763``): depth 2 when sharded (K7 takes no depth) or when the
    windows, here the tiles, number fewer than ``2 * depth``; the tile
    stays the one the pin chose, as JAX's row tile does. ``blocks_per_sm``
    counts the blocks that shared memory leaves room for (228 KB an SM, 1
    KB reserved a block),
    which the ring kernels' threads and register bound follow (1024
    threads at 64 registers on 64x64 tiles, one block; 512 on 32x32, two),
    so that the occupancy API's count, which the launch takes, is that
    many an SM for every ring of depth 3 to 8; a depth clamped to 2 on
    32x32 tiles (two buffers, room for six blocks) runs two. The pinned
    ring's count is capped at its bound (:func:`pinned_two_blocks`).

    ``tiles`` (a pinned geometry, not the compiled 64x64): the ring runs
    on them, and JAX's clamp counts their windows as JAX counts its row
    and column blocks (``:544-545``, ``:755-763``): depth 2 unless the tile
    rows number at least ``2 * depth`` on one tile column, or (tile rows
    - 1) x tile columns do on several. A ring past the shared memory a
    block may use raises :class:`UnsupportedConfigError` naming its
    bytes."""
    d = check_depth(depth)
    r, c = shape
    if tiles is not None:
        rows_t, cols_t = -(-r // tiles.tr), -(-c // tiles.tc)
        windows = rows_t if cols_t == 1 else (rows_t - 1) * cols_t
        if sharded or windows < 2 * d:
            d = 2
        buffers = ring_buffers(d)
        nbytes = buffers * tiles.bytes // 2
        if nbytes > SMEM_OPTIN:
            raise UnsupportedConfigError(
                f"mega_depth={d} on {tiles.tr}x{tiles.tc} tiles needs "
                f"{nbytes} B of shared memory a block for its {buffers} "
                f"window buffers, past the {SMEM_OPTIN} B a block may use; "
                "pin a smaller tile or depth", combo="mega_depth+tiles")
        per_sm = SMEM_SM // (nbytes + SMEM_RESERVED)
        if d > 2:
            per_sm = min(per_sm, 2 if pinned_two_blocks(nbytes) else 1)
        return RingGeometry(None, d, buffers, nbytes, per_sm, tiles)
    tile = 64 if ring_buffers(d) * PAIR_BYTES[64] <= SMEM_OPTIN else 32
    if sharded or -(-r // tile) * -(-c // tile) < 2 * d:
        d = 2
    buffers = ring_buffers(d)
    nbytes = buffers * PAIR_BYTES[tile]
    return RingGeometry(tile, d, buffers, nbytes,
                        SMEM_SM // (nbytes + SMEM_RESERVED))


def in_place_geometry(shape: Tuple[int, int], depth: int,
                      tiles: "geo.Geometry | None" = None) -> RingGeometry:
    """:func:`ring_geometry` of the ring with each tile stepped in place
    (the ablation parts 6 and 7): ``depth`` buffers, 64x64 tiles while they
    fit a block's shared memory (depths 2-4), else 32x32; JAX's clamp the
    same; ``blocks_per_sm`` by shared memory alone."""
    d = check_depth(depth)
    r, c = shape
    if tiles is not None:
        rows_t, cols_t = -(-r // tiles.tr), -(-c // tiles.tc)
        windows = rows_t if cols_t == 1 else (rows_t - 1) * cols_t
        d = 2 if windows < 2 * d else d
        nbytes = d * tiles.bytes // 2
        return RingGeometry(None, d, d, nbytes,
                            SMEM_SM // (nbytes + SMEM_RESERVED), tiles)
    tile = 64 if d * PAIR_BYTES[64] <= SMEM_OPTIN else 32
    if -(-r // tile) * -(-c // tile) < 2 * d:
        d = 2
    nbytes = d * PAIR_BYTES[tile]
    return RingGeometry(tile, d, d, nbytes,
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

#: the parts of the ring's split (csrc/splits/mega_ring_ablation.cu:
#: gs_mega_ring_ablation): each gives the whole kernel's result, but part
#: 2, whose result is its input; on 64x64 or 32x32 tiles (the compiled
#: geometries) or pinned ones, float32, naive, the default tap set
RING_ABLATIONS = {
    0: "the first form: the ring on the double buffer's threads, 128 "
       "registers a thread",
    1: "the first form bound to 64 registers a thread",
    2: "the first form's window loads and stores alone (no step)",
    3: "the first form waiting for every window in flight before each "
       "tile's steps",
    4: "the double buffer on the first form's tile and grid",
    5: "each tile stepped in place (depth buffers) on the first form's "
       "tile and grid",
    6: "in place on twice the threads, 64 registers a thread, on the tile "
       "depth buffers allow",
    7: "in place bound to 64 registers a thread, on that tile",
    8: "the first form on twice the threads, 64 registers a thread, one "
       "block an SM",
}
#: the parts that run on the tile the depth buffers of the in-place walk
#: allow (in_place_geometry; the others on ring_geometry's)
RING_IN_PLACE_PARTS = (6, 7)

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

#: the parts of the fold entries' split (csrc/mega.cu: gs_mega_fold_ablation;
#: part 4 launches the exact naive entry), numbered as K1's (K2's entry
#: takes its neighbour columns by scalar loads, so its part 9 is the entry
#: and its other blocks load them so too); each gives the whole kernel's
#: result, the parts of 0 steps their input
FOLD_ABLATIONS = windowed.FOLD_ABLATIONS

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


#: the fold arguments of K2's entries: the pairs, rows, cols, n_blocks,
#: steps, device, the constants, separable, dt_is_one, grid, the barrier,
#: the stream (the ring's and the pins' tails follow)
_FOLD_ARGS = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
              + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2)
#: the double buffer's fold entries and their ablation end with ``tma``
_FOLD_ENTRY_ARGS = _FOLD_ARGS + [ctypes.c_int]


def _fold_entry(dtype):
    """The fold entry of ``dtype`` pairs at the double buffer and the
    compiled tiles."""
    if dtype not in _fold_fns:
        _kernel()  # checks the time-block depth
        name = "gs_mega_multistep_fold" + (
            "_bf16" if dtype == torch.bfloat16 else "")
        _fold_fns[dtype] = build.bind(name, _FOLD_ENTRY_ARGS)
    return _fold_fns[dtype]


def _base_args(dtype, fold: bool) -> list:
    """The double buffer's arguments of ``dtype`` pairs (``fold``: the
    fold's, without ``tma``), which the ring's and the pins' entries
    extend."""
    if fold:
        _kernel()  # checks the time-block depth
        return _FOLD_ARGS
    return (_bf16_kernel() if dtype == torch.bfloat16 else _kernel()).argtypes


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
        base = _base_args(dtype, fold)
        _check_ring_buffers()
        name = "gs_mega_ring_multistep" + ("_fold" if fold else "") + (
            "_bf16" if dtype == torch.bfloat16 else "")
        _ring_fns[key] = build.bind(name, base + [ctypes.c_int] * 2)
    return _ring_fns[key]


def _pinned_kernel(dtype, fold: bool):
    """The pinned entry of K2 for ``dtype`` pairs (``fold``: its fold
    entry): the double buffer's arguments, then ``tr`` and ``tc``."""
    key = (dtype, fold)
    if key not in _pinned_fns:
        base = _base_args(dtype, fold)
        name = "gs_mega_pinned_multistep" + ("_fold" if fold else "") + (
            "_bf16" if dtype == torch.bfloat16 else "")
        _pinned_fns[key] = build.bind(name,
                                      base + [ctypes.c_int] * 2)
    return _pinned_fns[key]


def _pinned_ring_kernel(dtype, fold: bool):
    """The pinned ring entry of K2 for ``dtype`` pairs (``fold``: its fold
    entry): the double buffer's arguments, then ``tr``, ``tc`` and the
    buffers."""
    key = ("ring", dtype, fold)
    if key not in _pinned_fns:
        base = _base_args(dtype, fold)
        name = "gs_mega_pinned_ring_multistep" + (
            "_fold" if fold else "") + (
            "_bf16" if dtype == torch.bfloat16 else "")
        _pinned_fns[key] = build.bind(name,
                                      base + [ctypes.c_int] * 3)
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


def pinned_ring_max_blocks(device: torch.device,
                           geometry: RingGeometry) -> int:
    """The most blocks of one pinned ring launch of ``geometry`` (its
    tiles and buffers) that are co-resident on ``device``, the fewest over
    the instantiations."""
    index = torch.device(device).index
    n = build.bind("gs_mega_pinned_ring_max_blocks", [ctypes.c_int] * 4)(
        torch.cuda.current_device() if index is None else index,
        geometry.tiles.tr, geometry.tiles.tc, geometry.buffers)
    if n <= 0:
        raise RuntimeError(f"pinned ring occupancy query on "
                           f"{geometry.tiles.label()}, {geometry.buffers} "
                           f"buffers: " + (
                               f"CUDA error {-n} ({build.error_name(-n)})"
                               if n < 0 else "no block fits an SM"))
    return n


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
    on which a ``depth`` ring runs too. On a CUDA device the launch is
    enqueued on the current stream and not waited for."""
    global launches, bf16_launches, ring_launches, ring_bf16_launches
    global pinned_launches, pinned_bf16_launches
    global pinned_ring_launches, pinned_ring_bf16_launches
    _check(u_pair, v_pair, n_blocks, steps, boundary, grid,
           checks.STORAGE_DTYPES)
    pinned = _is_pinned(geometry)
    ring = ring_geometry(tuple(u_pair.shape[1:]), depth,
                         tiles=geometry if pinned else None)
    if fold:
        _fold_megastep(u_pair, v_pair, n_blocks, steps, consts, boundary,
                       grid, ring)
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
    if pinned and ring.ring:
        fn = _pinned_ring_kernel(u_pair.dtype, False)
        _launch(lambda *args: fn(*args, geometry.tr, geometry.tc,
                                 ring.buffers),
                u_pair, v_pair, n_blocks, steps, consts, boundary, grid)
        if bf16:
            pinned_ring_bf16_launches += 1
        else:
            pinned_ring_launches += 1
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


#: the fold entries' counters: (pinned tiles, ring, bf16) -> name
_FOLD_COUNTERS = {
    (False, False, False): "fold_launches",
    (False, False, True): "fold_bf16_launches",
    (False, True, False): "ring_fold_launches",
    (False, True, True): "ring_fold_bf16_launches",
    (True, False, False): "pinned_fold_launches",
    (True, False, True): "pinned_fold_bf16_launches",
    (True, True, False): "pinned_ring_fold_launches",
    (True, True, True): "pinned_ring_fold_bf16_launches",
}


def _fold_megastep(u_pair, v_pair, n_blocks, steps, fc, boundary, grid,
                   geometry: RingGeometry) -> None:
    """:func:`megastep` with ``fold=True`` (``geometry.tiles``: a pinned
    geometry, or None)."""
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
    tiles, ring = geometry.tiles, geometry.ring
    if tiles is not None and ring:
        fn = _pinned_ring_kernel(u_pair.dtype, True)
        tail = (tiles.tr, tiles.tc, geometry.buffers)
    elif tiles is not None:
        fn, tail = _pinned_kernel(u_pair.dtype, True), (tiles.tr, tiles.tc)
    elif ring:
        fn = _ring_kernel(u_pair.dtype, True)
        tail = (geometry.tile, geometry.buffers)
    else:
        tma = windowed.fold_load(u_pair, v_pair) == "tma"
        fn, tail = _fold_entry(u_pair.dtype), (int(tma),)
    err = fn(u_pair.data_ptr(), v_pair.data_ptr(), rows, cols, n_blocks,
             steps, u_pair.device.index, *build.fold_args(fc), grid,
             barrier.data_ptr(), stream, *tail)
    if err != 0:
        raise RuntimeError(f"mega fold kernel launch failed: CUDA error "
                           f"{err} ({build.error_name(err)})")
    name = _FOLD_COUNTERS[tiles is not None, ring,
                          u_pair.dtype == torch.bfloat16]
    globals()[name] += 1
    if tiles is None and not ring:
        globals()["fold_tma_launches"] += tail[0]


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


def fold_ablation(u_pair: torch.Tensor, v_pair: torch.Tensor,
                  n_blocks: int, steps: int, fc: FoldConstants, part: int,
                  exact: KernelConstants | None = None,
                  grid: int = 0) -> None:
    """The float32 fold entry on the card in the form of ``part``
    (:data:`FOLD_ABLATIONS`), on a stencil with a separable plan: slot 0
    of the pairs advanced by ``n_blocks`` time blocks of ``steps``
    (1..MEGA_STEPS) folded steps in place, or by none for the parts of no
    step. Part 4 runs the exact naive entry with ``exact`` (the same
    parameters' ``KernelConstants``; its result is ``stencil.run``'s).
    The second form's parts load as ``windowed.fold_load`` says; parts
    7-12 load through TMA only. Not counted in any launch counter."""
    _check(u_pair, v_pair, n_blocks, steps, "naive", grid)
    checks.check_fold(fc, "naive")
    if part not in FOLD_ABLATIONS:
        raise ValueError(f"part must be one of {sorted(FOLD_ABLATIONS)}, "
                         f"got {part!r}")
    if not fc.separable:
        raise ValueError("the fold's ablation parts run the separable plan; "
                         "this stencil has none")
    if (part == windowed.FOLD_ABLATION_EXACT
            and not isinstance(exact, KernelConstants)):
        raise ValueError("part 4 runs the exact naive entry: pass the same "
                         "parameters' KernelConstants as exact")
    load = windowed.fold_load(u_pair, v_pair)
    windowed.check_tma_part(part, load)
    if u_pair.device.type != "cuda":
        raise ValueError("an ablation runs the kernel: the pairs must lie on "
                         f"a CUDA device, not {u_pair.device}")
    if part == windowed.FOLD_ABLATION_EXACT:
        _launch(_kernel(), u_pair, v_pair, n_blocks, steps, exact, "naive",
                grid)
        return
    fn = build.bind("gs_mega_fold_ablation",
                    _FOLD_ENTRY_ARGS + [ctypes.c_int])
    _, rows, cols = u_pair.shape
    barrier = torch.zeros(1, dtype=torch.int64, device=u_pair.device)
    stream = torch.cuda.current_stream(u_pair.device).cuda_stream
    err = fn(u_pair.data_ptr(), v_pair.data_ptr(), rows, cols, n_blocks,
             steps, u_pair.device.index, *build.fold_args(fc), grid,
             barrier.data_ptr(), stream, int(load == "tma"), part)
    if err != 0:
        raise RuntimeError(f"mega fold ablation part {part} failed: CUDA "
                           f"error {err} ({build.error_name(err)})")


def ring_ablation_plan(shape: Tuple[int, int], depth: int, part: int,
                       tiles: "geo.Geometry | None" = None) -> dict:
    """What part ``part`` of the ring's split runs at ``depth`` on a
    ``shape`` domain (``tiles``: pinned, else the compiled geometries):
    {tile (tr, tc), pinned, buffers the walk uses, grid_buffers whose bytes
    set the grid, threads}. Raises ValueError where JAX's clamp leaves no
    ring, or where the part's in-place step does not fit its registers."""
    if part not in RING_ABLATIONS:
        raise ValueError(f"part must be one of {sorted(RING_ABLATIONS)}, got "
                         f"{part!r}")
    ring = ring_geometry(shape, depth, tiles=tiles)
    in_place = in_place_geometry(shape, depth, tiles)
    if ring.depth == 2 or in_place.depth == 2:
        raise ValueError(f"mega_depth={depth} clamps to 2 on {shape}: no "
                         "ring to split")
    g = in_place if part in RING_IN_PLACE_PARTS else ring
    tr, tc = (g.tile, g.tile) if tiles is None else (tiles.tr, tiles.tc)
    threads = (RING_THREADS if tiles is not None or g.tile == 64
               else RING_THREADS // 2) * (2 if part in (6, 8) else 1)
    buffers = {4: 2, 5: g.depth}.get(part, g.buffers)
    if tiles is not None and part in (6, 7):
        most = PIN_RING_ITEMS_2
        if ring_items(tr, tc, threads) > most:
            raise ValueError(f"part {part} holds {most} strips a thread; "
                             f"{tiles.label()} needs "
                             f"{ring_items(tr, tc, threads)}")
    return {"tile": (tr, tc), "pinned": tiles is not None,
            "buffers": buffers, "grid_buffers": g.buffers, "threads": threads,
            "bytes": g.bytes}


def ring_ablation(u_pair: torch.Tensor, v_pair: torch.Tensor, n_blocks: int,
                  steps: int, consts: KernelConstants, part: int, depth: int,
                  geometry=None, grid: int = 0) -> None:
    """K2's ring on the card in the form of ``part``
    (:data:`RING_ABLATIONS`; :func:`ring_ablation_plan` says where it
    runs): slot 0 of the float32 pairs advanced by ``n_blocks`` time blocks
    of ``steps`` steps in place (part 2: by none), naive boundary, the
    default stencil's tap set. ``geometry``: pinned tiles (None: the
    compiled geometries). Not counted in any launch counter."""
    _check(u_pair, v_pair, n_blocks, steps, "naive", grid)
    pinned = _is_pinned(geometry)
    plan = ring_ablation_plan(tuple(u_pair.shape[1:]), depth, part,
                              geometry if pinned else None)
    if u_pair.device.type != "cuda":
        raise ValueError("an ablation runs the kernel: the pairs must lie on "
                         f"a CUDA device, not {u_pair.device}")
    fn = build.bind("gs_mega_ring_ablation",
                    _kernel().argtypes + [ctypes.c_int] * 6, build.SPLITS)
    tr, tc = plan["tile"]
    _launch(lambda *args: fn(*args, tr, tc, int(pinned), plan["buffers"],
                             plan["grid_buffers"], part),
            u_pair, v_pair, n_blocks, steps, consts, "naive", grid)


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
