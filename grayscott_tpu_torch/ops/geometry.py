"""The temporal depth and the tile pins of the one-card windowed kernels K1
(``ops/windowed.py``) and K4 (``ops/packed.py``): what
``--pallas-steps-per-call``, ``--pallas-block-rows`` and
``--pallas-block-cols`` mean on the card.

JAX's windowed kernel takes any K in 1..32 (``grayscott_tpu/backends/
pallas.py:84-99``) in windows of ``halo_for_steps(K)`` rows on each side
(``grayscott_tpu/ops/pallas_stencil.py:87-92``), any row tile ``tr``
(``backends/pallas.py:270-287``) and a column tile ``tc`` (``:289-313``).
The port's kernels step 2-D tiles in shared memory, so the pins mean:

- ``block_rows`` is the K1 or K4 tile's height and ``block_cols`` its
  width. A pinned height steps down by 8 past the padded rows, as JAX's
  ``_tr`` does (``:284-287``); a pinned width of at least the domain's
  means one tile column across it (``:306-307``).
- An unpinned dimension keeps the port's 64. Where the window does not fit
  at 64, the unpinned dimension (both, when neither is pinned) takes the
  largest multiple of 8 whose window does: JAX's "fit the budget" rule for
  an unpinned ``tr`` (``choose_block_rows``, ``pallas_stencil.py:1865``),
  measured against shared memory instead of VMEM.
- The halo is ``halo_for_steps(K)`` on every side. A window pair takes
  (TR + 2H) x pitch x 4 B x 2 species x 2 buffers, the pitch TC + 2H
  rounded up to 8 floats (one 32-byte sector; equal to TC + 2H for every
  width that is a multiple of 8). A window past the 232,448 B a block may
  opt into (``csrc/gs_tile_sm90.cuh``: ``SMEM_OPTIN``) raises
  :class:`UnsupportedConfigError` naming the bytes, as JAX refuses what its
  VMEM and compile ceilings cannot hold.

The geometry of 64x64 tiles at a halo of 8 (K <= 8) is the compiled one
(``Main`` of ``gs_tile_sm90.cuh``), which the default entries launch; any
other runs the pinned entries, whose tile, halo and pitch are run-time
values. JAX's 128-lane quantum of ``tc`` (``pallas_stencil.py:1172-1178``)
is the TPU's lane width and has no counterpart here.

The megakernels' tile pins (K2, K6 and K7; :func:`mega_resolve`) take the
values JAX's megakernels take, and the rest raise JAX's refusal
(:func:`mega_pins_ok`): ``block_rows`` a positive multiple of 8
(``grayscott_tpu/ops/megakernel.py:733``), ``block_cols`` a positive
multiple of 128 (``:746-750``). Their halo is the time block's, 8. A
``block_cols`` of at least the domain's width means unpinned, as JAX's
``_mega_tiles`` drops it (``backends/pallas.py:396-397``,
``backends/sharded.py:285-286``); on a 2-D mesh's shard it means one tile
column across the shard, JAX's covering tile (``sharded.py:299-321``). An
unpinned dimension follows the windowed kernels' rule above; JAX's "a
pinned ``tr`` alone means full-width windows" has no counterpart, since a
tile in shared memory cannot span a row. A pinned height steps down past
the padded rows, as K1's does: a taller tile is one tile row all the same.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

from ..errors import UnsupportedConfigError

#: the deepest temporal block JAX's windowed kernel takes
#: (``grayscott_tpu/backends/pallas.py:56``), and the pinned entries'
MAX_STEPS_PER_CALL = 32

#: the compiled kernels' halo, and the row alignment quantum of the halo
#: rule (``pallas_stencil.py:HALO``)
HALO = 8

#: the port's tile edge where a dimension is not pinned (``Main``)
TILE = 64

#: the dynamic shared memory one block may opt into on an H100, of the
#: 233,472 B an SM has (228 KB), of which the CUDA runtime reserves 1 KB
#: a block
SMEM_OPTIN = 232448
SMEM_PER_SM = 233472
SMEM_PER_BLOCK_RESERVED = 1024

#: blocks an SM at most by registers: 512 threads a block, 64 registers a
#: thread (``__launch_bounds__(512, 2)`` of every windowed entry)
BLOCKS_BY_REGISTERS = 2

#: threads a block of every windowed entry (``Main``'s)
THREADS = 512

#: the pinned geometries (tr, tc, halo) whose sizes K1's pinned entries
#: compile in (csrc/windowed_pins.cuh: ``fixed_geometry``; for the default
#: stencils' tap set): K = 9..16 on the default tiles, and the sharded
#: windowed engine's row tile of 32 at K = 16
FIXED_PINS = ((64, 64, 16), (32, 64, 16))


class PinLaunch(NamedTuple):
    """What one launch of K1's pinned entries runs on a geometry
    (:meth:`Geometry.pin_launch`): ``threads`` a block, the ``cluster``
    shape of blocks (rows, cols; (1, 1): none), the ``blocks_per_sm`` its
    bytes and registers leave, its ``form`` ("blocks": 4x4 register
    blocks on interior tiles, strips on edge tiles; "strips": strips on
    every tile, the first form the fold entries keep) and its ``sizes``
    ("compiled" or "run-time")."""

    threads: int
    cluster: Tuple[int, int]
    blocks_per_sm: int
    form: str
    sizes: str


def halo_for_steps(k: int) -> int:
    """Halo depth for K fused steps: K rounded up to a multiple of 8,
    floored at 8 (``grayscott_tpu/ops/pallas_stencil.py:87-92``)."""
    return max(-(-k // 8) * 8, HALO)


def check_steps_per_call(k) -> int:
    """``k`` if it is a depth JAX's windowed kernel takes, else JAX's
    ``ValueError`` (``grayscott_tpu/backends/pallas.py:90-94``)."""
    if isinstance(k, bool) or not isinstance(k, int) or \
            not 1 <= k <= MAX_STEPS_PER_CALL:
        raise ValueError(f"steps_per_call must be in [1, "
                         f"{MAX_STEPS_PER_CALL}], got {k}")
    return k


def check_tile(name: str, value) -> int | None:
    """A tile pin: None, or a positive int (ValueError otherwise)."""
    if value is None:
        return None
    if isinstance(value, bool) or not isinstance(value, int) or value < 1:
        raise ValueError(f"{name} must be a positive int, got {value!r}")
    return value


def tile_shape(tile) -> Tuple[int, int]:
    """``(tr, tc)`` of a tile given as one edge or as ``(tr, tc)``."""
    return (tile, tile) if isinstance(tile, int) else tuple(tile)


def pitch(width: int) -> int:
    """The row pitch of a window ``width`` cells wide: a multiple of 8."""
    return -(-width // 8) * 8


def window_bytes(tr: int, tc: int, halo: int) -> int:
    """Dynamic shared memory of one block: two buffers of a window pair."""
    return (tr + 2 * halo) * pitch(tc + 2 * halo) * 4 * 2 * 2


def blocks_per_sm(nbytes: int) -> int:
    """Blocks of ``nbytes`` of shared memory that one SM holds at once,
    at most BLOCKS_BY_REGISTERS."""
    return min(SMEM_PER_SM // (nbytes + SMEM_PER_BLOCK_RESERVED),
               BLOCKS_BY_REGISTERS)


class Geometry(NamedTuple):
    """One launch's tiles: ``tr`` x ``tc`` output cells in windows of
    ``halo`` more on each side; at most ``halo`` steps a launch."""

    tr: int
    tc: int
    halo: int

    @property
    def bytes(self) -> int:
        return window_bytes(self.tr, self.tc, self.halo)

    @property
    def blocks_per_sm(self) -> int:
        return blocks_per_sm(self.bytes)

    @property
    def compiled(self) -> bool:
        """Whether the default entries run it (``Main``: 64x64, halo 8)."""
        return self == DEFAULT

    def pin_launch(self, fold: bool = False,
                   default_taps: bool = True) -> PinLaunch:
        """The launch of K1's pinned entries on these tiles (not the
        compiled geometry, which the default entries run): Main's threads,
        no cluster (the split's clusters lost, PERF.md §6), the
        blocks an SM of the window's bytes at two blocks by registers; the
        second form's blocks but for the folded naive reaction (``fold``),
        which keeps the first form's strips; sizes compiled in on
        FIXED_PINS for the default stencils' tap set (``default_taps``),
        as the C entries choose (csrc/windowed_pins.cu)."""
        compiled = (not fold and default_taps
                    and tuple(self) in FIXED_PINS)
        return PinLaunch(THREADS, (1, 1), self.blocks_per_sm,
                         "strips" if fold else "blocks",
                         "compiled" if compiled else "run-time")

    def stepped_ratio(self, k: int) -> float:
        """Window cells stepped over K steps for each output cell-step (the
        halo recompute): step s steps the (WR - 2s)(WC - 2s) cells inside
        the window's outer s rings."""
        stepped = sum((self.tr + 2 * (self.halo - s))
                      * (self.tc + 2 * (self.halo - s))
                      for s in range(1, k + 1))
        return stepped / (k * self.tr * self.tc)

    def label(self) -> str:
        return (f"{self.tr}x{self.tc} tiles, halo {self.halo}, "
                f"{self.bytes} B")


#: the compiled geometry (csrc/gs_tile_sm90.cuh: Main, HALO)
DEFAULT = Geometry(TILE, TILE, HALO)

#: columns of a cluster block's window past its tile and halo
#: (csrc/gs_pin_sm90.cuh: CLUSTER_MARGIN): a right-hand block's window
#: starts on a multiple of 8 columns
CLUSTER_MARGIN = 8


def cluster_bytes(tr: int, tc: int, halo: int) -> int:
    """Dynamic shared memory of a block of the pinned entries' cluster form
    (csrc/gs_pin_sm90.cuh: clusters of 2x2 blocks over 2x2 tiles): two
    buffers of a window pair of tr + halo + 1 rows (its tile, the group's
    halo on one side, a ghost row on the other) of pitch(tc + halo +
    CLUSTER_MARGIN) floats."""
    return (tr + halo + 1) * pitch(tc + halo + CLUSTER_MARGIN) * 4 * 2 * 2


def pin_block_plan(g: Geometry, lo: int,
                   threads: int = THREADS) -> list:
    """The 4x4 register blocks (first row, first column, rows) that the
    pinned entries' second form steps on an interior tile of ``g`` at the
    step whose valid region is window cells [lo, WR - lo) x [lo, WC - lo)
    (csrc/gs_pin_sm90.cuh: ``pin_step_blocks``): strips of 4 rows, the
    region's columns rounded outward to multiples of 4, item ``it`` of
    thread ``it % threads``; by thread, in order."""
    wr, wc = g.tr + 2 * g.halo, g.tc + 2 * g.halo
    nblk = (wc - lo + 3) // 4 - lo // 4
    hi_r = wr - lo
    items = nblk * ((hi_r - lo + 3) // 4)
    plan = []
    for t in range(threads):
        blocks = []
        for it in range(t, items, threads):
            strip, q = divmod(it, nblk)
            lr0 = lo + 4 * strip
            blocks.append((lr0, lo // 4 * 4 + 4 * q, min(4, hi_r - lr0)))
        plan.append(blocks)
    return plan


def cluster_stepped_ratio(g: Geometry, k: int) -> float:
    """Cells a cluster of 2x2 blocks steps over K steps for each output
    cell-step: its group of 2x2 tiles recomputes the halo around the group
    only."""
    return Geometry(2 * g.tr, 2 * g.tc, g.halo).stepped_ratio(k)


def _fit(fixed_rows: int | None, fixed_cols: int | None,
         halo: int) -> Tuple[int, int]:
    """(tr, tc) with each unpinned (None) dimension at TILE, or shrunk in
    steps of 8 (both together when neither is pinned) until the window
    fits SMEM_OPTIN; the smallest is 8."""
    tr, tc = fixed_rows or TILE, fixed_cols or TILE
    while window_bytes(tr, tc, halo) > SMEM_OPTIN:
        shrink_r = fixed_rows is None and tr > 8
        shrink_c = fixed_cols is None and tc > 8
        if not (shrink_r or shrink_c):
            break
        tr, tc = tr - 8 * shrink_r, tc - 8 * shrink_c
    return tr, tc


def resolve(shape: Tuple[int, int], k: int = HALO,
            block_rows: int | None = None,
            block_cols: int | None = None) -> Geometry:
    """The tiles that K1 or K4 steps a domain of ``shape`` (rows, cols of
    one species) with, at depth ``k`` under the pins; raises
    :class:`UnsupportedConfigError` when the window cannot fit."""
    check_steps_per_call(k)
    rows, cols = shape
    halo = halo_for_steps(k)
    tr, tc = check_tile("block_rows", block_rows), \
        check_tile("block_cols", block_cols)
    if tr is not None:
        rp = -(-rows // 8) * 8
        while tr > 8 and tr > rp:  # backends/pallas.py:284-287
            tr -= 8
    if tc is not None and tc >= cols:
        tc = cols  # backends/pallas.py:306-307
    tr, tc = _fit(tr, tc, halo)
    nbytes = window_bytes(tr, tc, halo)
    if nbytes > SMEM_OPTIN:
        raise UnsupportedConfigError(
            f"a {tr}x{tc} tile at steps_per_call={k} (halo {halo}) needs "
            f"{nbytes} B of shared memory a block for its two window "
            f"buffers, past the {SMEM_OPTIN} B a block may use; pin a "
            "smaller tile or fewer steps per call", combo="tiles")
    return Geometry(tr, tc, halo)


#: the quanta of the megakernels' tile pins (grayscott_tpu/ops/
#: megakernel.py:733, :746-750): a positive multiple of each
MEGA_ROWS_QUANTUM = 8
MEGA_COLS_QUANTUM = 128


def mega_pins_ok(block_rows: int | None, block_cols: int | None) -> bool:
    """Whether JAX's megakernels take the tile pins: ``block_rows`` None or
    a positive multiple of 8, ``block_cols`` None or a positive multiple
    of 128 (``mega_ok``, ``grayscott_tpu/ops/megakernel.py:733``,
    ``:746-750``)."""
    rows_ok = block_rows is None or (block_rows >= MEGA_ROWS_QUANTUM and
                                     block_rows % MEGA_ROWS_QUANTUM == 0)
    cols_ok = block_cols is None or (block_cols >= MEGA_COLS_QUANTUM and
                                     block_cols % MEGA_COLS_QUANTUM == 0)
    return rows_ok and cols_ok


def mega_resolve(shape: Tuple[int, int], block_rows: int | None = None,
                 block_cols: int | None = None,
                 cover: bool = False) -> Geometry:
    """The tiles that a megakernel (K2, K6, K7) steps a domain of
    ``shape`` (rows, cols of one species; a shard's interior for K7) with
    under the tile pins, at the time block's halo of 8. ``cover``: the
    domain is a 2-D mesh's shard, where a ``block_cols`` of at least its
    width is one tile column across it (else it is unpinned). The pins'
    quanta are the caller's to check (:func:`mega_pins_ok`, whose refusal
    names the backend); a window past the shared memory a block may use
    raises :class:`UnsupportedConfigError` naming its bytes. Neither pinned:
    the compiled 64x64 tiles (K7 picks its own between 64x64 and 32x32)."""
    rows, cols = shape
    tr, tc = check_tile("block_rows", block_rows), \
        check_tile("block_cols", block_cols)
    if tc is not None and tc >= cols:
        tc = cols if cover else None
    if tr is not None:
        rp = -(-rows // 8) * 8
        while tr > 8 and tr > rp:
            tr -= 8
    tr, tc = _fit(tr, tc, HALO)
    nbytes = window_bytes(tr, tc, HALO)
    if nbytes > SMEM_OPTIN:
        raise UnsupportedConfigError(
            f"a {tr}x{tc} megakernel tile (halo {HALO}) needs {nbytes} B of "
            f"shared memory a block for its two window buffers, past the "
            f"{SMEM_OPTIN} B a block may use; pin a smaller tile",
            combo="tiles")
    return Geometry(tr, tc, HALO)


#: bytes of one unit of a TMA row stride (and of its base's alignment)
TMA_UNIT = 16


def tma_ok(shape: Tuple[int, int], pair: bool = False) -> bool:
    """Whether a float32 state of ``shape`` (R, C) loads the fold entries'
    windows through TMA (``csrc/gs_fold_sm90.cuh``): a tensor map's row
    stride is a multiple of 16 bytes, so C must be a multiple of 4; for
    K2's pair (``pair``: two planes of R x C, one 3-D map), the second
    plane's offset, R*C*4 bytes, must be one too (it is whenever C is,
    whatever R). Other shapes load with cp.async; the wrappers also ask
    that every pointer be 16-byte aligned, which a fresh tensor is."""
    rows, cols = shape
    if rows < 1 or cols < 1:
        return False
    row = 4 * cols
    return row % TMA_UNIT == 0 and (not pair or rows * row % TMA_UNIT == 0)
