"""K7, the sharded megakernel: the wrapper of ``csrc/sharded_mega.cu``.

The port's ``_mega_kernel`` with ``n_shards > 1`` / ``n_shard_cols > 1``
(``grayscott_tpu/ops/megakernel.py:81``), as ``sharded_mega_run`` and
``sharded_mega_run2d`` drive it (``grayscott_tpu/parallel/halo.py:487``,
``:566``): one call advances every shard of a mesh by ``n_blocks`` time
blocks of ``steps`` (1..MEGA_STEPS) steps. At the end of each time block
each shard pushes its boundary cells into its neighbours' halos; a shard
enters the next block once its neighbours' pushes have arrived. The pairs
are in the layout of ``parallel/halo.py`` (slot 0 current, its halos valid
at the call: ``halo.exchange_halos``) and are updated in place; slot 0's
halos are valid again after the call.

On a CUDA tensor :func:`sharded_megastep` makes one cooperative launch for
all shards on the current stream, or raises. On a CPU tensor it runs the
plain PyTorch version, :func:`sharded_megastep_reference`, since there is
no kernel to launch on the CPU. ``launches`` counts the kernel launches,
and only them.

The pairs may be bfloat16 (the TPU kernel with a bfloat16 dtype): then the
bf16 entry runs, which widens each window to float32, steps it, rounds each
stored cell to bfloat16 once a time block, and pushes the rounded cells.
Its launches are counted in ``bf16_launches``.

The kernel steps 64x64 or 32x32 tiles (``TILES``); :func:`choose_tile`
picks one per domain and mesh from the rounds of tiles that each shard's
group of blocks walks, and the choice is logged once. Under the tile pins
(``--pallas-block-rows``, ``--pallas-block-cols``;
``ops/geometry.py:mega_resolve`` on the shard) ``geometry`` names the
tiles: the compiled 64x64 and 32x32 run the entries above, any other the
pinned entries of ``csrc/sharded_mega_pins.cu`` on the same descriptors,
counted in ``pinned_launches`` and ``pinned_bf16_launches``. The tiles
change how each shard is cut, not what a step computes: the plain version
is the same.

On a row mesh with more than one tile row a shard waits for its
neighbours' pushes where it reads them (JAX's 1-D read-site waits,
``grayscott_tpu/ops/megakernel.py:428-463``): the push from above before
its first tile, the push from below only before the first tile whose
window reaches its bottom halo rows (:func:`read_site_applies`). 2-D
meshes gate the entry to each time block on every direction (``:419-427``).
``read_site=False`` runs the entry gate on a row mesh too, the form the
read-site wait is timed against; the results are the same bit for bit.
``read_site_launches`` counts the launches that waited at the read site
(of either storage; they are counted in ``launches`` or ``bf16_launches``
too). Where 64-row tiles leave a shard's last tile row short, the
read-site entry also takes tiles fitted to the shard (:func:`fitted_tile`:
68x64 on 1080x1920's 272- and 544-row shards, 2 rounds of tiles where
64x64 take 3; ``csrc/sharded_mega_fit.cu``) when :func:`choose_tile` finds
them cheaper. :func:`read_site_plan` and :func:`read_site_walk` are the
CPU twin of that walk, and :func:`read_site_ablation` runs the parts of the
split that chose it (``READ_SITE_ABLATIONS``,
``csrc/splits/sharded_mega_ablation.cu``; card only, not counted).
"""

from __future__ import annotations

import ctypes
import logging
from typing import List, NamedTuple, Optional, Tuple

import torch

from ..params import KernelConstants
from ..parallel import halo
from . import build, checks, stencil
from .geometry import Geometry, tile_shape

#: most steps of one time block: the halo depth
MEGA_STEPS = halo.HALO

#: 64-bit counters of one shard (csrc/sharded_mega.cu: COUNTER_WORDS)
COUNTER_WORDS = 2 * len(halo.DIRECTIONS) + 2

#: the kernel's tile geometries: tile edge -> cells of its window (the tile
#: and MEGA_STEPS cells on every side; csrc/gs_tile_sm90.cuh: Main, Small)
TILES = {64: (64 + 2 * MEGA_STEPS) ** 2, 32: (32 + 2 * MEGA_STEPS) ** 2}

#: the read-site entry's fitted tiles: 64 columns, and the height compiled
#: in (csrc/sharded_mega.cuh: Fit68) that fills a shard's last tile row
#: (:func:`fitted_height`)
FIT_COLS = 64
FIT_HEIGHTS = (68,)
#: the tallest fitted tile whose window pair leaves two blocks an SM (the
#: split's part 3, a run-time height)
FIT_MAX = 72

#: the read-site entry's split (csrc/splits/sharded_mega_ablation.cu): part ->
#: what it runs (float32, the default stencils' tap set, a row mesh)
READ_SITE_ABLATIONS = {
    0: "the first form: 64x64 tiles, register strips",
    1: "window loads and tile stores alone, no step, no exchange",
    2: "the exchange alone: waits, group barrier, pushes, arrivals",
    3: "tile rows fitted to the shard, run-time height",
    4: "the fitted height compiled in",
    5: "4x4 register blocks, LDS.128, on interior tiles",
    6: "4 with 5",
}
#: the parts that step nothing (their result is their input)
READ_SITE_NO_STEP = (1, 2)
#: the parts on the fitted tiles (part 3 at a run-time height)
READ_SITE_FITTED = (3, 4, 6)

#: kernel launches so far (CPU calls run the plain version and add nothing)
launches = 0
#: the bf16 entry's launches so far (bfloat16 pairs)
bf16_launches = 0
#: the launches that waited at the read site (row meshes)
read_site_launches = 0
#: the pinned entries' launches (a tile geometry other than the compiled
#: ones), by storage
pinned_launches = 0
pinned_bf16_launches = 0

_fns = None
_bf16_fns = None
_pinned_fns: dict = {}
_logger = logging.getLogger("grayscott_tpu_torch")
#: (shape, mesh shape, device) -> the tile the wrapper picked
_chosen: dict = {}


def launch_plan(steps: int) -> list:
    """The launches, ``(n_blocks, steps)`` each, that advance ``steps``
    steps: ``steps // MEGA_STEPS`` full time blocks in one launch, then the
    remainder in another (``grayscott_tpu/backends/sharded.py:466-507``)."""
    n_full, rem = divmod(steps, MEGA_STEPS)
    return (([(n_full, MEGA_STEPS)] if n_full else [])
            + ([(1, rem)] if rem else []))


def sharded_megastep_reference(u_pairs: torch.Tensor, v_pairs: torch.Tensor,
                               n_blocks: int, steps: int,
                               consts: KernelConstants, boundary: str,
                               shape) -> None:
    """The plain version, in place. Per time block ``t`` (slot ``t % 2`` to
    slot ``1 - t % 2``): each shard's padded block of the source slot takes
    ``steps`` plain steps at its global origin against the domain ``shape``
    (``stencil.step_at``), and its interior cells inside the domain go to
    the destination slot; then every shard pushes into its neighbours'
    destination slot (``halo.push_halos``). On bfloat16 pairs each block is
    widened to float32 before its steps, and its cells are rounded to
    bfloat16 as they are stored, before the pushes. An odd block count
    ends with slot 1 copied to slot 0, halos and all
    (megakernel.py:660-671)."""
    n_r, n_c = u_pairs.shape[:2]
    r_loc, c_loc, ch = halo.interior_extents(u_pairs)
    h = halo.HALO
    for t in range(n_blocks):
        src, dst = t % 2, 1 - t % 2
        for i in range(n_r):
            for j in range(n_c):
                row0, col0 = i * r_loc, j * c_loc
                u, v = u_pairs[i, j, src].float(), v_pairs[i, j, src].float()
                for _ in range(steps):
                    u, v = stencil.step_at(u, v, consts, boundary,
                                           (row0 - h, col0 - ch), shape)
                rows = max(0, min(r_loc, shape[0] - row0))
                cols = max(0, min(c_loc, shape[1] - col0))
                for pairs, x in ((u_pairs, u), (v_pairs, v)):
                    pairs[i, j, dst, h:h + rows, ch:ch + cols] = \
                        x[h:h + rows, ch:ch + cols].to(pairs.dtype)
        halo.push_halos(u_pairs, dst)
        halo.push_halos(v_pairs, dst)
    if n_blocks % 2:
        u_pairs[:, :, 0] = u_pairs[:, :, 1]
        v_pairs[:, :, 0] = v_pairs[:, :, 1]


def tile_rounds(shape, mesh_shape, tile, blocks: int) -> float:
    """Rounds of tiles that each shard's group walks in one time block: a
    shard's tiles (``tile``: one edge, or ``(tr, tc)``) over the smallest
    group of a launch of ``blocks`` blocks (the co-resident maximum,
    capped at the tile count as the kernel caps it), split over the mesh's
    shards. Infinite when the launch cannot hold one block a shard (the
    kernel refuses it)."""
    n_r, n_c = mesh_shape
    n_shards = n_r * n_c
    r_loc, c_loc = halo.shard_extents(shape, halo.Mesh(n_r, n_c, None))
    tr, tc = tile_shape(tile)
    tiles = -(-r_loc // tr) * -(-c_loc // tc)
    group = min(blocks, n_shards * tiles) // n_shards
    return -(-tiles // group) if group else float("inf")


def fitted_height(r_loc: int) -> int:
    """The height of the read-site entry's tiles on a shard of ``r_loc``
    rows: ``r_loc // 64`` tile rows, each the least multiple of 4 that
    covers the shard in them, where that is a height the entry compiles
    (:data:`FIT_HEIGHTS`; 272 and 544 rows: 68, in 4 and 8 tile rows where
    64 takes 5 and 9); else 64 (1024 rows: 64 rows divide the shard
    already)."""
    n = r_loc // 64
    if n == 0:
        return 64
    h = -(-(-(-r_loc // n)) // 4) * 4
    return h if h in FIT_HEIGHTS else 64


def fitted_tile(shape, mesh_shape):
    """The fitted tile ``(height, FIT_COLS)`` of K7's read-site entry on
    ``shape`` over a mesh of ``mesh_shape``, or None: where the read-site
    wait applies on 64x64 tiles and :func:`fitted_height` is one of
    :data:`FIT_HEIGHTS`."""
    n_r, n_c = mesh_shape
    r_loc, _ = halo.shard_extents(shape, halo.Mesh(n_r, n_c, None))
    h = fitted_height(r_loc)
    if h == 64 or not read_site_applies(shape, mesh_shape, 64):
        return None
    return (h, FIT_COLS)


def window_cells(tile) -> int:
    """Cells of one window of ``tile`` (an edge, or ``(tr, tc)``): the tile
    and MEGA_STEPS cells on every side."""
    tr, tc = tile_shape(tile)
    return (tr + 2 * MEGA_STEPS) * (tc + 2 * MEGA_STEPS)


def choose_tile(shape, mesh_shape, coresident: dict, sms: int):
    """The tiles K7 runs ``shape`` with on a mesh of ``mesh_shape``: the
    fewest window cells that an SM steps in a time block, i.e. rounds
    (:func:`tile_rounds`) x blocks an SM x window cells a tile, from each
    geometry's co-resident blocks on a card of ``sms`` SMs. The candidates
    are the tile edges of :data:`TILES`, and the read-site entry's fitted
    tile (:func:`fitted_tile`, a ``(tr, tc)`` pair) where ``coresident``
    has it. A tie takes the 64x64 tiles, then the fitted ones."""
    candidates = list(TILES)
    fit = fitted_tile(shape, mesh_shape)
    if fit is not None and fit in coresident:
        candidates.append(fit)

    def cost(tile):
        per_sm = coresident[tile] / sms
        return (tile_rounds(shape, mesh_shape, tile, coresident[tile])
                * per_sm * window_cells(tile), -tile_shape(tile)[1],
                tile_shape(tile)[0])
    return min(candidates, key=cost)


def _kernel():
    global _fns
    if _fns is None:
        max_steps = build.bind("gs_sharded_mega_max_steps", [])()
        words = build.bind("gs_sharded_mega_counter_words", [])()
        if (max_steps, words) != (MEGA_STEPS, COUNTER_WORDS):
            raise RuntimeError(
                f"sharded mega kernel takes {max_steps} steps a time block "
                f"and {words} counters a shard; this wrapper expects "
                f"{MEGA_STEPS} and {COUNTER_WORDS}")
        _fns = (
            build.bind("gs_sharded_mega_desc_bytes", [])(),
            build.bind("gs_sharded_mega_describe",
                       [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5),
            build.bind("gs_sharded_mega_multistep",
                       [ctypes.c_void_p] + [ctypes.c_int] * 10
                       + [ctypes.c_float] * 14 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p]))
    return _fns


def _bf16_kernel():
    """:func:`_kernel`'s three for bfloat16 pairs."""
    global _bf16_fns
    if _bf16_fns is None:
        desc_bytes, describe, fn = _kernel()
        _bf16_fns = (
            desc_bytes,
            build.bind("gs_sharded_mega_describe_bf16",
                       describe.argtypes),
            build.bind("gs_sharded_mega_multistep_bf16", fn.argtypes))
    return _bf16_fns


def _pinned_kernel(dtype):
    """The pinned entry for ``dtype`` pairs: the compiled entry's
    arguments with ``tr`` and ``tc`` in place of the tile edge."""
    if dtype not in _pinned_fns:
        _kernel()  # checks the time block and the counters
        name = "gs_sharded_mega_pinned_multistep" + (
            "_bf16" if dtype == torch.bfloat16 else "")
        _pinned_fns[dtype] = build.bind(
            name, [ctypes.c_void_p] + [ctypes.c_int] * 10
            + [ctypes.c_float] * 14 + [ctypes.c_int] * 4
            + [ctypes.c_void_p])
    return _pinned_fns[dtype]


def pinned_max_blocks(device: torch.device, geometry) -> int:
    """The most blocks of one pinned launch on ``geometry``'s tiles that
    are co-resident on ``device`` (the occupancy API's count at its bytes
    and registers, the fewest over the instantiations)."""
    index = torch.device(device).index
    n = build.bind("gs_sharded_mega_pinned_max_blocks", [ctypes.c_int] * 3)(
        torch.cuda.current_device() if index is None else index,
        geometry.tr, geometry.tc)
    if n <= 0:
        raise RuntimeError(f"sharded mega pinned occupancy query on "
                           f"{geometry.label()}: CUDA error {-n} "
                           f"({build.error_name(-n)})")
    return n


def max_blocks(device: torch.device, tile=None) -> int:
    """The most blocks of one launch with ``tile`` x ``tile`` tiles (or a
    fitted ``(tr, FIT_COLS)``) that are co-resident on ``device``; with
    ``tile`` None, the most over both square geometries."""
    if tile is None:
        return max(max_blocks(device, t) for t in TILES)
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if tile in TILES:
        n = build.bind("gs_sharded_mega_max_blocks", [ctypes.c_int] * 2)(
            index, tile)
    else:  # the fitted tiles (csrc/sharded_mega_fit.cu)
        n = build.bind("gs_sharded_mega_fit_max_blocks", [ctypes.c_int])(
            index)
    if n <= 0:
        raise RuntimeError(f"sharded mega kernel occupancy query failed: "
                           f"CUDA error {-n} ({build.error_name(-n)})")
    return n


def tile_for(shape, mesh: halo.Mesh, read_site: bool = True):
    """:func:`choose_tile` on ``mesh``'s card, from the kernel's co-resident
    counts: a tile edge, or the fitted ``(tr, tc)`` of the read-site entry
    (only with ``read_site``); logged the first time for each domain, mesh
    and wait."""
    key = (tuple(shape), mesh.shape, mesh.device, read_site)
    if key not in _chosen:
        coresident = {t: max_blocks(mesh.device, t) for t in TILES}
        fit = fitted_tile(shape, mesh.shape) if read_site else None
        if fit is not None:
            coresident[fit] = max_blocks(mesh.device, fit)
        sms = torch.cuda.get_device_properties(
            mesh.device).multi_processor_count
        tile = choose_tile(shape, mesh.shape, coresident, sms)
        _chosen[key] = tile
        _logger.info(
            "sharded mega: %dx%d tiles for %dx%d on a %dx%d mesh (rounds "
            "%s, co-resident blocks %s, %d SMs)", *tile_shape(tile),
            shape[0], shape[1], *mesh.shape,
            {t: tile_rounds(shape, mesh.shape, t, coresident[t])
             for t in coresident}, coresident, sms)
    return _chosen[key]


def read_site_applies(shape, mesh_shape, tile) -> bool:
    """Whether K7 waits at the read site on a mesh of ``mesh_shape``: a
    row mesh (one column, more than one row of shards) whose shards have
    more than one row of tiles (``tile``: an edge, or ``(tr, tc)``) (JAX:
    ``n_shard_cols == 1`` and more than one window row,
    ``megakernel.py:428-463``)."""
    n_r, n_c = mesh_shape
    r_loc, _ = halo.shard_extents(shape, halo.Mesh(n_r, n_c, None))
    return n_c == 1 and n_r > 1 and -(-r_loc // tile_shape(tile)[0]) > 1


class ReadSitePlan(NamedTuple):
    """How the read-site entry walks one shard in a time block
    (``csrc/sharded_mega.cuh``: ``sharded_mega_run``, ``BottomGate``): its
    ``tile`` (tr, tc), ``tiles_x`` tiles a row and ``n_tiles`` in all
    (row-major), ``split`` the first tile whose window reaches the bottom
    halo rows (a tile row start times ``tiles_x``), and for each block of
    its group (by rank) the tiles it steps in order and the tile before
    whose window load it waits for the push from below (None: it loads no
    such tile)."""

    tile: Tuple[int, int]
    tiles_x: int
    n_tiles: int
    split: int
    blocks: List[List[int]]
    gates: List[Optional[int]]


def read_site_plan(shape, mesh_shape, tile, grid: int) -> List[ReadSitePlan]:
    """The read-site entry's walk of every shard of a launch of ``grid``
    blocks (the kernel caps it at the tiles) on ``tile``: the CPU twin of
    the kernel's group split (the first ``grid % shards`` groups one block
    larger), its tile walk (block ``rank`` steps tiles ``rank``, ``rank +
    size``, ...) and its gate (the first of a block's tiles at or past
    ``split``: ``split <= i < split + size``)."""
    n_r, n_c = mesh_shape
    n_shards = n_r * n_c
    r_loc, c_loc = halo.shard_extents(shape, halo.Mesh(n_r, n_c, None))
    tr, tc = tile_shape(tile)
    tiles_x = -(-c_loc // tc)
    n_tiles = tiles_x * -(-r_loc // tr)
    grid = min(grid, n_shards * n_tiles)
    per, extra = divmod(grid, n_shards)
    split = (r_loc - MEGA_STEPS) // tr * tiles_x
    plans = []
    for g in range(n_shards):
        size = per + (g < extra)
        blocks = [list(range(rank, n_tiles, size)) for rank in range(size)]
        gates = [next((i for i in walk if split <= i < split + size), None)
                 for walk in blocks]
        plans.append(ReadSitePlan((tr, tc), tiles_x, n_tiles, split, blocks,
                                  gates))
    return plans


def read_site_walk(u_pairs: torch.Tensor, v_pairs: torch.Tensor,
                   n_blocks: int, steps: int, consts: KernelConstants,
                   boundary: str, shape, tile, grid: int) -> None:
    """The read-site entry's walk replayed on the CPU, in place: per time
    block, each shard's blocks step their tiles of :func:`read_site_plan`
    one by one, each tile's window (MEGA_STEPS cells around it, the cells
    its pair does not hold or that lie outside the domain as 0.0) taking
    ``steps`` plain steps at its global place (``stencil.step_at``) and
    its tile's cells that the shard stores going to the other slot; then
    every shard's pushes (``halo.push_halos``). Equal to
    :func:`sharded_megastep_reference` bit for bit."""
    n_r, n_c = u_pairs.shape[:2]
    r_loc, c_loc, ch = halo.interior_extents(u_pairs)
    h = MEGA_STEPS
    plans = read_site_plan(shape, (n_r, n_c), tile, grid)
    tr, tc = plans[0].tile
    for t in range(n_blocks):
        src, dst = t % 2, 1 - t % 2
        for g, plan in enumerate(plans):
            i, j = divmod(g, n_c)
            row0, col0 = i * r_loc, j * c_loc
            for walk in plan.blocks:
                for n in walk:
                    ti, tj = divmod(n, plan.tiles_x)
                    # the window in the pair's coordinates, then padded
                    # with 0.0 where the pair holds no cell
                    a0, b0 = ti * tr, tj * tc + ch - h
                    rows = (max(a0, 0), min(a0 + tr + 2 * h, r_loc + 2 * h))
                    cols = (max(b0, 0), min(b0 + tc + 2 * h,
                                            c_loc + 2 * ch))
                    pad = (cols[0] - b0, b0 + tc + 2 * h - cols[1],
                           rows[0] - a0, a0 + tr + 2 * h - rows[1])
                    u, v = (torch.nn.functional.pad(
                        p[i, j, src, rows[0]:rows[1], cols[0]:cols[1]]
                        .float(), pad) for p in (u_pairs, v_pairs))
                    origin = (row0 + ti * tr - h, col0 + tj * tc - h)
                    for _ in range(steps):
                        u, v = stencil.step_at(u, v, consts, boundary,
                                               origin, shape)
                    n_rows = max(0, min(tr, r_loc - ti * tr,
                                        shape[0] - row0 - ti * tr))
                    n_cols = max(0, min(tc, c_loc - tj * tc,
                                        shape[1] - col0 - tj * tc))
                    for p, x in ((u_pairs, u), (v_pairs, v)):
                        p[i, j, dst, h + ti * tr:h + ti * tr + n_rows,
                          ch + tj * tc:ch + tj * tc + n_cols] = \
                            x[h:h + n_rows, h:h + n_cols].to(p.dtype)
        halo.push_halos(u_pairs, dst)
        halo.push_halos(v_pairs, dst)
    if n_blocks % 2:
        u_pairs[:, :, 0] = u_pairs[:, :, 1]
        v_pairs[:, :, 0] = v_pairs[:, :, 1]


def check_pairs(u_pairs: torch.Tensor, v_pairs: torch.Tensor,
                mesh: halo.Mesh, shape) -> None:
    """The pairs are those of ``shape`` on ``mesh``, in the shard layout,
    both float32 or both bfloat16."""
    checks.check_state((), (u_pairs, v_pairs), ndim=5,
                       dtypes=checks.STORAGE_DTYPES)
    want = halo.pair_shape(shape, mesh)
    if tuple(u_pairs.shape) != want:
        raise ValueError(f"pairs of a {shape[0]}x{shape[1]} domain on a "
                         f"{mesh.n_rows}x{mesh.n_cols} mesh must be {want}, "
                         f"got {tuple(u_pairs.shape)}")
    if u_pairs.device.type != mesh.device.type or (
            mesh.device.index is not None and u_pairs.device != mesh.device):
        raise ValueError(f"the pairs lie on {u_pairs.device}, the mesh on "
                         f"{mesh.device}")


def _describe(u_pairs: torch.Tensor, v_pairs: torch.Tensor,
              mesh: halo.Mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """(descriptors, counters): the shards' descriptors on the pairs' card,
    written on the host into pinned memory and copied on the current
    stream (PyTorch keeps the block until the copy is done), and the zeroed
    counters they point at, which the caller holds until its launch is
    enqueued."""
    bf16 = u_pairs.dtype == torch.bfloat16
    desc_bytes, describe, _ = _bf16_kernel() if bf16 else _kernel()
    r_loc, c_loc, ch = halo.interior_extents(u_pairs)
    counters = torch.zeros(mesh.n_shards * COUNTER_WORDS, dtype=torch.int64,
                           device=u_pairs.device)
    host = torch.empty(mesh.n_shards * desc_bytes, dtype=torch.uint8,
                       pin_memory=True)
    err = describe(host.data_ptr(), u_pairs.data_ptr(), v_pairs.data_ptr(),
                   counters.data_ptr(), mesh.n_rows, mesh.n_cols, r_loc,
                   c_loc, ch)
    if err != 0:
        raise RuntimeError(f"sharded mega descriptors: CUDA error {err} "
                           f"({build.error_name(err)})")
    return host.to(u_pairs.device, non_blocking=True), counters


def sharded_megastep(u_pairs: torch.Tensor, v_pairs: torch.Tensor,
                     mesh: halo.Mesh, n_blocks: int, steps: int,
                     consts: KernelConstants, boundary: str, shape,
                     grid: int = 0, geometry: Geometry | None = None,
                     read_site: bool = True) -> None:
    """Advance every shard's slot 0 by ``n_blocks`` x ``steps`` steps of the
    domain ``shape`` (R, C), in place. ``grid``: the blocks of the launch,
    0 for the co-resident maximum; it must hold one block a shard.
    ``geometry``: the tiles, None for :func:`tile_for`'s choice; 64x64,
    32x32 and, where the read-site wait applies, the fitted tiles
    (``FIT_HEIGHTS`` x ``FIT_COLS``) run the compiled entries, any other
    (the tile pins, ``geometry.mega_resolve`` of a shard) the pinned ones;
    its halo is MEGA_STEPS. ``read_site``: wait at the read site where it
    applies (:func:`read_site_applies`); False gates every time block's
    entry (and leaves the fitted tiles out of the choice). On a CUDA device
    the launch is enqueued on the current stream and not waited for. The
    pairs are float32 or bfloat16 (the bf16 entry)."""
    global launches, bf16_launches, read_site_launches
    global pinned_launches, pinned_bf16_launches
    checks.check_count("n_blocks", n_blocks, 1)
    checks.check_count("steps", steps, 1, MEGA_STEPS)
    checks.check_count("grid", grid, 0)
    checks.check_boundary(boundary)
    if geometry is not None and geometry.halo != MEGA_STEPS:
        raise ValueError(f"K7's halo is its time block, {MEGA_STEPS}; got "
                         f"{geometry.label()}")
    check_pairs(u_pairs, v_pairs, mesh, shape)
    if 0 < grid < mesh.n_shards:
        raise ValueError(f"a grid of {grid} blocks cannot hold "
                         f"{mesh.n_shards} shards (one block a shard)")
    if u_pairs.device.type == "cpu":
        sharded_megastep_reference(u_pairs, v_pairs, n_blocks, steps, consts,
                                   boundary, shape)
        return
    bf16 = u_pairs.dtype == torch.bfloat16
    _, _, fn = _bf16_kernel() if bf16 else _kernel()
    r_loc, c_loc, ch = halo.interior_extents(u_pairs)
    device = u_pairs.device
    desc, _counters = _describe(u_pairs, v_pairs, mesh)
    stream = torch.cuda.current_stream(device).cuda_stream
    if geometry is None:
        geometry = Geometry(*tile_shape(tile_for(shape, mesh, read_site)),
                            MEGA_STEPS)
    waits = read_site and read_site_applies(shape, mesh.shape, geometry.tr)
    fitted = (waits and geometry.tc == FIT_COLS
              and geometry.tr in FIT_HEIGHTS)
    pinned = not (fitted or (geometry.tr == geometry.tc
                             and geometry.tr in TILES))
    if pinned:
        fn = _pinned_kernel(u_pairs.dtype)
        tail = (geometry.tr, geometry.tc)
    else:
        if fitted:
            fn = build.bind("gs_sharded_mega_fit_multistep"
                            + ("_bf16" if bf16 else ""), fn.argtypes)
        tail = (geometry.tr,)
    err = fn(desc.data_ptr(), mesh.n_shards, shape[0], shape[1], r_loc,
             c_loc, ch, n_blocks, steps, int(boundary == "naive"),
             device.index, *consts.weights, *consts.reaction, grid, *tail,
             int(waits), stream)
    if err != 0:
        raise RuntimeError(f"sharded mega kernel launch failed: CUDA error "
                           f"{err} ({build.error_name(err)})")
    if waits:
        read_site_launches += 1
    if pinned and bf16:
        pinned_bf16_launches += 1
    elif pinned:
        pinned_launches += 1
    elif bf16:
        bf16_launches += 1
    else:
        launches += 1


def read_site_ablation_reference(part: int, u_pairs: torch.Tensor,
                                 v_pairs: torch.Tensor, n_blocks: int,
                                 steps: int, consts: KernelConstants,
                                 boundary: str, shape) -> None:
    """The plain version of :func:`read_site_ablation`'s part, in place:
    the parts that step nothing (:data:`READ_SITE_NO_STEP`) leave their
    input, whose halos the caller exchanged; every other part is
    :func:`sharded_megastep_reference`."""
    if part not in READ_SITE_NO_STEP:
        sharded_megastep_reference(u_pairs, v_pairs, n_blocks, steps, consts,
                                   boundary, shape)


def check_read_site_part(part: int, shape, mesh: halo.Mesh, n_blocks: int,
                         consts: KernelConstants, tr: int | None) -> int:
    """The tile height that ``part`` of :data:`READ_SITE_ABLATIONS` runs
    ``shape`` with on ``mesh`` (``tr`` None: 64, or :func:`fitted_height`
    for the fitted parts; part 3 takes any multiple of 4 from 12 to
    FIT_MAX), after refusing what the split does not take (ValueError): a
    mesh where the read-site wait does not apply, another tap set than the
    default stencils', and an odd block count for the parts that step
    nothing."""
    if part not in READ_SITE_ABLATIONS:
        raise ValueError(f"part must be one of "
                         f"{sorted(READ_SITE_ABLATIONS)}, got {part!r}")
    if not read_site_applies(shape, mesh.shape, 64):
        raise ValueError(f"the read-site split runs a row mesh whose shards "
                         f"have more than one tile row, not "
                         f"{shape[0]}x{shape[1]} on {mesh.n_rows}x"
                         f"{mesh.n_cols}")
    mask = sum(1 << t for t, w in enumerate(consts.weights) if w != 0.0)
    if mask != TAPS_RING:
        raise ValueError("the read-site split runs the default stencils' "
                         "tap set")
    if part in READ_SITE_NO_STEP and n_blocks % 2:
        raise ValueError(f"part {part} takes an even number of time blocks")
    r_loc, _ = halo.shard_extents(shape, mesh)
    if tr is None:
        tr = fitted_height(r_loc) if part in READ_SITE_FITTED else 64
    ok = (tr % 4 == 0 and MEGA_STEPS < tr <= FIT_MAX if part == 3 else
          tr in (64, FIT_HEIGHTS[0]) if part in READ_SITE_FITTED else
          tr == 64)
    if not ok:
        raise ValueError(f"part {part} does not run {tr}-row tiles")
    return tr


#: the default stencils' tap set (csrc/gs_tile_sm90.cuh: TAPS_RING)
TAPS_RING = 0x1EF


def read_site_ablation(part: int, u_pairs: torch.Tensor,
                       v_pairs: torch.Tensor, mesh: halo.Mesh,
                       n_blocks: int, steps: int, consts: KernelConstants,
                       boundary: str, shape, tr: int | None = None) -> int:
    """K7's read-site entry on the card in the form of ``part``
    (:data:`READ_SITE_ABLATIONS`), float32 pairs of a row mesh, in place as
    :func:`sharded_megastep`; ``tr``: the tile height
    (:func:`check_read_site_part`). Returns the launch's grid (blocks). Not
    the main path: nothing is counted. On the CPU it runs the part's plain
    version (:func:`read_site_ablation_reference`) and returns 0."""
    checks.check_count("n_blocks", n_blocks, 1)
    checks.check_count("steps", steps, 1, MEGA_STEPS)
    checks.check_boundary(boundary)
    check_pairs(u_pairs, v_pairs, mesh, shape)
    tr = check_read_site_part(part, shape, mesh, n_blocks, consts, tr)
    if u_pairs.dtype != torch.float32:
        raise ValueError("the read-site split runs float32 pairs")
    if u_pairs.device.type == "cpu":
        read_site_ablation_reference(part, u_pairs, v_pairs, n_blocks, steps,
                                     consts, boundary, shape)
        return 0
    fn = build.bind("gs_sharded_mega_ablation",
                    [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 10
                    + [ctypes.c_float] * 14 + [ctypes.c_int, ctypes.c_void_p,
                                               ctypes.c_void_p], build.SPLITS)
    r_loc, c_loc, ch = halo.interior_extents(u_pairs)
    desc, _counters = _describe(u_pairs, v_pairs, mesh)
    grid = ctypes.c_int(0)
    err = fn(part, desc.data_ptr(), mesh.n_shards, shape[0], shape[1], r_loc,
             c_loc, ch, n_blocks, steps, int(boundary == "naive"),
             u_pairs.device.index, *consts.weights, *consts.reaction, tr,
             ctypes.byref(grid),
             torch.cuda.current_stream(u_pairs.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sharded mega ablation part {part} ({tr}-row "
                           f"tiles): CUDA error {err} "
                           f"({build.error_name(err)})")
    return grid.value
