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
group of blocks walks, and the choice is logged once.

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
too).
"""

from __future__ import annotations

import ctypes
import logging

import torch

from ..params import KernelConstants
from ..parallel import halo
from . import build, checks, stencil

#: most steps of one time block: the halo depth
MEGA_STEPS = halo.HALO

#: 64-bit counters of one shard (csrc/sharded_mega.cu: COUNTER_WORDS)
COUNTER_WORDS = 2 * len(halo.DIRECTIONS) + 2

#: the kernel's tile geometries: tile edge -> cells of its window (the tile
#: and MEGA_STEPS cells on every side; csrc/gs_tile_sm90.cuh: Main, Small)
TILES = {64: (64 + 2 * MEGA_STEPS) ** 2, 32: (32 + 2 * MEGA_STEPS) ** 2}

#: kernel launches so far (CPU calls run the plain version and add nothing)
launches = 0
#: the bf16 entry's launches so far (bfloat16 pairs)
bf16_launches = 0
#: the launches that waited at the read site (row meshes)
read_site_launches = 0

_fns = None
_bf16_fns = None
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


def tile_rounds(shape, mesh_shape, tile: int, blocks: int) -> float:
    """Rounds of tiles that each shard's group walks in one time block: a
    shard's ``tile`` x ``tile`` tiles over the smallest group of a launch
    of ``blocks`` blocks (the co-resident maximum, capped at the tile count
    as the kernel caps it), split over the mesh's shards. Infinite when the
    launch cannot hold one block a shard (the kernel refuses it)."""
    n_r, n_c = mesh_shape
    n_shards = n_r * n_c
    r_loc, c_loc = halo.shard_extents(shape, halo.Mesh(n_r, n_c, None))
    tiles = -(-r_loc // tile) * -(-c_loc // tile)
    group = min(blocks, n_shards * tiles) // n_shards
    return -(-tiles // group) if group else float("inf")


def choose_tile(shape, mesh_shape, coresident: dict, sms: int) -> int:
    """The tile edge K7 runs ``shape`` with on a mesh of ``mesh_shape``:
    the fewest window cells that an SM steps in a time block, i.e. rounds
    (:func:`tile_rounds`) x blocks an SM x window cells a tile, from each
    geometry's co-resident blocks on a card of ``sms`` SMs. A tie takes
    the 64x64 tiles."""
    def cost(tile):
        per_sm = coresident[tile] / sms
        return (tile_rounds(shape, mesh_shape, tile, coresident[tile])
                * per_sm * TILES[tile], -tile)
    return min(TILES, key=cost)


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


def max_blocks(device: torch.device, tile: int | None = None) -> int:
    """The most blocks of one launch with ``tile`` x ``tile`` tiles that are
    co-resident on ``device``; with ``tile`` None, the most over both
    geometries."""
    if tile is None:
        return max(max_blocks(device, t) for t in TILES)
    index = torch.device(device).index
    n = build.bind("gs_sharded_mega_max_blocks", [ctypes.c_int] * 2)(
        torch.cuda.current_device() if index is None else index, tile)
    if n <= 0:
        raise RuntimeError(f"sharded mega kernel occupancy query failed: "
                           f"CUDA error {-n} ({build.error_name(-n)})")
    return n


def tile_for(shape, mesh: halo.Mesh) -> int:
    """:func:`choose_tile` on ``mesh``'s card, from the kernel's co-resident
    counts; logged the first time for each domain and mesh."""
    key = (tuple(shape), mesh.shape, mesh.device)
    if key not in _chosen:
        coresident = {t: max_blocks(mesh.device, t) for t in TILES}
        sms = torch.cuda.get_device_properties(
            mesh.device).multi_processor_count
        tile = choose_tile(shape, mesh.shape, coresident, sms)
        _chosen[key] = tile
        _logger.info(
            "sharded mega: %dx%d tiles for %dx%d on a %dx%d mesh (rounds "
            "%s, co-resident blocks %s, %d SMs)", tile, tile, shape[0],
            shape[1], *mesh.shape,
            {t: tile_rounds(shape, mesh.shape, t, coresident[t])
             for t in TILES}, coresident, sms)
    return _chosen[key]


def read_site_applies(shape, mesh_shape, tile: int) -> bool:
    """Whether K7 waits at the read site on a mesh of ``mesh_shape``: a
    row mesh (one column, more than one row of shards) whose shards have
    more than one row of ``tile`` x ``tile`` tiles (JAX: ``n_shard_cols ==
    1`` and more than one window row, ``megakernel.py:428-463``)."""
    n_r, n_c = mesh_shape
    r_loc, _ = halo.shard_extents(shape, halo.Mesh(n_r, n_c, None))
    return n_c == 1 and n_r > 1 and -(-r_loc // tile) > 1


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


def sharded_megastep(u_pairs: torch.Tensor, v_pairs: torch.Tensor,
                     mesh: halo.Mesh, n_blocks: int, steps: int,
                     consts: KernelConstants, boundary: str, shape,
                     grid: int = 0, tile: int | None = None,
                     read_site: bool = True) -> None:
    """Advance every shard's slot 0 by ``n_blocks`` x ``steps`` steps of the
    domain ``shape`` (R, C), in place. ``grid``: the blocks of the launch,
    0 for the co-resident maximum; it must hold one block a shard.
    ``tile``: the tile edge (a key of ``TILES``), None for
    :func:`tile_for`'s choice. ``read_site``: wait at the read site where
    it applies (:func:`read_site_applies`); False gates every time block's
    entry. On a CUDA device the launch is enqueued on the current stream
    and not waited for. The pairs are float32 or bfloat16 (the bf16
    entry)."""
    global launches, bf16_launches, read_site_launches
    checks.check_count("n_blocks", n_blocks, 1)
    checks.check_count("steps", steps, 1, MEGA_STEPS)
    checks.check_count("grid", grid, 0)
    checks.check_boundary(boundary)
    if tile is not None and tile not in TILES:
        raise ValueError(f"tile must be one of {sorted(TILES)} or None, got "
                         f"{tile!r}")
    check_pairs(u_pairs, v_pairs, mesh, shape)
    if 0 < grid < mesh.n_shards:
        raise ValueError(f"a grid of {grid} blocks cannot hold "
                         f"{mesh.n_shards} shards (one block a shard)")
    if u_pairs.device.type == "cpu":
        sharded_megastep_reference(u_pairs, v_pairs, n_blocks, steps, consts,
                                   boundary, shape)
        return
    bf16 = u_pairs.dtype == torch.bfloat16
    desc_bytes, describe, fn = _bf16_kernel() if bf16 else _kernel()
    r_loc, c_loc, ch = halo.interior_extents(u_pairs)
    device = u_pairs.device
    counters = torch.zeros(mesh.n_shards * COUNTER_WORDS, dtype=torch.int64,
                           device=device)
    # the shards' descriptors, written on the host into pinned memory and
    # copied on the launch stream (PyTorch keeps the block until the copy
    # is done)
    host = torch.empty(mesh.n_shards * desc_bytes, dtype=torch.uint8,
                       pin_memory=True)
    err = describe(host.data_ptr(), u_pairs.data_ptr(), v_pairs.data_ptr(),
                   counters.data_ptr(), mesh.n_rows, mesh.n_cols, r_loc,
                   c_loc, ch)
    if err != 0:
        raise RuntimeError(f"sharded mega descriptors: CUDA error {err} "
                           f"({build.error_name(err)})")
    desc = host.to(device, non_blocking=True)
    stream = torch.cuda.current_stream(device).cuda_stream
    if tile is None:
        tile = tile_for(shape, mesh)
    waits = read_site and read_site_applies(shape, mesh.shape, tile)
    err = fn(desc.data_ptr(), mesh.n_shards, shape[0], shape[1], r_loc,
             c_loc, ch, n_blocks, steps, int(boundary == "naive"),
             device.index, *consts.weights, *consts.reaction, grid, tile,
             int(waits), stream)
    if err != 0:
        raise RuntimeError(f"sharded mega kernel launch failed: CUDA error "
                           f"{err} ({build.error_name(err)})")
    if waits:
        read_site_launches += 1
    if bf16:
        bf16_launches += 1
    else:
        launches += 1
