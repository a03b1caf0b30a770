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
"""

from __future__ import annotations

import ctypes

import torch

from ..params import KernelConstants
from ..parallel import halo
from . import build, checks, stencil

#: most steps of one time block: the halo depth
MEGA_STEPS = halo.HALO

#: 64-bit counters of one shard (csrc/sharded_mega.cu: COUNTER_WORDS)
COUNTER_WORDS = 2 * len(halo.DIRECTIONS) + 2

#: kernel launches so far (CPU calls run the plain version and add nothing)
launches = 0

_fns = None


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
    destination slot (``halo.push_halos``). An odd block count ends with
    slot 1 copied to slot 0, halos and all (megakernel.py:660-671)."""
    n_r, n_c = u_pairs.shape[:2]
    r_loc, c_loc, ch = halo.interior_extents(u_pairs)
    h = halo.HALO
    for t in range(n_blocks):
        src, dst = t % 2, 1 - t % 2
        for i in range(n_r):
            for j in range(n_c):
                row0, col0 = i * r_loc, j * c_loc
                u, v = u_pairs[i, j, src], v_pairs[i, j, src]
                for _ in range(steps):
                    u, v = stencil.step_at(u, v, consts, boundary,
                                           (row0 - h, col0 - ch), shape)
                rows = max(0, min(r_loc, shape[0] - row0))
                cols = max(0, min(c_loc, shape[1] - col0))
                for pairs, x in ((u_pairs, u), (v_pairs, v)):
                    pairs[i, j, dst, h:h + rows, ch:ch + cols] = \
                        x[h:h + rows, ch:ch + cols]
        halo.push_halos(u_pairs, dst)
        halo.push_halos(v_pairs, dst)
    if n_blocks % 2:
        u_pairs[:, :, 0] = u_pairs[:, :, 1]
        v_pairs[:, :, 0] = v_pairs[:, :, 1]


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
                       + [ctypes.c_float] * 14 + [ctypes.c_int]
                       + [ctypes.c_void_p]))
    return _fns


def max_blocks(device: torch.device) -> int:
    """The most blocks of one launch that are co-resident on ``device``."""
    index = torch.device(device).index
    n = build.bind("gs_sharded_mega_max_blocks", [ctypes.c_int])(
        torch.cuda.current_device() if index is None else index)
    if n <= 0:
        raise RuntimeError(f"sharded mega kernel occupancy query failed: "
                           f"CUDA error {-n} ({build.error_name(-n)})")
    return n


def check_pairs(u_pairs: torch.Tensor, v_pairs: torch.Tensor,
                mesh: halo.Mesh, shape) -> None:
    """The pairs are those of ``shape`` on ``mesh``, in the shard layout."""
    checks.check_state((), (u_pairs, v_pairs), ndim=5)
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
                     grid: int = 0) -> None:
    """Advance every shard's slot 0 by ``n_blocks`` x ``steps`` steps of the
    domain ``shape`` (R, C), in place. ``grid``: the blocks of the launch,
    0 for the co-resident maximum; it must hold one block a shard. On a CUDA
    device the launch is enqueued on the current stream and not waited
    for."""
    global launches
    checks.check_count("n_blocks", n_blocks, 1)
    checks.check_count("steps", steps, 1, MEGA_STEPS)
    checks.check_count("grid", grid, 0)
    checks.check_boundary(boundary)
    check_pairs(u_pairs, v_pairs, mesh, shape)
    if 0 < grid < mesh.n_shards:
        raise ValueError(f"a grid of {grid} blocks cannot hold "
                         f"{mesh.n_shards} shards (one block a shard)")
    if u_pairs.device.type == "cpu":
        sharded_megastep_reference(u_pairs, v_pairs, n_blocks, steps, consts,
                                   boundary, shape)
        return
    desc_bytes, describe, fn = _kernel()
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
    err = fn(desc.data_ptr(), mesh.n_shards, shape[0], shape[1], r_loc,
             c_loc, ch, n_blocks, steps, int(boundary == "naive"),
             device.index, *consts.weights, *consts.reaction, grid, stream)
    if err != 0:
        raise RuntimeError(f"sharded mega kernel launch failed: CUDA error "
                           f"{err} ({build.error_name(err)})")
    launches += 1
