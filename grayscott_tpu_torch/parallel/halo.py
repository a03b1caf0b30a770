"""The sharded domain: the mesh of shards, their layout, and the halo
exchange. The port's copy of what the sharded megakernel path uses from
``grayscott_tpu/parallel/halo.py``.

The domain (R, C) is cut into an ``n_rows x n_cols`` mesh of shards, each
``r_loc x c_loc`` cells (:func:`shard_extents`; the last shards reach past
the domain, and their cells there stay 0.0). Each shard holds its state as
a pair per species, in one tensor for all shards::

    (n_rows, n_cols, 2, HALO + r_loc + HALO, chalo + c_loc + chalo)

Slot 0 of a pair is the current state and slot 1 the scratch of the
sharded megakernel K7 (``ops/sharded_mega.py``); the windowed engine's K1
(``ops/windowed.py:shard_multistep``) steps slot ``s`` into slot ``1 - s``
and carries which slot is current. Around the interior lie ``HALO`` rows of
the row neighbours' cells and, on 2-D meshes, ``chalo = COL_HALO`` columns
of the column neighbours' cells (corners from the diagonal neighbours); on
1-D meshes ``chalo`` is 0. The windowed engine at a K pin lays its shards
out with a deeper halo, ``halo_for_steps(K)`` rows, and as many columns on
a 2-D mesh (``grayscott_tpu/backends/sharded.py:137-139``, ``:243-252``):
the mesh carries it (``Mesh.halo``), and every function of the layout
takes it; K7's is always ``HALO``. A shard thinner than its halo along a
split axis cannot fill its neighbour's halo from its own interior
(:func:`thin_shard`). The TPU layout's 128-lane column ring is not
needed: only ``HALO`` of its columns are ever pushed
(``grayscott_tpu/ops/megakernel.py:301-309``).

In one process every shard of a mesh lives on one ``torch.device``: more
shards than cards share the card, as the JAX suite's virtual devices share
the CPU. The kernel is one launch for all of them.

With several processes (``utils/distributed.py``) the mesh stays global,
``n_rows x n_cols`` shards of the whole domain, and process ``p`` owns the
contiguous row-major run ``[p*L, (p+1)*L)`` of its ``L = N/P`` shards,
JAX's plain device order (``grayscott_tpu/parallel/halo.py:70``): whole
mesh rows, or an equal part of one mesh row, so that its shards form a
rectangular block (``Mesh.local_shape`` at ``Mesh.origin``) and the blocks
form a grid of processes (``Mesh.process_grid``); any other split raises.
A process allocates the pairs of its own block only,
``(local_rows, local_cols, 2, ...)``. Every layout function takes the
global mesh: the halo columns follow its columns, the kernels' global
origins its offsets. :func:`exchange` keeps :func:`exchange_halos`'s
order; the bands that cross processes go device -> pinned host -> gloo
-> device, one message a peer and a phase, both species together.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
from typing import Sequence, Tuple

import numpy as np
import torch

from ..errors import UnsupportedConfigError
from ..utils import distributed

#: halo rows around a shard: the megakernel's time-block depth
HALO = 8
#: halo columns around a shard on a 2-D mesh
COL_HALO = 8
#: shard extents are multiples of this, so a push band (HALO rows,
#: COL_HALO columns) lies inside every interior
QUANTUM = 8

#: the tile edge of K1 on the shard layout (``ops/windowed.py:TILE``,
#: ``csrc/gs_tile_sm90.cuh: Main``), which decides the overlap split
WINDOWED_TILE = 64

#: the eight push directions, (row, column) offsets of the receiver, in the
#: order of grayscott_tpu/ops/megakernel.py:324-353 (and of the kernel's)
DIRECTIONS = ((1, 0), (-1, 0), (0, 1), (0, -1),
              (1, 1), (1, -1), (-1, 1), (-1, -1))

_logger = logging.getLogger("grayscott_tpu_torch")
_shared_logged = False


def split(n_rows: int, n_cols: int, processes: int
          ) -> Tuple[int, int] | None:
    """The (rows, cols) block of shards each of ``processes`` owns on an
    ``n_rows x n_cols`` mesh, in row-major runs of ``N/P`` shards: whole
    mesh rows, or an equal part of one; None where no such block exists."""
    n = n_rows * n_cols
    if n % processes:
        return None
    per = n // processes
    if per % n_cols == 0:
        return per // n_cols, n_cols
    if n_cols % per == 0:
        return 1, per
    return None


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``n_rows x n_cols`` shards on ``device``, whose pairs hold ``halo``
    rows of each row neighbour's cells (and as many columns of each column
    neighbour's on a 2-D mesh). With ``processes`` > 1 this process
    (``process``) holds the block of :attr:`local_shape` shards at
    :attr:`origin` (:func:`split`); else every shard."""

    n_rows: int
    n_cols: int
    device: torch.device
    halo: int = HALO
    processes: int = 1
    process: int = 0

    def __post_init__(self):
        if split(self.n_rows, self.n_cols, self.processes) is None:
            raise UnsupportedConfigError(
                f"{self.n_shards} shards (a {self.n_rows}x{self.n_cols} "
                f"mesh) do not split over {self.processes} processes: each "
                "takes N/P shards in row-major order, which must be whole "
                "mesh rows or an equal part of one; pick --sharded-devices "
                "and --sharded-mesh-cols to suit", combo="distributed+mesh")

    # cached: K1's shard wrapper reads them at every launch, on a path the
    # host paces
    @functools.cached_property
    def local_shape(self) -> Tuple[int, int]:
        """(rows, cols) of the shards this process holds."""
        return split(self.n_rows, self.n_cols, self.processes)

    @functools.cached_property
    def process_grid(self) -> Tuple[int, int]:
        """(rows, cols) of the processes' blocks across the mesh."""
        lr, lc = self.local_shape
        return self.n_rows // lr, self.n_cols // lc

    @functools.cached_property
    def origin(self) -> Tuple[int, int]:
        """(mesh row, mesh column) of this process's first shard."""
        lr, lc = self.local_shape
        pi, pj = divmod(self.process, self.process_grid[1])
        return pi * lr, pj * lc

    def blocks(self, shape) -> "distributed.Blocks | None":
        """How the processes' blocks of interiors (:func:`
        mega_unshard_result` without a crop) tile a domain of ``shape``;
        None with one process."""
        if self.processes == 1:
            return None
        return distributed.Blocks(self.process_grid, tuple(shape))

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n_rows, self.n_cols)

    @property
    def n_shards(self) -> int:
        return self.n_rows * self.n_cols

    @property
    def chalo(self) -> int:
        return col_halo(self.n_cols, self.halo)

    def with_halo(self, halo: int) -> "Mesh":
        """The same shards with pairs of ``halo`` rows (and columns)."""
        return dataclasses.replace(self, halo=halo)


def col_halo(n_cols: int, halo: int = COL_HALO) -> int:
    """Halo columns of a shard: ``halo`` (COL_HALO unless a K pin deepens
    it) on 2-D meshes, else 0."""
    return halo if n_cols > 1 else 0


def visible_cards(device: torch.device) -> int:
    """The cards a mesh on ``device`` could spread over (1 on the CPU)."""
    return torch.cuda.device_count() if device.type == "cuda" else 1


def default_shards(device: torch.device) -> int:
    """The shards of a mesh with none asked for: one per visible card in
    each process."""
    return visible_cards(device) * distributed.process_count()


def make_mesh(n_devices: int | None = None, n_cols: int = 1,
              device: str | torch.device = "cuda") -> Mesh:
    """A mesh of ``n_devices`` shards in ``n_cols`` columns (a 1-D row mesh
    by default) on ``device``, across every process of the run
    (``utils/distributed.py``). ``None``: :func:`default_shards`."""
    device = torch.device(device)
    n = default_shards(device) if n_devices is None else n_devices
    if n < 1 or n_cols < 1:
        raise ValueError(f"a mesh needs >= 1 shard and >= 1 column, got "
                         f"{n} shards in {n_cols} columns")
    if n % n_cols:
        raise ValueError(f"{n} devices not divisible by {n_cols} mesh "
                         "columns")
    procs = distributed.process_count()
    mesh = Mesh(n // n_cols, n_cols, device, processes=procs,
                process=distributed.process_index())
    global _shared_logged
    if n > procs and not _shared_logged:
        _shared_logged = True
        _logger.info("this process's %d shard(s) of the %dx%d sharded mesh "
                     "share %s (%d card(s) visible): one launch runs them "
                     "all", n // procs, mesh.n_rows, mesh.n_cols, device,
                     visible_cards(device))
    return mesh


def viable_mesh_cols(shape, n: int, min_rows: int = 8,
                     min_cols: int = 128) -> list[int]:
    """Every divisor of ``n`` whose (rows, cols) factorization keeps shards
    at least ``min_rows`` tall and ``min_cols`` wide on ``shape``, where the
    axis is split (possibly empty). The one copy of the viability rule
    (``grayscott_tpu/parallel/halo.py:74``); :func:`choose_mesh_cols`
    reads it."""
    r, c = shape
    out = []
    for nc in range(1, n + 1):
        if n % nc:
            continue
        nr = n // nc
        if nc > 1 and -(-c // nc) < min_cols:
            continue
        if nr > 1 and -(-r // nr) < min_rows:
            continue
        out.append(nc)
    return out


def choose_mesh_cols(n: int, shape, min_rows: int = 8,
                     min_cols: int = 128, bias: float = 0.8) -> int:
    """Mesh columns for ``n`` shards on an (R, C) domain, by per-shard halo
    exchange volume (``grayscott_tpu/parallel/halo.py:112``): each
    factorization costs ``row_neighbours * ceil(C/nc) + col_neighbours *
    ceil(R/nr)``. A viable 1-D mesh wins unless a viable 2-D one costs less
    than ``bias`` times it; with no viable 1-D mesh the cheapest viable 2-D
    one wins, and with none at all, 1."""
    r, c = shape

    def neighbours(extent: int) -> int:
        return 0 if extent == 1 else (1 if extent == 2 else 2)

    def cost(nc: int) -> int:
        nr = n // nc
        return neighbours(nr) * -(-c // nc) + neighbours(nc) * -(-r // nr)

    viable = viable_mesh_cols(shape, n, min_rows, min_cols)
    best = min((nc for nc in viable if nc > 1), key=cost, default=None)
    if best is None:
        return 1
    if 1 not in viable or cost(best) < bias * cost(1):
        return best
    return 1


def _tile_rounded(extent: int, n_shards: int, tile: int) -> int:
    """ceil(ceil(extent / n_shards) / tile) * tile: the per-shard extent,
    padded to the tile (``grayscott_tpu/parallel/halo.py:635``)."""
    per = -(-extent // n_shards)
    return -(-per // tile) * tile


def shard_extents(shape, mesh: Mesh) -> Tuple[int, int]:
    """(r_loc, c_loc): the interior extents of every shard, multiples of
    QUANTUM (so at least QUANTUM)."""
    r, c = shape
    return (_tile_rounded(r, mesh.n_rows, QUANTUM),
            _tile_rounded(c, mesh.n_cols, QUANTUM))


def thin_shard(shape, mesh: Mesh) -> str | None:
    """Why shards of ``shape`` on ``mesh`` cannot run at its halo, or None:
    along a split axis a shard must hold at least ``mesh.halo`` interior
    cells, which the exchange copies into its neighbour's halo. JAX's
    exchange takes the same one hop (``grayscott_tpu/parallel/halo.py:
    206-216``) and checks nothing; from a thinner shard it sends the
    sender's own halo rows, and its windowed engine's result turns to NaN
    (``ShardedSimulation(engine="windowed", steps_per_call=32)`` on 4 row
    shards of 16 rows, interpret mode). The port refuses such a layout
    instead."""
    r_loc, c_loc = shard_extents(shape, mesh)
    if mesh.n_rows > 1 and r_loc < mesh.halo:
        return (f"shards of {r_loc} rows are thinner than their {mesh.halo}"
                " halo rows")
    if mesh.n_cols > 1 and c_loc < mesh.chalo:
        return (f"shards of {c_loc} columns are thinner than their "
                f"{mesh.chalo} halo columns")
    return None


def pair_shape(shape, mesh: Mesh) -> Tuple[int, ...]:
    """The shape of one species' pairs for a domain of ``shape``: this
    process's shards."""
    r_loc, c_loc = shard_extents(shape, mesh)
    return (*mesh.local_shape, 2, mesh.halo + r_loc + mesh.halo,
            mesh.chalo + c_loc + mesh.chalo)


def interior_extents(pairs: torch.Tensor,
                     halo: "int | Mesh" = HALO) -> Tuple[int, int, int]:
    """(r_loc, c_loc, chalo) of pairs in the shard layout of ``halo``, or
    of the mesh ``halo`` (its halo, and its columns: a process's block may
    hold fewer columns than the mesh)."""
    if isinstance(halo, Mesh):
        h, chalo = halo.halo, halo.chalo
    else:
        h, chalo = halo, col_halo(pairs.shape[1], halo)
    return pairs.shape[3] - 2 * h, pairs.shape[4] - 2 * chalo, chalo


def mega_shard_state(u, v, mesh: Mesh, dtype: torch.dtype = torch.float32
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(R, C) host or device state -> the pairs of this process's shards
    on ``mesh.device``, of ``dtype`` (float32, or bfloat16: the state
    rounded to nearest even) (``grayscott_tpu/parallel/halo.py:687`` and
    ``:644``, on tensors, for both mesh forms). Slot 0 holds the state;
    halos, slot 1 and the cells past the domain start 0.0. Every process
    passes the whole state."""
    out = []
    lr, lc = mesh.local_shape
    row0, col0 = mesh.origin
    for x in (u, v):
        x = torch.as_tensor(np.asarray(x, dtype=np.float32)
                            if isinstance(x, np.ndarray) else x,
                            dtype=torch.float32)
        pairs = torch.zeros(pair_shape(x.shape, mesh), dtype=dtype,
                            device=mesh.device)
        h = mesh.halo
        r_loc, c_loc, ch = interior_extents(pairs, mesh)
        part = x[row0 * r_loc:(row0 + lr) * r_loc,
                 col0 * c_loc:(col0 + lc) * c_loc].to(mesh.device)
        block = torch.zeros((lr * r_loc, lc * c_loc), dtype=torch.float32,
                            device=mesh.device)
        block[:part.shape[0], :part.shape[1]] = part
        pairs[:, :, 0, h:h + r_loc, ch:ch + c_loc] = block.reshape(
            lr, r_loc, lc, c_loc).permute(0, 2, 1, 3)
        out.append(pairs)
    return out[0], out[1]


def mega_unshard_result(pairs: torch.Tensor, shape, slot: int = 0,
                        halo: "int | Mesh" = HALO) -> torch.Tensor:
    """The interiors of ``slot`` of pairs of ``halo`` (or of the mesh
    ``halo``: :func:`interior_extents`), reassembled and cropped to
    ``shape`` (R, C): a new float32 tensor (bfloat16 pairs widen exactly),
    as JAX's host views are (``grayscott_tpu/parallel/halo.py:719`` and
    ``:673``). ``shape`` None: the block uncropped, each process's part of
    the padded domain, which ``utils/distributed.py:fetch`` assembles
    (``Mesh.blocks``)."""
    n_r, n_c = pairs.shape[:2]
    r_loc, c_loc, ch = interior_extents(pairs, halo)
    h = halo.halo if isinstance(halo, Mesh) else halo
    interior = pairs[:, :, slot, h:h + r_loc, ch:ch + c_loc]
    full = interior.permute(0, 2, 1, 3).reshape(n_r * r_loc, n_c * c_loc)
    if shape is not None:
        full = full[:shape[0], :shape[1]]
    return full.to(torch.float32, copy=True)


def exchange_halos(pairs: torch.Tensor, slot: int = 0,
                   halo: int = HALO) -> None:
    """Fill the halos of ``slot`` from the neighbours, in place: first the
    rows, across the whole width, then the columns across every row, halo
    rows included, so that the corners arrive from the diagonal neighbours
    (``_exchange_rows`` / ``_exchange_cols``,
    ``grayscott_tpu/parallel/halo.py:178-224``). Halos on the domain's
    outer sides get 0.0, as ``ppermute`` delivers there. Afterwards each
    shard's ``slot`` is the zero-padded domain's block around its
    interior. Eight copies of slices (four on a 1-D mesh), each across
    every shard at once; they read only interior cells and the halo rows
    they filled first, and write only halo cells. ``halo``: the layout's
    (the pairs' halo rows; :func:`thin_shard` must hold)."""
    r_loc, c_loc, ch = interior_extents(pairs, halo)
    h, x = halo, pairs[:, :, slot]
    x[1:, :, :h] = x[:-1, :, r_loc:r_loc + h]
    x[0, :, :h] = 0.0
    x[:-1, :, h + r_loc:] = x[1:, :, h:2 * h]
    x[-1, :, h + r_loc:] = 0.0
    if ch:
        x[:, 1:, :, :ch] = x[:, :-1, :, c_loc:c_loc + ch]
        x[:, 0, :, :ch] = 0.0
        x[:, :-1, :, ch + c_loc:] = x[:, 1:, :, ch:2 * ch]
        x[:, -1, :, ch + c_loc:] = 0.0


def exchange(mesh: Mesh, pairs: Sequence[torch.Tensor],
             slot: int = 0) -> None:
    """Fill the halos of ``slot`` of each of ``pairs`` (the species' pairs
    of ``mesh``, its halo), in place. One process: :func:`exchange_halos`
    of each. Several: the same two phases, rows then columns, on this
    process's block; copies between two shards of the block stay slice
    copies on the device, and the bands of the block's outer shards go to
    and come from the neighbouring processes' blocks (:func:`_swap`), the
    domain's outer halos 0.0. The column phase sends whole columns, halo
    rows included, once the row phase has received its bands, so the
    corners arrive from the diagonal neighbours. Every process must call
    it, in the same order."""
    if mesh.processes == 1:
        for p in pairs:
            exchange_halos(p, slot, mesh.halo)
        return
    r_loc, c_loc, ch = interior_extents(pairs[0], mesh)
    h, xs = mesh.halo, [p[:, :, slot] for p in pairs]
    n_pr, n_pc = mesh.process_grid
    pi, pj = divmod(mesh.process, n_pc)
    for x in xs:
        x[1:, :, :h] = x[:-1, :, r_loc:r_loc + h]
        x[:-1, :, h + r_loc:] = x[1:, :, h:2 * h]
    # the row phase: the block's first shard row with the block above, its
    # last with the block below
    plan = {}
    if pi:
        plan[mesh.process - n_pc] = ([x[0, :, h:2 * h] for x in xs],
                                     [x[0, :, :h] for x in xs])
    if pi < n_pr - 1:
        plan[mesh.process + n_pc] = ([x[-1, :, r_loc:r_loc + h] for x in xs],
                                     [x[-1, :, h + r_loc:] for x in xs])
    _swap(plan, tag=0)
    for x in xs:
        if not pi:
            x[0, :, :h] = 0.0
        if pi == n_pr - 1:
            x[-1, :, h + r_loc:] = 0.0
    if not ch:
        return
    for x in xs:
        x[:, 1:, :, :ch] = x[:, :-1, :, c_loc:c_loc + ch]
        x[:, :-1, :, ch + c_loc:] = x[:, 1:, :, ch:2 * ch]
    plan = {}
    if pj:
        plan[mesh.process - 1] = ([x[:, 0, :, ch:2 * ch] for x in xs],
                                  [x[:, 0, :, :ch] for x in xs])
    if pj < n_pc - 1:
        plan[mesh.process + 1] = ([x[:, -1, :, c_loc:c_loc + ch] for x in xs],
                                  [x[:, -1, :, ch + c_loc:] for x in xs])
    _swap(plan, tag=1)
    for x in xs:
        if not pj:
            x[:, 0, :, :ch] = 0.0
        if pj == n_pc - 1:
            x[:, -1, :, ch + c_loc:] = 0.0


def _swap(plan: dict, tag: int) -> None:
    """Send each peer's bands and receive its bands into ours, in place:
    ``plan`` maps a rank to (the views to send, the views to fill), all of
    one dtype and device, the same shapes on both sides. One message a
    peer each way: on the card the views are packed on the current stream,
    copied into a pinned host buffer, which the host waits for, and sent;
    what arrives is copied back on the current stream. Raises when a peer
    is gone (gloo's connection closes, or the group's timeout)."""
    import torch.distributed as dist

    if not plan:
        return
    sample = next(iter(plan.values()))[0][0]
    cuda = sample.device.type == "cuda"
    outgoing, incoming, works = {}, {}, []
    for rank, (send, _) in plan.items():
        flat = torch.cat([v.reshape(-1) for v in send])
        if cuda:
            host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
            host.copy_(flat, non_blocking=True)
            flat = host
        outgoing[rank] = flat
    if cuda:
        staged = torch.cuda.Event()
        staged.record()
        staged.synchronize()
    for rank, (_, recv) in plan.items():
        n = sum(v.numel() for v in recv)
        incoming[rank] = torch.empty(n, dtype=sample.dtype, pin_memory=cuda)
        works.append(dist.irecv(incoming[rank], rank, tag=tag))
    for rank, flat in outgoing.items():
        works.append(dist.isend(flat, rank, tag=tag))
    for work in works:
        work.wait()
    for rank, (_, recv) in plan.items():
        flat = incoming[rank].to(sample.device, non_blocking=True)
        at = 0
        for v in recv:
            v.copy_(flat[at:at + v.numel()].view(v.shape))
            at += v.numel()


def overlap_tiles(r_loc: int, c_loc: int, chalo: int,
                  tile: Tuple[int, int] = (WINDOWED_TILE, WINDOWED_TILE),
                  halo: int = HALO) -> Tuple[int, int, int, int]:
    """The overlap-interior tiles of a shard, ``(ti0, ti1, tj0, tj1)``
    (tile rows ``[ti0, ti1)``, tile columns ``[tj0, tj1)``): the ``tile``
    (tr, tc) tiles, anchored at the shard's interior origin, whose window
    (the tile and ``halo`` cells around it) lies inside the shard's
    interior rows and, on a 2-D mesh (``chalo`` > 0), its interior
    columns. Their windows read no halo cell, so the windowed engine can
    step them while the exchange fills the halos; every other tile is an
    overlap-edge tile. The rectangle may be empty. A 1-D mesh has no halo
    columns: every tile column is in."""
    def inner(extent: int, t: int) -> Tuple[int, int]:
        # tile i's window [i*t - halo, i*t + t + halo) inside [0, extent)
        first, end = -(-halo // t), (extent - halo) // t
        return (first, end) if end > first else (0, 0)

    tr, tc = tile
    ti0, ti1 = inner(r_loc, tr)
    tj0, tj1 = inner(c_loc, tc) if chalo else (0, -(-c_loc // tc))
    if ti1 <= ti0 or tj1 <= tj0:
        return (0, 0, 0, 0)
    return ti0, ti1, tj0, tj1


def overlap_engages(r_loc: int, c_loc: int, n_cols: int,
                    tile: Tuple[int, int] = (WINDOWED_TILE, WINDOWED_TILE),
                    halo: int = HALO) -> bool:
    """Whether the windowed engine's overlap split takes effect on shards
    of ``r_loc x c_loc`` interior cells in a mesh of ``n_cols`` columns, on
    ``tile`` tiles at ``halo``: every shard has at least one
    overlap-interior tile (:func:`overlap_tiles`; all shards share the
    extents). Else ``overlap`` runs serialized, as JAX falls back
    (``grayscott_tpu/parallel/halo.py:96-109``). The backend and the
    sharded tuner both read it."""
    ti0, ti1, _, _ = overlap_tiles(r_loc, c_loc, col_halo(n_cols, halo),
                                   tile, halo)
    return ti1 > ti0


def push_band(offset: int, n: int, halo: int) -> Tuple[slice, slice]:
    """Along one axis of a shard (``n`` interior cells inside ``halo`` on
    each side), the cells that a push toward the neighbour at ``offset``
    (-1, 0, 1) reads from the sender and writes in the receiver: the
    interior band of ``halo`` cells on that side into the receiver's
    opposite halo, or, for 0, the whole interior into the whole interior
    (``grayscott_tpu/ops/megakernel.py:324-353``)."""
    if offset > 0:
        return slice(n, n + halo), slice(0, halo)
    if offset < 0:
        return slice(halo, 2 * halo), slice(halo + n, 2 * halo + n)
    return slice(halo, halo + n), slice(halo, halo + n)


def _pairs_at(offset: int, count: int) -> Tuple[slice, slice]:
    """(senders, receivers) along one mesh axis for a push at ``offset``."""
    if offset > 0:
        return slice(0, count - 1), slice(1, count)
    if offset < 0:
        return slice(1, count), slice(0, count - 1)
    return slice(None), slice(None)


def push_halos(pairs: torch.Tensor, slot: int,
               directions: Sequence[Tuple[int, int]] = DIRECTIONS) -> None:
    """Every shard's pushes into its neighbours' halos of ``slot``, in
    place: the plain version of the megakernel's exchange at the end of a
    time block (K7's layout, ``HALO``). Row pushes span the interior
    columns, column pushes the interior rows, corner pushes a HALO x
    COL_HALO corner."""
    n_r, n_c = pairs.shape[:2]
    r_loc, c_loc, ch = interior_extents(pairs)
    for dr, dc in directions:
        if (dr and n_r == 1) or (dc and n_c == 1):
            continue
        (send_r, recv_r), (send_c, recv_c) = (_pairs_at(dr, n_r),
                                              _pairs_at(dc, n_c))
        (src_rows, dst_rows), (src_cols, dst_cols) = (
            push_band(dr, r_loc, HALO), push_band(dc, c_loc, ch))
        pairs[recv_r, recv_c, slot, dst_rows, dst_cols] = \
            pairs[send_r, send_c, slot, src_rows, src_cols]
