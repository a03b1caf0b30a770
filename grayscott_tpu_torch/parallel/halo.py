"""The sharded domain: the mesh of shards, their layout, and the halo
exchange. The port's copy of what the sharded megakernel path uses from
``grayscott_tpu/parallel/halo.py``.

The domain (R, C) is cut into an ``n_rows x n_cols`` mesh of shards, each
``r_loc x c_loc`` cells (:func:`shard_extents`; the last shards reach past
the domain, and their cells there stay 0.0). Each shard holds its state as
a pair per species, in one tensor for all shards::

    (n_rows, n_cols, 2, HALO + r_loc + HALO, chalo + c_loc + chalo)

Slot 0 of a pair is the current state, slot 1 the sharded megakernel's
scratch (``ops/sharded_mega.py``). Around the interior lie ``HALO`` rows of
the row neighbours' cells and, on 2-D meshes, ``chalo = COL_HALO`` columns
of the column neighbours' cells (corners from the diagonal neighbours); on
1-D meshes ``chalo`` is 0. The TPU layout's 128-lane column ring is not
needed: only ``HALO`` of its columns are ever pushed
(``grayscott_tpu/ops/megakernel.py:301-309``).

In this port every shard of a mesh lives on one ``torch.device``: more
shards than cards share the card, as the JAX suite's virtual devices share
the CPU. The kernel is one launch for all of them.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Sequence, Tuple

import numpy as np
import torch

#: halo rows around a shard: the megakernel's time-block depth
HALO = 8
#: halo columns around a shard on a 2-D mesh
COL_HALO = 8
#: shard extents are multiples of this, so a push band (HALO rows,
#: COL_HALO columns) lies inside every interior
QUANTUM = 8

#: the eight push directions, (row, column) offsets of the receiver, in the
#: order of grayscott_tpu/ops/megakernel.py:324-353 (and of the kernel's)
DIRECTIONS = ((1, 0), (-1, 0), (0, 1), (0, -1),
              (1, 1), (1, -1), (-1, 1), (-1, -1))

_logger = logging.getLogger("grayscott_tpu_torch")
_shared_logged = False


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``n_rows x n_cols`` shards, all on ``device``."""

    n_rows: int
    n_cols: int
    device: torch.device

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n_rows, self.n_cols)

    @property
    def n_shards(self) -> int:
        return self.n_rows * self.n_cols

    @property
    def chalo(self) -> int:
        return col_halo(self.n_cols)


def col_halo(n_cols: int) -> int:
    """Halo columns of a shard: COL_HALO on 2-D meshes, else 0."""
    return COL_HALO if n_cols > 1 else 0


def visible_cards(device: torch.device) -> int:
    """The cards a mesh on ``device`` could spread over (1 on the CPU)."""
    return torch.cuda.device_count() if device.type == "cuda" else 1


def make_mesh(n_devices: int | None = None, n_cols: int = 1,
              device: str | torch.device = "cuda") -> Mesh:
    """A mesh of ``n_devices`` shards in ``n_cols`` columns (a 1-D row mesh
    by default) on ``device``. ``None``: one shard per visible card."""
    device = torch.device(device)
    n = visible_cards(device) if n_devices is None else n_devices
    if n < 1 or n_cols < 1:
        raise ValueError(f"a mesh needs >= 1 shard and >= 1 column, got "
                         f"{n} shards in {n_cols} columns")
    if n % n_cols:
        raise ValueError(f"{n} devices not divisible by {n_cols} mesh "
                         "columns")
    global _shared_logged
    if n > 1 and not _shared_logged:
        _shared_logged = True
        _logger.info("the %d shards of a sharded mesh share %s (%d card(s) "
                     "visible): one launch runs them all", n, device,
                     visible_cards(device))
    return Mesh(n // n_cols, n_cols, device)


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


def pair_shape(shape, mesh: Mesh) -> Tuple[int, ...]:
    """The shape of one species' pairs for a domain of ``shape``."""
    r_loc, c_loc = shard_extents(shape, mesh)
    return (mesh.n_rows, mesh.n_cols, 2, HALO + r_loc + HALO,
            mesh.chalo + c_loc + mesh.chalo)


def interior_extents(pairs: torch.Tensor) -> Tuple[int, int, int]:
    """(r_loc, c_loc, chalo) of pairs in the shard layout."""
    chalo = col_halo(pairs.shape[1])
    return pairs.shape[3] - 2 * HALO, pairs.shape[4] - 2 * chalo, chalo


def mega_shard_state(u, v, mesh: Mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """(R, C) host or device state -> the pairs of its shards on
    ``mesh.device`` (``grayscott_tpu/parallel/halo.py:687`` and ``:644``,
    on tensors, for both mesh forms). Slot 0 holds the state; halos, slot 1
    and the cells past the domain start 0.0."""
    out = []
    for x in (u, v):
        x = torch.as_tensor(np.asarray(x, dtype=np.float32)
                            if isinstance(x, np.ndarray) else x,
                            dtype=torch.float32).to(mesh.device)
        r, c = x.shape
        pairs = torch.zeros(pair_shape((r, c), mesh), dtype=torch.float32,
                            device=mesh.device)
        r_loc, c_loc, ch = interior_extents(pairs)
        full = torch.zeros((mesh.n_rows * r_loc, mesh.n_cols * c_loc),
                           dtype=torch.float32, device=mesh.device)
        full[:r, :c] = x
        pairs[:, :, 0, HALO:HALO + r_loc, ch:ch + c_loc] = full.reshape(
            mesh.n_rows, r_loc, mesh.n_cols, c_loc).permute(0, 2, 1, 3)
        out.append(pairs)
    return out[0], out[1]


def mega_unshard_result(pairs: torch.Tensor, shape) -> torch.Tensor:
    """Slot 0's interiors, reassembled and cropped to (R, C): a new tensor
    (``grayscott_tpu/parallel/halo.py:719`` and ``:673``)."""
    r, c = shape
    n_r, n_c = pairs.shape[:2]
    r_loc, c_loc, ch = interior_extents(pairs)
    interior = pairs[:, :, 0, HALO:HALO + r_loc, ch:ch + c_loc]
    full = interior.permute(0, 2, 1, 3).reshape(n_r * r_loc, n_c * c_loc)
    return full[:r, :c].clone()


def exchange_halos(pairs: torch.Tensor) -> None:
    """Fill slot 0's halos from the neighbours, in place: first the rows,
    across the whole width, then the columns across every row, halo rows
    included, so that the corners arrive from the diagonal neighbours
    (``_exchange_rows`` / ``_exchange_cols``,
    ``grayscott_tpu/parallel/halo.py:178-224``). Halos on the domain's
    outer sides get 0.0, as ``ppermute`` delivers there. Afterwards each
    shard's slot 0 is the zero-padded domain's block around its interior."""
    r_loc, c_loc, ch = interior_extents(pairs)
    h, x = HALO, pairs[:, :, 0]
    x[1:, :, :h] = x[:-1, :, r_loc:r_loc + h]
    x[0, :, :h] = 0.0
    x[:-1, :, h + r_loc:] = x[1:, :, h:2 * h]
    x[-1, :, h + r_loc:] = 0.0
    if ch:
        x[:, 1:, :, :ch] = x[:, :-1, :, c_loc:c_loc + ch]
        x[:, 0, :, :ch] = 0.0
        x[:, :-1, :, ch + c_loc:] = x[:, 1:, :, ch:2 * ch]
        x[:, -1, :, ch + c_loc:] = 0.0


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
    time block. Row pushes span the interior columns, column pushes the
    interior rows, corner pushes a HALO x COL_HALO corner."""
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
