"""The plain PyTorch Gray-Scott step, for both boundary semantics.

The port's counterpart of ``grayscott_tpu/ops/stencil.py`` and
``grayscott_tpu/oracle.py``. It keeps the oracle's expression tree, term
order and zero-weight skips (``oracle.py:84-129``), so that on the CPU it
is bitwise equal to ``oracle.step``. It is the plain version that the CUDA
kernel (``ops/windowed.py``) is held against on the card, and the path a
CPU tensor takes.

``naive``: the 3x3 window is clamped to the domain and its weights stay
anchored at the clamped window's top-left corner (``oracle._index_maps``).
``zero``: cells outside the domain read as 0.0, weights centred.

:func:`step_at` steps one block of a larger domain, at the block's global
origin: the plain version of the sharded megakernel's per-shard step
(``ops/sharded_mega.py``).

:func:`tiled_step` is the CPU twin of the interior dispatch of K1 and K3
(``csrc/gs_tile_sm90.cuh``): a tile whose window lies inside the domain
adds a fixed term list (:func:`fixed_laplacian`), the others take
:func:`step`; :func:`interior_tiles` counts the former.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from ..params import KernelConstants

BOUNDARIES = ("naive", "zero")


def _taps(start: int, n: int, total: int, device) -> Tuple[list, list]:
    """Gather indices and validity of the three naive taps along one axis
    (``oracle._index_maps``), for ``n`` cells from global index ``start``
    of an axis of ``total`` cells: tap i of index r reads ``max(r-1, 0) +
    i`` and is valid iff that index is ``<= min(r+1, total-1)``. The
    indices are into the block padded by one cell on each side (the pad
    holds 0.0: cells the block does not hold)."""
    g = torch.arange(start, start + n, device=device)
    first = (g - 1).clamp(min=0)
    end = (g + 1).clamp(max=total - 1)
    idx, valid = [], []
    for i in range(3):
        src = first + i
        ok = src <= end
        # every tap lies within one cell of its centre: inside the padding
        idx.append(torch.where(ok, src - start + 1, 0))
        valid.append(ok)
    return idx, valid


def domain_mask(shape: Tuple[int, int], origin: Tuple[int, int],
                domain: Tuple[int, int], device) -> torch.Tensor:
    """Which cells of a block of ``shape`` at global ``origin`` lie in the
    ``domain`` (R, C)."""
    rows = torch.arange(origin[0], origin[0] + shape[0], device=device)
    cols = torch.arange(origin[1], origin[1] + shape[1], device=device)
    return (((rows >= 0) & (rows < domain[0]))[:, None]
            & ((cols >= 0) & (cols < domain[1]))[None, :])


def laplacian_at(x: torch.Tensor, weights: Sequence[float], boundary: str,
                 origin: Tuple[int, int],
                 domain: Tuple[int, int]) -> torch.Tensor:
    """:func:`laplacian` of a block ``x`` of the ``domain`` (R, C) whose
    cell (0, 0) lies at global ``origin``: the naive window is clamped at the
    domain's edge, not the block's. Cells outside the domain must hold 0.0.
    Taps outside the block read 0.0, so the block's outer ring is wrong,
    and one ring more with every step; a block with ``k`` rings around the
    cells it keeps gives them exactly for ``k`` steps."""
    rows, cols = x.shape
    full = torch.zeros_like(x)
    xp = F.pad(x, (1, 1, 1, 1))
    if boundary == "naive":
        ridx, rok = _taps(origin[0], rows, domain[0], x.device)
        cidx, cok = _taps(origin[1], cols, domain[1], x.device)
        for i in range(3):
            for j in range(3):
                w = weights[3 * i + j]
                if w == 0.0 and (i, j) != (1, 1):
                    continue
                tap = xp.index_select(0, ridx[i]).index_select(1, cidx[j])
                mask = rok[i][:, None] & cok[j][None, :]
                full = full + torch.where(mask, w * (tap - x), 0.0)
    elif boundary == "zero":
        for i in range(3):
            for j in range(3):
                w = weights[3 * i + j]
                if w == 0.0:
                    continue
                full = full + w * (xp[i:i + rows, j:j + cols] - x)
    else:
        raise ValueError(
            f"unknown boundary {boundary!r}; expected {BOUNDARIES}")
    return full


def laplacian(x: torch.Tensor, weights: Sequence[float],
              boundary: str) -> torch.Tensor:
    """The weighted diffusion gradient of one species (``oracle.laplacian``).

    ``weights``: 9 float32-exact Python floats, row-major."""
    return laplacian_at(x, weights, boundary, (0, 0), x.shape)


def _update(u: torch.Tensor, v: torch.Tensor, full_u: torch.Tensor,
            full_v: torch.Tensor, consts: KernelConstants
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reaction and the Euler update (``oracle.step``)."""
    du_rate, dv_rate, feed, min_feed_kill, dt = consts.reaction
    uv_square = u * v * v
    du = du_rate * full_u - uv_square + feed * (1.0 - u)
    # `+ (-(f+k)) * v` rounds exactly as the oracle's `- (f+k) * v`
    dv = dv_rate * full_v + uv_square + min_feed_kill * v
    return u + du * dt, v + dv * dt


def step(u: torch.Tensor, v: torch.Tensor, consts: KernelConstants,
         boundary: str = "naive") -> Tuple[torch.Tensor, torch.Tensor]:
    """One Gray-Scott step (``oracle.step``). Returns new ``(u', v')``."""
    return _update(u, v, laplacian(u, consts.weights, boundary),
                   laplacian(v, consts.weights, boundary), consts)


def run(u: torch.Tensor, v: torch.Tensor, steps: int,
        consts: KernelConstants, boundary: str = "naive"
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``steps`` calls of :func:`step`: the plain version of every kernel
    (``oracle.run``)."""
    for _ in range(steps):
        u, v = step(u, v, consts, boundary)
    return u, v


def step_at(u: torch.Tensor, v: torch.Tensor, consts: KernelConstants,
            boundary: str, origin: Tuple[int, int],
            domain: Tuple[int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`step` of a block of the ``domain`` (R, C) whose cell (0, 0)
    lies at global ``origin`` (:func:`laplacian_at`). Cells outside the
    domain come out as 0.0, as the kernels write them. On the whole domain
    at origin (0, 0) it equals :func:`step` bit for bit."""
    mask = domain_mask(u.shape, origin, domain, u.device)
    u, v = (torch.where(mask, x, 0.0) for x in (u, v))
    nu, nv = _update(u, v, laplacian_at(u, consts.weights, boundary, origin,
                                        domain),
                     laplacian_at(v, consts.weights, boundary, origin,
                                  domain), consts)
    return torch.where(mask, nu, 0.0), torch.where(mask, nv, 0.0)


def _interior_cells(n: int, t: int, halo: int, device=None) -> torch.Tensor:
    """Which of the ``n`` cells along one axis lie in a tile of ``t`` cells
    whose window (``halo`` more on each side) lies inside ``[0, n)``."""
    first = torch.arange(n, device=device) // t * t
    return (first - halo >= 0) & (first + t + halo <= n)


def interior_tiles(shape: Tuple[int, int], tile: Tuple[int, int],
                   halo: int) -> int:
    """How many ``tile`` (rows, cols) tiles of a ``shape`` domain have
    their window (the tile and ``halo`` cells around it) inside the domain:
    the tiles that K1 (``halo`` = K) and K3 (``halo`` = 1) step with no
    boundary arithmetic. Every cell such a tile steps lies in rows
    ``[1, R-2]`` and columns ``[1, C-2]``."""
    rows, cols = (int(_interior_cells(n, t, halo).sum()) // t
                  for n, t in zip(shape, tile))
    return rows * cols


def interior_mask(shape: Tuple[int, int], tile: Tuple[int, int], halo: int,
                  device=None) -> torch.Tensor:
    """The cells of the tiles that :func:`interior_tiles` counts."""
    rows, cols = (_interior_cells(n, t, halo, device)
                  for n, t in zip(shape, tile))
    return rows[:, None] & cols[None, :]


def fixed_laplacian(x: torch.Tensor, weights: Sequence[float],
                    boundary: str) -> torch.Tensor:
    """The laplacian of the cells ``x[1:-1, 1:-1]`` from the fixed term list
    of an interior tile, which no clamp and no domain edge reaches: every
    tap of nonzero weight in row-major order, and on the naive boundary the
    centre term ``w * (x - x)`` even when its weight is 0. These are the
    terms, in the order, that :func:`laplacian` adds for such a cell, so
    the result is the same bit for bit, NaN and Inf included."""
    if boundary not in BOUNDARIES:
        raise ValueError(
            f"unknown boundary {boundary!r}; expected {BOUNDARIES}")
    h, w = x.shape[0] - 2, x.shape[1] - 2
    centre = x[1:-1, 1:-1]
    full = torch.zeros_like(centre)
    for i in range(3):
        for j in range(3):
            wt = weights[3 * i + j]
            if wt == 0.0 and not (boundary == "naive" and (i, j) == (1, 1)):
                continue
            full = full + wt * (x[i:i + h, j:j + w] - centre)
    return full


def tiled_step(u: torch.Tensor, v: torch.Tensor, consts: KernelConstants,
               boundary: str, tile: Tuple[int, int], halo: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`step` decided tile by tile as K1 and K3 decide it: the cells
    of a tile that :func:`interior_tiles` counts come from
    :func:`fixed_laplacian` and the update, the others from :func:`step`.
    Equal to :func:`step` bit for bit."""
    nu, nv = step(u, v, consts, boundary)
    mask = interior_mask(u.shape, tile, halo, u.device)[1:-1, 1:-1]
    if not bool(mask.any()):
        return nu, nv
    fu, fv = _update(u[1:-1, 1:-1], v[1:-1, 1:-1],
                     fixed_laplacian(u, consts.weights, boundary),
                     fixed_laplacian(v, consts.weights, boundary), consts)
    nu[1:-1, 1:-1] = torch.where(mask, fu, nu[1:-1, 1:-1])
    nv[1:-1, 1:-1] = torch.where(mask, fv, nv[1:-1, 1:-1])
    return nu, nv
