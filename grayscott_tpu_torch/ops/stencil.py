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

:func:`run_bf16` is the plain version of bf16 storage: float32 steps in
blocks of 8, the state rounded to bfloat16 after each.

:func:`step_naive_fold` is the folded naive reaction, JAX's opt-in
``fast_fold`` (``grayscott_tpu/ops/pallas_stencil.py:363-382``,
``:646-653``, ``:817-859``), in JAX's tree, term for term: the plain
version of the fold entries of K1 and K2 (:func:`run_naive_fold`,
:func:`run_naive_fold_bf16`). It is a few ulp off :func:`step`.

:func:`step_at` steps one block of a larger domain, at the block's global
origin: the plain version of the sharded megakernel's per-shard step
(``ops/sharded_mega.py``).

:func:`tiled_step` is the CPU twin of the interior dispatch of K1, K2 and
K3 (``csrc/gs_tile_sm90.cuh``): a tile whose window lies inside the domain
adds a fixed term list (:func:`fixed_laplacian`), the others take
:func:`step`; :func:`interior_tiles` counts the former.
:func:`tiled_step_at` and :func:`interior_tiles_at` do the same for a block
at a shard's origin, as K7 decides in global coordinates.

The second tree is the JAX package's shift algebra
(``grayscott_tpu/ops/stencil.py:86-357``), under its JAX names, for the
``regular``, ``fused`` and ``conv`` rungs of the backend ladder. For a
symmetric stencil ``[[a,b,a],[b,c,b],[a,b,a]]`` with ``a > 0`` the
corrected-weight laplacian is ``sepconv(X) - X * (rowsum (x) colsum)``:
:func:`_sepconv`, the zero-padded separable pass with ``h = [x, y, x]``
(``Parameters.separable_plan``), and the per-row and per-column sums of
the taps in bounds (:func:`_edge_sums`; the constant ``alpha`` on the zero
boundary). Another stencil takes the direct 9-term form
(:func:`laplacian_zero_direct`, or the masked form on the naive
boundary). On the naive boundary the top row and the left column, where
the weights stay anchored, are then recomputed exactly
(:func:`naive_edge_strip`, :func:`_naive_strips`). :func:`step_fast` is
JAX's ``step(..., exact=False)``; :func:`step_runtime` takes the weights
and rates as tensors (:func:`rates_array`). The tree keeps JAX's term
order, its static skips of zero weights and its float32 constants, and is
a few ulp off the oracle's tree: the separable pass reassociates the sum.
Its constant vectors are built once per length and device
(:func:`_device_constant`), outside any CUDA graph capture that replays
the step.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import geometry
from ..params import (FoldConstants, KernelConstants, Parameters,
                      Precision, kernel_constants)

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


#: steps between two roundings of bf16 storage by default: every engine's
#: block (K1's K, K2's and K7's time block); a steps_per_call pin K sets
#: K1's (``block``)
BF16_BLOCK = 8


def _blocks(steps: int, block: int) -> list:
    """``steps`` in blocks of ``block`` and one of the remainder."""
    if not (isinstance(block, int) and block >= 1):
        raise ValueError(f"block must be an int >= 1, got {block!r}")
    n_full, rem = divmod(steps, block)
    return [block] * n_full + ([rem] if rem else [])


def run_bf16(u: torch.Tensor, v: torch.Tensor, steps: int,
             consts: KernelConstants, boundary: str = "naive",
             block: int = BF16_BLOCK
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``steps`` steps of bfloat16 storage, the plain version of the bf16
    kernels (``grayscott_tpu/ops/pallas_stencil.py:970-993``): in blocks of
    ``steps // block`` x ``block`` steps and one of the remainder, each
    block widens the bfloat16 state to float32, takes its steps with
    :func:`run`, and rounds to bfloat16 (to nearest even) once. ``block``
    is the steps a launch (JAX's K: a ``steps_per_call`` pin rounds once a
    K-step block). Takes and returns bfloat16 tensors."""
    for k in _blocks(steps, block):
        u, v = run(u.float(), v.float(), k, consts, boundary)
        u, v = u.to(torch.bfloat16), v.to(torch.bfloat16)
    return u, v


def _fold_sum(xp: torch.Tensor, fc: FoldConstants) -> torch.Tensor:
    """The raw diffusion sum of the fold at the cells of the zero-padded
    ``xp`` (R+2, C+2): the separable pass ``t = h1*x + h0*(xw + xe)``,
    ``s = h1*t + h0*(tn + ts)`` (``pallas_stencil.py:451-462``; not
    :func:`_sepconv`, whose tree adds the side taps one at a time), or the
    direct plan's taps of nonzero weight, row-major, from 0.0
    (``:515-516``)."""
    r, c = xp.shape[0] - 2, xp.shape[1] - 2
    if fc.separable:
        t = fc.h1 * xp[:, 1:c + 1] + fc.h0 * (xp[:, 0:c] + xp[:, 2:c + 2])
        return fc.h1 * t[1:r + 1] + fc.h0 * (t[0:r] + t[2:r + 2])
    full = torch.zeros((r, c), dtype=xp.dtype, device=xp.device)
    for i in range(3):
        for j in range(3):
            w = fc.weights[3 * i + j]
            if w != 0.0:
                full = full + w * xp[i:i + r, j:j + c]
    return full


@functools.lru_cache(maxsize=64)
def fold_fields(shape: Tuple[int, int], fc: FoldConstants,
                device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fold's u-linear coefficient fields ``(AU, BV)`` of a domain of
    ``shape``: ``au0 - cu*b`` and ``bv0 - cv*b``, ``b`` the sum of the
    in-bounds weights (``pallas_stencil.py:464-547``, ``:646-653``): the
    separable plan's row sums times its column sums, or the direct plan's
    per-column sums of each weight row, masked by row. Row 0 and column 0
    take the strips instead; every other cell holds one of ``fc.au`` and
    ``fc.bv``, the four values the kernels take."""
    r, c = shape

    def sums(n, first_mid_last):
        first, mid, last = first_mid_last
        out = torch.full((n,), mid, dtype=torch.float32, device=device)
        out[0] = first
        out[n - 1] = last
        return out

    if fc.separable:
        # JAX's row factor takes the first sum at both ends
        first, mid, _ = fc.row_sums
        b = (sums(r, (first, mid, first))[:, None]
             * sums(c, fc.row_sums)[None, :])
    else:
        rows = torch.arange(r, device=device)
        ok_top = (rows >= 1).to(torch.float32)[:, None]
        ok_bot = (rows <= r - 2).to(torch.float32)[:, None]
        cw = [sums(c, s)[None, :] for s in fc.direct_sums]
        b = (ok_top * cw[0] + 1.0 * cw[1]) + ok_bot * cw[2]
    return fc.au0 - fc.cu * b, fc.bv0 - fc.cv * b


def _fold_top(xp: torch.Tensor, fc: FoldConstants) -> torch.Tensor:
    """The anchored gradient of row 0 (JAX's ``_edge_strip_1xc``,
    ``pallas_stencil.py:139``; the math of :func:`naive_edge_strip`'s top
    row, on the padded array so that one row or column needs no special
    case): cell 0 the 2x2 block of rows and columns {0, 1}, every other
    cell rows {0, 1} of its centred window, the east tap's centre masked
    on the last column."""
    c = xp.shape[1] - 2
    center = xp[1, 1:c + 1]
    ok_e = (torch.arange(c, device=xp.device) + 1 <= c - 1).to(xp.dtype)
    full = torch.zeros_like(center)
    q = torch.zeros_like(center[:1])
    for i in range(2):
        for j in range(3):
            w = fc.weights[3 * i + j]
            if w == 0.0:
                continue
            tap = xp[1 + i, j:j + c]
            if j == 2:
                full = full + w * (tap - center * ok_e)
            else:
                full = full + w * (tap - center)
            if j < 2:
                q = q + w * (xp[1 + i, 1 + j:2 + j] - center[:1])
    return torch.cat([q, full[1:]])


def _fold_left(xp: torch.Tensor, fc: FoldConstants) -> torch.Tensor:
    """The anchored gradient of column 0, for every row (JAX's
    ``_left_col_strip``, ``pallas_stencil.py:194``; row 0's is unused):
    rows {r-1, r, r+1} and columns {0, 1}, row by row, the bottom row's
    terms times 0.0 on the domain's last row. Not
    :func:`naive_edge_strip`, which adds the same terms column by
    column."""
    r = xp.shape[0] - 2
    center = xp[1:r + 1, 1]
    ok_s = (torch.arange(r, device=xp.device) <= r - 2).to(xp.dtype)
    full = torch.zeros_like(center)
    for i in range(3):
        for j in range(2):
            w = fc.weights[3 * i + j]
            if w == 0.0:
                continue
            term = w * (xp[i:i + r, 1 + j] - center)
            full = full + (term * ok_s if i == 2 else term)
    return full


def step_naive_fold(u: torch.Tensor, v: torch.Tensor, fc: FoldConstants
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step of the folded naive reaction (JAX's ``fast_fold``,
    ``pallas_stencil.py:817-859``): the bulk ``u' = ((cu*s_u - q) + e) +
    AU*u``, ``v' = (cv*s_v + q) + BV*v`` (:func:`_fold_sum`,
    :func:`fold_fields`; ``q = uv^2``, or ``dt*uv^2``), then column 0
    (rows >= 1) and row 0 (selected last) from their anchored gradients
    with the scalars ``au0``/``bv0``. The naive boundary's semantics,
    a few ulp off :func:`step` (JAX's budget: 3e-6 over 16 steps)."""
    up, vp = F.pad(u, (1, 1, 1, 1)), F.pad(v, (1, 1, 1, 1))
    au, bv = fold_fields(tuple(u.shape), fc, u.device)
    uv_square = u * v * v
    q = uv_square if fc.dt_is_one else fc.dt * uv_square

    def update(s_u, s_v, a, b, sel):
        un = ((fc.cu * s_u - q[sel]) + fc.e) + a * u[sel]
        vn = (fc.cv * s_v + q[sel]) + b * v[sel]
        return un, vn

    un, vn = update(_fold_sum(up, fc), _fold_sum(vp, fc), au, bv,
                    (slice(None), slice(None)))
    col = (slice(None), 0)
    lu, lv = update(_fold_left(up, fc), _fold_left(vp, fc), fc.au0, fc.bv0,
                    col)
    un[1:, 0], vn[1:, 0] = lu[1:], lv[1:]
    un[0], vn[0] = update(_fold_top(up, fc), _fold_top(vp, fc), fc.au0,
                          fc.bv0, 0)
    return un, vn


def run_naive_fold(u: torch.Tensor, v: torch.Tensor, steps: int,
                   fc: FoldConstants) -> Tuple[torch.Tensor, torch.Tensor]:
    """``steps`` calls of :func:`step_naive_fold`: the plain version of the
    float32 fold entries."""
    for _ in range(steps):
        u, v = step_naive_fold(u, v, fc)
    return u, v


def run_naive_fold_bf16(u: torch.Tensor, v: torch.Tensor, steps: int,
                        fc: FoldConstants, block: int = BF16_BLOCK
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`run_naive_fold` on bfloat16 storage, the plain version of the
    bf16 fold entries: in blocks of at most ``block`` steps, each widened
    to float32 and rounded to bfloat16 once, as :func:`run_bf16`."""
    for k in _blocks(steps, block):
        u, v = run_naive_fold(u.float(), v.float(), k, fc)
        u, v = u.to(torch.bfloat16), v.to(torch.bfloat16)
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


def _interior_cells(n: int, t: int, halo: int, device=None, start: int = 0,
                    anchor: int = 0, total: int | None = None
                    ) -> torch.Tensor:
    """Which of the ``n`` cells along one axis from global index ``start``
    lie in a tile of ``t`` cells (tiles start at global ``anchor`` + a
    multiple of ``t``) whose window (``halo`` more on each side) lies
    inside ``[0, total)``; ``total`` defaults to ``n``."""
    total = n if total is None else total
    g = torch.arange(start, start + n, device=device)
    first = anchor + torch.div(g - anchor, t, rounding_mode="floor") * t
    return (first - halo >= 0) & (first + t + halo <= total)


def interior_tiles(shape: Tuple[int, int], tile: Tuple[int, int],
                   halo: int) -> int:
    """How many ``tile`` (rows, cols) tiles of a ``shape`` domain have
    their window (the tile and ``halo`` cells around it) inside the domain:
    the tiles that K1 and K2 (``halo`` = K) and K3 (``halo`` = 1) step with
    no boundary arithmetic. Every cell such a tile steps lies in rows
    ``[1, R-2]`` and columns ``[1, C-2]``."""
    return interior_tiles_at((0, 0), shape, shape, tile, halo)


def interior_tiles_at(anchor: Tuple[int, int], extent: Tuple[int, int],
                      domain: Tuple[int, int], tile: Tuple[int, int],
                      halo: int) -> int:
    """How many of the ``tile`` tiles that cover a block of ``extent``
    (rows, cols) cells whose cell (0, 0) lies at global ``anchor`` have
    their window inside the ``domain``: K7's interior tiles of one shard
    (``anchor`` its interior's origin, ``extent`` (r_loc, c_loc)). A shard
    seam is no domain edge."""
    # (each of the ceil(e / t) tiles counts t cells along its axis)
    rows, cols = (int(_interior_cells(-(-e // t) * t, t, halo, start=a,
                                      anchor=a, total=total).sum()) // t
                  for a, e, total, t in zip(anchor, extent, domain, tile))
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


def tiled_step_at(u: torch.Tensor, v: torch.Tensor, consts: KernelConstants,
                  boundary: str, origin: Tuple[int, int],
                  domain: Tuple[int, int], tile: Tuple[int, int], halo: int,
                  anchor: Tuple[int, int] = (0, 0)
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`step_at` of a block whose cell (0, 0) lies at global
    ``origin``, decided tile by tile as K7 decides it: the tiles start at
    global ``anchor`` (a shard's interior origin) plus multiples of
    ``tile``, and a cell of a tile whose window (``halo`` cells around it)
    lies inside the ``domain`` comes from :func:`fixed_laplacian` and the
    update, every other cell from :func:`step_at`. Equal to
    :func:`step_at` bit for bit: such a cell lies at least ``halo`` >= 1
    cells inside the domain, and both read 0.0 past the block."""
    nu, nv = step_at(u, v, consts, boundary, origin, domain)
    rows, cols = (_interior_cells(n, t, halo, u.device, start=o, anchor=a,
                                  total=total)
                  for n, t, o, a, total in zip(u.shape, tile, origin, anchor,
                                               domain))
    mask = rows[:, None] & cols[None, :]
    if not bool(mask.any()):
        return nu, nv
    fu, fv = _update(u, v,
                     fixed_laplacian(F.pad(u, (1, 1, 1, 1)), consts.weights,
                                     boundary),
                     fixed_laplacian(F.pad(v, (1, 1, 1, 1)), consts.weights,
                                     boundary), consts)
    return torch.where(mask, fu, nu), torch.where(mask, fv, nv)


def fold_block_walk(u: torch.Tensor, v: torch.Tensor, steps: int,
                    fc: FoldConstants, block_cols: int = 4,
                    tile: Tuple[int, int] = (64, 64), halo: int = 8
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`run_naive_fold` of ``steps`` (1..``halo``) steps as the fold
    entries' second form walks it (``csrc/gs_fold_sm90.cuh``), its CPU
    twin: each ``tile`` steps its window (``halo`` cells around it, the
    cells outside the domain loaded as 0.0) alone, each step over the valid
    region ``[s+1, W-s-1)``; the cells outside what a step writes and one
    cell past the window on every side hold NaN, the garbage the kernel
    leaves there. A tile whose window lies inside the domain steps the
    region with its columns rounded outward to multiples of ``block_cols``
    (C), every stepped cell taking the bulk fold with ``au[0]``,
    ``bv[0]``, and then holds NaN outside the valid region; an edge tile
    steps the region itself, each cell its per-cell result
    (:func:`step_naive_fold` of the window's cells in the domain, the
    domain's other cells NaN) and 0.0 outside the domain. Equal to
    :func:`run_naive_fold` bit for bit: a valid cell reads only cells valid
    at the step before, so no NaN reaches it."""
    tr, tc = tile
    wr, wc = tr + 2 * halo, tc + 2 * halo
    if wc % block_cols:
        raise ValueError(f"the window's width {wc} must be a multiple of "
                         f"the blocks' {block_cols} columns")
    if not 1 <= steps <= halo:
        raise ValueError(f"steps must lie in [1, {halo}], got {steps}")
    rows, cols = u.shape
    nan = float("nan")
    out = (torch.empty_like(u), torch.empty_like(v))
    for r0 in range(-halo, rows - halo, tr):
        for c0 in range(-halo, cols - halo, tc):
            inside = (min(r0, c0) >= 0 and r0 + wr <= rows
                      and c0 + wc <= cols)
            # the window's cells in the domain: global rr x cc, window wrr
            # x wcc in padded coordinates (window cell (0, 0) at (1, 1))
            rr = slice(max(r0, 0), min(r0 + wr, rows))
            cc = slice(max(c0, 0), min(c0 + wc, cols))
            wrr = slice(rr.start - r0 + 1, rr.stop - r0 + 1)
            wcc = slice(cc.start - c0 + 1, cc.stop - c0 + 1)
            win = []
            for x in (u, v):
                w = torch.full((wr + 2, wc + 2), nan, dtype=x.dtype)
                w[1:-1, 1:-1] = 0.0
                w[wrr, wcc] = x[rr, cc]
                win.append(w)
            for st in range(steps):
                lo = st + 1
                c_lo, c_hi = lo, wc - lo
                if inside:  # the blocks' columns, rounded outward
                    c_lo = lo // block_cols * block_cols
                    c_hi = -(-(wc - lo) // block_cols) * block_cols
                    xu, xv = (x[lo:wr - lo + 2, c_lo:c_hi + 2] for x in win)
                    cu, cv = xu[1:-1, 1:-1], xv[1:-1, 1:-1]
                    uv_square = cu * cv * cv
                    q = uv_square if fc.dt_is_one else fc.dt * uv_square
                    stepped = (((fc.cu * _fold_sum(xu, fc) - q) + fc.e)
                               + fc.au[0] * cu,
                               (fc.cv * _fold_sum(xv, fc) + q) + fc.bv[0] * cv)
                else:
                    dom = []
                    for w in win:
                        d = torch.full((rows, cols), nan, dtype=w.dtype)
                        d[rr, cc] = w[wrr, wcc]
                        dom.append(d)
                    stepped = []
                    for d in step_naive_fold(*dom, fc):
                        w = torch.zeros((wr + 2, wc + 2), dtype=d.dtype)
                        w[wrr, wcc] = d[rr, cc]
                        stepped.append(w[lo + 1:wr - lo + 1, c_lo + 1:c_hi + 1])
                for i, n in enumerate(stepped):
                    w = torch.full_like(win[i], nan)
                    w[lo + 1:wr - lo + 1, c_lo + 1:c_hi + 1] = n
                    w[:, :lo + 1] = nan  # stepped, not valid
                    w[:, wc - lo + 1:] = nan
                    win[i] = w
            # the tile's cells in the domain
            tr_ = slice(r0 + halo, min(r0 + halo + tr, rows))
            tc_ = slice(c0 + halo, min(c0 + halo + tc, cols))
            for o, w in zip(out, win):
                o[tr_, tc_] = w[tr_.start - r0 + 1:tr_.stop - r0 + 1,
                                tc_.start - c0 + 1:tc_.stop - c0 + 1]
    return out


def cluster_walk(u: torch.Tensor, v: torch.Tensor, steps: int,
                 consts: KernelConstants, boundary: str,
                 tile: Tuple[int, int], halo: int,
                 extent: Tuple[int, int] | None = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`run` of ``steps`` (1..``halo``) steps as the pinned entries'
    split walks it in its cluster part (``csrc/gs_pin_sm90.cuh``:
    ``cluster_window_multistep_on``), its CPU twin. The ``tile`` (tr, tc)
    tiles of the ``extent`` (rows, cols from global (0, 0); None: the
    domain) go in groups of 2x2 to clusters of 2x2 blocks, the grid padded
    to whole clusters. Each block holds its window (tr + halo + 1 rows, tc
    + halo + ``geometry.CLUSTER_MARGIN`` columns: its tile, the group's
    halo on the group's outer sides, a ghost row and column on its inner
    sides); it loads the cells the layout holds (the domain; with an
    ``extent``, as a shard's layout holds them: ``halo`` cells around the
    extent) and 0.0 elsewhere, and at each step steps the cells it owns in
    the group's valid region from one buffer into the other. Every other
    cell of the new buffer holds NaN, the garbage the kernel leaves there,
    but the ghost cells: those its live neighbours step on their inner
    edges (the kernel's stores into a neighbour's shared memory) and those
    of a neighbour that owns no cell of the domain (it steps nothing; they
    keep the 0.0 they loaded). A padded block (past the extent's tiles)
    owns the group's halo band beside its real neighbour and stores
    nothing. Returns the tiles' cells, on the extent (0.0 outside the
    domain), equal to :func:`run` there bit for bit: a valid cell reads
    only cells valid at the step before, and ghosts stepped by their
    owners at that step."""
    tr, tc = tile
    m = geometry.CLUSTER_MARGIN
    rows, cols = u.shape
    r_ext, c_ext = extent or (rows, cols)
    if not 1 <= steps <= halo:
        raise ValueError(f"steps must lie in [1, {halo}], got {steps}")
    tiles_y, tiles_x = -(-r_ext // tr), -(-c_ext // tc)
    wr, wc = tr + halo + 1, tc + halo + m
    nan = float("nan")
    held = ((-halo, r_ext + halo), (-halo, c_ext + halo)) if extent \
        else ((0, rows), (0, cols))

    def at(ti, tj):
        """The block's group geometry (kernel's names), in group coordinates
        and globally."""
        bi, bj = ti & 1, tj & 1
        gr_hi = (2 * tr if (ti | 1) < tiles_y else tr) + halo
        gc_hi = (2 * tc if (tj | 1) < tiles_x else tc) + halo
        b = {"bi": bi, "bj": bj, "gr_hi": gr_hi, "gc_hi": gc_hi,
             "own_r": (tr, gr_hi) if bi else (-halo, tr),
             "own_c": (tc, gc_hi) if bj else (-halo, tc),
             "wr0": tr - 1 if bi else -halo,
             "wc0": tc - m if bj else -halo,
             "gr0": (ti & ~1) * tr, "gc0": (tj & ~1) * tc}
        b["r0"], b["c0"] = b["gr0"] + b["wr0"], b["gc0"] + b["wc0"]
        b["dead"] = (b["gr0"] + b["own_r"][0] >= rows
                     or b["gc0"] + b["own_c"][0] >= cols)
        return b

    blocks = {(ti, tj): at(ti, tj)
              for ti in range(-(-tiles_y // 2) * 2)
              for tj in range(-(-tiles_x // 2) * 2)}
    bufs = {}
    for key, b in blocks.items():
        win = []
        for x in (u, v):
            w = torch.zeros((wr, wc), dtype=x.dtype)
            rr = (max(b["r0"], 0, held[0][0]),
                  min(b["r0"] + wr, rows, held[0][1]))
            cc = (max(b["c0"], 0, held[1][0]),
                  min(b["c0"] + wc, cols, held[1][1]))
            if rr[0] < rr[1] and cc[0] < cc[1]:
                w[rr[0] - b["r0"]:rr[1] - b["r0"],
                  cc[0] - b["c0"]:cc[1] - b["c0"]] = x[rr[0]:rr[1],
                                                      cc[0]:cc[1]]
            win.append(w)
        bufs[key] = win
    # the ghost row and column of each block, and their owners
    ghost = {}
    for key, b in blocks.items():
        gr = tr if b["bi"] == 0 else tr - 1  # group coordinates
        gc = tc if b["bj"] == 0 else tc - 1
        ghost[key] = (gr - b["wr0"], gc - b["wc0"])
    for st in range(1, steps + 1):
        new = {}
        for key, b in blocks.items():
            out = [torch.full((wr, wc), nan, dtype=x.dtype) for x in (u, v)]
            lr, lc = ghost[key]
            ti, tj = key
            for dti, dtj in ((1, 0), (0, 1), (1, 1)):
                n = (ti ^ dti, tj ^ dtj)
                if blocks[n]["dead"]:  # its cells keep the 0.0 loaded
                    rsel = slice(lr, lr + 1) if dti else slice(0, wr)
                    csel = slice(lc, lc + 1) if dtj else slice(0, wc)
                    if dti and dtj:
                        pass
                    elif dti:  # the ghost row's cells that n owns
                        own = blocks[n]["own_c"]
                        csel = slice(max(own[0] - b["wc0"], 0),
                                     max(min(own[1] - b["wc0"], wc), 0))
                    else:
                        own = blocks[n]["own_r"]
                        rsel = slice(max(own[0] - b["wr0"], 0),
                                     max(min(own[1] - b["wr0"], wr), 0))
                    for o, w in zip(out, bufs[key]):
                        o[rsel, csel] = w[rsel, csel]
            if not b["dead"]:
                r_lo = max(b["own_r"][0], st - halo) - b["wr0"]
                r_hi = min(b["own_r"][1], b["gr_hi"] - st) - b["wr0"]
                c_lo = max(b["own_c"][0], st - halo) - b["wc0"]
                c_hi = min(b["own_c"][1], b["gc_hi"] - st) - b["wc0"]
                nu, nv = step_at(*bufs[key], consts, boundary,
                                 (b["r0"], b["c0"]), (rows, cols))
                for o, x in zip(out, (nu, nv)):
                    o[r_lo:r_hi, c_lo:c_hi] = x[r_lo:r_hi, c_lo:c_hi]
                b["region"] = (r_lo, r_hi, c_lo, c_hi)
            new[key] = out
        # each live block's inner edge into its neighbours' ghost cells
        for key, b in blocks.items():
            if b["dead"]:
                continue
            r_lo, r_hi, c_lo, c_hi = b["region"]
            push_r = 1 if b["bi"] else tr - 1 + halo
            push_c = m if b["bj"] else tc - 1 + halo
            ti, tj = key
            for dti, dtj in ((1, 0), (0, 1), (1, 1)):
                n = blocks[ti ^ dti, tj ^ dtj]
                rs = (slice(push_r, push_r + 1) if dti
                      else slice(r_lo, r_hi))
                cs = (slice(push_c, push_c + 1) if dtj
                      else slice(c_lo, c_hi))
                if not (r_lo <= push_r < r_hi or not dti) or \
                        not (c_lo <= push_c < c_hi or not dtj):
                    continue
                dr, dc = b["r0"] - n["r0"], b["c0"] - n["c0"]
                for o, w in zip(new[ti ^ dti, tj ^ dtj], new[key]):
                    o[rs.start + dr:rs.stop + dr,
                      cs.start + dc:cs.stop + dc] = w[rs, cs]
        bufs = new
    outs = [torch.zeros((r_ext, c_ext), dtype=x.dtype) for x in (u, v)]
    for (ti, tj), b in blocks.items():
        if ti >= tiles_y or tj >= tiles_x:
            continue
        g0r, g0c = ti * tr, tj * tc
        rr = (g0r, min(g0r + tr, r_ext, rows))
        cc = (g0c, min(g0c + tc, c_ext, cols))
        if rr[0] >= rr[1] or cc[0] >= cc[1]:
            continue
        for o, w in zip(outs, bufs[ti, tj]):
            o[rr[0]:rr[1], cc[0]:cc[1]] = w[rr[0] - b["r0"]:rr[1] - b["r0"],
                                            cc[0] - b["c0"]:cc[1] - b["c0"]]
    return outs[0], outs[1]


# ---------------------------------------------------------------------------
# The shift algebra (``grayscott_tpu/ops/stencil.py:86-357``)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=256)
def _device_constant(kind: str, n: int, device: torch.device,
                     h: Tuple[float, ...] = ()) -> torch.Tensor:
    """A float32 constant of an axis of ``n`` cells on ``device``, built
    once: ``"rok"`` the (3, n) naive tap validity, ``"valid"`` the strip's
    ``c + 1 < n``, ``"edge_sums"`` :func:`_edge_sums` of ``h``. A CUDA graph
    captures no copy from the host, so the first eager step builds them."""
    if kind == "rok":
        return torch.stack(_taps(0, n, n, device)[1]).to(torch.float32)
    if kind == "valid":
        value = (np.arange(n) + 1 < n).astype(Precision)
    elif kind == "edge_sums":
        value = _edge_sums(n, np.asarray(h, dtype=Precision))
    else:
        raise ValueError(f"unknown constant {kind!r}")
    return torch.from_numpy(value).to(device)


def _shift2d(xp: torch.Tensor, i: int, j: int, r: int,
             c: int) -> torch.Tensor:
    """Tap (i-1, j-1) of the zero-padded ``xp`` of shape (r+2, c+2)."""
    return xp[i:i + r, j:j + c]


def laplacian_zero_direct(x: torch.Tensor,
                          params: Parameters) -> torch.Tensor:
    """The zero boundary as 9 shifted terms of the zero-padded array with
    the corrected weights."""
    wc = params.corrected_weights()
    r, c = x.shape
    xp = F.pad(x, (1, 1, 1, 1))
    full = torch.zeros_like(x)
    for i in range(3):
        for j in range(3):
            if wc[i, j] == 0.0:
                continue
            full = full + float(wc[i, j]) * _shift2d(xp, i, j, r, c)
    return full


def _sepconv(x: torch.Tensor, h: np.ndarray) -> torch.Tensor:
    """The zero-padded separable 3x3 convolution with kernel outer(h, h)."""
    r, c = x.shape
    h0, h1, h2 = (float(w) for w in h)
    xp = F.pad(x, (1, 1))
    t = h1 * x
    if h0 != 0.0:
        t = t + h0 * xp[:, 0:c]
    if h2 != 0.0:
        t = t + h2 * xp[:, 2:c + 2]
    tp = F.pad(t, (0, 0, 1, 1))
    s = h1 * t
    if h0 != 0.0:
        s = s + h0 * tp[0:r, :]
    if h2 != 0.0:
        s = s + h2 * tp[2:r + 2, :]
    return s


def _edge_sums(n: int, h: np.ndarray) -> np.ndarray:
    """Per-index sum of the h taps in bounds: h0+h1+h2 inside, h1+h2 and
    h0+h1 at the two ends."""
    s = np.full((n,), h.sum(), dtype=Precision)
    s[0] = Precision(h[1] + h[2])
    s[-1] = Precision(h[0] + h[1])
    return s


def laplacian_fast(x: torch.Tensor, params: Parameters,
                   boundary: str) -> torch.Tensor:
    """The diffusion gradient of the whole array on either boundary: the
    separable plan where the stencil has one, else the direct 9-term form.
    On the naive boundary every cell but the top row and the left column is
    exact; :func:`step_fast` patches those with :func:`_naive_strips`."""
    plan = params.separable_plan()
    r, c = x.shape
    if plan[0] == "separable":
        _, h, alpha = plan
        s = _sepconv(x, h)
        if boundary == "zero":
            return s - float(alpha) * x
        key = tuple(float(w) for w in h)
        b = torch.outer(_device_constant("edge_sums", r, x.device, key),
                        _device_constant("edge_sums", c, x.device, key))
        return s - x * b
    if boundary == "zero":
        return laplacian_zero_direct(x, params)
    # naive, direct: the masked 9-term form (valid but on row 0 / col 0)
    w = params.weights_array()
    xp = F.pad(x, (1, 1, 1, 1))
    full = torch.zeros_like(x)
    rok = _device_constant("rok", r, x.device)
    cok = _device_constant("rok", c, x.device)
    for i in range(3):
        for j in range(3):
            if w[i, j] == 0.0:
                continue
            mask = torch.outer(rok[i], cok[j])
            full = full + float(w[i, j]) * (
                _shift2d(xp, i, j, r, c) - x * mask)
    return full


def naive_edge_strip(lane0: torch.Tensor, lane1: torch.Tensor,
                     w2) -> torch.Tensor:
    """The exact naive diffusion gradient of a domain-edge strip
    (``grayscott_tpu/ops/stencil.py:184``).

    ``lane0`` is the edge row (or column) and ``lane1`` its inward
    neighbour, 1-D along the strip; ``w2`` the (2, 3) weight slab,
    ``w[0:2, :]`` for the top row and ``w[:, 0:2].T`` for the left column,
    as a numpy array (its zero weights skipped) or a tensor (every term
    added). Cell c >= 1 reads ``lane_i[c - 1 + j]`` while that index is
    below n; cell 0, where the weights stay anchored, reads ``lane_i[j]``
    for j in {0, 1}."""
    static = isinstance(w2, np.ndarray)
    n = lane0.shape[-1]
    center = lane0
    full = torch.zeros_like(lane0)
    lanes = (lane0, lane1)
    for i in range(2):
        xpi = F.pad(lanes[i], (1, 1))
        for j in range(3):
            wij = float(w2[i][j]) if static else w2[i][j]
            if static and wij == 0.0:
                continue
            tap = xpi[..., j:j + n]
            if j == 2:
                valid = _device_constant("valid", n, lane0.device)
                full = full + wij * (tap - center * valid)
            else:
                full = full + wij * (tap - center)
    q = torch.zeros_like(lane0[..., :1])
    for i in range(2):
        xi = lanes[i]
        for j in range(2):
            wij = float(w2[i][j]) if static else w2[i][j]
            if static and wij == 0.0:
                continue
            q = q + wij * (xi[..., j:j + 1] - center[..., :1])
    return torch.cat([q, full[..., 1:]], dim=-1)


def _naive_strips(x: torch.Tensor, params: Parameters
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(top-row strip, left-column strip) of the naive diffusion
    gradient."""
    w = params.weights_array()
    top = naive_edge_strip(x[0, :], x[1, :], w[0:2, :])
    left = naive_edge_strip(x[:, 0], x[:, 1], w[:, 0:2].T)
    return top, left


def _patch_strips(full: torch.Tensor, top: torch.Tensor,
                  left: torch.Tensor) -> torch.Tensor:
    """``full`` with its top row and left column replaced by the exact
    strips (JAX's ``.at[0, :].set`` and ``.at[1:, 0].set``), in place."""
    full[0, :] = top
    full[1:, 0] = left[1:]
    return full


def laplacian_shift(x: torch.Tensor, params: Parameters,
                    boundary: str) -> torch.Tensor:
    """JAX's ``laplacian(..., exact=False)``: :func:`laplacian_fast`, with
    the exact strips on the naive boundary."""
    if boundary == "naive":
        top, left = _naive_strips(x, params)
        return _patch_strips(laplacian_fast(x, params, "naive"), top, left)
    if boundary == "zero":
        return laplacian_fast(x, params, "zero")
    raise ValueError(f"unknown boundary {boundary!r}; expected {BOUNDARIES}")


def reaction(u: torch.Tensor, v: torch.Tensor, full_u: torch.Tensor,
             full_v: torch.Tensor, params: Parameters
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reaction and the Euler update in the reference's term order
    (``grayscott_tpu/ops/stencil.py:264``): the oracle's update."""
    return _update(u, v, full_u, full_v, kernel_constants(params))


def step_fast(u: torch.Tensor, v: torch.Tensor, params: Parameters,
              boundary: str = "naive") -> Tuple[torch.Tensor, torch.Tensor]:
    """One step on the shift algebra: JAX's ``step(..., exact=False)``."""
    return reaction(u, v, laplacian_shift(u, params, boundary),
                    laplacian_shift(v, params, boundary), params)


def step_runtime(u: torch.Tensor, v: torch.Tensor, weights: torch.Tensor,
                 rates: torch.Tensor, boundary: str = "naive"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step with the weights (3, 3) and the rates ``[Du, Dv, f, k, dt]``
    (:func:`rates_array`) as float32 tensors on the state's device
    (``grayscott_tpu/ops/stencil.py:300``): new values take effect without
    rebuilding anything that replays the step. Every weight is applied,
    zero or not."""
    if boundary not in BOUNDARIES:
        raise ValueError(
            f"unknown boundary {boundary!r}; expected {BOUNDARIES}")
    r, c = u.shape
    rok = _device_constant("rok", r, u.device)
    cok = _device_constant("rok", c, u.device)

    def lap(x):
        xp = F.pad(x, (1, 1, 1, 1))
        full = torch.zeros_like(x)
        for i in range(3):
            for j in range(3):
                tap = _shift2d(xp, i, j, r, c)
                if boundary == "zero":
                    full = full + weights[i, j] * (tap - x)
                else:
                    mask = torch.outer(rok[i], cok[j])
                    full = full + weights[i, j] * (tap - x * mask)
        if boundary == "naive":
            top = naive_edge_strip(x[0, :], x[1, :], weights[0:2, :])
            left = naive_edge_strip(x[:, 0], x[:, 1], weights[:, 0:2].T)
            full = _patch_strips(full, top, left)
        return full

    full_u = lap(u)
    full_v = lap(v)
    du_rate, dv_rate, f, k, dt = (rates[i] for i in range(5))
    uv_square = u * v * v
    du = du_rate * full_u - uv_square + f * (1.0 - u)
    dv = dv_rate * full_v + uv_square - (f + k) * v
    return u + du * dt, v + dv * dt


def rates_array(params: Parameters,
                device: str | torch.device = "cpu") -> torch.Tensor:
    """The scalar parameters of :func:`step_runtime`, float32."""
    return torch.tensor(
        [params.diffusion_rate_u, params.diffusion_rate_v,
         params.feed_rate, params.kill_rate, params.time_step],
        dtype=torch.float32, device=device)
