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
