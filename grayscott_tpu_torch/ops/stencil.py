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
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from ..params import KernelConstants

BOUNDARIES = ("naive", "zero")


def _index_maps(n: int, device) -> Tuple[list, list]:
    """Gather indices and validity of the three taps along one axis
    (``oracle._index_maps``): tap i of index r reads ``max(r-1, 0) + i``
    and is valid iff that index is ``<= min(r+1, n-1)``."""
    r = torch.arange(n, device=device)
    start = (r - 1).clamp(min=0)
    end = (r + 1).clamp(max=n - 1)
    idx, valid = [], []
    for i in range(3):
        src = start + i
        ok = src <= end
        idx.append(torch.where(ok, src, 0))  # a safe index; masked anyway
        valid.append(ok)
    return idx, valid


def laplacian(x: torch.Tensor, weights: Sequence[float],
              boundary: str) -> torch.Tensor:
    """The weighted diffusion gradient of one species (``oracle.laplacian``).

    ``weights``: 9 float32-exact Python floats, row-major."""
    rows, cols = x.shape
    full = torch.zeros_like(x)
    if boundary == "naive":
        ridx, rok = _index_maps(rows, x.device)
        cidx, cok = _index_maps(cols, x.device)
        for i in range(3):
            for j in range(3):
                w = weights[3 * i + j]
                if w == 0.0 and (i, j) != (1, 1):
                    continue
                tap = x.index_select(0, ridx[i]).index_select(1, cidx[j])
                mask = rok[i][:, None] & cok[j][None, :]
                full = full + torch.where(mask, w * (tap - x), 0.0)
    elif boundary == "zero":
        xp = F.pad(x, (1, 1, 1, 1))
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


def step(u: torch.Tensor, v: torch.Tensor, consts: KernelConstants,
         boundary: str = "naive") -> Tuple[torch.Tensor, torch.Tensor]:
    """One Gray-Scott step (``oracle.step``). Returns new ``(u', v')``."""
    du_rate, dv_rate, feed, min_feed_kill, dt = consts.reaction
    full_u = laplacian(u, consts.weights, boundary)
    full_v = laplacian(v, consts.weights, boundary)
    uv_square = u * v * v
    du = du_rate * full_u - uv_square + feed * (1.0 - u)
    # `+ (-(f+k)) * v` rounds exactly as the oracle's `- (f+k) * v`
    dv = dv_rate * full_v + uv_square + min_feed_kill * v
    return u + du * dt, v + dv * dt


def run(u: torch.Tensor, v: torch.Tensor, steps: int,
        consts: KernelConstants, boundary: str = "naive"
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``steps`` calls of :func:`step`: the plain version of every kernel
    (``oracle.run``)."""
    for _ in range(steps):
        u, v = step(u, v, consts, boundary)
    return u, v
