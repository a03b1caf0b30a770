"""The lane-fold layout (``--pallas-fold F``): the port's copy of
``grayscott_tpu/ops/pallas_stencil.py``'s helpers (``:1509-1584``), on
tensors.

JAX lays F row panels of a narrow ``(R, C)`` domain side by side along
lanes, so that its kernel works on ``F*C``-wide windows of the TPU's
128-lane registers. Panel ``p`` holds global rows ``[p*Rp, (p+1)*Rp)``,
``Rp`` (:func:`fold_geometry`) a multiple of the row tile; rows at or past
R are dead and stay 0.0. The folded state is ``(halo + Rp + halo, F*C)``:
around each panel's interior lie ``halo`` rows of its neighbours' cells,
which :func:`fold_refresh` fills before every block of K steps (the
sharded engine's halo exchange, across columns of one tensor).

The port keeps JAX's layout, so that ``extract_uv`` is JAX's
:func:`unfold_state`; K1's folded entry (``ops/windowed.py:
folded_multistep``) refreshes the halos with a kernel whose plain version
is :func:`fold_refresh`, then steps each panel at its global origin
``(p*Rp - halo, 0)``, as its shard entry steps a shard at its mesh
offset. A 2-D tile on the card has no lane width, so whether folding pays
there is the card's to say (PERF.md §6).
"""

from __future__ import annotations

from typing import Tuple

import torch

#: the lane width below which JAX folds (``pallas_stencil.py:1570``: the
#: TPU width probe's crossover)
FOLD_TARGET_LANES = 3840


def fold_geometry(r: int, f: int, tr: int) -> int:
    """The panel stride Rp: ``ceil(R/F)`` rounded up to a multiple of the
    row tile ``tr`` (``pallas_stencil.py:1509``)."""
    rp0 = -(-r // f)
    return -(-rp0 // tr) * tr


def fold_state(u, v, f: int, tr: int, halo: int,
               device: str | torch.device = "cpu"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(R, C)`` concentrations (arrays or tensors) in the folded layout
    ``(halo + Rp + halo, F*C)`` float32 on ``device``: panel ``p`` at
    columns ``[p*C, (p+1)*C)``, dead rows and halos 0.0
    (``pallas_stencil.py:1518``; the first :func:`fold_refresh` fills the
    halos)."""
    r, c = u.shape
    rp = fold_geometry(r, f, tr)
    out = []
    for x in (u, v):
        x = torch.as_tensor(x).to(device=device, dtype=torch.float32)
        flat = torch.zeros((f * rp, c), dtype=torch.float32, device=device)
        flat[:r] = x
        buf = torch.zeros((halo + rp + halo, f * c), dtype=torch.float32,
                          device=device)
        buf[halo:halo + rp] = flat.view(f, rp, c).transpose(0, 1) \
            .reshape(rp, f * c)
        out.append(buf)
    return out[0], out[1]


def unfold_state(x_pad: torch.Tensor, halo: int, f: int, cd: int,
                 r: int) -> torch.Tensor:
    """The ``(R, Cd)`` domain of a folded tensor, a new tensor
    (``pallas_stencil.py:1539``)."""
    rp = x_pad.shape[0] - 2 * halo
    interior = x_pad[halo:halo + rp]
    return interior.reshape(rp, f, cd).transpose(0, 1) \
        .reshape(f * rp, cd)[:r]


def fold_refresh(x: torch.Tensor, halo: int, f: int, cd: int,
                 rp: int) -> None:
    """Fill the panels' halo rows of a folded tensor, in place
    (``pallas_stencil.py:1547``): panel ``p``'s top ``halo`` rows get
    panel ``p-1``'s last ``halo`` interior rows, its bottom ones panel
    ``p+1``'s first; the outermost halos 0.0. Four slice copies across
    every panel at once; they read interior rows only (``rp >= halo``) and
    write halo rows only."""
    x3 = x.view(x.shape[0], f, cd)
    x3[:halo, 1:] = x3[rp:rp + halo, :f - 1]
    x3[:halo, 0] = 0.0
    x3[halo + rp:, :f - 1] = x3[halo:2 * halo, 1:]
    x3[halo + rp:, f - 1] = 0.0


def panel_window(x: torch.Tensor, halo: int, f: int, cd: int, rp: int,
                 p: int) -> torch.Tensor:
    """Panel ``p``'s columns of the folded ``x``, ``halo + rp + halo``
    rows, its halo rows read from the neighbour panels' interior rows
    (0.0 past the first and last panel), not from ``x``'s halo rows: the
    window of the one-launch form of K1's folded entry, which refreshes no
    halo before it steps (``csrc/windowed_folded.cuh``: FoldLayout). Equal
    to the panel's columns of ``x`` after :func:`fold_refresh`."""
    interior = x[halo:halo + rp]
    zeros = x.new_zeros((halo, cd))
    top = interior[rp - halo:, (p - 1) * cd:p * cd] if p > 0 else zeros
    bottom = (interior[:halo, (p + 1) * cd:(p + 2) * cd] if p + 1 < f
              else zeros)
    return torch.cat([top, interior[:, p * cd:(p + 1) * cd], bottom])


def choose_fold(r: int, c: int, halo: int = 16) -> int:
    """The fold factor F (1: no fold) JAX's tuner tries on a ``(r, c)``
    domain (``pallas_stencil.py:1573``): widen toward
    :data:`FOLD_TARGET_LANES` lanes, at most 8 panels, each of at least
    ``max(14 * halo, 16)`` rows."""
    if c >= FOLD_TARGET_LANES:
        return 1
    f = min(-(-FOLD_TARGET_LANES // c), 8)
    while f > 1 and (r // f) < max(14 * halo, 2 * 8):
        f -= 1
    return f
