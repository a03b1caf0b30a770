"""``conv`` rung: the port's ``grayscott_tpu/backends/conv.py``.

The stencil as a library convolution (``torch.nn.functional.conv2d``, on
the card through cuDNN), the rung that shows the wrong tool for a 3x3
stencil of two species. The zero boundary is the zero-padded convolution
with the corrected weights. The naive boundary convolves with the weights,
subtracts each cell's in-bounds weight sum times the cell (constant but on
the border lines: corrected on the last row and column) and replaces the
first row and column with the exact strips (``ops/stencil.py:
_naive_strips``), as JAX does (``grayscott_tpu/backends/conv.py:57-78``).

cuDNN runs float32 convolutions in TF32 by default, which would put errors
of about 1e-3 into the stencil: the convolution runs with TF32 off. The
batch of steps is one CUDA graph on the card and the plain loop on the
CPU, as in ``fused`` (``backends/base.py:LoopSimulation``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import stencil
from ..params import Parameters
from .base import LoopSimulation


def _edge_ok(n: int) -> np.ndarray:
    """(n, 3) in-bounds indicator of the stencil taps per index."""
    ok = np.ones((n, 3), dtype=np.float32)
    ok[0, 0] = 0.0
    ok[-1, 2] = 0.0
    return ok


class ConvSimulation(LoopSimulation):
    name = "conv"

    def __init__(self, params: Parameters, boundary: str = "naive",
                 device: str | torch.device = "cuda", **kwargs):
        super().__init__(params, boundary, device)
        self._w = params.weights_array()
        self._wsum = np.float32(self._w.sum())
        kernel = self._w if boundary == "naive" else \
            params.corrected_weights()
        self._kernel = torch.from_numpy(kernel)[None, None].to(self.device)
        #: shape -> (last row's correction, last column's), built eagerly
        self._corrections: Dict[Tuple[int, int], tuple] = {}

    def _conv2d(self, x: torch.Tensor) -> torch.Tensor:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            return F.conv2d(x[None, None], self._kernel, padding=1)[0, 0]

    def _correction(self, shape: Tuple[int, int]) -> tuple:
        """``wsum - B`` on the last row (a tensor along it) and on the last
        column (a float), B the in-bounds weight sum."""
        if shape not in self._corrections:
            r, c = shape
            w, wsum = self._w, self._wsum
            b_lastrow = np.einsum("i,ij,cj->c", _edge_ok(r)[-1], w,
                                  _edge_ok(c)).astype(np.float32)
            b_lastcol = np.float32(np.einsum(
                "i,ij,j->", np.ones(3, np.float32), w, _edge_ok(c)[-1]))
            self._corrections[shape] = (
                torch.from_numpy(wsum - b_lastrow).to(self.device),
                float(wsum - b_lastcol))
        return self._corrections[shape]

    def laplacian(self, x: torch.Tensor) -> torch.Tensor:
        if self.boundary == "zero":
            return self._conv2d(x)
        last_row, last_col = self._correction(tuple(x.shape))
        full = self._conv2d(x) - x * float(self._wsum)
        full[-1, :] += x[-1, :] * last_row
        full[1:-1, -1] += x[1:-1, -1] * last_col
        return stencil._patch_strips(full,
                                     *stencil._naive_strips(x, self.params))

    def step(self, u: torch.Tensor, v: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        return stencil.reaction(u, v, self.laplacian(u), self.laplacian(v),
                                self.params)
