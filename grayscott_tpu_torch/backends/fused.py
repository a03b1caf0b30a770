"""``fused`` rung: the port's ``grayscott_tpu/backends/fused.py``.

A whole batch of steps as one submission. JAX traces the loop of
``stencil.step`` into one executable with ``lax.fori_loop`` under ``jit``
and donated buffers; here the loop of ``ops/stencil.py:step_fast`` is a
CUDA graph on the card, captured once per step count and replayed, that
updates the storage pair in place (``backends/base.py:LoopSimulation``),
and the plain loop on the CPU. The graph replays the same PyTorch
operations as ``regular``, so the two agree bit for bit.

``runtime_weights=True`` (the reference's ``weights-runtime`` feature)
steps ``ops/stencil.py:step_runtime``, whose weights and rates are tensors
on the device that every call refreshes from ``self.params``: new
parameters take effect without a new capture.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops import stencil
from ..params import Parameters
from .base import LoopSimulation


class FusedSimulation(LoopSimulation):
    name = "fused"

    def __init__(self, params: Parameters, boundary: str = "naive",
                 device: str | torch.device = "cuda",
                 runtime_weights: bool = False, **kwargs):
        super().__init__(params, boundary, device)
        self.runtime_weights = runtime_weights
        if runtime_weights:
            self._weights = torch.empty((3, 3), dtype=torch.float32,
                                        device=self.device)
            self._rates = torch.empty((5,), dtype=torch.float32,
                                      device=self.device)

    def step(self, u: torch.Tensor, v: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.runtime_weights:
            return stencil.step_runtime(u, v, self._weights, self._rates,
                                        self.boundary)
        return stencil.step_fast(u, v, self.params, self.boundary)

    def run_steps(self, storage, shape, steps: int):
        if self.runtime_weights:
            self._weights.copy_(torch.from_numpy(
                self.params.weights_array()))
            self._rates.copy_(stencil.rates_array(self.params))
        return super().run_steps(storage, shape, steps)
