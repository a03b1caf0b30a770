"""``regular`` rung: the port's ``grayscott_tpu/backends/regular.py``.

The shift algebra of ``ops/stencil.py:step_fast`` (the separable pass,
the in-bounds weight sums and, on the naive boundary, the exact edge
strips), one step per host call: each of its PyTorch operations is a
launch of its own.
"""

from __future__ import annotations

from .base import StepwiseSimulation


class RegularSimulation(StepwiseSimulation):
    name = "regular"
