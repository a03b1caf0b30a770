"""``naive`` rung: the port's ``grayscott_tpu/backends/naive.py``.

Plain ``(u, v)`` storage, one step per host call, on the oracle's
expression tree (``ops/stencil.py:step``): bitwise to ``oracle.step`` on
the CPU, and to the ``cuda`` backend's kernels on the card, on both
boundaries. (JAX's naive rung takes its exact gather path on the naive
boundary only; on the zero boundary it steps the shift algebra.)
"""

from __future__ import annotations

from .base import StepwiseSimulation


class NaiveSimulation(StepwiseSimulation):
    name = "naive"
    exact = True
