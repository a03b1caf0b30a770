"""Simulation parameters, and their carry-over into the port's kernels.

``Parameters`` and the stencil tables are the JAX package's own
(``grayscott_tpu/params.py``, numpy only), re-exported here.
:func:`kernel_constants` turns a ``Parameters`` into the float32 numbers
that the plain PyTorch step and the CUDA kernel both take at run time.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

from grayscott_tpu.params import (  # noqa: F401  (re-exports)
    DEFAULT_STENCIL,
    PRESETS,
    STENCILS,
    Parameters,
    Precision,
)


class KernelConstants(NamedTuple):
    """Run-time constants of one Gray-Scott step, each exactly a float32.

    ``weights``: the 9 stencil weights, row-major. ``reaction``:
    ``(Du, Dv, f, -(f+k), dt)``.
    """

    weights: Tuple[float, ...]
    reaction: Tuple[float, ...]


def kernel_constants(params: Parameters) -> KernelConstants:
    """The float32 constants of ``params``, rounded exactly as the first
    five entries of the JAX kernel's reaction operand
    (``grayscott_tpu/ops/pallas_stencil.py:reaction_operand``).

    Python floats that hold float32 values: a float32 tensor times one of
    them computes in float32, so the plain step rounds as the oracle does.
    """
    weights = tuple(float(w) for w in params.weights_array().reshape(-1))
    reaction = (
        Precision(params.diffusion_rate_u),
        Precision(params.diffusion_rate_v),
        Precision(params.feed_rate),
        params.min_feed_kill(),
        Precision(params.time_step),
    )
    return KernelConstants(weights, tuple(float(x) for x in reaction))
