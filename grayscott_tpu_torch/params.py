"""Simulation parameters, and their carry-over into the port's kernels.

``Parameters`` and the stencil and preset tables are the port's own copy of
``grayscott_tpu/params.py``, trimmed to what the port uses (the reference's
parameter set, ``data/src/parameters.rs``). :func:`kernel_constants` turns
a ``Parameters`` into the float32 numbers that the plain PyTorch step and
the CUDA kernels all take at run time.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np

#: Floating-point precision of the simulation
Precision = np.float32

WeightsT = Tuple[Tuple[float, float, float], ...]

#: The four selectable 3x3 stencils, row-major
STENCILS: dict[str, WeightsT] = {
    # optimally isotropic discretisation of the Laplacian; the default
    "oono-puri": (
        (0.25, 0.5, 0.25),
        (0.5, 0.0, 0.5),
        (0.25, 0.5, 0.25),
    ),
    # all-ones stencil of the course's C++ version
    "pretty": (
        (1.0, 1.0, 1.0),
        (1.0, 1.0, 1.0),
        (1.0, 1.0, 1.0),
    ),
    # rotationally invariant, smallest error around the origin
    "patra-karttunen": (
        (1.0 / 6.0, 4.0 / 6.0, 1.0 / 6.0),
        (4.0 / 6.0, 0.0, 4.0 / 6.0),
        (1.0 / 6.0, 4.0 / 6.0, 1.0 / 6.0),
    ),
    # computationally simpler but anisotropic
    "5points": (
        (0.0, 1.0, 0.0),
        (1.0, 0.0, 1.0),
        (0.0, 1.0, 0.0),
    ),
}

DEFAULT_STENCIL = "oono-puri"

#: Named (feed_rate, kill_rate) pattern presets (Pearson's regime map)
PRESETS: dict[str, Tuple[float, float]] = {
    "reference": (0.014, 0.054),
    "solitons": (0.030, 0.062),
    "mitosis": (0.0367, 0.0649),
    "coral": (0.0545, 0.062),
    "maze": (0.029, 0.057),
    "worms": (0.058, 0.065),
    "waves": (0.014, 0.045),
    "u-skate": (0.062, 0.061),
    "chaos": (0.026, 0.051),
}


@dataclasses.dataclass(frozen=True)
class Parameters:
    """Gray-Scott simulation parameters (the reference's defaults)."""

    weights: WeightsT = STENCILS[DEFAULT_STENCIL]
    diffusion_rate_u: float = 0.1
    diffusion_rate_v: float = 0.05
    feed_rate: float = 0.014
    kill_rate: float = 0.054
    time_step: float = 1.0

    @classmethod
    def with_stencil(cls, name: str = DEFAULT_STENCIL,
                     **kwargs) -> "Parameters":
        if name not in STENCILS:
            raise ValueError(
                f"unknown stencil {name!r}; available: {sorted(STENCILS)}")
        return cls(weights=STENCILS[name], **kwargs)

    @classmethod
    def with_preset(cls, name: str, stencil: str = DEFAULT_STENCIL,
                    **kwargs) -> "Parameters":
        """Parameters of a named preset (:data:`PRESETS`); explicit
        ``feed_rate``/``kill_rate`` kwargs override the preset's pair."""
        if name not in PRESETS:
            raise ValueError(
                f"unknown preset {name!r}; available: {sorted(PRESETS)}")
        f, k = PRESETS[name]
        kwargs.setdefault("feed_rate", f)
        kwargs.setdefault("kill_rate", k)
        return cls.with_stencil(stencil, **kwargs)

    def weights_array(self) -> np.ndarray:
        """Stencil weights as a float32 (3, 3) array."""
        return np.asarray(self.weights, dtype=Precision)

    def min_feed_kill(self) -> Precision:
        """The ``-(feed_rate + kill_rate)`` prefactor of the dv update."""
        return Precision(-(Precision(self.feed_rate)
                           + Precision(self.kill_rate)))

    def stencil_name(self) -> str:
        for name, w in STENCILS.items():
            if w == self.weights:
                return name
        return "custom"


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
