"""U/V species state on a torch device.

The port's ``grayscott_tpu/species.py``, with its own copy of
``initial_uv``. The state lives in backend-specific ``storage``;
:meth:`Species.result` is V's current concentration as a device tensor,
and the ``*_host`` methods copy to the host after an explicit
synchronisation.
"""

from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from .params import Precision


def initial_uv(shape: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray]:
    """The reference's initial state (``Species::new``): U = 1 and V = 0,
    except a central box where U = 0 and V = 1. The box spans rows
    ``[7R/16 - 4, 8R/16 - 4)`` and columns ``[7C/16, 8C/16)`` (integer
    division, saturating at 0)."""
    u = np.ones(shape, dtype=Precision)
    v = np.zeros(shape, dtype=Precision)
    box = tuple(slice(max(n * 7 // 16 - shift, 0), max(n * 8 // 16 - shift, 0))
                for n, shift in zip(shape, (4, 0)))
    u[box] = Precision(0.0)
    v[box] = Precision(1.0)
    return u, v


def to_host(x: torch.Tensor) -> np.ndarray:
    """A host copy of ``x`` that later steps cannot overwrite."""
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
    return x.to("cpu", copy=True).numpy()


class Species:
    """Chemical species state bound to a backend's storage layout.

    Construct through ``Simulation.make_species(shape)``."""

    def __init__(self, shape: Tuple[int, int], storage: Any, backend: Any):
        self.shape = tuple(shape)
        self.storage = storage
        self._backend = backend
        self.steps_performed = 0

    def result(self) -> torch.Tensor:
        """V's current concentration, a device tensor of ``shape``. It
        views the live state: the next steps overwrite it."""
        return self._backend.extract_result(self.storage, self.shape)

    def result_host(self) -> np.ndarray:
        """Host copy of the result, after the device has finished."""
        return to_host(self.result())

    def uv_host(self) -> Tuple[np.ndarray, np.ndarray]:
        """Host copies of both concentrations."""
        u, v = self._backend.extract_uv(self.storage, self.shape)
        return to_host(u), to_host(v)
