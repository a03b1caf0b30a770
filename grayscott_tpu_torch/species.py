"""U/V species state on a torch device.

The port's ``grayscott_tpu/species.py:62-103``. ``initial_uv`` is the JAX
package's own (numpy only). The state lives in backend-specific
``storage``; :meth:`Species.result` is V's current concentration as a
device tensor, and the ``*_host`` methods copy to the host after an
explicit synchronisation.
"""

from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from grayscott_tpu.species import initial_uv  # noqa: F401  (re-export)


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
