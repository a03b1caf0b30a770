"""U/V species state on a torch device.

The port's ``grayscott_tpu/species.py``, with its own copy of
``initial_uv``. The state lives in backend-specific ``storage``;
:meth:`Species.result` is V's current concentration as a device tensor
(with several processes, this process's block of it), and the ``*_host``
methods copy the whole domain to the host through
``utils/distributed.py:fetch``, after an explicit synchronisation: with
several processes a collective call, which every process makes
(``grayscott_tpu/species.py:90-103``).
"""

from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from .params import Precision
from .utils.distributed import fetch


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


class Species:
    """Chemical species state bound to a backend's storage layout.

    Construct through ``Simulation.make_species(shape)``."""

    def __init__(self, shape: Tuple[int, int], storage: Any, backend: Any):
        self.shape = tuple(shape)
        self.storage = storage
        self._backend = backend
        self.steps_performed = 0

    def result(self) -> torch.Tensor:
        """V's current concentration, a device tensor of ``shape`` (with
        several processes, this process's block: ``blocks()``). It views
        the live state: the next steps overwrite it."""
        return self._backend.extract_result(self.storage, self.shape)

    def blocks(self):
        """How the processes' results tile the domain
        (``utils/distributed.py:Blocks``), or None where each is whole."""
        return self._backend.blocks(self.shape)

    def result_host(self) -> np.ndarray:
        """Host copy of the result, after the device has finished; with
        several processes collective (every process calls it)."""
        return fetch(self.result(), self.blocks())

    def uv_host(self) -> Tuple[np.ndarray, np.ndarray]:
        """Host copies of both concentrations; with several processes
        collective."""
        u, v = self._backend.extract_uv(self.storage, self.shape)
        blocks = self.blocks()
        return fetch(u, blocks), fetch(v, blocks)
