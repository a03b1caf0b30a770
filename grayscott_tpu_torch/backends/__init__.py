"""Backend registry and selector: the port's
``grayscott_tpu/backends/__init__.py``. Two backends: ``cuda`` (one card,
K1-K6) and ``sharded`` (a mesh of shards, K7). The selector returns
``GRAYSCOTT_BACKEND`` when it is set, as the JAX one does, and else picks
``cuda`` for every shape; the engine within it is the backend's own choice
(``cuda.auto_engine``). ``sharded`` runs when it is asked for
(``--backend sharded``): choosing it by the number of cards comes with the
multi-card launch (ROADMAP.md Queue 1 item 7)."""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple, Type

from .base import Simulation
from .cuda import CudaSimulation
from .sharded import ShardedSimulation

BACKENDS: Dict[str, Type[Simulation]] = {
    cls.name: cls for cls in (CudaSimulation, ShardedSimulation)}


def best_backend_name(shape: Optional[Tuple[int, int]] = None) -> str:
    """The backend for a domain of ``shape`` (the JAX signature):
    ``GRAYSCOTT_BACKEND`` when it is set, else ``cuda``."""
    return os.environ.get("GRAYSCOTT_BACKEND") or CudaSimulation.name


def get_backend(name: str) -> Type[Simulation]:
    if name not in BACKENDS:
        raise ValueError(
            f"unknown backend {name!r}; available: {sorted(BACKENDS)}")
    return BACKENDS[name]
