"""Backend registry and selector: the port's
``grayscott_tpu/backends/__init__.py``. The port has one backend so far,
``cuda``, and the selector picks it for every shape; the engine within it
is the backend's own choice (``cuda.auto_engine``)."""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Type

from .base import Simulation
from .cuda import CudaSimulation

BACKENDS: Dict[str, Type[Simulation]] = {CudaSimulation.name: CudaSimulation}


def best_backend_name(shape: Optional[Tuple[int, int]] = None) -> str:
    """The backend for a domain of ``shape`` (the JAX signature)."""
    return CudaSimulation.name


def get_backend(name: str) -> Type[Simulation]:
    if name not in BACKENDS:
        raise ValueError(
            f"unknown backend {name!r}; available: {sorted(BACKENDS)}")
    return BACKENDS[name]
