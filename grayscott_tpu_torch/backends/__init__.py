"""Backend registry and selector: the port's
``grayscott_tpu/backends/__init__.py``. The port has one backend so far,
``cuda``, and ``auto`` resolves to it."""

from __future__ import annotations

from typing import Dict, Type

from .base import Simulation
from .cuda import CudaSimulation

BACKENDS: Dict[str, Type[Simulation]] = {CudaSimulation.name: CudaSimulation}


def best_backend_name() -> str:
    return CudaSimulation.name


def get_backend(name: str) -> Type[Simulation]:
    if name not in BACKENDS:
        raise ValueError(
            f"unknown backend {name!r}; available: {sorted(BACKENDS)}")
    return BACKENDS[name]
