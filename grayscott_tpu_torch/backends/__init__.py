"""Backend registry and selector: the port's
``grayscott_tpu/backends/__init__.py``. Six backends: the four plain rungs
of the ladder (``naive``, ``regular``, ``fused``, ``conv``: PyTorch
operations, on the card or the CPU), ``cuda`` (one card, K1-K6) and
``sharded`` (a mesh of shards, K1 or K7). The selector returns
``GRAYSCOTT_BACKEND`` when it is set, as the JAX one does, and else picks
``cuda`` for every shape and on either device; the engine within it is the
backend's own choice (``cuda.auto_engine``). JAX picks ``fused`` where it
finds no TPU; the port never picks a rung by itself, since a rung taken
quietly off the GPU would be a fallback to the CPU, which the port does
not make. ``sharded`` runs when it is asked for (``--backend sharded``):
choosing it by the number of cards comes with the multi-card launch
(ROADMAP.md Queue 1 item 7.3)."""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple, Type

from .base import Simulation
from .conv import ConvSimulation
from .cuda import CudaSimulation
from .fused import FusedSimulation
from .naive import NaiveSimulation
from .regular import RegularSimulation
from .sharded import ShardedSimulation

BACKENDS: Dict[str, Type[Simulation]] = {
    cls.name: cls for cls in (NaiveSimulation, RegularSimulation,
                              FusedSimulation, ConvSimulation,
                              CudaSimulation, ShardedSimulation)}


def best_backend_name(shape: Optional[Tuple[int, int]] = None) -> str:
    """The backend for a domain of ``shape`` (the JAX signature):
    ``GRAYSCOTT_BACKEND`` when it is set, else ``cuda``."""
    return os.environ.get("GRAYSCOTT_BACKEND") or CudaSimulation.name


def get_backend(name: str) -> Type[Simulation]:
    if name not in BACKENDS:
        raise ValueError(
            f"unknown backend {name!r}; available: {sorted(BACKENDS)}")
    return BACKENDS[name]
