"""Backend contract: the port's ``grayscott_tpu/backends/base.py:49-112``.

A backend owns the storage layout of the state on its ``device``
(``build_storage``: host numpy arrays to device tensors, the carry-over of
the state into the port) and the stepping. ``prepare_steps`` only enqueues
work on the device's current stream; ``block_until_ready`` waits for it.
The device is explicit: nothing picks one behind the caller's back.
"""

from __future__ import annotations

import abc
import argparse
from typing import Any, Tuple

import numpy as np
import torch

from ..ops.stencil import BOUNDARIES
from ..params import Parameters
from ..species import Species, initial_uv


class Simulation(abc.ABC):
    """One compute backend."""

    #: registry name
    name: str = "?"

    def __init__(self, params: Parameters, boundary: str = "naive",
                 device: str | torch.device = "cuda"):
        if boundary not in BOUNDARIES:
            raise ValueError(f"unknown boundary semantics {boundary!r}")
        self.params = params
        self.boundary = boundary
        self.device = torch.device(device)

    def make_species(self, shape: Tuple[int, int]) -> Species:
        """The standard initial state (``initial_uv``) in this layout."""
        u, v = initial_uv(shape)
        return Species(shape, self.build_storage(u, v), self)

    @abc.abstractmethod
    def build_storage(self, u: np.ndarray, v: np.ndarray) -> Any:
        """Pack host (R, C) float32 concentrations into device storage."""

    @abc.abstractmethod
    def extract_uv(self, storage: Any, shape) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
        """The (u, v) device tensors of ``shape`` held by ``storage``."""

    def extract_result(self, storage: Any, shape) -> torch.Tensor:
        """V's concentration (the simulation result)."""
        return self.extract_uv(storage, shape)[1]

    @abc.abstractmethod
    def run_steps(self, storage: Any, shape, steps: int) -> Any:
        """Enqueue ``steps`` steps; returns the new storage."""

    def perform_steps(self, species: Species, steps: int) -> None:
        """Step and wait for the device."""
        self.prepare_steps(species, steps)
        self.block_until_ready(species)

    def prepare_steps(self, species: Species, steps: int) -> None:
        """Enqueue ``steps`` steps and return without waiting."""
        species.storage = self.run_steps(species.storage, species.shape,
                                         steps)
        species.steps_performed += steps

    @classmethod
    def add_cli_args(cls, parser: argparse.ArgumentParser) -> None:
        """The backend's own command-line arguments."""

    @classmethod
    def args_from_namespace(cls, ns: argparse.Namespace) -> dict:
        """The constructor's keyword arguments from those arguments."""
        return {}

    def block_until_ready(self, species: Species) -> None:
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
