"""Backend contract: the port's ``grayscott_tpu/backends/base.py:49-152``.

A backend owns the storage layout of the state on its ``device``
(``build_storage``: host numpy arrays to device tensors, the carry-over of
the state into the port) and the stepping. ``prepare_steps`` only enqueues
work on the device's current stream; ``block_until_ready`` waits for it.
The device is explicit: nothing picks one behind the caller's back.

Two bases serve the plain rungs of the ladder, whose storage is a plain
``(u, v)`` pair on the device: :class:`StepwiseSimulation` dispatches one
step per host call (``naive``, ``regular``), :class:`LoopSimulation` a
whole batch of steps as one submission (``fused``, ``conv``): on the card
a CUDA graph of the step loop, the counterpart of JAX's ``lax.fori_loop``
under ``jit``; on the CPU the plain loop.
"""

from __future__ import annotations

import abc
import argparse
import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..ops import stencil
from ..ops.stencil import BOUNDARIES
from ..params import Parameters, kernel_constants
from ..species import Species, initial_uv


def env_default(name: str, fallback, cast=None, choices=None):
    """A CLI default from the environment variable ``name``, else
    ``fallback`` (``grayscott_tpu/backends/base.py:31``). ``choices``: a
    value outside them stops the program (argparse checks only what is
    typed on the command line)."""
    raw = os.environ.get(name)
    if raw is None:
        return fallback
    if choices is not None and raw not in choices:
        raise SystemExit(f"{name}={raw!r}: expected one of {list(choices)}")
    return (cast or type(fallback))(raw)


def env_flag(name: str) -> bool:
    """A boolean ``GRAYSCOTT_*`` variable (``grayscott_tpu/utils/
    runtime.py:env_flag``): '', '0', 'false', 'no' and 'off' are off (in any
    case), anything else is on, so ``GRAYSCOTT_AUTOTUNE=0`` is off."""
    return os.environ.get(name, "").strip().lower() not in (
        "", "0", "false", "no", "off")


#: the names of the storage dtypes (``grayscott_tpu/backends/pallas.py:
#: 181-188``) -> the dtype's own name, which is torch's
DTYPE_ALIASES = {None: "float32", "float32": "float32", "f32": "float32",
                 "bfloat16": "bfloat16", "bf16": "bfloat16"}


def storage_dtype(name) -> str:
    """The storage dtype ``name`` asks for, ``"float32"`` or
    ``"bfloat16"``; ValueError for another."""
    if name not in DTYPE_ALIASES:
        raise ValueError(f"unsupported dtype {name!r}")
    return DTYPE_ALIASES[name]


#: on (:func:`env_flag`) when a simulation is built, its every
#: ``prepare_steps`` checks the state for NaN and Inf (``utils/runtime.py``)
DEBUG_VAR = "GRAYSCOTT_DEBUG"


class Simulation(abc.ABC):
    """One compute backend."""

    #: registry name
    name: str = "?"
    #: whether ``extract_result`` returns a tensor of its own, which no
    #: later step writes (a widened bf16 state, a reassembled sharded one):
    #: a snapshot of it need not be copied again
    fresh_result: bool = False

    def __init__(self, params: Parameters, boundary: str = "naive",
                 device: str | torch.device = "cuda"):
        if boundary not in BOUNDARIES:
            raise ValueError(f"unknown boundary semantics {boundary!r}")
        self.params = params
        self.boundary = boundary
        self.device = torch.device(device)
        #: check the state for NaN and Inf after every prepare_steps
        self.debug = env_flag(DEBUG_VAR)

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
        """Enqueue ``steps`` steps and return without waiting (with
        :attr:`debug` on, wait and check the state)."""
        species.storage = self.run_steps(species.storage, species.shape,
                                         steps)
        species.steps_performed += steps
        if self.debug:
            self.check_finite(species)

    def check_finite(self, species: Species) -> None:
        """Raise ``FloatingPointError`` when U or V holds a NaN or an Inf
        (``GRAYSCOTT_DEBUG``, the counterpart of JAX's ``jax_debug_nans``
        and ``jax_debug_infs``). Reading the answer synchronises."""
        for name, x in zip("UV", self.extract_uv(species.storage,
                                                 species.shape)):
            if not bool(torch.isfinite(x).all()):
                raise FloatingPointError(
                    f"{DEBUG_VAR}: {name} holds a NaN or an Inf on the "
                    f"{self.name} backend after {species.steps_performed} "
                    "steps")

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


class PairSimulation(Simulation):
    """A rung whose storage is a plain ``(u, v)`` pair of (R, C) float32
    tensors on ``self.device``. Like JAX's rungs it accepts and ignores
    keyword arguments it does not know (the harness passes ``engine=`` to
    every backend it sweeps)."""

    def __init__(self, params: Parameters, boundary: str = "naive",
                 device: str | torch.device = "cuda", **kwargs):
        super().__init__(params, boundary, device)

    def build_storage(self, u: np.ndarray, v: np.ndarray):
        return tuple(torch.from_numpy(np.array(x, dtype=np.float32,
                                               order="C")).to(self.device)
                     for x in (u, v))

    def extract_uv(self, storage, shape) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
        return storage


class StepwiseSimulation(PairSimulation):
    """One step per host call (the reference's ``SimulateStep`` loop,
    ``grayscott_tpu/backends/base.py:115-152``). :attr:`exact` picks the
    oracle's tree (``stencil.step``, bitwise to ``oracle.step`` on both
    boundaries) over the shift algebra (``stencil.step_fast``)."""

    #: step on the oracle's tree instead of the shift algebra
    exact = False

    def __init__(self, params: Parameters, boundary: str = "naive",
                 device: str | torch.device = "cuda", **kwargs):
        super().__init__(params, boundary, device)
        self.consts = kernel_constants(params)

    def step(self, u: torch.Tensor, v: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.exact:
            return stencil.step(u, v, self.consts, self.boundary)
        return stencil.step_fast(u, v, self.params, self.boundary)

    def run_steps(self, storage, shape, steps: int):
        u, v = storage
        for _ in range(steps):
            u, v = self.step(u, v)
        return (u, v)


class LoopSimulation(PairSimulation):
    """``steps`` steps as one submission. On the card the loop of
    :meth:`step` is captured once per step count as a CUDA graph, which
    reads the storage pair and writes its result back into it, so the
    graph's static buffers are the state; later calls replay it. A graph
    holds the addresses of the storage it was captured on, so new storage
    (``make_species``, ``--resume``) captures anew. A capture that fails
    raises. On the CPU the same loop runs eagerly."""

    def __init__(self, params: Parameters, boundary: str = "naive",
                 device: str | torch.device = "cuda", **kwargs):
        super().__init__(params, boundary, device)
        #: step count -> graph, all captured on ``_graph_storage``
        self._graphs: Dict[int, Any] = {}
        self._graph_storage = None
        #: captures made (each a new step count or new storage)
        self.captures = 0

    @abc.abstractmethod
    def step(self, u: torch.Tensor, v: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One step; new tensors."""

    def loop(self, u: torch.Tensor, v: torch.Tensor, steps: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``steps`` calls of :meth:`step`."""
        for _ in range(steps):
            u, v = self.step(u, v)
        return u, v

    def run_steps(self, storage, shape, steps: int):
        if steps == 0:
            return storage
        if self.device.type != "cuda":
            return self.loop(*storage, steps)
        self._graph_for(storage, steps).replay()
        return storage

    def _graph_for(self, storage, steps: int):
        u, v = storage
        key = (tuple(u.shape), u.data_ptr(), v.data_ptr())
        if key != self._graph_storage:
            self._graphs.clear()
            self._graph_storage = key
        graph = self._graphs.get(steps)
        if graph is None:
            graph = self._graphs[steps] = self._capture(u, v, steps)
        return graph

    def _capture(self, u: torch.Tensor, v: torch.Tensor, steps: int):
        """The graph of ``steps`` steps of (u, v), written back in place.
        One warm-up step on copies, on a side stream, first: it builds the
        step's constants and library handles, which a capture cannot."""
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self.step(u.clone(), v.clone())
        current.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            nu, nv = self.loop(u, v, steps)
            u.copy_(nu)
            v.copy_(nv)
        self.captures += 1
        return graph
