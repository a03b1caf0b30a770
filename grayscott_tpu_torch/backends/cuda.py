"""``cuda`` backend: the port's ``grayscott_tpu/backends/pallas.py``, with
its three f32 engines.

- ``windowed`` (K1, ``ops/windowed.py``): storage ``("windowed", u, v,
  u_next, v_next)``, plain ``(R, C)`` tensors, no padding (the kernel masks
  the domain edge itself). ``run_steps`` makes ``divmod(steps, K)`` full
  launches and one remainder launch (``backends/pallas.py:858-887``); each
  reads ``(u, v)`` and writes ``(u_next, v_next)``, then the pairs swap.
- ``resident`` (K3, ``ops/resident.py``): storage ``("resident", u, v,
  u_next, v_next)`` in the same layout; one launch per ``run_steps``, the
  step count a run-time argument (``backends/pallas.py:843-857``).
- ``mega`` (K2, ``ops/megakernel.py``): storage ``("mega", u_pair,
  v_pair)``, ``(2, R, C)`` pairs with slot 0 current, updated in place.
  ``run_steps`` makes one launch of ``steps // 8`` time blocks and one
  remainder launch of one block of ``steps % 8`` steps
  (``backends/pallas.py:793-816``).

The buffers are updated in place, where the JAX backend gets fresh
(donated) buffers from every call. ``engine`` (``auto|windowed|mega``) and
``resident`` (``auto|on|off``) take the JAX backend's names and values;
``auto`` follows :func:`auto_engine`, measured on the card. The JAX
backend's other knobs (bf16 storage, lane fold, packed layout, the naive
fix-up modes, the megakernel's ring depth and specialisation, tile pins)
are not ported: asking for one raises :class:`UnsupportedConfigError`.
"""

from __future__ import annotations

import argparse
from typing import Tuple

import numpy as np
import torch

from ..errors import UnsupportedConfigError
from ..ops import megakernel, resident, windowed
from ..params import Parameters, kernel_constants
from .base import Simulation

ENGINES = ("auto", "windowed", "mega")
RESIDENT = ("auto", "on", "off")

#: knob -> the values the port runs (the JAX backend's names and values)
_SUPPORTED = {
    "dtype": ("float32",),
    "fold": ("auto", "off", 1),
    "pack": ("auto", "off"),
    "naive_fix": ("select",),
    "mega_depth": (None,),
    "mega_specialize": (None,),
    "block_rows": (None,),
    "block_cols": (None,),
}

#: L2 of an H100 (NVIDIA's data sheet), and the share of it that the four
#: state buffers (U, V and their next step, f32) may fill in the "fits in
#: L2" class of :func:`auto_engine`; the rest is left to what the launch
#: and the snapshot copy bring in
L2_BYTES = 50 * 10 ** 6
L2_SHARE = 0.75

#: (shape class, boundary) -> the engines, fastest first (see auto_engine)
_RANKING = {
    ("l2", "naive"): ("resident", "windowed", "mega"),
    ("l2", "zero"): ("windowed", "mega", "resident"),
    ("larger", "naive"): ("resident", "windowed", "mega"),
    ("larger", "zero"): ("windowed", "mega", "resident"),
}


def shape_class(shape: Tuple[int, int]) -> str:
    """``"l2"`` when the four f32 state buffers fit the L2 share, else
    ``"larger"``."""
    r, c = shape
    return "l2" if 4 * r * c * 4 <= L2_SHARE * L2_BYTES else "larger"


def auto_engine(shape: Tuple[int, int], boundary: str,
                resident_ok: bool = True) -> str:
    """The engine that ``engine='auto'`` runs: the fastest of the three for
    the shape's class and the boundary, as measured on the card.
    ``resident_ok=False`` (the ``resident='off'`` knob) skips K3.

    Set from ``chip_smoke.py``'s engine times (32 steps a call through the
    backend, CUDA events; NVIDIA H100 80GB HBM3, power limit 700.00 W),
    ms per 32 steps, windowed / resident / mega:

    - 1080x1920 ("l2"): naive 1.2631 / 1.2490 / 1.6046, zero
      0.7808 / 0.9519 / 0.9395;
    - 4096x4096 ("larger"): naive 9.6143 / 8.7977 / 11.5039, zero
      5.9676 / 6.9794 / 6.7183.

    Both classes rank alike: K3 first on the naive boundary, whose costly
    per-cell arithmetic gains most from K3's lack of halo recompute; K1
    first on the zero boundary, where K3's barrier and reload a step cost
    more than K1's recompute. K2 is not first anywhere.
    """
    return next(e for e in _RANKING[shape_class(shape), boundary]
                if resident_ok or e != "resident")


class CudaSimulation(Simulation):
    name = "cuda"

    def __init__(self, params: Parameters, boundary: str = "naive",
                 device: str | torch.device = "cuda", engine: str = "auto",
                 resident: str = "auto", dtype: str = "float32",
                 fold: str | int = "auto", pack: str = "auto",
                 naive_fix: str = "select", mega_depth: int | None = None,
                 mega_specialize: bool | None = None,
                 block_rows: int | None = None,
                 block_cols: int | None = None):
        super().__init__(params, boundary, device)
        if engine not in ENGINES:
            raise ValueError(f"engine must be one of {ENGINES}, got "
                             f"{engine!r}")
        if resident not in RESIDENT:
            raise ValueError(f"resident must be one of {RESIDENT}, got "
                             f"{resident!r}")
        if resident == "on" and engine != "auto":
            raise UnsupportedConfigError(
                "resident='on' and an explicit engine pin conflict; pin at "
                "most one of them", combo="resident+engine")
        knobs = dict(dtype=dtype, fold=fold, pack=pack, naive_fix=naive_fix,
                     mega_depth=mega_depth, mega_specialize=mega_specialize,
                     block_rows=block_rows, block_cols=block_cols)
        for knob, value in knobs.items():
            if value not in _SUPPORTED[knob]:
                raise UnsupportedConfigError(
                    f"{knob}={value!r} is not ported to the cuda backend "
                    f"yet; it runs {knob} in {_SUPPORTED[knob]}",
                    combo=knob)
        self.engine = engine
        self.resident = resident
        self.consts = kernel_constants(params)

    def engine_for(self, shape: Tuple[int, int]) -> str:
        """The engine that runs a domain of ``shape``: a pin, else
        :func:`auto_engine`."""
        if self.engine != "auto":
            return self.engine
        if self.resident == "on":
            return "resident"
        return auto_engine(shape, self.boundary,
                           resident_ok=self.resident == "auto")

    def build_storage(self, u: np.ndarray, v: np.ndarray):
        u_t, v_t = (
            torch.from_numpy(np.array(x, dtype=np.float32, order="C"))
            .to(self.device) for x in (u, v))
        engine = self.engine_for(u.shape)
        if engine == "mega":
            return ("mega", megakernel.pair_state(u_t),
                    megakernel.pair_state(v_t))
        return (engine, u_t, v_t, torch.empty_like(u_t),
                torch.empty_like(v_t))

    def extract_uv(self, storage, shape) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
        if storage[0] == "mega":
            return storage[1][0], storage[2][0]
        return storage[1], storage[2]

    def run_steps(self, storage, shape, steps: int):
        if storage[0] == "mega":
            _, u_pair, v_pair = storage
            n_full, rem = divmod(steps, megakernel.MEGA_STEPS)
            if n_full:
                megakernel.megastep(u_pair, v_pair, n_full,
                                    megakernel.MEGA_STEPS, self.consts,
                                    self.boundary)
            if rem:
                megakernel.megastep(u_pair, v_pair, 1, rem, self.consts,
                                    self.boundary)
            return storage
        if storage[0] == "resident":
            if steps == 0:
                return storage
            return ("resident", *resident.multistep(
                *storage[1:], steps, self.consts, self.boundary))
        _, u, v, u_next, v_next = storage
        n_full, rem = divmod(steps, windowed.K)
        for k in [windowed.K] * n_full + ([rem] if rem else []):
            windowed.multistep(u, v, u_next, v_next, k, self.consts,
                               self.boundary)
            u, v, u_next, v_next = u_next, v_next, u, v
        return ("windowed", u, v, u_next, v_next)

    # -- CLI -----------------------------------------------------------------

    @classmethod
    def add_cli_args(cls, parser: argparse.ArgumentParser) -> None:
        """The JAX backend's engine flags, under its names."""
        parser.add_argument(
            "--pallas-engine", choices=ENGINES, default="auto",
            help="Kernel engine: 'mega' runs the whole step loop in one "
            "persistent launch (K2); 'windowed' launches K1 every 8 steps; "
            "'auto' (default) picks by domain size, as measured on the card",
        )
        parser.add_argument(
            "--pallas-resident", choices=RESIDENT, default="auto",
            help="Resident engine (K3: every step of a run in one "
            "persistent launch, the state in L2): 'on' forces it, 'off' "
            "never runs it, 'auto' (default) lets the engine choice decide",
        )

    @classmethod
    def args_from_namespace(cls, ns: argparse.Namespace) -> dict:
        return {"engine": getattr(ns, "pallas_engine", "auto"),
                "resident": getattr(ns, "pallas_resident", "auto")}
