"""``cuda`` backend: the port's ``grayscott_tpu/backends/pallas.py``, with
its three f32 engines, on two layouts.

The unpacked layout (``pack`` ``auto`` or ``off``), both boundaries:

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

The species-packed layout (``pack="on"``; ``ops/packed.py``): U and V side
by side in one ``(R, 2C)`` tensor ``[U | V]``, the JAX zero path's
separable step and linear fold (``backends/pallas.py:503-583``,
``:747-792``). ``pack="on"`` needs the zero boundary, float32, a separable
stencil (not ``5points``) and no tile pins, or it raises
:class:`UnsupportedConfigError` naming ``pack``. Its engines:

- ``windowed`` (K4, ``ops/packed.py:multistep``): storage ``("packed", x,
  x_next)``; ``divmod(steps, 8)`` launches as K1's;
- ``resident`` (K5, ``ops/packed.py:resident_multistep``): storage
  ``("respack", x, x_next)``; one launch per ``run_steps``;
- ``mega`` (K6, ``ops/megakernel.py:packed_megastep``): storage
  ``("megapack", x_pair)``, a ``(2, R, 2C)`` pair; one launch of the full
  time blocks and one of the remainder, as K2's.

``pack="auto"`` never packs: the JAX backend packs on ``auto`` only on an
autotune record, and the port has no autotuner.

The buffers are updated in place, where the JAX backend gets fresh
(donated) buffers from every call. ``engine`` (``auto|windowed|mega``),
``resident`` (``auto|on|off``) and ``pack`` (``auto|on|off``) take the JAX
backend's names and values; ``auto`` follows :func:`auto_engine`, or
:func:`auto_packed_engine` on the packed layout, measured on the card. The
JAX backend's other knobs (bf16 storage, lane fold, the naive fix-up
modes, the megakernel's ring depth and specialisation, tile pins) are not
ported: asking for one raises :class:`UnsupportedConfigError`.
"""

from __future__ import annotations

import argparse
from typing import Tuple

import numpy as np
import torch

from ..errors import UnsupportedConfigError
from ..ops import megakernel, packed, resident, windowed
from ..params import Parameters, kernel_constants, packed_constants
from .base import Simulation, env_default

ENGINES = ("auto", "windowed", "mega")
RESIDENT = ("auto", "on", "off")
PACK = ("auto", "on", "off")

#: knob -> the values the port runs (the JAX backend's names and values)
_SUPPORTED = {
    "dtype": ("float32",),
    "fold": ("auto", "off", 1),
    # "on" only on the zero boundary with a separable stencil
    "pack": PACK,
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
    ("l2", "zero"): ("windowed", "resident", "mega"),
    ("larger", "naive"): ("windowed", "resident", "mega"),
    ("larger", "zero"): ("windowed", "resident", "mega"),
}


def shape_class(shape: Tuple[int, int]) -> str:
    """``"l2"`` when the four f32 state buffers fit the L2 share, else
    ``"larger"``."""
    r, c = shape
    return "l2" if 4 * r * c * 4 <= L2_SHARE * L2_BYTES else "larger"


#: engine -> storage tag on the packed layout
PACKED_TAGS = {"windowed": "packed", "resident": "respack",
                "mega": "megapack"}

#: shape class -> the packed engines, fastest first (see auto_packed_engine)
_PACKED_RANKING = {
    "l2": ("windowed", "mega", "resident"),
    "larger": ("windowed", "mega", "resident"),
}


def auto_engine(shape: Tuple[int, int], boundary: str,
                resident_ok: bool = True) -> str:
    """The engine that ``engine='auto'`` runs: the fastest of the three for
    the shape's class and the boundary, as measured on the card.
    ``resident_ok=False`` (the ``resident='off'`` knob) skips K3.

    Set from ``chip_smoke.py``'s engine times (phase 6a: 32 steps a call
    through the backend, CUDA events, in turns; NVIDIA H100 80GB HBM3,
    power limit 700.00 W), ms per 32 steps, windowed / resident / mega,
    with K1 and K3 on the Hopper tile stepper (``csrc/gs_tile_sm90.cuh``):

    - 1080x1920 ("l2"): naive 0.5699 / 0.5568 / 1.6159, zero
      0.3696 / 0.4827 / 0.9440;
    - 4096x4096 ("larger"): naive 2.9680 / 4.3315 / 11.5723, zero
      2.5470 / 4.0544 / 6.7628.

    K1 is first everywhere but on the naive boundary while the state fits
    L2, where K3, with no halo recompute, leads it by 2 %. Beyond L2 K3
    passes the whole state through HBM every step, which K1 does every 8.
    K2 (still on the first stepper) is last everywhere.
    """
    return next(e for e in _RANKING[shape_class(shape), boundary]
                if resident_ok or e != "resident")


def auto_packed_engine(shape: Tuple[int, int],
                       resident_ok: bool = True) -> str:
    """The engine that ``engine='auto'`` runs on the packed layout (zero
    boundary only): the fastest of K4, K5 and K6 for the shape's class, as
    measured on the card. ``resident_ok=False`` skips K5.

    Set from ``chip_smoke.py``'s packed engine times (32 steps a call
    through the backend, CUDA events, in turns; NVIDIA H100 80GB HBM3,
    power limit 700.00 W), ms per 32 steps, windowed / resident / mega,
    beside K1 unpacked on the zero boundary:

    - 1080x1920 ("l2"): 0.6786 / 0.8477 / 0.8390 (K1 0.7814);
    - 4096x4096 ("larger"): 5.0528 / 6.0773 / 5.9647 (K1 5.9671).

    Both classes rank alike: K4 first, then K6, then K5. The JAX backend
    takes the megakernel first (``backends/pallas.py:567-577``); on the
    card K6 trails K4 as K2 trails K1. Since K1 moved to the Hopper tile
    stepper, the unpacked zero boundary on K1 is faster than every packed
    engine (0.3692 ms against K4's 0.6837 at 1080x1920, 2.5463 against
    5.0902 at 4096x4096), so packing stays opt-in.
    """
    return next(e for e in _PACKED_RANKING[shape_class(shape)]
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
        if pack not in PACK:
            raise ValueError(f"pack must be one of {PACK}, got {pack!r}")
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
        self.packed = pack == "on"
        if self.packed:
            if boundary != "zero":
                raise UnsupportedConfigError(
                    "pack requires the zero boundary, float32 storage, a "
                    f"separable stencil plan and no tile pins; got boundary "
                    f"{boundary!r}", combo="pack")
            self.packed_consts = packed_constants(params)

    def engine_for(self, shape: Tuple[int, int]) -> str:
        """The engine that runs a domain of ``shape``: a pin, else
        :func:`auto_engine` (:func:`auto_packed_engine` when packed)."""
        if self.engine != "auto":
            return self.engine
        if self.resident == "on":
            return "resident"
        if self.packed:
            return auto_packed_engine(shape,
                                      resident_ok=self.resident == "auto")
        return auto_engine(shape, self.boundary,
                           resident_ok=self.resident == "auto")

    def build_storage(self, u: np.ndarray, v: np.ndarray):
        u_t, v_t = (
            torch.from_numpy(np.array(x, dtype=np.float32, order="C"))
            .to(self.device) for x in (u, v))
        engine = self.engine_for(u.shape)
        if self.packed:
            x = packed.pack_state(u_t, v_t)
            if engine == "mega":
                return ("megapack", megakernel.pair_state(x))
            return (PACKED_TAGS[engine], x, torch.empty_like(x))
        if engine == "mega":
            return ("mega", megakernel.pair_state(u_t),
                    megakernel.pair_state(v_t))
        return (engine, u_t, v_t, torch.empty_like(u_t),
                torch.empty_like(v_t))

    def extract_uv(self, storage, shape) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
        if storage[0] == "megapack":
            return packed.unpack_state(storage[1][0], shape[1])
        if storage[0] in ("packed", "respack"):
            return packed.unpack_state(storage[1], shape[1])
        if storage[0] == "mega":
            return storage[1][0], storage[2][0]
        return storage[1], storage[2]

    def run_steps(self, storage, shape, steps: int):
        if storage[0] in ("packed", "respack", "megapack"):
            return self._run_packed(storage, steps)
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

    def _run_packed(self, storage, steps: int):
        """``run_steps`` on the packed layout (``backends/pallas.py:
        747-792``)."""
        pc = self.packed_consts
        if storage[0] == "megapack":
            n_full, rem = divmod(steps, megakernel.MEGA_STEPS)
            if n_full:
                megakernel.packed_megastep(storage[1], n_full,
                                           megakernel.MEGA_STEPS, pc)
            if rem:
                megakernel.packed_megastep(storage[1], 1, rem, pc)
            return storage
        if storage[0] == "respack":
            if steps == 0:
                return storage
            return ("respack", *packed.resident_multistep(
                storage[1], storage[2], steps, pc))
        _, x, x_next = storage
        n_full, rem = divmod(steps, packed.K)
        for k in [packed.K] * n_full + ([rem] if rem else []):
            packed.multistep(x, x_next, k, pc)
            x, x_next = x_next, x
        return ("packed", x, x_next)

    # -- CLI -----------------------------------------------------------------

    @classmethod
    def add_cli_args(cls, parser: argparse.ArgumentParser) -> None:
        """The JAX backend's engine flags, under its names, with its
        environment defaults (``GRAYSCOTT_PALLAS_ENGINE``,
        ``GRAYSCOTT_PALLAS_RESIDENT``, ``GRAYSCOTT_PALLAS_PACK``)."""
        parser.add_argument(
            "--pallas-engine", choices=ENGINES,
            default=env_default("GRAYSCOTT_PALLAS_ENGINE", "auto",
                                choices=ENGINES),
            help="Kernel engine: 'mega' runs the whole step loop in one "
            "persistent launch (K2); 'windowed' launches K1 every 8 steps; "
            "'auto' (default) picks by domain size, as measured on the card",
        )
        parser.add_argument(
            "--pallas-resident", choices=RESIDENT,
            default=env_default("GRAYSCOTT_PALLAS_RESIDENT", "auto",
                                choices=RESIDENT),
            help="Resident engine (K3: every step of a run in one "
            "persistent launch, the state in L2): 'on' forces it, 'off' "
            "never runs it, 'auto' (default) lets the engine choice decide",
        )
        parser.add_argument(
            "--pallas-pack", choices=PACK,
            default=env_default("GRAYSCOTT_PALLAS_PACK", "auto",
                                choices=PACK),
            help="Species-packed layout: U and V side by side in one array, "
            "the separable step and the linear fold (K4, K5, K6; zero "
            "boundary and a separable stencil only). 'on' packs, 'auto' "
            "(default) and 'off' never pack (the port has no autotuner)",
        )

    @classmethod
    def args_from_namespace(cls, ns: argparse.Namespace) -> dict:
        return {"engine": getattr(ns, "pallas_engine", "auto"),
                "resident": getattr(ns, "pallas_resident", "auto"),
                "pack": getattr(ns, "pallas_pack", "auto")}
