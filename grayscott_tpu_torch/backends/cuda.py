"""``cuda`` backend: the port's ``grayscott_tpu/backends/pallas.py``, with
its three engines, on two layouts, and bf16 storage.

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

``pack="auto"`` packs only on a measured record, as the JAX backend does
(``backends/pallas.py:503-534``): the autotune store's, else one that
``bench/defaults.py`` ships for this card (``bench/autotune.py:lookup``,
keyed on ``utils/device.py:autotune_platform``). With no engine pin,
``engine="auto"`` and ``resident="auto"`` follow the record's engine too;
without a record they follow :func:`auto_engine`, or
:func:`auto_packed_engine` on the packed layout, measured on the card. A
pin always wins: ``engine`` and ``resident`` pin the engine, ``pack`` the
layout, and a record fills in only what is left on ``auto``.
``tuned_lookup=False`` ignores the records (the autotuner measures each
candidate so).

``dtype="bfloat16"`` (``--pallas-dtype``; ``backends/pallas.py:181-188``)
stores the state in bfloat16, on the unpacked layout only: K1 and K2 widen
each window to float32, step it in float32 and round the stored cells to
bfloat16, to nearest even, once a block of at most 8 steps, so every engine
rounds where ``ops/stencil.py:run_bf16`` does and they agree bit for bit;
not with float32. ``build_storage`` rounds the initial state once;
``extract_uv`` and ``extract_result`` return float32 copies holding the
stored values (JAX's host views are f32). As in JAX, ``resident="on"``,
``pack="on"`` and a lane-fold pin refuse bf16, and ``auto`` never runs
K3, never packs and never folds with it: it follows a bf16 record's
engine (records key on ``:bfloat16``), else runs K1, JAX's static default
for bf16 (``backends/pallas.py:466-470``).

The buffers are updated in place, where the JAX backend gets fresh
(donated) buffers from every call. ``engine`` (``auto|windowed|mega``),
``resident`` (``auto|on|off``) and ``pack`` (``auto|on|off``) take the JAX
backend's names and values, and so do the other eight ``--pallas-*``
flags. ``runtime_params`` on and off run the same kernels (they take the
parameters by value), and ``steps_per_call`` runs ``None`` and the
kernels' own K of 8; every other value of the JAX backend's knobs that the
port does not run (lane fold, the naive fix-up modes and fold, the
megakernel's ring depth and specialisation, tile pins, another K) raises
:class:`UnsupportedConfigError` naming its ROADMAP.md item.
"""

from __future__ import annotations

import argparse
import functools
from typing import Tuple

import numpy as np
import torch

from ..errors import UnsupportedConfigError
from ..ops import megakernel, packed, resident, windowed
from ..params import Parameters, kernel_constants, packed_constants
from .base import Simulation, env_default, storage_dtype

ENGINES = ("auto", "windowed", "mega")
RESIDENT = ("auto", "on", "off")
PACK = ("auto", "on", "off")

DTYPES = ("float32", "bfloat16")
NAIVE_FIX = ("select", "store", "slice")
ON_OFF = ("on", "off")

#: the depth of every engine's time block (K1, K2, K4, K6): the one
#: ``steps_per_call`` the port runs
K = windowed.K

_TILES = "ROADMAP.md Queue 2 item 8 (column tiles, the temporal depth and " \
    "the tile pins)"

#: knob -> (the values the port runs, the JAX backend's names and values;
#: where ROADMAP.md keeps the rest)
_SUPPORTED = {
    "fold": (("auto", "off", 1), "ROADMAP.md Queue 2 item 7 (the lane-fold "
             "layout)"),
    "naive_fix": (("select",), "ROADMAP.md Queue 2 item 6 (the quirk-strip "
                  "mechanisms; the port's kernels compute the clamped "
                  "window per cell and have no strip to patch)"),
    "naive_fold": ((False,), "ROADMAP.md Queue 2 item 5 (the folded naive "
                   "reaction)"),
    "mega_depth": ((None,), "ROADMAP.md Queue 2 item 3 (the megakernels' "
                   "window ring)"),
    "mega_specialize": ((None,), "ROADMAP.md Queue 2 item 1 (interior tiles "
                        "are always on)"),
    "block_rows": ((None,), _TILES),
    "block_cols": ((None,), _TILES),
    "steps_per_call": ((None, K), _TILES),
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
    ("l2", "zero"): ("mega", "windowed", "resident"),
    ("larger", "naive"): ("windowed", "mega", "resident"),
    ("larger", "zero"): ("windowed", "mega", "resident"),
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
    "l2": ("mega", "windowed", "resident"),
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
    all three on the Hopper tile stepper (``csrc/gs_tile_sm90.cuh``):

    - 1080x1920 ("l2"): naive 0.5737 / 0.5586 / 0.5928, zero
      0.3694 / 0.4837 / 0.3545;
    - 4096x4096 ("larger"): naive 2.9493 / 4.3215 / 3.3267, zero
      2.5323 / 4.0311 / 2.6285.

    While the state fits L2, K3 leads on the naive boundary (no halo
    recompute) and K2 on the zero boundary (no launch every 8 steps, and
    its zero-boundary edge tiles cost little). Beyond L2 K1 leads, K2
    second: K3 passes the whole state through HBM every step, K1 and K2
    every 8, and K2 pays its static tile walk (16 rounds) before each grid
    barrier.
    """
    return next(e for e in _RANKING[shape_class(shape), boundary]
                if resident_ok or e != "resident")


def auto_packed_engine(shape: Tuple[int, int],
                       resident_ok: bool = True) -> str:
    """The engine that ``engine='auto'`` runs on the packed layout (zero
    boundary only): the fastest of K4, K5 and K6 for the shape's class, as
    measured on the card. ``resident_ok=False`` skips K5.

    Set from ``chip_smoke.py``'s packed engine times (phase 6c: 32 steps
    a call through the backend, CUDA events, in turns; NVIDIA H100 80GB
    HBM3, power limit 700.00 W), ms per 32 steps, windowed / resident /
    mega, beside K1 and K2 unpacked on the zero boundary:

    - 1080x1920 ("l2"): 0.2716 / 0.4184 / 0.2582 (K1 0.3694, K2 0.3556);
    - 4096x4096 ("larger"): 1.8249 / 3.8596 / 1.9081 (K1 2.5469, K2
      2.6385).

    All three step on the packed Hopper stepper
    (``csrc/gs_packed_sm90.cuh``), and they rank as K1 and K2 do on the
    unpacked one: while the state fits L2, K6 leads (1.05x faster than K4:
    no launch every 8 steps); beyond it K4 leads (1.05x faster than K6,
    which walks its tiles in 16 static rounds before each grid barrier).
    K5, which passes the state through L2 or HBM every step, is last in
    both. The packed engines are the fastest zero-boundary engines of the
    port on either layout: 0.73x K2's time in L2 and 0.72x K1's at
    4096x4096, from the packed step's 30 float32 operations a cell-step
    against the unpacked zero tree's 63. Whether ``pack="auto"`` packs is
    the autotune records' verdict, as in JAX, measured on speed alone; the
    drift the packed tree adds (8.7e-5 in V over 1000 steps at 256x384,
    inside ``scripts/parity_check.py``'s 1e-3) is what
    ``scripts/parity_check.py`` checks on the card.
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
                 block_cols: int | None = None,
                 steps_per_call: int | None = None,
                 runtime_params: bool = True, naive_fold: bool = False,
                 tuned_lookup: bool = True):
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
        #: the storage dtype, by name and torch's
        self.dtype = storage_dtype(dtype)
        self.storage_dtype = getattr(torch, self.dtype)
        bf16 = self.storage_dtype == torch.bfloat16
        # JAX's refusals of bf16 storage (backends/pallas.py:194-196,
        # :334-336, :509)
        if bf16 and resident == "on":
            raise UnsupportedConfigError(
                "resident='on' requires float32 storage", combo="resident")
        if bf16 and isinstance(fold, int) and fold > 1:
            raise UnsupportedConfigError(
                "fold excludes bf16 storage and column tiling", combo="fold")
        knobs = dict(fold=fold, naive_fix=naive_fix,
                     naive_fold=naive_fold, mega_depth=mega_depth,
                     mega_specialize=mega_specialize, block_rows=block_rows,
                     block_cols=block_cols, steps_per_call=steps_per_call)
        for knob, value in knobs.items():
            runs, item = _SUPPORTED[knob]
            if value not in runs:
                raise UnsupportedConfigError(
                    f"{knob}={value!r} is not ported to the cuda backend "
                    f"yet ({item}); it runs {knob} in {runs}", combo=knob)
        self.engine = engine
        self.resident = resident
        self.pack = pack
        self.tuned_lookup = tuned_lookup
        self.consts = kernel_constants(params)
        #: extract_result hands out a float32 copy of bf16 storage, which
        #: no later step writes
        self.fresh_result = bf16
        if pack == "on" and not self._pack_ok():
            raise UnsupportedConfigError(
                "pack requires the zero boundary, float32 storage, a "
                f"separable stencil plan and no tile pins; got boundary "
                f"{boundary!r}, stencil {params.stencil_name()!r}, dtype "
                f"{self.dtype}", combo="pack")

    def _pack_ok(self) -> bool:
        """Whether the packed layout runs this configuration (no tile pins
        hold for every configuration the constructor takes)."""
        return (self.boundary == "zero"
                and self.storage_dtype == torch.float32
                and self.params.separable_plan()[0] == "separable")

    @functools.cached_property
    def packed_consts(self):
        return packed_constants(self.params)

    def tuned(self, shape: Tuple[int, int]) -> dict | None:
        """The autotune record of a domain of ``shape`` in this storage
        dtype on this device (``bench/autotune.py:lookup``), or None;
        always None with ``tuned_lookup=False``."""
        if not self.tuned_lookup:
            return None
        from ..bench import autotune

        return autotune.lookup(self.params, shape, self.boundary,
                               dtype=self.dtype, device=self.device)

    def layout_for(self, shape: Tuple[int, int]) -> Tuple[bool, str]:
        """(packed, engine) of a domain of ``shape``: the pins, then the
        autotune record for what is left on ``auto``, then
        :func:`auto_engine` (:func:`auto_packed_engine` when packed; K1 with
        bf16 storage, which never runs K3)."""
        tuned = self.tuned(shape)
        record_packs = bool(tuned and tuned.get("pack"))
        packed = self.pack == "on" or (self.pack == "auto" and record_packs
                                       and self._pack_ok())
        if record_packs != packed:
            # a record of the other layout says nothing of this one's engine
            tuned = None
        if self.engine != "auto":
            return packed, self.engine
        if self.resident == "on":
            return packed, "resident"
        bf16 = self.storage_dtype == torch.bfloat16
        resident_ok = self.resident == "auto" and not bf16
        verdict = (tuned or {}).get("engine")
        if verdict in ENGINES[1:] + ("resident",) and \
                (resident_ok or verdict != "resident"):
            return packed, verdict
        if packed:
            return packed, auto_packed_engine(shape, resident_ok=resident_ok)
        if bf16:
            return packed, "windowed"
        return packed, auto_engine(shape, self.boundary,
                                   resident_ok=resident_ok)

    def engine_for(self, shape: Tuple[int, int]) -> str:
        """The engine that runs a domain of ``shape`` (:meth:`layout_for`)."""
        return self.layout_for(shape)[1]

    def build_storage(self, u: np.ndarray, v: np.ndarray):
        # the float32 state, rounded to bf16 storage (to nearest even) once
        u_t, v_t = (
            torch.from_numpy(np.array(x, dtype=np.float32, order="C"))
            .to(self.device).to(self.storage_dtype) for x in (u, v))
        packed_layout, engine = self.layout_for(u.shape)
        if packed_layout:
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
        # (.float(): bf16 storage widens into a new tensor; float32 storage
        # is returned as it is)
        if storage[0] == "mega":
            return storage[1][0].float(), storage[2][0].float()
        return storage[1].float(), storage[2].float()

    def extract_result(self, storage, shape) -> torch.Tensor:
        """V alone: bf16 storage widens V only, not U as well."""
        if storage[0] == "mega":
            return storage[2][0].float()
        if storage[0] in ("windowed", "resident"):
            return storage[2].float()
        return super().extract_result(storage, shape)

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
        """The JAX backend's eleven ``--pallas-*`` flags
        (``grayscott_tpu/backends/pallas.py:892-989``), under its names,
        choices, defaults and environment variables; a value the port does
        not run parses, and the constructor refuses it, naming its
        ROADMAP.md item."""
        parser.add_argument(
            "--pallas-block-rows", type=int,
            default=env_default("GRAYSCOTT_PALLAS_BLOCK_ROWS", None, int),
            help="Row-tile size of the Pallas kernel (multiple of 8; "
            "default: VMEM budget heuristic). The port's kernels run "
            "fixed tiles: a pin is refused (ROADMAP.md Queue 2 item 8)",
        )
        parser.add_argument(
            "--pallas-block-cols", type=int,
            default=env_default("GRAYSCOTT_PALLAS_BLOCK_COLS", None, int),
            help="Column-tile size (multiple of 128) for very wide domains; "
            "default: full width unless the window would exceed VMEM. "
            "With --pallas-engine mega, pins the megakernel's column tile. "
            "The port's kernels run fixed tiles: a pin is refused "
            "(ROADMAP.md Queue 2 item 8)",
        )
        parser.add_argument(
            "--pallas-dtype", choices=DTYPES,
            default=env_default("GRAYSCOTT_PALLAS_DTYPE", "float32",
                                choices=DTYPES),
            help="Storage precision: bfloat16 is an opt-in fast mode "
            "(halved HBM traffic and footprint; compute stays f32 in "
            "VMEM) that is NOT bit-compatible with the f32 reference "
            "semantics. The port runs it on K1 and K2 (and the sharded "
            "engines): the state is stored in bfloat16 and rounded once "
            "every 8 steps; the resident kernel, the packed layout and "
            "lane folds refuse it",
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
            "--pallas-fold", type=parse_fold,
            default=env_default("GRAYSCOTT_PALLAS_FOLD", "auto"),
            help="Lane-fold layout for narrow domains: an integer F "
            "computes F row-panels side by side along lanes; 'auto' "
            "(default) folds only when the autotuner measured fold "
            "winning on this domain; 'off' never folds. The port runs "
            "'auto', 'off' and 1 (ROADMAP.md Queue 2 item 7)",
        )
        parser.add_argument(
            "--pallas-pack", choices=PACK,
            default=env_default("GRAYSCOTT_PALLAS_PACK", "auto",
                                choices=PACK),
            help="Species-packed layout: U and V side by side in one array, "
            "the separable step and the linear fold (K4, K5, K6; zero "
            "boundary and a separable stencil only). 'on' packs, 'off' "
            "never packs, 'auto' (default) packs only when an autotune "
            "record measured pack winning on this domain and card",
        )
        parser.add_argument(
            "--pallas-naive-fix", choices=NAIVE_FIX,
            default=env_default("GRAYSCOTT_NAIVE_FIX", "select",
                                choices=NAIVE_FIX),
            help="Naive-boundary fix-up mechanism: 'select' (default, "
            "bit-frozen) patches the quirk strips with full-window "
            "masked selects; 'store' uses narrow scratch-ref stores "
            "(perf experiment, measured slower); 'slice' feeds the "
            "top-row strip from the laplacian's own shifted tensors — "
            "measured +4.0% on-chip at 4096^2 naive, at ulp-scale drift "
            "from the frozen default (the naive_fold budget class). The "
            "port runs 'select' (ROADMAP.md Queue 2 item 6)",
        )
        parser.add_argument(
            "--pallas-naive-fold", choices=ON_OFF,
            default=env_default("GRAYSCOTT_NAIVE_FOLD", "off",
                                choices=ON_OFF),
            help="Folded naive reaction (opt-in fast mode): the naive "
            "update's u-linear terms, including the clamped-window "
            "boundary correction, collapse into per-window coefficient "
            "fields — near zero-path op count under exact naive "
            "SEMANTICS, at ulp-scale drift from the bit-frozen default "
            "rounding (same budget class as fold/pack/bf16). The port "
            "runs 'off' (ROADMAP.md Queue 2 item 5)",
        )
        parser.add_argument(
            "--pallas-engine", choices=ENGINES,
            default=env_default("GRAYSCOTT_PALLAS_ENGINE", "auto",
                                choices=ENGINES),
            help="Kernel engine: 'mega' runs the whole step loop in one "
            "persistent launch (K2); 'windowed' launches K1 every 8 steps; "
            "'auto' (default) follows the autotune record, else picks by "
            "domain size, as measured on the card",
        )
        parser.add_argument(
            "--pallas-runtime-params", choices=ON_OFF,
            default=env_default("GRAYSCOTT_PALLAS_RUNTIME_PARAMS", "on",
                                choices=ON_OFF),
            help="Pass the reaction scalars (Du, Dv, f, -(f+k), dt) as a "
            "traced SMEM operand so parameter changes reuse the compiled "
            "kernel (default on; bit-identical to 'off', which folds them "
            "at compile time like the reference's default stencil). The "
            "port's kernels take them by value: both run the same kernels",
        )
        parser.add_argument(
            "--pallas-steps-per-call", type=int,
            default=env_default("GRAYSCOTT_PALLAS_STEPS_PER_CALL", None,
                                int),
            help="Temporal blocking depth (1..32 steps fused in VMEM; "
            "default 16 on TPU, autotuner may adjust). The port's kernels "
            f"run K = {K} (another K: ROADMAP.md Queue 2 item 8)",
        )

    @classmethod
    def args_from_namespace(cls, ns: argparse.Namespace) -> dict:
        return {
            "block_rows": getattr(ns, "pallas_block_rows", None),
            "block_cols": getattr(ns, "pallas_block_cols", None),
            "steps_per_call": getattr(ns, "pallas_steps_per_call", None),
            "dtype": getattr(ns, "pallas_dtype", "float32"),
            "runtime_params": getattr(
                ns, "pallas_runtime_params", "on") != "off",
            "resident": getattr(ns, "pallas_resident", "auto"),
            "fold": parse_fold(getattr(ns, "pallas_fold", "auto")),
            "engine": getattr(ns, "pallas_engine", "auto"),
            "pack": getattr(ns, "pallas_pack", "auto"),
            "naive_fix": getattr(ns, "pallas_naive_fix", "select"),
            "naive_fold": getattr(ns, "pallas_naive_fold", "off") == "on",
        }


def parse_fold(value):
    """``--pallas-fold``'s value: ``auto``, ``off`` or an integer
    (``grayscott_tpu/backends/pallas.py:_parse_fold``)."""
    if isinstance(value, str) and value not in ("auto", "off"):
        try:
            return int(value)
        except ValueError:
            raise argparse.ArgumentTypeError(
                f"expected 'auto', 'off' or an integer, got {value!r}"
            ) from None
    return value
