"""``cuda`` backend: the port's ``grayscott_tpu/backends/pallas.py``, with
its three engines, on two layouts, and bf16 storage.

The unpacked layout (``pack`` ``auto`` or ``off``), both boundaries:

- ``windowed`` (K1, ``ops/windowed.py``): storage ``("windowed", u, v,
  u_next, v_next, (K, tiles))``, plain ``(R, C)`` tensors, no padding (the
  kernel masks the domain edge itself), and the depth and tiles it steps
  with (:meth:`CudaSimulation.plan_for`), as JAX's storage carries its
  ``tr`` and K. ``run_steps`` makes ``divmod(steps, K)`` full
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
  x_next, (K, tiles))``; ``divmod(steps, K)`` launches as K1's;
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
bfloat16, to nearest even, once a block of at most K steps (8 unless
pinned), so every engine rounds where ``ops/stencil.py:run_bf16`` does and
they agree bit for bit; not with float32. ``build_storage`` rounds the
initial state once; ``extract_uv`` and ``extract_result`` return float32
copies holding the stored values (JAX's host views are f32). As in JAX,
``resident="on"``, ``pack="on"`` and a lane-fold pin refuse bf16, and
``auto`` never runs K3, never packs and never folds with it: it follows a
bf16 record's engine (records key on ``:bfloat16``), else runs K1, JAX's
static default for bf16 (``backends/pallas.py:466-470``).

``naive_fold=True`` (``--pallas-naive-fold on``; ``backends/pallas.py:
232-252``) runs the folded naive reaction on K1 and K2, float32 and bf16:
their fold entries (``ops/windowed.py``, ``ops/megakernel.py``), whose
plain version is ``ops/stencil.py:step_naive_fold``, a few ulp off the
exact naive step. As in JAX it needs the naive boundary and refuses
``naive_fix='store'``, a lane-fold pin and ``resident='on'``, and ``auto``
never runs K3 under it (``:489``): a record whose engine is ``resident``
is ignored, and :func:`auto_engine` skips K3. ``naive_fix`` takes
``select``, ``store`` and ``slice`` (``:161-172``): JAX's three mechanisms
for patching the quirk strips, which the port's kernels do not have (they
compute the clamped window per cell), so all three run the exact naive
path, within the budgets JAX gives ``store`` and ``slice``. As in JAX a
value other than ``select`` needs the naive boundary, ``store`` refuses
``resident='on'``, and ``auto`` never runs K3 with ``store`` (``:490``).

``mega_depth`` (None or 2..8, else ``ValueError``, as JAX's
``backends/pallas.py:224-225``) runs K2's window ring: ``depth`` window
slots, ``depth - 1`` loads in flight while a tile steps
(``ops/megakernel.py:ring_geometry`` gives the tile and the depth that run:
JAX's clamp to 2 under ``2 * depth`` tiles, 32x32 tiles where 64x64 ones
do not fit the ring). It acts only where K2 runs: K6, like JAX's
``packed_megastep`` (``grayscott_tpu/ops/megakernel.py:1112-1168``), takes no depth and
runs the double buffer under any pin. ``auto`` does not pick the
megakernel for it (JAX's ``_use_mega``). Every depth gives the same frames
bit for bit. ``mega_specialize`` (None, True, False; JAX's
interior-block specialisation, ``:227-232``, ``:370-382``) is inert: the
port's kernels always step interior tiles without the boundary selects,
bitwise to the edge code, so all three values run the same kernels. As in
JAX it refuses ``naive_fix='store'`` and is declined silently on the
packed layout; JAX has no flag for either knob (its constructor and its
sweep's ``depth`` and ``spec`` keys take them), and neither has the port.

The temporal depth and the tile pins (``steps_per_call`` 1..32,
``block_rows``, ``block_cols``; ``ops/geometry.py``) run on K1, and K4
where JAX's packed windowed kernel takes them (``block_rows`` and K:
``backends/pallas.py:554-583``). ``run_steps`` then launches
``divmod(steps, K)`` blocks of K steps and one of the remainder on the
tiles the pins give; 64x64 tiles at K <= 8 are the compiled entries', any
other geometry the pinned ones. Exact float32 results do not depend on K
or the tiles; bf16 storage rounds once a K-step block
(``pallas_stencil.py:970-993``), so a K pin changes its results, as in
JAX. A K other than 1..32 raises JAX's ``ValueError`` (``:90-94``), and a
window past the shared memory a block may use raises
:class:`UnsupportedConfigError` naming its bytes. As in JAX:

- an explicit K or a tile pin means "the windowed kernel with these
  knobs" (``_explicit_k``, ``:83``; ``:447-460``, ``:485-497``,
  ``:526-532``): ``engine="auto"`` then runs K1, packs only on
  ``pack="on"``, and no record moves it to K2, K3 or a packed engine;
  ``resident="on"`` still runs K3 (K5 packed), which takes no pin
  (``_use_resident``: the pin is checked first);
- ``engine="mega"`` with a K other than 8 raises JAX's refusal
  (``:144-152``); ``pack="on"`` with ``block_cols`` raises JAX's
  (``:507-519``);
- a record's ``steps_per_call`` is adopted when K is not pinned
  (``_tuned_k``, ``:315-327``), its ``block_rows`` and ``block_cols`` when
  they are not pinned and the record's K is the run's (``:270-313``;
  ADVICE.md #2: tiles measured at another K do not transfer), from a
  windowed record of the run's layout only. Records key on the card
  (``utils/device.py:autotune_platform``), so a CPU record never reaches
  the card.

The megakernels' tile pins (``engine="mega"`` with ``block_rows`` and/or
``block_cols``; ``_mega_tiles``, ``backends/pallas.py:384-411``) run K2, and
K6 on the packed layout (its row tile; ``:554-576``), on the tiles
``ops/geometry.py:mega_resolve`` gives: the pins, then an ``engine: mega``
record's tiles where the run pins none (``:390-396``), then the compiled
64x64. The storage carries them (``("mega", u_pair, v_pair, tiles)``,
``("megapack", x_pair, tiles)``), and a geometry other than 64x64 launches
the pinned entries (``csrc/mega_pins.cu``). The values JAX's megakernels
refuse raise its refusal when the storage is built (``block_rows`` not a
positive multiple of 8, ``block_cols`` not a positive multiple of 128, a
column tile under ``naive_fix="store"``; ``:414-428``, ``:552-562``), and a
window past the shared memory a block may use raises naming its bytes. A
pinned tile with a ``mega_depth`` above 2 runs the window ring on the
pinned tiles (``ops/megakernel.py:ring_geometry``: JAX's clamp to depth 2
on few windows; a ring past the shared memory a block may use raises
naming its bytes); the frames do not depend on the tiles or the depth.

The lane fold (``fold``, ``--pallas-fold F``; ``backends/pallas.py:
329-368``, ``:611-636``; ``ops/lane_fold.py``) runs K1's folded entry
(``ops/windowed.py:folded_multistep``): storage ``("folded", u, v, u_next,
v_next, (K, tiles), (F, Rp))``, JAX's folded layout ``(halo + Rp + halo,
F*C)`` float32, ``Rp = fold_geometry(R, F, tr)`` on the tiles
``plan_for`` gives the panel; ``run_steps`` calls the entry, which
refreshes the panels' halos (``lane_fold.fold_refresh``) and steps, once
every K steps and once for the remainder (``:817-842``). A pin is an int;
``auto`` folds only on a record whose ``fold`` is greater than 1, never
under ``off``, bf16, a ``block_cols`` pin, ``resident='on'``,
``naive_fold`` or the naive boundary with ``C % 128 != 0`` (JAX's TPU lane
tile; a pin runs it here, as JAX's interpret mode computes it); a fold
record's K and tiles are dropped when the run does not fold
(``:633-636``), its engine, the windowed kernel, stays (``_use_mega``
reads it first). As in JAX a pin F > 1 refuses bf16 storage and
``block_cols``, ``resident='on'``, ``naive_fold``, ``engine='mega'`` and
``pack='on'``, and panels thinner than the halo. The results are K1's
unfolded ones bit for bit.

A record whose engine the configuration refuses (``resident`` under
``resident="off"``, bf16, ``naive_fold`` or ``naive_fix="store"``) runs
K1 (K4 when packed), as JAX's verdict that is not ``mega`` runs the
windowed kernel (``:463-465``).

The buffers are updated in place, where the JAX backend gets fresh
(donated) buffers from every call. ``engine`` (``auto|windowed|mega``),
``resident`` (``auto|on|off``) and ``pack`` (``auto|on|off``) take the JAX
backend's names and values, and so do the other eight ``--pallas-*``
flags. ``runtime_params`` on and off run the same kernels (they take the
parameters by value).
"""

from __future__ import annotations

import argparse
import functools
from typing import Tuple

import numpy as np
import torch

from ..errors import UnsupportedConfigError
from ..ops import geometry, lane_fold, megakernel, packed, resident, windowed
from ..params import (Parameters, fold_constants, kernel_constants,
                      packed_constants)
from .base import Simulation, env_default, storage_dtype

ENGINES = ("auto", "windowed", "mega")
RESIDENT = ("auto", "on", "off")
PACK = ("auto", "on", "off")

DTYPES = ("float32", "bfloat16")
NAIVE_FIX = ("select", "store", "slice")
ON_OFF = ("on", "off")

#: the depth of every engine's time block (K1, K2, K4, K6) where K is not
#: pinned, and the megakernels' only one
K = windowed.K

#: JAX's refusal of the packed layout (``backends/pallas.py:515-518``)
PACK_REFUSAL = ("pack requires the zero boundary, f32 storage, a separable "
                "stencil plan, and no fold/column tiling")

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
        # JAX's order: the K range first, the megakernel's K with the
        # engine's value (backends/pallas.py:90-94, :144-152)
        self._check_k(engine, steps_per_call)
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
        #: the lane fold: an int pins F, "auto" follows a fold record,
        #: "off" never folds
        self.fold = self._check_fold(fold, resident, bf16, block_cols)
        self._check_naive_modes(boundary, resident, fold, naive_fix,
                                naive_fold)
        #: the window ring's depth pin (ops/megakernel.py:ring_geometry)
        self.mega_depth = None if mega_depth is None else \
            megakernel.check_depth(mega_depth)
        if mega_specialize and naive_fix == "store":
            raise UnsupportedConfigError(
                "mega_specialize and naive_fix='store' conflict; pin at most "
                "one of them", combo="mega_specialize+naive_fix")
        #: inert: interior tiles are always specialised, bitwise
        self.mega_specialize = mega_specialize
        geometry.check_tile("block_rows", block_rows)
        geometry.check_tile("block_cols", block_cols)
        self.engine = engine
        self.resident = resident
        self.pack = pack
        #: the pins of K1's (and K4's) depth and tiles (ops/geometry.py)
        self.steps_per_call = steps_per_call
        self.block_rows = block_rows
        self.block_cols = block_cols
        #: a K pin (JAX's _explicit_k)
        self._explicit_k = steps_per_call is not None
        #: a K or tile pin: auto runs the windowed kernel, packed only on
        #: pack='on'
        self._pinned = self._explicit_k or block_rows is not None or \
            block_cols is not None
        self.naive_fix = naive_fix
        self.naive_fold = naive_fold
        self.tuned_lookup = tuned_lookup
        self.consts = kernel_constants(params)
        #: the constants K1 and K2 step with: the fold's under naive_fold
        self.step_consts = (fold_constants(params) if naive_fold
                            else self.consts)
        #: extract_result hands out a float32 copy of bf16 storage, which
        #: no later step writes
        self.fresh_result = bf16
        if pack == "on" and not self._pack_ok():
            raise UnsupportedConfigError(
                f"{PACK_REFUSAL}; got boundary {boundary!r}, stencil "
                f"{params.stencil_name()!r}, dtype {self.dtype}, block_cols "
                f"{block_cols!r}", combo="pack")

    @staticmethod
    def _check_k(engine, steps_per_call) -> None:
        """JAX's rules of the K pin, with its messages
        (``backends/pallas.py:90-94``, ``:144-152``)."""
        if steps_per_call is not None:
            geometry.check_steps_per_call(steps_per_call)
        if engine == "mega" and steps_per_call not in (None, K):
            raise UnsupportedConfigError(
                "engine='mega' fixes steps-per-call at its halo depth "
                f"K={K}; drop --pallas-steps-per-call",
                combo="engine+steps_per_call")

    @staticmethod
    def _check_fold(fold, resident, bf16: bool, block_cols):
        """``fold`` if JAX's backend takes it (``auto``, ``off`` or an int
        >= 1, else its ``ValueError``, ``backends/pallas.py:128-132``), and
        JAX's refusals of a pin F > 1 with ``resident='on'`` (``:205-210``)
        and with bf16 storage or a column tile (``:333-337``)."""
        if isinstance(fold, str):
            if fold not in ("auto", "off"):
                raise ValueError(f"fold must be auto/off/int, got {fold!r}")
        elif isinstance(fold, bool) or not (isinstance(fold, int)
                                            and fold >= 1):
            raise ValueError(f"fold must be auto/off/int >= 1, got {fold!r}")
        if isinstance(fold, int) and fold > 1:
            if resident == "on":
                raise UnsupportedConfigError(
                    "resident='on' and a pinned lane fold conflict; pin at "
                    "most one of them", combo="resident+fold")
            if bf16 or block_cols is not None:
                raise UnsupportedConfigError(
                    "fold excludes bf16 storage and column tiling",
                    combo="fold")
        return fold

    @staticmethod
    def _check_naive_modes(boundary, resident, fold, naive_fix,
                           naive_fold) -> None:
        """JAX's rules of ``naive_fix`` and ``naive_fold``, with its
        messages (``backends/pallas.py:165-171``, ``:197-204``,
        ``:238-252``)."""
        if naive_fix not in NAIVE_FIX:
            raise ValueError(f"naive_fix must be select/store/slice, got "
                             f"{naive_fix!r}")
        if naive_fix != "select" and boundary != "naive":
            raise UnsupportedConfigError(
                f"naive_fix={naive_fix!r} requires the naive boundary",
                combo="naive_fix+boundary")
        if resident == "on" and naive_fix == "store":
            raise UnsupportedConfigError(
                "resident='on' and naive_fix='store' conflict; pin at most "
                "one of them", combo="resident+naive_fix")
        if not naive_fold:
            return
        if boundary != "naive":
            raise UnsupportedConfigError(
                "naive_fold applies to the naive boundary",
                combo="naive_fold+boundary")
        if naive_fix == "store":
            raise UnsupportedConfigError(
                "naive_fold and naive_fix='store' conflict; pin at most one "
                "of them", combo="naive_fold+naive_fix")
        if isinstance(fold, int) and fold > 1:
            raise UnsupportedConfigError(
                "naive_fold excludes the lane-fold layout",
                combo="naive_fold+fold")
        if resident == "on":
            raise UnsupportedConfigError(
                "naive_fold runs on the windowed/mega engines only",
                combo="naive_fold+resident")

    def _pack_ok(self) -> bool:
        """Whether the packed layout runs this configuration (JAX's
        ``_use_pack`` conditions, ``backends/pallas.py:507-513``)."""
        return (self.boundary == "zero"
                and self.storage_dtype == torch.float32
                and self.block_cols is None
                and not self._fold_pinned
                and self.params.separable_plan()[0] == "separable")

    @property
    def _fold_pinned(self) -> bool:
        """A lane-fold pin F > 1."""
        return isinstance(self.fold, int) and self.fold > 1

    def fold_for(self, shape: Tuple[int, int], tuned=None) -> int:
        """The lane-fold factor F of a domain of ``shape`` (1: unfolded;
        JAX's ``_fold_factor``, ``backends/pallas.py:329-368``): the pin;
        under ``auto`` the record ``tuned``'s ``fold``, except with
        bf16 storage, a ``block_cols`` pin, ``resident='on'``,
        ``naive_fold``, or the naive boundary on a width that is not a
        multiple of 128. The megakernel and the packed layout take no fold:
        an engine or layout pin wins over a fold record."""
        if isinstance(self.fold, int):
            return self.fold
        r, c = shape
        if (self.fold == "off"
                or self.storage_dtype != torch.float32
                or (self.boundary == "naive" and c % 128 != 0)
                or self.block_cols is not None
                or self.resident == "on"
                or self.naive_fold
                or self.engine == "mega" or self.pack == "on"):
            return 1
        return int((tuned or {}).get("fold") or 1)

    @functools.cached_property
    def packed_consts(self):
        return packed_constants(self.params)

    def tuned(self, shape: Tuple[int, int]) -> dict | None:
        """The autotune record of a domain of ``shape`` in this storage
        dtype on this device under this run's K and tile pins
        (``bench/autotune.py:lookup``), or None; always None with
        ``tuned_lookup=False``."""
        if not self.tuned_lookup:
            return None
        from ..bench import autotune

        return autotune.lookup(self.params, shape, self.boundary,
                               dtype=self.dtype, device=self.device,
                               **self.pins())

    def pins(self) -> dict:
        """The K and tile pins, as the autotuner's keywords."""
        return dict(steps_per_call=self.steps_per_call,
                    block_rows=self.block_rows, block_cols=self.block_cols)

    def plan_for(self, shape: Tuple[int, int], packed_layout: bool = False,
                 tuned=None) -> Tuple[int, "geometry.Geometry"]:
        """(K, tiles) that K1 (K4 on the packed layout) steps a domain of
        ``shape`` with: the pins, then what the record ``tuned`` leaves on
        ``auto`` (a windowed record of the same layout: its K where K is
        not pinned, its tiles where they are not pinned and its K is the
        run's), then K = 8 and the default tiles
        (``geometry.resolve``)."""
        rec = tuned
        if rec and (bool(rec.get("pack")) != packed_layout
                    or rec.get("engine") not in (None, "windowed")):
            rec = None
        k = self.steps_per_call
        if k is None:
            tk = (rec or {}).get("steps_per_call")
            k = int(tk) if tk and 1 <= int(tk) <= \
                geometry.MAX_STEPS_PER_CALL else K
        tr, tc = self.block_rows, self.block_cols
        if rec and rec.get("steps_per_call", K) == k:
            tr = rec.get("block_rows") if tr is None else tr
            if not packed_layout:
                tc = rec.get("block_cols") if tc is None else tc
        return k, geometry.resolve(shape, k, tr, tc)

    def mega_plan_for(self, shape: Tuple[int, int],
                      packed_layout: bool = False,
                      tuned=None) -> "geometry.Geometry":
        """The tiles that K2 (K6 on the packed layout) steps a domain of
        ``shape`` with: the pins, then an ``engine: mega`` record's tiles
        of the same layout where the run pins none and no ``mega_depth``
        ring runs (``backends/pallas.py:384-411``, ``:552-554``), then
        ``geometry.mega_resolve``. The values JAX's megakernels refuse
        raise its :class:`UnsupportedConfigError` (``:414-428``,
        ``:555-562``), and so does a ``mega_depth`` ring on pinned tiles
        past the shared memory a block may use, naming its bytes
        (``ops/megakernel.py:ring_geometry``)."""
        tr, tc = self.block_rows, self.block_cols
        rec = tuned
        if rec and (bool(rec.get("pack")) == packed_layout
                    and rec.get("engine") == "mega"
                    and self.mega_depth in (None, 2)):
            tr = rec.get("block_rows") if tr is None else tr
            tc = rec.get("block_cols") if tc is None else tc
        if tc is not None and tc >= shape[1]:
            tc = None  # backends/pallas.py:396-397
        if packed_layout:
            if not geometry.mega_pins_ok(tr, None):
                r, c = shape
                raise UnsupportedConfigError(
                    "engine='mega' with pack needs full-width windows under "
                    f"the VMEM/compile ceilings; unsupported for shape "
                    f"{(r, c)} packed to {(r, 2 * c)}", combo="engine+pack")
            return geometry.mega_resolve(shape, tr, None)
        if not geometry.mega_pins_ok(tr, tc) or (
                tc is not None and self.naive_fix == "store"):
            raise UnsupportedConfigError(
                "engine='mega' needs windows under the VMEM/compile ceilings "
                "(including the pinned mega_depth ring and mega_specialize "
                "graph) and no lane fold; unsupported for shape "
                f"{tuple(shape)} at tr={tr}, tc={tc}", combo="engine+tiles")
        g = geometry.mega_resolve(shape, tr, tc)
        if not g.compiled:
            megakernel.ring_geometry(shape, self.mega_depth, tiles=g)
        return g

    def layout_for(self, shape: Tuple[int, int]) -> Tuple[bool, str]:
        """(packed, engine) of a domain of ``shape``: the pins, then the
        autotune record for what is left on ``auto``, then
        :func:`auto_engine` (:func:`auto_packed_engine` when packed; K1 with
        bf16 storage, which never runs K3). A lane fold (:meth:`fold_for`)
        runs K1 (its folded entry). Under ``naive_fold`` and
        ``naive_fix='store'`` neither a record nor ``auto`` picks K3; a
        record whose engine is refused runs K1. Under a K or tile pin
        ``auto`` runs K1 (K3 on ``resident='on'``) and packs only on
        ``pack='on'``."""
        return self._layout(shape, self.tuned(shape))

    def _layout(self, shape: Tuple[int, int], tuned) -> Tuple[bool, str]:
        """:meth:`layout_for` with the record ``tuned`` looked up."""
        if self._fold_pinned and self.engine == "mega":
            raise UnsupportedConfigError(
                "engine='mega' needs windows under the VMEM/compile ceilings "
                "(including the pinned mega_depth ring and mega_specialize "
                "graph) and no lane fold; unsupported for shape "
                f"{tuple(shape)} at tr={self.block_rows}, "
                f"tc={self.block_cols}", combo="engine+fold")
        if self.fold_for(shape, tuned) > 1:
            return False, "windowed"
        if self._pinned:
            packed = self.pack == "on"
            if self.engine != "auto":
                return packed, self.engine
            return packed, "resident" if self.resident == "on" else \
                "windowed"
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
        resident_ok = (self.resident == "auto" and not bf16
                       and not self.naive_fold and self.naive_fix != "store")
        verdict = (tuned or {}).get("engine")
        if verdict in ENGINES[1:] + ("resident",):
            refused = verdict == "resident" and not resident_ok
            return packed, "windowed" if refused else verdict
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
        tuned = self.tuned(u.shape)
        packed_layout, engine = self._layout(u.shape, tuned)
        f = self.fold_for(u.shape, tuned)
        if f > 1:
            return self._build_folded(u_t, v_t, f, tuned)
        if tuned and int(tuned.get("fold") or 1) > 1:
            tuned = None  # a fold record's K and tiles (:633-636)
        # K1's and K4's (K, tiles) ride in the storage, as JAX's (tr, K) do
        plan = (self.plan_for(u.shape, packed_layout, tuned),) \
            if engine == "windowed" else ()
        tiles = self.mega_plan_for(u.shape, packed_layout, tuned) \
            if engine == "mega" else None
        if packed_layout:
            x = packed.pack_state(u_t, v_t)
            if engine == "mega":
                return ("megapack", megakernel.pair_state(x), tiles)
            return (PACKED_TAGS[engine], x, torch.empty_like(x), *plan)
        if engine == "mega":
            return ("mega", megakernel.pair_state(u_t),
                    megakernel.pair_state(v_t), tiles)
        return (engine, u_t, v_t, torch.empty_like(u_t),
                torch.empty_like(v_t), *plan)

    def _build_folded(self, u: torch.Tensor, v: torch.Tensor, f: int,
                      tuned):
        """The lane-fold storage of F panels (``backends/pallas.py:
        611-632``): the panel's (K, tiles) from the pins, then a record of
        this fold (``plan_for``), Rp from the row tile, JAX's refusal of
        panels thinner than the halo."""
        r, c = u.shape
        rec = tuned if tuned and int(tuned.get("fold") or 1) == f else None
        k, g = self.plan_for((-(-r // f), c), False, rec)
        rp = lane_fold.fold_geometry(r, f, g.tr)
        if rp < g.halo:
            raise UnsupportedConfigError(
                f"fold={f} on a {r}-row domain leaves panels of {rp} rows < "
                f"the {g.halo}-row halo; use a smaller fold factor",
                combo="fold")
        u_pad, v_pad = lane_fold.fold_state(u, v, f, g.tr, g.halo,
                                            self.device)
        return ("folded", u_pad, v_pad, torch.zeros_like(u_pad),
                torch.zeros_like(v_pad), (k, g), (f, rp))

    def extract_uv(self, storage, shape) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
        if storage[0] == "folded":
            halo, (f, _) = storage[5][1].halo, storage[6]
            return tuple(lane_fold.unfold_state(x, halo, f, shape[1],
                                                shape[0])
                         for x in storage[1:3])
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
        if storage[0] == "folded":
            return lane_fold.unfold_state(storage[2], storage[5][1].halo,
                                          storage[6][0], shape[1], shape[0])
        if storage[0] == "mega":
            return storage[2][0].float()
        if storage[0] in ("windowed", "resident"):
            return storage[2].float()
        return super().extract_result(storage, shape)

    def run_steps(self, storage, shape, steps: int):
        if storage[0] in ("packed", "respack", "megapack"):
            return self._run_packed(storage, shape, steps)
        if storage[0] == "mega":
            _, u_pair, v_pair, tiles = storage
            n_full, rem = divmod(steps, megakernel.MEGA_STEPS)
            if n_full:
                megakernel.megastep(u_pair, v_pair, n_full,
                                    megakernel.MEGA_STEPS, self.step_consts,
                                    self.boundary, fold=self.naive_fold,
                                    depth=self.mega_depth, geometry=tiles)
            if rem:
                megakernel.megastep(u_pair, v_pair, 1, rem, self.step_consts,
                                    self.boundary, fold=self.naive_fold,
                                    depth=self.mega_depth, geometry=tiles)
            return storage
        if storage[0] == "resident":
            if steps == 0:
                return storage
            return ("resident", *resident.multistep(
                *storage[1:], steps, self.consts, self.boundary))
        if storage[0] == "folded":
            return self._run_folded(storage, shape, steps)
        _, u, v, u_next, v_next, plan = storage
        k_max, g = plan
        n_full, rem = divmod(steps, k_max)
        for k in [k_max] * n_full + ([rem] if rem else []):
            windowed.multistep(u, v, u_next, v_next, k, self.step_consts,
                               self.boundary, fold=self.naive_fold,
                               geometry=g)
            u, v, u_next, v_next = u_next, v_next, u, v
        return ("windowed", u, v, u_next, v_next, plan)

    def _run_folded(self, storage, shape, steps: int):
        """``run_steps`` on the lane-fold layout (``backends/pallas.py:
        817-842``): each call of K steps (and of the remainder) refreshes
        the panels' halos first."""
        _, u, v, u_next, v_next, plan, (f, rp) = storage
        k_max, g = plan
        n_full, rem = divmod(steps, k_max)
        for k in [k_max] * n_full + ([rem] if rem else []):
            windowed.folded_multistep(u, v, u_next, v_next, k, self.consts,
                                      self.boundary, shape, rp, g)
            u, v, u_next, v_next = u_next, v_next, u, v
        return ("folded", u, v, u_next, v_next, plan, (f, rp))

    def _run_packed(self, storage, shape, steps: int):
        """``run_steps`` on the packed layout (``backends/pallas.py:
        747-792``)."""
        pc = self.packed_consts
        if storage[0] == "megapack":
            _, x_pair, tiles = storage
            n_full, rem = divmod(steps, megakernel.MEGA_STEPS)
            if n_full:
                megakernel.packed_megastep(x_pair, n_full,
                                           megakernel.MEGA_STEPS, pc,
                                           geometry=tiles)
            if rem:
                megakernel.packed_megastep(x_pair, 1, rem, pc,
                                           geometry=tiles)
            return storage
        if storage[0] == "respack":
            if steps == 0:
                return storage
            return ("respack", *packed.resident_multistep(
                storage[1], storage[2], steps, pc))
        _, x, x_next, plan = storage
        k_max, g = plan
        n_full, rem = divmod(steps, k_max)
        for k in [k_max] * n_full + ([rem] if rem else []):
            packed.multistep(x, x_next, k, pc, geometry=g)
            x, x_next = x_next, x
        return ("packed", x, x_next, plan)

    # -- CLI -----------------------------------------------------------------

    @classmethod
    def add_cli_args(cls, parser: argparse.ArgumentParser) -> None:
        """The JAX backend's eleven ``--pallas-*`` flags
        (``grayscott_tpu/backends/pallas.py:892-989``), under its names,
        choices, defaults and environment variables; a combination JAX
        refuses parses, and the constructor (or ``build_storage``) refuses
        it, as JAX's does."""
        parser.add_argument(
            "--pallas-block-rows", type=int,
            default=env_default("GRAYSCOTT_PALLAS_BLOCK_ROWS", None, int),
            help="Row-tile size of the Pallas kernel (multiple of 8; "
            "default: VMEM budget heuristic). The port: the height of the "
            "tiles of K1 and K4 (default 64, smaller where a deep "
            "--pallas-steps-per-call leaves no room in shared memory) and, "
            "with --pallas-engine mega, of K2 and K6 (a positive multiple "
            "of 8); holds 'auto' to the windowed kernel",
        )
        parser.add_argument(
            "--pallas-block-cols", type=int,
            default=env_default("GRAYSCOTT_PALLAS_BLOCK_COLS", None, int),
            help="Column-tile size (multiple of 128) for very wide domains; "
            "default: full width unless the window would exceed VMEM. "
            "With --pallas-engine mega, pins the megakernel's column tile. "
            "The port: the width of K1's tiles (default 64; at least the "
            "domain's width: one tile column) and, with --pallas-engine "
            "mega, of K2's (a positive multiple of 128; at least the "
            "domain's width: unpinned); holds 'auto' to the windowed "
            "kernel, unpacked; refused with --pallas-pack on (as in JAX)",
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
            "a block of K steps (8, or the --pallas-steps-per-call pin); "
            "the resident kernel, the packed layout and "
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
            "winning on this domain; 'off' never folds. The port: K1's "
            "folded entry steps every panel at its place in the domain, "
            "bit for bit the unfolded K1; F > 1 refuses bfloat16, "
            "--pallas-block-cols, --pallas-resident on, --pallas-naive-fold "
            "on, --pallas-engine mega and --pallas-pack on, as in JAX",
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
            "measured +4.0%% on-chip at 4096^2 naive, at ulp-scale drift "
            "from the frozen default (the naive_fold budget class). The "
            "port's kernels compute the clamped window per cell and have "
            "no strip to patch: all three run its exact naive path",
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
            "runs it on K1 and K2, float32 and bf16; 'auto' never picks "
            "the resident kernel under it",
        )
        parser.add_argument(
            "--pallas-engine", choices=ENGINES,
            default=env_default("GRAYSCOTT_PALLAS_ENGINE", "auto",
                                choices=ENGINES),
            help="Kernel engine: 'mega' runs the whole step loop in one "
            "persistent launch (K2); 'windowed' launches K1 every K steps; "
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
            "default 16 on TPU, autotuner may adjust). The port: K steps a "
            f"launch of K1 and K4 in windows of max(ceil(K/8)*8, 8) cells "
            f"around each tile (default {K}, an autotune record may adjust);"
            " a pin holds 'auto' to the windowed kernel, unpacked; "
            f"--pallas-engine mega takes {K} only",
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
