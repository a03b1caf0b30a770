"""K1, the windowed multistep: the wrapper of ``csrc/windowed.cu``.

The port's ``multistep`` of ``grayscott_tpu/ops/pallas_stencil.py``
(``multistep``/``run_blocks``, ``:1256-1309``): one call advances the whole
``(R, C)`` state by ``steps <= K`` Gray-Scott steps. On a CUDA tensor it
launches the hand-written kernel on the current stream, or raises. On a
CPU tensor it runs the plain PyTorch version, :func:`multistep_reference`,
since there is no kernel to launch on the CPU.

``launches`` counts the kernel launches, and only them, so that a run can
show that its main path went through the kernel.

:func:`shard_multistep` is K1 on the shard layout of ``parallel/halo.py``,
as ``grayscott_tpu/parallel/halo.py:sharded_run_blocks`` runs
``multistep_impl`` on each shard (``:314-316``): one launch steps every
shard of a mesh from slot ``s`` of its pairs into slot ``1 - s``, all of
a tile set (``part``: every tile, the overlap-interior tiles, or the
rest; ``halo.overlap_tiles``). Its plain version is
:func:`shard_multistep_reference`, and it counts its launches apart, in
``shard_launches``, so that a run can tell the sharded engine's K1 from
the unsharded one. With several processes the pairs are one process's
block of the mesh, and the entry takes the block's place in the mesh
(``Mesh.origin``, 0 and 0 with one process), from which each shard's
global origin, its interior tiles and the naive clamp follow.

Both take bfloat16 storage too (``pallas_stencil.py:_kernel`` with a
bfloat16 dtype, ``:970-993``): on bfloat16 tensors they launch the bf16
entries, which widen each cell to float32 on load and round it back, to
nearest even, once a launch. Their plain versions are
``stencil.run_bf16`` (one block of ``steps`` <= K) and
:func:`shard_multistep_reference` on bfloat16 pairs; their launches are
counted apart, in ``bf16_launches`` and ``bf16_shard_launches``.

``multistep(..., fold=True)`` runs the folded naive reaction
(``pallas_stencil.py:_kernel`` with ``fast_fold``, ``:363-382``,
``:817-859``) on either storage: the fold entries, whose plain versions are
``stencil.run_naive_fold`` and ``stencil.run_naive_fold_bf16``; their
launches are counted in ``fold_launches`` and ``fold_bf16_launches``. They
run the fold's second form (``csrc/gs_fold_sm90.cuh``: 2-D register blocks
with vector shared loads); a float32 state loads its windows through TMA
where ``geometry.tma_ok`` allows it and its pointers are 16-byte aligned
(:func:`fold_load` names the choice; those launches are also counted in
``fold_tma_launches``), else with cp.async. :func:`fold_ablation` runs the
first form and the parts of the split between the two
(:data:`FOLD_ABLATIONS`), on the card only.

:func:`shard_multistep` takes the sharded windowed engine's K and row
tile (``--backend sharded --sharded-engine windowed
--pallas-steps-per-call K --pallas-block-rows N``) as ``geometry``: the
pairs then hold ``geometry.halo`` = ``halo_for_steps(K)`` rows (and
columns on a 2-D mesh) of the neighbours' cells (``mesh.halo``), and any
geometry but the compiled one launches the pinned shard entries of
``csrc/windowed_pins.cu``, counted in ``pinned_shard_launches`` and
``pinned_bf16_shard_launches``; their plain version is
:func:`shard_multistep_reference` at that halo.

``multistep(..., geometry=g)`` runs the tile and depth pins
(``--pallas-block-rows``, ``--pallas-block-cols``,
``--pallas-steps-per-call``; ``ops/geometry.py``): ``g`` the tiles and the
halo, up to ``g.halo`` (at most 32) steps a launch. The compiled geometry
(64x64 tiles, halo 8: ``geometry.DEFAULT``) launches the entries above;
any other launches the pinned entries of ``csrc/windowed_pins.cu`` on all
four storages, counted apart in ``pinned_launches``,
``pinned_bf16_launches``, ``pinned_fold_launches`` and
``pinned_fold_bf16_launches``. Their plain versions are the same as the
compiled entries' (the results do not depend on the tiles; bf16 storage
rounds once a launch, so ``steps`` is the block length). The pinned
entries and the pinned shard entries run their second form
(``csrc/windowed_pins.cuh``: 4x4 register blocks with 16-byte shared loads
on interior tiles, and on ``geometry.FIXED_PINS`` the tile's sizes
compiled in), the fold entries the first; ``Geometry.pin_launch`` says
what a launch runs. :func:`pinned_ablation` and
:func:`pinned_shard_ablation` run the parts of the split that chose it
(:data:`PIN_ABLATIONS`), on the card only.

:func:`folded_multistep` is K1 on the lane-fold layout (``--pallas-fold
F``; ``pallas_stencil.py:_kernel`` with ``fold=(F, Cd, Rp)``, ``:929-933``,
``:1123-1138``, after ``fold_refresh`` as ``run_blocks`` calls it,
``:1287-1297``; ``ops/lane_fold.py``): the entry refreshes the panels'
halo rows of a folded float32 state in place, then steps every panel at
its global origin, on the tiles of a geometry (any K in 1..32, the row
tile pin), into the panels' interior rows of the output. Its plain version
is :func:`folded_multistep_reference`; its calls are counted in
``folded_launches``.
"""

from __future__ import annotations

import ctypes

import torch

from ..params import FoldConstants, KernelConstants
from ..parallel import halo
from . import build, checks, geometry, lane_fold, sharded_mega, stencil

#: most steps one launch may take: the kernel's compile-time halo depth
K = 8

#: the kernel's output tile (rows, cols); each block steps it in a window of
#: K cells more on every side (csrc/windowed.cu: Main)
TILE = (halo.WINDOWED_TILE, halo.WINDOWED_TILE)

#: the compiled geometry (64x64 tiles, halo 8), where none is given
COMPILED = geometry.DEFAULT

#: the tile sets of :func:`shard_multistep`, in the kernel's numbering
PARTS = ("all", "interior", "edge")

#: kernel launches so far (CPU calls run the plain version and add nothing)
launches = 0
#: shard entry launches so far (:func:`shard_multistep`), apart from
#: ``launches``
shard_launches = 0
#: the bf16 entries' launches so far (bfloat16 storage), apart from the
#: float32 ones
bf16_launches = 0
bf16_shard_launches = 0
#: the fold entries' launches so far (float32, bfloat16 storage)
fold_launches = 0
fold_bf16_launches = 0
#: the float32 fold launches that loaded their windows through TMA (also
#: counted in ``fold_launches``)
fold_tma_launches = 0
#: the pinned entries' launches (a geometry other than the compiled one),
#: by storage and mode
pinned_launches = 0
pinned_bf16_launches = 0
pinned_fold_launches = 0
pinned_fold_bf16_launches = 0
#: the pinned shard entries' launches, by storage
pinned_shard_launches = 0
pinned_bf16_shard_launches = 0
#: the folded entry's launches (the lane fold)
folded_launches = 0

#: the C entry of each storage type: (unsharded, shard entry)
_ENTRIES = {torch.float32: ("gs_windowed_multistep",
                            "gs_windowed_shard_multistep"),
            torch.bfloat16: ("gs_windowed_multistep_bf16",
                             "gs_windowed_shard_multistep_bf16")}
#: the fold entry of each storage type
_FOLD_ENTRIES = {torch.float32: "gs_windowed_multistep_fold",
                 torch.bfloat16: "gs_windowed_multistep_fold_bf16"}
#: the pinned entries: (storage type, fold) -> (C entry, its counter's
#: name)
_PINNED = {(torch.float32, False): ("gs_windowed_pinned_multistep",
                                    "pinned_launches"),
           (torch.bfloat16, False): ("gs_windowed_pinned_multistep_bf16",
                                     "pinned_bf16_launches"),
           (torch.float32, True): ("gs_windowed_pinned_multistep_fold",
                                   "pinned_fold_launches"),
           (torch.bfloat16, True): ("gs_windowed_pinned_multistep_fold_bf16",
                                    "pinned_fold_bf16_launches")}

#: the parts of the fold entries' split (csrc/windowed.cu:
#: gs_windowed_fold_ablation; part 4 launches the exact naive entry); each
#: gives the whole kernel's result, the parts of 0 steps their input
FOLD_ABLATIONS = {
    0: "the first form (one-column strips of 4, the cp.async load)",
    1: "the first form's window load and store alone (0 steps)",
    2: "the first form with every tile an edge tile",
    3: "the first form at one block an SM",
    4: "the first form's walk on the exact naive tree",
    5: "the second form with the cp.async load",
    6: "the second form's window load and store alone (0 steps)",
    7: "the second form on 4x2 blocks",
    8: "the second form on 8x4 blocks of 256 threads",
    9: "the second form with the neighbour columns from scalar loads",
    10: "the second form on 2x4 blocks",
    11: "the second form on 416 threads",
    12: "the second form at a window pitch of 80 floats",
}
#: the parts that take no step, the part that runs the exact tree, and the
#: parts built for the TMA load only (other blocks, timed at the entry's
#: load on shapes that load through TMA)
FOLD_ABLATION_NO_STEP = (1, 6)
FOLD_ABLATION_EXACT = 4
FOLD_ABLATION_TMA_ONLY = tuple(range(7, 13))

#: the parts of the pinned entries' split
#: (csrc/splits/windowed_pins_ablation.cu: gs_windowed_pinned_ablation,
#: gs_windowed_shard_pinned_ablation); each
#: gives the whole kernel's result but part 2, whose result is its input;
#: float32, naive, the default stencil's tap set
PIN_ABLATIONS = {
    0: "the first form: run-time sizes, 512 threads, two blocks an SM at "
       "64 registers",
    1: "the first form on 1024 threads at 64 registers",
    2: "the first form's window load and store alone (no step)",
    3: "the first form with every tile an edge tile",
    4: "the first form on the tile's sizes compiled in (64x64 and 32x64 "
       "tiles at a halo of 16)",
    5: "4x4 register blocks with 16-byte shared loads on interior tiles",
    6: "clusters of 2x2 blocks over 2x2 tiles, the inner edges read from "
       "the neighbours' shared memory",
    7: "part 5 walked without a division an item",
    8: "part 7 on the tile's sizes compiled in (64x64 and 32x64 tiles at a "
       "halo of 16)",
    9: "part 7 on 1024 threads at 64 registers",
    10: "part 8 on 1024 threads at 64 registers",
    11: "part 6 with the inner edges sent in a pass of their own",
    12: "the first form's strips walked without a division an item",
    13: "part 11 with the cluster barrier split around the cells that "
        "read no ghost cell",
}
#: the part that takes no step, the tiles part 4 compiles (tr, tc, halo),
#: and the cluster's part
PIN_ABLATION_NO_STEP = 2
#: the parts the shard entry's split runs
PIN_SHARD_ABLATIONS = tuple(range(7))
PIN_ABLATION_FIXED = geometry.FIXED_PINS
PIN_ABLATION_FIXED_PARTS = (4, 8, 10)
PIN_ABLATION_CLUSTERS = (6, 11, 13)

_fns: dict = {}
#: the folded entry's split (csrc/splits/windowed_folded_ablation.cu): part ->
#: what it runs (float32, naive, the default stencils' tap set)
FOLDED_ABLATIONS = {
    0: "the first form: refresh launch, then the step on run-time sizes",
    1: "the refresh launch alone",
    2: "the step launch alone",
    3: "sizes compiled in",
    4: "4x4 register blocks, LDS.128, on interior tiles",
    5: "one launch: windows from the neighbour panels' interior rows",
    6: "3 with 4 and 5",
}
FOLDED_ABLATION_REFRESH = 1
FOLDED_ABLATION_STEP = 2
#: the parts on compiled sizes, and the geometries they compile (64x64 at
#: a halo of 8, Main's, and of 16)
FOLDED_ABLATION_FIXED = (3, 6)
FOLDED_FIXED = ((64, 64, 8), (64, 64, 16))

_checked = False


#: the plain PyTorch version: ``steps`` calls of ``stencil.step``
multistep_reference = stencil.run
#: the plain version on bfloat16 storage: ``steps`` (<= K) float32 steps,
#: rounded once
multistep_reference_bf16 = stencil.run_bf16


def _bind(name: str, argtypes: list, library: str = build.KERNELS):
    """The C entry ``name`` of ``library``, bound once, after the kernel's K
    is checked."""
    global _checked
    if not _checked:
        max_steps = build.bind("gs_windowed_max_steps", [])()
        if max_steps != K:
            raise RuntimeError(f"windowed kernel takes at most {max_steps} "
                               f"steps a launch; this wrapper expects {K}")
        _checked = True
    if name not in _fns:
        _fns[name] = build.bind(name, argtypes, library)
    return _fns[name]


def _pinned_kernel(dtype, fold: bool):
    """The pinned entry of ``dtype`` storage, bound once, after its most
    steps a launch are checked against ``geometry.MAX_STEPS_PER_CALL``."""
    name = _PINNED[dtype, fold][0]
    if name not in _fns:
        most = build.bind("gs_windowed_pinned_max_steps", [])()
        if most != geometry.MAX_STEPS_PER_CALL:
            raise RuntimeError(f"pinned windowed kernel takes at most {most}"
                               f" steps a launch; this wrapper expects "
                               f"{geometry.MAX_STEPS_PER_CALL}")
        args = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                + [ctypes.c_void_p] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
                if fold else
                [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                + [ctypes.c_float] * 14 + [ctypes.c_void_p])
        _fns[name] = build.bind(name, args)
    return _fns[name]


def _kernel(dtype=torch.float32):
    return _bind(_ENTRIES[dtype][0],
                 [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                 + [ctypes.c_float] * 14 + [ctypes.c_void_p])


#: the fold entries' arguments: the four state pointers, rows, cols,
#: steps, device, the constants, separable, dt_is_one, the stream, tma
_FOLD_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
              + [ctypes.c_int] * 2 + [ctypes.c_void_p] + [ctypes.c_int])


def _fold_kernel(dtype=torch.float32):
    return _bind(_FOLD_ENTRIES[dtype], _FOLD_ARGS)


def fold_load(*tensors: torch.Tensor) -> str:
    """How a fold entry loads the windows of these state tensors (one
    shape, on the card): ``"tma"`` for float32 of a shape
    ``geometry.tma_ok`` takes (``pair``: the last two dimensions of K2's
    pairs) with every pointer 16-byte aligned, else ``"cp.async"`` (bf16
    states load through registers under that name)."""
    t = tensors[0]
    shape, pair = tuple(t.shape[-2:]), t.dim() == 3
    ok = (t.dtype == torch.float32 and geometry.tma_ok(shape, pair)
          and all(x.data_ptr() % geometry.TMA_UNIT == 0 for x in tensors))
    return "tma" if ok else "cp.async"


def multistep(u: torch.Tensor, v: torch.Tensor, u_out: torch.Tensor,
              v_out: torch.Tensor, steps: int,
              consts: KernelConstants | FoldConstants, boundary: str,
              fold: bool = False,
              geometry: geometry.Geometry | None = None) -> None:
    """Write the state ``steps`` (1..K, or 1..``geometry.halo``) steps
    after ``(u, v)`` into ``(u_out, v_out)``, all four float32 or all four
    bfloat16. ``fold``: the folded naive reaction, ``consts`` a
    ``FoldConstants`` and the boundary naive. ``geometry``: the tiles and
    halo of the launch (None: the compiled ones). On a CUDA device the
    launch is enqueued on the current stream and not waited for."""
    global launches, bf16_launches
    if geometry is not None and not geometry.compiled:
        _pinned_multistep(u, v, u_out, v_out, steps, consts, boundary, fold,
                          geometry)
        return
    checks.check_count("steps", steps, 1, K)
    checks.check_boundary(boundary)
    checks.check_state((u, v), (u_out, v_out), dtypes=checks.STORAGE_DTYPES)
    if fold:
        _fold_multistep(u, v, u_out, v_out, steps, consts, boundary)
        return
    bf16 = u.dtype == torch.bfloat16
    if u.device.type == "cpu":
        ref = multistep_reference_bf16 if bf16 else multistep_reference
        ru, rv = ref(u, v, steps, consts, boundary)
        u_out.copy_(ru)
        v_out.copy_(rv)
        return
    fn = _kernel(u.dtype)
    rows, cols = u.shape
    stream = torch.cuda.current_stream(u.device).cuda_stream
    err = fn(u.data_ptr(), v.data_ptr(), u_out.data_ptr(), v_out.data_ptr(),
             rows, cols, steps, int(boundary == "naive"), u.device.index,
             *consts.weights, *consts.reaction, stream)
    if err != 0:
        raise RuntimeError(f"windowed kernel launch failed: CUDA error {err} "
                           f"({build.error_name(err)})")
    if bf16:
        bf16_launches += 1
    else:
        launches += 1


def _pinned_multistep(u, v, u_out, v_out, steps, consts, boundary, fold,
                      g: geometry.Geometry) -> None:
    """:func:`multistep` on a geometry other than the compiled one: the
    pinned entries (``csrc/windowed_pins.cu``)."""
    global pinned_launches, pinned_bf16_launches, pinned_fold_launches
    global pinned_fold_bf16_launches
    checks.check_count("steps", steps, 1, g.halo)
    checks.check_boundary(boundary)
    checks.check_state((u, v), (u_out, v_out), dtypes=checks.STORAGE_DTYPES)
    if fold:
        checks.check_fold(consts, boundary)
    bf16 = u.dtype == torch.bfloat16
    if u.device.type == "cpu":
        if fold:
            ru, rv = (stencil.run_naive_fold_bf16(u, v, steps, consts,
                                                  block=steps) if bf16
                      else stencil.run_naive_fold(u, v, steps, consts))
        elif bf16:
            ru, rv = stencil.run_bf16(u, v, steps, consts, boundary,
                                      block=steps)
        else:
            ru, rv = stencil.run(u, v, steps, consts, boundary)
        u_out.copy_(ru)
        v_out.copy_(rv)
        return
    fn = _pinned_kernel(u.dtype, fold)
    rows, cols = u.shape
    stream = torch.cuda.current_stream(u.device).cuda_stream
    head = (u.data_ptr(), v.data_ptr(), u_out.data_ptr(), v_out.data_ptr(),
            rows, cols, steps, *g)
    if fold:
        err = fn(*head, u.device.index, *build.fold_args(consts), stream)
    else:
        err = fn(*head, int(boundary == "naive"), u.device.index,
                 *consts.weights, *consts.reaction, stream)
    if err != 0:
        raise RuntimeError(f"pinned windowed kernel launch failed "
                           f"({g.label()}): CUDA error {err} "
                           f"({build.error_name(err)})")
    if fold and bf16:
        pinned_fold_bf16_launches += 1
    elif fold:
        pinned_fold_launches += 1
    elif bf16:
        pinned_bf16_launches += 1
    else:
        pinned_launches += 1


def _fold_multistep(u, v, u_out, v_out, steps, fc, boundary) -> None:
    """:func:`multistep` with ``fold=True``."""
    global fold_launches, fold_bf16_launches, fold_tma_launches
    checks.check_fold(fc, boundary)
    bf16 = u.dtype == torch.bfloat16
    if u.device.type == "cpu":
        ref = stencil.run_naive_fold_bf16 if bf16 else stencil.run_naive_fold
        ru, rv = ref(u, v, steps, fc)
        u_out.copy_(ru)
        v_out.copy_(rv)
        return
    fn = _fold_kernel(u.dtype)
    rows, cols = u.shape
    tma = fold_load(u, v, u_out, v_out) == "tma"
    stream = torch.cuda.current_stream(u.device).cuda_stream
    err = fn(u.data_ptr(), v.data_ptr(), u_out.data_ptr(), v_out.data_ptr(),
             rows, cols, steps, u.device.index, *build.fold_args(fc), stream,
             int(tma))
    if err != 0:
        raise RuntimeError(f"windowed fold kernel launch failed "
                           f"({'TMA' if tma else 'cp.async'} load): CUDA "
                           f"error {err} ({build.error_name(err)})")
    if bf16:
        fold_bf16_launches += 1
    else:
        fold_launches += 1
        fold_tma_launches += tma


def check_tma_part(part: int, load: str) -> None:
    """Parts 7-12 load through TMA only: refuse them on a state that
    :func:`fold_load` sends to cp.async."""
    if part in FOLD_ABLATION_TMA_ONLY and load != "tma":
        raise ValueError(f"fold ablation part {part} loads through TMA "
                         f"only; this state loads with {load}")


def fold_ablation(u: torch.Tensor, v: torch.Tensor, u_out: torch.Tensor,
                  v_out: torch.Tensor, steps: int, fc: FoldConstants,
                  part: int, exact: KernelConstants | None = None) -> None:
    """The float32 fold entry on the card in the form of ``part``
    (:data:`FOLD_ABLATIONS`), on a stencil with a separable plan: the
    state ``steps`` (1..K) folded steps after ``(u, v)`` into ``(u_out,
    v_out)``, or ``(u, v)`` itself for the parts of no step. Part 4 runs
    the exact naive entry with ``exact`` (the same parameters'
    ``KernelConstants``; its result is ``stencil.run``'s). The second
    form's parts load as :func:`fold_load` says; parts 7-12 load through
    TMA only. Not counted in any launch counter."""
    checks.check_count("steps", steps, 1, K)
    checks.check_state((u, v), (u_out, v_out))
    checks.check_fold(fc, "naive")
    if part not in FOLD_ABLATIONS:
        raise ValueError(f"part must be one of {sorted(FOLD_ABLATIONS)}, "
                         f"got {part!r}")
    if not fc.separable:
        raise ValueError("the fold's ablation parts run the separable plan; "
                         "this stencil has none")
    if part == FOLD_ABLATION_EXACT and not isinstance(exact, KernelConstants):
        raise ValueError("part 4 runs the exact naive entry: pass the same "
                         "parameters' KernelConstants as exact")
    load = fold_load(u, v, u_out, v_out)
    check_tma_part(part, load)
    if u.device.type != "cuda":
        raise ValueError("an ablation runs the kernel: the state must lie on "
                         f"a CUDA device, not {u.device}")
    rows, cols = u.shape
    stream = torch.cuda.current_stream(u.device).cuda_stream
    ptrs = (u.data_ptr(), v.data_ptr(), u_out.data_ptr(), v_out.data_ptr())
    if part == FOLD_ABLATION_EXACT:
        err = _kernel()(*ptrs, rows, cols, steps, 1, u.device.index,
                        *exact.weights, *exact.reaction, stream)
    else:
        fn = _bind("gs_windowed_fold_ablation", _FOLD_ARGS + [ctypes.c_int])
        err = fn(*ptrs, rows, cols, steps, u.device.index,
                 *build.fold_args(fc), stream, int(load == "tma"), part)
    if err != 0:
        raise RuntimeError(f"windowed fold ablation part {part} failed: CUDA "
                           f"error {err} ({build.error_name(err)})")


def _shard_kernel(dtype=torch.float32):
    return _bind(_ENTRIES[dtype][1],
                 [ctypes.c_void_p] * 2 + [ctypes.c_int] * 18
                 + [ctypes.c_float] * 14 + [ctypes.c_void_p])


def _pinned_shard_kernel(dtype=torch.float32):
    """The pinned shard entry of ``dtype`` pairs: the shard entry's
    arguments with ``tr``, ``tc`` and ``halo`` after the rectangle."""
    name = "gs_windowed_shard_pinned_multistep" + (
        "_bf16" if dtype == torch.bfloat16 else "")
    _pinned_kernel(dtype, False)  # checks the most steps a launch
    return _bind(name, [ctypes.c_void_p] * 2 + [ctypes.c_int] * 21
                 + [ctypes.c_float] * 14 + [ctypes.c_void_p])


def part_mask(r_loc: int, c_loc: int, chalo: int, part: str,
              device=None,
              g: geometry.Geometry = geometry.DEFAULT) -> torch.Tensor:
    """Which of a shard's ``r_loc x c_loc`` interior cells the tiles of
    ``part`` store on the tiles of ``g`` (``halo.overlap_tiles``)."""
    ti0, ti1, tj0, tj1 = halo.overlap_tiles(r_loc, c_loc, chalo,
                                            (g.tr, g.tc), g.halo)
    rows = torch.arange(r_loc, device=device) // g.tr
    cols = torch.arange(c_loc, device=device) // g.tc
    inner = (((rows >= ti0) & (rows < ti1))[:, None]
             & ((cols >= tj0) & (cols < tj1))[None, :])
    if part == "interior":
        return inner
    if part == "edge":
        return ~inner
    return torch.ones((r_loc, c_loc), dtype=torch.bool, device=device)


def shard_multistep_reference(u_pairs: torch.Tensor, v_pairs: torch.Tensor,
                              src_slot: int, steps: int,
                              consts: KernelConstants, boundary: str, shape,
                              part: str = "all",
                              g: geometry.Geometry = geometry.DEFAULT,
                              mesh: halo.Mesh | None = None) -> None:
    """The plain version, in place: each shard's padded block of slot
    ``src_slot`` (``g.halo`` halo rows, and columns on a 2-D mesh) takes
    ``steps`` plain steps at its global origin against the domain
    ``shape`` (``stencil.step_at``), and the interior cells of ``part``'s
    tiles (of ``g``) go to slot ``1 - src_slot``, those past the domain as
    0.0 (``step_at`` gives them). On bfloat16 pairs the block is widened
    to float32 first and the cells are rounded to bfloat16 as they are
    stored. The body of ``sharded_mega.sharded_megastep_reference``
    without the pushes. ``mesh``: the pairs are this process's block of
    it (its origin offsets every shard's, its columns decide the halo
    columns); None: the pairs are the whole mesh."""
    n_r, n_c = u_pairs.shape[:2]
    h, dst = g.halo, 1 - src_slot
    row0, col0 = mesh.origin if mesh is not None else (0, 0)
    r_loc, c_loc, ch = halo.interior_extents(u_pairs, mesh or h)
    mask = part_mask(r_loc, c_loc, ch, part, u_pairs.device, g)
    for i in range(n_r):
        for j in range(n_c):
            u = u_pairs[i, j, src_slot].float()
            v = v_pairs[i, j, src_slot].float()
            origin = ((row0 + i) * r_loc - h, (col0 + j) * c_loc - ch)
            for _ in range(steps):
                u, v = stencil.step_at(u, v, consts, boundary, origin, shape)
            for pairs, x in ((u_pairs, u), (v_pairs, v)):
                out = pairs[i, j, dst, h:h + r_loc, ch:ch + c_loc]
                x = x[h:h + r_loc, ch:ch + c_loc].to(pairs.dtype)
                out.copy_(torch.where(mask, x, out))


def shard_multistep(u_pairs: torch.Tensor, v_pairs: torch.Tensor,
                    mesh: halo.Mesh, src_slot: int, steps: int,
                    consts: KernelConstants, boundary: str, shape,
                    part: str = "all",
                    geometry: geometry.Geometry | None = None) -> None:
    """Advance every shard of ``mesh`` by ``steps`` (1..K, or
    1..``geometry.halo``) steps of the domain ``shape`` (R, C), from slot
    ``src_slot`` of the pairs (its halos filled: ``halo.exchange_halos``)
    into the interior of slot ``1 - src_slot``, for the tiles of ``part``
    (:data:`PARTS`). ``geometry``: the tiles and halo (None: the compiled
    64x64 at 8), whose halo is the mesh's. The pairs are float32 or
    bfloat16, this process's block of the mesh (the whole mesh with one
    process): the kernel takes the block's place in the mesh, so each
    shard steps at its global origin. On a CUDA device one launch is
    enqueued on the current stream and not waited for; an ``"interior"``
    part with no tile launches nothing."""
    global shard_launches, bf16_shard_launches
    global pinned_shard_launches, pinned_bf16_shard_launches
    g = geometry or COMPILED
    if g.halo != mesh.halo:
        raise ValueError(f"the tiles' halo ({g.label()}) must be the "
                         f"mesh's, {mesh.halo}")
    checks.check_count("steps", steps, 1, g.halo)
    checks.check_boundary(boundary)
    if src_slot not in (0, 1):
        raise ValueError(f"src_slot must be 0 or 1, got {src_slot!r}")
    if part not in PARTS:
        raise ValueError(f"part must be one of {PARTS}, got {part!r}")
    sharded_mega.check_pairs(u_pairs, v_pairs, mesh, shape)
    if u_pairs.device.type == "cpu":
        shard_multistep_reference(u_pairs, v_pairs, src_slot, steps, consts,
                                  boundary, shape, part, g, mesh)
        return
    r_loc, c_loc, ch = halo.interior_extents(u_pairs, mesh)
    rect = halo.overlap_tiles(r_loc, c_loc, ch, (g.tr, g.tc), g.halo)
    if part == "interior" and rect[1] == rect[0]:
        return
    bf16 = u_pairs.dtype == torch.bfloat16
    pinned = not g.compiled
    fn = _pinned_shard_kernel(u_pairs.dtype) if pinned \
        else _shard_kernel(u_pairs.dtype)
    stream = torch.cuda.current_stream(u_pairs.device).cuda_stream
    err = fn(u_pairs.data_ptr(), v_pairs.data_ptr(), *mesh.local_shape,
             *mesh.origin, r_loc, c_loc, ch, src_slot, shape[0], shape[1],
             steps, PARTS.index(part), *rect, *((*g,) if pinned else ()),
             int(boundary == "naive"), u_pairs.device.index,
             *consts.weights, *consts.reaction, stream)
    if err != 0:
        raise RuntimeError(f"windowed shard kernel launch failed "
                           f"({g.label()}): CUDA error {err} "
                           f"({build.error_name(err)})")
    if pinned and bf16:
        pinned_bf16_shard_launches += 1
    elif pinned:
        pinned_shard_launches += 1
    elif bf16:
        bf16_shard_launches += 1
    else:
        shard_launches += 1


def folded_multistep_reference(u: torch.Tensor, v: torch.Tensor,
                               u_out: torch.Tensor, v_out: torch.Tensor,
                               steps: int, consts: KernelConstants,
                               boundary: str, shape, rp: int,
                               halo: int, refresh: bool = True) -> None:
    """The plain version of :func:`folded_multistep`: the panels' halo
    rows of ``(u, v)`` refreshed in place (``lane_fold.fold_refresh``;
    ``refresh=False``: read as they are), then each panel's columns (its
    interior and halo rows) take ``steps`` plain steps at its global origin
    ``(p*rp - halo, 0)`` against the domain ``shape``
    (``stencil.step_at``), and their interior rows go to ``(u_out,
    v_out)``, the dead rows as the 0.0 ``step_at`` gives them."""
    c = shape[1]
    for x in (u, v) if refresh else ():
        lane_fold.fold_refresh(x, halo, u.shape[1] // c, c, rp)
    for p in range(u.shape[1] // c):
        cols = slice(p * c, (p + 1) * c)
        a, b = u[:, cols], v[:, cols]
        for _ in range(steps):
            a, b = stencil.step_at(a, b, consts, boundary, (p * rp - halo, 0),
                                   shape)
        u_out[halo:halo + rp, cols] = a[halo:halo + rp]
        v_out[halo:halo + rp, cols] = b[halo:halo + rp]


def folded_one_launch_reference(u: torch.Tensor, v: torch.Tensor,
                                u_out: torch.Tensor, v_out: torch.Tensor,
                                steps: int, consts: KernelConstants,
                                boundary: str, shape, rp: int,
                                halo: int) -> None:
    """The plain version of the folded entry's one-launch form: each
    panel's window read from its neighbours' interior rows
    (``lane_fold.panel_window``), ``steps`` plain steps at its global
    origin, its interior rows into ``(u_out, v_out)``; then the halo rows
    of ``(u, v)`` that the refresh leaves (``lane_fold.fold_refresh``).
    Equal to :func:`folded_multistep_reference` bit for bit."""
    c = shape[1]
    f = u.shape[1] // c
    for p in range(f):
        a, b = (lane_fold.panel_window(x, halo, f, c, rp, p) for x in (u, v))
        for _ in range(steps):
            a, b = stencil.step_at(a, b, consts, boundary, (p * rp - halo, 0),
                                   shape)
        u_out[halo:halo + rp, p * c:(p + 1) * c] = a[halo:halo + rp]
        v_out[halo:halo + rp, p * c:(p + 1) * c] = b[halo:halo + rp]
    for x in (u, v):
        lane_fold.fold_refresh(x, halo, f, c, rp)


def _check_folded(x: torch.Tensor, shape, rp: int,
                  g: geometry.Geometry) -> int:
    """The panels of a folded state of the domain ``shape`` at panel
    stride ``rp`` on the tiles of ``g`` (ValueError where the layout does
    not hold them: ``lane_fold.fold_state``'s shape, ``rp`` its
    ``fold_geometry`` and, with more than one panel, no thinner than the
    halo that ``lane_fold.fold_refresh`` copies)."""
    r, c = shape
    f = x.shape[1] // c if x.dim() == 2 else 0
    if f < 1 or tuple(x.shape) != (rp + 2 * g.halo, f * c):
        raise ValueError(f"a folded state of {r}x{c} at Rp={rp}, halo "
                         f"{g.halo} is ({rp + 2 * g.halo}, F*{c}), got "
                         f"{tuple(x.shape)}")
    if lane_fold.fold_geometry(r, f, g.tr) != rp or (f > 1 and rp < g.halo):
        raise ValueError(f"panel stride {rp} is not fold_geometry({r}, {f}, "
                         f"{g.tr}) (a multiple of the row tile, at least "
                         f"the {g.halo}-row halo)")
    return f


def _folded_kernel():
    name = "gs_windowed_folded_multistep"
    if name not in _fns:
        _pinned_kernel(torch.float32, False)  # checks the most steps
        _fns[name] = build.bind(name, [ctypes.c_void_p] * 4
                                + [ctypes.c_int] * 10 + [ctypes.c_float] * 14
                                + [ctypes.c_void_p])
    return _fns[name]


def folded_multistep(u: torch.Tensor, v: torch.Tensor, u_out: torch.Tensor,
                     v_out: torch.Tensor, steps: int,
                     consts: KernelConstants, boundary: str, shape, rp: int,
                     geometry: geometry.Geometry) -> None:
    """Write the state ``steps`` (1..``geometry.halo``) steps after the
    folded float32 state ``(u, v)`` into the interior rows of ``(u_out,
    v_out)``, every panel of the domain ``shape`` (R, C) at panel stride
    ``rp`` stepped at its global origin on the tiles of ``geometry``, and
    leave the panels' halo rows of ``(u, v)`` refreshed in place; the
    dead rows and halo rows of ``(u_out, v_out)`` are not written. On a
    CUDA device this is one launch, enqueued on the current stream and not
    waited for: each window reads a panel's halo rows from its neighbour
    panels' interior rows, and the blocks of each panel's first and last
    tile rows write the refreshed halo rows. On the CPU it is the plain
    version, the refresh and then the step."""
    global folded_launches
    g = geometry
    checks.check_count("steps", steps, 1, g.halo)
    checks.check_boundary(boundary)
    checks.check_state((u, v), (u_out, v_out))
    f = _check_folded(u, shape, rp, g)
    if u.device.type == "cpu":
        folded_multistep_reference(u, v, u_out, v_out, steps, consts,
                                   boundary, shape, rp, g.halo)
        return
    stream = torch.cuda.current_stream(u.device).cuda_stream
    err = _folded_kernel()(
        u.data_ptr(), v.data_ptr(), u_out.data_ptr(), v_out.data_ptr(),
        shape[0], shape[1], f, rp, steps, *g, int(boundary == "naive"),
        u.device.index, *consts.weights, *consts.reaction, stream)
    if err != 0:
        raise RuntimeError(f"folded windowed kernel launch failed "
                           f"({g.label()}, F={f}, Rp={rp}): CUDA error {err} "
                           f"({build.error_name(err)})")
    folded_launches += 1


def folded_ablation_reference(part: int, u: torch.Tensor, v: torch.Tensor,
                              u_out: torch.Tensor, v_out: torch.Tensor,
                              steps: int, consts: KernelConstants,
                              boundary: str, shape, rp: int,
                              halo: int) -> None:
    """The plain version of :func:`folded_ablation`'s part: part 1 the
    refresh alone (``lane_fold.fold_refresh`` of ``(u, v)``), part 2 the
    step of the halo rows as they are (:func:`folded_multistep_reference`
    of a state whose halo rows are already fresh), every other part
    :func:`folded_multistep_reference`."""
    c = shape[1]
    if part == FOLDED_ABLATION_REFRESH:
        for x in (u, v):
            lane_fold.fold_refresh(x, halo, u.shape[1] // c, c, rp)
        return
    folded_multistep_reference(u, v, u_out, v_out, steps, consts, boundary,
                               shape, rp, halo,
                               refresh=part != FOLDED_ABLATION_STEP)


def check_folded_part(part: int, g: geometry.Geometry,
                      consts: KernelConstants, boundary: str) -> None:
    """Refuse a part of :data:`FOLDED_ABLATIONS` that does not run on the
    tiles of ``g``, the weights of ``consts`` or ``boundary``
    (ValueError): the split runs the naive boundary on the default
    stencils' tap set, and parts 3 and 6 compile 64x64 tiles at a halo of
    8 or 16 only (:data:`FOLDED_FIXED`)."""
    if part not in FOLDED_ABLATIONS:
        raise ValueError(f"part must be one of {sorted(FOLDED_ABLATIONS)}, "
                         f"got {part!r}")
    mask = sum(1 << t for t, w in enumerate(consts.weights) if w != 0.0)
    if mask != TAPS_RING or boundary != "naive":
        raise ValueError("the folded split runs the naive boundary on the "
                         "default stencils' tap set")
    if part in FOLDED_ABLATION_FIXED and tuple(g) not in FOLDED_FIXED:
        raise ValueError(f"part {part} compiles {FOLDED_FIXED} only, not "
                         f"{g.label()}")


def folded_ablation(part: int, u: torch.Tensor, v: torch.Tensor,
                    u_out: torch.Tensor, v_out: torch.Tensor, steps: int,
                    consts: KernelConstants, boundary: str, shape, rp: int,
                    geometry: geometry.Geometry) -> None:
    """K1's folded entry on the card in the form of ``part``
    (:data:`FOLDED_ABLATIONS`), with :func:`folded_multistep`'s arguments;
    the naive boundary on the default stencils' tap set. Not the main path:
    nothing is counted.
    On the CPU it runs the part's plain version
    (:func:`folded_ablation_reference`)."""
    g = geometry
    checks.check_count("steps", steps, 1, g.halo)
    checks.check_boundary(boundary)
    checks.check_state((u, v), (u_out, v_out))
    f = _check_folded(u, shape, rp, g)
    check_folded_part(part, g, consts, boundary)
    if u.device.type == "cpu":
        folded_ablation_reference(part, u, v, u_out, v_out, steps, consts,
                                  boundary, shape, rp, g.halo)
        return
    fn = build.bind("gs_windowed_folded_ablation",
                    [ctypes.c_int] + [ctypes.c_void_p] * 4
                    + [ctypes.c_int] * 10 + [ctypes.c_float] * 14
                    + [ctypes.c_void_p], build.SPLITS)
    err = fn(part, u.data_ptr(), v.data_ptr(), u_out.data_ptr(),
             v_out.data_ptr(), shape[0], shape[1], f, rp, steps, *g,
             int(boundary == "naive"), u.device.index, *consts.weights,
             *consts.reaction,
             torch.cuda.current_stream(u.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"folded ablation part {part} ({g.label()}, "
                           f"F={f}, Rp={rp}): CUDA error {err} "
                           f"({build.error_name(err)})")


def check_pin_part(part: int, g: geometry.Geometry) -> None:
    """Refuse a part of :data:`PIN_ABLATIONS` that does not run on the
    tiles of ``g`` (ValueError): part 4 compiles two geometries only, and
    each part's shared memory must fit a block."""
    if part not in PIN_ABLATIONS:
        raise ValueError(f"part must be one of {sorted(PIN_ABLATIONS)}, got "
                         f"{part!r}")
    if part in PIN_ABLATION_FIXED_PARTS and tuple(g) not in \
            PIN_ABLATION_FIXED:
        raise ValueError(f"part {part} compiles {PIN_ABLATION_FIXED} only, "
                         f"not {g.label()}")
    if pin_part_bytes(part, g) > geometry.SMEM_OPTIN:
        raise ValueError(f"part {part} on {g.label()} needs "
                         f"{pin_part_bytes(part, g)} B a block")


def pin_part_bytes(part: int, g: geometry.Geometry) -> int:
    """Dynamic shared memory of a block of ``part`` on ``g``: the window
    pair's two buffers (the cluster parts the cluster's windows,
    ``geometry.cluster_bytes``)."""
    if part in PIN_ABLATION_CLUSTERS:
        return geometry.cluster_bytes(g.tr, g.tc, g.halo)
    return g.bytes


#: the default stencils' tap set (csrc/gs_tile_sm90.cuh: TAPS_RING; bit t:
#: weight t, row-major, is nonzero), the one the pinned split compiles
TAPS_RING = 0x1EF


def _pin_consts(consts: KernelConstants, boundary: str) -> None:
    mask = sum(1 << t for t, w in enumerate(consts.weights) if w != 0.0)
    if boundary != "naive" or mask != TAPS_RING:
        raise ValueError("the pinned split runs the naive boundary on the "
                         "default stencil's tap set")


def pinned_ablation(part: int, u: torch.Tensor, v: torch.Tensor,
                    u_out: torch.Tensor, v_out: torch.Tensor, steps: int,
                    consts: KernelConstants, g: geometry.Geometry) -> None:
    """K1's pinned entry on the card in the form of ``part``
    (:data:`PIN_ABLATIONS`): the float32 state ``steps`` (1..``g.halo``)
    naive steps after ``(u, v)`` into ``(u_out, v_out)`` on the tiles of
    ``g`` (part 2: the state itself). Not counted in any launch counter."""
    checks.check_count("steps", steps, 1, g.halo)
    checks.check_state((u, v), (u_out, v_out))
    check_pin_part(part, g)
    _pin_consts(consts, "naive")
    if u.device.type != "cuda":
        raise ValueError("an ablation runs the kernel: the state must lie on "
                         f"a CUDA device, not {u.device}")
    fn = _bind("gs_windowed_pinned_ablation",
               _pinned_kernel(torch.float32, False).argtypes + [ctypes.c_int],
               build.SPLITS)
    rows, cols = u.shape
    stream = torch.cuda.current_stream(u.device).cuda_stream
    err = fn(u.data_ptr(), v.data_ptr(), u_out.data_ptr(), v_out.data_ptr(),
             rows, cols, steps, *g, 1, u.device.index, *consts.weights,
             *consts.reaction, stream, part)
    if err != 0:
        raise RuntimeError(f"pinned windowed ablation part {part} failed "
                           f"({g.label()}): CUDA error {err} "
                           f"({build.error_name(err)})")


def pinned_shard_ablation(part: int, u_pairs: torch.Tensor,
                          v_pairs: torch.Tensor, mesh: halo.Mesh,
                          src_slot: int, steps: int, consts: KernelConstants,
                          shape, g: geometry.Geometry,
                          tiles: str = "all") -> None:
    """K1's pinned shard entry on the card in the form of ``part``
    (:data:`PIN_SHARD_ABLATIONS` of :data:`PIN_ABLATIONS`):
    :func:`shard_multistep` of the float32 pairs on the tiles of ``g``
    (``tiles``: the tile set, :data:`PARTS`; part 6 takes ``"all"``
    only), naive boundary. Not counted in any launch counter."""
    if part not in PIN_SHARD_ABLATIONS:
        raise ValueError(f"the shard entry's split runs parts "
                         f"{PIN_SHARD_ABLATIONS}, not {part!r}")
    if g.halo != mesh.halo:
        raise ValueError(f"the tiles' halo ({g.label()}) must be the "
                         f"mesh's, {mesh.halo}")
    checks.check_count("steps", steps, 1, g.halo)
    if tiles not in PARTS:
        raise ValueError(f"tiles must be one of {PARTS}, got {tiles!r}")
    if part in PIN_ABLATION_CLUSTERS and tiles != "all":
        raise ValueError(f"part {part} (the cluster) steps every tile: tiles "
                         "must be 'all'")
    check_pin_part(part, g)
    _pin_consts(consts, "naive")
    sharded_mega.check_pairs(u_pairs, v_pairs, mesh, shape)
    if u_pairs.dtype != torch.float32 or u_pairs.device.type != "cuda":
        raise ValueError("an ablation runs the kernel: the pairs must be "
                         "float32 on a CUDA device")
    r_loc, c_loc, ch = halo.interior_extents(u_pairs, mesh)
    rect = halo.overlap_tiles(r_loc, c_loc, ch, (g.tr, g.tc), g.halo)
    fn = _bind("gs_windowed_shard_pinned_ablation",
               _pinned_shard_kernel().argtypes + [ctypes.c_int], build.SPLITS)
    stream = torch.cuda.current_stream(u_pairs.device).cuda_stream
    err = fn(u_pairs.data_ptr(), v_pairs.data_ptr(), *mesh.local_shape,
             *mesh.origin, r_loc, c_loc, ch, src_slot, shape[0], shape[1],
             steps, PARTS.index(tiles), *rect, *g, 1,
             u_pairs.device.index, *consts.weights, *consts.reaction, stream,
             part)
    if err != 0:
        raise RuntimeError(f"pinned windowed shard ablation part {part} "
                           f"failed ({g.label()}): CUDA error {err} "
                           f"({build.error_name(err)})")
