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
the unsharded one.

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
launches are counted in ``fold_launches`` and ``fold_bf16_launches``.

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
rounds once a launch, so ``steps`` is the block length).
"""

from __future__ import annotations

import ctypes

import torch

from ..params import FoldConstants, KernelConstants
from ..parallel import halo
from . import build, checks, geometry, sharded_mega, stencil

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
#: the pinned entries' launches (a geometry other than the compiled one),
#: by storage and mode
pinned_launches = 0
pinned_bf16_launches = 0
pinned_fold_launches = 0
pinned_fold_bf16_launches = 0
#: the pinned shard entries' launches, by storage
pinned_shard_launches = 0
pinned_bf16_shard_launches = 0

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

_fns: dict = {}
_checked = False


#: the plain PyTorch version: ``steps`` calls of ``stencil.step``
multistep_reference = stencil.run
#: the plain version on bfloat16 storage: ``steps`` (<= K) float32 steps,
#: rounded once
multistep_reference_bf16 = stencil.run_bf16


def _bind(name: str, argtypes: list):
    """The C entry ``name``, bound once, after the kernel's K is checked."""
    global _checked
    if not _checked:
        max_steps = build.bind("gs_windowed_max_steps", [])()
        if max_steps != K:
            raise RuntimeError(f"windowed kernel takes at most {max_steps} "
                               f"steps a launch; this wrapper expects {K}")
        _checked = True
    if name not in _fns:
        _fns[name] = build.bind(name, argtypes)
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


def _fold_kernel(dtype=torch.float32):
    return _bind(_FOLD_ENTRIES[dtype],
                 [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                 + [ctypes.c_void_p] + [ctypes.c_int] * 2
                 + [ctypes.c_void_p])


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
    global fold_launches, fold_bf16_launches
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
    stream = torch.cuda.current_stream(u.device).cuda_stream
    err = fn(u.data_ptr(), v.data_ptr(), u_out.data_ptr(), v_out.data_ptr(),
             rows, cols, steps, u.device.index, *build.fold_args(fc), stream)
    if err != 0:
        raise RuntimeError(f"windowed fold kernel launch failed: CUDA error "
                           f"{err} ({build.error_name(err)})")
    if bf16:
        fold_bf16_launches += 1
    else:
        fold_launches += 1


def _shard_kernel(dtype=torch.float32):
    return _bind(_ENTRIES[dtype][1],
                 [ctypes.c_void_p] * 2 + [ctypes.c_int] * 16
                 + [ctypes.c_float] * 14 + [ctypes.c_void_p])


def _pinned_shard_kernel(dtype=torch.float32):
    """The pinned shard entry of ``dtype`` pairs: the shard entry's
    arguments with ``tr``, ``tc`` and ``halo`` after the rectangle."""
    name = "gs_windowed_shard_pinned_multistep" + (
        "_bf16" if dtype == torch.bfloat16 else "")
    _pinned_kernel(dtype, False)  # checks the most steps a launch
    return _bind(name, [ctypes.c_void_p] * 2 + [ctypes.c_int] * 19
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
                              g: geometry.Geometry = geometry.DEFAULT
                              ) -> None:
    """The plain version, in place: each shard's padded block of slot
    ``src_slot`` (``g.halo`` halo rows, and columns on a 2-D mesh) takes
    ``steps`` plain steps at its global origin against the domain
    ``shape`` (``stencil.step_at``), and the interior cells of ``part``'s
    tiles (of ``g``) go to slot ``1 - src_slot``, those past the domain as
    0.0 (``step_at`` gives them). On bfloat16 pairs the block is widened
    to float32 first and the cells are rounded to bfloat16 as they are
    stored. The body of ``sharded_mega.sharded_megastep_reference``
    without the pushes."""
    n_r, n_c = u_pairs.shape[:2]
    h, dst = g.halo, 1 - src_slot
    r_loc, c_loc, ch = halo.interior_extents(u_pairs, h)
    mask = part_mask(r_loc, c_loc, ch, part, u_pairs.device, g)
    for i in range(n_r):
        for j in range(n_c):
            u = u_pairs[i, j, src_slot].float()
            v = v_pairs[i, j, src_slot].float()
            for _ in range(steps):
                u, v = stencil.step_at(u, v, consts, boundary,
                                       (i * r_loc - h, j * c_loc - ch), shape)
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
    bfloat16. On a CUDA device one launch is enqueued on the current
    stream and not waited for; an ``"interior"`` part with no tile
    launches nothing."""
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
                                  boundary, shape, part, g)
        return
    r_loc, c_loc, ch = halo.interior_extents(u_pairs, g.halo)
    rect = halo.overlap_tiles(r_loc, c_loc, ch, (g.tr, g.tc), g.halo)
    if part == "interior" and rect[1] == rect[0]:
        return
    bf16 = u_pairs.dtype == torch.bfloat16
    pinned = not g.compiled
    fn = _pinned_shard_kernel(u_pairs.dtype) if pinned \
        else _shard_kernel(u_pairs.dtype)
    stream = torch.cuda.current_stream(u_pairs.device).cuda_stream
    err = fn(u_pairs.data_ptr(), v_pairs.data_ptr(), mesh.n_rows,
             mesh.n_cols, r_loc, c_loc, ch, src_slot, shape[0], shape[1],
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
