"""The fold entries' second form on the CPU (``csrc/gs_fold_sm90.cuh``): the
CPU twin of its walk, the TMA rule, and the argument checks of the fold
ablation wrappers, which run only on the card.

``stencil.fold_block_walk`` steps each tile's window as the kernel does,
the valid region's columns rounded outward to the blocks' C columns, with
NaN in every cell outside the valid region and one cell past the window
(the garbage the kernel leaves there): interior tiles on the bulk fold,
edge tiles on the per-cell fold. Tolerances: none against
``stencil.run_naive_fold`` (the twin must equal it bit for bit, NaN and Inf
included: no valid cell may read an invalid one); atol 1e-6 against JAX's
fold in interpret mode, the budget tests/test_torch_naive_fold.py gives
(XLA:CPU contracts some multiply-adds that the port rounds twice)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from grayscott_tpu_torch.ops import geometry, megakernel, stencil, windowed
from grayscott_tpu_torch.params import (STENCILS, Parameters, fold_constants,
                                        kernel_constants)

from conftest import random_uv
from test_torch_naive_fold import jax_run

#: widths that are not a multiple of C, and a square; each with a tile
#: small enough that some windows lie inside the domain (the kernel's own
#: 64x64 tiles at 200x264)
WALKS = [((37, 61), (8, 8)), ((131, 259), (16, 16)), ((64, 64), (16, 16)),
         ((200, 264), (64, 64))]

CASES = [(shape, tile, name, steps, c)
         for shape, tile in WALKS for name in sorted(STENCILS)
         for steps in (1, 8) for c in (2, 4)]


def bits(pair):
    return [x.view(torch.int32) for x in pair]


def assert_bitwise(got, want):
    for g, w in zip(bits(got), bits(want)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("shape,tile,name,steps,c", CASES)
def test_block_walk_is_the_plain_fold(rng, shape, tile, name, steps, c):
    """Every stencil, dt = 0.5, K 1 and 8, blocks of 2 and 4 columns: bit
    for bit ``run_naive_fold``, with some windows walked."""
    assert stencil.interior_tiles(shape, tile, 8) > 0
    fc = fold_constants(Parameters.with_stencil(name, time_step=0.5))
    u, v = (torch.from_numpy(x) for x in random_uv(rng, shape))
    assert_bitwise(stencil.fold_block_walk(u, v, steps, fc, c, tile),
                   stencil.run_naive_fold(u, v, steps, fc))


@pytest.mark.parametrize("shape", [(5, 7), (1, 9), (9, 1), (70, 97)])
def test_block_walk_edge_tiles_only(rng, shape):
    """Domains with no interior tile (one row, one column, smaller than a
    tile, ragged): every window reaches past the domain."""
    fc = fold_constants(Parameters.with_stencil("pretty", time_step=0.5))
    u, v = (torch.from_numpy(x) for x in random_uv(rng, shape))
    for steps in (1, 8):
        assert_bitwise(stencil.fold_block_walk(u, v, steps, fc),
                       stencil.run_naive_fold(u, v, steps, fc))


@pytest.mark.parametrize("c", [2, 4])
def test_block_walk_nan_and_inf(rng, c):
    """NaN and +-Inf in interior and edge tiles: the same bits."""
    u, v = random_uv(rng, (200, 264))
    u[100, 150] = v[70, 80] = np.nan
    v[90, 140] = u[130, 200] = np.inf
    u[120, 7] = v[-1, -1] = -np.inf
    u, v = torch.from_numpy(u), torch.from_numpy(v)
    fc = fold_constants(Parameters())
    assert_bitwise(stencil.fold_block_walk(u, v, 8, fc, c),
                   stencil.run_naive_fold(u, v, 8, fc))


def test_block_walk_refuses_what_the_kernel_cannot_walk():
    fc = fold_constants(Parameters())
    u = torch.zeros(40, 40)
    with pytest.raises(ValueError):
        stencil.fold_block_walk(u, u, 9, fc)  # past the halo
    with pytest.raises(ValueError):
        stencil.fold_block_walk(u, u, 0, fc)
    with pytest.raises(ValueError):
        stencil.fold_block_walk(u, u, 1, fc, 4, (6, 6), 8)  # width 22


def test_block_walk_matches_jax(rng):
    """The twin against JAX's fast fold in interpret mode, 8 steps: 1e-6."""
    u, v = random_uv(rng, (40, 32))
    assert stencil.interior_tiles((40, 32), (8, 8), 8) > 0
    got = stencil.fold_block_walk(torch.from_numpy(u), torch.from_numpy(v),
                                  8, fold_constants(Parameters()), 4, (8, 8))
    (want,) = jax_run(u, v, [8], engine="windowed", naive_fold=True,
                      dtype="float32")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape,pair,ok", [
    ((1080, 1920), False, True), ((1080, 1920), True, True),
    ((4096, 4096), False, True), ((4096, 4096), True, True),
    ((1000, 1917), False, False), ((1000, 1917), True, False),
    ((1001, 1920), True, True), ((1081, 1924), True, True),
    ((7, 4), True, True), ((3, 6), False, False), ((0, 8), False, False)])
def test_tma_rule(shape, pair, ok):
    """TMA's row stride is a multiple of 16 bytes: C a multiple of 4; K2's
    second plane then starts 16-byte aligned whatever R (odd R
    included)."""
    assert geometry.tma_ok(shape, pair) is ok


def test_fold_load_names_the_choice():
    """``fold_load``: TMA for aligned float32 of a shape the rule takes;
    cp.async for bf16, for 1917 columns and for a pointer 4 bytes off."""
    u = torch.zeros(16, 32)
    assert windowed.fold_load(u, u.clone()) == "tma"
    assert windowed.fold_load(torch.zeros(2, 16, 32)) == "tma"
    assert windowed.fold_load(u.bfloat16()) == "cp.async"
    assert windowed.fold_load(torch.zeros(16, 17)) == "cp.async"
    off = torch.zeros(16 * 32 + 1)[1:].view(16, 32)
    assert windowed.fold_load(off, u) == "cp.async"


ABLATION_CASES = ["part_unknown", "part_negative", "cpu", "steps_zero",
                  "steps_over", "bf16", "direct_plan", "exact_missing",
                  "not_fold_constants", "tma_only_on_cp_async"]


def _ablation_args(kind):
    """K1's fold ablation arguments for one refusal."""
    fc = fold_constants(Parameters())
    state = [torch.rand(16, 24) for _ in range(4)]
    args = dict(steps=1, fc=fc, part=0)
    if kind == "part_unknown":
        args["part"] = max(windowed.FOLD_ABLATIONS) + 1
    elif kind == "part_negative":
        args["part"] = -1
    elif kind == "steps_zero":
        args["steps"] = 0
    elif kind == "steps_over":
        args["steps"] = windowed.K + 1
    elif kind == "bf16":
        state = [x.bfloat16() for x in state]
    elif kind == "direct_plan":
        args["fc"] = fold_constants(Parameters.with_stencil("5points"))
    elif kind == "exact_missing":
        args["part"] = windowed.FOLD_ABLATION_EXACT
    elif kind == "not_fold_constants":
        args["fc"] = kernel_constants(Parameters())
    elif kind == "tma_only_on_cp_async":
        state = [torch.rand(16, 23) for _ in range(4)]
        args["part"] = min(windowed.FOLD_ABLATION_TMA_ONLY)
    return state, args


@pytest.mark.parametrize("kind", ABLATION_CASES)
def test_windowed_fold_ablation_rejects_bad_arguments(kind):
    """K1's fold ablation wrapper checks its arguments, refuses a part it
    does not have, a stencil without a separable plan and part 4 without
    the exact constants, and runs only on the card; no call counts a
    launch."""
    state, args = _ablation_args(kind)
    before = (windowed.fold_launches, windowed.launches)
    with pytest.raises((ValueError, TypeError)):
        windowed.fold_ablation(*state, **args)
    assert (windowed.fold_launches, windowed.launches) == before


@pytest.mark.parametrize("kind", ABLATION_CASES)
def test_mega_fold_ablation_rejects_bad_arguments(kind):
    """K2's fold ablation wrapper: the same refusals on (2, R, C) pairs."""
    state, args = _ablation_args(kind)
    pairs = [megakernel.pair_state(x) for x in state[:2]]
    before = (megakernel.fold_launches, megakernel.launches)
    with pytest.raises((ValueError, TypeError)):
        megakernel.fold_ablation(*pairs, 1, args["steps"], args["fc"],
                                 args["part"])
    assert (megakernel.fold_launches, megakernel.launches) == before


def test_fold_ablation_parts_are_numbered_alike():
    """Both entries' parts share one numbering; part 4 is the exact tree,
    parts 1 and 6 take no step, and the other blocks (7-12) load through
    TMA only."""
    parts = set(windowed.FOLD_ABLATIONS)
    assert megakernel.FOLD_ABLATIONS == windowed.FOLD_ABLATIONS
    assert set(windowed.FOLD_ABLATION_NO_STEP) < parts
    assert windowed.FOLD_ABLATION_EXACT in parts
    assert set(windowed.FOLD_ABLATION_TMA_ONLY) == parts - set(range(7))


def test_tma_only_parts_refuse_a_cp_async_state():
    """The refusal names the load, before the device is looked at."""
    with pytest.raises(ValueError, match="TMA only"):
        windowed.check_tma_part(7, "cp.async")
    windowed.check_tma_part(7, "tma")
    windowed.check_tma_part(6, "cp.async")
