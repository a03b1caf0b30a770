"""The second form of K1's pinned entries on the CPU (``csrc/gs_pin_sm90.cuh``,
``csrc/windowed_pins.cuh``): the host's launch choice for every geometry of
the pins matrix, the plan of the 4x4 register blocks on interior tiles,
the CPU twin of the split's cluster part (``stencil.cluster_walk``), and
the split's refusals. The kernels themselves run on the card
(``chip_smoke.py`` phase 23). Tolerances: none against ``stencil.run`` (the
twin must equal it bit for bit, NaN and Inf included); atol 1e-6 against
the JAX package's oracle, the budget of the other pinned tests."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from grayscott_tpu import oracle
from grayscott_tpu.params import Parameters as JaxParameters
from grayscott_tpu_torch.errors import UnsupportedConfigError
from grayscott_tpu_torch.ops import geometry, stencil, windowed
from grayscott_tpu_torch.params import Parameters, kernel_constants

from conftest import random_uv

#: the tile pins of the matrix (test_torch_tile_pins.py's), with a width
#: that is not a multiple of 4 and the sharded engine's row tile
TILES = [(None, None), (32, 32), (8, 512), (64, 128), (128, 32), (8, None),
         (16, 8), (None, 13), (32, None), (544, 64)]


def pins_matrix():
    """(K, geometry) of every accepted pin of the matrix at 4096^2."""
    out = []
    for k in range(1, geometry.MAX_STEPS_PER_CALL + 1):
        for tr, tc in TILES:
            try:
                out.append((k, geometry.resolve((4096, 4096), k, tr, tc)))
            except UnsupportedConfigError:
                continue
    return out


@pytest.mark.parametrize("k", list(range(1, 33)))
def test_launch_choice_from_the_window_bytes(k):
    """Every pinned geometry at K: Main's 512 threads, no cluster, the
    blocks an SM that the window's bytes leave (at most two, by
    registers), 4x4 blocks but for the fold, sizes compiled in exactly on
    FIXED_PINS for the default stencils' tap set."""
    for kk, g in pins_matrix():
        if kk != k or g.compiled:
            continue
        launch = g.pin_launch()
        assert launch.threads == 512 and launch.cluster == (1, 1)
        by_bytes = geometry.SMEM_PER_SM // (
            g.bytes + geometry.SMEM_PER_BLOCK_RESERVED)
        assert launch.blocks_per_sm == min(by_bytes, 2) >= 1
        assert launch.blocks_per_sm == (2 if g.bytes <= 115712 else 1)
        assert launch.form == "blocks"
        assert (launch.sizes == "compiled") == (tuple(g)
                                                in geometry.FIXED_PINS)
        assert g.pin_launch(default_taps=False).sizes == "run-time"
        fold = g.pin_launch(fold=True)
        assert (fold.form, fold.sizes) == ("strips", "run-time")


def test_the_kernel_table_rows_compile_their_sizes():
    """K = 16 on the default tiles, and the sharded engine's row tile of 32
    at K = 16 on a 2x2 shard of 1080x1920, run on compiled sizes."""
    assert geometry.resolve((1080, 1920), 16).pin_launch().sizes == \
        "compiled"
    assert geometry.resolve((544, 960), 16, 32).pin_launch().sizes == \
        "compiled"


PLAN_GEOMETRIES = sorted({g for _, g in pins_matrix() if not g.compiled},
                         key=tuple)[::3]


@pytest.mark.parametrize("g", PLAN_GEOMETRIES, ids=str)
def test_block_plan_steps_each_cell_once(g):
    """At every step of an interior tile the 4x4 blocks step each cell of
    the valid region exactly once, step nothing twice, stay within the
    window's rows and its pitch (the columns past the valid region hold
    values no valid cell reads), and read no cell before the first buffer
    but column 0's left neighbour, which the kernel takes as 0.0, and past
    the window's last row only at the first step (buffer 0's, which other
    buffers follow)."""
    wr, wc = g.tr + 2 * g.halo, g.tc + 2 * g.halo
    pitch = geometry.pitch(wc)
    for lo in range(1, g.halo + 1):
        hits = np.zeros((wr, pitch), dtype=np.int32)
        lowest, highest = 0, 0
        for blocks in geometry.pin_block_plan(g, lo):
            for lr0, lc, n in blocks:
                assert lc % 4 == 0 and 1 <= n <= 4 and lc + 4 <= pitch
                hits[lr0:lr0 + n, lc:lc + 4] += 1
                first = (lr0 - 1) * pitch + lc - (lc > 0)
                last = (lr0 + n) * pitch + lc + 4
                lowest, highest = min(lowest, first), max(highest, last)
        assert hits.max() == 1
        assert hits[lo:wr - lo, lo:wc - lo].min() == 1
        assert hits[:lo].sum() == hits[wr - lo:].sum() == 0
        assert lowest >= 0
        assert highest <= wr * pitch - (lo > 1)


def bits(pair):
    return [x.contiguous().view(torch.int32) for x in pair]


#: ragged shapes (1001x1920 scaled down by 16, 40x40, 70x130) with tiles
#: that leave padded clusters, and K 1, 8, 16 and 24
WALKS = [((63, 120), (8, 16), 1), ((40, 40), (8, 8), 8),
         ((70, 130), (32, 32), 16), ((40, 40), (16, 16), 24)]


@pytest.mark.parametrize("shape,tile,k", WALKS)
@pytest.mark.parametrize("boundary", ["naive", "zero"])
def test_cluster_walk_is_the_plain_run(rng, shape, tile, k, boundary):
    """The split's cluster part (6; parts 11 and 13 send the same cells)
    replayed block by block: bit for bit ``stencil.run``, and within 1e-6
    of JAX's oracle; with an extent smaller than the domain (a shard's
    layout, its padded blocks stepping the neighbour's band) bit for bit
    its crop."""
    h = geometry.halo_for_steps(k)
    u_np, v_np = random_uv(rng, shape)
    u, v = torch.from_numpy(u_np), torch.from_numpy(v_np)
    consts = kernel_constants(Parameters())
    want = stencil.run(u, v, k, consts, boundary)
    got = stencil.cluster_walk(u, v, k, consts, boundary, tile, h)
    for g_, w in zip(bits(got), bits(want)):
        assert torch.equal(g_, w)
    ext = (shape[0] - 11, shape[1] - 13)
    got = stencil.cluster_walk(u, v, k, consts, boundary, tile, h, ext)
    for g_, w in zip(bits(got), bits(x[:ext[0], :ext[1]] for x in want)):
        assert torch.equal(g_, w)
    ref = oracle.run(u_np, v_np, JaxParameters(), k, boundary)
    for g_, r in zip(want, ref):
        np.testing.assert_allclose(g_.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-6)


def test_cluster_walk_nan_inf(rng):
    """NaN and +-Inf in interior and edge cells: bit for bit."""
    u_np, v_np = random_uv(rng, (40, 72))
    u_np[20, 30] = v_np[0, 5] = np.nan
    v_np[17, 40] = np.inf
    u_np[39, 71] = -np.inf
    u, v = torch.from_numpy(u_np), torch.from_numpy(v_np)
    consts = kernel_constants(Parameters())
    for boundary in ("naive", "zero"):
        want = stencil.run(u, v, 8, consts, boundary)
        got = stencil.cluster_walk(u, v, 8, consts, boundary, (8, 16), 8)
        for g_, w in zip(bits(got), bits(want)):
            assert torch.equal(g_, w)


def test_cluster_bytes_leave_two_blocks_on_64x64_at_k16():
    g = geometry.Geometry(64, 64, 16)
    assert geometry.cluster_bytes(64, 64, 16) == 81 * 88 * 16
    assert geometry.blocks_per_sm(geometry.cluster_bytes(*g)) == 2
    assert geometry.cluster_stepped_ratio(g, 16) < g.stepped_ratio(16)


@pytest.mark.parametrize("part,g,match", [
    (14, geometry.Geometry(64, 64, 16), "part must be one of"),
    (4, geometry.Geometry(32, 32, 16), "compiles"),
    (8, geometry.Geometry(64, 128, 8), "compiles")])
def test_split_refuses_what_it_does_not_compile(part, g, match):
    with pytest.raises(ValueError, match=match):
        windowed.check_pin_part(part, g)


def test_shard_split_runs_parts_0_to_6():
    u = torch.zeros((1, 1, 2, 8, 8))
    with pytest.raises(ValueError, match="parts"):
        windowed.pinned_shard_ablation(7, u, u, None, 0, 16, None, (8, 8),
                                       geometry.Geometry(64, 64, 16))


def test_split_runs_on_the_card_only():
    u = torch.zeros((70, 97))
    consts = kernel_constants(Parameters())
    with pytest.raises(ValueError, match="CUDA device"):
        windowed.pinned_ablation(0, u, u, u.clone(), u.clone(), 16, consts,
                                 geometry.resolve((70, 97), 16))
    with pytest.raises(ValueError, match="tap set"):
        windowed.pinned_ablation(
            0, u, u, u.clone(), u.clone(), 16,
            kernel_constants(Parameters.with_stencil("pretty")),
            geometry.resolve((70, 97), 16))
