"""K7's read-site entry on tiles fitted to the shard, its CPU twin
(``ops/sharded_mega.py``: ``fitted_height``, ``fitted_tile``,
``read_site_plan``, ``read_site_walk``): the tile rows, each block's tiles
and where its wait for the push from below fires, replayed on the CPU
against the kernel's rules (``csrc/sharded_mega.cuh``: ``sharded_mega_run``,
``BottomGate``) and JAX's (``grayscott_tpu/ops/megakernel.py:428-463``);
the tile choice and its rounds; the split's plain versions and refusals.
The kernels are held bit for bit on the card by ``chip_smoke.py`` (phase
25) and tests/test_torch_gpu.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from grayscott_tpu import oracle
from grayscott_tpu.params import Parameters as JaxParameters
from grayscott_tpu_torch.ops import sharded_mega, stencil
from grayscott_tpu_torch.parallel import halo
from grayscott_tpu_torch.params import (Parameters, kernel_constants,
                                        STENCILS)

from conftest import random_uv

#: the H100's co-resident blocks: two an SM of the 64-column tiles, four of
#: the 32x32 ones
SMS = 132
CORESIDENT = {64: 2 * SMS, 32: 4 * SMS, (68, 64): 2 * SMS}
H = sharded_mega.MEGA_STEPS


@pytest.mark.parametrize("r_loc,want", [
    (272, 68), (544, 68), (1024, 64), (136, 68), (256, 64), (270, 68),
    (300, 64), (140, 64), (56, 64), (8, 64)])
def test_fitted_height(r_loc, want):
    """r_loc // 64 tile rows, each the least multiple of 4 that covers the
    shard, where that is the compiled 68; else 64."""
    h = sharded_mega.fitted_height(r_loc)
    assert h == want
    n = r_loc // 64
    if h != 64:
        assert -(-r_loc // h) == n and h % 4 == 0 and h - 4 < -(-r_loc // n)


@pytest.mark.parametrize("shape,mesh,want", [
    ((1080, 1920), (4, 1), (68, 64)), ((1080, 1920), (2, 1), (68, 64)),
    ((4096, 4096), (4, 1), None), ((1080, 1920), (2, 2), None),
    ((1080, 1920), (1, 4), None), ((100, 64), (2, 1), None)])
def test_fitted_tile_on_row_meshes_only(shape, mesh, want):
    assert sharded_mega.fitted_tile(shape, mesh) == want


def test_rounds_of_the_fitted_tiles():
    """2 rounds where the 64x64 tiles take 3 on 4x1 and 2x1 at 1080x1920;
    16 at 4096^2 on 4x1, where 64 rows divide the shard already."""
    for mesh in ((4, 1), (2, 1)):
        assert sharded_mega.tile_rounds((1080, 1920), mesh, (68, 64),
                                        264) == 2
        assert sharded_mega.tile_rounds((1080, 1920), mesh, 64, 264) == 3
    assert sharded_mega.tile_rounds((4096, 4096), (4, 1), (64, 64), 264) == 16


@pytest.mark.parametrize("shape,mesh", [
    ((1080, 1920), (4, 1)), ((1080, 1920), (2, 1)), ((4096, 4096), (4, 1)),
    ((1080, 1920), (2, 2)), ((1080, 1920), (1, 4))])
def test_choose_tile_takes_the_fitted_tile_where_it_costs_less(shape, mesh):
    """The fitted tile is a candidate on the row meshes it fits, and wins
    where its cost (rounds x blocks an SM x window cells) is the least;
    without its co-resident count the choice is the square tiles' alone."""
    cost = {t: sharded_mega.tile_rounds(shape, mesh, t, n) * n / SMS
            * sharded_mega.window_cells(t) for t, n in CORESIDENT.items()}
    fit = sharded_mega.fitted_tile(shape, mesh)
    chosen = sharded_mega.choose_tile(shape, mesh, CORESIDENT, SMS)
    candidates = [64, 32] + ([fit] if fit else [])
    assert chosen in candidates
    assert cost[chosen] == min(cost[t] for t in candidates)
    square = {t: n for t, n in CORESIDENT.items() if t in (64, 32)}
    assert sharded_mega.choose_tile(shape, mesh, square, SMS) in (64, 32)
    if shape == (1080, 1920) and mesh[1] == 1:
        assert chosen == (68, 64)


def covered(plan, r_loc, c_loc):
    """How many times each interior cell of a shard is stored in a time
    block of ``plan``."""
    tr, tc = plan.tile
    count = np.zeros((r_loc, c_loc), dtype=int)
    for walk in plan.blocks:
        for i in walk:
            ti, tj = divmod(i, plan.tiles_x)
            count[ti * tr:(ti + 1) * tr, tj * tc:(tj + 1) * tc] += 1
    return count


@pytest.mark.parametrize("shape,mesh,tile,grid", [
    ((1080, 1920), (4, 1), (68, 64), 264), ((1080, 1920), (2, 1), (68, 64),
                                             264),
    ((1080, 1920), (4, 1), 64, 264), ((4096, 4096), (4, 1), 64, 264),
    ((272, 96), (2, 1), (68, 64), 5), ((1001, 1920), (4, 1), (68, 64), 7)])
def test_each_cell_is_stored_once_and_the_gate_precedes_the_bottom_rows(
        shape, mesh, tile, grid):
    """Each block of a shard's group steps tiles rank, rank + size, ...;
    every interior cell of the shard is stored once a time block; each
    block waits for the push from below before it loads the first of its
    tiles whose window reaches the bottom halo rows (JAX: before the
    prefetch of the last window row, ``megakernel.py:450-463``), and no
    tile it loads before the wait reaches them; a block with no such tile
    waits nowhere."""
    r_loc, c_loc = halo.shard_extents(shape, halo.Mesh(*mesh, None))
    plans = sharded_mega.read_site_plan(shape, mesh, tile, grid)
    assert len(plans) == mesh[0] * mesh[1]
    sizes = [len(p.blocks) for p in plans]
    assert sum(sizes) == min(grid, sum(p.n_tiles for p in plans))
    assert max(sizes) - min(sizes) <= 1
    for plan in plans:
        tr, tc = plan.tile
        assert (covered(plan, -(-r_loc // tr) * tr, -(-c_loc // tc) * tc)
                == 1).all()
        for walk, gate in zip(plan.blocks, plan.gates):
            reaches = [i for i in walk
                       if (i // plan.tiles_x + 1) * tr + H > r_loc]
            if not reaches:
                assert gate is None
                continue
            assert gate == reaches[0]
            assert walk.index(gate) == min(walk.index(i) for i in reaches)
            before = walk[:walk.index(gate)]
            assert all((i // plan.tiles_x + 1) * tr + H <= r_loc
                       for i in before)
        # the first tile row that reaches the bottom halo rows: the split
        first = min(i for i in range(plan.n_tiles)
                    if (i // plan.tiles_x + 1) * tr + H > r_loc)
        assert plan.split == first


@pytest.mark.parametrize("stencil_name", sorted(STENCILS))
@pytest.mark.parametrize("boundary", ["zero", "naive"])
def test_walk_is_the_plain_version_and_jax_oracle(rng, stencil_name,
                                                  boundary):
    """The fitted walk stepped on the CPU, 3 time blocks of 8 steps and a
    remainder of 5 on 2x1 at 272x96 (136-row shards, 2 tile rows of 68; a
    grid of 3 blocks, so a shard's group holds 1 or 2): bit for bit the
    plain version and ``stencil.run``, and within 1e-6 of JAX's
    ``oracle.run``."""
    shape, mesh_shape = (272, 96), (2, 1)
    params = Parameters.with_stencil(stencil_name)
    consts = kernel_constants(params)
    u, v = random_uv(rng, shape)
    mesh = halo.make_mesh(2, 1, "cpu")
    assert halo.shard_extents(shape, mesh) == (136, 96)
    tile = sharded_mega.fitted_tile(shape, mesh_shape)
    assert tile == (68, 64)
    got = halo.mega_shard_state(u, v, mesh)
    want = halo.mega_shard_state(u, v, mesh)
    for n_blocks, k in ((3, 8), (1, 5)):
        for p in (*got, *want):
            halo.exchange_halos(p)
        sharded_mega.read_site_walk(*got, n_blocks, k, consts, boundary,
                                    shape, tile, 3)
        sharded_mega.sharded_megastep_reference(*want, n_blocks, k, consts,
                                                boundary, shape)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    result = [halo.mega_unshard_result(p, shape) for p in got]
    plain = stencil.run(torch.from_numpy(u), torch.from_numpy(v), 29, consts,
                        boundary)
    for a, b in zip(result, plain):
        assert torch.equal(a, b)
    ju, jv = oracle.run(u, v, JaxParameters.with_stencil(stencil_name), 29,
                        boundary)
    for a, b in zip(result, (ju, jv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("part", sorted(sharded_mega.READ_SITE_ABLATIONS))
def test_split_runs_its_plain_version_on_the_cpu(rng, part):
    """On the CPU each part of the read-site split runs its plain version:
    the parts that step nothing leave their input, every other part is
    the entry's plain version; nothing is counted."""
    shape = (272, 96)
    mesh = halo.make_mesh(2, 1, "cpu")
    consts = kernel_constants(Parameters())
    u, v = random_uv(rng, shape)
    got = halo.mega_shard_state(u, v, mesh)
    for p in got:
        halo.exchange_halos(p)
    want = [p.clone() for p in got]
    before = (sharded_mega.launches, sharded_mega.read_site_launches)
    assert sharded_mega.read_site_ablation(part, *got, mesh, 2, 8, consts,
                                           "naive", shape) == 0
    assert (sharded_mega.launches, sharded_mega.read_site_launches) == before
    if part not in sharded_mega.READ_SITE_NO_STEP:
        sharded_mega.sharded_megastep_reference(*want, 2, 8, consts, "naive",
                                                shape)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_split_refusals(rng):
    """The split runs a row mesh whose shards have more than one tile row,
    the default stencils' tap set, an even block count for the parts that
    step nothing, and the tile heights each part takes."""
    consts = kernel_constants(Parameters())
    row = halo.make_mesh(2, 1, "cpu")
    check = sharded_mega.check_read_site_part
    assert check(0, (272, 96), row, 3, consts, None) == 64
    assert check(4, (272, 96), row, 3, consts, None) == 68
    assert check(3, (272, 96), row, 3, consts, 60) == 60
    assert check(6, (4096, 4096), halo.make_mesh(4, 1, "cpu"), 3, consts,
                 None) == 64
    with pytest.raises(ValueError, match="row mesh"):
        check(0, (272, 96), halo.make_mesh(4, 2, "cpu"), 2, consts, None)
    with pytest.raises(ValueError, match="row mesh"):
        check(0, (100, 64), row, 2, consts, None)
    with pytest.raises(ValueError, match="tap set"):
        check(0, (272, 96), row, 2,
              kernel_constants(Parameters.with_stencil("5points")), None)
    with pytest.raises(ValueError, match="even number"):
        check(1, (272, 96), row, 3, consts, None)
    for part, tr in ((0, 68), (3, 74), (3, 66), (4, 72), (5, 68)):
        with pytest.raises(ValueError, match="does not run"):
            check(part, (272, 96), row, 2, consts, tr)
    with pytest.raises(ValueError, match="part must be"):
        check(7, (272, 96), row, 2, consts, None)
