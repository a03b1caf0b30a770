"""The port's CUDA kernels on a CUDA card, against their plain PyTorch
version. Every test here needs the card and skips without one.

This file imports neither jax nor ``conftest`` (which imports jax), so it
runs on a machine that has no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from grayscott_tpu_torch.backends.cuda import CudaSimulation
from grayscott_tpu_torch.backends.sharded import ShardedSimulation
from grayscott_tpu_torch.cli import simulate
from grayscott_tpu_torch.ops import (ilpsplit, megakernel, oplat, packed,
                                     resident, sharded_mega, windowed)
from grayscott_tpu_torch.parallel import halo
from grayscott_tpu_torch.params import (STENCILS, Parameters,
                                        kernel_constants, packed_constants)

#: ragged shapes put tile seams and all four domain edges inside the 32x32
#: tiles; (1, 1) is a domain smaller than one tile's interior
SHAPES = [(1, 1), (33, 65), (70, 97), (64, 96)]

#: one launch, an odd and an even time-block count, remainders
STEP_COUNTS = [1, 7, 8, 9, 27]

#: the stencils the species-packed kernels (K4, K5, K6) take
SEPARABLE = [name for name in sorted(STENCILS)
             if Parameters.with_stencil(name).separable_plan()[0]
             == "separable"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def random_uv(shape, device):
    rng = np.random.RandomState(42)
    return tuple(torch.from_numpy(rng.uniform(0.0, 1.0, shape)
                                  .astype(np.float32)).to(device)
                 for _ in range(2))


@pytest.mark.gpu
@pytest.mark.parametrize("boundary", ["naive", "zero"])
@pytest.mark.parametrize("stencil_name", sorted(STENCILS))
def test_kernel_bitwise_equals_plain(cuda_device, boundary, stencil_name):
    """Tolerance: none (same expression tree, nvcc -fmad=false). Every
    shape of SHAPES, every step count 1..K."""
    consts = kernel_constants(Parameters.with_stencil(stencil_name))
    for shape in SHAPES:
        u, v = random_uv(shape, cuda_device)
        for steps in range(1, windowed.K + 1):
            uo, vo = torch.empty_like(u), torch.empty_like(v)
            before = windowed.launches
            windowed.multistep(u, v, uo, vo, steps, consts, boundary)
            assert windowed.launches == before + 1
            ru, rv = windowed.multistep_reference(u, v, steps, consts,
                                                  boundary)
            torch.cuda.synchronize()
            assert torch.equal(uo, ru) and torch.equal(vo, rv), \
                (shape, steps)


@pytest.mark.gpu
@pytest.mark.parametrize("boundary", ["naive", "zero"])
def test_simulate_run_on_card_equals_cpu(cuda_device, boundary):
    """The main path on the card (9 steps an image: one K-step launch and
    one remainder launch) gives the frames of the plain version on the CPU,
    bit for bit."""
    params = Parameters(time_step=0.5)
    frames = {}
    for device in ("cuda", "cpu"):
        sim = CudaSimulation(params, boundary, device=device)
        species = sim.make_species((70, 97))
        frames[device] = []
        simulate.run(sim, species, 3, 9, frames[device].append)
    for got, want in zip(frames["cuda"], frames["cpu"]):
        np.testing.assert_array_equal(got, want)


@pytest.mark.gpu
def test_launch_error_raises(cuda_device):
    """A launch the card refuses raises; nothing falls back."""
    consts = kernel_constants(Parameters())
    # grid.y over 65535
    u, v = random_uv((70000 * windowed.TILE[0], 1), cuda_device)
    with pytest.raises(RuntimeError, match="CUDA error"):
        windowed.multistep(u, v, torch.empty_like(u), torch.empty_like(v),
                           1, consts, "naive")


#: domains with interior tiles for K1 (64x64 tiles in 80x80 windows) and
#: K3 (32x32 tiles in 34x34 windows), ragged against both
INTERIOR_SHAPES = [(200, 300), (161, 259), (130, 97)]


def bits_equal(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [1.0, 0.5])
@pytest.mark.parametrize("boundary", ["naive", "zero"])
@pytest.mark.parametrize("stencil_name", sorted(STENCILS))
def test_redesigned_kernels_bitwise_on_interior_tiles(cuda_device, boundary,
                                                      stencil_name, dt):
    """K1 (every step count 1..K) and K3 (1, 2 and 9 steps) on domains whose
    interior tiles take the fixed term lists (csrc/gs_tile_sm90.cuh), with
    each stencil's tap set and dt. Tolerance: none."""
    consts = kernel_constants(Parameters.with_stencil(stencil_name,
                                                      time_step=dt))
    for shape in INTERIOR_SHAPES:
        u, v = random_uv(shape, cuda_device)
        for steps in range(1, windowed.K + 2):
            want = windowed.multistep_reference(u, v, steps, consts,
                                                boundary)
            if steps <= windowed.K:
                uo, vo = torch.empty_like(u), torch.empty_like(v)
                windowed.multistep(u, v, uo, vo, steps, consts, boundary)
                assert bits_equal(uo, want[0]) and bits_equal(vo, want[1]), \
                    ("K1", shape, steps)
            if steps in (1, 2, 9):
                out = resident.multistep(u.clone(), v.clone(),
                                         torch.empty_like(u),
                                         torch.empty_like(v), steps, consts,
                                         boundary)
                torch.cuda.synchronize()
                assert bits_equal(out[0], want[0]) and \
                    bits_equal(out[1], want[1]), ("K3", shape, steps)


@pytest.mark.gpu
@pytest.mark.parametrize("boundary", ["naive", "zero"])
@pytest.mark.parametrize("stencil_name", sorted(STENCILS))
def test_redesigned_kernels_keep_nan_and_inf(cuda_device, boundary,
                                             stencil_name):
    """NaN and +-Inf in interior and edge tiles and on the domain's edge
    spread through K1 and K3 bit for bit as through the plain step (the
    naive list's centre term makes an infinite cell NaN)."""
    consts = kernel_constants(Parameters.with_stencil(stencil_name))
    u, v = random_uv((200, 300), cuda_device)
    u[100, 150] = v[0, 5] = float("nan")
    v[90, 140] = u[70, 200] = float("inf")
    u[120, 7] = v[-1, -1] = float("-inf")
    want = windowed.multistep_reference(u, v, 3, consts, boundary)
    uo, vo = torch.empty_like(u), torch.empty_like(v)
    windowed.multistep(u, v, uo, vo, 3, consts, boundary)
    out = resident.multistep(u.clone(), v.clone(), torch.empty_like(u),
                             torch.empty_like(v), 3, consts, boundary)
    torch.cuda.synchronize()
    assert bits_equal(uo, want[0]) and bits_equal(vo, want[1])
    assert bits_equal(out[0], want[0]) and bits_equal(out[1], want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("boundary", ["naive", "zero"])
@pytest.mark.parametrize("stencil_name", sorted(STENCILS))
def test_resident_bitwise_equals_plain(cuda_device, boundary, stencil_name):
    """K3, one launch of each step count, at every shape of SHAPES.
    Tolerance: none."""
    consts = kernel_constants(Parameters.with_stencil(stencil_name))
    for shape in SHAPES:
        u, v = random_uv(shape, cuda_device)
        for steps in STEP_COUNTS:
            bufs = (u.clone(), v.clone(), torch.empty_like(u),
                    torch.empty_like(v))
            before = resident.launches
            out = resident.multistep(*bufs, steps, consts, boundary)
            assert resident.launches == before + 1
            ru, rv = resident.resident_reference(u, v, steps, consts,
                                                 boundary)
            torch.cuda.synchronize()
            assert torch.equal(out[0], ru) and torch.equal(out[1], rv), \
                (shape, steps)


@pytest.mark.gpu
@pytest.mark.parametrize("boundary", ["naive", "zero"])
@pytest.mark.parametrize("stencil_name", sorted(STENCILS))
def test_mega_bitwise_equals_plain(cuda_device, boundary, stencil_name):
    """K2 through the backend's mega engine (steps // 8 time blocks in one
    launch, then one remainder launch), at every shape of SHAPES.
    Tolerance: none."""
    params = Parameters.with_stencil(stencil_name)
    consts = kernel_constants(params)
    sim = CudaSimulation(params, boundary, device="cuda", engine="mega")
    for shape in SHAPES:
        u, v = random_uv(shape, cuda_device)
        for steps in STEP_COUNTS:
            storage = sim.build_storage(u.cpu().numpy(), v.cpu().numpy())
            before = megakernel.launches
            storage = sim.run_steps(storage, shape, steps)
            n_full, rem = divmod(steps, megakernel.MEGA_STEPS)
            assert megakernel.launches == before + (n_full > 0) + (rem > 0)
            ku, kv = sim.extract_uv(storage, shape)
            ru, rv = megakernel.megastep_reference(u, v, steps, consts,
                                                   boundary)
            torch.cuda.synchronize()
            assert torch.equal(ku, ru) and torch.equal(kv, rv), \
                (shape, steps)


@pytest.mark.gpu
@pytest.mark.parametrize("boundary", ["naive", "zero"])
def test_engines_bitwise_equal_each_other(cuda_device, boundary):
    """K1, K2 and K3 give the same state after 27 steps (3 time blocks
    and a remainder of 3), through the backend."""
    params = Parameters(time_step=0.5)
    u, v = random_uv((70, 97), "cpu")
    got = {}
    for pins in ({"engine": "windowed"}, {"engine": "mega"},
                 {"resident": "on"}):
        sim = CudaSimulation(params, boundary, device="cuda", **pins)
        storage = sim.run_steps(sim.build_storage(u.numpy(), v.numpy()),
                                (70, 97), 27)
        assert storage[0] == (pins.get("engine") or "resident")
        got[storage[0]] = [x.cpu() for x in sim.extract_uv(storage,
                                                           (70, 97))]
    for engine in ("mega", "resident"):
        assert all(torch.equal(a, b) for a, b in zip(got[engine],
                                                      got["windowed"]))


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["resident", "mega"])
def test_refused_cooperative_launch_raises(cuda_device, kernel):
    """A grid larger than the card holds at once is refused, and the
    wrapper raises; nothing falls back."""
    consts = kernel_constants(Parameters())
    u, v = random_uv((4096, 4096), cuda_device)
    too_many = 2 * (resident if kernel == "resident" else megakernel) \
        .max_blocks(cuda_device) + 1
    with pytest.raises(RuntimeError, match="CUDA error"):
        if kernel == "resident":
            resident.multistep(u, v, torch.empty_like(u),
                               torch.empty_like(v), 1, consts, "naive",
                               grid=too_many)
        else:
            megakernel.megastep(megakernel.pair_state(u),
                                megakernel.pair_state(v), 1, 1, consts,
                                "naive", grid=too_many)


def random_packed(shape, device):
    return packed.pack_state(*random_uv(shape, device))


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [1.0, 0.5])
@pytest.mark.parametrize("stencil_name", SEPARABLE)
def test_packed_bitwise_equals_plain(cuda_device, stencil_name, dt):
    """K4, one launch of each step count 1..K, at every shape of SHAPES.
    Tolerance: none (the plain packed tree, nvcc -fmad=false)."""
    pc = packed_constants(Parameters.with_stencil(stencil_name,
                                                  time_step=dt))
    for shape in SHAPES:
        x = random_packed(shape, cuda_device)
        for steps in range(1, packed.K + 1):
            out = torch.empty_like(x)
            before = packed.launches
            packed.multistep(x, out, steps, pc)
            assert packed.launches == before + 1
            want = packed.packed_run(x, steps, pc)
            torch.cuda.synchronize()
            assert torch.equal(out, want), (shape, steps)


@pytest.mark.gpu
@pytest.mark.parametrize("stencil_name", SEPARABLE)
def test_packed_resident_bitwise_equals_plain(cuda_device, stencil_name):
    """K5, one launch of each step count, at every shape of SHAPES.
    Tolerance: none."""
    pc = packed_constants(Parameters.with_stencil(stencil_name))
    for shape in SHAPES:
        x = random_packed(shape, cuda_device)
        for steps in STEP_COUNTS:
            before = packed.resident_launches
            out = packed.resident_multistep(x.clone(), torch.empty_like(x),
                                            steps, pc)
            assert packed.resident_launches == before + 1
            want = packed.packed_run(x, steps, pc)
            torch.cuda.synchronize()
            assert torch.equal(out[0], want), (shape, steps)


@pytest.mark.gpu
@pytest.mark.parametrize("stencil_name", SEPARABLE)
def test_packed_mega_bitwise_equals_plain(cuda_device, stencil_name):
    """K6 through the backend's packed mega engine (steps // 8 time blocks
    in one launch, then one remainder launch), at every shape of SHAPES.
    Tolerance: none."""
    params = Parameters.with_stencil(stencil_name)
    pc = packed_constants(params)
    sim = CudaSimulation(params, "zero", device="cuda", engine="mega",
                         pack="on")
    for shape in SHAPES:
        u, v = random_uv(shape, "cpu")
        x = packed.pack_state(u, v).to(cuda_device)
        for steps in STEP_COUNTS:
            storage = sim.build_storage(u.numpy(), v.numpy())
            assert storage[0] == "megapack"
            before = megakernel.packed_launches
            storage = sim.run_steps(storage, shape, steps)
            n_full, rem = divmod(steps, megakernel.MEGA_STEPS)
            assert megakernel.packed_launches == \
                before + (n_full > 0) + (rem > 0)
            want = packed.packed_run(x, steps, pc)
            torch.cuda.synchronize()
            assert torch.equal(storage[1][0], want), (shape, steps)


@pytest.mark.gpu
@pytest.mark.parametrize("pins", [{"engine": "windowed"}, {"engine": "mega"},
                                  {"resident": "on"}])
def test_packed_simulate_run_on_card_equals_cpu(cuda_device, pins):
    """The packed path through simulate.run on the card (9 steps an
    image: full and remainder launches) gives the CPU's frames, bit for
    bit."""
    params = Parameters(time_step=0.5)
    frames = {}
    for device in ("cuda", "cpu"):
        sim = CudaSimulation(params, "zero", device=device, pack="on",
                             **pins)
        species = sim.make_species((70, 97))
        frames[device] = []
        simulate.run(sim, species, 3, 9, frames[device].append)
    for got, want in zip(frames["cuda"], frames["cpu"]):
        np.testing.assert_array_equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["packed", "packed_resident",
                                    "packed_mega"])
def test_refused_packed_launch_raises(cuda_device, kernel):
    """A packed launch the card refuses raises, and nothing falls back:
    K4 with more tile rows than a grid holds, K5 and K6 with a grid larger
    than the card holds at once."""
    pc = packed_constants(Parameters())
    with pytest.raises(RuntimeError, match="CUDA error"):
        if kernel == "packed":
            x = torch.zeros((70000 * 32, 2), device=cuda_device)
            packed.multistep(x, torch.empty_like(x), 1, pc)
        elif kernel == "packed_resident":
            x = random_packed((4096, 4096), cuda_device)
            too_many = 2 * packed.resident_max_blocks(cuda_device) + 1
            packed.resident_multistep(x, torch.empty_like(x), 1, pc,
                                      grid=too_many)
        else:
            x = random_packed((4096, 4096), cuda_device)
            too_many = 2 * megakernel.packed_max_blocks(cuda_device) + 1
            megakernel.packed_megastep(megakernel.pair_state(x), 1, 1, pc,
                                       grid=too_many)


@pytest.mark.gpu
@pytest.mark.parametrize("rolls", [False, True])
def test_oplat_bitwise_equals_plain(cuda_device, rolls):
    """K8 at ragged and tile-aligned shapes, chains that end on a roll and
    chains that end on multiply-adds. Inputs in [0.5, 2), where the plain
    version's float64 multiply-add rounds as the kernel's fused one.
    Tolerance: none."""
    rng = np.random.default_rng(0)
    for shape in [(1, 1), (33, 65), (70, 97), (272, 1920)]:
        x = torch.from_numpy(rng.uniform(0.5, 2.0, shape)
                             .astype(np.float32)).to(cuda_device)
        for steps, n_ops in [(1, 1), (1, 3), (2, 4), (3, 15), (4, 45)]:
            before = oplat.launches
            got = oplat.chain(x, steps, n_ops, rolls)
            assert oplat.launches == before + 1
            want = oplat.chain_reference(x, steps, n_ops, rolls)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (shape, steps, n_ops)


@pytest.mark.gpu
@pytest.mark.parametrize("boundary", ["naive", "zero"])
@pytest.mark.parametrize("split", [1, 2, 4, 8])
def test_ilpsplit_bitwise_equals_plain_and_k3(cuda_device, boundary, split):
    """K9, one launch of each step count, against its plain version on the
    same slabs and against K3. Tolerance: none."""
    consts = kernel_constants(Parameters(time_step=0.5))
    for shape in [(257, 65), (300, 97), (1000, 1917)]:
        u, v = random_uv(shape, cuda_device)
        for steps in STEP_COUNTS:
            bufs = (u.clone(), v.clone(), torch.empty_like(u),
                    torch.empty_like(v))
            before = ilpsplit.launches
            out = ilpsplit.split_multistep(*bufs, steps, consts, boundary,
                                           split)
            assert ilpsplit.launches == before + 1
            want = ilpsplit.split_reference(u, v, steps, consts, boundary,
                                            split, quantum=ilpsplit.TILE)
            k3 = resident.multistep(u.clone(), v.clone(),
                                    torch.empty_like(u), torch.empty_like(v),
                                    steps, consts, boundary)
            torch.cuda.synchronize()
            for got, plain, other in zip(out[:2], want, k3[:2]):
                assert torch.equal(got, plain), (shape, steps)
                assert torch.equal(got, other), (shape, steps)


@pytest.mark.gpu
def test_ilpsplit_grid_of_one_block_a_slab(cuda_device):
    """The smallest grid (one block a slab) and an uneven one give the
    same result."""
    consts = kernel_constants(Parameters())
    u, v = random_uv((300, 97), cuda_device)
    want = resident.resident_reference(u, v, 9, consts, "zero")
    for grid in (8, 13, 50):
        out = ilpsplit.split_multistep(u.clone(), v.clone(),
                                       torch.empty_like(u),
                                       torch.empty_like(v), 9, consts,
                                       "zero", 8, grid=grid)
        torch.cuda.synchronize()
        assert torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["split_over_tile_rows", "grid_below_split"])
def test_ilpsplit_refuses_bad_splits(cuda_device, case):
    """More slabs than rows of tiles, or fewer blocks than slabs, raise
    before anything is launched."""
    consts = kernel_constants(Parameters())
    u, v = random_uv((70, 97), cuda_device)  # 3 rows of 32x32 tiles
    split, grid = (4, 0) if case == "split_over_tile_rows" else (3, 2)
    before = ilpsplit.launches
    with pytest.raises(ValueError):
        ilpsplit.split_multistep(u, v, torch.empty_like(u),
                                 torch.empty_like(v), 1, consts, "naive",
                                 split, grid=grid)
    assert ilpsplit.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["oplat", "ilpsplit"])
def test_refused_microbenchmark_launch_raises(cuda_device, kernel):
    """A grid larger than the card holds at once is refused, and the
    wrapper raises; nothing falls back."""
    with pytest.raises(RuntimeError, match="CUDA error"):
        if kernel == "oplat":
            x = torch.ones((1088, 1920), device=cuda_device)
            oplat.chain(x, 1, 3, True,
                        grid=2 * oplat.max_blocks(cuda_device) + 1)
        else:
            consts = kernel_constants(Parameters())
            u, v = random_uv((4096, 4096), cuda_device)
            ilpsplit.split_multistep(
                u, v, torch.empty_like(u), torch.empty_like(v), 1, consts,
                "naive", 2, grid=2 * ilpsplit.max_blocks(cuda_device) + 1)


#: (shape, shards, mesh columns): 1-D and 2-D meshes, ragged against the
#: shards and the tiles; 1x1 runs no pushes; the last of 4 row shards of 17
#: rows lies wholly past the domain
SHARDED = [((70, 97), 4, 1), ((70, 300), 4, 2), ((33, 65), 1, 1),
           ((100, 290), 6, 3), ((17, 40), 4, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("boundary", ["naive", "zero"])
@pytest.mark.parametrize("shape,n,cols", SHARDED)
def test_sharded_mega_bitwise_equals_plain_and_k2(cuda_device, boundary,
                                                  shape, n, cols):
    """K7, one launch of 1 and 3 time blocks on the exchanged pairs, at
    three grids (the co-resident maximum, one block a shard, an uneven
    split): every cell of the pairs, halos included, equals the plain
    version's. Then through the backend at every step count: K2's state.
    Tolerance: none."""
    params = Parameters(time_step=0.5)
    consts = kernel_constants(params)
    u, v = random_uv(shape, "cpu")
    mesh = halo.make_mesh(n, cols, cuda_device)
    for n_blocks, steps in ((1, 8), (3, 8), (3, 5)):
        for grid in (0, n, 2 * n + 1):
            pairs = halo.mega_shard_state(u, v, mesh)
            for p in pairs:
                halo.exchange_halos(p)
            want = [p.clone() for p in pairs]
            before = sharded_mega.launches
            sharded_mega.sharded_megastep(*pairs, mesh, n_blocks, steps,
                                          consts, boundary, shape, grid=grid)
            assert sharded_mega.launches == before + 1
            sharded_mega.sharded_megastep_reference(*want, n_blocks, steps,
                                                    consts, boundary, shape)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(pairs, want)), \
                (n_blocks, steps, grid)
    sim = ShardedSimulation(params, boundary, device="cuda", engine="mega",
                            n_devices=n, mesh_cols=cols)
    k2 = CudaSimulation(params, boundary, device="cuda", engine="mega")
    for steps in STEP_COUNTS:
        storage = sim.build_storage(u.numpy(), v.numpy())
        before = sharded_mega.launches
        storage = sim.run_steps(storage, shape, steps)
        n_full, rem = divmod(steps, sharded_mega.MEGA_STEPS)
        assert sharded_mega.launches == before + (n_full > 0) + (rem > 0)
        want = k2.extract_uv(k2.run_steps(k2.build_storage(
            u.numpy(), v.numpy()), shape, steps), shape)
        got = sim.extract_uv(storage, shape)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want)), steps


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["grid_below_shards", "card_below_shards",
                                  "grid_over_card"])
def test_sharded_mega_refuses_grids(cuda_device, case):
    """A grid smaller than the shard count is refused before the launch
    (a pinned grid) or by the kernel's host side (the co-resident maximum
    below the shard count); a grid larger than the card holds at once is
    refused by the card. Each raises; nothing falls back."""
    consts = kernel_constants(Parameters())
    n, cols, grid, error = 4, 2, 3, ValueError
    if case == "card_below_shards":
        n, cols, grid = sharded_mega.max_blocks(cuda_device) + 8, 1, 0
        error = RuntimeError
    elif case == "grid_over_card":
        grid = 2 * sharded_mega.max_blocks(cuda_device) + 1
        error = RuntimeError
    shape = (8 * n, 256)
    mesh = halo.make_mesh(n, cols, cuda_device)
    pairs = halo.mega_shard_state(*random_uv(shape, "cpu"), mesh)
    before = sharded_mega.launches
    with pytest.raises(error):
        sharded_mega.sharded_megastep(*pairs, mesh, 1, 8, consts, "naive",
                                      shape, grid=grid)
    assert sharded_mega.launches == before
