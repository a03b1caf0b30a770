"""The port's CUDA kernels on a CUDA card, against their plain PyTorch
version, and the plain rungs of the ladder on the card against the same
rungs on the CPU. Every test here needs the card and skips without one.

This file imports neither jax nor ``conftest`` (which imports jax), so it
runs on a machine that has no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""

import re
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from grayscott_tpu_torch.backends import cuda as cuda_backend
from grayscott_tpu_torch.backends import get_backend
from grayscott_tpu_torch.backends.cuda import CudaSimulation
from grayscott_tpu_torch.backends.sharded import ShardedSimulation
from grayscott_tpu_torch.cli import simulate
from grayscott_tpu_torch.ops import (build, ilpsplit, megakernel, oplat,
                                     packed, resident, sharded_mega,
                                     windowed)
from grayscott_tpu_torch.parallel import halo
from grayscott_tpu_torch.params import (DEFAULT_STENCIL, STENCILS,
                                        Parameters, fold_constants,
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


def nan_state(shape, device):
    """A random state with NaN and +-Inf in interior and edge tiles and on
    the domain's edge."""
    u, v = random_uv(shape, device)
    u[100, 150] = v[0, 5] = float("nan")
    v[90, 140] = u[70, 200] = float("inf")
    u[120, 7] = v[-1, -1] = float("-inf")
    return u, v


@pytest.mark.gpu
@pytest.mark.parametrize("boundary", ["naive", "zero"])
@pytest.mark.parametrize("stencil_name", sorted(STENCILS))
def test_mega_keeps_nan_and_inf(cuda_device, boundary, stencil_name):
    """K2 on the Hopper stepper: NaN and +-Inf spread bit for bit as
    through the plain step, in one time block and in three."""
    consts = kernel_constants(Parameters.with_stencil(stencil_name))
    u, v = nan_state((200, 300), cuda_device)
    for n_blocks, steps in ((1, 3), (3, 2)):
        pu, pv = megakernel.pair_state(u), megakernel.pair_state(v)
        megakernel.megastep(pu, pv, n_blocks, steps, consts, boundary)
        want = megakernel.megastep_reference(u, v, n_blocks * steps, consts,
                                             boundary)
        torch.cuda.synchronize()
        assert bits_equal(pu[0], want[0]) and bits_equal(pv[0], want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("boundary", ["naive", "zero"])
@pytest.mark.parametrize("part", sorted(megakernel.ABLATIONS))
def test_mega_ablation_parts_bitwise(cuda_device, boundary, part):
    """Each part of K2's design taken out (the first stepper's kernel and
    the 32x32 geometry among them) gives the plain version's state bit for
    bit, on domains with interior tiles and on NaN and Inf; launches of
    these parts are not counted."""
    consts = kernel_constants(Parameters())
    states = [random_uv(shape, cuda_device)
              for shape in INTERIOR_SHAPES + SHAPES]
    states.append(nan_state((200, 300), cuda_device))
    for u, v in states:
        for n_blocks, steps in ((1, 8), (3, 5), (4, 8)):
            pu, pv = megakernel.pair_state(u), megakernel.pair_state(v)
            before = megakernel.launches
            megakernel.megastep_ablation(pu, pv, n_blocks, steps, consts,
                                         boundary, part)
            assert megakernel.launches == before
            want = megakernel.megastep_reference(u, v, n_blocks * steps,
                                                 consts, boundary)
            torch.cuda.synchronize()
            assert bits_equal(pu[0], want[0]) and \
                bits_equal(pv[0], want[1]), (tuple(u.shape), n_blocks, steps)


@pytest.mark.gpu
@pytest.mark.parametrize("boundary", ["naive", "zero"])
@pytest.mark.parametrize("grid", [1, 7])
def test_mega_on_pinned_grids(cuda_device, boundary, grid):
    """K2 on grids far below the co-resident maximum (many rounds of tiles
    a time block) gives the plain version's state."""
    params = Parameters(time_step=0.5)
    consts = kernel_constants(params)
    for shape in INTERIOR_SHAPES + [(300, 500)]:
        u, v = random_uv(shape, cuda_device)
        pu, pv = megakernel.pair_state(u), megakernel.pair_state(v)
        megakernel.megastep(pu, pv, 3, 8, consts, boundary, grid=grid)
        want = megakernel.megastep_reference(u, v, 24, consts, boundary)
        torch.cuda.synchronize()
        assert torch.equal(pu[0], want[0]) and torch.equal(pv[0], want[1])


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
        if kernel == "packed":  # 65536 rows of tiles
            x = torch.zeros((65536 * packed.TILE[0], 2), device=cuda_device)
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


#: domains for K5 (32x32 tiles in 34x34 windows) and K6 (64x64 tiles in
#: 80x80 windows) on the packed Hopper stepper: interior tiles of both,
#: ragged against both, rows of 16-byte copies (a width of a multiple of 4)
#: and of 4-byte ones; (40, 40) has no interior tile of either
PACKED_SHAPES = [(200, 264), (161, 260), (130, 97), (40, 40)]


def packed_states(device):
    """K5's and K6's test states: PACKED_SHAPES, and NaN and +-Inf in
    interior and edge tiles and on the domain's edge."""
    return ([random_packed(shape, device) for shape in PACKED_SHAPES]
            + [packed.pack_state(*nan_state((200, 300), device))])


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [1.0, 0.5])
@pytest.mark.parametrize("stencil_name", SEPARABLE)
def test_redesigned_packed_kernels_bitwise(cuda_device, stencil_name, dt):
    """K5 (1, 2 and 9 steps in one launch) and K6 (one launch of 1 x 8,
    3 x 5 and 9 x 3 time blocks) on the packed Hopper stepper
    (csrc/gs_packed_sm90.cuh), at ragged and no-interior shapes and on NaN
    and +-Inf. Tolerance: none, NaN bits included."""
    pc = packed_constants(Parameters.with_stencil(stencil_name,
                                                  time_step=dt))
    for x in packed_states(cuda_device):
        for steps in (1, 2, 9):
            out = packed.resident_multistep(x.clone(), torch.empty_like(x),
                                            steps, pc)
            want = packed.packed_run(x, steps, pc)
            torch.cuda.synchronize()
            assert bits_equal(out[0], want), (tuple(x.shape), steps)
        for n_blocks, steps in ((1, 8), (3, 5), (9, 3)):
            pair = megakernel.pair_state(x)
            megakernel.packed_megastep(pair, n_blocks, steps, pc)
            want = packed.packed_run(x, n_blocks * steps, pc)
            torch.cuda.synchronize()
            assert bits_equal(pair[0], want), (tuple(x.shape), n_blocks,
                                               steps)


#: K4's domains: ragged against its 64x64 tiles, one tile narrower than its
#: window, a domain smaller than one tile, interior tiles (200x264), rows
#: of 16-byte copies and of 4-byte ones
WINDOWED_SHAPES = [(70, 97), (19, 16), (130, 200), (5, 7), (200, 264),
                   (161, 260)]


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [1.0, 0.5])
@pytest.mark.parametrize("stencil_name", SEPARABLE)
def test_redesigned_packed_windowed_bitwise(cuda_device, stencil_name, dt):
    """K4 on the packed Hopper stepper (csrc/packed.cu), one launch of 1, 3
    and 8 steps, at the CPU twin's shapes (tests/test_torch_packed_windowed
    .py) and on NaN and +-Inf, against the plain packed run and the twin.
    Tolerance: none, NaN bits included."""
    pc = packed_constants(Parameters.with_stencil(stencil_name,
                                                  time_step=dt))
    states = ([random_packed(shape, cuda_device) for shape in WINDOWED_SHAPES]
              + [packed.pack_state(*nan_state((200, 300), cuda_device))])
    for x in states:
        for steps in (1, 3, 8):
            out = torch.empty_like(x)
            packed.multistep(x, out, steps, pc)
            want = packed.packed_run(x, steps, pc)
            twin = packed.packed_windowed_run(x, steps, pc)
            torch.cuda.synchronize()
            assert bits_equal(out, want), (tuple(x.shape), steps)
            assert bits_equal(out, twin), (tuple(x.shape), steps)


@pytest.mark.gpu
@pytest.mark.parametrize("part", sorted(packed.WINDOWED_ABLATIONS))
def test_packed_windowed_ablation_parts_bitwise(cuda_device, part):
    """Each part of K4's design taken out (its first form among them) gives
    the plain packed state bit for bit, on K4's and K5's test domains and
    on NaN and +-Inf; launches of these parts are not counted."""
    pc = packed_constants(Parameters())
    states = ([random_packed(shape, cuda_device) for shape in WINDOWED_SHAPES]
              + packed_states(cuda_device))
    for x in states:
        before = packed.launches
        for steps in (1, 8):
            out = torch.empty_like(x)
            packed.packed_windowed_ablation(x, out, steps, pc, part)
            want = packed.packed_run(x, steps, pc)
            torch.cuda.synchronize()
            assert bits_equal(out, want), (tuple(x.shape), steps)
        assert packed.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("part", [-1, max(packed.WINDOWED_ABLATIONS) + 1])
def test_packed_windowed_ablation_refuses_unknown_parts(cuda_device, part):
    """A part K4 does not have is refused on the card too, before anything
    is launched."""
    x = random_packed((70, 97), cuda_device)
    with pytest.raises(ValueError):
        packed.packed_windowed_ablation(x, torch.empty_like(x), 1,
                                        packed_constants(Parameters()), part)


#: (kernel, part) of every ablation part of K5 and K6
PACKED_PARTS = ([("resident", p) for p in sorted(packed.RESIDENT_ABLATIONS)]
                + [("mega", p) for p in sorted(megakernel.PACKED_ABLATIONS)])


@pytest.mark.gpu
@pytest.mark.parametrize("kernel,part", PACKED_PARTS)
def test_packed_ablation_parts_bitwise(cuda_device, kernel, part):
    """Each part of K5's and K6's design taken out (their first forms
    among them) gives the plain packed state bit for bit, at ragged and
    no-interior shapes and on NaN and +-Inf; launches of these parts are
    not counted."""
    pc = packed_constants(Parameters())
    for x in packed_states(cuda_device):
        before = (packed.resident_launches, megakernel.packed_launches)
        if kernel == "resident":
            for steps in (2, 9):
                out = packed.packed_resident_ablation(
                    x.clone(), torch.empty_like(x), steps, pc, part)
                want = packed.packed_run(x, steps, pc)
                torch.cuda.synchronize()
                assert bits_equal(out[0], want), (tuple(x.shape), steps)
        else:
            for n_blocks, steps in ((1, 8), (3, 5), (4, 8)):
                pair = megakernel.pair_state(x)
                megakernel.packed_mega_ablation(pair, n_blocks, steps, pc,
                                                part)
                want = packed.packed_run(x, n_blocks * steps, pc)
                torch.cuda.synchronize()
                assert bits_equal(pair[0], want), (tuple(x.shape), n_blocks,
                                                   steps)
        assert (packed.resident_launches,
                megakernel.packed_launches) == before


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["resident", "mega"])
@pytest.mark.parametrize("grid", [1, 7])
def test_packed_on_pinned_grids(cuda_device, kernel, grid):
    """K5 and K6 on grids far below the co-resident maximum (many tiles a
    block a step, or a time block) give the plain packed state."""
    pc = packed_constants(Parameters(time_step=0.5))
    for shape in PACKED_SHAPES + [(300, 500)]:
        x = random_packed(shape, cuda_device)
        if kernel == "resident":
            got = packed.resident_multistep(x.clone(), torch.empty_like(x),
                                            9, pc, grid=grid)[0]
        else:
            pair = megakernel.pair_state(x)
            megakernel.packed_megastep(pair, 3, 3, pc, grid=grid)
            got = pair[0]
        want = packed.packed_run(x, 9, pc)
        torch.cuda.synchronize()
        assert torch.equal(got, want), shape


def ptxas_spills(source: str, kernel: str, tmp_path) -> dict:
    """(spill stores, spill loads) in bytes of each instantiation of
    ``kernel`` (its mangled name: length, then name) in ptxas's report of
    ``csrc/<source>``, built alone with the library's flags."""
    src = build.CSRC_DIR / source
    done = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-c", "-o",
                           str(tmp_path / f"{src.stem}.o"), str(src)],
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stdout + done.stderr
    entry, spills = None, {}
    for line in (done.stdout + done.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1) if kernel in m.group(1) else None
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and entry is not None:
            spills[entry] = (int(m.group(1)), int(m.group(2)))
            entry = None
    return spills


@pytest.mark.gpu
def test_packed_mega_does_not_spill(cuda_device, tmp_path):
    """ptxas's report of K6 (csrc/packed_mega.cu, built alone with the
    library's flags): every instantiation of packed_mega_kernel, bound to
    64 registers a thread, spills nothing."""
    spills = ptxas_spills("packed_mega.cu", "18packed_mega_kernel", tmp_path)
    assert len(spills) == 4, spills  # the whole kernel and parts 1-3
    assert all(v == (0, 0) for v in spills.values()), spills


@pytest.mark.gpu
def test_packed_windowed_does_not_spill(cuda_device, tmp_path):
    """ptxas's report of K4 (csrc/packed.cu): every instantiation of
    packed_kernel, its 64x64 tiles bound to 64 registers a thread, spills
    nothing."""
    spills = ptxas_spills("packed.cu", "13packed_kernel", tmp_path)
    assert len(spills) == 3, spills  # the whole kernel and parts 1-2
    assert all(v == (0, 0) for v in spills.values()), spills


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
@pytest.mark.parametrize("boundary", ["naive", "zero"])
@pytest.mark.parametrize("part", sorted(ilpsplit.ABLATIONS))
def test_ilpsplit_ablation_parts_bitwise(cuda_device, part, boundary):
    """Each part of K9's design taken out (its first form among them), one
    launch of 1, 8 and 27 steps at every split, against its plain version
    on the same slabs and against K3; launches of these parts are not
    counted. Tolerance: none."""
    consts = kernel_constants(Parameters(time_step=0.5))
    for shape in [(257, 65), (300, 97), (1000, 1917)]:
        u, v = random_uv(shape, cuda_device)
        for split in (1, 2, 4, 8):
            before = ilpsplit.launches
            for steps in (1, 8, 27):
                out = ilpsplit.split_ablation(
                    u.clone(), v.clone(), torch.empty_like(u),
                    torch.empty_like(v), steps, consts, boundary, split,
                    part)
                want = ilpsplit.split_reference(u, v, steps, consts,
                                                boundary, split,
                                                quantum=ilpsplit.TILE)
                k3 = resident.multistep(u.clone(), v.clone(),
                                        torch.empty_like(u),
                                        torch.empty_like(v), steps, consts,
                                        boundary)
                torch.cuda.synchronize()
                for got, plain, other in zip(out[:2], want, k3[:2]):
                    assert torch.equal(got, plain), (shape, split, steps)
                    assert torch.equal(got, other), (shape, split, steps)
            assert ilpsplit.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("boundary", ["naive", "zero"])
@pytest.mark.parametrize("stencil_name", sorted(STENCILS))
def test_ilpsplit_keeps_nan_and_inf(cuda_device, boundary, stencil_name):
    """K9 at every split (and each ablation part, on the default stencil):
    NaN and +-Inf in interior and edge tiles, on slab seams and on the
    domain's edge spread over 3 steps bit for bit as through the plain
    version and K3."""
    consts = kernel_constants(Parameters.with_stencil(stencil_name))
    u, v = nan_state((200, 300), cuda_device)
    u[64, 40] = v[95, 33] = float("nan")  # next to tile-row seams
    k3 = resident.multistep(u.clone(), v.clone(), torch.empty_like(u),
                            torch.empty_like(v), 3, consts, boundary)
    parts = [None]
    if stencil_name == DEFAULT_STENCIL:
        parts += sorted(ilpsplit.ABLATIONS)
    for split in (1, 2, 4, 7):
        want = ilpsplit.split_reference(u, v, 3, consts, boundary, split,
                                        quantum=ilpsplit.TILE)
        for part in parts:
            bufs = (u.clone(), v.clone(), torch.empty_like(u),
                    torch.empty_like(v))
            if part is None:
                out = ilpsplit.split_multistep(*bufs, 3, consts, boundary,
                                               split)
            else:
                out = ilpsplit.split_ablation(*bufs, 3, consts, boundary,
                                              split, part)
            torch.cuda.synchronize()
            for got, plain, other in zip(out[:2], want, k3[:2]):
                assert bits_equal(got, plain), (split, part)
                assert bits_equal(got, other), (split, part)


@pytest.mark.gpu
@pytest.mark.parametrize("part", [-1, max(ilpsplit.ABLATIONS) + 1])
def test_ilpsplit_ablation_refuses_unknown_parts(cuda_device, part):
    """A part K9 does not have is refused on the card too, before anything
    is launched."""
    u, v = random_uv((70, 97), cuda_device)
    with pytest.raises(ValueError):
        ilpsplit.split_ablation(u, v, torch.empty_like(u),
                                torch.empty_like(v), 1,
                                kernel_constants(Parameters()), "naive", 2,
                                part)


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


@pytest.mark.gpu
@pytest.mark.parametrize("tile", sorted(sharded_mega.TILES))
@pytest.mark.parametrize("boundary", ["naive", "zero"])
@pytest.mark.parametrize("shape,n,cols", SHARDED + [((300, 500), 4, 2),
                                                    ((301, 500), 4, 1)])
def test_sharded_mega_geometries_bitwise(cuda_device, boundary, shape, n,
                                         cols, tile):
    """K7 on each of its tile geometries, one launch of 3 time blocks on
    the exchanged pairs: every cell of the pairs, halos included, equals
    the plain version's, on random states and on states with NaN and
    +-Inf (at 300x500 and 301x500: interior tiles at the shard seams).
    Tolerance: none."""
    consts = kernel_constants(Parameters())
    mesh = halo.make_mesh(n, cols, cuda_device)
    states = [random_uv(shape, "cpu")]
    if shape[0] >= 200:
        states.append(nan_state(shape, "cpu"))
    for u, v in states:
        pairs = halo.mega_shard_state(u, v, mesh)
        for p in pairs:
            halo.exchange_halos(p)
        want = [p.clone() for p in pairs]
        sharded_mega.sharded_megastep(*pairs, mesh, 3, 8, consts, boundary,
                                      shape,
                                      geometry=geometry.Geometry(tile, tile,
                                                                 8))
        sharded_mega.sharded_megastep_reference(*want, 3, 8, consts,
                                                boundary, shape)
        torch.cuda.synchronize()
        assert all(bits_equal(a, b) for a, b in zip(pairs, want))


#: the windowed engine's meshes: SHARDED, and shards that split for
#: overlap (1-D, 1x2, 2x2; NaN and Inf states from 200 columns)
SHARDED_WINDOWED = SHARDED + [((300, 40), 2, 1), ((150, 300), 2, 2),
                              ((290, 300), 4, 2), ((301, 500), 4, 1),
                              ((300, 500), 4, 2)]


@pytest.mark.gpu
@pytest.mark.parametrize("boundary", ["naive", "zero"])
@pytest.mark.parametrize("shape,n,cols", SHARDED_WINDOWED)
def test_windowed_shard_bitwise_equals_plain(cuda_device, boundary, shape, n,
                                             cols):
    """K1's shard entry, one launch per part (all, interior, edge) from
    either slot of the exchanged pairs at 1, 5 and 8 steps, on random
    states and, from 200 columns, on states with NaN and +-Inf: every cell
    of the pairs, halos included, equals the plain version's, and the
    interior and edge launches together equal the whole. One count a
    launch; an interior part with no tile launches nothing. Tolerance:
    none."""
    consts = kernel_constants(Parameters(time_step=0.5))
    mesh = halo.make_mesh(n, cols, cuda_device)
    states = [random_uv(shape, "cpu")]
    if shape[0] > 120 and shape[1] > 200:  # nan_state's cells
        states.append(nan_state(shape, "cpu"))
    r_loc, c_loc = halo.shard_extents(shape, mesh)
    engages = halo.overlap_engages(r_loc, c_loc, cols)
    for (u, v), slot, steps in zip(states * 3, (0, 1, 0, 1, 0, 1),
                                   (1, 5, 8, 8, 5, 1)):
        pairs = halo.mega_shard_state(u, v, mesh)
        for p in pairs:
            if slot:
                p[:, :, 1] = p[:, :, 0]
            halo.exchange_halos(p, slot)
        whole = None
        for part in windowed.PARTS:
            got = [p.clone() for p in pairs]
            want = [p.clone() for p in pairs]
            before = windowed.shard_launches
            windowed.shard_multistep(*got, mesh, slot, steps, consts,
                                     boundary, shape, part=part)
            launched = part != "interior" or engages
            assert windowed.shard_launches == before + launched
            windowed.shard_multistep_reference(*want, slot, steps, consts,
                                               boundary, shape, part)
            torch.cuda.synchronize()
            assert all(bits_equal(a, b) for a, b in zip(got, want)), \
                (part, slot, steps)
            if part == "all":
                whole = got
        split = [p.clone() for p in pairs]
        for part in ("interior", "edge"):
            windowed.shard_multistep(*split, mesh, slot, steps, consts,
                                     boundary, shape, part=part)
        torch.cuda.synchronize()
        assert all(bits_equal(a, b) for a, b in zip(split, whole))


@pytest.mark.gpu
@pytest.mark.parametrize("boundary", ["naive", "zero"])
@pytest.mark.parametrize("stencil_name", sorted(STENCILS))
def test_windowed_shard_keeps_nan_and_inf_like_k1(cuda_device, boundary,
                                                  stencil_name):
    """Through the backend on a 2x2 mesh with overlap on (the split
    engages) and off, 27 steps from a state with NaN and +-Inf: bit for
    bit the unsharded K1's state, with 4 and 8 shard launches and no K7
    launch. Tolerance: none."""
    params = Parameters.with_stencil(stencil_name)
    shape = (300, 500)
    u, v = nan_state(shape, "cpu")
    k1 = CudaSimulation(params, boundary, device="cuda", engine="windowed",
                        tuned_lookup=False)
    want = k1.extract_uv(k1.run_steps(k1.build_storage(
        u.numpy(), v.numpy()), shape, 27), shape)
    for overlap, launches in (("off", 4), ("on", 8)):
        sim = ShardedSimulation(params, boundary, device="cuda",
                                engine="windowed", n_devices=4,
                                mesh_cols=2, overlap=overlap,
                                tuned_lookup=False)
        before = (windowed.shard_launches, sharded_mega.launches)
        storage = sim.run_steps(sim.build_storage(u.numpy(), v.numpy()),
                                shape, 27)
        assert (windowed.shard_launches - before[0],
                sharded_mega.launches - before[1]) == (launches, 0)
        got = sim.extract_uv(storage, shape)
        torch.cuda.synchronize()
        assert all(bits_equal(a, b) for a, b in zip(got, want)), overlap


@pytest.mark.gpu
def test_windowed_shard_refuses_bad_geometry(cuda_device):
    """A tile rectangle past the shard's tiles is refused by the kernel's
    host side; it raises, and nothing falls back."""
    shape = (40, 300)
    mesh = halo.make_mesh(4, 2, cuda_device)
    up, vp = halo.mega_shard_state(*random_uv(shape, "cpu"), mesh)
    fn = windowed._shard_kernel()
    consts = kernel_constants(Parameters())
    err = fn(up.data_ptr(), vp.data_ptr(), 2, 2, 0, 0, 24, 152, 8, 0,
             *shape, 8, 1, 0, 5, 0, 1, 1, 0, *consts.weights,
             *consts.reaction,
             torch.cuda.current_stream().cuda_stream)
    assert build.error_name(err) == "invalid argument"


#: the plain rungs of the ladder (PyTorch operations; fused and conv
#: replay a CUDA graph on the card)
RUNGS = ["naive", "regular", "fused", "conv"]


@pytest.mark.gpu
@pytest.mark.parametrize("boundary", ["naive", "zero"])
@pytest.mark.parametrize("rung", RUNGS)
def test_rung_on_card_equals_cpu(cuda_device, rung, boundary):
    """Each rung through ``simulate.run`` on the card (3 images of 9 steps)
    against the same rung on the CPU: bit for bit for the elementwise
    rungs (each PyTorch operation rounds once on either device); conv
    within 1e-5, since cuDNN sums the taps in another order (TF32 would
    be about 1e-3)."""
    params = Parameters(time_step=0.5)
    frames = {}
    for device in ("cuda", "cpu"):
        sim = get_backend(rung)(params, boundary, device=device)
        species = sim.make_species((70, 97))
        frames[device] = []
        simulate.run(sim, species, 3, 9, frames[device].append)
    for got, want in zip(frames["cuda"], frames["cpu"]):
        if rung == "conv":
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        else:
            np.testing.assert_array_equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("boundary", ["naive", "zero"])
def test_runtime_weights_rung_on_card_equals_cpu(cuda_device, boundary):
    """fused(runtime_weights=True): the graph reads weights and rates from
    tensors that each call refreshes, so a swap of ``sim.params`` takes
    effect without a new capture; bit for bit against the CPU."""
    u, v = random_uv((70, 97), "cpu")
    got = {}
    for device in ("cuda", "cpu"):
        sim = get_backend("fused")(Parameters(), boundary, device=device,
                                   runtime_weights=True)
        storage = sim.build_storage(u.numpy(), v.numpy())
        storage = sim.run_steps(storage, (70, 97), 5)
        sim.params = Parameters.with_stencil("pretty", kill_rate=0.06)
        storage = sim.run_steps(storage, (70, 97), 5)
        got[device] = [x.cpu() for x in sim.extract_uv(storage, (70, 97))]
        if device == "cuda":
            assert sim.captures == 1
    assert all(torch.equal(a, b) for a, b in zip(got["cuda"], got["cpu"]))


@pytest.mark.gpu
@pytest.mark.parametrize("boundary", ["naive", "zero"])
@pytest.mark.parametrize("rung", ["fused", "conv"])
def test_graph_is_bitwise_to_its_loop_and_recaptures(cuda_device, rung,
                                                     boundary):
    """The captured graph steps the storage in place, bit for bit as the
    eager loop of the same step; it is captured once per step count and
    again on new storage (``build_storage``, as ``--resume`` does)."""
    sim = get_backend(rung)(Parameters(), boundary, device="cuda")
    u, v = (x.numpy() for x in random_uv((70, 97), "cpu"))
    storage = sim.build_storage(u, v)
    want = sim.loop(*storage, 9)
    assert sim.run_steps(storage, u.shape, 9) is storage
    assert sim.captures == 1
    assert all(bits_equal(a, b) for a, b in zip(storage, want))
    want = sim.loop(*want, 9)
    sim.run_steps(storage, u.shape, 9)
    assert sim.captures == 1
    assert all(bits_equal(a, b) for a, b in zip(storage, want))
    fresh = sim.build_storage(u, v)
    sim.run_steps(fresh, u.shape, 18)
    assert sim.captures == 2
    torch.cuda.synchronize()
    assert all(bits_equal(a, b) for a, b in zip(fresh, want))
    sim.run_steps(fresh, u.shape, 4)
    assert sim.captures == 3


@pytest.mark.gpu
@pytest.mark.parametrize("boundary", ["naive", "zero"])
def test_conv_runs_without_tf32(cuda_device, boundary):
    """conv on the card within 1e-5 of conv on the CPU over 32 steps at
    70x97, with cuDNN's TF32 default left on around it and unchanged
    after."""
    assert torch.backends.cudnn.allow_tf32
    got = {}
    for device in ("cuda", "cpu"):
        sim = get_backend("conv")(Parameters(), boundary, device=device)
        species = sim.make_species((70, 97))
        sim.perform_steps(species, 32)
        got[device] = species.uv_host()
    for a, b in zip(got["cuda"], got["cpu"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    assert torch.backends.cudnn.allow_tf32


@pytest.mark.gpu
@pytest.mark.parametrize("ablation", [None, 0])
@pytest.mark.parametrize("snapshot_dtype", ["float32", "bfloat16"])
def test_simulate_frames_kept_by_the_sink_equal_replay(cuda_device,
                                                        snapshot_dtype,
                                                        ablation):
    """``simulate.run`` copies each snapshot to the host on a copy stream of
    its own while the next batch runs (``ablation=None``), or on the launch
    stream (part 0, the first form). A sink that keeps every frame (the
    float32 ones are views of their pinned buffers) sees every frame equal
    to the plain replay, bit for bit; bf16 frames are the replay rounded
    through bf16."""
    from grayscott_tpu_torch.ops import stencil
    from grayscott_tpu_torch.species import initial_uv

    shape, images, steps = (256, 384), 12, 8
    sim = CudaSimulation(Parameters(), "naive", device=cuda_device,
                         engine="windowed", tuned_lookup=False)
    species = sim.make_species(shape)
    frames = []
    simulate.run(sim, species, images, steps, frames.append, snapshot_dtype,
                 ablation=ablation)
    torch.cuda.synchronize()
    consts = kernel_constants(Parameters())
    u, v = (torch.from_numpy(x) for x in initial_uv(shape))
    assert len(frames) == images
    for frame in frames:
        u, v = stencil.run(u, v, steps, consts, "naive")
        want = v if snapshot_dtype == "float32" else \
            v.to(torch.bfloat16).float()
        assert frame.dtype == np.float32
        np.testing.assert_array_equal(frame.view(np.int32),
                                      want.numpy().view(np.int32))


@pytest.mark.gpu
def test_autotune_record_is_followed(cuda_device, tmp_path, monkeypatch):
    """One ``autotune`` call at 256x384 zero persists a record keyed on the
    card (``autotune_platform``) that ``auto`` then follows: layout and
    engine; a second call measures nothing."""
    from grayscott_tpu_torch.bench import autotune
    from grayscott_tpu_torch.utils import cache
    from grayscott_tpu_torch.utils.device import autotune_platform

    monkeypatch.setenv("GRAYSCOTT_CACHE_DIR", str(tmp_path))
    params, shape = Parameters(), (256, 384)
    rec = autotune.autotune(params, shape, "zero", device=cuda_device,
                            steps=64, reps=2)
    key = autotune.key_for(params, shape, "zero", device=cuda_device)
    platform = autotune_platform(cuda_device)
    assert platform not in ("gpu", "cuda") and f":{platform}:" in key
    assert cache.load_autotune()[key] == rec
    assert rec["device_gcells_per_sec"] > 0 and len(rec["candidates"]) == \
        len(autotune.default_candidates(params, "zero"))
    sim = CudaSimulation(params, "zero", device=cuda_device)
    assert sim.layout_for(shape) == (rec["pack"], rec["engine"])
    assert sim.plan_for(shape, rec["pack"], rec)[0] == \
        rec["steps_per_call"]
    tag = sim.make_species(shape).storage[0]
    want = cuda_backend.PACKED_TAGS[rec["engine"]] if rec["pack"] \
        else rec["engine"]
    assert tag == want
    before = autotune.measurements
    assert autotune.autotune(params, shape, "zero",
                             device=cuda_device) == rec
    assert autotune.measurements == before


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["cuda", "fused"])
@pytest.mark.parametrize("depth", [1, 3])
def test_livesim_frames_on_card_equal_cpu(cuda_device, backend, depth):
    """livesim's frames through the copy stream (pinned frames, events,
    record_stream) equal the same source's frames on the CPU, index for
    index, at any depth; the host keeps every frame it was handed."""
    from grayscott_tpu_torch.cli import livesim

    frames = {}
    for device in ("cuda", "cpu"):
        ns = livesim.build_parser().parse_args(
            ["-r", "70", "-c", "97", "-e", "9", "--backend", backend,
             "--frames-in-flight", str(depth), "--device", device])
        src = livesim.FrameSource(ns)
        frames[device] = [src.next_idx() for _ in range(6)]
        assert src.species.steps_performed == 9 * (6 + depth - 1)
    for got, want in zip(frames["cuda"], frames["cpu"]):
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


@pytest.mark.gpu
def test_debug_check_raises_on_card(cuda_device, monkeypatch):
    from grayscott_tpu_torch.cli import shared

    monkeypatch.setenv("GRAYSCOTT_DEBUG", "1")
    ns = simulate.build_parser().parse_args(
        ["-r", "70", "-c", "97", "-t", "1e4", "--backend", "cuda"])
    sim = shared.make_simulation(ns)
    species = sim.make_species((70, 97))
    with pytest.raises(FloatingPointError, match="cuda backend"):
        simulate.run(sim, species, 4, 8, lambda frame: None)


# -- bf16 storage: K1, K1's shard entry, K2 and K7 on bfloat16 buffers --------

#: widths of 16-byte rows in float32 but not in bf16 (1924 = 4 mod 8), and
#: ragged ones
BF16_SHAPES = [(33, 65), (70, 97), (64, 1924), (200, 300)]


def bf16_equal(a, b):
    """Bit for bit, NaN's bit pattern aside: the same NaN positions, and
    the same bits in every other cell (bfloat16 or float32 tensors)."""
    a, b = a.float(), b.float()
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and \
        bits_equal(torch.where(nan, 0.0, a), torch.where(nan, 0.0, b))


def bf16_states(shape, device):
    """A random state and one with NaN and +-Inf, as bfloat16."""
    states = [random_uv(shape, device)]
    if shape[0] > 120 and shape[1] > 200:
        states.append(nan_state(shape, device))
    return [tuple(x.to(torch.bfloat16) for x in s) for s in states]


@pytest.mark.gpu
@pytest.mark.parametrize("boundary", ["naive", "zero"])
@pytest.mark.parametrize("stencil_name", sorted(STENCILS))
def test_bf16_k1_and_k2_equal_run_bf16(cuda_device, boundary, stencil_name):
    """K1's bf16 entry (one launch of 1..K steps) and K2's (blocks of 8 and
    of a remainder) against ``stencil.run_bf16`` on the card, NaN and Inf
    states included. Tolerance: none."""
    from grayscott_tpu_torch.ops import stencil

    consts = kernel_constants(Parameters.with_stencil(stencil_name))
    for shape in BF16_SHAPES:
        for u, v in bf16_states(shape, cuda_device):
            for steps in (1, 5, 8):
                uo, vo = torch.empty_like(u), torch.empty_like(v)
                before = (windowed.bf16_launches, windowed.launches)
                windowed.multistep(u, v, uo, vo, steps, consts, boundary)
                assert (windowed.bf16_launches, windowed.launches) == \
                    (before[0] + 1, before[1])
                want = stencil.run_bf16(u, v, steps, consts, boundary)
                torch.cuda.synchronize()
                assert all(bf16_equal(g, w)
                           for g, w in zip((uo, vo), want)), (shape, steps)
            for n_blocks, steps in ((3, 8), (1, 3), (2, 5)):
                up, vp = megakernel.pair_state(u), megakernel.pair_state(v)
                before = megakernel.bf16_launches
                megakernel.megastep(up, vp, n_blocks, steps, consts,
                                    boundary)
                assert megakernel.bf16_launches == before + 1
                want = megakernel.megastep_reference_bf16(
                    u, v, n_blocks, steps, consts, boundary)
                torch.cuda.synchronize()
                assert all(bf16_equal(g, w) for g, w in
                           zip((up[0], vp[0]), want)), (shape, n_blocks)


@pytest.mark.gpu
@pytest.mark.parametrize("boundary", ["naive", "zero"])
@pytest.mark.parametrize("mesh", [(1, 1), (4, 1), (2, 2), (1, 4)])
def test_bf16_sharded_engines_equal_k1_and_k2(cuda_device, boundary, mesh):
    """Through the backends, 27 steps from a random and a NaN/Inf state:
    K1's shard entry (overlap off and on) equals K1 on bf16 storage, and K7
    equals K2, bit for bit (NaN's bit pattern aside), with the bf16
    entries' launches only."""
    params = Parameters()
    shape = (300, 500)
    for u, v in (random_uv(shape, "cpu"), nan_state(shape, "cpu")):
        u, v = u.numpy(), v.numpy()
        want = {}
        for engine in ("windowed", "mega"):
            sim = CudaSimulation(params, boundary, device="cuda",
                                 engine=engine, dtype="bfloat16",
                                 tuned_lookup=False)
            want[engine] = sim.extract_uv(sim.run_steps(
                sim.build_storage(u, v), shape, 27), shape)
        for kwargs in ({"engine": "windowed", "overlap": "off"},
                       {"engine": "windowed", "overlap": "on"},
                       {"engine": "mega"}):
            sim = ShardedSimulation(params, boundary, device="cuda",
                                    n_devices=mesh[0] * mesh[1],
                                    mesh_cols=mesh[1], dtype="bfloat16",
                                    tuned_lookup=False, **kwargs)
            before = (windowed.shard_launches, sharded_mega.launches,
                      windowed.bf16_shard_launches,
                      sharded_mega.bf16_launches)
            got = sim.extract_uv(sim.run_steps(sim.build_storage(u, v),
                                               shape, 27), shape)
            after = (windowed.shard_launches, sharded_mega.launches,
                     windowed.bf16_shard_launches,
                     sharded_mega.bf16_launches)
            torch.cuda.synchronize()
            assert after[:2] == before[:2] and after[2:] != before[2:]
            assert all(bf16_equal(g, w) for g, w in
                       zip(got, want[kwargs["engine"]])), kwargs


@pytest.mark.gpu
def test_bf16_descriptor_takes_multiples_of_8(cuda_device):
    """K7's bf16 descriptor refuses a shard width that is not a multiple
    of 8 (a push moves 8 bfloat16 cells a copy); the float32 one takes a
    multiple of 4."""
    desc_bytes, describe, _ = sharded_mega._kernel()
    _, describe_bf16, _ = sharded_mega._bf16_kernel()
    host = torch.empty(4 * desc_bytes, dtype=torch.uint8)
    counters = torch.zeros(4 * sharded_mega.COUNTER_WORDS,
                           dtype=torch.int64, device=cuda_device)
    pairs = torch.zeros(4 * 2 * 40 * 80, device=cuda_device)
    for fn, c_loc, ok in ((describe, 60, True), (describe_bf16, 60, False),
                          (describe_bf16, 64, True)):
        err = fn(host.data_ptr(), pairs.data_ptr(), pairs.data_ptr(),
                 counters.data_ptr(), 2, 2, 24, c_loc, 8)
        assert (err == 0) == ok, (c_loc, err)


#: the fold's parameters: every stencil (the separable pass and the direct
#: plan's tap lists), and dt != 1
FOLD_PARAMS = [(name, Parameters.with_stencil(name))
               for name in sorted(STENCILS)] + [
                   ("dt=0.5", Parameters(time_step=0.5))]


def fold_states(shape, device, dtype):
    """A random state, and one with NaN and +-Inf where the shape holds
    them, as ``dtype``."""
    states = [random_uv(shape, device)]
    if shape[0] > 120 and shape[1] > 200:
        states.append(nan_state(shape, device))
    return [tuple(x.to(dtype) for x in s) for s in states]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("label,params", FOLD_PARAMS,
                         ids=[label for label, _ in FOLD_PARAMS])
def test_fold_entries_equal_their_plain_version(cuda_device, label, params,
                                                dtype):
    """K1's and K2's fold entries (the folded naive reaction) against
    ``stencil.run_naive_fold`` (``run_naive_fold_bf16`` on bf16 storage)
    on the card, after 1, 8 and 9 steps (9: K1's launches of 8 and 1, K2's
    time blocks of 8 and 1), at ragged shapes, NaN and Inf states included.
    Tolerance: none (bf16: NaN's bit pattern aside). Only the fold
    counters move."""
    from grayscott_tpu_torch.ops import stencil

    fc = fold_constants(params)
    bf16 = dtype == torch.bfloat16
    plain = stencil.run_naive_fold_bf16 if bf16 else stencil.run_naive_fold
    k1 = "fold_bf16_launches" if bf16 else "fold_launches"
    for shape in [(1, 1), (33, 65), (70, 97), (200, 300)]:
        for u, v in fold_states(shape, cuda_device, dtype):
            for steps in (1, 8, 9):
                # (9 steps: the second launch writes the first's inputs)
                bufs = [u.clone(), v.clone(), torch.empty_like(u),
                        torch.empty_like(v)]
                before = (getattr(windowed, k1), windowed.launches,
                          windowed.bf16_launches)
                for k in [8] * (steps // 8) + [steps % 8] * (steps % 8 > 0):
                    windowed.multistep(*bufs, k, fc, "naive", fold=True)
                    bufs = bufs[2:] + bufs[:2]
                assert (getattr(windowed, k1), windowed.launches,
                        windowed.bf16_launches) == \
                    (before[0] + -(-steps // 8), before[1], before[2])
                want = plain(u, v, steps, fc)
                torch.cuda.synchronize()
                assert all(bf16_equal(g, w) for g, w in
                           zip(bufs[:2], want)), ("K1", shape, steps)
                up, vp = megakernel.pair_state(u), megakernel.pair_state(v)
                before = getattr(megakernel, k1)
                for n_blocks, k in ([(steps // 8, 8)] * (steps >= 8)
                                    + [(1, steps % 8)] * (steps % 8 > 0)):
                    megakernel.megastep(up, vp, n_blocks, k, fc, "naive",
                                        fold=True)
                assert getattr(megakernel, k1) == before + 1 + (steps == 9)
                torch.cuda.synchronize()
                assert all(bf16_equal(g, w) for g, w in
                           zip((up[0], vp[0]), want)), ("K2", shape, steps)


@pytest.mark.gpu
@pytest.mark.parametrize("part", sorted(windowed.FOLD_ABLATIONS))
def test_fold_ablation_parts_bitwise(cuda_device, part):
    """Each part of the fold entries' split (the first form, part 0, among
    them) on both entries, bit for bit its plain version: the fold's
    state, the input for the parts of no step, the exact step's for part
    4; the parts built for TMA only where the state loads through TMA
    (200x300; 70x97 loads with cp.async), NaN and Inf included. Their
    launches are not counted."""
    from grayscott_tpu_torch.ops import stencil

    params = Parameters()
    fc, kc = fold_constants(params), kernel_constants(params)
    for shape in [(70, 97), (200, 300)]:
        for u, v in fold_states(shape, cuda_device, torch.float32):
            if (part in windowed.FOLD_ABLATION_TMA_ONLY
                    and windowed.fold_load(u, v) != "tma"):
                continue
            for steps in (1, 8):
                if part in windowed.FOLD_ABLATION_NO_STEP:
                    want = (u, v)
                elif part == windowed.FOLD_ABLATION_EXACT:
                    want = stencil.run(u, v, steps, kc, "naive")
                else:
                    want = stencil.run_naive_fold(u, v, steps, fc)
                before = (windowed.launches, windowed.fold_launches,
                          megakernel.launches, megakernel.fold_launches)
                out = [torch.empty_like(u), torch.empty_like(v)]
                windowed.fold_ablation(u, v, *out, steps, fc, part, exact=kc)
                pu, pv = megakernel.pair_state(u), megakernel.pair_state(v)
                megakernel.fold_ablation(pu, pv, 1, steps, fc, part,
                                         exact=kc)
                torch.cuda.synchronize()
                assert (windowed.launches, windowed.fold_launches,
                        megakernel.launches,
                        megakernel.fold_launches) == before
                assert all(bits_equal(g, w) for g, w in zip(out, want)), \
                    ("K1", shape, steps)
                assert all(bits_equal(g, w) for g, w in
                           zip((pu[0], pv[0]), want)), ("K2", shape, steps)


@pytest.mark.gpu
@pytest.mark.parametrize("flags", [[], ["--pallas-engine", "mega"],
                                   ["--pallas-dtype", "bfloat16"]])
def test_simulate_fold_runs_k1_or_k2_never_k3(cuda_device, flags):
    """``simulate --pallas-naive-fold on``: ``auto`` runs K1's fold entry
    (K2's with the engine pinned), never K3 nor the exact entries, and
    every frame is the plain fold's replay."""
    from grayscott_tpu_torch.ops import stencil
    from grayscott_tpu_torch.species import initial_uv
    from grayscott_tpu_torch.cli import shared

    shape, images, steps = (256, 384), 3, 12
    ns = simulate.build_parser().parse_args(
        ["-r", str(shape[0]), "-c", str(shape[1]), "--pallas-naive-fold",
         "on", *flags])
    sim = shared.make_simulation(ns)
    species = sim.make_species(shape)
    bf16 = ns.pallas_dtype == "bfloat16"
    counters = {"K1": (windowed, "launches"),
                "K1 bf16": (windowed, "bf16_launches"),
                "K1 fold": (windowed, "fold_launches"),
                "K1 fold bf16": (windowed, "fold_bf16_launches"),
                "K2": (megakernel, "launches"),
                "K2 fold": (megakernel, "fold_launches"),
                "K3": (resident, "launches")}
    before = {k: getattr(*c) for k, c in counters.items()}
    frames = []
    simulate.run(sim, species, images, steps, frames.append)
    torch.cuda.synchronize()
    moved = {k: getattr(*c) - before[k] for k, c in counters.items()
             if getattr(*c) != before[k]}
    kernel = ("K2 fold" if "mega" in flags
              else "K1 fold bf16" if bf16 else "K1 fold")
    assert moved == {kernel: 2 * images}  # 8 + 4 steps an image
    fc = fold_constants(Parameters())
    u, v = (torch.from_numpy(x) for x in initial_uv(shape))
    if bf16:
        u, v = u.to(torch.bfloat16), v.to(torch.bfloat16)
    for frame in frames:
        u, v = (stencil.run_naive_fold_bf16 if bf16
                else stencil.run_naive_fold)(u, v, steps, fc)
        np.testing.assert_array_equal(frame.view(np.int32),
                                      v.float().numpy().view(np.int32))


#: the ring's shapes: every depth unclamped (35 tiles of 32x32, 12 of
#: 64x64; NaN and Inf fit), and one under the clamp
RING_SHAPES = [(130, 210), (33, 65)]


def ring_equal(a, b):
    return bf16_equal(a, b) if a.dtype == torch.bfloat16 else bits_equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("entry,boundary", [
    ("f32", "naive"), ("f32", "zero"), ("bf16", "naive"), ("bf16", "zero"),
    ("fold", "naive"), ("fold bf16", "naive")])
def test_k2_ring_bitwise_equals_plain_and_depth_two(cuda_device, entry,
                                                    boundary):
    """Every K2 entry at every mega_depth (the ring entries, or the double
    buffer where the geometry is Main at depth 2), one launch of 3 time
    blocks of 8 and of 2 of 5 steps: bit for bit the plain version's and
    depth 2's, NaN and Inf included (bf16: NaN's bit pattern aside).
    Tolerance: none."""
    fold = entry.startswith("fold")
    dtype = torch.bfloat16 if entry.endswith("bf16") else torch.float32
    params = Parameters()
    k = fold_constants(params) if fold else kernel_constants(params)
    tag = ("ring_" + ("fold_" if fold else "")
           + ("bf16_" if dtype == torch.bfloat16 else "") + "launches")
    for shape in RING_SHAPES:
        for u, v in fold_states(shape, cuda_device, dtype):
            for n_blocks, steps in ((3, 8), (2, 5)):
                if fold:
                    want = megakernel.megastep_reference_fold(
                        u, v, n_blocks, steps, k)
                elif dtype == torch.bfloat16:
                    want = megakernel.megastep_reference_bf16(
                        u, v, n_blocks, steps, k, boundary)
                else:
                    want = megakernel.megastep_reference(
                        u, v, n_blocks * steps, k, boundary)
                at2 = None
                for depth in megakernel.DEPTHS:
                    ring = megakernel.ring_geometry(shape, depth).ring
                    before = getattr(megakernel, tag)
                    pu = megakernel.pair_state(u)
                    pv = megakernel.pair_state(v)
                    megakernel.megastep(pu, pv, n_blocks, steps, k, boundary,
                                        fold=fold, depth=depth)
                    torch.cuda.synchronize()
                    assert getattr(megakernel, tag) == before + ring
                    got = (pu[0], pv[0])
                    assert all(ring_equal(a, b) for a, b in zip(got, want)), \
                        (shape, depth, n_blocks, steps)
                    if at2 is not None:
                        assert all(ring_equal(a, b)
                                   for a, b in zip(got, at2)), (shape, depth)
                    at2 = at2 or got


@pytest.mark.gpu
def test_k6_declines_the_depth_pin(cuda_device):
    """K6 through the backend under every mega_depth pin: the double
    buffer runs (as JAX's packed megakernel takes no depth), counted in
    ``packed_launches``, and no ring launch; the frames bit for bit the
    plain packed version's, NaN and Inf included. Tolerance: none."""
    from grayscott_tpu_torch.species import Species

    pc = packed_constants(Parameters())
    for shape in RING_SHAPES:
        for u, v in fold_states(shape, cuda_device, torch.float32):
            want = packed.unpack_state(
                packed.packed_run(packed.pack_state(u, v), 24, pc),
                shape[1])
            for depth in megakernel.DEPTHS:
                sim = CudaSimulation(Parameters(), "zero",
                                     device=cuda_device, engine="mega",
                                     pack="on", mega_depth=depth,
                                     tuned_lookup=False)
                before = (megakernel.packed_launches,
                          megakernel.ring_launches)
                species = Species(shape, sim.build_storage(
                    u.cpu().numpy(), v.cpu().numpy()), sim)
                sim.perform_steps(species, 24)
                torch.cuda.synchronize()
                assert (megakernel.packed_launches - before[0],
                        megakernel.ring_launches - before[1]) == (1, 0)
                assert all(bits_equal(torch.from_numpy(a), b.cpu())
                           for a, b in zip(species.uv_host(), want)), \
                    (shape, depth)


@pytest.mark.gpu
@pytest.mark.parametrize("depth", megakernel.DEPTHS)
def test_ring_blocks_follow_the_bytes(cuda_device, depth):
    """The occupancy API's co-resident blocks of each ring geometry stay
    within what its shared memory holds, at least one an SM."""
    sms = torch.cuda.get_device_properties(cuda_device) \
        .multi_processor_count
    for shape in ((1080, 1920), (33, 65)):
        g = megakernel.ring_geometry(shape, depth)
        if not g.ring:
            continue
        n = megakernel.ring_max_blocks(cuda_device, g)
        assert sms <= n <= g.blocks_per_sm * sms, (shape, g, n)


#: row meshes where K7 waits at the read site: (shape, shards)
READ_SITE = [((300, 200), 4), ((300, 97), 2), ((1000, 130), 4)]


@pytest.mark.gpu
@pytest.mark.parametrize("boundary", ["naive", "zero"])
@pytest.mark.parametrize("shape,n", READ_SITE)
@pytest.mark.parametrize("tile", sorted(sharded_mega.TILES))
def test_k7_read_site_bitwise_equals_entry_gate(cuda_device, boundary, shape,
                                                n, tile):
    """K7 on a row mesh, one launch of 1, 3 and 4 time blocks: the
    read-site wait (counted in ``read_site_launches``) bit for bit the
    entry gate's and the plain version's, halos included. Tolerance:
    none."""
    consts = kernel_constants(Parameters())
    mesh = halo.make_mesh(n, 1, cuda_device)
    assert sharded_mega.read_site_applies(shape, mesh.shape, tile)
    u, v = random_uv(shape, "cpu")
    for n_blocks, steps in ((1, 8), (3, 8), (4, 5)):
        runs = []
        for read_site in (True, False, None):
            pairs = halo.mega_shard_state(u, v, mesh)
            for p in pairs:
                halo.exchange_halos(p)
            if read_site is None:
                sharded_mega.sharded_megastep_reference(
                    *pairs, n_blocks, steps, consts, boundary, shape)
            else:
                before = sharded_mega.read_site_launches
                sharded_mega.sharded_megastep(
                    *pairs, mesh, n_blocks, steps, consts, boundary, shape,
                    geometry=geometry.Geometry(tile, tile, 8),
                    read_site=read_site)
                assert sharded_mega.read_site_launches == before + read_site
            runs.append(pairs)
        torch.cuda.synchronize()
        for other in runs[1:]:
            assert all(torch.equal(a, b) for a, b in zip(runs[0], other)), \
                (n_blocks, steps)


# -- the tile and depth pins: K1's and K4's pinned entries -------------------

from grayscott_tpu_torch.ops import geometry, stencil  # noqa: E402

#: (K, tile rows, tile cols) of the pinned launches: every halo (8..32), a
#: tile width not a multiple of 4 (4-byte copies), one row of tiles, and
#: the compiled geometry itself through the pinned path's selection
PIN_CASES = [(1, 32, 32), (3, 8, 512), (12, 64, 64), (16, 32, 128),
             (16, 13, 37), (24, 64, 64), (32, 56, 56), (8, 128, 32),
             (8, 64, 64)]
#: a ragged domain, and one with NaN and +-Inf (fold_states)
PIN_SHAPES = [(70, 97), (130, 210)]


def pinned_plain(u, v, steps, entry, boundary, consts):
    """The plain version of one pinned launch of ``entry``."""
    if entry == "fold":
        return stencil.run_naive_fold(u, v, steps, consts)
    if entry == "fold bf16":
        return stencil.run_naive_fold_bf16(u, v, steps, consts, block=steps)
    if entry == "bf16":
        return stencil.run_bf16(u, v, steps, consts, boundary, block=steps)
    return stencil.run(u, v, steps, consts, boundary)


@pytest.mark.gpu
@pytest.mark.parametrize("entry,boundary", [
    ("f32", "naive"), ("f32", "zero"), ("bf16", "naive"), ("bf16", "zero"),
    ("fold", "naive"), ("fold bf16", "naive")])
def test_pinned_entries_bitwise_equal_plain(cuda_device, entry, boundary):
    """Each pinned entry of K1 (csrc/windowed_pins.cu), one launch of K
    steps (and of one step) on each geometry of PIN_CASES, against its
    plain version: bit for bit, NaN and Inf included (bf16: NaN's bit
    pattern aside); the compiled geometry launches the compiled entry.
    Tolerance: none."""
    fold = entry.startswith("fold")
    dtype = torch.bfloat16 if entry.endswith("bf16") else torch.float32
    params = Parameters()
    consts = fold_constants(params) if fold else kernel_constants(params)
    counter = windowed._PINNED[dtype, fold][1]
    for shape in PIN_SHAPES:
        for u, v in fold_states(shape, cuda_device, dtype):
            for k, tr, tc in PIN_CASES:
                g = geometry.resolve(shape, k, tr, tc)
                for steps in sorted({1, k}):
                    uo, vo = torch.empty_like(u), torch.empty_like(v)
                    before = getattr(windowed, counter)
                    windowed.multistep(u, v, uo, vo, steps, consts, boundary,
                                       fold=fold, geometry=g)
                    torch.cuda.synchronize()
                    assert getattr(windowed, counter) == \
                        before + (not g.compiled), (shape, g)
                    want = pinned_plain(u, v, steps, entry, boundary, consts)
                    assert all(bf16_equal(a, b) for a, b in
                               zip((uo, vo), want)), (shape, g, steps)


@pytest.mark.gpu
def test_packed_pinned_bitwise_equals_plain(cuda_device):
    """K4's pinned entry (csrc/packed.cu) on the row tiles and depths JAX's
    packed kernel takes, one launch of K steps, against ``packed_run``:
    bit for bit, NaN and Inf included. Tolerance: none."""
    pc = packed_constants(Parameters())
    for shape in PIN_SHAPES:
        for u, v in fold_states(shape, cuda_device, torch.float32):
            x = packed.pack_state(u, v)
            for k, tr in ((16, None), (32, None), (8, 32), (12, 8),
                          (4, 128), (24, 13)):
                g = geometry.resolve(shape, k, tr)
                out = torch.empty_like(x)
                before = packed.pinned_launches
                packed.multistep(x, out, k, pc, geometry=g)
                torch.cuda.synchronize()
                assert packed.pinned_launches == before + 1, g
                assert bits_equal(out, packed.packed_run(x, k, pc)), (shape,
                                                                      g)


@pytest.mark.gpu
def test_pinned_launch_past_the_shared_memory_raises(cuda_device):
    """A window past the 232,448 B a block may use: ``geometry.resolve``
    refuses the pin with the bytes named, and the C entry refuses such a
    geometry with cudaErrorInvalidValue (1) before any launch, which the
    wrapper raises."""
    from grayscott_tpu_torch.errors import UnsupportedConfigError

    u, v = random_uv((70, 97), cuda_device)
    uo, vo = torch.empty_like(u), torch.empty_like(v)
    with pytest.raises(UnsupportedConfigError, match="262144 B"):
        geometry.resolve((70, 97), 32, 64, 64)
    big = geometry.Geometry(64, 64, 32)
    with pytest.raises(RuntimeError, match="CUDA error 1 "):
        windowed.multistep(u, v, uo, vo, 8, kernel_constants(Parameters()),
                           "naive", geometry=big)
    x = packed.pack_state(u, v)
    with pytest.raises(RuntimeError, match="CUDA error 1 "):
        packed.multistep(x, torch.empty_like(x), 8,
                         packed_constants(Parameters()), geometry=big)
    fn = windowed._pinned_kernel(torch.float32, False)
    stream = torch.cuda.current_stream().cuda_stream
    err = fn(u.data_ptr(), v.data_ptr(), uo.data_ptr(), vo.data_ptr(), 70,
             97, 8, *big, 1, cuda_device.index or 0,
             *kernel_constants(Parameters()).weights,
             *kernel_constants(Parameters()).reaction, stream)
    assert err != 0
    assert build.bind("gs_windowed_pinned_max_steps", [])() == 32


@pytest.mark.gpu
@pytest.mark.parametrize("pins", [{}, {"block_rows": 64, "block_cols": 64},
                                  {"steps_per_call": 8},
                                  {"steps_per_call": 4}])
def test_default_geometry_launches_the_compiled_entry(cuda_device, pins):
    """An unpinned run on K1, and a pin equal to the default (64x64 tiles,
    K <= 8), launch the compiled entry (``windowed.launches``), never a
    pinned one: ceil(32 / K) launches for 32 steps."""
    from grayscott_tpu_torch.species import Species

    sim = CudaSimulation(Parameters(), "naive", device=cuda_device,
                         engine="windowed", tuned_lookup=False, **pins)
    u, v = (x.cpu().numpy() for x in random_uv((1080, 1920), cuda_device))
    species = Species((1080, 1920), sim.build_storage(u, v), sim)
    before = (windowed.launches, windowed.pinned_launches)
    sim.perform_steps(species, 32)
    torch.cuda.synchronize()
    k = pins.get("steps_per_call", 8)
    assert (windowed.launches - before[0],
            windowed.pinned_launches - before[1]) == (-(-32 // k), 0)


@pytest.mark.gpu
def test_pinned_kernels_do_not_spill(cuda_device, tmp_path):
    """ptxas's report of the pinned entries (csrc/windowed_pins.cu: the
    fold entries' 6 first-form instantiations and the second form's 16 on
    run-time sizes; csrc/windowed_pins_fixed.cu: its 8 on compiled sizes;
    K4's in csrc/packed.cu), bound to 64 registers a thread as Main's
    are: no spill."""
    for source, kernel, count in (
            ("windowed_pins.cu", "13pinned_kernel", 6),
            ("windowed_pins.cu", "18pinned_form_kernel", 16),
            ("windowed_pins_fixed.cu", "18pinned_form_kernel", 8)):
        spills = ptxas_spills(source, kernel, tmp_path)
        assert len(spills) == count, (kernel, spills)
        assert all(v == (0, 0) for v in spills.values()), spills
    spills = ptxas_spills("packed.cu", "20packed_pinned_kernel", tmp_path)
    assert len(spills) == 1 and all(v == (0, 0) for v in spills.values()), \
        spills


# -- the megakernels' tile pins, the sharded windowed engine's K -------------

#: K2's pinned geometries (tr, tc), and the shapes: a last tile row of one
#: row (1025 = 1024 + 1) and ragged ones
MEGA_PIN_CASES = [(8, 64), (32, 128), (16, 256), (128, 32), (24, 40)]
MEGA_PIN_SHAPES = [(70, 97), (1025, 300)]


@pytest.mark.gpu
@pytest.mark.parametrize("entry,boundary", [
    ("f32", "naive"), ("f32", "zero"), ("bf16", "naive"), ("bf16", "zero"),
    ("fold", "naive"), ("fold bf16", "naive")])
def test_mega_pinned_entries_bitwise_equal_plain(cuda_device, entry,
                                                 boundary):
    """Each pinned entry of K2 (csrc/mega_pins.cu) on each geometry of
    MEGA_PIN_CASES, two time blocks of 8 steps and one of 3, against its
    plain version: bit for bit, NaN and Inf included (bf16: NaN's bit
    pattern aside), counted on its own counter. Tolerance: none."""
    fold = entry.startswith("fold")
    dtype = torch.bfloat16 if entry.endswith("bf16") else torch.float32
    params = Parameters()
    consts = fold_constants(params) if fold else kernel_constants(params)
    counter = {(torch.float32, False): "pinned_launches",
               (torch.bfloat16, False): "pinned_bf16_launches",
               (torch.float32, True): "pinned_fold_launches",
               (torch.bfloat16, True): "pinned_fold_bf16_launches"}[
                   dtype, fold]
    for shape in MEGA_PIN_SHAPES:
        for u, v in fold_states(shape, cuda_device, dtype):
            for n_blocks, steps in ((2, 8), (1, 3)):
                if fold:
                    want = megakernel.megastep_reference_fold(
                        u, v, n_blocks, steps, consts)
                elif dtype == torch.bfloat16:
                    want = megakernel.megastep_reference_bf16(
                        u, v, n_blocks, steps, consts, boundary)
                else:
                    want = stencil.run(u, v, n_blocks * steps, consts,
                                       boundary)
                for tr, tc in MEGA_PIN_CASES:
                    g = geometry.Geometry(tr, tc, 8)
                    up, vp = (megakernel.pair_state(x) for x in (u, v))
                    before = getattr(megakernel, counter)
                    megakernel.megastep(up, vp, n_blocks, steps, consts,
                                        boundary, fold=fold, geometry=g)
                    torch.cuda.synchronize()
                    assert getattr(megakernel, counter) == before + 1
                    assert all(bf16_equal(a, b) for a, b in
                               zip((up[0], vp[0]), want)), (shape, g)


@pytest.mark.gpu
def test_packed_mega_pinned_bitwise_equals_plain(cuda_device):
    """K6's pinned entry on its row tiles: ``packed_run`` bit for bit."""
    pc = packed_constants(Parameters())
    for shape in MEGA_PIN_SHAPES:
        for u, v in fold_states(shape, cuda_device, torch.float32):
            x = packed.pack_state(u, v)
            want = packed.packed_run(x, 16, pc)
            for tr in (8, 32, 128):
                g = geometry.mega_resolve(shape, tr)
                xp = megakernel.pair_state(x)
                before = megakernel.packed_pinned_launches
                megakernel.packed_megastep(xp, 2, 8, pc, geometry=g)
                torch.cuda.synchronize()
                assert megakernel.packed_pinned_launches == before + 1
                assert bits_equal(xp[0], want), (shape, g)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mesh", [(1, 4), (4, 1), (2, 2)])
def test_sharded_mega_pinned_bitwise_equals_plain(cuda_device, dtype, mesh):
    """K7's pinned entry (csrc/sharded_mega_pins.cu) on each mesh form,
    the read-site wait on the row mesh: the plain version bit for bit."""
    shape = (300, 520)
    u, v = random_uv(shape, cuda_device)
    m = halo.Mesh(*mesh, cuda_device)
    consts = kernel_constants(Parameters())
    counter = ("pinned_bf16_launches" if dtype == torch.bfloat16
               else "pinned_launches")
    for boundary in ("naive", "zero"):
        up, vp = halo.mega_shard_state(u, v, m, dtype)
        for x in (up, vp):
            halo.exchange_halos(x)
        cu, cv = up.clone(), vp.clone()
        sharded_mega.sharded_megastep_reference(cu, cv, 3, 8, consts,
                                                boundary, shape)
        for tr, tc in ((32, 128), (16, 256), (64, 40)):
            gu, gv = up.clone(), vp.clone()
            before = getattr(sharded_mega, counter)
            sharded_mega.sharded_megastep(
                gu, gv, m, 3, 8, consts, boundary, shape,
                geometry=geometry.Geometry(tr, tc, 8))
            torch.cuda.synchronize()
            assert getattr(sharded_mega, counter) == before + 1
            assert all(bf16_equal(halo.mega_unshard_result(a, shape),
                                  halo.mega_unshard_result(b, shape))
                       for a, b in ((gu, cu), (gv, cv))), (mesh, tr, tc)


@pytest.mark.gpu
@pytest.mark.parametrize("boundary", ["naive", "zero"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_compiled_mega_pins_bitwise_equal_plain_and_run_time(
        cuda_device, dtype, boundary):
    """K2's pinned sizes compiled in (csrc/mega_pins_fixed.cu, each
    geometry of geometry.MEGA_FIXED_PINS at its threads), two time blocks
    of 8 steps and one of 3 on ragged domains, NaN and Inf included: the
    plain version and the first form on run-time sizes (the split's part
    0) bit for bit (bf16: NaN's bit pattern aside), counted on the pinned
    counters. Tolerance: none."""
    consts = kernel_constants(Parameters())
    counter = ("pinned_bf16_launches" if dtype == torch.bfloat16
               else "pinned_launches")
    for shape in MEGA_PIN_SHAPES:
        for u, v in fold_states(shape, cuda_device, dtype):
            for n_blocks, steps in ((2, 8), (1, 3)):
                want = (megakernel.megastep_reference_bf16(
                    u, v, n_blocks, steps, consts, boundary)
                    if dtype == torch.bfloat16 else
                    stencil.run(u, v, n_blocks * steps, consts, boundary))
                for tiles in geometry.MEGA_FIXED_PINS:
                    g = geometry.Geometry(*tiles, 8)
                    assert geometry.mega_pin_launch(g).sizes == "compiled"
                    up, vp = (megakernel.pair_state(x) for x in (u, v))
                    before = getattr(megakernel, counter)
                    megakernel.megastep(up, vp, n_blocks, steps, consts,
                                        boundary, geometry=g)
                    rp, rq = (megakernel.pair_state(x) for x in (u, v))
                    megakernel.pinned_ablation(0, rp, rq, n_blocks, steps,
                                               consts, boundary, g)
                    torch.cuda.synchronize()
                    assert getattr(megakernel, counter) == before + 1
                    for got, ref in ((up[0], rp[0]), (vp[0], rq[0])):
                        assert bf16_equal(got, ref), (shape, g)
                    assert all(bf16_equal(a, b) for a, b in
                               zip((up[0], vp[0]), want)), (shape, g)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mesh", [(1, 4), (4, 1), (2, 2)])
def test_compiled_sharded_pins_bitwise_equal_plain_and_run_time(
        cuda_device, dtype, mesh):
    """K7's pinned sizes compiled in (csrc/sharded_mega_pins_fixed.cu, each
    geometry of geometry.SHARDED_FIXED_PINS at its threads) on each mesh
    form (the read-site wait on the row mesh), both boundaries: the plain
    version and the first form on run-time sizes (the split's part 0, the
    entry gate) bit for bit, slot 0 and its halos; the grid the launch
    took that of ``sharded_mega.pinned_walk``."""
    shape = (300, 520)
    u, v = random_uv(shape, cuda_device)
    m = halo.Mesh(*mesh, cuda_device)
    consts = kernel_constants(Parameters())
    sms = torch.cuda.get_device_properties(
        cuda_device).multi_processor_count
    counter = ("pinned_bf16_launches" if dtype == torch.bfloat16
               else "pinned_launches")
    for boundary in ("naive", "zero"):
        up, vp = halo.mega_shard_state(u, v, m, dtype)
        for x in (up, vp):
            halo.exchange_halos(x)
        cu, cv = up.clone(), vp.clone()
        sharded_mega.sharded_megastep_reference(cu, cv, 3, 8, consts,
                                                boundary, shape)
        for tiles in geometry.SHARDED_FIXED_PINS:
            g = geometry.Geometry(*tiles, 8)
            gu, gv = up.clone(), vp.clone()
            before = getattr(sharded_mega, counter)
            grid = sharded_mega.sharded_megastep(gu, gv, m, 3, 8, consts,
                                                 boundary, shape, geometry=g)
            ru, rv = up.clone(), vp.clone()
            sharded_mega.pinned_ablation(0, ru, rv, m, 3, 8, consts,
                                         boundary, shape, g)
            torch.cuda.synchronize()
            assert getattr(sharded_mega, counter) == before + 1
            assert grid == sharded_mega.pinned_walk(shape, mesh, g, boundary,
                                                    sms).grid
            for got, ref in ((gu, cu), (gv, cv), (gu, ru), (gv, rv)):
                assert bf16_equal(got[:, :, 0], ref[:, :, 0]), (mesh, g)


@pytest.mark.gpu
def test_compiled_pinned_megakernels_do_not_spill(cuda_device, tmp_path):
    """ptxas's report of K2's and K7's pinned instantiations on compiled
    sizes (the default stencils' tap set; K7's with both waits): no spill,
    the naive ones included at 64 registers."""
    for source, kernel, count in (
            ("mega_pins_fixed.cu", "20mega_pin_form_kernel", 16),
            ("sharded_mega_pins_fixed.cu", "23sharded_pin_form_kernel", 16)):
        spills = ptxas_spills(source, kernel, tmp_path)
        assert len(spills) == count, (kernel, spills)
        assert all(v == (0, 0) for v in spills.values()), spills


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mesh", [(4, 1), (2, 2)])
def test_shard_pinned_bitwise_equals_plain(cuda_device, dtype, mesh):
    """K1's pinned shard entry (csrc/windowed_pins.cu) at K 4, 16 and 32
    on row tiles 32 and 64, every part: the plain version at the shard
    layout's halo, bit for bit."""
    shape = (400, 300)
    u, v = random_uv(shape, cuda_device)
    consts = kernel_constants(Parameters())
    for k, tr in ((4, 32), (16, 32), (16, 64), (32, 64)):
        h = geometry.halo_for_steps(k)
        m = halo.Mesh(*mesh, cuda_device, h)
        r_loc, c_loc = halo.shard_extents(shape, m)
        g = geometry.resolve((r_loc, c_loc), k, tr)
        up, vp = halo.mega_shard_state(u, v, m, dtype)
        for x in (up, vp):
            halo.exchange_halos(x, 0, h)
        for part in windowed.PARTS:
            cu, cv = up.clone(), vp.clone()
            windowed.shard_multistep_reference(cu, cv, 0, k, consts,
                                               "naive", shape, part, g)
            gu, gv = up.clone(), vp.clone()
            windowed.shard_multistep(gu, gv, m, 0, k, consts, "naive",
                                     shape, part, geometry=g)
            torch.cuda.synchronize()
            assert all(bf16_equal(a, b) for a, b in
                       zip((gu[:, :, 1], gv[:, :, 1]),
                           (cu[:, :, 1], cv[:, :, 1]))), (k, tr, part)


@pytest.mark.gpu
def test_pinned_megakernel_grids_follow_the_bytes(cuda_device):
    """The co-resident blocks of a pinned megakernel launch follow its
    window's bytes: a small window holds more blocks an SM than Main's, a
    large one fewer; the card holds at least one a shard."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    small, large = geometry.Geometry(8, 64, 8), geometry.Geometry(64, 128, 8)
    assert megakernel.pinned_max_blocks(cuda_device, small) >= \
        megakernel.max_blocks(cuda_device) >= \
        megakernel.pinned_max_blocks(cuda_device, large) >= sms
    assert megakernel.packed_pinned_max_blocks(cuda_device, large) >= sms
    assert sharded_mega.pinned_max_blocks(cuda_device, small) >= sms


@pytest.mark.gpu
def test_new_pinned_kernels_do_not_spill(cuda_device, tmp_path):
    """ptxas's report of the megakernels' and the shard entry's pinned
    instantiations (the default stencils' tap set and any other): no
    spill."""
    for source, kernel, count in (
            ("mega_pins.cu", "18mega_pinned_kernel", 12),
            ("mega_pins.cu", "25packed_mega_pinned_kernel", 1),
            ("sharded_mega_pins.cu", "26sharded_mega_pinned_kernel", 16),
            ("windowed_pins.cu", "17shard_form_kernel", 8),
            ("windowed_pins_fixed.cu", "17shard_form_kernel", 8)):
        spills = ptxas_spills(source, kernel, tmp_path)
        assert len(spills) == count, (kernel, spills)
        assert all(v == (0, 0) for v in spills.values()), spills


# -- the lane fold (K1's folded entry) and the window ring at pinned tiles --

from grayscott_tpu_torch.ops import lane_fold  # noqa: E402

#: (shape, F, K, row tile pin): even and uneven panels, dead rows, a deep
#: halo, a short panel, ragged widths
FOLD_CASES = [((300, 520), 2, 8, None), ((301, 97), 3, 8, None),
              ((400, 256), 8, 16, 16), ((200, 300), 3, 12, 16),
              ((37, 24), 3, 32, None), ((1, 1), 1, 8, None)]


@pytest.mark.gpu
@pytest.mark.parametrize("boundary", ["naive", "zero"])
@pytest.mark.parametrize("stencil_name", sorted(STENCILS))
def test_folded_entry_bitwise_equals_plain_and_k1(cuda_device, boundary,
                                                  stencil_name):
    """K1's folded entry (csrc/windowed_pins.cu: the refresh, then the
    step) on each of FOLD_CASES, NaN and Inf included: its plain version
    (the halos it refreshed included) and the unfolded K1 bit for bit,
    counted on ``folded_launches``. Tolerance: none."""
    consts = kernel_constants(Parameters.with_stencil(stencil_name))
    for shape, f, k, tr in FOLD_CASES:
        for u0, v0 in fold_states(shape, cuda_device, torch.float32):
            g = geometry.resolve((-(-shape[0] // f), shape[1]), k, tr)
            rp = lane_fold.fold_geometry(shape[0], f, g.tr)
            u, v = lane_fold.fold_state(u0, v0, f, g.tr, g.halo, cuda_device)
            pu, pv = u.clone(), v.clone()
            uo, vo = torch.zeros_like(u), torch.zeros_like(v)
            before = windowed.folded_launches
            windowed.folded_multistep(u, v, uo, vo, k, consts, boundary,
                                      shape, rp, g)
            torch.cuda.synchronize()
            assert windowed.folded_launches == before + 1
            po, qo = torch.zeros_like(u), torch.zeros_like(v)
            windowed.folded_multistep_reference(pu, pv, po, qo, k, consts,
                                                boundary, shape, rp, g.halo)
            want = stencil.run(u0, v0, k, consts, boundary)
            assert bf16_equal(u, pu) and bf16_equal(v, pv), (shape, f, k)
            for got, plain, oracle in zip((uo, vo), (po, qo), want):
                assert bf16_equal(got, plain), (shape, f, k)
                got = lane_fold.unfold_state(got, g.halo, f, shape[1],
                                             shape[0])
                assert bf16_equal(got, oracle), (shape, f, k)


@pytest.mark.gpu
@pytest.mark.parametrize("fold", [2, 3])
def test_folded_run_launches_and_equals_unfolded(cuda_device, fold):
    """``run_steps`` on the folded storage: a refresh and a launch every K
    steps and one for the remainder, V bit for bit the unfolded run's."""
    shape, params = (300, 256), Parameters()
    frames = []
    for f in (fold, "off"):
        sim = CudaSimulation(params, "naive", device=cuda_device, fold=f,
                             tuned_lookup=False)
        species = sim.make_species(shape)
        assert species.storage[0] == ("folded" if f == fold else "resident")
        before = windowed.folded_launches
        sim.perform_steps(species, 19)
        assert windowed.folded_launches == before + (3 if f == fold else 0)
        frames.append(species.result_host())
    np.testing.assert_array_equal(*frames)


@pytest.mark.gpu
@pytest.mark.parametrize("entry,boundary", [
    ("f32", "naive"), ("f32", "zero"), ("bf16", "naive"), ("bf16", "zero"),
    ("fold", "naive"), ("fold bf16", "naive")])
def test_pinned_ring_entries_bitwise_equal_plain(cuda_device, entry,
                                                 boundary):
    """Each pinned ring entry of K2 (csrc/mega_pins.cu) at depths 3, 4 and
    8 on pinned tiles, three time blocks of 8 steps and one of 3: its
    plain version and the pinned double buffer bit for bit, NaN and Inf
    included (bf16: NaN's bit pattern aside), counted on its own
    counter."""
    fold = entry.startswith("fold")
    dtype = torch.bfloat16 if entry.endswith("bf16") else torch.float32
    params = Parameters()
    consts = fold_constants(params) if fold else kernel_constants(params)
    counter = "pinned_ring" + ("_fold" if fold else "") + (
        "_bf16" if dtype == torch.bfloat16 else "") + "_launches"
    shape = (1025, 300)
    for u, v in fold_states(shape, cuda_device, dtype):
        for n_blocks, steps in ((3, 8), (1, 3)):
            if fold:
                want = megakernel.megastep_reference_fold(u, v, n_blocks,
                                                          steps, consts)
            elif dtype == torch.bfloat16:
                want = megakernel.megastep_reference_bf16(
                    u, v, n_blocks, steps, consts, boundary)
            else:
                want = stencil.run(u, v, n_blocks * steps, consts, boundary)
            for (tr, tc), depth in (((32, 128), 3), ((16, 64), 4),
                                    ((16, 64), 8), ((8, 256), 3)):
                g = geometry.Geometry(tr, tc, 8)
                assert megakernel.ring_geometry(shape, depth,
                                                tiles=g).ring
                up, vp = (megakernel.pair_state(x) for x in (u, v))
                before = getattr(megakernel, counter)
                megakernel.megastep(up, vp, n_blocks, steps, consts,
                                    boundary, fold=fold, depth=depth,
                                    geometry=g)
                torch.cuda.synchronize()
                assert getattr(megakernel, counter) == before + 1
                assert all(bf16_equal(a, b) for a, b in
                           zip((up[0], vp[0]), want)), (g, depth)


@pytest.mark.gpu
def test_pinned_ring_grids_follow_the_bytes(cuda_device):
    """The pinned ring's co-resident blocks: at least one an SM, at most
    what its bytes leave room for."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for tiles, depth in (((32, 128), 3), ((16, 64), 4), ((16, 64), 8)):
        ring = megakernel.ring_geometry((1080, 1920), depth,
                                        tiles=geometry.Geometry(*tiles, 8))
        n = megakernel.pinned_ring_max_blocks(cuda_device, ring)
        assert sms <= n <= ring.blocks_per_sm * sms, (tiles, depth, n)


@pytest.mark.gpu
def test_folded_and_pinned_ring_kernels_do_not_spill(cuda_device, tmp_path):
    """ptxas's report of the folded entry's 8 instantiations (4 on
    run-time sizes, 4 compiled), its split's 6 and the first form's refresh
    kernel, the pinned ring's 24 (bound to one block an SM and to two) and
    the compiled ring's 24: no spill."""
    for source, kernel, count in (
            ("windowed_pins.cu", "18folded_form_kernel", 4),
            ("windowed_pins_fixed.cu", "18folded_form_kernel", 4),
            ("splits/windowed_folded_ablation.cu", "18folded_form_kernel", 6),
            ("splits/windowed_folded_ablation.cu", "19fold_refresh_kernel", 1),
            ("mega_pins_ring.cu", "18ring_pinned_kernel", 24),
            ("mega_ring.cu", "11ring_kernel", 44)):
        spills = ptxas_spills(source, kernel, tmp_path)
        assert len(spills) == count, (kernel, spills)
        assert all(v == (0, 0) for v in spills.values()), spills


@pytest.mark.gpu
def test_ring_ablation_parts_bitwise(cuda_device):
    """Every part of the ring's split (megakernel.RING_ABLATIONS) on the
    compiled rings at depth 3, 4 and 8 (130x210: 35 tiles of 32x32, 12 of
    64x64) and the pinned 16x64 ring at depth 4 (1025x300), one launch of
    3 time blocks of 8 steps, naive, NaN and Inf included: bit for bit the
    plain version (part 2, which steps nothing: its input), and not
    counted in any launch counter. Tolerance: none."""
    consts = kernel_constants(Parameters())
    cases = [((130, 210), d, None) for d in (3, 4, 8)]
    cases.append(((1025, 300), 4, geometry.Geometry(16, 64, 8)))
    for shape, depth, tiles in cases:
        for u, v in fold_states(shape, cuda_device, torch.float32):
            want = stencil.run(u, v, 24, consts, "naive")
            for part in megakernel.RING_ABLATIONS:
                try:
                    megakernel.ring_ablation_plan(shape, depth, part, tiles)
                except ValueError:
                    continue
                before = (megakernel.ring_launches,
                          megakernel.pinned_ring_launches)
                pu, pv = megakernel.pair_state(u), megakernel.pair_state(v)
                megakernel.ring_ablation(pu, pv, 3, 8, consts, part, depth,
                                         geometry=tiles)
                torch.cuda.synchronize()
                assert (megakernel.ring_launches,
                        megakernel.pinned_ring_launches) == before
                ref = (u, v) if part == 2 else want
                assert all(bits_equal(a, b) for a, b in
                           zip((pu[0], pv[0]), ref)), (shape, depth, part)


@pytest.mark.gpu
def test_pinned_ring_bound_follows_the_bytes(cuda_device):
    """The pinned ring's grid follows its bytes: the occupancy API's count
    is RingGeometry.blocks_per_sm an SM, two where the bytes leave room
    for two (512 threads bound to two blocks), else one (1024 threads)."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for tiles, depth in (((16, 64), 4), ((16, 64), 5), ((32, 128), 3),
                         ((8, 256), 3), ((8, 128), 4), ((16, 64), 8)):
        g = geometry.Geometry(*tiles, 8)
        ring = megakernel.ring_geometry((1080, 1920), depth, tiles=g)
        assert ring.blocks_per_sm == (
            2 if megakernel.pinned_two_blocks(ring.bytes) else 1)
        n = megakernel.pinned_ring_max_blocks(cuda_device, ring)
        assert n == ring.blocks_per_sm * sms, (tiles, depth, n)


# -- K1's pinned entries' second form and their split ------------------------


@pytest.mark.gpu
def test_pinned_ablation_parts_bitwise(cuda_device):
    """Every part of the pinned entries' split (windowed.PIN_ABLATIONS, the
    shard entry's PIN_SHARD_ABLATIONS on 2x2) on K = 16 64x64 and 32x64
    tiles and K = 8 32x128 tiles at 130x210 and 1025x300, naive, NaN and
    Inf included: bit for bit the plain version (part 2, which steps
    nothing: its input), and not counted in any launch counter. Tolerance:
    none."""
    consts = kernel_constants(Parameters())
    for shape in ((130, 210), (1025, 300)):
        for u, v in fold_states(shape, cuda_device, torch.float32):
            for k, tr, tc in ((16, 64, 64), (16, 32, 64), (8, 32, 128)):
                g = geometry.resolve(shape, k, tr, tc)
                want = stencil.run(u, v, k, consts, "naive")
                for part in windowed.PIN_ABLATIONS:
                    try:
                        windowed.check_pin_part(part, g)
                    except ValueError:
                        continue
                    before = windowed.pinned_launches
                    got = (torch.empty_like(u), torch.empty_like(v))
                    windowed.pinned_ablation(part, u, v, *got, k, consts, g)
                    torch.cuda.synchronize()
                    assert windowed.pinned_launches == before
                    ref = (u, v) if part == 2 else want
                    assert all(bits_equal(a, b) for a, b in zip(got, ref)), \
                        (shape, g, part)
        mesh = halo.Mesh(2, 2, cuda_device, 16)
        g = geometry.resolve(halo.shard_extents(shape, mesh), 16, 32)
        u_np, v_np = (x.cpu().numpy() for x in random_uv(shape, cuda_device))
        up, vp = halo.mega_shard_state(u_np, v_np, mesh)
        for x in (up, vp):
            halo.exchange_halos(x, 0, 16)
        cu, cv = up.clone(), vp.clone()
        windowed.shard_multistep_reference(cu, cv, 0, 16, consts, "naive",
                                           shape, "all", g)
        want = [halo.mega_unshard_result(x, shape, 1, 16) for x in (cu, cv)]
        for part in windowed.PIN_SHARD_ABLATIONS:
            try:
                windowed.check_pin_part(part, g)
            except ValueError:
                continue
            gu, gv = up.clone(), vp.clone()
            windowed.pinned_shard_ablation(part, gu, gv, mesh, 0, 16, consts,
                                           shape, g)
            got = [halo.mega_unshard_result(x, shape, 1, 16)
                   for x in (gu, gv)]
            ref = ([halo.mega_unshard_result(x, shape, 0, 16)
                    for x in (up, vp)] if part == 2 else want)
            assert all(bits_equal(a, b) for a, b in zip(got, ref)), \
                (shape, g, part)


@pytest.mark.gpu
def test_pinned_blocks_follow_pin_launch(cuda_device):
    """The occupancy API's blocks an SM of each pinned entry's kernel
    (gs_windowed_pinned_blocks: compiled sizes on FIXED_PINS, else
    PinGeometry's) equal Geometry.pin_launch's, for the pinned entry and
    the pinned shard entry."""
    import ctypes

    fn = build.bind("gs_windowed_pinned_blocks",
                    [ctypes.c_int] * 5 + [ctypes.c_void_p])
    for k, tr, tc in ((16, None, None), (16, 32, None), (24, None, None),
                      (16, 32, 32), (8, 32, 128), (32, None, None)):
        g = geometry.resolve((4096, 4096), k, tr, tc)
        for shard in (0, 1):
            per_sm = ctypes.c_int(0)
            assert fn(g.tr, g.tc, g.halo, shard, cuda_device.index or 0,
                      ctypes.byref(per_sm)) == 0
            assert per_sm.value == g.pin_launch().blocks_per_sm, (g, shard)


# -- the read-site entry's fitted tiles and the folded entry's one launch ----

#: row meshes whose shards the fitted tiles fit: (shape, shards)
FITTED = [((544, 256), 4), ((1088, 208), 4), ((272, 300), 2)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("boundary", ["naive", "zero"])
@pytest.mark.parametrize("shape,n", FITTED)
def test_k7_fitted_read_site_bitwise(cuda_device, dtype, boundary, shape, n):
    """K7's read-site entry on the fitted 68x64 tiles, the compiled entry
    (counted in ``launches`` or ``bf16_launches`` and in
    ``read_site_launches``, not in the pinned counters), one launch of 1,
    3 and 4 time blocks: bit for bit the plain version, halos included.
    Tolerance: none."""
    consts = kernel_constants(Parameters())
    mesh = halo.make_mesh(n, 1, cuda_device)
    fit = sharded_mega.fitted_tile(shape, mesh.shape)
    assert fit == (68, 64)
    u, v = random_uv(shape, "cpu")
    for n_blocks, steps in ((1, 8), (3, 8), (4, 5)):
        runs = []
        for kernel in (True, False):
            pairs = [p.to(dtype) for p in halo.mega_shard_state(u, v, mesh)]
            for p in pairs:
                halo.exchange_halos(p)
            if kernel:
                before = (sharded_mega.read_site_launches,
                          sharded_mega.launches + sharded_mega.bf16_launches,
                          sharded_mega.pinned_launches
                          + sharded_mega.pinned_bf16_launches)
                sharded_mega.sharded_megastep(
                    *pairs, mesh, n_blocks, steps, consts, boundary, shape,
                    geometry=geometry.Geometry(*fit, 8))
                assert (sharded_mega.read_site_launches,
                        sharded_mega.launches + sharded_mega.bf16_launches,
                        sharded_mega.pinned_launches
                        + sharded_mega.pinned_bf16_launches) \
                    == (before[0] + 1, before[1] + 1, before[2])
            else:
                sharded_mega.sharded_megastep_reference(
                    *pairs, n_blocks, steps, consts, boundary, shape)
            runs.append(pairs)
        torch.cuda.synchronize()
        assert all(bf16_equal(a, b) if dtype == torch.bfloat16
                   else torch.equal(a, b) for a, b in zip(*runs)), \
            (n_blocks, steps)


@pytest.mark.gpu
@pytest.mark.parametrize("part", sorted(sharded_mega.READ_SITE_ABLATIONS))
@pytest.mark.parametrize("shape,n", FITTED[:2])
def test_k7_read_site_split_parts_bitwise(cuda_device, part, shape, n):
    """Every part of the read-site split, one launch of 4 time blocks of 8
    steps, naive, NaN and Inf included: slot 0 bit for bit the plain
    version's (the parts that step nothing: their input), and not counted.
    Tolerance: none."""
    consts = kernel_constants(Parameters())
    mesh = halo.make_mesh(n, 1, cuda_device)
    u, v = nan_state(shape, "cpu")
    pairs = halo.mega_shard_state(u, v, mesh)
    for p in pairs:
        halo.exchange_halos(p)
    want = [p.clone() for p in pairs]
    counts = (sharded_mega.launches, sharded_mega.read_site_launches)
    assert sharded_mega.read_site_ablation(part, *pairs, mesh, 4, 8, consts,
                                           "naive", shape) >= n
    sharded_mega.read_site_ablation_reference(part, *want, 4, 8, consts,
                                              "naive", shape)
    torch.cuda.synchronize()
    assert (sharded_mega.launches, sharded_mega.read_site_launches) == counts
    # slot 0, halos included (a part that steps nothing leaves slot 1 as
    # its copies or pushes left it)
    assert all(bits_equal(a[:, :, 0], b[:, :, 0]) for a, b in zip(pairs, want))


@pytest.mark.gpu
@pytest.mark.parametrize("part", sorted(windowed.FOLDED_ABLATIONS))
@pytest.mark.parametrize("shape,f,k", [((300, 256), 2, 8), ((300, 256), 2, 16),
                                       ((1000, 128), 8, 8)])
def test_folded_split_parts_bitwise(cuda_device, part, shape, f, k):
    """Every part of the folded entry's split that runs on the case's tiles
    (64x64 at a halo of 8 or 16), one call of K steps, naive, NaN and Inf
    at the panels' seam: the outputs and the input's halo rows bit for
    bit the part's plain version, and not counted. Tolerance: none."""
    consts = kernel_constants(Parameters())
    g = geometry.resolve((-(-shape[0] // f), shape[1]), k)
    rp = lane_fold.fold_geometry(shape[0], f, g.tr)
    if part in windowed.FOLDED_ABLATION_FIXED:
        assert tuple(g) in windowed.FOLDED_FIXED
    u, v = random_uv(shape, "cpu")
    u[rp - 1, -1] = v[rp, 0] = float("nan")
    u[rp, -1] = float("-inf")
    x = list(lane_fold.fold_state(u, v, f, g.tr, g.halo, cuda_device))
    x += [torch.zeros_like(x[0]), torch.zeros_like(x[0])]
    y = [t.clone() for t in x]
    before = windowed.folded_launches
    windowed.folded_ablation(part, *x, k, consts, "naive", shape, rp, g)
    windowed.folded_ablation_reference(part, *y, k, consts, "naive", shape,
                                       rp, g.halo)
    torch.cuda.synchronize()
    assert windowed.folded_launches == before
    assert all(bits_equal(a, b) for a, b in zip(x, y))


@pytest.mark.gpu
def test_new_split_kernels_do_not_spill(cuda_device, tmp_path):
    """ptxas's report of K7's fitted instantiations (68x64 tiles: the read
    site's two tap sets and boundaries, float32 and bf16): no spill; of
    the read-site split's 14 parts, reported (part 3's naive instantiation
    at a run-time height spills 24 B at its 64 registers)."""
    spills = ptxas_spills("sharded_mega_fit.cu", "19sharded_mega_kernel",
                          tmp_path)
    assert len(spills) == 8, spills
    assert all("ILi68ELi64ELi512ELi4E" in k for k in spills), spills
    assert all(s == (0, 0) for s in spills.values()), spills
    spills = ptxas_spills("splits/sharded_mega_ablation.cu",
                          "15ablation_kernel", tmp_path)
    assert len(spills) == 14, spills
    spilled = [k for k, s in spills.items() if s != (0, 0)]
    assert all("8FitShape" in k for k in spilled), spilled
