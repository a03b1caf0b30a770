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
from grayscott_tpu_torch.cli import simulate
from grayscott_tpu_torch.ops import megakernel, resident, windowed
from grayscott_tpu_torch.params import STENCILS, Parameters, kernel_constants

#: ragged shapes put tile seams and all four domain edges inside the 32x32
#: tiles; (1, 1) is a domain smaller than one tile's interior
SHAPES = [(1, 1), (33, 65), (70, 97), (64, 96)]

#: one launch, an odd and an even time-block count, remainders
STEP_COUNTS = [1, 7, 8, 9, 27]


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
    u, v = random_uv((70000 * 32, 1), cuda_device)  # grid.y over 65535
    with pytest.raises(RuntimeError, match="CUDA error"):
        windowed.multistep(u, v, torch.empty_like(u), torch.empty_like(v),
                           1, consts, "naive")


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
