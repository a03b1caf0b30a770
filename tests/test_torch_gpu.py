"""The port's CUDA kernel on a CUDA card, against its plain PyTorch
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
from grayscott_tpu_torch.ops import windowed
from grayscott_tpu_torch.params import STENCILS, Parameters, kernel_constants

#: ragged shapes put tile seams and all four domain edges inside the 32x32
#: tiles; (1, 1) is a domain smaller than one tile's interior
SHAPES = [(1, 1), (33, 65), (70, 97), (64, 96)]


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
