"""bf16 storage: the port against JAX's megakernel on bf16 storage in TPU
interpret mode, bit for bit (tests/test_torch_bf16.py has the oracle and
the windowed kernel): the single-chip megakernel against the port's K2
path, and the sharded megakernel on a 2x1 mesh against the port's K7 path
(JAX's 2-D sharded megakernel needs shards of 128 columns or more, wider
than these domains)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from grayscott_tpu.backends.pallas import PallasSimulation
from grayscott_tpu.backends.sharded import ShardedSimulation as JaxSharded
from grayscott_tpu_torch.backends.cuda import CudaSimulation
from grayscott_tpu_torch.backends.sharded import ShardedSimulation
from grayscott_tpu_torch.params import Parameters

from conftest import random_uv
from test_torch_bf16 import (BOUNDARIES, SHAPES, STEPS, assert_bitwise,
                             oracle_bf16, run_sim)


def run_jax(sim, u, v, steps):
    species = sim.make_species(u.shape)
    species.storage = sim.build_storage(u, v)
    sim.perform_steps(species, steps)
    return species.uv_host()


@pytest.mark.parametrize("steps", STEPS)
@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("shape", SHAPES)
def test_cuda_backend_equals_jax_mega_bf16(rng, params, shape, boundary,
                                           steps):
    u, v = random_uv(rng, shape)
    want = run_jax(PallasSimulation(params, boundary=boundary,
                                    interpret=True, dtype="bfloat16",
                                    engine="mega"), u, v, steps)
    port = CudaSimulation(Parameters(), boundary, device="cpu",
                          dtype="bfloat16", engine="mega")
    assert_bitwise(run_sim(port, u, v, steps).uv_host(), want)
    assert_bitwise(want, oracle_bf16(u, v, params, steps, boundary))


@pytest.mark.parametrize("steps", STEPS)
@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_equals_jax_sharded_mega_bf16(rng, params, shape, boundary,
                                              steps):
    u, v = random_uv(rng, shape)
    want = run_jax(JaxSharded(params, boundary=boundary, engine="mega",
                              n_devices=2, mesh_cols=1, interpret=True,
                              dtype="bfloat16", tuned_lookup=False),
                   u, v, steps)
    port = ShardedSimulation(Parameters(), boundary, device="cpu",
                             dtype="bfloat16", engine="mega", n_devices=2,
                             mesh_cols=1, tuned_lookup=False)
    species = run_sim(port, u, v, steps)
    assert species.storage[0] == "shmega"
    assert_bitwise(species.uv_host(), want)
