"""bf16 storage: the port's sharded backend against JAX's
``ShardedSimulation(..., dtype="bfloat16", steps_per_call=8)``, its
windowed engine in TPU interpret mode, on 2x1 and 2x2 meshes, bit for bit:
the port's windowed engine (overlap off and on) and its megakernel K7
(tests/test_torch_bf16.py has the oracle and the single-chip kernels)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from grayscott_tpu.backends.sharded import ShardedSimulation as JaxSharded
from grayscott_tpu_torch.backends.sharded import ShardedSimulation
from grayscott_tpu_torch.params import Parameters

from conftest import random_uv
from test_torch_bf16 import BOUNDARIES, SHAPES, STEPS, assert_bitwise, run_sim
from test_torch_bf16_jax import run_jax


@pytest.mark.parametrize("steps", STEPS)
@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mesh", [(2, 1), (2, 2)])
def test_sharded_equals_jax_sharded_windowed_bf16(rng, params, mesh, shape,
                                                  boundary, steps):
    u, v = random_uv(rng, shape)
    n = mesh[0] * mesh[1]
    want = run_jax(JaxSharded(params, boundary=boundary, engine="windowed",
                              n_devices=n, mesh_cols=mesh[1],
                              interpret=True, dtype="bfloat16",
                              steps_per_call=8, tuned_lookup=False),
                   u, v, steps)
    for kwargs in ({"engine": "windowed", "overlap": "off"},
                   {"engine": "windowed", "overlap": "on"},
                   {"engine": "mega"}):
        port = ShardedSimulation(Parameters(), boundary, device="cpu",
                                 dtype="bfloat16", n_devices=n,
                                 mesh_cols=mesh[1], tuned_lookup=False,
                                 **kwargs)
        assert_bitwise(run_sim(port, u, v, steps).uv_host(), want)
