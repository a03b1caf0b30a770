"""The port's plain PyTorch step (grayscott_tpu_torch/ops/stencil.py)
against the numpy oracle, and the port's kernel constants against the JAX
kernel's reaction operand."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from grayscott_tpu import oracle
from grayscott_tpu.ops import pallas_stencil as ps
from grayscott_tpu.params import Parameters, STENCILS
from grayscott_tpu_torch.ops import stencil
from grayscott_tpu_torch.params import kernel_constants

from conftest import random_uv


def torch_run(u, v, params, steps, boundary):
    tu, tv = torch.from_numpy(u), torch.from_numpy(v)
    consts = kernel_constants(params)
    for _ in range(steps):
        tu, tv = stencil.step(tu, tv, consts, boundary)
    return tu.numpy(), tv.numpy()


@pytest.mark.parametrize("shape", [(24, 32), (17, 29)])
@pytest.mark.parametrize("boundary", ["naive", "zero"])
@pytest.mark.parametrize("stencil_name", sorted(STENCILS))
def test_step_bitwise_equals_oracle(rng, shape, boundary, stencil_name):
    """Tolerance: none. Same float32 expression tree, term order and
    zero-weight skips as oracle.step, so every bit agrees."""
    params = Parameters.with_stencil(stencil_name)
    u, v = random_uv(rng, shape)
    ou, ov = oracle.step(u, v, params, boundary)
    tu, tv = torch_run(u, v, params, 1, boundary)
    np.testing.assert_array_equal(tu, ou)
    np.testing.assert_array_equal(tv, ov)


@pytest.mark.parametrize("boundary", ["naive", "zero"])
def test_run_bitwise_equals_oracle_runtime_params(rng, boundary):
    """Five steps with non-default f, k, Du and dt: still bitwise."""
    params = Parameters.with_stencil(
        "patra-karttunen", feed_rate=0.0367, kill_rate=0.0649,
        diffusion_rate_u=0.12, time_step=0.5)
    u, v = random_uv(rng, (17, 29))
    ou, ov = oracle.run(u, v, params, 5, boundary)
    tu, tv = torch_run(u, v, params, 5, boundary)
    np.testing.assert_array_equal(tu, ou)
    np.testing.assert_array_equal(tv, ov)


@pytest.mark.parametrize("preset", ["reference", "coral", "chaos"])
def test_kernel_constants_match_jax_reaction_operand(preset):
    """[Du, Dv, f, -(f+k), dt] rounded exactly as the JAX kernel's
    runtime-parameter operand, and the weights as float32."""
    params = Parameters.with_preset(preset, time_step=0.75)
    consts = kernel_constants(params)
    want = ps.reaction_operand(params)[0, :5]
    np.testing.assert_array_equal(np.float32(consts.reaction), want)
    np.testing.assert_array_equal(
        np.float32(consts.weights), params.weights_array().reshape(-1))
    assert all(float(np.float32(x)) == x
               for x in consts.weights + consts.reaction)


def test_unknown_boundary_raises(rng):
    u, v = random_uv(rng, (8, 8))
    with pytest.raises(ValueError, match="boundary"):
        stencil.step(torch.from_numpy(u), torch.from_numpy(v),
                     kernel_constants(Parameters()), "periodic")
