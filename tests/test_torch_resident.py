"""The port's resident engine (grayscott_tpu_torch/ops/resident.py and the
backend's ``resident`` storage) against the JAX resident kernel K3 in
Pallas interpret mode, and its wrapper's checks. The CUDA kernel itself is
held against its plain version on the card by tests/test_torch_gpu.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from grayscott_tpu import oracle
from grayscott_tpu.backends.pallas import PallasSimulation
from grayscott_tpu_torch.backends.cuda import CudaSimulation
from grayscott_tpu_torch.ops import resident
from grayscott_tpu_torch.params import Parameters, kernel_constants
from grayscott_tpu_torch.species import Species

from conftest import random_uv


def run_jax_k3(u, v, params, boundary, steps):
    """K3 in interpret mode, as tests/test_pallas.py runs it."""
    sim = PallasSimulation(params, boundary=boundary, resident="on",
                           interpret=True)
    species = sim.make_species(u.shape)
    species.storage = sim.build_storage(u, v)
    assert species.storage[0] == "resident"
    sim.perform_steps(species, steps)
    return species.uv_host()


def run_port(u, v, params, boundary, steps, pins):
    sim = CudaSimulation(params, boundary, device="cpu", **pins)
    species = Species(u.shape, sim.build_storage(u, v), sim)
    sim.perform_steps(species, steps)
    return species.storage[0], species.uv_host()


@pytest.mark.parametrize("boundary", ["naive", "zero"])
@pytest.mark.parametrize("shape", [(24, 16), (17, 23)])
def test_resident_matches_jax_k3(rng, params, boundary, shape):
    """7 steps in one call. atol 2e-6 against JAX K3 (its zero path folds
    the update's linear terms, a few ulp off the oracle's rounding);
    bitwise against the oracle."""
    u, v = random_uv(rng, shape)
    ju, jv = run_jax_k3(u, v, params, boundary, 7)
    engine, (pu, pv) = run_port(u, v, params, boundary, 7,
                                {"resident": "on"})
    assert engine == "resident"
    np.testing.assert_allclose(pu, ju, rtol=0, atol=2e-6)
    np.testing.assert_allclose(pv, jv, rtol=0, atol=2e-6)
    ou, ov = oracle.run(u, v, params, 7, boundary)
    np.testing.assert_array_equal(pu, ou)
    np.testing.assert_array_equal(pv, ov)


@pytest.mark.parametrize("steps", [1, 2, 7])
def test_multistep_returns_the_result_first(rng, steps):
    """The buffers come back with the result pair first, whatever the
    parity of the step count; the input tensors are the storage."""
    u, v = random_uv(rng, (9, 11))
    consts = kernel_constants(Parameters())
    bufs = [torch.from_numpy(u.copy()), torch.from_numpy(v.copy()),
            torch.empty(9, 11), torch.empty(9, 11)]
    out = resident.multistep(*bufs, steps, consts, "naive")
    assert {id(t) for t in out} == {id(t) for t in bufs}
    ou, ov = oracle.run(u, v, Parameters(), steps, "naive")
    np.testing.assert_array_equal(out[0].numpy(), ou)
    np.testing.assert_array_equal(out[1].numpy(), ov)
    assert (out[0] is bufs[0]) == (steps % 2 == 0)


def test_run_steps_zero_is_a_no_op(rng):
    u, v = random_uv(rng, (9, 11))
    sim = CudaSimulation(Parameters(), device="cpu", resident="on")
    storage = sim.build_storage(u, v)
    assert sim.run_steps(storage, (9, 11), 0) is storage


def _bad(kind):
    bufs = [torch.rand(8, 12) for _ in range(4)]
    steps, boundary, grid = 1, "naive", 0
    if kind == "dtype":
        bufs[1] = bufs[1].double()
    elif kind == "shape":
        bufs[3] = torch.empty(8, 13)
    elif kind == "aliased":
        bufs[2] = bufs[0]
    elif kind == "overlap":
        whole = torch.empty(2, 8, 12)
        bufs[2] = whole.view(-1)[:96].view(8, 12)
        bufs[3] = whole.view(-1)[48:144].view(8, 12)
    elif kind == "contiguous":
        bufs[0] = torch.rand(12, 8).t()
    elif kind == "steps_zero":
        steps = 0
    elif kind == "grid":
        grid = -1
    elif kind == "boundary":
        boundary = "periodic"
    elif kind == "device":
        bufs = [torch.empty(8, 12, device="meta") for _ in range(4)]
    return bufs, steps, boundary, grid


@pytest.mark.parametrize("kind", [
    "dtype", "shape", "aliased", "overlap", "contiguous", "steps_zero",
    "grid", "boundary", "device",
])
def test_multistep_rejects_bad_arguments(kind):
    bufs, steps, boundary, grid = _bad(kind)
    with pytest.raises(ValueError):
        resident.multistep(*bufs, steps, kernel_constants(Parameters()),
                           boundary, grid=grid)


def test_cpu_calls_do_not_count_as_launches(rng, params):
    before = resident.launches
    u, v = random_uv(rng, (17, 23))
    run_port(u, v, params, "zero", 5, {"resident": "on"})
    assert resident.launches == before
