"""The port's windowed multistep (grayscott_tpu_torch/ops/windowed.py)
against the JAX windowed kernel K1 in Pallas interpret mode, its input
checks and its launch counter. The CUDA kernel itself is held against its
plain version on the card by tests/test_torch_gpu.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from grayscott_tpu import oracle
from grayscott_tpu.backends.pallas import PallasSimulation
from grayscott_tpu.params import Parameters
from grayscott_tpu_torch.backends.cuda import CudaSimulation
from grayscott_tpu_torch.ops import windowed
from grayscott_tpu_torch.params import kernel_constants
from grayscott_tpu_torch.species import Species

from conftest import random_uv

SHAPE = (24, 32)


def run_jax_k1(u, v, params, boundary, steps):
    """K1 in interpret mode, as tests/test_pallas.py runs it (K = 8)."""
    sim = PallasSimulation(params, boundary=boundary, interpret=True,
                           block_rows=8)
    species = sim.make_species(u.shape)
    species.storage = sim.build_storage(u, v)
    sim.perform_steps(species, steps)
    return species.uv_host()


def run_port(u, v, params, boundary, steps):
    """One multistep call for steps <= K; more go through the backend,
    which makes K-step launches and one remainder launch (9 = 8 + 1)."""
    if steps <= windowed.K:
        tu, tv = torch.from_numpy(u), torch.from_numpy(v)
        uo, vo = torch.empty_like(tu), torch.empty_like(tv)
        windowed.multistep(tu, tv, uo, vo, steps, kernel_constants(params),
                           boundary)
        return uo.numpy(), vo.numpy()
    sim = CudaSimulation(params, boundary, device="cpu")
    species = Species(u.shape, sim.build_storage(u, v), sim)
    sim.perform_steps(species, steps)
    return species.uv_host()


@pytest.mark.parametrize("boundary", ["naive", "zero"])
@pytest.mark.parametrize("steps", [1, 8, 9])
def test_multistep_matches_jax_k1(rng, params, boundary, steps):
    """atol 2e-6 against JAX K1: its zero path folds the update's linear
    terms into other coefficients (pallas_stencil._zero_fold_coeffs), so it
    rounds differently from the oracle's tree by a few ulp. Against the
    oracle itself the port is bitwise."""
    u, v = random_uv(rng, SHAPE)
    ju, jv = run_jax_k1(u, v, params, boundary, steps)
    pu, pv = run_port(u, v, params, boundary, steps)
    np.testing.assert_allclose(pu, ju, rtol=0, atol=2e-6)
    np.testing.assert_allclose(pv, jv, rtol=0, atol=2e-6)
    ou, ov = oracle.run(u, v, params, steps, boundary)
    np.testing.assert_array_equal(pu, ou)
    np.testing.assert_array_equal(pv, ov)


def _buffers(shape=(8, 12)):
    u = torch.rand(shape)
    return [u, torch.rand(shape), torch.empty(shape), torch.empty(shape)]


def _bad(kind):
    u, v, uo, vo = _buffers()
    steps, boundary = 1, "naive"
    if kind == "dtype":
        v = v.double()
    elif kind == "shape":
        vo = torch.empty(8, 13)
    elif kind == "ndim":
        u, v, uo, vo = (torch.rand(2, 8, 12) for _ in range(4))
    elif kind == "contiguous":
        u = torch.rand(12, 8).t()
    elif kind == "aliased":
        uo = u
    elif kind == "same_out":
        vo = uo
    elif kind == "steps_zero":
        steps = 0
    elif kind == "steps_over_k":
        steps = windowed.K + 1
    elif kind == "steps_float":
        steps = 2.0
    elif kind == "boundary":
        boundary = "periodic"
    elif kind == "device":
        u, v, uo, vo = (torch.empty(8, 12, device="meta") for _ in range(4))
    elif kind == "mixed_device":
        vo = torch.empty(8, 12, device="meta")
    return u, v, uo, vo, steps, boundary


@pytest.mark.parametrize("kind", [
    "dtype", "shape", "ndim", "contiguous", "aliased", "same_out",
    "steps_zero", "steps_over_k", "steps_float", "boundary", "device",
    "mixed_device",
])
def test_multistep_rejects_bad_arguments(kind):
    u, v, uo, vo, steps, boundary = _bad(kind)
    with pytest.raises(ValueError):
        windowed.multistep(u, v, uo, vo, steps,
                           kernel_constants(Parameters()), boundary)


def test_cpu_calls_do_not_count_as_launches(rng, params):
    """On the CPU the wrapper runs the plain version: no kernel launch."""
    before = windowed.launches
    u, v = random_uv(rng, SHAPE)
    run_port(u, v, params, "naive", 8)
    run_port(u, v, params, "zero", 9)
    assert windowed.launches == before


@pytest.mark.parametrize("knob,value", [
    ("block_rows", 8), ("fold", 2), ("pack", "on"), ("steps_per_call", 16),
])
def test_unported_knobs_raise(params, knob, value):
    """Each knob where the port does not run it: the lane fold, the packed
    layout on the naive boundary, the megakernel's K (JAX's refusal), and
    its tile pin with the window ring (ROADMAP.md Queue 2 item 12; the tile
    pin alone runs: tests/test_torch_mega_pins.py; on K1 the K and tile
    pins run: tests/test_torch_tile_pins.py)."""
    from grayscott_tpu_torch.errors import UnsupportedConfigError

    engine = "mega" if knob in ("block_rows", "steps_per_call") else "auto"
    ring = {"mega_depth": 3} if knob == "block_rows" else {}
    with pytest.raises(UnsupportedConfigError):
        CudaSimulation(params, device="cpu", engine=engine, **{knob: value},
                       **ring)


@pytest.mark.parametrize("steps", [1, 8])
def test_multistep_on_bf16_storage(rng, params, steps):
    """The knob that raised until bf16 storage was ported: one K1 call on
    bfloat16 tensors is the oracle's ``steps`` steps rounded to bfloat16
    once (JAX's kernel on bf16 storage; tests/test_torch_bf16.py holds the
    port against it), and launches nothing on the CPU."""
    from test_torch_bf16 import oracle_bf16

    u, v = random_uv(rng, SHAPE)
    tu, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (u, v))
    uo, vo = torch.empty_like(tu), torch.empty_like(tv)
    before = windowed.bf16_launches
    windowed.multistep(tu, tv, uo, vo, steps, kernel_constants(params),
                       "naive")
    assert windowed.bf16_launches == before
    for got, want in zip((uo, vo), oracle_bf16(u, v, params, steps,
                                               "naive")):
        np.testing.assert_array_equal(got.float().numpy(), want)
