"""The port's mega engine (grayscott_tpu_torch/ops/megakernel.py and the
backend's ``mega`` storage) against the JAX single-chip megakernel K2 in
Pallas interpret mode; the engine choice (``auto_engine``) and the knobs
that are not ported. The CUDA kernel itself is held against its plain
version on the card by tests/test_torch_gpu.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from grayscott_tpu import oracle
from grayscott_tpu.backends.pallas import PallasSimulation
from grayscott_tpu_torch.backends import cuda as cuda_backend
from grayscott_tpu_torch.backends.cuda import CudaSimulation
from grayscott_tpu_torch.errors import UnsupportedConfigError
from grayscott_tpu_torch.ops import megakernel
from grayscott_tpu_torch.params import Parameters, kernel_constants
from grayscott_tpu_torch.species import Species

from conftest import random_uv


def run_jax_k2(u, v, params, boundary, steps):
    """K2 in interpret mode, as tests/test_mega.py runs it."""
    sim = PallasSimulation(params, boundary=boundary, engine="mega",
                           interpret=True, block_rows=8)
    species = sim.make_species(u.shape)
    species.storage = sim.build_storage(u, v)
    assert species.storage[0] == "mega"
    sim.perform_steps(species, steps)
    return species.uv_host()


@pytest.mark.parametrize("boundary", ["naive", "zero"])
@pytest.mark.parametrize("shape,steps", [
    ((24, 32), 16),  # two time blocks: an even count, one launch
    ((24, 32), 27),  # three (odd: the slot copy) and a remainder of 3
    ((19, 32), 16),  # ragged rows
])
def test_mega_matches_jax_k2(rng, params, boundary, shape, steps):
    """atol 2e-6 against JAX K2 (its zero path folds the update's linear
    terms, a few ulp off the oracle's rounding); bitwise against the
    oracle."""
    u, v = random_uv(rng, shape)
    ju, jv = run_jax_k2(u, v, params, boundary, steps)
    sim = CudaSimulation(params, boundary, device="cpu", engine="mega")
    species = Species(shape, sim.build_storage(u, v), sim)
    assert species.storage[0] == "mega"
    assert species.storage[1].shape == (2, *shape)
    sim.perform_steps(species, steps)
    pu, pv = species.uv_host()
    np.testing.assert_allclose(pu, ju, rtol=0, atol=2e-6)
    np.testing.assert_allclose(pv, jv, rtol=0, atol=2e-6)
    ou, ov = oracle.run(u, v, params, steps, boundary)
    np.testing.assert_array_equal(pu, ou)
    np.testing.assert_array_equal(pv, ov)


def test_pair_state_keeps_slot_zero(rng):
    u, _ = random_uv(rng, (5, 7))
    pair = megakernel.pair_state(torch.from_numpy(u))
    assert pair.shape == (2, 5, 7) and pair.is_contiguous()
    np.testing.assert_array_equal(pair[0].numpy(), u)


@pytest.mark.parametrize("kind", [
    "not_a_pair", "n_blocks_zero", "steps_over", "grid", "aliased",
    "dtype", "boundary",
])
def test_megastep_rejects_bad_arguments(kind):
    up, vp = torch.rand(2, 8, 12), torch.rand(2, 8, 12)
    n_blocks, steps, boundary, grid = 1, 8, "naive", 0
    if kind == "not_a_pair":
        up, vp = torch.rand(3, 8, 12), torch.rand(3, 8, 12)
    elif kind == "n_blocks_zero":
        n_blocks = 0
    elif kind == "steps_over":
        steps = megakernel.MEGA_STEPS + 1
    elif kind == "grid":
        grid = -2
    elif kind == "aliased":
        vp = up
    elif kind == "dtype":
        vp = vp.half()
    elif kind == "boundary":
        boundary = "periodic"
    with pytest.raises(ValueError):
        megakernel.megastep(up, vp, n_blocks, steps,
                            kernel_constants(Parameters()), boundary,
                            grid=grid)


def test_cpu_calls_do_not_count_as_launches(rng, params):
    before = megakernel.launches
    u, v = random_uv(rng, (17, 23))
    sim = CudaSimulation(params, "zero", device="cpu", engine="mega")
    sim.run_steps(sim.build_storage(u, v), (17, 23), 19)
    assert megakernel.launches == before


@pytest.mark.parametrize("boundary", ["naive", "zero"])
@pytest.mark.parametrize("shape,cls", [
    ((1080, 1920), "l2"),      # the default run: 33.2 MB of state buffers
    ((24, 32), "l2"),
    ((1500, 1500), "l2"),      # 36.0 MB, just under 3/4 of the L2
    ((2048, 2048), "larger"),  # 67 MB
    ((4096, 4096), "larger"),  # the bench shape: 268 MB
])
def test_auto_engine_classes(shape, cls, boundary):
    """Two shape classes, by whether the four f32 state buffers fit the
    L2 share; each picks the engine measured fastest for the class and
    the boundary (on the card: K3 for the default naive run, K2 on the
    zero boundary in L2, K1 beyond L2), and resident='off' skips K3."""
    assert cuda_backend.shape_class(shape) == cls
    ranking = cuda_backend._RANKING[cls, boundary]
    assert sorted(ranking) == ["mega", "resident", "windowed"]
    assert ranking[0] == {("l2", "naive"): "resident", ("l2", "zero"): "mega",
                          ("larger", "naive"): "windowed",
                          ("larger", "zero"): "windowed"}[cls, boundary]
    assert cuda_backend.auto_engine(shape, boundary) == ranking[0]
    assert cuda_backend.auto_engine(shape, boundary, resident_ok=False) \
        == next(e for e in ranking if e != "resident")
    sim = CudaSimulation(Parameters(), boundary, device="cpu")
    assert sim.engine_for(shape) == ranking[0]
    off = CudaSimulation(Parameters(), boundary, device="cpu",
                         resident="off")
    assert off.engine_for(shape) != "resident"


@pytest.mark.parametrize("pins,engine", [
    ({"engine": "windowed"}, "windowed"),
    ({"engine": "mega"}, "mega"),
    ({"resident": "on"}, "resident"),
    ({"engine": "mega", "resident": "off"}, "mega"),
])
def test_pins_name_their_engine(pins, engine):
    for shape in ((24, 32), (4096, 4096)):
        assert CudaSimulation(Parameters(), device="cpu", **pins) \
            .engine_for(shape) == engine


@pytest.mark.parametrize("kwargs", [
    {"resident": "on", "engine": "mega"},
    {"resident": "on", "engine": "windowed"},
    {"mega_specialize": True, "naive_fix": "store"},  # JAX's refusal
    # JAX's refusals of a lane-fold pin (tests/test_torch_lane_fold.py)
    {"fold": 2, "resident": "on"},
    {"fold": 2, "naive_fold": True},
])
def test_unported_or_conflicting_pins_raise(kwargs):
    with pytest.raises(UnsupportedConfigError):
        CudaSimulation(Parameters(), device="cpu", **kwargs)


@pytest.mark.parametrize("kwargs", [{"engine": "fast"},
                                    {"resident": "yes"}])
def test_unknown_knob_values_raise(kwargs):
    with pytest.raises(ValueError):
        CudaSimulation(Parameters(), device="cpu", **kwargs)
