"""``mega_depth`` on the port's mega engine against JAX's
``PallasSimulation(engine='mega', mega_depth=D)`` in Pallas interpret mode
after 16 steps, and bitwise against the port's own depth-2 run.

Tolerance against JAX: atol 2e-6, as tests/test_torch_megakernel.py holds
K2 (JAX's zero path folds the update's linear terms, a few ulp off the
oracle's rounding). JAX's interpret megakernel compiles anew for each
depth (about 10 s a run), so the depths run at one shape that keeps every
depth unclamped in both packages (17 row blocks of 8 in JAX, 20 tiles of
32x32 and 6 of 64x64 in the port), and one shape under the clamp."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from grayscott_tpu.backends.pallas import PallasSimulation
from grayscott_tpu.params import Parameters as JaxParameters
from grayscott_tpu_torch.backends.cuda import CudaSimulation
from grayscott_tpu_torch.ops import megakernel
from grayscott_tpu_torch.params import Parameters
from grayscott_tpu_torch.species import Species

from conftest import random_uv

#: every depth unclamped in both packages
WIDE = (136, 128)
#: under the clamp in both: one tile, three row blocks of 8
NARROW = (24, 32)
STEPS = 16


def run_jax(u, v, boundary, depth):
    sim = PallasSimulation(JaxParameters(), boundary=boundary,
                           engine="mega", interpret=True, block_rows=8,
                           mega_depth=depth)
    species = sim.make_species(u.shape)
    species.storage = sim.build_storage(u, v)
    assert species.storage[0] == "mega"
    sim.perform_steps(species, STEPS)
    return species.uv_host()


def run_port(u, v, boundary, depth, **kwargs):
    sim = CudaSimulation(Parameters(), boundary, device="cpu", engine="mega",
                         mega_depth=depth, **kwargs)
    species = Species(u.shape, sim.build_storage(u, v), sim)
    sim.perform_steps(species, STEPS)
    return species.uv_host()


@pytest.mark.parametrize("shape,boundary,depth", [
    *((WIDE, "naive", d) for d in megakernel.DEPTHS),
    (WIDE, "zero", 8),
    (NARROW, "naive", 4),
])
def test_depth_matches_jax(rng, shape, boundary, depth):
    u, v = random_uv(rng, shape)
    g = megakernel.ring_geometry(shape, depth)
    assert g.depth == (depth if shape == WIDE else 2)
    ju, jv = run_jax(u, v, boundary, depth)
    pu, pv = run_port(u, v, boundary, depth)
    np.testing.assert_allclose(pu, ju, rtol=0, atol=2e-6)
    np.testing.assert_allclose(pv, jv, rtol=0, atol=2e-6)
    for got, want in zip((pu, pv), run_port(u, v, boundary, 2)):
        np.testing.assert_array_equal(got, want)
