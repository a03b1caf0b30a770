"""The megakernels' tile pins against the JAX package on the CPU: the port's
K2 and K6 under ``block_rows`` and ``block_cols`` (their plain versions
here) against JAX's megakernels in interpret mode on the same pins
(``tests/test_mega.py:21-27``'s ``run_mega`` form), float32 within 1e-6
and bf16 storage bit for bit, and the refusals of the values JAX refuses
with JAX's exception class and message. JAX's interpret mode unrolls the
time block: the cases are small."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from grayscott_tpu.backends.pallas import PallasSimulation
from grayscott_tpu.errors import UnsupportedConfigError as JaxUnsupported
from grayscott_tpu.params import Parameters as JaxParameters
from grayscott_tpu_torch.backends.cuda import CudaSimulation
from grayscott_tpu_torch.errors import UnsupportedConfigError
from grayscott_tpu_torch.params import Parameters
from grayscott_tpu_torch.species import Species

from conftest import random_uv


def run_mega(u, v, boundary, steps, **kw):
    """JAX's megakernel, as ``tests/test_mega.py:run_mega`` runs it."""
    sim = PallasSimulation(JaxParameters(), boundary=boundary,
                           interpret=True, engine="mega",
                           tuned_lookup=False, **kw)
    species = sim.make_species(u.shape)
    species.storage = sim.build_storage(u, v)
    sim.perform_steps(species, steps)
    return species.uv_host()


def run_port(u, v, boundary, steps, **kw):
    sim = CudaSimulation(Parameters(), boundary, device="cpu", engine="mega",
                         tuned_lookup=False, **kw)
    species = Species(u.shape, sim.build_storage(u, v), sim)
    sim.perform_steps(species, steps)
    return species.uv_host()


@pytest.mark.parametrize("shape,boundary,pins", [
    ((40, 264), "naive", {"block_rows": 16, "block_cols": 128}),
    ((40, 56), "zero", {"block_rows": 8}),
])
def test_pinned_k2_matches_jax(shape, boundary, pins):
    """Two time blocks: within JAX's 1e-6 of JAX's megakernel on the same
    pins (its shift algebra is a few ulp off the oracle's tree, which the
    port's plain version is bit for bit)."""
    u, v = random_uv(np.random.RandomState(7), shape)
    for got, want in zip(run_port(u, v, boundary, 16, **pins),
                         run_mega(u, v, boundary, 16, **pins)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_pinned_k2_bf16_is_jax_bit_for_bit():
    """bf16 storage under a row-tile pin: JAX's bf16 megakernel bit for
    bit (both round to bfloat16 once a time block)."""
    u, v = random_uv(np.random.RandomState(8), (40, 56))
    for got, want in zip(run_port(u, v, "naive", 16, block_rows=24,
                                  dtype="bfloat16"),
                         run_mega(u, v, "naive", 16, block_rows=24,
                                  dtype="bfloat16")):
        np.testing.assert_array_equal(got, want)


def test_pinned_k6_matches_jax():
    """K6 under a row-tile pin against JAX's packed megakernel, within
    1e-6 (the packed tree of both)."""
    u, v = random_uv(np.random.RandomState(9), (40, 56))
    kw = dict(pack="on", block_rows=8)
    for got, want in zip(run_port(u, v, "zero", 16, **kw),
                         run_mega(u, v, "zero", 16, **kw)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape,boundary,pins", [
    ((40, 264), "naive", {"block_rows": 12}),
    ((40, 264), "naive", {"block_rows": 12, "block_cols": 128}),
    ((40, 264), "naive", {"block_rows": 16, "block_cols": 100}),
    ((40, 264), "naive", {"block_rows": 16, "block_cols": 128,
                          "naive_fix": "store"}),
    ((40, 56), "zero", {"pack": "on", "block_rows": 20}),
    ((40, 56), "zero", {"pack": "on", "block_cols": 128}),
])
def test_refusals_are_jax(shape, boundary, pins):
    """The values JAX's megakernels refuse raise JAX's class and message
    (a row tile not a multiple of 8, a column tile not a multiple of 128
    where both are pinned, a column tile under ``naive_fix='store'``, the
    packed layout's row tile and column tile; the port's refusal of the
    latter names the values after JAX's text)."""
    u, v = random_uv(np.random.RandomState(0), shape)
    with pytest.raises(JaxUnsupported) as want:
        run_mega(u, v, boundary, 1, **pins)
    with pytest.raises(UnsupportedConfigError) as got:
        run_port(u, v, boundary, 1, **pins)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value).startswith(str(want.value))


def test_a_column_tile_of_the_width_runs_unpinned():
    """A column tile at least the domain's width is JAX's full width
    (``backends/pallas.py:396-397``): both run it, the port on its default
    column tile, and agree within 1e-6."""
    u, v = random_uv(np.random.RandomState(10), (40, 56))
    kw = {"block_rows": 16, "block_cols": 128}
    for got, want in zip(run_port(u, v, "naive", 8, **kw),
                         run_mega(u, v, "naive", 8, **kw)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
