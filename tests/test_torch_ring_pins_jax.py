"""The window ring at a pinned tile (``mega_depth`` 3..8 with
``block_rows``/``block_cols`` under ``engine='mega'``) on the port against
JAX's ``PallasSimulation(engine='mega', mega_depth=D, block_rows=...,
block_cols=...)`` in Pallas interpret mode after 16 steps, and bit for bit
against the port's own depth-2 run on the same tiles.

Tolerance against JAX: atol 2e-6, as tests/test_torch_ring_jax.py holds
the ring at the compiled tiles (JAX's zero path folds the update's linear
terms, a few ulp off the oracle's rounding, which the port's plain version
is bit for bit); bf16 storage within one bf16 ulp (both round once a time
block, and a float32 value a few ulp from JAX's may round to the next
bfloat16: 3 cells of U and 1 of V here).
Also JAX's clamp to depth 2 on few windows, counted on the pinned tiles
(``grayscott_tpu/ops/megakernel.py:544-545``, ``:755-763``), and the
refusal of a ring past the shared memory a block may use, with its
bytes."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from grayscott_tpu.backends.pallas import PallasSimulation
from grayscott_tpu.params import Parameters as JaxParameters
from grayscott_tpu_torch.backends.cuda import CudaSimulation
from grayscott_tpu_torch.errors import UnsupportedConfigError
from grayscott_tpu_torch.ops import geometry, megakernel
from grayscott_tpu_torch.params import Parameters, kernel_constants
from grayscott_tpu_torch.species import Species

from conftest import random_uv

STEPS = 16


def run_jax(u, v, boundary, depth, dtype="float32", **pins):
    sim = PallasSimulation(JaxParameters(), boundary=boundary,
                           engine="mega", interpret=True, mega_depth=depth,
                           tuned_lookup=False, dtype=dtype, **pins)
    species = sim.make_species(u.shape)
    species.storage = sim.build_storage(u, v)
    assert species.storage[0] == "mega"
    sim.perform_steps(species, STEPS)
    return species.uv_host()


def run_port(u, v, boundary, depth, dtype="float32", **pins):
    sim = CudaSimulation(Parameters(), boundary, device="cpu", engine="mega",
                         mega_depth=depth, tuned_lookup=False, dtype=dtype,
                         **pins)
    species = Species(u.shape, sim.build_storage(u, v), sim)
    tiles = species.storage[3]
    sim.perform_steps(species, STEPS)
    return species.uv_host(), tiles


def jax_clamp(shape, tiles, depth) -> int:
    """JAX's depth on a single chip (``megastep_impl``, ``:755-763``), its
    row and column blocks counted as the port's tiles."""
    rows_t, cols_t = (-(-n // t) for n, t in zip(shape, tiles))
    windows = rows_t if cols_t == 1 else (rows_t - 1) * cols_t
    return depth if windows >= 2 * depth else 2


@pytest.mark.parametrize("shape,pins,depth,boundary,ring_depth", [
    ((136, 264), {"block_rows": 32, "block_cols": 128}, 3, "naive", 3),
    ((136, 128), {"block_rows": 16}, 4, "zero", 4),
    ((136, 128), {"block_rows": 16}, 8, "naive", 8),
    # the clamp on few windows: 2 tile rows by 3 tile columns
    ((72, 264), {"block_rows": 64, "block_cols": 128}, 3, "naive", 2),
    ((72, 264), {"block_rows": 64, "block_cols": 128}, 8, "zero", 2),
])
def test_pinned_ring_matches_jax(rng, shape, pins, depth, boundary,
                                 ring_depth):
    """The ring's depth on the pinned tiles after JAX's clamp (32x128,
    16x64 and 64x128 tiles); within 2e-6 of JAX's megakernel on the same
    pins and depth, and the port's depth-2 run bit for bit."""
    u, v = random_uv(rng, shape)
    (pu, pv), tiles = run_port(u, v, boundary, depth, **pins)
    assert not tiles.compiled
    ring = megakernel.ring_geometry(shape, depth, tiles=tiles)
    assert ring.depth == ring_depth == jax_clamp(shape, (tiles.tr, tiles.tc),
                                                  depth)
    assert ring.ring == (ring_depth > 2)
    ju, jv = run_jax(u, v, boundary, depth, **pins)
    np.testing.assert_allclose(pu, ju, rtol=0, atol=2e-6)
    np.testing.assert_allclose(pv, jv, rtol=0, atol=2e-6)
    for got, want in zip((pu, pv), run_port(u, v, boundary, 2, **pins)[0]):
        np.testing.assert_array_equal(got, want)


def test_pinned_ring_bf16_is_jax_to_one_ulp(rng):
    """bf16 storage on a ring of 16x64 tiles at depth 4: JAX's bf16
    megakernel at its depth 4 within one bf16 ulp, and the port's depth-2
    run bit for bit."""
    from test_torch_naive_fold import bf16_ulp

    u, v = random_uv(rng, (136, 128))
    got = run_port(u, v, "naive", 4, dtype="bfloat16", block_rows=16)[0]
    want = run_jax(u, v, "naive", 4, dtype="bfloat16", block_rows=16)
    for g, w in zip(got, want):
        assert (np.abs(g - w) <= bf16_ulp(w)).all()
    for g, w in zip(got, run_port(u, v, "naive", 2, dtype="bfloat16",
                                  block_rows=16)[0]):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("shape,tiles,depth", [
    (shape, tiles, depth)
    for shape in ((1080, 1920), (136, 264), (72, 264), (1000, 1917), (40, 64))
    for tiles in ((32, 128), (16, 64), (64, 128), (8, 256), (128, 32))
    for depth in (2, 3, 4, 8)])
def test_clamp_and_bytes(shape, tiles, depth):
    """The ring's depth is JAX's clamp on the pinned tiles' windows; its
    bytes are D + 1 window pairs (the double buffer's two at depth 2), and
    a ring past the 232,448 B a block may opt into raises naming them."""
    g = geometry.Geometry(*tiles, geometry.HALO)
    d = jax_clamp(shape, tiles, depth)
    nbytes = megakernel.ring_buffers(d) * g.bytes // 2
    if nbytes > geometry.SMEM_OPTIN:
        with pytest.raises(UnsupportedConfigError, match=f"{nbytes} B"):
            megakernel.ring_geometry(shape, depth, tiles=g)
        return
    ring = megakernel.ring_geometry(shape, depth, tiles=g)
    assert (ring.depth, ring.bytes, ring.tiles) == (d, nbytes, g)
    assert ring.ring == (d > 2)
    assert megakernel.ring_geometry(shape, depth, sharded=True,
                                    tiles=g).depth == 2


@pytest.mark.parametrize("pins,depth,nbytes", [
    ({"block_rows": 64, "block_cols": 128}, 3, 368640),
    ({"block_rows": 32, "block_cols": 128}, 4, 276480),
    ({"block_rows": 64, "block_cols": 128, "naive_fold": True}, 3, 368640),
    ({"block_rows": 32, "block_cols": 128, "dtype": "bfloat16"}, 6, 387072),
])
def test_ring_past_shared_memory_is_refused(rng, pins, depth, nbytes):
    """Refused when the storage is built, naming the ring's bytes; the
    double buffer on the same tiles runs."""
    u, v = random_uv(rng, (136, 264))
    with pytest.raises(UnsupportedConfigError, match=f"{nbytes} B"):
        run_port(u, v, "naive", depth, **pins)
    run_port(u, v, "naive", 2, **pins)


def test_pinned_ring_on_the_cpu_launches_nothing(rng):
    """The wrapper runs the plain version on CPU tensors (the double
    buffer's), and counts no launch."""
    u, v = (torch.from_numpy(x) for x in random_uv(rng, (136, 128)))
    g = geometry.mega_resolve((136, 128), 16, None)
    before = (megakernel.pinned_ring_launches, megakernel.pinned_launches)
    pu, pv = megakernel.pair_state(u), megakernel.pair_state(v)
    consts = kernel_constants(Parameters())
    megakernel.megastep(pu, pv, 2, 8, consts, "naive", depth=4, geometry=g)
    want = megakernel.megastep_reference(u, v, 16, consts, "naive")
    assert torch.equal(pu[0], want[0]) and torch.equal(pv[0], want[1])
    assert (megakernel.pinned_ring_launches,
            megakernel.pinned_launches) == before
