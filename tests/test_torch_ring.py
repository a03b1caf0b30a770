"""The megakernels' last JAX knobs on the port's ``cuda`` backend:
``mega_depth`` (the window ring of K2 and K6: its geometry against JAX's
clamp rule, its range, and that it moves no engine choice) and
``mega_specialize`` (inert: None, True and False against JAX's
``PallasSimulation(engine='mega', mega_specialize=...)`` in interpret mode,
atol 2e-6 as tests/test_torch_megakernel.py holds K2, and bitwise against
the port's default), with JAX's refusals. The kernels themselves are held
against their plain versions on the card by tests/test_torch_gpu.py and
``chip_smoke.py``; tests/test_torch_ring_jax.py holds each depth against
JAX."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from grayscott_tpu.backends.pallas import PallasSimulation
from grayscott_tpu.errors import UnsupportedConfigError as JaxUnsupported
from grayscott_tpu.ops import megakernel as jax_mk
from grayscott_tpu.params import Parameters as JaxParameters
from grayscott_tpu_torch.backends.cuda import CudaSimulation
from grayscott_tpu_torch.errors import UnsupportedConfigError
from grayscott_tpu_torch.ops import megakernel
from grayscott_tpu_torch.params import (Parameters, kernel_constants,
                                        packed_constants)
from grayscott_tpu_torch.species import Species

from conftest import random_uv

SHAPES = [(24, 32), (64, 64), (130, 200), (256, 256), (1080, 1920),
          (4096, 4096)]


def tiles(shape, tile):
    return -(-shape[0] // tile) * -(-shape[1] // tile)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("depth", megakernel.DEPTHS)
def test_geometry_follows_jax_clamp(shape, depth):
    """The tile follows the pinned depth (64x64 while the ring fits the
    227 KB a block may opt into: depths 2 and 3), then JAX's clamp to 2
    when the windows number fewer than 2 * depth
    (grayscott_tpu/ops/megakernel.py:1022-1028: ``seam_cap < 2 * depth``,
    the tile kept, as JAX keeps its row tile); sharded, always 2."""
    g = megakernel.ring_geometry(shape, depth)
    assert g.tile == (64 if depth <= 3 else 32)
    assert g.depth == (2 if tiles(shape, g.tile) < 2 * depth else depth)
    assert g.buffers == (2 if g.depth == 2 else g.depth + 1)
    assert g.bytes == g.buffers * 2 * 4 * (g.tile + 16) ** 2
    assert g.bytes <= megakernel.SMEM_OPTIN
    assert g.buffers <= megakernel.ring_max_buffers(g.tile)
    # blocks an SM: as many as 228 KB hold at 1 KB reserved a block
    assert g.blocks_per_sm == 233_472 // (g.bytes + 1_024)
    assert g.ring == ((g.tile, g.buffers) != (64, 2))
    sharded = megakernel.ring_geometry(shape, depth, sharded=True)
    assert sharded.depth == 2 and sharded.tile == g.tile


@pytest.mark.parametrize("depth,tile,buffers,nbytes,per_sm", [
    (None, 64, 2, 102_400, 2),  # the double buffer, today's K2
    (2, 64, 2, 102_400, 2),
    (3, 64, 4, 204_800, 1),
    (4, 32, 5, 92_160, 2),
    (5, 32, 6, 110_592, 2),
    (6, 32, 7, 129_024, 1),
    (7, 32, 8, 147_456, 1),
    (8, 32, 9, 165_888, 1),
])
def test_geometry_at_the_default_run(depth, tile, buffers, nbytes, per_sm):
    """1080x1920 (510 tiles of 64x64, 2040 of 32x32): no clamp."""
    g = megakernel.ring_geometry((1080, 1920), depth)
    assert (g.tile, g.depth, g.buffers, g.bytes, g.blocks_per_sm) == (
        tile, depth or 2, buffers, nbytes, per_sm)


@pytest.mark.parametrize("depth", [1, 9, 0, -2, 2.5, "4", True])
def test_depth_out_of_range_raises_value_error(depth):
    """JAX's range check (backends/pallas.py:224-225): ValueError, not
    UnsupportedConfigError; the kernel wrappers check it too."""
    with pytest.raises(ValueError, match=r"\[2, 8\]") as err:
        CudaSimulation(Parameters(), device="cpu", mega_depth=depth)
    assert not isinstance(err.value, UnsupportedConfigError)
    if isinstance(depth, int) and not isinstance(depth, bool):
        with pytest.raises(ValueError):
            PallasSimulation(JaxParameters(), interpret=True,
                             mega_depth=depth)
    pu, pv = torch.zeros(2, 8, 8), torch.zeros(2, 8, 8)
    with pytest.raises(ValueError):
        megakernel.megastep(pu, pv, 1, 8, kernel_constants(Parameters()),
                            "naive", depth=depth)


@pytest.mark.parametrize("depth", [None, *megakernel.DEPTHS])
def test_depths_run(depth):
    sim = CudaSimulation(Parameters(), device="cpu", engine="mega",
                         mega_depth=depth)
    assert sim.mega_depth == depth


def test_specialize_with_store_is_refused_as_in_jax():
    """JAX's refusal (backends/pallas.py:227-231), with its message."""
    with pytest.raises(UnsupportedConfigError,
                       match="mega_specialize and naive_fix='store'"):
        CudaSimulation(Parameters(), device="cpu", mega_specialize=True,
                       naive_fix="store")
    with pytest.raises(JaxUnsupported,
                       match="mega_specialize and naive_fix='store'"):
        PallasSimulation(JaxParameters(), interpret=True,
                         mega_specialize=True, naive_fix="store")
    for spec in (None, False):  # nothing pinned, nothing refused
        CudaSimulation(Parameters(), device="cpu", mega_specialize=spec,
                       naive_fix="store")


@pytest.mark.parametrize("boundary", ["naive", "zero"])
@pytest.mark.parametrize("spec", [None, True, False])
def test_specialize_matches_jax(rng, boundary, spec):
    """Every value runs the port's unchanged kernels: the frames of the
    default run, bit for bit, and within 2e-6 of JAX's megakernel with the
    same value after 16 steps."""
    shape = (24, 32)
    u, v = random_uv(rng, shape)
    sim = PallasSimulation(JaxParameters(), boundary=boundary,
                           engine="mega", interpret=True, block_rows=8,
                           mega_specialize=spec)
    species = sim.make_species(shape)
    species.storage = sim.build_storage(u, v)
    sim.perform_steps(species, 16)
    ju, jv = species.uv_host()
    got = []
    for value in (spec, None):
        port = CudaSimulation(Parameters(), boundary, device="cpu",
                              engine="mega", mega_specialize=value)
        assert port.mega_specialize is value
        s = Species(shape, port.build_storage(u, v), port)
        port.perform_steps(s, 16)
        got.append(s.uv_host())
    np.testing.assert_allclose(got[0][0], ju, rtol=0, atol=2e-6)
    np.testing.assert_allclose(got[0][1], jv, rtol=0, atol=2e-6)
    for a, b in zip(*got):
        np.testing.assert_array_equal(a, b)


def test_specialize_declined_on_the_packed_layout(rng):
    """JAX declines it silently there (backends/pallas.py:370-382); so
    does the port, whose value changes nothing anyway."""
    u, v = random_uv(rng, (24, 32))
    sim = CudaSimulation(Parameters(), "zero", device="cpu", pack="on",
                         engine="mega", mega_specialize=True)
    assert sim.build_storage(u, v)[0] == "megapack"


@pytest.mark.parametrize("boundary", ["naive", "zero"])
@pytest.mark.parametrize("shape", [(24, 32), (1080, 1920), (4096, 4096)])
@pytest.mark.parametrize("depth", [3, 8])
def test_depth_moves_no_engine_choice(shape, boundary, depth):
    """A depth pin acts only where K2 or K6 runs: ``auto`` picks what it
    picks without the pin (JAX's ``_use_mega`` judges the pin only on its
    own choice of mega), and the windowed and resident pins stay."""
    for pins in ({}, {"engine": "windowed"}, {"resident": "on"},
                 {"engine": "mega"}):
        base = CudaSimulation(Parameters(), boundary, device="cpu", **pins)
        pinned = CudaSimulation(Parameters(), boundary, device="cpu",
                                mega_depth=depth, **pins)
        assert pinned.layout_for(shape) == base.layout_for(shape)


@pytest.mark.parametrize("depth", [2, 4, 8])
def test_packed_depth_runs_bitwise_to_depth_two(rng, depth):
    """K6 through the backend under a depth pin (its plain version here):
    the pin is declined, as JAX's packed megakernel declines it, and the
    frames are depth 2's."""
    u, v = random_uv(rng, (70, 96))
    out = []
    for d in (depth, 2):
        sim = CudaSimulation(Parameters(), "zero", device="cpu", pack="on",
                             engine="mega", mega_depth=d)
        s = Species(u.shape, sim.build_storage(u, v), sim)
        assert s.storage[0] == "megapack"
        sim.perform_steps(s, 27)
        out.append(s.uv_host())
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)


def test_jax_packed_megastep_takes_no_depth():
    """JAX's packed megakernel runs the double buffer whatever the pin
    (``packed_megastep_impl`` takes no depth), and so does the port's K6;
    both packages' unpacked megakernels take one."""
    import inspect

    for packed_fn, fn in ((jax_mk.packed_megastep_impl, jax_mk.megastep_impl),
                          (megakernel.packed_megastep, megakernel.megastep)):
        assert "depth" not in inspect.signature(packed_fn).parameters
        assert "depth" in inspect.signature(fn).parameters


def test_cpu_ring_calls_do_not_count_as_launches(rng):
    before = (megakernel.ring_launches, megakernel.packed_launches)
    u, v = random_uv(rng, (70, 96))
    for pack, boundary in (("off", "naive"), ("on", "zero")):
        sim = CudaSimulation(Parameters(), boundary, device="cpu",
                             engine="mega", pack=pack, mega_depth=5)
        sim.run_steps(sim.build_storage(u, v), u.shape, 19)
    assert (megakernel.ring_launches, megakernel.packed_launches) == before
