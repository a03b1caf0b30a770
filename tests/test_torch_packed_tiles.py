"""The CPU twin of K5's and K6's tile dispatch on the packed Hopper stepper
(grayscott_tpu_torch/ops/packed.py: ``packed_tiled_step``,
``packed_tiles``): each tile steps its window, an interior tile's cut from
the state with no domain test, an edge tile's from the zero-padded state
with its cells outside the domain written as 0.0; and the argument checks
of K5's and K6's ablation wrappers (``packed.packed_resident_ablation``,
``megakernel.packed_mega_ablation``), which run only on the card.

Tolerance: none against ``packed.packed_step`` (the twin must equal it bit
for bit, NaN and Inf included); atol 1e-6 against the JAX packed kernel in
interpret mode, for the reason tests/test_torch_packed.py gives."""

import numpy as np
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from grayscott_tpu.ops import pallas_stencil as ps
from grayscott_tpu.params import Parameters as JaxParameters
from grayscott_tpu_torch.ops import megakernel, packed, stencil
from grayscott_tpu_torch.params import Parameters, packed_constants

#: see the module docstring
ATOL = 1e-6

SEPARABLE = ["oono-puri", "pretty", "patra-karttunen"]

#: no interior tile at either tile size (40x40), ragged against both with
#: an odd width (70x97), interior tiles of both (200x264)
SHAPES = [(40, 40), (70, 97), (200, 264)]

#: the kernels' (tile, halo): K5 (32, 1), K6 (64, 8), K6's ablation part 3
#: (32, 8); and (64, 1)
GEOMETRIES = [(32, 1), (32, 8), (64, 1), (64, 8)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on one host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32)


def random_packed(shape, seed=0):
    rng = np.random.RandomState(seed)
    return packed.pack_state(*(torch.from_numpy(rng.uniform(0.0, 1.0, shape)
                                                .astype(np.float32))
                               for _ in range(2)))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("tile,halo", GEOMETRIES)
@pytest.mark.parametrize("dt", [1.0, 0.5])
@pytest.mark.parametrize("stencil_name", SEPARABLE)
def test_packed_tiled_step_bitwise_equals_packed_step(stencil_name, dt, tile,
                                                      halo, shape):
    pc = packed_constants(Parameters.with_stencil(stencil_name,
                                                  time_step=dt))
    x = random_packed(shape)
    got = packed.packed_tiled_step(x, pc, tile, halo)
    assert torch.equal(bits(got), bits(packed.packed_step(x, pc)))


@pytest.mark.parametrize("tile,halo", GEOMETRIES)
@pytest.mark.parametrize("stencil_name", SEPARABLE)
def test_packed_tiled_step_keeps_nan_and_inf(stencil_name, tile, halo):
    """NaN and +-Inf in interior and edge tiles and on the domain's edge
    spread over 3 steps exactly as through the plain packed step; the
    cells outside the domain stay 0.0, so no NaN leaks across U's last
    column into V's first."""
    pc = packed_constants(Parameters.with_stencil(stencil_name))
    x = random_packed((200, 264), seed=1)
    c = 264
    for (r, col), value in (((100, 150), np.nan), ((90, c + 140), np.inf),
                            ((120, 7), -np.inf), ((0, c + 5), np.nan),
                            ((70, c - 1), np.inf), ((199, 2 * c - 1),
                                                    -np.inf)):
        x[r, col] = value
    tx, px = x, x
    for _ in range(3):
        tx = packed.packed_tiled_step(tx, pc, tile, halo)
        px = packed.packed_step(px, pc)
        assert torch.equal(bits(tx), bits(px))
    assert not torch.isfinite(tx).all()


@pytest.mark.parametrize("shape,tile,halo,want", [
    ((1080, 1920), 32, 1, 1856),   # K5, of 2040
    ((1080, 1920), 64, 8, 420),    # K6, of 510
    ((1080, 1920), 32, 8, 1856),   # K6 part 3, of 2040
    ((4096, 4096), 32, 1, 15876),  # of 16384
    ((4096, 4096), 64, 8, 3844),   # of 4096
    ((1000, 1917), 64, 8, 392),    # of 480
    ((1001, 1920), 32, 1, 1740),   # of 1920
    ((200, 264), 64, 8, 6),        # of 20
    ((40, 40), 32, 1, 0),
    ((40, 40), 64, 8, 0),
])
def test_packed_interior_tiles_count(shape, tile, halo, want):
    """The tiles that K5 and K6 step with no domain test: the twin's walk
    agrees with ``stencil.interior_tiles`` and with the count that
    chip_smoke.py prints for the kernels' geometries."""
    tiles = packed.packed_tiles(shape, tile, halo)
    assert len(tiles) == -(-shape[0] // tile) * -(-shape[1] // tile)
    assert sum(inside for *_, inside in tiles) == want
    assert stencil.interior_tiles(shape, (tile, tile), halo) == want


@pytest.mark.parametrize("tile,halo", [(32, 1), (64, 8)])
def test_packed_tiled_step_matches_jax_packed_kernel(rng, tile, halo):
    """Through the plain packed step, the twin meets the JAX packed kernel
    (``ps.packed_multistep``, one step, interpret mode)."""
    r, c = 70, 97
    u = rng.uniform(0.0, 1.0, (r, c)).astype(np.float32)
    v = rng.uniform(0.0, 1.0, (r, c)).astype(np.float32)
    x = ps.pack_state(u, v, tr=8, halo=ps.HALO)
    out = ps.packed_multistep(jnp.asarray(x), None, steps=1, tr=8, r=r, c=c,
                              params=JaxParameters(), halo=ps.HALO,
                              interpret=True)
    want = ps.unpack_state(np.asarray(out), ps.HALO, r, c)
    got = packed.packed_tiled_step(
        packed.pack_state(torch.from_numpy(u), torch.from_numpy(v)),
        packed_constants(Parameters()), tile, halo)
    for g, w in zip(packed.unpack_state(got, c), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL)


def test_packed_tiled_step_needs_a_ring():
    with pytest.raises(ValueError):
        packed.packed_tiled_step(random_packed((8, 8)),
                                 packed_constants(Parameters()), 32, 0)


@pytest.mark.parametrize("kind", [
    "resident_part", "resident_cpu", "resident_steps_zero", "resident_grid",
    "resident_odd_width", "mega_part", "mega_cpu", "mega_n_blocks_zero",
    "mega_steps_over", "mega_not_pair",
])
def test_packed_ablation_wrappers_reject_bad_arguments(kind):
    """K5's and K6's ablation wrappers check their arguments as the main
    wrappers do, refuse a part they do not have, and run only on the card:
    on CPU tensors they raise, and no call counts a launch."""
    pc = packed_constants(Parameters())
    x, x_next = torch.rand(8, 12), torch.rand(8, 12)
    pair = torch.rand(2, 8, 12)
    before = (packed.launches, packed.resident_launches,
              megakernel.packed_launches)
    with pytest.raises(ValueError):
        if kind == "resident_part":
            packed.packed_resident_ablation(x, x_next, 1, pc,
                                            max(packed.RESIDENT_ABLATIONS)
                                            + 1)
        elif kind == "resident_cpu":
            packed.packed_resident_ablation(x, x_next, 1, pc, 0)
        elif kind == "resident_steps_zero":
            packed.packed_resident_ablation(x, x_next, 0, pc, 0)
        elif kind == "resident_grid":
            packed.packed_resident_ablation(x, x_next, 1, pc, 0, grid=-1)
        elif kind == "resident_odd_width":
            packed.packed_resident_ablation(torch.rand(8, 11),
                                            torch.rand(8, 11), 1, pc, 0)
        elif kind == "mega_part":
            megakernel.packed_mega_ablation(pair, 1, 1, pc, -1)
        elif kind == "mega_cpu":
            megakernel.packed_mega_ablation(pair, 1, 1, pc, 0)
        elif kind == "mega_n_blocks_zero":
            megakernel.packed_mega_ablation(pair, 0, 1, pc, 0)
        elif kind == "mega_steps_over":
            megakernel.packed_mega_ablation(pair, 1,
                                            megakernel.MEGA_STEPS + 1, pc, 0)
        else:
            megakernel.packed_mega_ablation(torch.rand(3, 8, 12), 1, 1, pc,
                                            0)
    assert (packed.launches, packed.resident_launches,
            megakernel.packed_launches) == before
