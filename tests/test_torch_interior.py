"""The CPU twin of the interior dispatch of K1 and K3
(grayscott_tpu_torch/ops/stencil.py: ``tiled_step``, ``fixed_laplacian``,
``interior_tiles``): a tile whose window lies inside the domain adds a fixed
term list, the others take the plain step. Tolerance: none. The twin must
equal ``stencil.step`` bit for bit, NaN and Inf included, and through it
the numpy oracle."""

import numpy as np
import pytest
import torch

from grayscott_tpu import oracle
from grayscott_tpu.params import Parameters as JaxParameters
from grayscott_tpu_torch.ops import resident, stencil, windowed
from grayscott_tpu_torch.params import STENCILS, Parameters, kernel_constants

#: the kernels' tiles and windows: K1 (64^2 tiles, halo K = 8) and K3
#: (32^2 tiles, a one-cell ring)
GEOMETRIES = {"K1": (windowed.TILE, windowed.K),
              "K3": (resident.TILE, resident.HALO)}

#: no interior tile (40x40), smaller than a tile (20x30, 1x1), a mix
#: (200x300, 161x259); and the ragged domains of the card's checks
#: (1000x1917, 1001x1920), on the time step 1.0 only, to keep the CPU time
#: down
SHAPES = [(40, 40), (20, 30), (1, 1), (200, 300), (161, 259)]
LARGE_SHAPES = [(1000, 1917), (1001, 1920)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on one host, and
    these tensors are large enough that every worker would otherwise spread
    over every core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32)


def random_state(shape, seed=0):
    rng = np.random.RandomState(seed)
    return tuple(torch.from_numpy(rng.uniform(0.0, 1.0, shape)
                                  .astype(np.float32)) for _ in range(2))


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("dt", [1.0, 0.5])
@pytest.mark.parametrize("boundary", ["naive", "zero"])
@pytest.mark.parametrize("stencil_name", sorted(STENCILS))
def test_tiled_step_bitwise_equals_step(stencil_name, boundary, dt,
                                        geometry):
    consts = kernel_constants(Parameters.with_stencil(stencil_name,
                                                      time_step=dt))
    tile, halo = GEOMETRIES[geometry]
    for shape in SHAPES + (LARGE_SHAPES if dt == 1.0 else []):
        u, v = random_state(shape)
        want = stencil.step(u, v, consts, boundary)
        got = stencil.tiled_step(u, v, consts, boundary, tile, halo)
        for g, w in zip(got, want):
            assert torch.equal(bits(g), bits(w)), shape


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("boundary", ["naive", "zero"])
@pytest.mark.parametrize("stencil_name", sorted(STENCILS))
def test_tiled_step_keeps_nan_and_inf(stencil_name, boundary, geometry):
    """NaN and +-Inf in interior and edge tiles, and on the domain edge,
    spread over 3 steps exactly as through the plain step: the naive
    list's centre term ``w * (x - x)`` is NaN at an infinite cell even
    when the centre weight is 0."""
    consts = kernel_constants(Parameters.with_stencil(stencil_name))
    tile, halo = GEOMETRIES[geometry]
    u, v = random_state((200, 300), seed=1)
    for x, (r, c), value in ((u, (100, 150), np.nan), (v, (90, 140), np.inf),
                             (u, (120, 7), -np.inf), (v, (0, 5), np.nan),
                             (u, (70, 200), np.inf), (v, (199, 299), -np.inf)):
        x[r, c] = value
    tu, tv, pu, pv = u, v, u, v
    for _ in range(3):
        tu, tv = stencil.tiled_step(tu, tv, consts, boundary, tile, halo)
        pu, pv = stencil.step(pu, pv, consts, boundary)
        assert torch.equal(bits(tu), bits(pu))
        assert torch.equal(bits(tv), bits(pv))
    assert not torch.isfinite(tu).all()


@pytest.mark.parametrize("boundary", ["naive", "zero"])
@pytest.mark.parametrize("stencil_name", sorted(STENCILS))
def test_tiled_step_equals_oracle(stencil_name, boundary):
    """Through the plain step, the twin meets the numpy oracle."""
    u, v = random_state((160, 224), seed=2)
    tile, halo = GEOMETRIES["K3"]
    consts = kernel_constants(Parameters.with_stencil(stencil_name))
    ou, ov = oracle.step(u.numpy(), v.numpy(),
                         JaxParameters.with_stencil(stencil_name), boundary)
    tu, tv = stencil.tiled_step(u, v, consts, boundary, tile, halo)
    np.testing.assert_array_equal(tu.numpy(), ou)
    np.testing.assert_array_equal(tv.numpy(), ov)


@pytest.mark.parametrize("shape,tile,halo,want", [
    ((1080, 1920), (32, 32), 1, 1856),   # of 2040
    ((1080, 1920), (64, 64), 8, 420),    # of 510
    ((4096, 4096), (64, 64), 8, 3844),   # of 4096
    ((4096, 4096), (32, 32), 1, 15876),  # of 16384
    ((1000, 1917), (64, 64), 8, 392),    # 14 x 28 of 16 x 30
    ((1001, 1920), (32, 32), 1, 1740),   # 30 x 58 of 32 x 60
    ((40, 40), (32, 32), 1, 0),
    ((40, 40), (64, 64), 8, 0),
    ((20, 30), (32, 32), 1, 0),
    ((66, 66), (32, 32), 1, 1),          # one tile: rows 32..63
    ((1, 1), (64, 64), 8, 0),
])
def test_interior_tiles_count(shape, tile, halo, want):
    """The count, the mask, and a tile-by-tile walk of the windows agree."""
    assert stencil.interior_tiles(shape, tile, halo) == want
    mask = stencil.interior_mask(shape, tile, halo)
    walk = 0
    for i in range(-(-shape[0] // tile[0])):
        for j in range(-(-shape[1] // tile[1])):
            r0, c0 = i * tile[0] - halo, j * tile[1] - halo
            inside = (r0 >= 0 and c0 >= 0
                      and r0 + tile[0] + 2 * halo <= shape[0]
                      and c0 + tile[1] + 2 * halo <= shape[1])
            walk += inside
            cells = mask[i * tile[0]:(i + 1) * tile[0],
                         j * tile[1]:(j + 1) * tile[1]]
            assert bool(cells.all()) == inside and bool(cells.any()) == inside
    assert walk == want
    # every cell an interior tile steps lies in rows [1, R-2], cols [1, C-2]
    assert not mask[0].any() and not mask[-1].any()
    assert not mask[:, 0].any() and not mask[:, -1].any()
