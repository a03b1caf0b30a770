"""The CPU twin of the interior dispatch of K1, K2 and K3
(grayscott_tpu_torch/ops/stencil.py: ``tiled_step``, ``fixed_laplacian``,
``interior_tiles``): a tile whose window lies inside the domain adds a fixed
term list, the others take the plain step; and of K7's at a shard's origin
(``tiled_step_at``, ``interior_tiles_at``), decided in global coordinates.
Tolerance: none. The twin must equal ``stencil.step`` (``stencil.step_at``)
bit for bit, NaN and Inf included, and through it the numpy oracle."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from grayscott_tpu import oracle
from grayscott_tpu.params import Parameters as JaxParameters
from grayscott_tpu_torch.ops import resident, sharded_mega, stencil, windowed
from grayscott_tpu_torch.parallel import halo
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


#: the sharded suite's meshes on the default shape and its ragged one
#: (1080x1920 and 1001x1920, a quarter of the size: 1001 rows in 4 shards
#: of 256 scale to 251 rows in 4 shards of 64, the last one past the
#: domain)
SHARD_CASES = [((270, 480), mesh) for mesh in ((1, 1), (2, 1), (4, 1), (2, 2))]
SHARD_CASES += [((251, 480), mesh) for mesh in ((4, 1), (2, 2))]


def shard_blocks(u: torch.Tensor, mesh_shape):
    """Each shard's padded block of the zero-framed domain ``u``, with its
    global origin and its interior's origin (the tiles' anchor)."""
    mesh = halo.Mesh(*mesh_shape, torch.device("cpu"))
    r_loc, c_loc = halo.shard_extents(u.shape, mesh)
    h, ch = halo.HALO, mesh.chalo
    frame = torch.zeros((mesh.n_rows * r_loc + 2 * h,
                         mesh.n_cols * c_loc + 2 * ch))
    frame[h:h + u.shape[0], ch:ch + u.shape[1]] = u
    for i in range(mesh.n_rows):
        for j in range(mesh.n_cols):
            row0, col0 = i * r_loc, j * c_loc
            yield (frame[row0:row0 + r_loc + 2 * h,
                         col0:col0 + c_loc + 2 * ch],
                   (row0 - h, col0 - ch), (row0, col0))


@pytest.mark.parametrize("tile", sorted(sharded_mega.TILES))
@pytest.mark.parametrize("boundary", ["naive", "zero"])
@pytest.mark.parametrize("stencil_name", sorted(STENCILS))
def test_tiled_step_at_bitwise_equals_step_at(stencil_name, boundary, tile):
    """K7's decision at each shard's origin, for both of its tile
    geometries: every shard's padded block, stepped tile by tile at its
    global origin, equals ``step_at`` bit for bit, with NaN and +-Inf in
    interior tiles, at shard seams and on the domain's edge."""
    consts = kernel_constants(Parameters.with_stencil(stencil_name))
    checked = 0
    for shape, mesh_shape in SHARD_CASES:
        u, v = random_state(shape, seed=3)
        for x, (r, c), value in ((u, (100, 150), np.nan),
                                 (v, (135, 240), np.inf),
                                 (u, (136, 239), -np.inf),
                                 (v, (64, 300), np.nan),
                                 (u, (0, 7), np.inf),
                                 (v, (shape[0] - 1, 479), -np.inf)):
            x[r, c] = value
        for (bu, origin, anchor), (bv, _, _) in zip(
                shard_blocks(u, mesh_shape), shard_blocks(v, mesh_shape)):
            want = stencil.step_at(bu, bv, consts, boundary, origin, shape)
            got = stencil.tiled_step_at(bu, bv, consts, boundary, origin,
                                        shape, (tile, tile), halo.HALO,
                                        anchor)
            for g, w in zip(got, want):
                assert torch.equal(bits(g), bits(w)), (shape, mesh_shape,
                                                       anchor)
            checked += stencil.interior_tiles_at(
                anchor, halo.shard_extents(shape, halo.Mesh(
                    *mesh_shape, None)), shape, (tile, tile), halo.HALO)
    assert checked > 0  # the fixed list ran


def test_tiled_step_at_whole_domain_is_tiled_step():
    """At origin (0, 0) on the whole domain, with tiles anchored there, the
    shard form is K1's and K2's decision (``tiled_step``)."""
    consts = kernel_constants(Parameters())
    u, v = random_state((161, 259), seed=4)
    for boundary in ("naive", "zero"):
        got = stencil.tiled_step_at(u, v, consts, boundary, (0, 0),
                                    (161, 259), (64, 64), 8)
        want = stencil.tiled_step(u, v, consts, boundary, (64, 64), 8)
        for g, w in zip(got, want):
            assert torch.equal(bits(g), bits(w))


@pytest.mark.parametrize("shape,mesh_shape,tile,want", [
    ((1080, 1920), (1, 1), 64, [420]),               # of 510: K2's count
    ((1080, 1920), (2, 1), 64, [224, 224]),          # of 270 a shard
    ((1080, 1920), (4, 1), 64, [112, 140, 140, 112]),  # of 150
    ((1080, 1920), (2, 2), 64, [112] * 4),           # of 135
    ((1080, 1920), (2, 2), 32, [464] * 4),           # of 510
    ((1080, 1920), (4, 1), 32, [464, 522, 522, 464]),  # of 540
    ((4096, 4096), (1, 1), 64, [3844]),              # of 4096
    ((4096, 4096), (2, 2), 64, [961] * 4),           # of 1024
    ((4096, 4096), (4, 1), 64, [930, 992, 992, 930]),  # of 1024
    ((1001, 1920), (4, 1), 64, [84, 112, 112, 84]),  # of 120
    ((1001, 1920), (2, 2), 32, [435] * 4),           # of 480
    ((1000, 1917), (2, 2), 64, [98] * 4),            # of 120
])
def test_interior_tiles_per_shard(shape, mesh_shape, tile, want):
    """K7's interior tiles per shard (a seam is no domain edge), by count
    and by a walk of the windows; on one shard, K2's count."""
    mesh = halo.Mesh(*mesh_shape, None)
    r_loc, c_loc = halo.shard_extents(shape, mesh)
    got, walked = [], []
    for i in range(mesh.n_rows):
        for j in range(mesh.n_cols):
            row0, col0 = i * r_loc, j * c_loc
            got.append(stencil.interior_tiles_at(
                (row0, col0), (r_loc, c_loc), shape, (tile, tile), 8))
            walked.append(sum(
                row0 + a * tile - 8 >= 0 and col0 + b * tile - 8 >= 0
                and row0 + (a + 1) * tile + 8 <= shape[0]
                and col0 + (b + 1) * tile + 8 <= shape[1]
                for a in range(-(-r_loc // tile))
                for b in range(-(-c_loc // tile))))
    assert got == walked == want
    if mesh_shape == (1, 1):
        assert got[0] == stencil.interior_tiles(shape, (tile, tile), 8)
