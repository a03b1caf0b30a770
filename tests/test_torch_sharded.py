"""The port's sharded path on the CPU: the shard layout and the halo
exchange (grayscott_tpu_torch/parallel/halo.py), the plain version of the
sharded megakernel K7 (ops/sharded_mega.py) against the numpy oracle and
against JAX's ``ShardedSimulation(engine="mega")`` in TPU interpret mode,
the ``sharded`` backend and ``simulate --backend sharded``. The CUDA kernel
itself is held against its plain version on the card by
tests/test_torch_gpu.py; the windowed engine is
tests/test_torch_sharded_windowed.py's."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from grayscott_tpu import oracle
from grayscott_tpu.backends.sharded import ShardedSimulation as JaxSharded
from grayscott_tpu_torch.backends.sharded import ShardedSimulation
from grayscott_tpu_torch.cli import shared, simulate
from grayscott_tpu_torch.errors import UnsupportedConfigError
from grayscott_tpu_torch.ops import geometry, sharded_mega, stencil
from grayscott_tpu_torch.parallel import halo
from grayscott_tpu_torch.params import Parameters, kernel_constants
from grayscott_tpu_torch.species import Species

from conftest import random_uv

#: (shape, shards, mesh columns): 1-D, 2-D, ragged, shards past the domain
LAYOUTS = [
    ((48, 16), 4, 1),    # the bottom shard half outside the domain
    ((17, 23), 4, 1),    # the last shards wholly outside it
    ((32, 300), 4, 2),
    ((70, 97), 6, 3),    # 2x3: ragged in both axes
    ((40, 280), 6, 2),   # 3x2: a middle row of shards
    ((24, 300), 2, 2),   # 1x2: a column mesh
    ((9, 5), 1, 1),
]


def padded_global(x: np.ndarray, mesh: halo.Mesh) -> np.ndarray:
    """The domain inside a frame of zeros: HALO rows and chalo columns
    around every shard's interior, cells past the domain 0.0."""
    r_loc, c_loc = halo.shard_extents(x.shape, mesh)
    h, ch = halo.HALO, mesh.chalo
    out = np.zeros((mesh.n_rows * r_loc + 2 * h, mesh.n_cols * c_loc + 2 * ch),
                   np.float32)
    out[h:h + x.shape[0], ch:ch + x.shape[1]] = x
    return out


def shard_block(g: np.ndarray, mesh: halo.Mesh, shape, i: int, j: int):
    """Shard (i, j)'s padded block of the zero-framed domain ``g``."""
    r_loc, c_loc = halo.shard_extents(shape, mesh)
    h, ch = halo.HALO, mesh.chalo
    return g[i * r_loc:i * r_loc + r_loc + 2 * h,
             j * c_loc:j * c_loc + c_loc + 2 * ch]


@pytest.mark.parametrize("shape,n,cols", LAYOUTS)
def test_layout_round_trip(rng, shape, n, cols):
    u, v = random_uv(rng, shape)
    mesh = halo.make_mesh(n, cols, "cpu")
    up, vp = halo.mega_shard_state(u, v, mesh)
    r_loc, c_loc = halo.shard_extents(shape, mesh)
    assert r_loc % halo.QUANTUM == 0 and c_loc % halo.QUANTUM == 0
    assert mesh.n_rows * r_loc >= shape[0] and mesh.n_cols * c_loc >= shape[1]
    assert tuple(up.shape) == halo.pair_shape(shape, mesh) == (
        mesh.n_rows, mesh.n_cols, 2, r_loc + 2 * halo.HALO,
        c_loc + 2 * mesh.chalo)
    assert mesh.chalo == (halo.COL_HALO if cols > 1 else 0)
    np.testing.assert_array_equal(halo.mega_unshard_result(up, shape), u)
    np.testing.assert_array_equal(halo.mega_unshard_result(vp, shape), v)
    # slot 0's interiors hold the domain, everything else starts 0.0
    g = padded_global(u, mesh)
    h, ch = halo.HALO, mesh.chalo
    for i in range(mesh.n_rows):
        for j in range(mesh.n_cols):
            want = np.zeros(up.shape[3:], np.float32)
            want[h:h + r_loc, ch:ch + c_loc] = shard_block(
                g, mesh, shape, i, j)[h:h + r_loc, ch:ch + c_loc]
            np.testing.assert_array_equal(up[i, j, 0].numpy(), want)
            assert not up[i, j, 1].any()


@pytest.mark.parametrize("shape,n,cols", LAYOUTS)
def test_exchange_fills_rows_columns_and_corners(rng, shape, n, cols):
    """After the exchange every shard's slot 0 is its block of the
    zero-framed domain: halo rows, halo columns and corners. Exact."""
    u, v = random_uv(rng, shape)
    mesh = halo.make_mesh(n, cols, "cpu")
    up, vp = halo.mega_shard_state(u, v, mesh)
    r_loc, c_loc = halo.shard_extents(shape, mesh)
    h, ch = halo.HALO, mesh.chalo
    interior = up[:, :, 0, h:h + r_loc, ch:ch + c_loc].clone()
    up[:, :, 0] = 7.0  # stale halos: the exchange must overwrite them
    up[:, :, 0, h:h + r_loc, ch:ch + c_loc] = interior
    halo.exchange_halos(up)
    g = padded_global(u, mesh)
    for i in range(mesh.n_rows):
        for j in range(mesh.n_cols):
            np.testing.assert_array_equal(
                up[i, j, 0].numpy(), shard_block(g, mesh, shape, i, j),
                err_msg=f"shard ({i}, {j})")


@pytest.mark.parametrize("shape,n,cols", LAYOUTS)
def test_pushes_fill_the_other_slot_like_the_exchange(rng, shape, n, cols):
    """The plain version of the kernel's 8 pushes into slot 1 leaves slot 1
    as the exchange leaves slot 0 (its outer halos stay 0.0)."""
    u, _ = random_uv(rng, shape)
    mesh = halo.make_mesh(n, cols, "cpu")
    up, _ = halo.mega_shard_state(u, u, mesh)
    up[:, :, 1] = up[:, :, 0]
    up[:, :, 0] = 0.0
    halo.push_halos(up, 1)
    assert not up[:, :, 0].any()
    g = padded_global(u, mesh)
    for i in range(mesh.n_rows):
        for j in range(mesh.n_cols):
            np.testing.assert_array_equal(up[i, j, 1].numpy(),
                                          shard_block(g, mesh, shape, i, j))


@pytest.mark.parametrize("boundary", ["naive", "zero"])
def test_step_at_whole_domain_is_step(rng, boundary):
    """The block step at origin (0, 0) over the whole domain is the plain
    step, bit for bit."""
    u, v = (torch.from_numpy(x) for x in random_uv(rng, (19, 23)))
    consts = kernel_constants(Parameters(time_step=0.5))
    for got, want in zip(stencil.step_at(u, v, consts, boundary, (0, 0),
                                         (19, 23)),
                         stencil.step(u, v, consts, boundary)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("boundary", ["naive", "zero"])
@pytest.mark.parametrize("origin", [(-3, -2), (5, 7), (12, 14)])
def test_step_at_keeps_cells_k_rings_in(rng, boundary, origin):
    """A block of the domain (reaching past its edges or not) stepped k
    times at its origin holds the whole domain's state k rings in from its
    sides; its cells outside the domain are 0.0."""
    shape, k = (24, 30), 4
    u, v = (torch.from_numpy(x) for x in random_uv(rng, shape))
    consts = kernel_constants(Parameters())
    want = stencil.run(u, v, k, consts, boundary)
    h, w = 16, 20
    frame = [torch.zeros((shape[0] + 40, shape[1] + 40)) for _ in range(2)]
    for f, x in zip(frame, (u, v)):
        f[20:20 + shape[0], 20:20 + shape[1]] = x
    bu, bv = (f[20 + origin[0]:20 + origin[0] + h,
                20 + origin[1]:20 + origin[1] + w] for f in frame)
    for _ in range(k):
        bu, bv = stencil.step_at(bu, bv, consts, boundary, origin, shape)
    for got, full in zip((bu, bv), want):
        ref = torch.zeros((shape[0] + 40, shape[1] + 40))
        ref[20:20 + shape[0], 20:20 + shape[1]] = full
        ref = ref[20 + origin[0]:20 + origin[0] + h,
                  20 + origin[1]:20 + origin[1] + w]
        assert torch.equal(got[k:h - k, k:w - k], ref[k:h - k, k:w - k])
        inside = stencil.domain_mask((h, w), origin, shape, "cpu")
        assert not got[~inside].any()


def run_port(u, v, params, boundary, steps, n_devices, mesh_cols=None):
    sim = ShardedSimulation(params, boundary, device="cpu", engine="mega",
                            n_devices=n_devices, mesh_cols=mesh_cols)
    species = Species(u.shape, sim.build_storage(u, v), sim)
    sim.perform_steps(species, steps)
    return species, species.uv_host()


@pytest.mark.parametrize("boundary", ["naive", "zero"])
@pytest.mark.parametrize("shape,n,cols,steps", [
    ((48, 16), 4, 1, 16),    # 4 row shards, the bottom one half outside
    ((32, 16), 2, 1, 27),    # odd block count: the slot copy, then a rest
    ((32, 300), 4, 2, 16),   # 2x2: corners
    ((32, 384), 4, 2, 27),
    ((24, 300), 2, 2, 16),   # 1x2
    ((24, 32), 1, 1, 19),    # 1x1: no pushes
    ((40, 280), 6, 2, 9),    # 3x2
    ((17, 23), 4, 1, 12),    # the last shard wholly past the domain
])
def test_plain_sharded_equals_oracle(rng, params, boundary, shape, n, cols,
                                     steps):
    """The plain sharded version, through the backend, is the oracle bit
    for bit (the JAX suite's geometries, tests/test_mega_sharded.py)."""
    u, v = random_uv(rng, shape)
    species, (gu, gv) = run_port(u, v, Parameters(), boundary, steps, n, cols)
    assert species.storage[0] == ("shmega" if cols == 1 else "shmega2d")
    ou, ov = oracle.run(u, v, params, steps, boundary)
    np.testing.assert_array_equal(gu, ou)
    np.testing.assert_array_equal(gv, ov)


def test_plain_sharded_fuzz(rng, params):
    """test_mega_sharded.py's fuzz: rows 17-80, 2-4 row shards, every
    remainder and parity of the step count. Bitwise."""
    for _ in range(3):
        r = int(rng.randint(17, 80))
        c = 16 * int(rng.randint(1, 3))
        n = int(rng.choice([2, 3, 4]))
        steps = int(rng.randint(1, 25))
        u, v = random_uv(rng, (r, c))
        _, (gu, gv) = run_port(u, v, Parameters(), "naive", steps, n, 1)
        ou, ov = oracle.run(u, v, params, steps, "naive")
        msg = f"r={r} c={c} n={n} steps={steps}"
        np.testing.assert_array_equal(gu, ou, err_msg=msg)
        np.testing.assert_array_equal(gv, ov, err_msg=msg)


@pytest.mark.parametrize("shape,n,cols,tiles", [
    ((48, 16), 4, None, {}),                  # 4x1 (auto picks 1-D)
    ((32, 384), 4, 2, {"block_cols": 128}),  # 2x2
])
def test_plain_sharded_matches_jax_sharded_mega(rng, params, shape, n, cols,
                                                tiles):
    """Against the JAX sharded megakernel in TPU interpret mode, as
    tests/test_mega_sharded.py runs it: naive, 16 steps. atol 1e-6, the
    tolerance of JAX's own tests against the oracle."""
    u, v = random_uv(rng, shape)
    sim = JaxSharded(params, boundary="naive", engine="mega", n_devices=n,
                     mesh_cols=cols, block_rows=8, **tiles)
    species = sim.make_species(shape)
    species.storage = sim.build_storage(u, v)
    assert species.storage[0] == ("mega" if cols is None else "mega2d")
    sim.perform_steps(species, 16)
    ju, jv = species.uv_host()
    port, (pu, pv) = run_port(u, v, Parameters(), "naive", 16, n, cols)
    assert port.storage[0] == ("shmega" if cols is None else "shmega2d")
    np.testing.assert_allclose(pu, ju, rtol=0, atol=1e-6)
    np.testing.assert_allclose(pv, jv, rtol=0, atol=1e-6)


@pytest.mark.parametrize("kwargs", [
    {"engine": "mega", "overlap": "on"},
    {"engine": "mega", "overlap": True},
    {"engine": "mega", "steps_per_call": 16},
    # the tile pins and K run since they were ported
    # (tests/test_torch_sharded_pins.py); what JAX refuses of them, and
    # what the shared memory or the exchange cannot hold, raises
    {"engine": "mega", "block_rows": 12},
    {"engine": "mega", "block_cols": 100},
    {"engine": "mega", "n_devices": 0},
    {"engine": "mega", "mesh_cols": 0},
    {"engine": "mega", "block_rows": 512, "block_cols": 512},
    {"engine": "windowed", "block_cols": 128},
    {"engine": "windowed", "steps_per_call": 32, "n_devices": 4,
     "mesh_cols": 1},
    {"engine": "auto", "block_cols": 128},
])
def test_unported_or_conflicting_knobs_raise(kwargs):
    with pytest.raises(UnsupportedConfigError):
        sim = ShardedSimulation(Parameters(), device="cpu", **kwargs)
        sim.make_species((64, 640))


@pytest.mark.parametrize("kwargs,tag", [
    ({"engine": "auto"}, "shwin"),      # no record: windowed, as in JAX
    ({"engine": "windowed"}, "shwin"),
    ({"engine": "mega", "tuned_lookup": True}, "shmega"),
    ({"engine": "mega", "dtype": "bfloat16"}, "shmega"),
    ({"engine": "windowed", "dtype": "bfloat16"}, "shwin"),
    ({"engine": "auto", "dtype": "bfloat16"}, "shwin"),
])
def test_knobs_that_now_run(monkeypatch, tmp_path, rng, params, kwargs,
                            tag):
    """The knobs that raised until the windowed engine, the sharded
    records and bf16 storage were ported run, bit for bit the oracle (an
    empty store); on bf16 storage the oracle rounded to bfloat16 once a
    block of 8 steps (tests/test_torch_bf16.py:oracle_bf16)."""
    from test_torch_bf16 import oracle_bf16

    monkeypatch.setenv("GRAYSCOTT_CACHE_DIR", str(tmp_path))
    u, v = random_uv(rng, (48, 16))
    sim = ShardedSimulation(Parameters(), device="cpu", n_devices=4,
                            **kwargs)
    species = Species(u.shape, sim.build_storage(u, v), sim)
    assert species.storage[0] == tag
    sim.perform_steps(species, 19)
    reference = oracle_bf16 if kwargs.get("dtype") == "bfloat16" \
        else oracle.run
    for got, want in zip(species.uv_host(),
                         reference(u, v, params, 19, "naive")):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kwargs", [{"engine": "resident"},
                                    {"engine": "mega", "overlap": "maybe"}])
def test_unknown_knob_values_raise(kwargs):
    with pytest.raises(ValueError):
        ShardedSimulation(Parameters(), device="cpu", **kwargs)


def test_accepted_knobs_and_mesh_choice():
    sim = ShardedSimulation(Parameters(), device="cpu", engine="mega",
                            overlap="off", steps_per_call=8, n_devices=4)
    assert sim.mesh is None  # chosen at the first build, then kept
    sim.build_storage(*random_uv(np.random.RandomState(0), (1080, 1920)))
    assert sim.mesh.shape == (2, 2)
    sim.build_storage(*random_uv(np.random.RandomState(0), (64, 16)))
    assert sim.mesh.shape == (2, 2)
    pinned = ShardedSimulation(Parameters(), device="cpu", engine="mega",
                               n_devices=4, mesh_cols=1)
    assert pinned.mesh.shape == (4, 1)
    # None: one shard per visible card, one on the CPU
    assert ShardedSimulation(Parameters(), device="cpu", engine="mega") \
        ._resolve_mesh((64, 64)).shape == (1, 1)


@pytest.mark.parametrize("case", ["not_divisible", "zero_shards"])
def test_make_mesh_rejects(case):
    with pytest.raises(ValueError):
        if case == "not_divisible":
            halo.make_mesh(4, 3, "cpu")
        else:
            halo.make_mesh(0, 1, "cpu")


@pytest.mark.parametrize("kind", [
    "grid_below_shards", "steps_over", "n_blocks_zero", "wrong_shape",
    "other_device", "boundary", "tile",
])
def test_sharded_megastep_rejects_bad_arguments(kind):
    shape = (40, 30)
    mesh = halo.make_mesh(4, 2, "cpu")
    up, vp = halo.mega_shard_state(np.zeros(shape, np.float32),
                                   np.ones(shape, np.float32), mesh)
    args = dict(n_blocks=1, steps=8, boundary="zero", grid=0)
    if kind == "grid_below_shards":
        args["grid"] = 3
    elif kind == "steps_over":
        args["steps"] = 9
    elif kind == "n_blocks_zero":
        args["n_blocks"] = 0
    elif kind == "wrong_shape":
        shape = (80, 30)
    elif kind == "other_device":
        mesh = halo.Mesh(2, 2, torch.device("cuda"))
    elif kind == "boundary":
        args["boundary"] = "periodic"
    elif kind == "tile":
        args["geometry"] = geometry.Geometry(48, 48, 4)
    before = sharded_mega.launches
    with pytest.raises(ValueError):
        sharded_mega.sharded_megastep(
            up, vp, mesh, args["n_blocks"], args["steps"],
            kernel_constants(Parameters()), args["boundary"], shape,
            grid=args["grid"], geometry=args.get("geometry"))
    assert sharded_mega.launches == before


@pytest.mark.parametrize("sms", [132, 114, 66])
def test_tile_rounds_and_choice(sms):
    """K7's rounds of tiles a time block and its geometry choice, from each
    geometry's co-resident blocks on a card of ``sms`` SMs: 2 blocks an SM
    of the 64x64 tiles, 4 of the 32x32 ones. Rounds: a shard's tiles over
    its group, ceil(tiles / (blocks // shards)); the choice: the fewest
    window cells an SM steps (rounds x blocks an SM x window cells)."""
    coresident = {64: 2 * sms, 32: 4 * sms}
    cases = [((1080, 1920), m) for m in ((1, 1), (2, 1), (4, 1), (2, 2))]
    cases += [((4096, 4096), m) for m in ((1, 1), (4, 1), (2, 2))]
    chosen = {}
    for shape, mesh_shape in cases:
        n_shards = mesh_shape[0] * mesh_shape[1]
        r_loc, c_loc = halo.shard_extents(shape, halo.Mesh(*mesh_shape,
                                                           None))
        cost = {}
        for tile, cells in sharded_mega.TILES.items():
            tiles = -(-r_loc // tile) * -(-c_loc // tile)
            group = min(coresident[tile], n_shards * tiles) // n_shards
            rounds = sharded_mega.tile_rounds(shape, mesh_shape, tile,
                                              coresident[tile])
            assert rounds == -(-tiles // group)
            assert (rounds - 1) * group < tiles <= rounds * group
            cost[tile] = rounds * coresident[tile] / sms * cells
        chosen[shape, mesh_shape] = sharded_mega.choose_tile(
            shape, mesh_shape, coresident, sms)
        assert cost[chosen[shape, mesh_shape]] == min(cost.values())
    if sms == 132:
        # the H100: 264 and 528 co-resident blocks. 2x2 at 1080x1920:
        # 135 tiles of 64^2 a shard on 66 blocks (3 rounds, where one shard
        # takes 2) against 510 of 32^2 on 132 (4 rounds)
        assert [sharded_mega.tile_rounds((1080, 1920), m, 64, 264)
                for m in ((1, 1), (2, 1), (4, 1), (2, 2))] == [2, 3, 3, 3]
        assert [sharded_mega.tile_rounds((1080, 1920), m, 32, 528)
                for m in ((1, 1), (2, 1), (4, 1), (2, 2))] == [4, 4, 5, 4]
        assert chosen == {
            ((1080, 1920), (1, 1)): 64, ((1080, 1920), (2, 1)): 32,
            ((1080, 1920), (4, 1)): 64, ((1080, 1920), (2, 2)): 32,
            ((4096, 4096), (1, 1)): 64, ((4096, 4096), (4, 1)): 64,
            ((4096, 4096), (2, 2)): 64}


def test_tile_rounds_without_a_block_a_shard():
    """A launch that cannot hold one block a shard takes no rounds (the
    kernel refuses it), and the choice falls to the 64x64 tiles."""
    assert sharded_mega.tile_rounds((64, 64), (4, 2), 64, 7) == float("inf")
    assert sharded_mega.choose_tile((64, 64), (4, 2), {64: 7, 32: 7},
                                    132) == 64


def test_cpu_calls_do_not_count_as_launches(rng):
    before = sharded_mega.launches
    run_port(*random_uv(rng, (40, 300)), Parameters(), "zero", 19, 4, 2)
    assert sharded_mega.launches == before


@pytest.mark.parametrize("flags", [
    [],                                # auto: 2x2 at this shape
    ["--sharded-mesh-cols", "1"],      # 4x1
    ["--sharded-mesh-cols", "2"],
])
def test_simulate_sharded_equals_cuda_backend_on_cpu(flags):
    """``simulate --backend sharded --sharded-engine mega --sharded-devices
    4 --device cpu``: every frame equal to the ``cuda`` backend's CPU run
    (9 steps an image: one full and one remainder launch)."""
    frames, engines = {}, {}
    for backend in (["--backend", "sharded", "--sharded-engine", "mega",
                     "--sharded-devices", "4", *flags], []):
        ns = simulate.build_parser().parse_args(
            ["-r", "70", "-c", "300", "--device", "cpu", *backend])
        sim = shared.make_simulation(ns)
        species = sim.make_species(shared.domain_shape(ns))
        engines[sim.name] = species.storage[0]
        frames[sim.name] = []
        simulate.run(sim, species, 3, 9, frames[sim.name].append)
    assert engines["sharded"] == ("shmega" if flags[-1:] == ["1"]
                                  else "shmega2d")
    for got, want in zip(frames["sharded"], frames["cuda"]):
        np.testing.assert_array_equal(got, want)


def test_sharded_cli_flags_and_env(monkeypatch):
    ns = simulate.build_parser().parse_args([])
    assert (ns.backend, ns.sharded_engine, ns.sharded_devices,
            ns.sharded_mesh_cols, ns.sharded_overlap) == (
        "auto", "auto", None, None, "auto")
    monkeypatch.setenv("GRAYSCOTT_BACKEND", "sharded")
    monkeypatch.setenv("GRAYSCOTT_SHARDED_ENGINE", "mega")
    monkeypatch.setenv("GRAYSCOTT_SHARDED_DEVICES", "4")
    monkeypatch.setenv("GRAYSCOTT_SHARDED_MESH_COLS", "2")
    ns = simulate.build_parser().parse_args(["--device", "cpu"])
    sim = shared.make_simulation(ns)
    assert isinstance(sim, ShardedSimulation)
    assert sim.mesh.shape == (2, 2)
    monkeypatch.setenv("GRAYSCOTT_SHARDED_ENGINE", "fast")
    with pytest.raises(SystemExit):
        simulate.build_parser()
