"""The sharded engines' K and tile pins on the CPU: K7's tile pins and the
windowed engine's K (1..32) and row tile (grayscott_tpu_torch/backends/
sharded.py; the shard layout at ``halo_for_steps(K)``, parallel/halo.py),
their plain versions bit for bit the oracle, against JAX's
``ShardedSimulation`` in interpret mode on ``tests/conftest.py``'s virtual
CPU mesh (1e-6; bf16 the plain run bit for bit and JAX to one ulp at a
few cells), JAX's refusals with its class and message, a shard
thinner than its halo, the layout functions at a deep halo, and the
sharded tuner's candidates against JAX's ``_sharded_candidates``."""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from grayscott_tpu import oracle
from grayscott_tpu.backends.sharded import ShardedSimulation as JaxSharded
from grayscott_tpu.bench import autotune as jax_autotune
from grayscott_tpu.errors import UnsupportedConfigError as JaxUnsupported
from grayscott_tpu.params import Parameters as JaxParameters
from grayscott_tpu_torch.backends.sharded import ShardedSimulation
from grayscott_tpu_torch.bench import autotune
from grayscott_tpu_torch.cli import shared, simulate
from grayscott_tpu_torch.errors import UnsupportedConfigError
from grayscott_tpu_torch.ops import geometry, sharded_mega, stencil
from grayscott_tpu_torch.parallel import halo
from grayscott_tpu_torch.params import Parameters, kernel_constants
from grayscott_tpu_torch.utils import cache

from conftest import random_uv


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module: its tensors are small, and
    beside other test processes torch's thread pool spins against them
    (a tuner test took 685 s so, 11 s alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def store(monkeypatch, tmp_path):
    """An empty autotune store of the test's own."""
    monkeypatch.setenv("GRAYSCOTT_CACHE_DIR", str(tmp_path / "store"))


def run_port(u, v, boundary, steps, **kw):
    sim = ShardedSimulation(Parameters(), boundary, device="cpu",
                            tuned_lookup=False, **kw)
    species = sim.make_species(u.shape)
    species.storage = sim.build_storage(u, v)
    sim.perform_steps(species, steps)
    return sim, species


def run_jax(u, v, boundary, steps, **kw):
    sim = JaxSharded(JaxParameters(), boundary, interpret=True,
                     tuned_lookup=False, **kw)
    species = sim.make_species(u.shape)
    species.storage = sim.build_storage(u, v)
    sim.perform_steps(species, steps)
    return species.uv_host()


@pytest.mark.parametrize("shape,kw", [
    ((64, 256), dict(engine="mega", n_devices=4, mesh_cols=2,
                     block_rows=16, block_cols=128)),
    ((64, 96), dict(engine="windowed", n_devices=4, mesh_cols=1,
                    steps_per_call=16, block_rows=16)),
])
def test_pins_match_jax(shape, kw):
    """The port under K7's tile pins and the windowed engine's K and row
    tile: the oracle bit for bit, and within 1e-6 of JAX's sharded engines
    in interpret mode on the same pins."""
    u, v = random_uv(np.random.RandomState(11), shape)
    sim, species = run_port(u, v, "naive", 16, **kw)
    got = species.uv_host()
    for g, o in zip(got, oracle.run(u, v, JaxParameters(), 16, "naive")):
        np.testing.assert_array_equal(g, o)
    for g, w in zip(got, run_jax(u, v, "naive", 16, **kw)):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


@pytest.mark.parametrize("kw", [
    dict(engine="windowed", n_devices=4, mesh_cols=1, steps_per_call=16,
         block_rows=16),
    dict(engine="windowed", n_devices=4, mesh_cols=2, steps_per_call=16,
         block_rows=16),
    dict(engine="mega", n_devices=4, mesh_cols=2, block_rows=16,
         block_cols=128),
])
def test_bf16_pins_match_jax(kw):
    """bf16 storage under the windowed engine's K and row tile (overlap off
    and on) and under K7's tile pins, over a run that ends mid-block: bit
    for bit the plain bf16 run rounded once a K-step block, and JAX's
    sharded engines in interpret mode on the same pins to within one bf16
    ulp at no more than 1 element in 1000.

    Bit for bit JAX is not attainable at every input: JAX's interpret-mode
    float32 differs from the exact step by up to 1.8e-7 (the 1e-6 of the
    float32 tests), and a value that close to a bf16 rounding midpoint
    rounds the other way. At this input the windowed cases agree bit for
    bit; K7's differs at 6 of 32768 elements, one ulp each, and so does
    JAX's own K = 8 windowed engine against the plain run, unpinned."""
    shape = (64, 256)
    steps = 19
    u, v = random_uv(np.random.RandomState(14), shape)
    plain = stencil.run_bf16(*(torch.from_numpy(x).to(torch.bfloat16)
                               for x in (u, v)), steps,
                             kernel_constants(Parameters()), "naive",
                             block=kw.get("steps_per_call", 8))
    want = run_jax(u, v, "naive", steps, dtype="bfloat16", **kw)
    overlaps = ("off", "on") if kw["engine"] == "windowed" else ("off",)
    for overlap in overlaps:
        _, species = run_port(u, v, "naive", steps, dtype="bfloat16",
                              overlap=overlap, **kw)
        for g, p, w in zip(species.uv_host(), plain, want):
            np.testing.assert_array_equal(g, p.float().numpy())
            apart = g != w
            ulp = np.exp2(np.floor(np.log2(np.abs(w[apart]))) - 7)
            np.testing.assert_array_equal(np.abs(g - w)[apart], ulp)
            assert apart.sum() * 1000 <= apart.size


@pytest.mark.parametrize("k", [1, 3, 12, 16, 24, 32])
@pytest.mark.parametrize("mesh", [(1, 1), (4, 1), (2, 2)])
@pytest.mark.parametrize("tr", [None, 8])
def test_windowed_k_and_row_tile_are_the_oracle(k, mesh, tr):
    """K across 1..32 and row tiles, on row and 2-D meshes: the oracle bit
    for bit over a run that ends mid-block; the layout's halo is
    ``halo_for_steps(K)`` (and its columns on a 2-D mesh)."""
    shape = (130, 72)
    u, v = random_uv(np.random.RandomState(k), shape)
    n, cols = mesh[0] * mesh[1], mesh[1]
    sim, species = run_port(u, v, "naive" if k % 2 else "zero", 2 * k + 3,
                            engine="windowed", n_devices=n, mesh_cols=cols,
                            steps_per_call=k, block_rows=tr)
    plan_k, g = species.storage[4]
    h = geometry.halo_for_steps(k)
    assert (plan_k, g.halo, sim.mesh.halo, sim.mesh.chalo) == (
        k, h, h, h if cols > 1 else 0)
    assert species.storage[1].shape == halo.pair_shape(shape, sim.mesh)
    for got, want in zip(species.uv_host(), oracle.run(
            u, v, JaxParameters(), 2 * k + 3,
            "naive" if k % 2 else "zero")):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [4, 16])
def test_windowed_bf16_rounds_once_a_k_block(k):
    """bf16 storage rounds once a K-step block, as JAX's sharded engine
    does: the plain bf16 run at ``block=K``, bit for bit, overlap on and
    off."""
    shape = (300, 24)
    u, v = random_uv(np.random.RandomState(12), shape)
    steps = 2 * k + 1
    want = stencil.run_bf16(*(torch.from_numpy(x).to(torch.bfloat16)
                              for x in (u, v)), steps,
                            kernel_constants(Parameters()), "zero", block=k)
    for overlap in ("off", "on"):
        sim, species = run_port(u, v, "zero", steps, engine="windowed",
                                n_devices=2, mesh_cols=1, steps_per_call=k,
                                block_rows=64, dtype="bfloat16",
                                overlap=overlap)
        assert sim.overlap_runs(shape) == (overlap == "on")
        for g, w in zip(species.uv_host(), want):
            np.testing.assert_array_equal(g, w.float().numpy())


@pytest.mark.parametrize("pins", [(8, None), (16, 128), (None, 256),
                                  (32, 1024)])
@pytest.mark.parametrize("mesh", [(4, 1), (2, 2), (1, 4)])
def test_k7_tile_pins_are_the_oracle(pins, mesh):
    """K7's plain version under each tile pin on 1-D and 2-D meshes, the
    oracle bit for bit; the storage carries the tiles (None where neither
    is pinned or the column pin spans a row mesh's width alone)."""
    shape = (72, 300)
    u, v = random_uv(np.random.RandomState(13), shape)
    sim, species = run_port(u, v, "naive", 13, engine="mega",
                            n_devices=mesh[0] * mesh[1], mesh_cols=mesh[1],
                            block_rows=pins[0], block_cols=pins[1])
    tiles = species.storage[3]
    r_loc, c_loc = halo.shard_extents(shape, sim.mesh)
    tc = pins[1]
    if mesh[1] == 1 and tc is not None and tc >= shape[1]:
        tc = None
    assert tiles == geometry.mega_resolve((r_loc, c_loc), pins[0], tc,
                                          cover=mesh[1] > 1)
    for got, want in zip(species.uv_host(),
                         oracle.run(u, v, JaxParameters(), 13, "naive")):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [
    dict(engine="mega", block_rows=12),
    dict(engine="mega", block_rows=0),
    dict(engine="mega", block_cols=100),
    dict(engine="mega", block_rows=16, block_cols=64),
    dict(engine="mega", steps_per_call=16),
    dict(engine="windowed", block_cols=128),
    dict(block_cols=256),
    dict(engine="mega", overlap="on"),
])
def test_refusals_are_jax(kw):
    """The values JAX's sharded backend refuses raise its class and
    message: K7's row tile not a positive multiple of 8 and column tile
    not one of 128 (``backends/sharded.py:354-364``), K7's K
    (``:99-104``), a column tile on the windowed engine (``:106-111``),
    overlap on K7."""
    u, v = random_uv(np.random.RandomState(0), (64, 256))
    kw = dict(kw, n_devices=2, mesh_cols=1)
    with pytest.raises(JaxUnsupported) as want:
        run_jax(u, v, "naive", 1, **kw)
    with pytest.raises(UnsupportedConfigError) as got:
        run_port(u, v, "naive", 1, **kw)
    assert str(got.value) == str(want.value)


def test_k_outside_the_range_is_jax_s_value_error():
    for k in (0, 33):
        with pytest.raises(ValueError, match=r"steps_per_call must be in "
                                             r"\[1, 32\]"):
            ShardedSimulation(Parameters(), device="cpu", steps_per_call=k)


@pytest.mark.parametrize("mesh,k", [((4, 1), 32), ((8, 1), 16),
                                    ((2, 4), 32)])
def test_a_shard_thinner_than_its_halo_is_refused(mesh, k):
    """JAX's exchange fills a halo from one neighbour's interior, and
    checks nothing: from a shard thinner than its halo it sends the
    sender's own halo rows (its windowed engine's result turns to NaN,
    ``halo.thin_shard``). The port refuses the layout."""
    shape = (64, 96)
    u, v = random_uv(np.random.RandomState(0), shape)
    with pytest.raises(UnsupportedConfigError, match="thinner than their"):
        run_port(u, v, "naive", 1, engine="windowed",
                 n_devices=mesh[0] * mesh[1], mesh_cols=mesh[1],
                 steps_per_call=k)
    mesh_h = halo.Mesh(*mesh, torch.device("cpu"),
                       geometry.halo_for_steps(k))
    assert halo.thin_shard(shape, mesh_h)
    assert halo.thin_shard(shape, mesh_h.with_halo(8)) is None


@pytest.mark.parametrize("h", [8, 16, 24, 32])
@pytest.mark.parametrize("mesh", [(3, 1), (2, 3)])
def test_exchange_at_a_deep_halo_is_the_padded_domain(h, mesh):
    """After ``exchange_halos`` at halo ``h`` each shard's slot is the
    zero-padded domain's block around its interior, ``h`` rows (and ``h``
    columns on a 2-D mesh) deep on every side."""
    shape = (100, 150)
    u = torch.from_numpy(random_uv(np.random.RandomState(h), shape)[0])
    m = halo.Mesh(*mesh, torch.device("cpu"), h)
    pairs, _ = halo.mega_shard_state(u, u, m)
    halo.exchange_halos(pairs, 0, h)
    r_loc, c_loc, ch = halo.interior_extents(pairs, h)
    assert ch == (h if mesh[1] > 1 else 0)
    full = torch.zeros((mesh[0] * r_loc + 2 * h,
                        mesh[1] * c_loc + 2 * h))
    full[h:h + shape[0], h:h + shape[1]] = u
    for i, j in itertools.product(range(mesh[0]), range(mesh[1])):
        want = full[i * r_loc:i * r_loc + r_loc + 2 * h,
                    j * c_loc + h - ch:j * c_loc + h + c_loc + ch]
        assert torch.equal(pairs[i, j, 0], want)
    assert torch.equal(halo.mega_unshard_result(pairs, shape, 0, h), u)


@pytest.mark.parametrize("tile,h", [((64, 64), 8), ((32, 64), 16),
                                    ((16, 48), 24), ((88, 64), 16)])
@pytest.mark.parametrize("extents", [(272, 1920), (544, 960), (40, 40)])
def test_overlap_tiles_are_those_whose_windows_stay_inside(tile, h,
                                                           extents):
    """``overlap_tiles`` at any tile and halo: exactly the tiles whose
    window lies inside the shard's interior rows (and columns on a 2-D
    mesh), by brute force."""
    r_loc, c_loc = extents
    for chalo in (0, h):
        ti0, ti1, tj0, tj1 = halo.overlap_tiles(r_loc, c_loc, chalo, tile,
                                                h)
        rows = [i for i in range(-(-r_loc // tile[0]))
                if i * tile[0] - h >= 0 and (i + 1) * tile[0] + h <= r_loc]
        cols = ([j for j in range(-(-c_loc // tile[1]))
                 if j * tile[1] - h >= 0
                 and (j + 1) * tile[1] + h <= c_loc] if chalo
                else list(range(-(-c_loc // tile[1]))))
        if rows and cols:
            assert (ti0, ti1, tj0, tj1) == (rows[0], rows[-1] + 1, cols[0],
                                            cols[-1] + 1)
        else:
            assert (ti0, ti1, tj0, tj1) == (0, 0, 0, 0)


def test_read_site_counts_tile_rows_of_the_pinned_height():
    """K7's read-site wait applies on a row mesh whose shards have more
    than one row of tiles of the pinned height."""
    assert sharded_mega.read_site_applies((1080, 1920), (4, 1), 64)
    assert not sharded_mega.read_site_applies((1080, 1920), (4, 1), 272)
    assert sharded_mega.read_site_applies((1080, 1920), (4, 1), 136)
    assert not sharded_mega.read_site_applies((1080, 1920), (2, 2), 8)


@pytest.mark.parametrize("shape,n", [((1080, 1920), 4), ((4096, 4096), 4),
                                     ((300, 300), 4), ((2048, 512), 2)])
def test_tuner_candidates_are_jax_s(shape, n):
    """The sharded tuner's candidates are JAX's ``_sharded_candidates``
    (``bench/autotune.py:604-665``) mapped onto the port: the same meshes,
    engines, K and overlap verdicts in the same order, JAX's ``tr_ov``
    on the overlap candidates, and the half row tile at K = 16, halved
    from the port's default row tile (64) where JAX halves its VMEM
    heuristic's. An overlap candidate stands where the port's split
    engages on its tile, as JAX's stands where its own does."""
    jax = jax_autotune._sharded_candidates(shape, n, "naive", "float32")
    port = autotune._sharded_candidates(shape, n)

    def kind(c, jax_side):
        if c.get("overlap"):
            return "overlap"
        if c.get("block_rows"):
            return "half"
        return c["engine"]

    def key(c, jax_side):
        return (c["engine"], c["mesh_cols"], c.get("steps_per_call"),
                kind(c, jax_side))

    strip = [key(c, True) for c in jax if not c.get("overlap")]
    assert strip == [key(c, False) for c in port if not c.get("overlap")]
    for c in port:
        if c.get("overlap"):
            nr = n // c["mesh_cols"]
            h = geometry.halo_for_steps(c["steps_per_call"])
            assert c["block_rows"] == max(h, -(-shape[0] // nr) // 3 // 8
                                          * 8)
        elif c.get("block_rows"):
            assert c["block_rows"] == 32


def test_a_record_lends_k7_its_tiles_and_never_a_tile_across_k():
    """ADVICE.md #2 on the sharded records: K7 adopts a K7 record's tiles
    of its mesh (K = 8, the record's); a windowed run pinned to K = 16
    takes neither the K = 8 record's row tile nor its K."""
    shape = (70, 300)
    key = autotune.sharded_key(Parameters(), shape, "naive", n_devices=4,
                               device="cpu", engine="mega")
    store = {key: {"engine": "mega", "mesh_cols": 1, "mesh_rows": 4,
                   "block_rows": 16, "block_cols": 128, "steps_per_call": 8,
                   "overlap": False, "gcells_per_sec": 1.0}}
    key = autotune.sharded_key(Parameters(), shape, "naive", n_devices=4,
                               device="cpu", steps_per_call=16)
    store[key] = {"engine": "windowed", "mesh_cols": 1, "mesh_rows": 4,
                  "block_rows": 8, "block_cols": None, "steps_per_call": 8,
                  "overlap": False, "gcells_per_sec": 1.0}
    cache.save_autotune(store)
    sim = ShardedSimulation(Parameters(), device="cpu", n_devices=4,
                            engine="mega")
    species = sim.make_species(shape)
    assert (sim.tile_rows, sim.tile_cols) == (16, 128)
    assert species.storage[3] == geometry.Geometry(16, 128, 8)
    sim = ShardedSimulation(Parameters(), device="cpu", n_devices=4,
                            steps_per_call=16)
    species = sim.make_species(shape)
    assert sim.tile_rows is None and species.storage[4][0] == 16


@pytest.mark.parametrize("flags,tag", [
    (["--sharded-engine", "mega", "--pallas-block-rows", "16",
      "--pallas-block-cols", "128"], "shmega2d"),
    (["--sharded-engine", "windowed", "--pallas-steps-per-call", "16",
      "--pallas-block-rows", "24", "--sharded-mesh-cols", "1"], "shwin"),
])
def test_simulate_under_the_pins_gives_the_unpinned_frames(flags, tag):
    """``simulate.run`` under the pins: each frame bit for bit the unpinned
    run's (float32)."""
    base = ["--device", "cpu", "--backend", "sharded", "--sharded-devices",
            "4", "-r", "70", "-c", "300"]
    runs = []
    for argv in (base + flags, base + flags[:2]):
        ns = simulate.build_parser().parse_args(argv)
        sim = shared.make_simulation(ns)
        species = sim.make_species((70, 300))
        frames = []
        simulate.run(sim, species, 3, 9, frames.append)
        runs.append((species.storage[0], frames))
    assert runs[0][0] == tag
    for a, b in zip(runs[0][1], runs[1][1]):
        np.testing.assert_array_equal(a, b)
