"""The second form of the megakernels' pinned entries on the CPU, K2 pinned
(``csrc/mega_pins_fixed.cu``) and K7 pinned
(``csrc/sharded_mega_pins_fixed.cu``): the host's choice of the compiled
or the run-time form (``geometry.mega_pin_launch``, which the wrappers
call) for every geometry of the pins matrix and of the tuner's K2
candidates, the threads and blocks an SM a window's bytes leave, K7's
group split and rounds of tiles a shard, the splits' refusals, and the
plain versions against JAX's interpret-mode megakernels at each newly
compiled tile. The kernels themselves run on the card (``chip_smoke.py``
phase 26). Tolerances: none between the port's plain runs (bit for bit);
atol 1e-6 against JAX's megakernels, as the other pinned tests hold
them."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from grayscott_tpu.backends.pallas import PallasSimulation
from grayscott_tpu.backends.sharded import ShardedSimulation as JaxSharded
from grayscott_tpu.params import Parameters as JaxParameters
from grayscott_tpu_torch.backends.cuda import CudaSimulation
from grayscott_tpu_torch.backends.sharded import ShardedSimulation
from grayscott_tpu_torch.bench import autotune
from grayscott_tpu_torch.errors import UnsupportedConfigError
from grayscott_tpu_torch.ops import geometry, megakernel, sharded_mega
from grayscott_tpu_torch.parallel import halo
from grayscott_tpu_torch.params import Parameters, kernel_constants
from grayscott_tpu_torch.species import Species

from conftest import random_uv

#: the tile pins of the matrix (test_torch_pin_form.py's TILES) and the
#: tuner's K2 candidates (bench/autotune.py:MEGA_EXTRA)
TILES = [(None, None), (32, 32), (8, 512), (64, 128), (128, 32), (8, None),
         (16, 8), (None, 13), (32, None), (544, 64)]
TUNER = [(c.get("block_rows"), c.get("block_cols"))
         for c in autotune.MEGA_EXTRA]
SHAPES = [(1080, 1920), (4096, 4096)]
MESHES = [(2, 2), (1, 4), (4, 1)]

DEFAULT = kernel_constants(Parameters())
FIVE_POINTS = kernel_constants(Parameters.with_stencil("5points"))


@pytest.fixture(autouse=True)
def store(monkeypatch, tmp_path):
    """An empty autotune store of the test's own."""
    monkeypatch.setenv("GRAYSCOTT_CACHE_DIR", str(tmp_path / "store"))


def k2_tiles(shape, tr, tc):
    """K2's tiles under the pins, as the backend resolves them, or None
    where JAX's megakernel refuses the pins."""
    if not geometry.mega_pins_ok(tr, tc):
        return None
    sim = CudaSimulation(Parameters(), device="cpu", engine="mega",
                         block_rows=tr, block_cols=tc, tuned_lookup=False)
    return sim.mega_plan_for(shape)


def k7_tiles(shape, mesh, tr, tc):
    """K7's tiles on a mesh under the pins, as the backend resolves them
    (None: the compiled tiles K7 picks itself), or False where JAX's K7
    refuses the pins."""
    sim = ShardedSimulation(Parameters(), device="cpu", engine="mega",
                            n_devices=mesh[0] * mesh[1], mesh_cols=mesh[1],
                            block_rows=tr, block_cols=tc,
                            tuned_lookup=False)
    try:
        return sim.mega_tiles(shape)
    except UnsupportedConfigError:
        return False


@pytest.mark.parametrize("tr,tc", TILES + TUNER)
@pytest.mark.parametrize("shape", SHAPES)
def test_k2_launch_choice(shape, tr, tc):
    """K2 under each pin: the compiled sizes exactly on MEGA_FIXED_PINS
    for the default stencils' tap set, at the boundary's threads there;
    else the first form's run-time sizes on 512 threads; the fold and
    another tap set always the first form."""
    g = k2_tiles(shape, tr, tc)
    if g is None or g.compiled:
        return
    fixed = geometry.MEGA_FIXED_PINS.get((g.tr, g.tc))
    for i, boundary in enumerate(("naive", "zero")):
        form = geometry.mega_pin_launch(g, boundary=boundary)
        assert form.sizes == ("compiled" if fixed else "run-time")
        assert form.threads == (fixed[i] if fixed else 512)
        assert form.blocks_per_sm == min(geometry.blocks_by_bytes(g.bytes),
                                         65536 // (64 * form.threads))
    assert geometry.mega_pin_launch(g, default=False) == \
        geometry.mega_pin_launch(g, fold=True) == (
            "run-time", 512, min(geometry.blocks_by_bytes(g.bytes), 2))


@pytest.mark.parametrize("tr,tc", TILES)
@pytest.mark.parametrize("mesh", MESHES)
def test_k7_launch_choice(mesh, tr, tc):
    """K7 under each pin on 1-D and 2-D meshes at 1080x1920: the compiled
    sizes exactly on SHARDED_FIXED_PINS for the default tap set, where the
    naive kernels hold 64 registers; the first form's naive kernels one
    block an SM, its zero ones up to two."""
    g = k7_tiles((1080, 1920), mesh, tr, tc)
    if not g:
        return
    fixed = geometry.SHARDED_FIXED_PINS.get((g.tr, g.tc))
    by_bytes = geometry.blocks_by_bytes(g.bytes)
    for i, boundary in enumerate(("naive", "zero")):
        form = geometry.mega_pin_launch(g, True, boundary)
        if fixed:
            assert form == ("compiled", fixed[i],
                            min(by_bytes, 65536 // (64 * fixed[i])))
        else:
            assert form == ("run-time", 512, min(
                by_bytes, 1 if boundary == "naive" else 2))
        assert geometry.mega_pin_launch(g, True, boundary,
                                        default=False).sizes == "run-time"


#: the kept forms, written out by hand from the split (PERF.md §6, PR 26):
#: (K2 or K7, tiles, boundary) -> (sizes, threads, blocks an SM)
KEPT = {
    ("K2", (16, 64), "naive"): ("compiled", 256, 4),
    ("K2", (16, 64), "zero"): ("compiled", 256, 4),
    ("K2", (32, 64), "naive"): ("compiled", 512, 2),
    ("K2", (32, 64), "zero"): ("compiled", 512, 2),
    ("K2", (32, 128), "naive"): ("compiled", 512, 2),
    ("K2", (32, 128), "zero"): ("compiled", 512, 2),
    ("K2", (64, 128), "naive"): ("compiled", 1024, 1),
    ("K2", (64, 128), "zero"): ("compiled", 512, 1),
    ("K2", (8, 64), "naive"): ("run-time", 512, 2),
    ("K2", (16, 256), "zero"): ("run-time", 512, 1),
    ("K7", (32, 128), "naive"): ("compiled", 512, 2),
    ("K7", (32, 128), "zero"): ("compiled", 512, 2),
    ("K7", (64, 128), "naive"): ("compiled", 1024, 1),
    ("K7", (64, 128), "zero"): ("compiled", 512, 1),
    ("K7", (16, 64), "naive"): ("run-time", 512, 1),
    ("K7", (16, 64), "zero"): ("run-time", 512, 2),
    ("K7", (32, 64), "naive"): ("run-time", 512, 1),
}


@pytest.mark.parametrize("key", list(KEPT), ids=str)
def test_kept_forms_by_hand(key):
    """The launch the wrappers run on the split's geometries and a few
    others, against a table written out by hand."""
    kernel, tiles, boundary = key
    assert geometry.mega_pin_launch(geometry.Geometry(*tiles, 8),
                                    kernel == "K7", boundary) == KEPT[key]


def test_the_pinned_paths_compile_their_sizes():
    """The pins of the kernel table's rows and of the tuner: K2 on 32x128,
    32x64, 64x128 and 16x64 (bf16's row) and K7 on 2x2 at 32x128 and 1x4
    at 64x128 run compiled sizes."""
    shape = (1080, 1920)
    for tr, tc in ((32, 128), (32, None), (None, 128), (64, 128),
                   (16, None)):
        assert geometry.mega_pin_launch(k2_tiles(shape, tr, tc)).sizes == \
            "compiled"
    assert k2_tiles(shape, 16, None) == (16, 64, 8)
    for mesh, tiles in (((2, 2), (32, 128)), ((1, 4), (64, 128))):
        g = k7_tiles(shape, mesh, *tiles)
        assert tuple(g)[:2] == tiles
        assert geometry.mega_pin_launch(g, True).sizes == "compiled"


#: (tr, tc) -> (window pair bytes, blocks an SM by bytes, fitted threads,
#: blocks an SM at 64 registers): each window (tr + 16) x pitch(tc + 16)
#: floats, 4 B, two species, two buffers; an SM's 233,472 B less 1,024 a
#: block; 65,536 registers over 64 a thread
BYTES_TABLE = {
    (8, 64): (30720, 7, 256, 4),
    (16, 64): (40960, 5, 256, 4),
    (32, 64): (61440, 3, 512, 2),
    (64, 64): (102400, 2, 512, 2),
    (32, 128): (110592, 2, 512, 2),
    (128, 32): (110592, 2, 512, 2),
    (16, 256): (139264, 1, 1024, 1),
    (64, 128): (184320, 1, 1024, 1),
    (8, 512): (202752, 1, 1024, 1),
}


@pytest.mark.parametrize("tiles", list(BYTES_TABLE))
def test_threads_fitted_to_the_window_bytes(tiles):
    """The split's part 3 rule (csrc/gs_pin_sm90.cuh:fitted_threads):
    1024 threads where a window pair leaves one block an SM, 512 at two or
    three, 256 at four or more, against a table written out by hand; and
    the blocks an SM of each compiled geometry at its table's threads on
    either boundary."""
    nbytes, blocks, threads, per_sm = BYTES_TABLE[tiles]
    g = geometry.Geometry(*tiles, 8)
    assert g.bytes == nbytes
    assert geometry.blocks_by_bytes(nbytes) == blocks
    assert geometry.fitted_threads(nbytes) == threads
    assert min(blocks, 65536 // (64 * threads)) == per_sm
    assert megakernel.pinned_part_threads(3, g) == threads
    assert megakernel.pinned_part_threads(0, g) == 512
    for fixed, sharded in ((geometry.MEGA_FIXED_PINS, False),
                           (geometry.SHARDED_FIXED_PINS, True)):
        for i, boundary in enumerate(("naive", "zero")):
            if tiles in fixed:
                assert geometry.mega_pin_launch(
                    g, sharded, boundary).blocks_per_sm == \
                    min(blocks, 65536 // (64 * fixed[tiles][i]))


#: (mesh, tiles, form) -> (grid, blocks of each group, rounds of tiles a
#: group walks) at 1080x1920 on 132 SMs: shards 544x960 (2x2), 1080x480
#: (1x4) and 272x1920 (4x1); 32x128 tiles 17x8, 34x4 and 9x15 a shard,
#: 64x128 9x8, 17x4 and 5x15; two blocks an SM 264, one 132, a quarter each
WALK_TABLE = {
    ((2, 2), (32, 128), "compiled"): (264, 66, 3),
    ((2, 2), (32, 128), "run-time"): (132, 33, 5),
    ((1, 4), (32, 128), "compiled"): (264, 66, 3),
    ((1, 4), (32, 128), "run-time"): (132, 33, 5),
    ((4, 1), (32, 128), "compiled"): (264, 66, 3),
    ((4, 1), (32, 128), "run-time"): (132, 33, 5),
    ((2, 2), (64, 128), "compiled"): (132, 33, 3),
    ((1, 4), (64, 128), "compiled"): (132, 33, 3),
    ((4, 1), (64, 128), "compiled"): (132, 33, 3),
}


@pytest.mark.parametrize("key", list(WALK_TABLE), ids=str)
def test_k7_group_split_and_rounds(key):
    """K7's naive walk (``sharded_mega.pinned_walk``: the grid the C entry
    sizes, one group a shard, rounds per shard) against a table by hand:
    the compiled 32x128 naive kernels run two blocks an SM, 3 rounds a
    shard where the first form's one block took 5."""
    mesh, tiles, sizes = key
    grid, group, rounds = WALK_TABLE[key]
    walk = sharded_mega.pinned_walk((1080, 1920), mesh,
                                    geometry.Geometry(*tiles, 8), "naive",
                                    132, default=sizes == "compiled")
    assert walk == (grid, [group] * 4, [rounds] * 4)


def test_k7_groups_of_an_uneven_grid():
    """A grid that does not divide: the first grid % shards groups one
    block larger (csrc/sharded_mega.cuh), as the read-site plan splits
    it; rounds follow the smallest group."""
    assert sharded_mega.group_sizes(263, 4) == [66, 66, 66, 65]
    assert sharded_mega.group_sizes(9, 4) == [3, 2, 2, 2]
    walk = sharded_mega.pinned_walk((1080, 1920), (2, 2),
                                    geometry.Geometry(32, 128, 8), "zero",
                                    131)
    assert walk == (262, [66, 66, 65, 65], [3, 3, 3, 3])
    plans = sharded_mega.read_site_plan((1080, 1920), (4, 1), 64, 263)
    assert [len(p.blocks) for p in plans] == [66, 66, 66, 65]


K2_REFUSED = [
    (5, (32, 128, 8), torch.float32, DEFAULT, "part must be"),
    (0, (64, 64, 8), torch.float32, DEFAULT, "pinned tiles"),
    (0, (32, 128, 8), torch.float32, FIVE_POINTS, "tap set"),
    (2, (16, 64, 8), torch.float32, DEFAULT, "compiles no 16x64"),
    (4, (32, 128, 8), torch.bfloat16, DEFAULT, "compiles no 32x128"),
    (2, (8, 256, 8), torch.float32, DEFAULT, "compiles no 8x256"),
]


@pytest.mark.parametrize("part,tiles,dtype,consts,match", K2_REFUSED)
def test_k2_split_refuses_what_it_does_not_take(part, tiles, dtype, consts,
                                                match):
    with pytest.raises(ValueError, match=match):
        megakernel.check_pinned_part(part, geometry.Geometry(*tiles), dtype,
                                     consts)


@pytest.mark.parametrize("part", list(megakernel.PINNED_ABLATIONS))
def test_k2_split_on_the_cpu_is_its_plain_version(rng, part):
    """Each part on the CPU: its input (part 1), else the entry's plain
    version, bit for bit; its grid 0."""
    u, v = random_uv(rng, (40, 136))
    g = geometry.Geometry(32, 64, 8)
    pairs = [megakernel.pair_state(torch.from_numpy(x)) for x in (u, v)]
    want = [p.clone() for p in pairs]
    if part != megakernel.PINNED_NO_STEP:
        megakernel.megastep(*want, 2, 8, DEFAULT, "naive", geometry=g)
    assert megakernel.pinned_ablation(part, *pairs, 2, 8, DEFAULT, "naive",
                                      g) == 0
    for p, w in zip(pairs, want):
        assert torch.equal(p[0], w[0])


K7_REFUSED = [
    (5, (32, 128, 8), torch.float32, DEFAULT, "naive", 2, "part must be"),
    (0, (32, 128, 16), torch.float32, DEFAULT, "naive", 2, "halo"),
    (0, (32, 128, 8), torch.float32, FIVE_POINTS, "naive", 2, "tap set"),
    (1, (32, 128, 8), torch.float32, DEFAULT, "naive", 3, "even number"),
    (3, (64, 128, 8), torch.bfloat16, DEFAULT, "naive", 2, "zero boundary"),
    (3, (16, 64, 8), torch.float32, DEFAULT, "zero", 2, "one or two"),
    (2, (64, 128, 8), torch.float32, DEFAULT, "zero", 2, "compiles no"),
    (4, (32, 128, 8), torch.bfloat16, DEFAULT, "naive", 2, "compiles no"),
]


@pytest.mark.parametrize("part,tiles,dtype,consts,boundary,n_blocks,match",
                         K7_REFUSED)
def test_k7_split_refuses_what_it_does_not_take(part, tiles, dtype, consts,
                                                boundary, n_blocks, match):
    with pytest.raises(ValueError, match=match):
        sharded_mega.check_pinned_part(part, geometry.Geometry(*tiles),
                                       dtype, consts, boundary, n_blocks)


@pytest.mark.parametrize("part", list(sharded_mega.PINNED_ABLATIONS))
def test_k7_split_on_the_cpu_is_its_plain_version(rng, part):
    """Each part on the CPU (part 3 on the zero boundary): its input,
    halos exchanged (part 1), else ``sharded_megastep_reference``, bit for
    bit; its grid 0."""
    shape = (72, 520)
    u, v = random_uv(rng, shape)
    mesh = halo.Mesh(2, 2, torch.device("cpu"))
    g = geometry.Geometry(32, 128, 8)
    boundary = "zero" if part == 3 else "naive"
    pairs = halo.mega_shard_state(u, v, mesh)
    for p in pairs:
        halo.exchange_halos(p)
    want = [p.clone() for p in pairs]
    if part != sharded_mega.PINNED_NO_STEP:
        sharded_mega.sharded_megastep_reference(*want, 2, 8, DEFAULT,
                                                boundary, shape)
    assert sharded_mega.pinned_ablation(part, *pairs, mesh, 2, 8, DEFAULT,
                                        boundary, shape, g) == 0
    for p, w in zip(pairs, want):
        assert torch.equal(p[:, :, 0], w[:, :, 0])


def run_k2(u, v, steps, jax: bool, **kw):
    """``steps`` steps of K2 under the pins: the port's (its plain version
    here), or JAX's megakernel in interpret mode."""
    if jax:
        sim = PallasSimulation(JaxParameters(), boundary="naive",
                               interpret=True, engine="mega",
                               tuned_lookup=False, **kw)
        species = sim.make_species(u.shape)
        species.storage = sim.build_storage(u, v)
    else:
        sim = CudaSimulation(Parameters(), "naive", device="cpu",
                             engine="mega", tuned_lookup=False, **kw)
        species = Species(u.shape, sim.build_storage(u, v), sim)
    sim.perform_steps(species, steps)
    return species.uv_host()


#: K2's newly compiled tiles: (domain, pins) that resolve to them
K2_JAX = [((40, 72), dict(block_rows=32)),
          ((40, 136), dict(block_rows=32, block_cols=128)),
          ((72, 136), dict(block_rows=64, block_cols=128))]


@pytest.mark.parametrize("shape,pins", K2_JAX)
def test_compiled_k2_tiles_match_jax(shape, pins):
    """A time block of 3 steps at each of K2's compiled tiles (JAX's
    interpret mode unrolls the block: the fewer steps, the less it
    compiles): the geometry the backend hands the wrapper is compiled, and
    the port's run lies within 1e-6 of JAX's megakernel in interpret mode
    on the same pins."""
    g = k2_tiles(shape, pins.get("block_rows"), pins.get("block_cols"))
    assert (g.tr, g.tc) in geometry.MEGA_FIXED_PINS
    assert geometry.mega_pin_launch(g).sizes == "compiled"
    u, v = random_uv(np.random.RandomState(21), shape)
    for got, want in zip(run_k2(u, v, 3, False, **pins),
                         run_k2(u, v, 3, True, **pins)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def run_k7(u, v, steps, jax: bool, **kw):
    """``steps`` steps of K7 under the pins: the port's (its plain version
    here), or JAX's sharded megakernel in interpret mode."""
    if jax:
        sim = JaxSharded(JaxParameters(), "naive", interpret=True,
                         tuned_lookup=False, **kw)
    else:
        sim = ShardedSimulation(Parameters(), "naive", device="cpu",
                                tuned_lookup=False, **kw)
    species = sim.make_species(u.shape)
    species.storage = sim.build_storage(u, v)
    sim.perform_steps(species, steps)
    return species.uv_host()


#: K7's newly compiled tiles: (domain, mesh, pins) that resolve to them
K7_JAX = [((72, 264), (2, 2), dict(block_rows=32, block_cols=128)),
          ((72, 528), (1, 4), dict(block_rows=64, block_cols=128))]


@pytest.mark.parametrize("shape,mesh,pins", K7_JAX)
def test_compiled_k7_tiles_match_jax(shape, mesh, pins):
    """A time block of 3 steps at each of K7's compiled tiles: the shard's
    geometry is compiled, and the port's run lies within 1e-6 of JAX's
    sharded megakernel in interpret mode on the same pins and mesh."""
    g = k7_tiles(shape, mesh, pins["block_rows"], pins["block_cols"])
    assert (g.tr, g.tc) in geometry.SHARDED_FIXED_PINS
    assert geometry.mega_pin_launch(g, True).sizes == "compiled"
    kw = dict(pins, engine="mega", n_devices=mesh[0] * mesh[1],
              mesh_cols=mesh[1])
    u, v = random_uv(np.random.RandomState(22), shape)
    for got, want in zip(run_k7(u, v, 3, False, **kw),
                         run_k7(u, v, 3, True, **kw)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
