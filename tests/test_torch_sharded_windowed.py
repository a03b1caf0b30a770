"""The port's windowed sharded engine on the CPU: K1 on the shard layout
(grayscott_tpu_torch/ops/windowed.py:shard_multistep), its plain version
through the ``sharded`` backend against the numpy oracle (bitwise) and
against JAX's ``ShardedSimulation(engine="windowed")`` in TPU interpret mode
(1e-6), the overlap split (``--sharded-overlap``) against the serialized
run (bitwise), the overlap geometry (parallel/halo.py:overlap_tiles,
overlap_engages), ``engine="auto"``, resume, the harness, and the refusal of
a multi-process run. The CUDA kernel is held against its plain version on
the card by tests/test_torch_gpu.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from grayscott_tpu import oracle
from grayscott_tpu.backends.sharded import ShardedSimulation as JaxSharded
from grayscott_tpu_torch.backends import sharded as sharded_backend
from grayscott_tpu_torch.backends.sharded import ShardedSimulation
from grayscott_tpu_torch.bench import harness
from grayscott_tpu_torch.cli import shared, simulate
from grayscott_tpu_torch.errors import UnsupportedConfigError
from grayscott_tpu_torch.ops import sharded_mega, windowed
from grayscott_tpu_torch.parallel import halo
from grayscott_tpu_torch.params import Parameters, kernel_constants
from grayscott_tpu_torch.species import Species

from conftest import random_uv
from test_torch_sharded import LAYOUTS

#: layouts whose shards have overlap-interior tiles (the split engages):
#: 2x1, 1x2, 2x2 and 3x1, ragged against the tiles
OVERLAP_LAYOUTS = [
    ((300, 40), 2, 1),    # 152-row shards: tile row 1 inside
    ((150, 300), 2, 2),   # 1x2: 152 x 152
    ((290, 300), 4, 2),   # 2x2: 152 x 152
    ((420, 30), 3, 1),    # 3x1: 144-row shards
]


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


@pytest.fixture
def parts(monkeypatch):
    """The parts of every shard_multistep call the backend makes."""
    calls = []
    real = windowed.shard_multistep

    def spy(*args, part="all", **kwargs):
        calls.append(part)
        return real(*args, part=part, **kwargs)

    monkeypatch.setattr(windowed, "shard_multistep", spy)
    return calls


def run_port(u, v, boundary, steps, n, cols, params=None, **kwargs):
    sim = ShardedSimulation(params or Parameters(), boundary, device="cpu",
                            n_devices=n, mesh_cols=cols, tuned_lookup=False,
                            **{"engine": "windowed", **kwargs})
    species = Species(u.shape, sim.build_storage(u, v), sim)
    sim.perform_steps(species, steps)
    return species, species.uv_host()


@pytest.mark.parametrize("steps", [8, 13, 27])
@pytest.mark.parametrize("boundary", ["naive", "zero"])
@pytest.mark.parametrize("shape,n,cols", LAYOUTS)
def test_plain_windowed_equals_oracle(rng, params, shape, n, cols, boundary,
                                      steps):
    """The plain windowed engine through the backend is the oracle bit for
    bit: one block, a block and a remainder, an odd block count."""
    u, v = random_uv(rng, shape)
    species, (gu, gv) = run_port(u, v, boundary, steps, n, cols)
    assert species.storage[0] == ("shwin" if cols == 1 else "shwin2d")
    assert species.storage[3] == -(-steps // windowed.K) % 2
    ou, ov = oracle.run(u, v, params, steps, boundary)
    np.testing.assert_array_equal(gu, ou)
    np.testing.assert_array_equal(gv, ov)


@pytest.mark.parametrize("jax_overlap", [False, True])
@pytest.mark.parametrize("boundary", ["naive", "zero"])
@pytest.mark.parametrize("shape,n,cols", [((96, 16), 4, 1),
                                          ((96, 144), 4, 2)])
def test_plain_windowed_matches_jax_windowed(rng, params, shape, n, cols,
                                             boundary, jax_overlap):
    """Against JAX's windowed sharded engine in TPU interpret mode (K = 8,
    8-row tiles, overlap off and on: its three- and five-slab splits
    engage at these shapes), 16 steps, 4x1 and 2x2. atol 1e-6, the
    tolerance of the mega test (tests/test_torch_sharded.py) and of JAX's
    own sharded tests against the oracle; the port runs with overlap on
    too (serialized here: its shards have no 64x64 interior tile)."""
    u, v = random_uv(rng, shape)
    sim = JaxSharded(params, boundary=boundary, engine="windowed",
                     n_devices=n, mesh_cols=cols, interpret=True,
                     block_rows=8, steps_per_call=8, overlap=jax_overlap,
                     tuned_lookup=False)
    species = sim.make_species(shape)
    species.storage = sim.build_storage(u, v)
    assert species.storage[0] == "windowed"
    sim.perform_steps(species, 16)
    ju, jv = species.uv_host()
    for overlap in ("off", "on"):
        _, (pu, pv) = run_port(u, v, boundary, 16, n, cols, overlap=overlap)
        np.testing.assert_allclose(pu, ju, rtol=0, atol=1e-6)
        np.testing.assert_allclose(pv, jv, rtol=0, atol=1e-6)


@pytest.mark.parametrize("steps", [16, 27])
@pytest.mark.parametrize("boundary", ["naive", "zero"])
@pytest.mark.parametrize("shape,n,cols", OVERLAP_LAYOUTS)
def test_overlap_on_equals_off(rng, params, parts, shape, n, cols, boundary,
                               steps):
    """With the split engaged each block makes an interior and an edge
    call; the result is the serialized run's, 0.0, and the oracle's."""
    u, v = random_uv(rng, shape)
    _, (su, sv) = run_port(u, v, boundary, steps, n, cols, overlap="off")
    blocks = -(-steps // windowed.K)
    assert parts == ["all"] * blocks
    parts.clear()
    _, (ou, ov) = run_port(u, v, boundary, steps, n, cols, overlap="on")
    assert parts == ["interior", "edge"] * blocks
    np.testing.assert_array_equal(ou, su)
    np.testing.assert_array_equal(ov, sv)
    np.testing.assert_array_equal(ov, oracle.run(u, v, params, steps,
                                                 boundary)[1])


def _exchanged(rng, shape, n, cols, slot):
    u, v = random_uv(rng, shape)
    mesh = halo.make_mesh(n, cols, "cpu")
    pairs = halo.mega_shard_state(u, v, mesh)
    for p in pairs:
        if slot:
            p[:, :, 1] = p[:, :, 0]
            p[:, :, 0] = 0.0
        halo.exchange_halos(p, slot)
    return mesh, pairs


@pytest.mark.parametrize("slot", [0, 1])
@pytest.mark.parametrize("shape,n,cols", OVERLAP_LAYOUTS)
def test_interior_part_independent_of_the_halos(rng, shape, n, cols, slot):
    """The overlap-interior part reads no halo cell: with the halos of the
    source slot poisoned with NaN its cells come out as with valid halos,
    and it writes no other cell. The two parts together are the whole
    call, bit for bit (the counterpart of JAX's
    test_overlap_interior_kernel_independent_of_permutes)."""
    consts = kernel_constants(Parameters())
    mesh, (up, vp) = _exchanged(rng, shape, n, cols, slot)
    r_loc, c_loc, ch = halo.interior_extents(up)
    h = halo.HALO
    inner = windowed.part_mask(r_loc, c_loc, ch, "interior")
    assert inner.any() and not inner.all()
    whole = [p.clone() for p in (up, vp)]
    windowed.shard_multistep(*whole, mesh, slot, 8, consts, "naive", shape)
    split = [p.clone() for p in (up, vp)]
    poisoned = [p.clone() for p in (up, vp)]
    for p in poisoned:
        keep = p[:, :, slot, h:h + r_loc, ch:ch + c_loc].clone()
        p[:, :, slot] = float("nan")
        p[:, :, slot, h:h + r_loc, ch:ch + c_loc] = keep
        p[:, :, 1 - slot] = -1.0
    windowed.shard_multistep(*poisoned, mesh, slot, 8, consts, "naive",
                             shape, part="interior")
    windowed.shard_multistep(*split, mesh, slot, 8, consts, "naive", shape,
                             part="interior")
    windowed.shard_multistep(*split, mesh, slot, 8, consts, "naive", shape,
                             part="edge")
    for got, split_p, want in zip(poisoned, split, whole):
        assert torch.equal(split_p, want)
        out = got[:, :, 1 - slot, h:h + r_loc, ch:ch + c_loc]
        ref = want[:, :, 1 - slot, h:h + r_loc, ch:ch + c_loc]
        assert torch.equal(out[:, :, inner], ref[:, :, inner])
        assert bool((out[:, :, ~inner] == -1.0).all())
        assert bool((got[:, :, 1 - slot, :h] == -1.0).all())


def brute_overlap_tiles(r_loc, c_loc, chalo):
    """The tiles whose window lies in the shard's interior rows (and
    columns on a 2-D mesh), by enumeration."""
    t, h = halo.WINDOWED_TILE, halo.HALO
    return {(i, j) for i in range(-(-r_loc // t)) for j in range(-(-c_loc // t))
            if i * t - h >= 0 and i * t + t + h <= r_loc
            and (not chalo or (j * t - h >= 0 and j * t + t + h <= c_loc))}


@pytest.mark.parametrize("shape,n,cols", LAYOUTS + OVERLAP_LAYOUTS + [
    ((1080, 1920), 4, 1), ((1080, 1920), 4, 2), ((1080, 1920), 4, 4),
    ((4096, 4096), 4, 2), ((128, 40), 1, 1), ((136, 40), 1, 1),
    ((272, 135), 4, 2)])
def test_overlap_engages_agrees_with_what_runs(rng, parts, shape, n, cols):
    """``overlap_engages`` is true exactly where ``overlap_tiles`` finds a
    tile (checked against an enumeration), and where it is, an overlap run
    makes the split calls; elsewhere it runs serialized."""
    mesh = halo.make_mesh(n, cols, "cpu")
    r_loc, c_loc = halo.shard_extents(shape, mesh)
    ti0, ti1, tj0, tj1 = halo.overlap_tiles(r_loc, c_loc, mesh.chalo)
    want = brute_overlap_tiles(r_loc, c_loc, mesh.chalo)
    assert {(i, j) for i in range(ti0, ti1) for j in range(tj0, tj1)} \
        == want
    engages = halo.overlap_engages(r_loc, c_loc, cols)
    assert engages == bool(want)
    sim = ShardedSimulation(Parameters(), "zero", device="cpu", n_devices=n,
                            mesh_cols=cols, engine="windowed", overlap="on",
                            tuned_lookup=False)
    assert sim.overlap_runs(shape) == engages
    if shape[0] * shape[1] <= 300 * 300:
        species = Species(shape, sim.build_storage(*random_uv(rng, shape)),
                          sim)
        sim.perform_steps(species, 3)
        assert parts == (["interior", "edge"] if engages else ["all"])


@pytest.mark.parametrize("engine", ["windowed", "mega"])
def test_resume_across_the_sharded_engine(tmp_path, engine):
    """5 images straight == 3 images + --checkpoint + 2 images --resume,
    bit for bit, with an odd block count at the split (the windowed
    engine's state ends in slot 1): ``uv_host`` and ``build_storage``
    carry the state across."""
    h5py = pytest.importorskip("h5py")
    common = ["-r", "300", "-c", "40", "-e", "8", "--device", "cpu",
              "--backend", "sharded", "--sharded-devices", "2",
              "--sharded-engine", engine]
    if engine == "windowed":
        common += ["--sharded-overlap", "on"]
    full, a, b, ck = (tmp_path / f"{n}.h5" for n in ("full", "a", "b", "ck"))
    assert simulate.main(common + ["-n", "5", "-o", str(full)]) == 0
    assert simulate.main(common + ["-n", "3", "-o", str(a), "--checkpoint",
                                   str(ck)]) == 0
    assert simulate.main(common + ["-n", "2", "-o", str(b), "--resume",
                                   str(ck)]) == 0
    with h5py.File(full, "r") as f_full, h5py.File(b, "r") as f_b:
        np.testing.assert_array_equal(f_b["matrix"][:],
                                      f_full["matrix"][3:])


def test_resumed_storage_equals_straight_run(rng):
    """The in-memory part of --resume: 3 blocks, ``uv_host``, a new
    ``build_storage``, 2 blocks == 5 blocks straight, 0.0."""
    u, v = random_uv(rng, (300, 300))
    sim = ShardedSimulation(Parameters(), "naive", device="cpu", n_devices=4,
                            engine="windowed", overlap="on",
                            tuned_lookup=False)
    straight = Species(u.shape, sim.build_storage(u, v), sim)
    sim.perform_steps(straight, 40)
    first = Species(u.shape, sim.build_storage(u, v), sim)
    sim.perform_steps(first, 24)
    assert first.storage[3] == 1
    second = Species(u.shape, sim.build_storage(*first.uv_host()), sim)
    assert second.storage[3] == 0
    sim.perform_steps(second, 16)
    for got, want in zip(second.uv_host(), straight.uv_host()):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("flags", [
    [],                                                  # auto: windowed
    ["--sharded-engine", "windowed"],
    ["--sharded-overlap", "on"],
    ["--sharded-engine", "windowed", "--sharded-overlap", "on",
     "--sharded-mesh-cols", "1"],
    ["--sharded-engine", "windowed", "--sharded-mesh-cols", "2"],
])
def test_simulate_windowed_equals_cuda_backend_on_cpu(parts, flags):
    """``simulate --backend sharded --sharded-devices 4 --device cpu``
    with no engine pin (no record: windowed), pinned, and with overlap:
    every frame equal to the ``cuda`` backend's CPU run (9 steps an image:
    one full and one remainder block)."""
    frames, tags = {}, {}
    for backend in (["--backend", "sharded", "--sharded-devices", "4",
                     *flags], []):
        ns = simulate.build_parser().parse_args(
            ["-r", "300", "-c", "300", "--device", "cpu", *backend])
        sim = shared.make_simulation(ns)
        species = sim.make_species(shared.domain_shape(ns))
        tags[sim.name] = species.storage[0]
        if sim.name == "sharded":
            split = sim.overlap_runs(species.shape)
        frames[sim.name] = []
        simulate.run(sim, species, 3, 9, frames[sim.name].append)
    one_d = flags[-1:] == ["1"]
    assert tags["sharded"] == ("shwin" if one_d else "shwin2d")
    # 2x2: 152x152 shards split; 4x1: 80-row shards have no interior tile
    assert split == ("--sharded-overlap" in flags and not one_d)
    assert parts == (["interior", "edge"] if split else ["all"]) * 6
    for got, want in zip(frames["sharded"], frames["cuda"]):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("engine", ["windowed", "mega"])
def test_harness_sweeps_either_engine(engine):
    """``harness --backends sharded --engine windowed|mega`` runs."""
    results = harness.sweep(["sharded"], domains=[(24, 32)],
                            step_counts=[9], reps=2, verbose=False,
                            backend_kwargs={"engine": engine},
                            device="cpu")
    assert [(r.backend, r.extra["engine"]) for r in results] == [
        ("sharded", engine)]
    assert results[0].gcells_per_sec > 0


def test_cpu_calls_do_not_count_as_launches(rng):
    before = (windowed.shard_launches, windowed.launches,
              sharded_mega.launches)
    run_port(*random_uv(rng, (300, 300)), "zero", 19, 4, 2, overlap="on")
    assert (windowed.shard_launches, windowed.launches,
            sharded_mega.launches) == before


@pytest.mark.parametrize("kind", [
    "slot", "part", "steps_over", "steps_zero", "wrong_shape", "boundary",
    "other_device"])
def test_shard_multistep_rejects_bad_arguments(kind):
    shape = (40, 300)
    mesh = halo.make_mesh(4, 2, "cpu")
    up, vp = halo.mega_shard_state(np.zeros(shape, np.float32),
                                   np.ones(shape, np.float32), mesh)
    args = dict(src_slot=0, steps=8, boundary="zero", part="all")
    if kind == "slot":
        args["src_slot"] = 2
    elif kind == "part":
        args["part"] = "middle"
    elif kind == "steps_over":
        args["steps"] = 9
    elif kind == "steps_zero":
        args["steps"] = 0
    elif kind == "wrong_shape":
        shape = (80, 300)
    elif kind == "boundary":
        args["boundary"] = "periodic"
    elif kind == "other_device":
        mesh = halo.Mesh(2, 2, torch.device("cuda"))
    before = (up.clone(), windowed.shard_launches)
    with pytest.raises(ValueError):
        windowed.shard_multistep(up, vp, mesh, args["src_slot"],
                                 args["steps"], kernel_constants(Parameters()),
                                 args["boundary"], shape, part=args["part"])
    assert torch.equal(up, before[0])
    assert windowed.shard_launches == before[1]


@pytest.mark.parametrize("kwargs,item", [
    # the K and row tile run since they were ported
    # (tests/test_torch_sharded_pins.py); a shard thinner than its halo,
    # and a window past the shared memory, do not (built at 64x2048, the
    # second at 512x64)
    ({"engine": "windowed", "steps_per_call": 16, "n_devices": 8,
      "mesh_cols": 1}, "thinner than their 16 halo rows"),
    ({"engine": "windowed", "steps_per_call": 32, "block_rows": 256,
      "n_devices": 1}, "B of shared memory"),
    ({"steps_per_call": 24, "n_devices": 4, "mesh_cols": 1},
     "thinner than their 24 halo rows"),
    ({"engine": "windowed", "block_cols": 128}, "column layout"),
    ({"block_cols": 128}, "column layout"),
])
def test_windowed_refusals_name_their_item(kwargs, item):
    shape = (512, 64) if kwargs.get("block_rows") else (64, 2048)
    with pytest.raises(UnsupportedConfigError, match=item):
        sim = ShardedSimulation(Parameters(), device="cpu", **kwargs)
        sim.make_species(shape)


@pytest.mark.parametrize("kwargs", [{"engine": "windowed",
                                     "dtype": "bfloat16"},
                                    {"dtype": "bfloat16"}])
def test_windowed_engine_runs_bf16(rng, kwargs):
    """bf16 storage, which the windowed engine refused until it was
    ported: the windowed engine runs it (no record: ``auto`` is windowed),
    with overlap off and on, bit for bit the oracle rounded to bfloat16
    once a block (tests/test_torch_bf16.py:oracle_bf16)."""
    from test_torch_bf16 import oracle_bf16

    shape = (300, 40)  # 2x1: the overlap split engages
    u, v = random_uv(rng, shape)
    want = oracle_bf16(u, v, Parameters(), 19, "zero")
    for overlap in ("off", "on"):
        species, got = run_port(u, v, "zero", 19, 2, 1, overlap=overlap,
                                **{"engine": "auto", **kwargs})
        assert species.storage[0] == "shwin"
        assert species.storage[1].dtype == torch.bfloat16
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


#: the ROADMAP.md items the port has done: a pin of theirs runs
PORTED = ("Queue 2 item 4", "Queue 2 item 12")


@pytest.mark.parametrize("argv,item", [
    (["--pallas-dtype", "bfloat16"], "Queue 2 item 4"),
    (["--pallas-steps-per-call", "16"], "Queue 2 item 12"),
    (["--pallas-block-rows", "64"], "Queue 2 item 12"),
])
def test_cli_pins_reach_the_sharded_backend(argv, item):
    """The ``--pallas-*`` pins reach the sharded backend, as in JAX
    (``args_from_namespace``), and it runs them: bf16 storage, the
    windowed engine's K and row tile (each an item the port has done)."""
    ns = simulate.build_parser().parse_args(
        ["--device", "cpu", "--backend", "sharded", *argv])
    assert item in PORTED
    sim = shared.make_simulation(ns)
    species = sim.make_species((64, 64))
    sim.perform_steps(species, 17)
    assert (sim.dtype, sim.steps_per_call, sim.tile_rows) == {
        "--pallas-dtype": ("bfloat16", 8, None),
        "--pallas-steps-per-call": ("float32", 16, None),
        "--pallas-block-rows": ("float32", 8, 64)}[argv[0]]


@pytest.mark.parametrize("value", ["localhost:1234", "auto"])
def test_coordinator_is_refused(monkeypatch, value):
    """``make_simulation`` and ``livesim``'s set-up start no process group
    with ``GRAYSCOTT_COORDINATOR`` set, as JAX's ``livesim`` ignores it
    (``grayscott_tpu/cli/livesim.py:84``): ``simulate.main`` alone joins
    the group (``utils/distributed.py``), so ``livesim`` and the bench run
    one process and wait for no peer."""
    import torch.distributed as dist

    from grayscott_tpu_torch.cli import livesim

    monkeypatch.setenv("GRAYSCOTT_COORDINATOR", value)
    monkeypatch.setenv("GRAYSCOTT_NUM_PROCESSES", "2")
    monkeypatch.setenv("GRAYSCOTT_PROCESS_ID", "0")
    ns = simulate.build_parser().parse_args(["--device", "cpu"])
    assert shared.make_simulation(ns).name == "cuda"
    source = livesim.FrameSource(livesim.build_parser().parse_args(
        ["--device", "cpu", "-r", "16", "-c", "16"]))
    assert source.sim.name == "cuda" and source.species.shape == (16, 16)
    assert not dist.is_initialized()


def test_storage_tags_and_slots(rng):
    """Each engine and mesh form has its tag; the windowed storage carries
    its current slot, which extract_uv reads."""
    assert set(sharded_backend.TAGS.values()) == {
        "shwin", "shwin2d", "shmega", "shmega2d"}
    u, v = random_uv(rng, (40, 300))
    sim = ShardedSimulation(Parameters(), device="cpu", n_devices=4,
                            mesh_cols=2, engine="windowed",
                            tuned_lookup=False)
    storage = sim.run_steps(sim.build_storage(u, v), (40, 300), 5)
    assert storage[0] == "shwin2d" and storage[3] == 1
    got = sim.extract_uv(storage, (40, 300))
    want = (halo.mega_unshard_result(storage[1], (40, 300), 1),
            halo.mega_unshard_result(storage[2], (40, 300), 1))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(sim.extract_result(storage, (40, 300)), want[1])
