"""The port's sharded autotuner and its records
(grayscott_tpu_torch/bench/autotune.py: sharded_key, _sharded_candidates,
measure_sharded_config, sharded_autotune, sharded_lookup; the records
``ShardedSimulation`` follows) on the CPU, against the JAX package's: the
key and its pins, the candidates under every pin, ``--autotune --backend
sharded`` (the second run measures nothing), what ``auto`` adopts and what
a pin keeps, ADVICE.md's three faults of the JAX tuner (round 5), and the
platform keys. Every test points ``GRAYSCOTT_CACHE_DIR`` at its own
directory."""

import itertools
import types

import pytest

torch = pytest.importorskip("torch")

from grayscott_tpu.bench import autotune as jax_autotune
from grayscott_tpu.params import Parameters as JaxParameters
from grayscott_tpu_torch.backends.sharded import ShardedSimulation
from grayscott_tpu_torch.bench import autotune, defaults
from grayscott_tpu_torch.cli import shared, simulate
from grayscott_tpu_torch.errors import UnsupportedConfigError
from grayscott_tpu_torch.ops import geometry
from grayscott_tpu_torch.parallel import halo
from grayscott_tpu_torch.params import Parameters
from grayscott_tpu_torch.utils import cache

#: a domain small enough to measure on the CPU: 4 shards on 4x1 or 2x2
SHAPE = (70, 300)
#: one whose shards split for overlap on 2x2 (152x152) and 1x4 is not viable
SPLIT_SHAPE = (300, 300)
#: the card's platform string, as the shipped records key on it
H100 = "h100-80gb-hbm3-sm132"


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
    """An empty store of the test's own, and few steps a measurement (8:
    the candidates at K = 16 run one launch of 8 steps on their layout)."""
    monkeypatch.setenv("GRAYSCOTT_CACHE_DIR", str(tmp_path / "store"))
    monkeypatch.setattr(autotune, "STEPS", 8)
    return tmp_path / "store"


def put(key: str, **record) -> dict:
    rec = {"engine": "windowed", "mesh_cols": 1, "mesh_rows": 4,
           "block_rows": None, "block_cols": None, "steps_per_call": 8,
           "overlap": False, "gcells_per_sec": 1.0, **record}
    entries = cache.load_autotune()
    entries[key] = rec
    cache.save_autotune(entries)
    return rec


def cpu_key(shape=SHAPE, n=4, **pins):
    return autotune.sharded_key(Parameters(), shape, "naive", n_devices=n,
                                device="cpu", **pins)


PINS = [dict(mesh_cols=mc, engine=e, overlap=ov)
        for mc, e, ov in itertools.product((None, 1, 2),
                                           (None, "windowed", "mega"),
                                           (None, True, False))]


@pytest.mark.parametrize("pins", PINS)
def test_key_and_pins_match_jax(pins):
    """The key is the single-card key, then ``|sharded:n{n}`` and each pin,
    with JAX's suffix for the mesh, engine and overlap pins."""
    port = cpu_key(**pins)
    base = autotune.key_for(Parameters(), SHAPE, "naive", device="cpu")
    assert port.startswith(base + "|sharded:n4")
    jax = jax_autotune.sharded_key(JaxParameters(), SHAPE, "naive",
                                   "float32", 4, **pins)
    assert port.split("|sharded", 1)[1] == jax.split("|sharded", 1)[1]


def test_every_pin_keys_its_own_record():
    """Every pin, the K pin and the shard count too, gives a key of its
    own (ADVICE.md #3): a record measured under one never steers another."""
    keys = [cpu_key(**pins) for pins in PINS]
    keys += [cpu_key(steps_per_call=8), cpu_key(n=2),
             cpu_key(shape=(SHAPE[0] + 1, SHAPE[1]))]
    assert len(set(keys)) == len(keys)
    assert cpu_key(steps_per_call=8).endswith(":k8")


@pytest.mark.parametrize("pins", PINS)
@pytest.mark.parametrize("shape,n", [(SHAPE, 4), (SPLIT_SHAPE, 4),
                                     ((1080, 1920), 4), ((4096, 4096), 4),
                                     ((70, 300), 2)])
def test_candidates_honour_every_pin(shape, n, pins):
    """Each candidate runs what the pins allow: the pinned mesh (else each
    viable one), the pinned engine, the pinned overlap (on excludes the
    megakernel), and overlap on only where the split engages on the
    candidate's row tile. Unpinned, each viable mesh has, at K 16 and 8,
    windowed off, windowed on (on JAX's ``tr_ov``) where it engages, and at
    K = 16 windowed on half the default row tile; then mega."""
    cands = autotune._sharded_candidates(shape, n, **pins)
    meshes = ([pins["mesh_cols"]] if pins["mesh_cols"]
              else halo.viable_mesh_cols(shape, n) or [1])
    assert meshes == (
        [pins["mesh_cols"]] if pins["mesh_cols"]
        else jax_autotune._viable_mesh_cols(shape, n))
    want = []
    for nc in meshes:
        r_loc, c_loc = halo.shard_extents(shape, halo.Mesh(n // nc, nc,
                                                           None))
        for k, variant in itertools.product((16, 8), ("off", "on", "half")):
            if pins["engine"] == "mega" or pins["overlap"] not in (
                    None, variant == "on"):
                continue
            if variant == "half" and k == 8:
                continue
            h = max(-(-k // 8) * 8, 8)
            cfg = {"engine": "windowed", "mesh_cols": nc,
                   "steps_per_call": k, "overlap": variant == "on"}
            if variant == "on":
                tr = max(h, -(-shape[0] // (n // nc)) // 3 // 8 * 8)
                try:
                    g = geometry.resolve((r_loc, c_loc), k, tr)
                except UnsupportedConfigError:
                    continue
                if not halo.overlap_engages(r_loc, c_loc, nc,
                                            (g.tr, g.tc), g.halo):
                    continue
                cfg["block_rows"] = tr
            if variant == "half":
                cfg["block_rows"] = geometry.resolve((r_loc, c_loc),
                                                     k).tr // 2
            want.append(cfg)
        if pins["engine"] in (None, "mega") and pins["overlap"] is not True:
            want.append({"engine": "mega", "mesh_cols": nc})
    assert cands == want
    for c in cands:
        assert pins["mesh_cols"] in (None, c["mesh_cols"])
        assert pins["engine"] in (None, c["engine"])
        assert not (pins["overlap"] is True and c["engine"] == "mega")
        assert pins["overlap"] is None or c["engine"] == "mega" or \
            c["overlap"] == pins["overlap"]


def test_default_candidates_of_the_default_run():
    """At 1080x1920 in 4 shards: 4x1, 2x2 and 1x4, each with windowed at
    K = 16 off, on (on JAX's ``tr_ov``, where the split engages: not on
    1x4 at K = 16, whose 360-row tile leaves no window in the shared
    memory) and on the half tile, at K = 8 off and on, and mega: seventeen
    candidates."""
    cands = autotune._sharded_candidates((1080, 1920), 4)
    assert [(c["mesh_cols"], c["engine"], c.get("steps_per_call"),
             c.get("overlap"), c.get("block_rows")) for c in cands] == [
        (1, "windowed", 16, False, None), (1, "windowed", 16, True, 88),
        (1, "windowed", 16, False, 32), (1, "windowed", 8, False, None),
        (1, "windowed", 8, True, 88), (1, "mega", None, None, None),
        (2, "windowed", 16, False, None), (2, "windowed", 16, True, 176),
        (2, "windowed", 16, False, 32), (2, "windowed", 8, False, None),
        (2, "windowed", 8, True, 176), (2, "mega", None, None, None),
        (4, "windowed", 16, False, None), (4, "windowed", 16, False, 32),
        (4, "windowed", 8, False, None), (4, "windowed", 8, True, 360),
        (4, "mega", None, None, None)]


def test_sharded_autotune_measures_ranks_and_persists():
    """Every candidate runs; each result names what ran (the mesh, the
    engine, overlap only where it split); the winner is the fastest; the
    record is keyed on ``cpu`` and carries the K and the row tile that
    ran."""
    before = autotune.measurements
    rec = autotune.sharded_autotune(Parameters(), SPLIT_SHAPE, "naive",
                                    n_devices=4, reps=1, device="cpu")
    table = rec["candidates"]
    cands = autotune._sharded_candidates(SPLIT_SHAPE, 4)
    assert len(table) == len(cands) and autotune.measurements - before >= \
        len(cands)
    for cand, res in zip(cands, table):
        assert (res["engine"], res["mesh_cols"], res["mesh_rows"]) == (
            cand["engine"], cand["mesh_cols"], 4 // cand["mesh_cols"])
        assert res["overlap"] == bool(cand.get("overlap"))
        assert res["block_rows"] == cand.get("block_rows")
        assert res["steps_per_call"] == cand.get("steps_per_call", 8)
    assert any(res["overlap"] for res in table)
    assert rec["gcells_per_sec"] == max(c["gcells_per_sec"] for c in table)
    assert "device_gcells_per_sec" not in rec  # no device time on the CPU
    assert cache.load_autotune() == {
        autotune.sharded_key(Parameters(), SPLIT_SHAPE, "naive",
                             n_devices=4, device="cpu"): rec}


def test_no_candidate_under_the_pins_raises():
    """Overlap on where no shard splits leaves nothing to measure (4 row
    shards of 16 rows: no overlap-interior tile at K 8 or 16, whatever the
    row tile)."""
    with pytest.raises(UnsupportedConfigError, match="no sharded autotune"):
        autotune.sharded_autotune(Parameters(), (64, 300), "naive",
                                  n_devices=4, overlap="on", mesh_cols=1,
                                  device="cpu")


def test_cli_autotune_measures_once_then_follows_the_record(monkeypatch):
    """``--autotune --backend sharded``: the first run measures, the second
    measures nothing; both run the record's engine and mesh."""
    argv = ["--autotune", "--device", "cpu", "-r", str(SHAPE[0]), "-c",
            str(SHAPE[1]), "--backend", "sharded", "--sharded-devices", "4"]
    measured, ran = [], []
    for _ in range(2):
        before = autotune.measurements
        sim = shared.make_simulation(simulate.build_parser().parse_args(
            argv))
        measured.append(autotune.measurements - before)
        species = sim.make_species(SHAPE)
        ran.append((sim.engine, sim.mesh.n_cols, species.storage[0]))
    rec = cache.load_autotune()[cpu_key()]
    assert measured[0] >= len(autotune._sharded_candidates(SHAPE, 4))
    assert measured[1] == 0
    tag = {"windowed": "shwin", "mega": "shmega"}[rec["engine"]] + (
        "2d" if rec["mesh_cols"] > 1 else "")
    assert ran == [(rec["engine"], rec["mesh_cols"], tag)] * 2


@pytest.mark.parametrize("argv,pins", [
    (["--sharded-mesh-cols", "2"], dict(mesh_cols=2)),
    (["--sharded-engine", "windowed"], dict(engine="windowed")),
    (["--sharded-engine", "mega", "--sharded-overlap", "off"],
     dict(engine="mega", overlap=False)),
    (["--sharded-overlap", "on", "--sharded-mesh-cols", "2"],
     dict(mesh_cols=2, overlap=True)),
    (["--pallas-steps-per-call", "8", "--sharded-mesh-cols", "1"],
     dict(mesh_cols=1, steps_per_call=8)),
    (["--pallas-steps-per-call", "16", "--sharded-mesh-cols", "2"],
     dict(mesh_cols=2, steps_per_call=16)),
    (["--pallas-block-rows", "32", "--sharded-mesh-cols", "2"],
     dict(mesh_cols=2, block_rows=32)),
    (["--sharded-engine", "mega", "--pallas-block-cols", "128",
      "--sharded-mesh-cols", "1"],
     dict(mesh_cols=1, engine="mega", block_cols=128)),
])
def test_cli_autotune_forwards_every_pin(argv, pins):
    """ADVICE.md #3: every pin of the command line reaches the candidates
    (each measured one honours it) and the key; the run follows it."""
    shape = SPLIT_SHAPE
    ns = simulate.build_parser().parse_args(
        ["--autotune", "--device", "cpu", "-r", str(shape[0]), "-c",
         str(shape[1]), "--backend", "sharded", "--sharded-devices", "4",
         *argv])
    sim = shared.make_simulation(ns)
    store = cache.load_autotune()
    key = cpu_key(shape=shape, **pins)
    assert list(store) == [key]
    table = store[key]["candidates"]
    assert table
    for res in table:
        assert pins.get("mesh_cols") in (None, res["mesh_cols"])
        assert pins.get("engine") in (None, res["engine"])
        assert pins.get("overlap") is None or res["engine"] == "mega" or \
            res["overlap"] == pins["overlap"]
        for name in ("steps_per_call", "block_rows", "block_cols"):
            assert pins.get(name) in (None, res.get(name))
    sim.make_species(shape)
    assert pins.get("engine") in (None, sim.engine)
    assert pins.get("mesh_cols") in (None, sim.mesh.n_cols)


def test_cli_autotune_refuses_unported_pins_before_measuring():
    """A pin the sharded backend refuses (a column tile on the windowed
    engine, JAX's refusal; another K and the tile pins run since they were
    ported: :func:`test_cli_autotune_forwards_every_pin`; bf16 storage:
    tests/test_torch_bf16.py) stops the run before the tuner measures
    anything."""
    for argv in (["--pallas-block-cols", "128"],
                 ["--sharded-engine", "windowed", "--pallas-block-cols",
                  "256"]):
        before = autotune.measurements
        with pytest.raises(UnsupportedConfigError, match="column layout"):
            shared.make_simulation(simulate.build_parser().parse_args(
                ["--autotune", "--device", "cpu", "--backend", "sharded",
                 *argv]))
        assert autotune.measurements == before
        assert cache.load_autotune() == {}


def test_device_time_is_one_interval_never_a_sum_over_shards(monkeypatch):
    """ADVICE.md #1: a candidate's time is one interval around the whole
    call (the exchange and every launch, on the one card), not a sum over
    the shards: with a clock that advances 1 s a reading, every candidate
    of every mesh has the rate of 1 s a call, whatever its shard count."""
    clock = itertools.count()
    monkeypatch.setattr(autotune, "time", types.SimpleNamespace(
        perf_counter=lambda: float(next(clock))))
    rates = set()
    for n, cols in ((1, 1), (4, 1), (4, 2)):
        for engine in ("windowed", "mega"):
            res = autotune.measure_sharded_config(
                Parameters(), SHAPE, "naive", steps=16, reps=2,
                device="cpu", n_devices=n, engine=engine, mesh_cols=cols)
            rates.add(res["gcells_per_sec"])
    assert rates == {SHAPE[0] * SHAPE[1] * 16 / 1.0 / 1e9}


@pytest.mark.parametrize("pins", [{}, {"steps_per_call": 8},
                                  {"engine": "windowed"}])
def test_record_tile_and_k_never_transfer(pins):
    """ADVICE.md #2: a record's row tile moves into the run only at the
    record's own K. A windowed record of K = 16 and a 16-row tile is
    adopted whole where K is not pinned (JAX's ``_adopt_record``), and
    under a K pin of 8 neither its K nor its tile transfers, where JAX
    adopts the tile; its column tile never reaches the windowed engine.
    Every run runs."""
    key = cpu_key(**{"steps_per_call": pins.get("steps_per_call"),
                     "engine": pins.get("engine")})
    put(key, engine="windowed", mesh_cols=2, block_rows=16, block_cols=128,
        steps_per_call=16, overlap=False)
    sim = ShardedSimulation(Parameters(), device="cpu", n_devices=4, **pins)
    species = sim.make_species(SHAPE)
    assert species.storage[0] == "shwin2d" and sim.mesh.n_cols == 2
    k, g = species.storage[4]
    if "steps_per_call" in pins:
        assert (k, sim.tile_rows, g.tr, g.halo) == (8, None, 64, 8)
    else:
        assert (k, sim.tile_rows, g.tr, g.halo) == (16, 16, 16, 16)
    assert sim.tile_cols is None and g.tc == 64
    sim.perform_steps(species, 9)


@pytest.mark.parametrize("record,pins,want", [
    # auto follows the record's engine, mesh and overlap
    (dict(engine="mega", mesh_cols=1), {}, ("mega", 1, False)),
    (dict(engine="windowed", mesh_cols=2, overlap=True), {},
     ("windowed", 2, True)),
    # a pinned engine wins; the record's overlap transfers only to its
    # own engine and mesh
    (dict(engine="mega", mesh_cols=1), {"engine": "windowed"},
     ("windowed", 1, False)),
    (dict(engine="windowed", mesh_cols=1, overlap=True),
     {"mesh_cols": 2}, ("windowed", 2, False)),
    # overlap pinned on: a mega record is not adopted
    (dict(engine="mega", mesh_cols=2), {"overlap": "on"},
     ("windowed", 2, True)),
    # a pinned overlap off keeps a windowed-on record's engine, not its
    # overlap
    (dict(engine="windowed", mesh_cols=2, overlap=True),
     {"overlap": "off"}, ("windowed", 2, False)),
])
def test_auto_follows_the_record_and_pins_win(record, pins, want):
    """The record under the sim's own pins (its key) fills in what is left
    on ``auto``; ``tuned_lookup=False`` ignores it."""
    sh = SPLIT_SHAPE
    key_pins = {"mesh_cols": pins.get("mesh_cols"),
                "engine": pins.get("engine"),
                "overlap": {"on": True, "off": False}.get(
                    pins.get("overlap"))}
    put(cpu_key(shape=sh, **key_pins), **record)
    sim = ShardedSimulation(Parameters(), device="cpu", n_devices=4, **pins)
    species = sim.make_species(sh)
    assert (sim.engine, sim.mesh.n_cols, sim.overlap_runs(sh)) == want
    assert species.storage[0].startswith(
        {"windowed": "shwin", "mega": "shmega"}[want[0]])
    plain = ShardedSimulation(Parameters(), device="cpu", n_devices=4,
                              tuned_lookup=False, **pins)
    plain.make_species(sh)
    assert plain.engine == ("windowed" if "engine" not in pins
                            else pins["engine"])


def test_local_record_beats_shipped(monkeypatch):
    key = cpu_key()
    shipped = {"engine": "mega", "mesh_cols": 1, "source": "shipped-test"}
    monkeypatch.setitem(defaults.SHARDED, key, shipped)
    assert autotune.sharded_lookup(Parameters(), SHAPE, "naive",
                                   n_devices=4, device="cpu") == shipped
    local = put(key, engine="windowed")
    assert autotune.sharded_lookup(Parameters(), SHAPE, "naive",
                                   n_devices=4, device="cpu") == local


def test_a_cpu_record_never_reaches_the_card(monkeypatch):
    """A record measured on the CPU keys on ``cpu``; the card's key names
    the card, so the card never reads it (and the other way round)."""
    rec = autotune.sharded_autotune(Parameters(), SHAPE, "naive",
                                    n_devices=4, reps=1, device="cpu")
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: types.SimpleNamespace(
                            name="NVIDIA H100 80GB HBM3",
                            multi_processor_count=132))
    card = autotune.sharded_key(Parameters(), SHAPE, "naive", n_devices=4,
                                device="cuda")
    assert card.startswith(f"v{autotune.KERNEL_VERSION}:{H100}:")
    assert card not in cache.load_autotune()
    assert autotune.sharded_lookup(Parameters(), SHAPE, "naive",
                                   n_devices=4, device="cuda") is None
    assert autotune.sharded_lookup(Parameters(), SHAPE, "naive",
                                   n_devices=4, device="cpu") == rec


def test_shipped_sharded_records_name_a_candidate_of_their_key(
        monkeypatch):
    """Each shipped sharded record is keyed on the H100 and names a
    candidate of its key (its mesh, engine and overlap), with K = 8 and no
    tile (K7's default); on the CPU ``auto`` never reads it."""
    assert defaults.SHARDED
    for key, rec in defaults.SHARDED.items():
        base, tail = key.split("|sharded:n")
        _, platform, size, boundary, stencil = base.split(":")
        assert platform == H100 and stencil == "oono-puri"
        n = int(tail)  # no pin: the record of an all-auto run
        shape = tuple(int(x) for x in size.split("x"))
        cands = autotune._sharded_candidates(shape, n)
        assert {k: rec.get(k) for k in ("engine", "mesh_cols")} | (
            {"overlap": rec["overlap"]} if rec["engine"] == "windowed"
            else {}) in cands
        assert rec["steps_per_call"] == 8 and rec["block_rows"] is None
        assert rec["source"].startswith("shipped-h100")
        assert rec["gcells_per_sec"] == rec["device_gcells_per_sec"]
        assert autotune.sharded_lookup(Parameters(), shape, boundary,
                                       n_devices=n, device="cpu") is None
        sim = ShardedSimulation(Parameters(), boundary, device="cpu",
                                n_devices=n)
        sim._adopt_record(shape)
        assert sim.engine == "windowed" and not sim.overlap
