"""The port's autotuner and its records (``grayscott_tpu_torch/bench/
autotune.py``, ``bench/defaults.py``, ``utils/cache.py``) on the CPU,
against the JAX package's: the store key, the record schema, ``lookup``'s
precedence and platform keys, what ``auto`` follows, and ``--autotune``.
Every test points ``GRAYSCOTT_CACHE_DIR`` at its own directory, so a
developer's store never leaks in."""

import os
import types

import pytest

torch = pytest.importorskip("torch")

from grayscott_tpu.bench import autotune as jax_autotune
from grayscott_tpu.bench import defaults as jax_defaults
from grayscott_tpu.params import Parameters as JaxParameters
from grayscott_tpu.utils import cache as jax_cache
from grayscott_tpu.utils import runtime as jax_runtime
from grayscott_tpu_torch.backends import cuda as cuda_backend
from grayscott_tpu_torch.backends.base import env_flag
from grayscott_tpu_torch.backends.cuda import CudaSimulation
from grayscott_tpu_torch.bench import autotune, defaults
from grayscott_tpu_torch.cli import shared, simulate
from grayscott_tpu_torch.errors import UnsupportedConfigError
from grayscott_tpu_torch.params import STENCILS, Parameters
from grayscott_tpu_torch.utils import cache
from grayscott_tpu_torch.utils.device import autotune_platform

#: the card's platform string, as the shipped records key on it
H100 = "h100-80gb-hbm3-sm132"

#: a domain small enough to measure on the CPU
SHAPE = (24, 32)


@pytest.fixture(autouse=True)
def store(monkeypatch, tmp_path):
    """An empty store of the test's own, and few steps a measurement."""
    monkeypatch.setenv("GRAYSCOTT_CACHE_DIR", str(tmp_path / "store"))
    monkeypatch.setattr(autotune, "STEPS", 16)
    return tmp_path / "store"


def put(key: str, **record) -> dict:
    rec = {"engine": "windowed", "block_rows": None, "steps_per_call": 8,
           "block_cols": None, "fold": 1, "pack": False,
           "gcells_per_sec": 1.0, **record}
    entries = cache.load_autotune()
    entries[key] = rec
    cache.save_autotune(entries)
    return rec


def cpu_key(shape=SHAPE, boundary="zero", stencil="oono-puri"):
    return autotune.key_for(Parameters.with_stencil(stencil), shape,
                            boundary, device="cpu")


@pytest.mark.parametrize("args", [
    ("cpu", (24, 32), "zero", "oono-puri", 1, "float32"),
    (H100, (1080, 1920), "naive", "oono-puri", 1, "float32"),
    ("v5e", (4096, 4096), "zero", "5points", 4, "bfloat16"),
    (H100, (7, 5), "naive", "pretty", 2, "f32"),
    ("cpu", (3, 9), "zero", "patra-karttunen", 1, None),
])
def test_key_matches_jax(args):
    assert cache.autotune_key(*args) == jax_cache.autotune_key(*args)


def test_store_follows_the_variable_and_writes_atomically(store,
                                                          monkeypatch):
    assert cache.cache_dir() == str(store)
    assert cache.load_autotune() == {}
    cache.save_autotune({"k": {"engine": "mega"}})
    assert cache.load_autotune() == {"k": {"engine": "mega"}}
    assert sorted(os.listdir(store)) == ["autotune.json"]
    monkeypatch.delenv("GRAYSCOTT_CACHE_DIR")
    assert cache.cache_dir() == os.path.join(
        os.path.expanduser("~"), ".cache", "grayscott_tpu_torch")


@pytest.mark.parametrize("name,sms,want", [
    ("NVIDIA H100 80GB HBM3", 132, H100),
    ("NVIDIA H100 PCIe", 114, "h100-pcie-sm114"),
    ("NVIDIA GeForce RTX 4090", 128, "geforce-rtx-4090-sm128"),
])
def test_autotune_platform_names_the_card(monkeypatch, name, sms, want):
    """On the card: the name without the vendor, lowercased, and the SM
    count; never ``gpu`` or ``cuda`` alone. On the CPU: ``cpu``."""
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: types.SimpleNamespace(
                            name=name, multi_processor_count=sms))
    assert autotune_platform("cuda") == want
    assert autotune_platform(torch.device("cuda", 0)) == want
    assert autotune_platform("cpu") == "cpu"


@pytest.fixture(scope="module")
def jax_record_keys():
    """The keys of a record JAX's tuner persists: ``measure_config``'s
    (interpret mode, a tiny run), without the transient ``rank_metric``,
    and the ``candidates`` table."""
    rec = jax_autotune.measure_config(JaxParameters(), (16, 128), "zero",
                                      steps=8, reps=1, block_rows=8,
                                      steps_per_call=8)
    return set(rec) - {"rank_metric"} | {"candidates"}


@pytest.mark.parametrize("boundary", ["naive", "zero"])
def test_autotune_measures_ranks_and_persists(jax_record_keys, boundary):
    """Every candidate runs (the three engines and K1's depth and tile
    candidates; on zero their packed twins and K4's too), the winner is
    the fastest of the table and carries the K and tiles it ran, and the
    persisted record is a superset of JAX's keys, keyed on ``cpu``."""
    before = autotune.measurements
    rec = autotune.autotune(Parameters(), SHAPE, boundary, device="cpu",
                            reps=1)
    table = rec["candidates"]
    assert len(table) == (11 if boundary == "zero" else 6)
    assert autotune.measurements - before >= len(table)
    assert {(c["engine"], c["pack"]) for c in table} == {
        (e, p) for e in ("windowed", "mega", "resident")
        for p in ((False, True) if boundary == "zero" else (False,))}
    assert rec["gcells_per_sec"] == max(c["gcells_per_sec"] for c in table)
    assert jax_record_keys <= set(rec)
    ran = {(c["engine"], c["pack"], c["steps_per_call"], c["block_rows"],
            c["block_cols"]) for c in table}
    assert (rec["engine"], rec["pack"], rec["steps_per_call"],
            rec["block_rows"], rec["block_cols"]) in ran
    assert {c["steps_per_call"] for c in table} == {8, 16}
    assert ("windowed", False, 8, 32, 128) in ran
    assert "device_gcells_per_sec" not in rec  # no device time on the CPU
    assert cache.load_autotune() == {cpu_key(boundary=boundary): rec}


def test_autotune_returns_a_stored_record_without_measuring():
    rec = put(cpu_key(), engine="mega", pack=True)
    before = autotune.measurements
    assert autotune.autotune(Parameters(), SHAPE, "zero",
                             device="cpu") == rec
    assert autotune.measurements == before


@pytest.mark.parametrize("rates,again", [
    ({"windowed": 10.0, "mega": 9.8, "resident": 5.0}, 2),
    ({"windowed": 10.0, "mega": 9.6, "resident": 5.0}, 0),
])
def test_close_call_is_measured_again(monkeypatch, rates, again):
    """When the runner-up is within 3 % of the winner both are measured
    again and the better of each counts, as in JAX; else nothing is."""
    calls = []
    first = len(autotune.default_candidates(Parameters(), "naive",
                                            shape=SHAPE))

    def fake(params, shape, boundary, steps, dtype, reps, device, **cfg):
        engine = "resident" if cfg.get("resident") == "on" else cfg["engine"]
        calls.append(engine)
        bump = 1.05 if len(calls) > first and engine == "mega" else 1.0
        # K1's depth and tile candidates trail far behind
        rate = 1.0 if len(cfg) > 1 else rates[engine]
        return {"engine": engine, "pack": False, "block_rows": None,
                "steps_per_call": 8, "block_cols": None, "fold": 1,
                "gcells_per_sec": rate * bump, "wall_gcells_per_sec": rate}

    monkeypatch.setattr(autotune, "measure_config", fake)
    rec = autotune.autotune(Parameters(), SHAPE, "naive", device="cpu")
    assert len(calls) == first + again
    assert rec["engine"] == ("mega" if again else "windowed")


@pytest.mark.parametrize("stencil", sorted(STENCILS))
@pytest.mark.parametrize("boundary", ["naive", "zero"])
def test_pack_candidates_follow_jax_conditions(stencil, boundary):
    """The packed candidates exactly where JAX's ``_pack_candidates``
    conditions hold: the zero boundary, float32, a separable plan."""
    packs = any(c.get("pack") == "on" for c in autotune.default_candidates(
        Parameters.with_stencil(stencil), boundary))
    jax_params = JaxParameters.with_stencil(stencil)
    assert packs == (boundary == "zero"
                     and jax_params.separable_plan()[0] == "separable")
    assert not any(c.get("pack") for c in autotune.default_candidates(
        Parameters.with_stencil(stencil), boundary, "bfloat16"))


def test_local_record_beats_shipped(monkeypatch):
    key = cpu_key()
    shipped = {"engine": "mega", "pack": True, "source": "shipped-test"}
    monkeypatch.setitem(defaults.SHIPPED, key, shipped)
    assert autotune.lookup(Parameters(), SHAPE, "zero", device="cpu") \
        == shipped
    local = put(key, engine="resident", pack=False)
    assert autotune.lookup(Parameters(), SHAPE, "zero",
                           device="cpu") == local


def test_record_of_another_platform_is_never_used():
    put(cache.autotune_key(H100, SHAPE, "zero", "oono-puri",
                           autotune.KERNEL_VERSION), engine="mega",
        pack=True)
    put(cache.autotune_key("cpu", SHAPE, "zero", "oono-puri",
                           autotune.KERNEL_VERSION + 1), engine="mega",
        pack=True)
    assert autotune.lookup(Parameters(), SHAPE, "zero", device="cpu") is None
    sim = CudaSimulation(Parameters(), "zero", device="cpu")
    assert sim.layout_for(SHAPE) == (False, cuda_backend.auto_engine(
        SHAPE, "zero"))


def test_shipped_records_are_the_cards_and_never_reach_the_cpu():
    """The four configurations of the default and the bench run, keyed on
    the H100; each a superset of JAX's shipped records' keys, with its
    source. On the CPU, ``auto`` at those shapes never reads them."""
    want = {cache.autotune_key(H100, shape, boundary, "oono-puri",
                               autotune.KERNEL_VERSION)
            for shape in ((1080, 1920), (4096, 4096))
            for boundary in ("naive", "zero")}
    assert set(defaults.SHIPPED) == want
    jax_keys = set(jax_defaults.SHIPPED["v4:v5e:4096x4096:zero:oono-puri"])
    for key, rec in defaults.SHIPPED.items():
        assert jax_keys <= set(rec), key
        assert rec["source"] == "shipped-h100-pr11"
        assert rec["engine"] in ("windowed", "mega", "resident")
        assert not rec["pack"] or ":zero:" in key
        _, _, size, boundary, _ = key.split(":")
        shape = tuple(int(x) for x in size.split("x"))
        assert autotune.lookup(Parameters(), shape, boundary,
                               device="cpu") is None
        sim = CudaSimulation(Parameters(), boundary, device="cpu")
        assert sim.layout_for(shape) == (
            False, cuda_backend.auto_engine(shape, boundary))


@pytest.mark.parametrize("record,pins,want", [
    # auto follows the record's layout and engine
    ({"engine": "resident", "pack": True}, {}, (True, "resident")),
    ({"engine": "windowed", "pack": False}, {}, (False, "windowed")),
    # an engine record of the other layout says nothing: the ranking
    ({"engine": "resident", "pack": True}, {"pack": "off"},
     (False, "mega")),
    ({"engine": "resident", "pack": False}, {"pack": "on"},
     (True, "mega")),
    # a pin always wins
    ({"engine": "resident", "pack": True}, {"engine": "windowed"},
     (True, "windowed")),
    ({"engine": "mega", "pack": True}, {"resident": "on"},
     (True, "resident")),
    # ... and a record whose engine the pins refuse runs K1, as JAX's
    # verdict that is not mega runs its windowed kernel
    # (grayscott_tpu/backends/pallas.py:463-465)
    ({"engine": "resident", "pack": False}, {"resident": "off"},
     (False, "windowed")),
    # an auto record (a sweep's engine=auto winner) keeps the ranking
    ({"engine": None, "pack": False}, {}, (False, "mega")),
])
def test_auto_follows_the_record_and_pins_win(record, pins, want):
    put(cpu_key(), **record)
    assert CudaSimulation(Parameters(), "zero", device="cpu",
                          **pins).layout_for(SHAPE) == want


def test_a_packed_record_packs_only_what_can_pack():
    """A packed record on a configuration that does not pack (5points has
    no separable plan) keeps the unpacked layout."""
    put(cpu_key(stencil="5points"), engine="mega", pack=True)
    sim = CudaSimulation(Parameters.with_stencil("5points"), "zero",
                         device="cpu")
    assert sim.layout_for(SHAPE)[0] is False


def test_tuned_lookup_false_ignores_the_store():
    put(cpu_key(), engine="resident", pack=True)
    assert CudaSimulation(Parameters(), "zero", device="cpu").make_species(
        SHAPE).storage[0] == "respack"
    sim = CudaSimulation(Parameters(), "zero", device="cpu",
                         tuned_lookup=False)
    assert sim.make_species(SHAPE).storage[0] == cuda_backend.auto_engine(
        SHAPE, "zero")


def test_cli_autotune_measures_once_then_follows_the_record():
    """``--autotune`` measures before the run; a second run finds the
    record and measures nothing; the run follows the record."""
    argv = ["--autotune", "--device", "cpu", "-r", str(SHAPE[0]), "-c",
            str(SHAPE[1]), "--boundary", "zero"]
    measured, tags = [], []
    for _ in range(2):
        before = autotune.measurements
        sim = shared.make_simulation(simulate.build_parser().parse_args(
            argv))
        measured.append(autotune.measurements - before)
        tags.append(sim.make_species(SHAPE).storage[0])
    rec = cache.load_autotune()[cpu_key()]
    assert measured[0] >= 6 and measured[1] == 0
    want = cuda_backend.PACKED_TAGS[rec["engine"]] if rec["pack"] \
        else rec["engine"]
    assert tags == [want, want]


def test_cli_autotune_refuses_sharded_and_skips_the_rungs():
    """``--autotune --backend sharded`` runs the sharded tuner
    (tests/test_torch_sharded_autotune.py); with a pin the sharded backend
    does not run (a column tile on the windowed engine, JAX's refusal; bf16
    storage and the tile and K pins run since they were ported:
    tests/test_torch_bf16.py, tests/test_torch_sharded_pins.py) it is
    refused before anything is measured. The plain rungs ignore
    ``--autotune``."""
    before = autotune.measurements
    ns = simulate.build_parser().parse_args(
        ["--autotune", "--device", "cpu", "--backend", "sharded",
         "--sharded-engine", "windowed", "--pallas-block-cols", "128"])
    with pytest.raises(UnsupportedConfigError, match="column layout"):
        shared.make_simulation(ns)
    assert autotune.measurements == before and cache.load_autotune() == {}
    shared.make_simulation(simulate.build_parser().parse_args(
        ["--autotune", "--device", "cpu", "--backend", "fused"]))
    assert autotune.measurements == before and cache.load_autotune() == {}


@pytest.mark.parametrize("value", [None, "", "0", "false", "No", "off",
                                   "1", "yes", "true", "anything"])
def test_autotune_variable_matches_jax(monkeypatch, value):
    """``GRAYSCOTT_AUTOTUNE`` through ``env_flag``, as JAX reads it."""
    from grayscott_tpu.cli import simulate as jax_simulate

    if value is None:
        monkeypatch.delenv("GRAYSCOTT_AUTOTUNE", raising=False)
    else:
        monkeypatch.setenv("GRAYSCOTT_AUTOTUNE", value)
    assert env_flag("GRAYSCOTT_AUTOTUNE") == \
        jax_runtime.env_flag("GRAYSCOTT_AUTOTUNE")
    assert simulate.build_parser().parse_args([]).autotune == \
        jax_simulate.build_parser().parse_args([]).autotune
