"""Two faults of the port's pins against the JAX reference, each with the
record or the sweep configuration that shows it.

1. An explicit ``steps_per_call`` pin holds ``auto`` to K1 on the unpacked
   layout, whatever a record says, as JAX's ``_explicit_k`` does
   (``grayscott_tpu/backends/pallas.py:83``; ``:438-440``, ``:454``,
   ``:495``, ``:530``, ``:570``); and a record whose engine the
   configuration refuses runs K1 (``:463-465``: a verdict that is not
   ``mega`` means the windowed kernel). JAX's interpret mode always runs
   its windowed kernel, so these cite its lines rather than run it; the
   records are patched in.
2. The port's sweep passes every key the backend runs, under JAX's names
   (``scripts/_sweep_util.py:25-40``), takes ``--dtype``
   (``scripts/sweep.py:45``), converts boolean and integer pins, and files
   a result under the key it ran."""

import json

import pytest

torch = pytest.importorskip("torch")

from grayscott_tpu_torch.backends.cuda import CudaSimulation
from grayscott_tpu_torch.errors import UnsupportedConfigError
from grayscott_tpu_torch.params import Parameters
from grayscott_tpu_torch.scripts import adopt_sweep, parity_check, sweep
from grayscott_tpu_torch.scripts._sweep_util import parse_pins, simulation
from grayscott_tpu_torch.utils import cache

from conftest import random_uv

MAIN = (1080, 1920)
#: the shipped records' verdicts at 1080x1920 (bench/defaults.py): K3 on
#: the naive boundary, the packed K6 on the zero boundary
K3_RECORD = {"engine": "resident", "pack": False}
K6_RECORD = {"engine": "mega", "pack": True}


def patched(monkeypatch, record, boundary, **kwargs):
    sim = CudaSimulation(Parameters(), boundary, device="cpu", **kwargs)
    monkeypatch.setattr(sim, "tuned", lambda shape: dict(record))
    return sim


@pytest.mark.parametrize("boundary,record,without", [
    ("naive", K3_RECORD, (False, "resident")),
    ("zero", K6_RECORD, (True, "mega")),
])
def test_k_pin_holds_auto_to_unpacked_k1(monkeypatch, boundary, record,
                                         without):
    """Without the pin the record decides; with ``steps_per_call=8`` auto
    runs K1 unpacked (JAX: no mega, resident or packed layout under
    ``_explicit_k``)."""
    assert patched(monkeypatch, record, boundary).layout_for(MAIN) == without
    sim = patched(monkeypatch, record, boundary, steps_per_call=8)
    assert sim.layout_for(MAIN) == (False, "windowed")


@pytest.mark.parametrize("pins,want", [
    ({"engine": "mega"}, (False, "mega")),
    ({"resident": "on"}, (False, "resident")),
    ({"pack": "on"}, (True, "windowed")),
    ({"pack": "on", "engine": "mega"}, (True, "mega")),
])
def test_k_pin_keeps_the_other_pins(monkeypatch, pins, want):
    """A K pin beside an explicit pin: the pin names its kernel, as in JAX
    (``_use_resident`` on 'on'; ``_build_packed`` runs K4 under a K pin
    unless the engine is pinned to mega)."""
    sim = patched(monkeypatch, K6_RECORD, "zero", steps_per_call=8, **pins)
    assert sim.layout_for(MAIN) == want


def test_k_pin_storage_runs_k1(monkeypatch, rng):
    u, v = random_uv(rng, (24, 32))
    sim = patched(monkeypatch, K3_RECORD, "naive", steps_per_call=8)
    storage = sim.build_storage(u, v)
    assert storage[0] == "windowed"
    plain = CudaSimulation(Parameters(), "naive", device="cpu",
                           engine="windowed", tuned_lookup=False)
    got = sim.extract_uv(sim.run_steps(storage, u.shape, 9), u.shape)
    want = plain.extract_uv(plain.run_steps(plain.build_storage(u, v),
                                            u.shape, 9), u.shape)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("boundary,kwargs", [
    ("zero", {"resident": "off"}),
    ("naive", {"resident": "off"}),
    ("naive", {"naive_fold": True}),
    ("naive", {"naive_fix": "store"}),
    ("naive", {"dtype": "bfloat16"}),
])
def test_refused_verdict_runs_k1(monkeypatch, boundary, kwargs):
    """A ``resident`` record under a configuration that refuses K3 runs K1
    (JAX: ``_use_resident`` declines, and ``_use_mega`` reads a verdict
    that is not mega as the windowed kernel); before, the port fell back
    to its ranking, which on the zero boundary in L2 is K2."""
    sim = patched(monkeypatch, K3_RECORD, boundary, **kwargs)
    assert sim.layout_for(MAIN) == (False, "windowed")
    # an accepted verdict is still followed
    assert patched(monkeypatch, {"engine": "mega", "pack": False}, boundary,
                   **kwargs).layout_for(MAIN) == (False, "mega")


@pytest.mark.parametrize("text,want", [
    ("", {}),
    ("engine=mega:pack=on", {"engine": "mega", "pack": "on"}),
    ("naive_fold=off", {"naive_fold": False}),
    ("naive_fold=on", {"naive_fold": True}),
    ("nfold=true:rt=0:spec=False", {"nfold": True, "rt": False,
                                    "spec": False}),
    ("depth=4:k=8:tr=64:tc=128", {"depth": 4, "k": 8, "tr": 64, "tc": 128}),
    ("mega_depth=3:steps_per_call=8", {"mega_depth": 3,
                                       "steps_per_call": 8}),
    ("fold=off", {"fold": "off"}),
    ("fold=auto", {"fold": "auto"}),
    ("fold=2", {"fold": 2}),
    ("dtype=bfloat16:fix=store", {"dtype": "bfloat16", "fix": "store"}),
    ("n_devices=4:mesh_cols=1:overlap=on", {"n_devices": 4, "mesh_cols": 1,
                                            "overlap": "on"}),
])
def test_parse_pins_converts(text, want):
    assert parse_pins(text) == want


@pytest.mark.parametrize("text", ["naive_fold=maybe", "nfold=", "depth=four",
                                  "k=8.5", "fold=wide", "engine"])
def test_parse_pins_refuses_what_it_cannot_convert(text):
    with pytest.raises(ValueError):
        parse_pins(text)


def test_parity_check_naive_fold_off_runs_the_exact_path():
    """``cuda:naive_fold=off`` was the truthy string "off", which ran the
    fold."""
    name, pins = parity_check.parse_backend("cuda:naive_fold=off")
    sim = CudaSimulation(Parameters(), device="cpu", **pins)
    assert name == "cuda" and sim.naive_fold is False
    assert sim.step_consts is sim.consts


@pytest.mark.parametrize("cfg,kw,value", [
    ({"dtype": "bfloat16"}, "dtype", "bfloat16"),
    ({"fix": "slice"}, "naive_fix", "slice"),
    ({"nfold": True}, "naive_fold", True),
    ({"k": 8}, "_explicit_k", True),
    ({"k": 16}, "steps_per_call", 16),
    ({"tr": 64}, "block_rows", 64),
    ({"tc": 128}, "block_cols", 128),
    ({"depth": 5}, "mega_depth", 5),
    ({"spec": True}, "mega_specialize", True),
    ({"fold": 1}, "engine", "auto"),
    ({"rt": False}, "engine", "auto"),
])
def test_every_key_reaches_the_backend(cfg, kw, value):
    sim = simulation(dict(cfg, boundary="naive"), device="cpu")
    assert getattr(sim, kw) == value


@pytest.mark.parametrize("cfg,item,error", [
    ({"k": 33}, "steps_per_call must be in", ValueError),
    ({"fold": 2, "resident": "on"}, "pinned lane fold conflict",
     UnsupportedConfigError),
    ({"tc": 128, "pack": "on", "boundary": "zero"}, "no fold/column tiling",
     UnsupportedConfigError),
    ({"fold": 2, "dtype": "bfloat16"}, "fold excludes bf16 storage",
     UnsupportedConfigError),
    ({"limit": 1 << 20}, "limit", UnsupportedConfigError),
    ({"dtype": "bfloat16", "resident": "on"}, "float32",
     UnsupportedConfigError),
])
def test_backend_refuses_the_rest(cfg, item, error):
    """What the backend does not run raises :class:`UnsupportedConfigError`
    with JAX's message; a K outside 1..32 raises JAX's plain
    ``ValueError``."""
    with pytest.raises(error, match=item) as info:
        simulation({"boundary": "naive", **cfg}, device="cpu")
    assert type(info.value) is error


@pytest.fixture
def store(monkeypatch, tmp_path):
    monkeypatch.setenv("GRAYSCOTT_CACHE_DIR", str(tmp_path / "store"))


def test_bf16_fold_config_runs_and_files_under_its_key(store, capsys,
                                                       tmp_path):
    """ROADMAP's case: ``{"dtype": "bfloat16", "nfold": true, "boundary":
    "naive"}`` at 32x32 ran float32 K3 and was filed under the bf16 key.
    Now it runs bf16 storage and the fold (auto: K1), ``ran`` says so, and
    adopt_sweep files it under the key it ran."""
    assert sweep.main(["--device", "cpu", "--shape", "32x32", "--steps",
                       "8", "--boundary", "naive", "--json",
                       '[{"dtype": "bfloat16", "nfold": true}]']) == 0
    out = capsys.readouterr().out
    (line,) = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
    res = json.loads(line[len("RESULT "):])
    assert res["ran"] == {"engine": "windowed", "pack": False,
                          "dtype": "bfloat16", "nfold": True, "depth": None,
                          "fold": 1}
    log = tmp_path / "sweep.log"
    log.write_text(out)
    assert adopt_sweep.main([str(log), "--platform", "p"]) == 0
    (key,) = cache.load_autotune()
    assert key == "v1:p:32x32:naive:oono-puri:bfloat16"


def test_dtype_flag_sets_every_config(store, capsys):
    """``--dtype`` reaches every configuration; ``k=16``, the megakernel's
    tile pin and the window ring at a pinned tile, refused until they were
    ported, run; the lane fold is refused with bf16 storage, as JAX
    refuses it (the sweep goes on)."""
    assert sweep.main(["--device", "cpu", "--shape", "24x32", "--steps",
                       "8", "--boundary", "naive", "--dtype", "bfloat16",
                       "--configs", "engine=mega:depth=4", "nfold=on",
                       "engine=windowed:k=16", "engine=mega:tr=32",
                       "engine=mega:tr=32:depth=4", "fold=2"]) == 0
    lines = capsys.readouterr().out.splitlines()
    results = [json.loads(ln[len("RESULT "):]) for ln in lines
               if ln.startswith("RESULT ")]
    errors = [json.loads(ln) for ln in lines if ln.startswith("{")]
    bf16 = {"pack": False, "dtype": "bfloat16", "fold": 1}
    assert [r["ran"] for r in results] == [
        {"engine": "mega", "nfold": False, "depth": 4, **bf16},
        {"engine": "windowed", "nfold": True, "depth": None, **bf16},
        {"engine": "windowed", "nfold": False, "depth": None, **bf16},
        {"engine": "mega", "nfold": False, "depth": None, **bf16},
        {"engine": "mega", "nfold": False, "depth": 4, **bf16}]
    assert all(r["config"]["dtype"] == "bfloat16" for r in results)
    assert len(errors) == 1 and "fold excludes bf16" in errors[0]["error"]
