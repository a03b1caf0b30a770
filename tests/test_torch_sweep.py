"""The port's sweep tools on the CPU: ``scripts/sweep.py`` prints a
``RESULT`` line for each configuration, in one process, and
``scripts/adopt_sweep.py`` groups the results and applies the margin as
JAX's ``scripts/adopt_sweep.py`` does on the same lines."""

import copy
import importlib.util
import json
import os

import pytest

torch = pytest.importorskip("torch")

from grayscott_tpu.utils import cache as jax_cache
from grayscott_tpu_torch.bench import stats
from grayscott_tpu_torch.scripts import adopt_sweep, sweep
from grayscott_tpu_torch.utils import cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def store(monkeypatch, tmp_path):
    monkeypatch.setenv("GRAYSCOTT_CACHE_DIR", str(tmp_path / "port"))
    monkeypatch.setattr(jax_cache, "CACHE_DIR", str(tmp_path / "jax"))


def test_sweep_prints_a_result_per_config(capsys):
    assert sweep.main(["--device", "cpu", "--shape", "24x32", "--steps",
                       "8", "--configs", "engine=windowed",
                       "pack=on:engine=mega", "resident=on"]) == 0
    lines = capsys.readouterr().out.splitlines()
    results = [json.loads(ln[len("RESULT "):]) for ln in lines
               if ln.startswith("RESULT ")]
    assert lines[-1] == "DONE" and len(results) == 3
    plain = {"dtype": "float32", "nfold": False, "depth": None, "fold": 1}
    assert [r["ran"] for r in results] == [
        {"engine": "windowed", "pack": False, **plain},
        {"engine": "mega", "pack": True, **plain},
        {"engine": "resident", "pack": False, **plain}]
    for r in results:
        assert r["config"]["shape"] == [24, 32] and r["steps"] == 8
        assert r["gcells_per_sec"] > 0 and r["stats"]["n"] == 5
        assert "device_gcells_per_sec" not in r  # the CPU has no device time


def test_refused_config_is_an_error_line(capsys):
    sweep.main(["--device", "cpu", "--shape", "24x32", "--steps", "8",
                "--boundary", "naive", "--json",
                '[{"pack": "on"}, {"engine": "mega"}]'])
    lines = capsys.readouterr().out.splitlines()
    errors = [json.loads(ln) for ln in lines if ln.startswith("{")]
    assert len(errors) == 1 and "pack" in errors[0]["error"]
    assert sum(ln.startswith("RESULT ") for ln in lines) == 1


def result(shape, boundary, rate, device=None, samples=None, **pins):
    out = {"config": {"shape": list(shape), "boundary": boundary, **pins},
           "gcells_per_sec": rate}
    if device is not None:
        out["device_gcells_per_sec"] = device
    if samples is not None:
        out["stats"] = stats.summarize(samples)
    return out


#: sweep results in four groups: device rates on every result; a result
#: without one (wall ranking); samples whose CI95 decides against a margin
#: win; an engine=auto winner; and a packed win at another shape
RESULTS = [
    result((1080, 1920), "zero", 50.0, 300.0, engine="mega"),
    result((1080, 1920), "zero", 48.0, 340.0, engine="mega", pack="on"),
    result((1080, 1920), "zero", 47.0, 250.0, resident="on"),
    result((4096, 4096), "zero", 200.0, 230.0, engine="windowed"),
    result((4096, 4096), "zero", 210.0, None, engine="windowed", pack="on"),
    result((1080, 1920), "naive", 90.0, samples=[80, 100, 85, 95, 90],
           resident="on"),
    result((1080, 1920), "naive", 70.0, samples=[70, 70, 70, 70, 70],
           engine="windowed"),
    result((2048, 2048), "zero", 150.0, 160.0),
    result((2048, 2048), "zero", 140.0, 150.0, engine="mega"),
    result((512, 512), "naive", 30.0, 31.0, engine="mega"),
]

#: records in both stores before the adoption: (shape, boundary) -> record
PREVIOUS = {
    ((4096, 4096), "zero"): {"engine": "windowed", "pack": False,
                             "gcells_per_sec": 205.0,
                             "wall_gcells_per_sec": 205.0},
    ((1080, 1920), "naive"): {"engine": "resident", "pack": False,
                              "gcells_per_sec": 86.0,
                              "wall_gcells_per_sec": 86.0},
    ((2048, 2048), "zero"): {"engine": "mega", "pack": True,
                             "gcells_per_sec": 140.0,
                             "device_gcells_per_sec": 140.0,
                             "wall_gcells_per_sec": 120.0},
    ((512, 512), "naive"): {"engine": "mega", "pack": False,
                            "gcells_per_sec": 30.5,
                            "device_gcells_per_sec": 30.5},
}

#: the fields both tools agree on (the rest name TPU tiles in JAX)
FIELDS = ("engine", "pack", "gcells_per_sec", "wall_gcells_per_sec",
          "device_gcells_per_sec", "source")


def project(record: dict) -> dict:
    out = {k: record.get(k) for k in FIELDS}
    if "candidates" in record:
        out["candidates"] = [{k: c.get(k) for k in FIELDS}
                             for c in record["candidates"]]
    return out


def jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_adopt_sweep", os.path.join(REPO, "scripts", "adopt_sweep.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("margin", ["1.02", "1.2", "1.0"])
@pytest.mark.parametrize("seeded", [False, True])
def test_adoption_matches_jax(tmp_path, margin, seeded):
    """The same lines (the port's ``RESULT`` form and JAX's bare JSON)
    into stores that hold the same records give the same verdicts: the
    winner of each group, its rates and source, the candidates table."""
    jax = jax_tool()
    from grayscott_tpu.ops import pallas_stencil as ps

    tools = {"port": (adopt_sweep, cache, 1, "RESULT "),
             "jax": (jax, jax_cache, ps.KERNEL_VERSION, "")}
    stores = {}
    for name, (module, store_of, version, prefix) in tools.items():
        log = tmp_path / f"{name}.log"
        log.write_text("noise\n" + "".join(
            prefix + json.dumps(r) + "\n" for r in RESULTS) + "DONE\n")
        if seeded:
            store_of.save_autotune({
                store_of.autotune_key("p", shape, boundary, "oono-puri",
                                      version): copy.deepcopy(rec)
                for (shape, boundary), rec in PREVIOUS.items()})
        assert module.main([str(log), "--platform", "p", "--margin",
                            margin]) == 0
        stores[name] = {key.split(":", 1)[1]: project(rec)
                        for key, rec in store_of.load_autotune().items()}
    assert stores["port"] == stores["jax"]
    assert len(stores["port"]) == 5


def test_parse_results_reads_both_forms(tmp_path):
    log = tmp_path / "s.log"
    log.write_text("RESULT " + json.dumps(RESULTS[0]) + "\n"
                   + json.dumps(RESULTS[1]) + "\n"
                   + json.dumps({"config": {}, "error": "x"}) + "\n"
                   + "RESULT {broken\nDONE\n")
    assert adopt_sweep.parse_results([str(log)]) == RESULTS[:2]


def test_dry_run_writes_nothing(tmp_path):
    log = tmp_path / "s.log"
    log.write_text("RESULT " + json.dumps(RESULTS[0]) + "\n")
    assert adopt_sweep.main([str(log), "--platform", "p",
                             "--dry-run"]) == 0
    assert cache.load_autotune() == {}
    assert adopt_sweep.main([str(log), "--platform", "p"]) == 0
    (key, rec), = cache.load_autotune().items()
    assert key == "v1:p:1080x1920:zero:oono-puri"
    assert (rec["engine"], rec["pack"], rec["source"],
            rec["steps_per_call"]) == ("mega", False, "sweep", 8)
