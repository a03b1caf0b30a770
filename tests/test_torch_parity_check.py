"""The port's ``scripts/parity_check.py`` on the CPU against JAX's
``scripts/parity_check.py``: the same report schema and exit rule, the
port's ``naive`` reference bitwise to the oracle, and the ``fused`` drift
the two scripts measure, each against its own reference, within 1e-5 of
each other."""

import importlib.util
import json
import os

import pytest

torch = pytest.importorskip("torch")

from grayscott_tpu_torch.scripts import parity_check

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: fused's max|dV| from the oracle, the port's against JAX's, at each
#: snapshot: both rungs drift from the oracle's rounding by reassociating
#: the stencil sum (1e-7 to 1e-6 here), each in its own order, so their
#: drifts agree to well within this
FUSED_TOL = 1e-5

SHAPE, STEPS = "64x96", 200


def jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_parity_check", os.path.join(REPO, "scripts", "parity_check.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parity")
    out = {}
    for name, main, backends in (
            ("port", parity_check.main, "naive,fused"),
            ("jax", jax_script().main, "fused")):
        path = tmp / f"{name}.json"
        argv = ["--backends", backends, "--steps", str(STEPS), "--shape",
                SHAPE, "-o", str(path)]
        if name == "port":
            argv += ["--device", "cpu"]
        assert main(argv) == 0
        out[name] = json.loads(path.read_text())
    return out


def test_report_schema_is_jax(reports):
    port, ref = reports["port"], reports["jax"]
    assert set(ref) <= set(port)
    assert (port["shape"], port["boundary"], port["stencil"]) == \
        (ref["shape"], ref["boundary"], ref["stencil"])
    assert [r["step"] for r in port["rows"]] == \
        [r["step"] for r in ref["rows"]] == [100, 200]
    for p, r in zip(port["rows"], ref["rows"]):
        assert set(p["fused"]) == set(r["fused"])


def test_naive_reference_is_exact(reports):
    for row in reports["port"]["rows"]:
        assert row["naive"] == {"max_abs_u": 0.0, "max_abs_v": 0.0,
                                "rms_v": 0.0}


def test_fused_drift_matches_jax(reports):
    for p, r in zip(reports["port"]["rows"], reports["jax"]["rows"]):
        assert 0.0 < p["fused"]["max_abs_v"] < 1e-5
        assert abs(p["fused"]["max_abs_v"] - r["fused"]["max_abs_v"]) \
            <= FUSED_TOL


@pytest.mark.parametrize("spec,want", [
    ("cuda", ("cuda", {})),
    ("cuda:engine=mega", ("cuda", {"engine": "mega"})),
    ("cuda:pack=on:resident=on", ("cuda", {"pack": "on",
                                           "resident": "on"})),
    ("sharded:engine=mega", ("sharded", {"engine": "mega"})),
])
def test_backend_specs(spec, want):
    assert parity_check.parse_backend(spec) == want


def test_engines_and_the_exit_rule(monkeypatch, tmp_path):
    """Each pinned engine of ``cuda`` runs (its plain version here): the
    unpacked ones exactly the reference, the packed one drifting but
    inside the rule; a tolerance the drift exceeds makes the exit code 1."""
    monkeypatch.setenv("GRAYSCOTT_CACHE_DIR", str(tmp_path))
    specs = ["cuda:engine=windowed", "cuda:engine=mega", "cuda:resident=on",
             "cuda:pack=on:engine=mega"]
    report = parity_check.run(specs, steps=40, snapshot_every=20,
                              boundary="zero", shape=(32, 48), device="cpu",
                              verbose=False)
    for spec in specs[:3]:
        assert all(row[spec]["max_abs_v"] == 0.0 for row in report["rows"])
    packed = [row[specs[3]]["max_abs_v"] for row in report["rows"]]
    assert 0.0 < max(packed) < parity_check.TOLERANCE
    assert parity_check.worst_v(report) == max(packed)
    argv = ["--backends", specs[3], "--steps", "40", "--shape", "32x48",
            "--boundary", "zero", "--device", "cpu"]
    assert parity_check.main(argv) == 0
    monkeypatch.setattr(parity_check, "TOLERANCE", max(packed) / 2)
    assert parity_check.main(argv) == 1
