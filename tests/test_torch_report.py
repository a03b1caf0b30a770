"""The port's benchmark report and regression gate
(grayscott_tpu_torch/bench/report.py, harness --report/--baseline/--format/
--gate) on the CPU: the same sweep JSON gives the same text, the same gated
rows and the same exit code as the JAX package's, and a report needs no
GPU and no --device flag."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from grayscott_tpu.bench import harness as jax_harness
from grayscott_tpu.bench import report as jax_report
from grayscott_tpu_torch.bench import harness, report, stats


def result(backend, shape, steps, rates, boundary="naive", **extra):
    """A sweep row as ``harness.Result.to_json`` writes it."""
    row = {"backend": backend, "workload": "compute", "shape": list(shape),
           "steps": steps, "seconds": 1.0,
           "gcells_per_sec": max(rates), "boundary": boundary,
           "samples_gcells": list(rates)}
    if len(rates) > 1:
        row["stats"] = stats.summarize(rates)
    row.update(extra)
    return row


def sweeps(kind):
    """(current, baseline) sweep rows: ``"regressed"`` (one row clearly
    slower, one within noise, one new, one gone), ``"even"`` (the same
    rates) and ``"points"`` (no samples: point deltas only)."""
    rng = np.random.RandomState({"regressed": 1, "even": 2,
                                 "points": 3}[kind])

    def noisy(mean, n=7):
        return list(mean * (1.0 + 0.002 * rng.standard_normal(n)))

    shapes = [(8, 16), (16, 32), (32, 64), (64, 128)]
    base = [result("cuda", s, 32, noisy(10.0 * (i + 1)))
            for i, s in enumerate(shapes)]
    base += [result("fused", (8, 16), 8, noisy(2.0)),
             result("naive", (8, 16), 8, noisy(1.0), boundary="zero")]
    if kind == "even":
        return [dict(r) for r in base], base
    if kind == "points":
        strip = [{k: v for k, v in r.items() if k != "stats"} for r in base]
        cur = [dict(r, gcells_per_sec=r["gcells_per_sec"] * 1.3)
               for r in strip[:4]]
        return cur, strip
    cur = [result("cuda", shapes[0], 32, noisy(6.0)),      # regressed
           result("cuda", shapes[1], 32, noisy(20.0)),     # within noise
           result("cuda", shapes[2], 32, noisy(45.0)),     # faster
           result("cuda", shapes[3], 32, noisy(40.0)),
           result("conv", (8, 16), 8, noisy(0.5)),         # new
           result("fused", (8, 16), 8, noisy(2.0), dtype="bfloat16")]
    return cur, base


def write(tmp_path, kind):
    cur, base = sweeps(kind)
    paths = tmp_path / f"{kind}.json", tmp_path / f"{kind}_base.json"
    for path, rows in zip(paths, (cur, base)):
        path.write_text(json.dumps(rows))
    return tuple(str(p) for p in paths)


@pytest.mark.parametrize("kind", ["regressed", "even", "points"])
@pytest.mark.parametrize("fmt", ["markdown", "html", "svg"])
@pytest.mark.parametrize("with_baseline", [False, True])
def test_report_text_equals_jax(tmp_path, kind, fmt, with_baseline):
    cur, base = write(tmp_path, kind)
    base = base if with_baseline else None
    got = report.report(cur, base, fmt)
    assert got == jax_report.report(cur, base, fmt)
    if fmt == "markdown":
        assert got.startswith("# Benchmark report")
    elif fmt == "html":
        assert got.startswith("<!doctype html>")


@pytest.mark.parametrize("kind", ["regressed", "even", "points"])
def test_gate_flags_the_same_rows(tmp_path, kind):
    cur, base = write(tmp_path, kind)
    rows = report.build_rows(report.load_results(cur),
                             report.load_results(base))
    jax_rows = jax_report.build_rows(jax_report.load_results(cur),
                                     jax_report.load_results(base))
    assert rows == jax_rows
    assert report.gate(rows) == jax_report.gate(jax_rows)
    flagged = [(r["backend"], r["shape"]) for r in report.gate(rows)]
    assert flagged == ([("cuda", "8x16")] if kind == "regressed" else [])


def test_row_key_and_svg_colours_equal_jax():
    row = result("cuda", (8, 16), 4, [1.0, 1.1])
    assert report.row_key(row) == jax_report.row_key(row)
    assert report.row_key({"backend": "x"}) == \
        jax_report.row_key({"backend": "x"})
    for n in (1, 1000, 1 << 20, 3 << 29, 1 << 31):
        assert report._fmt_cells_count(n) == jax_report._fmt_cells_count(n)
    assert report.render_svg([]) == jax_report.render_svg([]) == ""


def test_load_results_refuses_a_non_list(tmp_path):
    path = tmp_path / "x.json"
    path.write_text(json.dumps({"backend": "cuda"}))
    for module in (report, jax_report):
        with pytest.raises(ValueError, match="expected a JSON list"):
            module.load_results(str(path))
    empty = tmp_path / "empty.json"
    empty.write_text("[]")
    with pytest.raises(ValueError, match="unknown report format"):
        report.report(str(empty), None, "pdf")


@pytest.mark.parametrize("kind,code", [("regressed", 1), ("even", 0),
                                       ("points", 0)])
@pytest.mark.parametrize("gate", [True, False])
def test_harness_report_exits_as_jax(tmp_path, capsys, monkeypatch, kind,
                                     code, gate):
    """``harness --report A --baseline B [--gate]``: the same text and the
    same exit code as the JAX harness, with no --device flag on a host
    where PyTorch sees no GPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cur, base = write(tmp_path, kind)
    argv = ["--report", cur, "--baseline", base] + (["--gate"] if gate
                                                    else [])
    rc = harness.main(argv)
    out = capsys.readouterr().out
    jax_rc = jax_harness.main(argv)
    jax_out = capsys.readouterr().out
    assert (rc, out) == (jax_rc, jax_out)
    assert rc == (code if gate else 0)
    assert ("REGRESSION cuda 8x16" in out) == (gate and code == 1)


@pytest.mark.parametrize("fmt", ["markdown", "html", "svg"])
def test_harness_report_writes_the_output_file(tmp_path, capsys, fmt):
    cur, base = write(tmp_path, "regressed")
    out, jax_out = tmp_path / "r.txt", tmp_path / "jax.txt"
    assert harness.main(["--report", cur, "--baseline", base, "--format",
                         fmt, "-o", str(out)]) == 0
    assert jax_harness.main(["--report", cur, "--baseline", base,
                             "--format", fmt, "-o", str(jax_out)]) == 0
    assert out.read_text() == jax_out.read_text() != ""
    assert capsys.readouterr().out == ""


def test_harness_sweep_then_report(tmp_path, capsys):
    """A sweep of the port on the CPU renders, and gates clean against
    itself."""
    sweep = tmp_path / "sweep.json"
    assert harness.main(["--device", "cpu", "--backends", "cuda,regular",
                         "--smin", "3", "--smax", "3", "--steps", "2",
                         "--reps", "3", "-o", str(sweep)]) == 0
    capsys.readouterr()
    assert harness.main(["--report", str(sweep), "--baseline", str(sweep),
                         "--gate"]) == 0
    out = capsys.readouterr().out
    assert "| cuda | compute | 8x16 | 2 | naive | float32 |" in out
    assert "| regular | compute | 8x16 |" in out
    assert out == jax_report.report(str(sweep), str(sweep))
