"""The port's bench package (grayscott_tpu_torch/bench/) on the CPU: its
statistics against the JAX ones, the harness's workloads and flags, and
the headline's JSON line against the keys of the root bench.py."""

import ast
import json
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from grayscott_tpu.bench import stats as jax_stats
from grayscott_tpu_torch.backends.cuda import CudaSimulation
from grayscott_tpu_torch.bench import harness, headline, stats
from grayscott_tpu_torch.params import Parameters

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("samples", [
    [1.0],
    [3.0, 1.0, 2.0],
    [5.0, 5.0, 5.0, 5.0, 6.0],          # degenerate MAD: the floor
    [10.0, 10.5, 9.8, 10.2, 30.0, 10.1],  # one severe outlier
    list(np.random.RandomState(7).lognormal(3.0, 0.2, 20)),
])
def test_summarize_equals_jax(samples):
    assert stats.summarize(samples) == jax_stats.summarize(samples)
    ci = stats.summarize(samples)["ci95"]
    assert stats.intervals_overlap(ci, ci) == \
        jax_stats.intervals_overlap(ci, ci)
    s = stats.summarize(samples)
    assert stats.significantly_better(s, 1.0, 0.1) == \
        jax_stats.significantly_better(s, 1.0, 0.1)


@pytest.mark.parametrize("workload", ["compute", "full_sync",
                                      "full_future"])
@pytest.mark.parametrize("engine", ["auto", "mega"])
def test_run_one_gives_finite_rates(workload, engine):
    sim = CudaSimulation(Parameters(), device="cpu", engine=engine)
    res = harness.run_one(sim, (8, 16), 9, workload, reps=3,
                          extra={"engine": engine})
    assert res.workload == workload and res.shape == (8, 16)
    assert len(res.samples_gcells) == 3
    assert all(math.isfinite(r) and r > 0 for r in res.samples_gcells)
    assert res.gcells_per_sec == max(res.samples_gcells)
    assert res.stats["n"] == 3
    assert res.to_json()["engine"] == engine


def test_device_workload_raises_on_the_cpu():
    sim = CudaSimulation(Parameters(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        harness.run_one(sim, (8, 16), 1, "device", reps=1)


def test_sweep_writes_json(tmp_path):
    out = tmp_path / "sweep.json"
    results = harness.sweep(["cuda"], domains=harness.default_domains(3, 4),
                            step_counts=[1, 8], reps=2, out_path=str(out),
                            verbose=False, device="cpu", boundary="zero")
    assert len(results) == 4
    rows = json.loads(out.read_text())
    assert [(r["shape"], r["steps"]) for r in rows] == \
        [([8, 16], 1), ([8, 16], 8), ([16, 32], 1), ([16, 32], 8)]
    assert all(r["boundary"] == "zero" and r["device"] == "cpu"
               for r in rows)


def test_main_runs_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "sweep.json"
    assert harness.main(["--device", "cpu", "--smin", "3", "--smax", "3",
                         "--steps", "2", "--reps", "2", "--engine", "mega",
                         "-o", str(out)]) == 0
    assert json.loads(out.read_text())[0]["engine"] == "mega"
    assert "Gcell/s" in capsys.readouterr().out


@pytest.mark.parametrize("flags", [
    ["--block-rows", "8"], ["--steps-per-call", "4"],
])
def test_deferred_flags_stop_with_their_roadmap_item(flags, tmp_path):
    """The tile and depth pins, which stopped the run until ROADMAP.md Queue
    2 item 8 ported them: JAX's parser takes the same flags, and the rows
    run on the ``cuda`` backend under the pin, labelled with it, as JAX's
    harness labels them."""
    from grayscott_tpu.bench import harness as jax_harness

    key, value = flags[0][2:].replace("-", "_"), int(flags[1])
    out = tmp_path / "sweep.json"
    assert harness.main(["--device", "cpu", "--smin", "3", "--smax", "3",
                         "--steps", "9", "--reps", "1", "--backends",
                         "cuda,naive", *flags, "-o", str(out)]) == 0
    rows = json.loads(out.read_text())
    assert [r[key] for r in rows] == [value, value]
    with pytest.raises(SystemExit):  # JAX's parser: the same flag, an int
        jax_harness.main([flags[0], "x"])


def test_dtype_flag_runs_like_jax(tmp_path, capsys):
    """``--dtype``, deferred until bf16 storage was ported, takes JAX's
    choices and runs: the ``cuda`` rows are labelled with the dtype, and
    a backend without one gets JAX's note (tests/test_torch_bf16.py runs
    ``sharded`` too)."""
    from grayscott_tpu.bench import harness as jax_harness

    for value in ("float32", "bfloat16"):
        out = tmp_path / f"{value}.json"
        assert harness.main(["--device", "cpu", "--smin", "3", "--smax",
                             "3", "--steps", "2", "--reps", "1",
                             "--backends", "cuda,naive", "--dtype", value,
                             "-o", str(out)]) == 0
        rows = json.loads(out.read_text())
        assert [r.get("dtype") for r in rows] == [
            value, None if value == "bfloat16" else value]
    assert "naive: dtype=bfloat16 unsupported" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        harness.main(["--device", "cpu", "--dtype", "float16"])
    assert "float16" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        jax_harness.main(["--dtype", "float16"])


def test_device_cuda_without_gpu_stops(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        harness.main(["--smax", "3"])
    with pytest.raises(SystemExit, match="--device cpu"):
        headline.measure(24, 32, 9)


def bench_py_keys():
    """The keys of the JSON object that the root bench.py prints."""
    tree = ast.parse(open(os.path.join(REPO, "bench.py")).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "attr",
                                                  None) == "dumps":
            return {k.value for k in node.args[0].keys}
    raise AssertionError("bench.py prints no json.dumps object")


def test_headline_has_the_keys_of_bench_py():
    rows = {b: headline.measure(r=24, c=32, steps=9, boundary=b,
                                device="cpu") for b in ("zero", "naive")}
    for name, steady, single, batch in rows.values():
        assert name == "cuda" and batch == headline.BATCH
        assert math.isfinite(steady) and math.isfinite(single)
    line = headline.headline(rows["zero"], rows["naive"], (24, 32), 9,
                             "cpu")
    assert set(line) == bench_py_keys()
    assert line["vs_baseline"] == line["value"] / headline.ROOFLINE_GCELLS
    assert headline.ROOFLINE_GCELLS == pytest.approx(209.375)


def test_headline_main_prints_one_json_line(capsys):
    assert headline.main(["-r", "16", "-c", "16", "--steps", "3",
                          "--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and set(json.loads(out[0])) == bench_py_keys()


def test_simulate_turns_stops_without_a_card(monkeypatch, capsys):
    """The parent-against-change timer refuses to run without a card and
    prints no result line."""
    from grayscott_tpu_torch.bench import simulate_turns
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert simulate_turns.main(["--reps", "1"]) == 1
    assert capsys.readouterr().out == ""


def test_ladder_times_every_backend_in_turns():
    """bench/ladder.py's timing on the CPU at a small size: 2 x rounds
    finite samples for each rung and for cuda."""
    from grayscott_tpu_torch.bench import ladder

    runs = ladder.ladder_ms(shape=(16, 24), steps=3, images=2, rounds=2,
                            device="cpu")
    assert list(runs) == list(ladder.LABELS)
    assert all(len(r) == 4 and all(math.isfinite(x) and x > 0 for x in r)
               for r in runs.values())


@pytest.mark.parametrize("intervals,total", [
    ([], 0.0), ([(0.0, 2.0)], 2.0), ([(0.0, 2.0), (1.0, 3.0)], 3.0),
    ([(5.0, 6.0), (0.0, 1.0), (0.5, 0.75)], 2.0),
])
def test_ladder_union_of_device_intervals(intervals, total):
    from grayscott_tpu_torch.bench import ladder

    assert ladder._union_us(intervals) == total


def test_ladder_stops_without_a_card(monkeypatch, capsys):
    from grayscott_tpu_torch.bench import ladder

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ladder.main(["--images", "1"]) == 1
    assert capsys.readouterr().out == ""
