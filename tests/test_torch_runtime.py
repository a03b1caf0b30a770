"""The port's runtime plumbing on the CPU: ``GRAYSCOTT_PLATFORM`` as the
default of ``--device`` (utils/runtime.py), the ``GRAYSCOTT_DEBUG`` checks
of ``Simulation.prepare_steps`` (the counterpart of JAX's
``jax_debug_nans``/``jax_debug_infs``), ``trace``/``annotate``
(utils/profiling.py) and the build store under ``GRAYSCOTT_CACHE_DIR``
(utils/cache.py:build_dir) for the kernel and native libraries."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from grayscott_tpu.utils import runtime as jax_runtime
from grayscott_tpu_torch import native
from grayscott_tpu_torch.backends import base
from grayscott_tpu_torch.bench import harness, headline
from grayscott_tpu_torch.cli import livesim, shared, simulate
from grayscott_tpu_torch.ops import build
from grayscott_tpu_torch.scripts import livesim_fps, parity_check
from grayscott_tpu_torch.utils import cache, profiling, runtime

PARSERS = {
    "simulate": lambda argv: simulate.build_parser().parse_args(argv),
    "livesim": lambda argv: livesim.build_parser().parse_args(argv),
}


@pytest.mark.parametrize("program", sorted(PARSERS))
@pytest.mark.parametrize("value", [None, "cpu", "cuda"])
def test_platform_sets_the_device_default(monkeypatch, program, value):
    if value is None:
        monkeypatch.delenv("GRAYSCOTT_PLATFORM", raising=False)
    else:
        monkeypatch.setenv("GRAYSCOTT_PLATFORM", value)
    ns = PARSERS[program]([])
    assert ns.device == (value or "cuda")
    # the command line wins over the variable
    assert PARSERS[program](["--device", "cpu"]).device == "cpu"
    assert runtime.apply_env_config().device == (value or "cuda")


@pytest.mark.parametrize("bad", ["tpu", "gpu", "CPU"])
def test_bad_platform_stops_naming_the_choices(monkeypatch, bad):
    monkeypatch.setenv("GRAYSCOTT_PLATFORM", bad)
    for stop in (runtime.apply_env_config, lambda: PARSERS["livesim"]([])):
        with pytest.raises(SystemExit) as e:
            stop()
        assert "cuda" in str(e.value) and "cpu" in str(e.value)


def test_platform_reaches_every_device_flag(monkeypatch, tmp_path):
    """The measurement scripts' --device follows it too: with
    GRAYSCOTT_PLATFORM=cpu, no flag, they run on the CPU."""
    monkeypatch.setenv("GRAYSCOTT_PLATFORM", "cpu")
    assert livesim_fps.main(["--rows", "16", "--cols", "16", "--frames",
                             "2", "--depths", "1"]) == 0
    assert headline.main(["-r", "16", "-c", "16", "--steps", "4"]) == 0
    out = tmp_path / "p.json"
    assert parity_check.main(["--shape", "16x16", "--steps", "4",
                              "--snapshot-every", "2", "--backends", "naive",
                              "-o", str(out)]) == 0
    assert harness.main(["--smin", "3", "--smax", "3", "--steps", "1",
                         "--reps", "1",
                         "--output", str(tmp_path / "h.json")]) == 0


def test_env_flag_is_one_function_read_like_jax(monkeypatch):
    assert runtime.env_flag is base.env_flag
    for raw in ("", "0", "false", "No", "OFF", "1", "yes", "on", "x"):
        monkeypatch.setenv("GRAYSCOTT_DEBUG", raw)
        assert runtime.env_flag("GRAYSCOTT_DEBUG") == \
            jax_runtime.env_flag("GRAYSCOTT_DEBUG")
        assert runtime.apply_env_config().debug == \
            jax_runtime.env_flag("GRAYSCOTT_DEBUG")


def _sim(argv):
    ns = simulate.build_parser().parse_args(
        ["-r", "16", "-c", "16", "--device", "cpu"] + argv)
    return shared.make_simulation(ns)


@pytest.mark.parametrize("backend", ["naive", "fused", "cuda", "sharded"])
def test_debug_raises_on_a_diverging_run(monkeypatch, backend):
    monkeypatch.setenv("GRAYSCOTT_DEBUG", "1")
    flags = ["--backend", backend, "-t", "1e4"]
    if backend == "sharded":
        flags += ["--sharded-engine", "mega", "--sharded-devices", "2"]
    sim = _sim(flags)
    species = sim.make_species((16, 16))
    with pytest.raises(FloatingPointError) as e:
        simulate.run(sim, species, 10, 1, lambda frame: None)
    assert sim.name in str(e.value)
    assert f"after {species.steps_performed} steps" in str(e.value)
    assert species.steps_performed < 10


@pytest.mark.parametrize("backend", ["naive", "cuda"])
def test_debug_passes_a_healthy_run_and_off_changes_nothing(monkeypatch,
                                                            backend):
    frames = {}
    for flag in ("1", "0", None):
        if flag is None:
            monkeypatch.delenv("GRAYSCOTT_DEBUG", raising=False)
        else:
            monkeypatch.setenv("GRAYSCOTT_DEBUG", flag)
        sim = _sim(["--backend", backend])
        assert sim.debug == (flag == "1")
        got = []
        simulate.run(sim, sim.make_species((16, 16)), 3, 8, got.append)
        frames[flag] = got
    for a, b, c in zip(*frames.values()):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_debug_off_runs_no_check(monkeypatch):
    """Off, the step path runs what it ran before the flag existed: no
    check, so no synchronisation."""
    monkeypatch.delenv("GRAYSCOTT_DEBUG", raising=False)
    sim = _sim(["--backend", "cuda", "-t", "1e4"])

    def check(species):
        raise AssertionError("checked with GRAYSCOTT_DEBUG unset")

    monkeypatch.setattr(sim, "check_finite", check)
    species = sim.make_species((16, 16))
    simulate.run(sim, species, 10, 1, lambda frame: None)
    assert species.steps_performed == 10
    assert not np.isfinite(species.result_host()).all()


def test_trace_writes_a_chrome_trace_with_the_label(monkeypatch, tmp_path):
    monkeypatch.setenv("GRAYSCOTT_TRACE_DIR", str(tmp_path / "traces"))
    sim = _sim(["--backend", "cuda"])
    species = sim.make_species((16, 16))
    with profiling.trace(device="cpu") as path:
        with profiling.annotate("livesim-frame"):
            sim.perform_steps(species, 4)
    assert os.path.dirname(path) == str(tmp_path / "traces")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "livesim-frame" for e in events)
    assert profiling.device_events(path) == []  # the CPU has no card
    with profiling.trace(str(tmp_path / "own"), device="cpu") as second:
        pass
    assert second != path and os.path.exists(second)


def test_device_events_reads_kernels_and_copies(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 10, "dur": 5},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 16,
         "dur": 2},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 20,
         "dur": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 1, "dur": 3},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "a", "ts": 1,
         "dur": 30},
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 4},
    ]}))
    events = profiling.device_events(str(path))
    assert [(e.name, e.category, e.start_us, e.end_us) for e in events] == [
        ("k", "kernel", 10.0, 15.0),
        ("Memcpy DtoH", "gpu_memcpy", 16.0, 18.0),
        ("Memset", "gpu_memset", 20.0, 21.0)]


def test_cache_dir_moves_the_kernel_and_native_builds(monkeypatch,
                                                      tmp_path):
    monkeypatch.setenv("GRAYSCOTT_CACHE_DIR", str(tmp_path))
    assert build.library_path().parent == tmp_path / "kernels"
    assert native.library_path().parent == tmp_path / "native"
    assert cache.autotune_path() == str(tmp_path / "autotune.json")
    monkeypatch.delenv("GRAYSCOTT_CACHE_DIR")
    # a checkout: build/ beside the package
    assert build.library_path().parent == \
        cache.PACKAGE_PARENT / "build" / "kernels"
    assert native.library_path().parent == \
        cache.PACKAGE_PARENT / "build" / "native"


def test_unwritable_package_builds_under_the_user_cache(monkeypatch,
                                                        tmp_path):
    """An installed package (site-packages not writable) builds under
    ~/.cache/grayscott_tpu_torch."""
    site = tmp_path / "site"
    site.mkdir()
    monkeypatch.delenv("GRAYSCOTT_CACHE_DIR", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.setattr(cache, "PACKAGE_PARENT", site)
    # build/ does not exist yet: its first existing ancestor decides
    assert cache._writable(site / "build" / "kernels")
    assert cache.build_dir("kernels") == site / "build" / "kernels"
    writable = {str(site): False}
    monkeypatch.setattr(cache.os, "access",
                        lambda path, mode: writable.get(str(path), True))
    user = tmp_path / "home" / ".cache" / "grayscott_tpu_torch"
    assert cache.build_dir("kernels") == user / "kernels"
    assert native.library_path().parent == user / "native"
    assert build.library_path().parent == user / "kernels"
