"""The port and chip_smoke.py import with jax, h5py, matplotlib, PIL and
the JAX package blocked: the port imports none of the four when a module
is imported, and it keeps its own copies of what it needs from the JAX
package. Each copy is held against its JAX original here. And the other
way round: with torch blocked, every port test module skips at
collection instead of failing (a host with the JAX package alone, as its
CI job has)."""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import importlib, json, pkgutil, sys
for blocked in ("jax", "h5py", "matplotlib", "PIL", "grayscott_tpu"):
    sys.modules[blocked] = None
import grayscott_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    grayscott_tpu_torch.__path__, "grayscott_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
print(json.dumps({
    "imported": names,
    "jax_loaded": sorted(m for m in sys.modules
                         if m == "jax" or m.startswith("jax.")
                         if sys.modules[m] is not None),
    "jax_package": sorted(m for m in sys.modules
                          if m == "grayscott_tpu"
                          or m.startswith("grayscott_tpu.")
                          if sys.modules[m] is not None),
}))
"""


#: every test module of the port, this one included
PORT_TESTS = sorted(name for name in os.listdir(os.path.join(REPO, "tests"))
                    if name.startswith("test_torch_")
                    and name.endswith(".py"))

#: collects the port's test modules with torch blocked, as a host without
#: torch would (the JAX package's CI job installs none), and prints each
#: module's collection outcome
NO_TORCH_PROBE = r"""
import json, sys
sys.modules["torch"] = None
import pytest

class Outcomes:
    def __init__(self):
        self.modules = {}

    def pytest_collectreport(self, report):
        if report.nodeid.endswith(".py"):
            self.modules[report.nodeid.rsplit("/", 1)[-1]] = report.outcome

outcomes = Outcomes()
rc = pytest.main(["--collect-only", "-q", "-p", "no:cacheprovider",
                  *sys.argv[1:]], plugins=[outcomes])
print(json.dumps({"rc": int(rc), "modules": outcomes.modules}))
"""


@pytest.fixture(scope="module")
def without_torch():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", NO_TORCH_PROBE,
         *(os.path.join("tests", name) for name in PORT_TESTS)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", PORT_TESTS)
def test_port_test_module_skips_without_torch(without_torch, module):
    """Each port test module begins with ``pytest.importorskip("torch")``:
    on a host without torch its collection is a skip, not an error."""
    assert without_torch["modules"][module] == "skipped"


@pytest.fixture(scope="module")
def probe():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_every_port_module_imports_without_jax_or_h5py(probe):
    """Every port module imports with jax, h5py, matplotlib and PIL
    blocked (the probe blocks all four)."""
    expected = {
        "grayscott_tpu_torch.params", "grayscott_tpu_torch.errors",
        "grayscott_tpu_torch.species",
        "grayscott_tpu_torch.ops.stencil", "grayscott_tpu_torch.ops.build",
        "grayscott_tpu_torch.ops.checks", "grayscott_tpu_torch.ops.windowed",
        "grayscott_tpu_torch.ops.resident",
        "grayscott_tpu_torch.ops.megakernel",
        "grayscott_tpu_torch.ops.packed",
        "grayscott_tpu_torch.ops.oplat", "grayscott_tpu_torch.ops.ilpsplit",
        "grayscott_tpu_torch.ops.sharded_mega",
        "grayscott_tpu_torch.parallel",
        "grayscott_tpu_torch.parallel.halo",
        "grayscott_tpu_torch.backends.sharded",
        "grayscott_tpu_torch.scripts",
        "grayscott_tpu_torch.scripts.oplat",
        "grayscott_tpu_torch.scripts.ilpsplit",
        "grayscott_tpu_torch.backends.base",
        "grayscott_tpu_torch.backends.cuda",
        "grayscott_tpu_torch.backends.naive",
        "grayscott_tpu_torch.backends.regular",
        "grayscott_tpu_torch.backends.fused",
        "grayscott_tpu_torch.backends.conv",
        "grayscott_tpu_torch.cli.shared", "grayscott_tpu_torch.cli.simulate",
        "grayscott_tpu_torch.io.hdf5", "grayscott_tpu_torch.io.checkpoint",
        "grayscott_tpu_torch.bench.stats",
        "grayscott_tpu_torch.bench.report",
        "grayscott_tpu_torch.bench.ladder",
        "grayscott_tpu_torch.bench.harness",
        "grayscott_tpu_torch.bench.headline",
        "grayscott_tpu_torch.utils.device", "grayscott_tpu_torch.utils.logs",
        "grayscott_tpu_torch.utils.progress",
        "grayscott_tpu_torch.utils.cache",
        "grayscott_tpu_torch.bench.autotune",
        "grayscott_tpu_torch.bench.defaults",
        "grayscott_tpu_torch.scripts.parity_check",
        "grayscott_tpu_torch.scripts._sweep_util",
        "grayscott_tpu_torch.scripts.sweep",
        "grayscott_tpu_torch.scripts.adopt_sweep",
        "grayscott_tpu_torch.utils.runtime",
        "grayscott_tpu_torch.utils.distributed",
        "grayscott_tpu_torch.utils.profiling",
        "grayscott_tpu_torch.utils.palette",
        "grayscott_tpu_torch.native",
        "grayscott_tpu_torch.cli.data_to_pics",
        "grayscott_tpu_torch.cli.livesim",
        "grayscott_tpu_torch.scripts.livesim_fps",
        "grayscott_tpu_torch.support",
    }
    assert expected <= set(probe["imported"])


def test_no_jax_module_was_loaded(probe):
    """Neither jax nor any module of the JAX package (grayscott_tpu or
    grayscott_tpu.*) was pulled in by the port or chip_smoke.py."""
    assert probe["jax_loaded"] == []
    assert probe["jax_package"] == []


# -- the port's copies against their JAX originals ---------------------------


def _params(tmp_path):
    from grayscott_tpu import params as jax_params
    from grayscott_tpu.ops import pallas_stencil as ps
    from grayscott_tpu_torch import params

    assert params.Precision is jax_params.Precision
    assert params.DEFAULT_STENCIL == jax_params.DEFAULT_STENCIL
    assert params.STENCILS == jax_params.STENCILS
    assert params.PRESETS == jax_params.PRESETS
    assert params.Parameters().__dict__ == jax_params.Parameters().__dict__
    for name in params.STENCILS:
        port = params.Parameters.with_stencil(name, time_step=0.5)
        ref = jax_params.Parameters.with_stencil(name, time_step=0.5)
        np.testing.assert_array_equal(port.weights_array(),
                                      ref.weights_array())
        assert port.weights_array().dtype == ref.weights_array().dtype
        assert port.min_feed_kill() == ref.min_feed_kill()
        assert port.stencil_name() == ref.stencil_name() == name
        # the separable plan, the corrected weights and the zero fold
        np.testing.assert_array_equal(port.corrected_weights(),
                                      ref.corrected_weights())
        port_plan, ref_plan = port.separable_plan(), ref.separable_plan()
        assert port_plan[0] == ref_plan[0]
        for a, b in zip(port_plan[1:], ref_plan[1:]):
            np.testing.assert_array_equal(a, b)
            assert np.asarray(a).dtype == np.asarray(b).dtype
        assert params.plan_alpha(port) == ps._plan_alpha(ref)
        scalars = (0.1, 0.05, 0.029, port.min_feed_kill(), 0.5,
                   params.plan_alpha(port))
        np.testing.assert_array_equal(
            np.asarray(params.zero_fold_coeffs(*scalars)),
            np.asarray(ps._zero_fold_coeffs(*scalars)))
    assert params.STENCIL_OFFSET == jax_params.STENCIL_OFFSET
    for name in params.PRESETS:
        port = params.Parameters.with_preset(name, "5points", kill_rate=0.06)
        ref = jax_params.Parameters.with_preset(name, "5points",
                                                kill_rate=0.06)
        assert port.__dict__ == ref.__dict__
        assert port.min_feed_kill() == ref.min_feed_kill()
    for bad in (lambda m: m.Parameters.with_stencil("nine-points"),
                lambda m: m.Parameters.with_preset("spirals")):
        for module in (params, jax_params):
            with pytest.raises(ValueError):
                bad(module)


def _errors(tmp_path):
    from grayscott_tpu import errors as jax_errors
    from grayscott_tpu_torch import errors

    for module in (errors, jax_errors):
        err = module.UnsupportedConfigError("no", combo="engine+resident")
        assert isinstance(err, ValueError)
        assert (str(err), err.combo) == ("no", "engine+resident")
        assert module.UnsupportedConfigError("no").combo is None


def _species(tmp_path):
    from grayscott_tpu import species as jax_species
    from grayscott_tpu_torch import species

    for shape in ((1080, 1920), (17, 23), (5, 3)):
        for port, ref in zip(species.initial_uv(shape),
                             jax_species.initial_uv(shape)):
            assert port.dtype == ref.dtype and port.shape == ref.shape
            np.testing.assert_array_equal(port, ref)


def _shared(tmp_path):
    from grayscott_tpu.cli import shared as jax_shared
    from grayscott_tpu_torch.cli import shared

    for argv in ([], ["-r", "17", "-c", "23", "-f", "0.03", "-t", "0.5"],
                 ["--preset", "coral", "-k", "0.06", "--stencil", "pretty"],
                 ["--preset", "maze", "--stencil", "5points", "-e", "9"]):
        port_p, jax_p = argparse.ArgumentParser(), argparse.ArgumentParser()
        shared.add_shared_args(port_p)
        jax_shared.add_shared_args(jax_p)
        port_ns, jax_ns = port_p.parse_args(argv), jax_p.parse_args(argv)
        assert shared.domain_shape(port_ns) == jax_shared.domain_shape(jax_ns)
        assert shared.simulation_parameters(port_ns).__dict__ == \
            jax_shared.simulation_parameters(jax_ns).__dict__
    for path in (None, "", "x.h5"):
        assert shared.simulation_output_path(path) == \
            jax_shared.simulation_output_path(path)


def _hdf5(tmp_path):
    import h5py

    from grayscott_tpu.io import hdf5 as jax_hdf5
    from grayscott_tpu_torch.io import hdf5

    frames = np.random.RandomState(3).uniform(0, 1, (3, 5, 7)) \
        .astype(np.float32)
    files = {}
    for name, module in (("port", hdf5), ("jax", jax_hdf5)):
        files[name] = tmp_path / f"{name}.h5"
        writer = module.Writer(files[name], (5, 7), 3)
        for frame in frames:
            writer.write(frame)
        writer.close()
    with h5py.File(files["port"], "r") as p, h5py.File(files["jax"], "r") as j:
        assert p["matrix"].chunks == j["matrix"].chunks
        np.testing.assert_array_equal(p["matrix"][:], j["matrix"][:])
    assert hdf5._chunk_shape(40000, 40000, 4) == \
        jax_hdf5._chunk_shape(40000, 40000, 4)


def _progress_and_logs(tmp_path):
    import io

    from grayscott_tpu.utils import progress as jax_progress
    from grayscott_tpu_torch.utils import logs, progress

    for seconds in (0, 59, 61, 3600 + 62):
        assert progress._fmt_duration(seconds) == \
            jax_progress._fmt_duration(seconds)
    out = io.StringIO()
    bar = progress.ProgressBar("run", 3, stream=out, enabled=True)
    for _ in range(3):
        bar.inc()
    bar.finish()
    assert bar.pos == 3 and "run 3/3" in out.getvalue()
    logger = logs.init_logging(prefer_syslog=False)
    assert logs.init_logging() is logger and logger.handlers


def _halo(tmp_path):
    from grayscott_tpu.parallel import halo as jax_halo
    from grayscott_tpu_torch.parallel import halo

    rng = np.random.RandomState(5)
    shapes = [(1080, 1920), (4096, 4096), (48, 16), (32, 300), (32, 384),
              (24, 600), (16384, 128), (7, 5000)]
    shapes += [tuple(int(x) for x in rng.randint(1, 3000, 2))
               for _ in range(40)]
    for shape in shapes:
        for n in range(1, 13):
            assert halo.viable_mesh_cols(shape, n) == \
                jax_halo.viable_mesh_cols(shape, n), (shape, n)
            assert halo.choose_mesh_cols(n, shape) == \
                jax_halo.choose_mesh_cols(n, shape), (shape, n)
        for n in (1, 2, 3, 4, 7):
            for tile in (8, 32, 128):
                assert halo._tile_rounded(shape[0], n, tile) == \
                    jax_halo._tile_rounded(shape[0], n, tile)


def _checkpoint(tmp_path):
    from grayscott_tpu.io import checkpoint as jax_checkpoint
    from grayscott_tpu.params import Parameters as JaxParameters
    from grayscott_tpu_torch.io import checkpoint
    from grayscott_tpu_torch.params import Parameters

    assert checkpoint.FORMAT_VERSION == jax_checkpoint.FORMAT_VERSION
    u, v = np.random.RandomState(4).uniform(0, 1, (2, 6, 9)) \
        .astype(np.float32)
    files = {}
    for name, module, params in (
            ("port", checkpoint, Parameters.with_preset("coral")),
            ("jax", jax_checkpoint, JaxParameters.with_preset("coral"))):
        files[name] = tmp_path / f"{name}.h5"
        module.save_state(files[name], u, v, params, 96)
    for path in files.values():
        port, ref = checkpoint.load_state(path), \
            jax_checkpoint.load_state(path)
        for a, b in zip(port[:2], ref[:2]):
            np.testing.assert_array_equal(a, b)
        assert port[2].__dict__ == ref[2].__dict__ and port[3] == ref[3] == 96


def _report(tmp_path):
    """A whole copy: the source below the module docstring is the JAX
    module's, character for character."""
    import ast
    import inspect

    from grayscott_tpu.bench import report as jax_report
    from grayscott_tpu_torch.bench import report

    def body(module):
        source = inspect.getsource(module)
        doc = ast.get_docstring(ast.parse(source), clean=False)
        return source[source.index(doc) + len(doc):]

    assert body(report) == body(jax_report)


def _native(tmp_path):
    """colorize.cpp is JAX's, character for character."""
    from grayscott_tpu import native as jax_native
    from grayscott_tpu_torch import native

    with open(os.path.join(os.path.dirname(jax_native.__file__),
                           "colorize.cpp")) as f:
        want = f.read()
    assert native.SOURCE.read_text() == want
    assert native.PNG_LEVEL_DEFAULT == jax_native.PNG_LEVEL_DEFAULT


def _reader(tmp_path):
    """The Reader's methods are JAX's, but for h5py's import moved inside
    ``__init__``; and each reader reads the other package's file."""
    import inspect

    from grayscott_tpu.io import hdf5 as jax_hdf5
    from grayscott_tpu_torch.io import hdf5

    port = inspect.getsource(hdf5.Reader).replace(
        "        import h5py\n\n", "")
    assert port == inspect.getsource(jax_hdf5.Reader)
    frames = np.random.RandomState(6).uniform(0, 1, (4, 3, 5)) \
        .astype(np.float32)
    for writer in (hdf5.Writer, jax_hdf5.Writer):
        path = tmp_path / f"{writer.__module__}.h5"
        w = writer(path, (3, 5), 4)
        for frame in frames:
            w.write(frame)
        w.close()
        for reader in (hdf5.Reader, jax_hdf5.Reader):
            with reader(path) as r:
                assert r.num_images == 4 and r.image_shape == (3, 5)
                out = np.empty((3, 5), np.float32)
                for frame in frames:
                    np.testing.assert_array_equal(r.read(out=out), frame)
                assert r.read() is None


def _palette(tmp_path):
    from grayscott_tpu.utils import palette as jax_palette
    from grayscott_tpu_torch.utils import palette

    assert palette.MAX_AMPLITUDE == jax_palette.MAX_AMPLITUDE
    assert palette.AMPLITUDE_SCALE == jax_palette.AMPLITUDE_SCALE
    np.testing.assert_array_equal(palette.inferno_lut(),
                                  jax_palette.inferno_lut())


def _actions(parser, dests=None):
    return {a.dest: (a.option_strings, a.default, a.type, a.nargs,
                     a.required, a.help, a.metavar, a.choices)
            for a in parser._actions
            if dests is None or a.dest in dests}


def _data_to_pics_args(tmp_path):
    """The same flags, defaults and help as JAX's data-to-pics."""
    from grayscott_tpu.cli import data_to_pics as jax_data_to_pics
    from grayscott_tpu_torch.cli import data_to_pics

    assert _actions(data_to_pics.build_parser()) == \
        _actions(jax_data_to_pics.build_parser())


def _livesim_args(tmp_path):
    """livesim's own flags are JAX's (the shared ones are held in
    ``_shared``)."""
    from grayscott_tpu.cli import livesim as jax_livesim
    from grayscott_tpu_torch.cli import livesim

    own = {"web", "port", "frames", "output_dir", "fps_cap",
           "color_palette_resolution", "frames_in_flight"}
    port = _actions(livesim.build_parser(), own)
    assert set(port) == own
    assert port == _actions(jax_livesim.build_parser(), own)


@pytest.mark.parametrize("copy", ["params", "errors", "species", "shared",
                                  "hdf5", "progress_and_logs", "halo",
                                  "checkpoint", "report", "native",
                                  "reader", "palette", "data_to_pics_args",
                                  "livesim_args"])
def test_copy_matches_the_jax_original(copy, tmp_path):
    globals()[f"_{copy}"](tmp_path)
