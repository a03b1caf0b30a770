"""The port's environment defaults against the JAX package's: the three
``--pallas-*`` engine flags read ``GRAYSCOTT_PALLAS_ENGINE``,
``GRAYSCOTT_PALLAS_RESIDENT`` and ``GRAYSCOTT_PALLAS_PACK``
(``grayscott_tpu/backends/pallas.py:915-969``), and ``best_backend_name``
returns ``GRAYSCOTT_BACKEND`` when it is set
(``grayscott_tpu/backends/__init__.py:98-100``)."""

import pytest

from grayscott_tpu.backends import best_backend_name as jax_best_backend
from grayscott_tpu.cli import simulate as jax_simulate
from grayscott_tpu_torch.backends import best_backend_name
from grayscott_tpu_torch.backends.cuda import CudaSimulation
from grayscott_tpu_torch.cli import shared, simulate

#: variable -> (parser destination, a value other than the default, the
#: backend's keyword, what the backend then runs on a 24x32 domain)
FLAGS = {
    "GRAYSCOTT_PALLAS_ENGINE": ("pallas_engine", "mega", "engine", "mega"),
    "GRAYSCOTT_PALLAS_RESIDENT": ("pallas_resident", "on", "resident",
                                  "resident"),
    "GRAYSCOTT_PALLAS_PACK": ("pallas_pack", "on", "pack", "megapack"),
}


@pytest.fixture
def clean_env(monkeypatch):
    for var in (*FLAGS, "GRAYSCOTT_BACKEND"):
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


@pytest.mark.parametrize("var", sorted(FLAGS))
def test_flag_defaults_to_its_variable(clean_env, var):
    """Unset, the flag defaults to ``auto``; set, to the variable's value,
    which reaches the backend; a flag on the command line wins; a value
    outside the choices stops the parser."""
    dest, value, knob, storage = FLAGS[var]
    assert getattr(simulate.build_parser().parse_args([]), dest) == "auto"
    clean_env.setenv(var, value)
    extra = ["--boundary", "zero"] if knob == "pack" else []
    ns = simulate.build_parser().parse_args(
        ["--device", "cpu", "-r", "24", "-c", "32", *extra])
    assert getattr(ns, dest) == value
    assert CudaSimulation.args_from_namespace(ns)[knob] == value
    sim = shared.make_simulation(ns)
    assert sim.make_species((24, 32)).storage[0] == storage
    ns = simulate.build_parser().parse_args([f"--{dest.replace('_', '-')}",
                                             "auto"])
    assert getattr(ns, dest) == "auto"
    clean_env.setenv(var, "sometimes")
    with pytest.raises(SystemExit):
        simulate.build_parser()


@pytest.mark.parametrize("value", [None, "", "cuda", "sharded"])
def test_best_backend_name_reads_its_variable(clean_env, value):
    """``GRAYSCOTT_BACKEND`` names the backend when it is set and not
    empty, as in JAX; else the port picks ``cuda``."""
    if value is not None:
        clean_env.setenv("GRAYSCOTT_BACKEND", value)
    want = value or "cuda"
    assert best_backend_name() == want
    assert best_backend_name(shape=(1080, 1920)) == want
    if value:
        assert jax_best_backend() == value


@pytest.mark.parametrize("env", [
    {},
    {"GRAYSCOTT_PALLAS_ENGINE": "windowed"},
    {"GRAYSCOTT_PALLAS_ENGINE": "mega", "GRAYSCOTT_PALLAS_PACK": "on"},
    {"GRAYSCOTT_PALLAS_RESIDENT": "off", "GRAYSCOTT_PALLAS_PACK": "off"},
    {"GRAYSCOTT_PALLAS_RESIDENT": "on"},
    {"GRAYSCOTT_PALLAS_ENGINE": "turbo"},
    {"GRAYSCOTT_PALLAS_RESIDENT": "yes"},
    {"GRAYSCOTT_PALLAS_PACK": "true"},
])
def test_parser_matches_jax_under_env(clean_env, env):
    """Under one environment the port's parser and the JAX parser give the
    three flags the same defaults, or both stop."""
    for var, value in env.items():
        clean_env.setenv(var, value)
    results = []
    for module in (simulate, jax_simulate):
        try:
            ns = module.build_parser().parse_args([])
        except SystemExit:
            results.append("stopped")
            continue
        results.append(tuple(getattr(ns, dest)
                             for dest, *_ in FLAGS.values()))
    assert results[0] == results[1]
