"""The port's environment defaults against the JAX package's: the eleven
``--pallas-*`` flags read the JAX backend's variables
(``grayscott_tpu/backends/pallas.py:892-989``) and give the backend what
JAX's parser gives its own, the values the port does not run refused with
their ROADMAP.md item; and ``best_backend_name`` returns
``GRAYSCOTT_BACKEND`` when it is set
(``grayscott_tpu/backends/__init__.py:98-100``)."""

import pytest

torch = pytest.importorskip("torch")

from grayscott_tpu.backends import best_backend_name as jax_best_backend
from grayscott_tpu.cli import simulate as jax_simulate
from grayscott_tpu_torch.backends import best_backend_name
from grayscott_tpu_torch.backends.cuda import CudaSimulation
from grayscott_tpu_torch.cli import shared, simulate
from grayscott_tpu_torch.errors import UnsupportedConfigError
from grayscott_tpu_torch.ops import stencil
from grayscott_tpu_torch.params import (Parameters, fold_constants,
                                        kernel_constants)
from grayscott_tpu_torch.species import initial_uv

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


#: the other eight ``--pallas-*`` flags (``grayscott_tpu/backends/pallas.py:
#: 892-989``): variable -> (parser destination, a value the port runs
#: other than the default, a value it refuses and the ROADMAP.md item the
#: refusal names)
MORE_FLAGS = {
    "GRAYSCOTT_PALLAS_BLOCK_ROWS": ("pallas_block_rows", "64",
                                    None, None, None),
    "GRAYSCOTT_PALLAS_BLOCK_COLS": ("pallas_block_cols", "128",
                                    None, None, None),
    "GRAYSCOTT_PALLAS_DTYPE": ("pallas_dtype", "bfloat16", None, None, None),
    "GRAYSCOTT_PALLAS_FOLD": ("pallas_fold", "off", "2", "Queue 2 item 7",
                              UnsupportedConfigError),
    "GRAYSCOTT_NAIVE_FIX": ("pallas_naive_fix", "store", None, None, None),
    "GRAYSCOTT_NAIVE_FOLD": ("pallas_naive_fold", "on", None, None, None),
    "GRAYSCOTT_PALLAS_RUNTIME_PARAMS": ("pallas_runtime_params", "off",
                                        None, None, None),
    "GRAYSCOTT_PALLAS_STEPS_PER_CALL": ("pallas_steps_per_call", "16", "33",
                                        "steps_per_call must be in",
                                        ValueError),
}


@pytest.fixture
def clean_more_env(clean_env):
    for var in MORE_FLAGS:
        clean_env.delenv(var, raising=False)
    return clean_env


def both_args(argv):
    """The backends' keyword arguments from the port's parser and from
    JAX's on the same argv, over the keys the port's backend takes."""
    from grayscott_tpu.backends.pallas import PallasSimulation

    port = CudaSimulation.args_from_namespace(
        simulate.build_parser().parse_args(argv))
    ref = PallasSimulation.args_from_namespace(
        jax_simulate.build_parser().parse_args(argv))
    return port, {k: ref[k] for k in port}


@pytest.mark.parametrize("var", sorted(MORE_FLAGS))
def test_more_flags_default_to_their_variables(clean_more_env, var):
    """Each new variable gives its flag's default in both parsers, the same
    backend arguments; the port runs the value, or refuses it naming its
    ROADMAP.md item (a K outside 1..32: JAX's ``ValueError``)."""
    dest, runs, refused, item, error = MORE_FLAGS[var]
    assert both_args([])[0] == both_args([])[1]
    for value in (runs, refused):
        if value is None:
            continue
        clean_more_env.setenv(var, value)
        port, ref = both_args([])
        assert port == ref
        ns = simulate.build_parser().parse_args(
            ["--device", "cpu", "-r", "24", "-c", "32"])
        assert str(getattr(ns, dest)) == value
        if value == refused:
            with pytest.raises(error, match=item) as info:
                shared.make_simulation(ns)
            assert type(info.value) is error
        else:
            sim = shared.make_simulation(ns)
            sim.perform_steps(sim.make_species((24, 32)), 9)


#: the ROADMAP.md items the port has done: a value of theirs runs
PORTED = ("Queue 2 item 1", "Queue 2 item 3", "Queue 2 item 4",
          "Queue 2 item 5", "Queue 2 item 6", "Queue 2 item 8",
          "Queue 2 item 12")

#: argv -> the ROADMAP.md item of the value (None, or an item in PORTED: it
#: runs; another: the port's refusal names it)
ARGV = [
    (["--pallas-dtype", "float32"], None),
    (["--pallas-dtype", "bfloat16"], "Queue 2 item 4"),
    (["--pallas-fold", "auto"], None),
    (["--pallas-fold", "off"], None),
    (["--pallas-fold", "1"], None),
    (["--pallas-fold", "4"], "Queue 2 item 7"),
    (["--pallas-naive-fix", "select"], None),
    (["--pallas-naive-fix", "store"], "Queue 2 item 6"),
    (["--pallas-naive-fix", "slice"], "Queue 2 item 6"),
    (["--pallas-naive-fold", "off"], None),
    (["--pallas-naive-fold", "on"], "Queue 2 item 5"),
    (["--pallas-runtime-params", "on"], None),
    (["--pallas-runtime-params", "off"], None),
    (["--pallas-steps-per-call", "8"], None),
    (["--pallas-steps-per-call", "16"], "Queue 2 item 8"),
    (["--pallas-steps-per-call", "1"], "Queue 2 item 8"),
    (["--pallas-block-rows", "64"], "Queue 2 item 8"),
    (["--pallas-block-cols", "256"], "Queue 2 item 8"),
    (["--pallas-engine", "mega", "--pallas-runtime-params", "off",
      "--pallas-fold", "off", "--pallas-steps-per-call", "8"], None),
    (["--pallas-engine", "mega", "--pallas-block-rows", "16"],
     "Queue 2 item 12"),
    (["--pallas-engine", "mega", "--pallas-block-rows", "8",
      "--pallas-block-cols", "256"], "Queue 2 item 12"),
]


@pytest.mark.parametrize("argv,item", ARGV)
def test_flag_values_against_jax(clean_more_env, argv, item):
    """The port's parser gives the backend what JAX's gives its own on the
    same argv; each value the port runs runs (the same frames as with no
    flag: runtime parameters on and off, the K and tile pins,
    ``naive_fix``'s three values; bf16 storage the same steps rounded to
    bfloat16 once a block of 8, ``stencil.run_bf16``; the folded naive reaction its own
    plain replay, ``stencil.run_naive_fold``), each value it does not run
    raises :class:`UnsupportedConfigError` naming its item."""
    port, ref = both_args(argv)
    assert port == ref
    ns = simulate.build_parser().parse_args(
        ["--device", "cpu", "-r", "24", "-c", "32", *argv])
    if item is not None and item not in PORTED:
        with pytest.raises(UnsupportedConfigError, match=item):
            shared.make_simulation(ns)
        return
    plain = simulate.build_parser().parse_args(
        ["--device", "cpu", "-r", "24", "-c", "32"])
    frames = []
    for n in (ns, plain):
        sim = shared.make_simulation(n)
        species = sim.make_species((24, 32))
        sim.perform_steps(species, 9)
        frames.append(species.result_host())
    if ns.pallas_dtype == "bfloat16":
        u, v = (torch.from_numpy(x).to(torch.bfloat16)
                for x in initial_uv((24, 32)))
        frames[1] = stencil.run_bf16(u, v, 9, kernel_constants(
            Parameters()))[1].float().numpy()
    if ns.pallas_naive_fold == "on":
        u, v = (torch.from_numpy(x) for x in initial_uv((24, 32)))
        frames[1] = stencil.run_naive_fold(u, v, 9, fold_constants(
            Parameters()))[1].numpy()
    assert (frames[0] == frames[1]).all()


@pytest.mark.parametrize("var,value", [
    ("GRAYSCOTT_PALLAS_DTYPE", "float16"),
    ("GRAYSCOTT_NAIVE_FIX", "patch"),
    ("GRAYSCOTT_NAIVE_FOLD", "yes"),
    ("GRAYSCOTT_PALLAS_RUNTIME_PARAMS", "maybe"),
])
def test_bad_variable_stops_both_parsers(clean_more_env, var, value):
    clean_more_env.setenv(var, value)
    for module in (simulate, jax_simulate):
        with pytest.raises(SystemExit):
            module.build_parser()


#: the knobs JAX's backend takes without a flag (its constructor and its
#: sweep's ``spec`` and ``depth`` keys): keyword arguments -> the
#: ROADMAP.md item of the value, as ARGV's
CONSTRUCTOR = [
    ({"mega_depth": 2}, "Queue 2 item 3"),
    ({"mega_depth": 4}, "Queue 2 item 3"),
    ({"mega_depth": 8, "engine": "mega"}, "Queue 2 item 3"),
    ({"mega_depth": 5, "engine": "mega", "pack": "on"}, "Queue 2 item 3"),
    ({"mega_specialize": True}, "Queue 2 item 1"),
    ({"mega_specialize": False, "engine": "mega"}, "Queue 2 item 1"),
    ({"mega_specialize": True, "engine": "mega", "naive_fix": "slice"},
     "Queue 2 item 1"),
    ({"fold": 4}, "Queue 2 item 7"),
    ({"steps_per_call": 16}, "Queue 2 item 8"),
    ({"engine": "mega", "block_rows": 16}, "Queue 2 item 12"),
    ({"engine": "mega", "pack": "on", "block_rows": 8}, "Queue 2 item 12"),
]


@pytest.mark.parametrize("kwargs,item", CONSTRUCTOR)
def test_constructor_values_against_jax(kwargs, item):
    """JAX's backend takes each value; the port runs the ported ones (the
    frames of the same pins without the knob: the ring, the
    specialisation and the K and tile pins change no float32 result) and
    refuses the rest naming its item."""
    from grayscott_tpu.backends.pallas import PallasSimulation
    from grayscott_tpu.params import Parameters as JaxParameters

    boundary = "zero" if kwargs.get("pack") == "on" else "naive"
    PallasSimulation(JaxParameters(), boundary=boundary, interpret=True,
                     **kwargs)
    if item not in PORTED:
        with pytest.raises(UnsupportedConfigError, match=item):
            CudaSimulation(Parameters(), boundary, device="cpu", **kwargs)
        return
    pins = {k: v for k, v in kwargs.items()
            if k not in ("mega_depth", "mega_specialize", "steps_per_call",
                         "block_rows", "block_cols")}
    frames = []
    for kw in (kwargs, pins):
        sim = CudaSimulation(Parameters(), boundary, device="cpu", **kw)
        species = sim.make_species((24, 32))
        sim.perform_steps(species, 9)
        frames.append(species.result_host())
    assert (frames[0] == frames[1]).all()
