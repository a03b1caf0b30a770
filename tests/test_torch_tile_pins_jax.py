"""The temporal depth and the tile pins of K1 and K4 against the JAX
package on the CPU: ``halo_for_steps`` and the pinned row tile against
JAX's rules, the selection (which engine runs, which combination raises,
with JAX's exception class and message where JAX refuses) against JAX's
constructor and ``build_storage`` on the same keyword arguments, the port's
runs under the pins against JAX's Pallas kernels in interpret mode (the
windowed kernel at ``block_rows=8, steps_per_call=16`` as
``tests/test_pallas.py:371-387`` runs it, bf16 storage under K 4 and 12,
and the packed kernel under a row tile and K), and the harness's, the
sweep's and ``adopt_sweep``'s pins against JAX's. JAX's interpret mode
unrolls K steps: the cases are small."""

import itertools
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from grayscott_tpu import oracle
from grayscott_tpu.backends.pallas import PallasSimulation
from grayscott_tpu.errors import UnsupportedConfigError as JaxUnsupported
from grayscott_tpu.ops import pallas_stencil as ps
from grayscott_tpu_torch.backends.cuda import CudaSimulation
from grayscott_tpu_torch.bench import harness
from grayscott_tpu_torch.errors import UnsupportedConfigError
from grayscott_tpu_torch.ops import geometry
from grayscott_tpu_torch.params import Parameters
from grayscott_tpu_torch.scripts import _sweep_util, adopt_sweep
from grayscott_tpu_torch.species import Species

from conftest import random_uv

SHAPE = (24, 32)


@pytest.fixture(autouse=True)
def store(monkeypatch, tmp_path):
    """An empty autotune store of the test's own."""
    monkeypatch.setenv("GRAYSCOTT_CACHE_DIR", str(tmp_path / "store"))


def run_jax(sim, u, v, steps):
    species = sim.make_species(u.shape)
    species.storage = sim.build_storage(u, v)
    sim.perform_steps(species, steps)
    return species


def run_port(sim, u, v, steps):
    species = Species(u.shape, sim.build_storage(u, v), sim)
    sim.perform_steps(species, steps)
    return species


@pytest.mark.parametrize("k", range(1, 33))
def test_halo_for_steps_is_jax(k):
    assert geometry.halo_for_steps(k) == ps.halo_for_steps(k)


@pytest.mark.parametrize("shape,tr", [
    ((40, 48), 64), ((33, 48), 64), ((33, 48), 13), ((1, 5), 256),
    ((1080, 1920), 544), ((1080, 1920), 8), ((100, 30), 96)])
def test_pinned_row_tile_is_jax(params, shape, tr):
    """The pinned row tile steps down by 8 past the padded rows as JAX's
    ``_tr`` does (``backends/pallas.py:270-287``)."""
    sim = PallasSimulation(params, interpret=True, block_rows=tr,
                           tuned_lookup=False)
    assert geometry.resolve(shape, 8, tr, 8).tr == sim._tr(shape,
                                                           tuned=None)


@pytest.mark.parametrize("tc", [128, 256, 384])
def test_a_column_tile_of_the_domain_is_one_tile_column(params, tc):
    """``tc >= cols`` is one tile column (``backends/pallas.py:306-307``:
    JAX's full-width window; the port's tile as wide as the domain)."""
    shape = (64, 256)
    sim = PallasSimulation(params, interpret=True, block_cols=tc,
                           tuned_lookup=False)
    _, jax_tc, _ = sim._tiles(shape, tuned=None)
    g = geometry.resolve(shape, 8, None, tc)
    assert (jax_tc is None) == (g.tc == shape[1])


#: the selection matrix: each knob's values, K and tile pins among them
MATRIX = {
    "steps_per_call": (None, 4, 8, 16, 33),
    "tiles": (None, (64, None), (None, 128)),
    "engine": ("auto", "windowed", "mega"),
    "pack": ("auto", "on"),
    "resident": ("auto", "on"),
}
#: JAX's storage tags, the port's
TAGS = {"windowed": "windowed", "mega": "mega", "resident": "resident",
        "packed": "packed", "megapack": "megapack", "respack": "respack"}


def outcome(make):
    """("runs", storage tag) or ("raises", exception class name,
    message)."""
    try:
        return ("runs", make())
    except (ValueError, TypeError) as e:
        cls = ("UnsupportedConfigError"
               if isinstance(e, (UnsupportedConfigError, JaxUnsupported))
               else type(e).__name__)
        return ("raises", cls, str(e))


@pytest.mark.parametrize("combo", list(itertools.product(*MATRIX.values())),
                         ids=str)
def test_selection_matches_jax(params, combo):
    """On the same keyword arguments JAX's constructor and
    ``build_storage`` (interpret mode) and the port's (on the CPU) both
    run or both raise, with the same exception class and, where the port
    copies JAX's refusal, JAX's message (the K range, the megakernel's K,
    the packed layout's column tiles). Where both run under a pin or an
    engine pin, the same engine and layout run, the megakernels' tile pins
    among them (ported since: tests/test_torch_mega_pins_jax.py)."""
    k, tiles, engine, pack, resident = combo
    kw = dict(steps_per_call=k, engine=engine, pack=pack,
              resident=resident)
    if tiles is not None:
        kw.update(block_rows=tiles[0], block_cols=tiles[1])
    u, v = random_uv(np.random.RandomState(0), SHAPE)
    want = outcome(lambda: PallasSimulation(
        params, boundary="zero", interpret=True, tuned_lookup=False,
        **kw).build_storage(u, v)[0])
    got = outcome(lambda: CudaSimulation(
        Parameters(), "zero", device="cpu", tuned_lookup=False,
        **kw).build_storage(u, v)[0])
    assert got[0] == want[0], (got, want)
    if want[0] == "raises":
        assert got[1] == want[1], (got, want)
        if "steps_per_call must be in" in want[2] or \
                "fixes steps-per-call" in want[2] or \
                "no fold/column tiling" in want[2]:
            assert want[2] in got[2]
        return
    pinned = (k, tiles) != (None, None) or engine != "auto" or \
        resident == "on"
    if pinned:
        assert got[1] == TAGS[want[1]], (got, want)


@pytest.mark.parametrize("boundary", ["naive", "zero"])
def test_row_tile_8_at_k_16_is_jax_and_the_oracle(params, boundary):
    """``tests/test_pallas.py:371-387``'s case (a row tile under the halo,
    K = 16) at 32x16: the port bit for bit the oracle, and within JAX's
    1e-6 of JAX's windowed kernel (whose shift algebra is a few ulp off
    the oracle: 1.2e-7 here)."""
    u, v = random_uv(np.random.RandomState(42), (32, 16))
    jax_sim = PallasSimulation(params, boundary=boundary, interpret=True,
                               engine="windowed", block_rows=8,
                               steps_per_call=16)
    want = run_jax(jax_sim, u, v, 16)
    assert want.storage[3] == 8 and want.storage[-1] == 16
    port = CudaSimulation(Parameters(), boundary, device="cpu",
                          engine="windowed", block_rows=8,
                          steps_per_call=16)
    got = run_port(port, u, v, 16)
    assert got.storage[-1] == (16, geometry.Geometry(8, 64, 16))
    for g, w, o in zip(got.uv_host(), want.uv_host(),
                       oracle.run(u, v, params, 16, boundary)):
        np.testing.assert_array_equal(g, o)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


@pytest.mark.parametrize("k,boundary", [(4, "naive"), (4, "zero"),
                                        (12, "zero"), (12, "naive")])
def test_bf16_under_a_k_pin_is_jax(params, k, boundary):
    """bf16 storage rounds once a K-step block: the port under a K pin bit
    for bit JAX's windowed kernel on bf16 storage under the same pin
    (``pallas_stencil.py:970-993``), over two blocks. Tolerance: none."""
    u, v = random_uv(np.random.RandomState(42), (32, 48))
    want = run_jax(PallasSimulation(params, boundary=boundary,
                                    interpret=True, engine="windowed",
                                    dtype="bfloat16", steps_per_call=k),
                   u, v, 2 * k)
    got = run_port(CudaSimulation(Parameters(), boundary, device="cpu",
                                  dtype="bfloat16", steps_per_call=k),
                   u, v, 2 * k)
    for g, w in zip(got.uv_host(), want.uv_host()):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("pins", [{"steps_per_call": 16},
                                  {"block_rows": 8, "steps_per_call": 4}])
def test_packed_pins_are_jax(params, pins):
    """K4 under a row tile and K (``pack='on'``) against JAX's packed
    windowed kernel under the same pins, within 1e-6 (JAX's compiler
    contracts the packed tree into fused multiply-adds differently:
    ``ops/packed.py:packed_step``)."""
    u, v = random_uv(np.random.RandomState(42), (32, 48))
    jax_sim = PallasSimulation(params, boundary="zero", interpret=True,
                               pack="on", engine="windowed", **pins)
    want = run_jax(jax_sim, u, v, 16)
    assert want.storage[0] == "packed"
    got = run_port(CudaSimulation(Parameters(), "zero", device="cpu",
                                  pack="on", engine="windowed", **pins),
                   u, v, 16)
    assert got.storage[0] == "packed"
    for g, w in zip(got.uv_host(), want.uv_host()):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


def test_harness_pins_reach_the_backends_as_jax(monkeypatch):
    """``--block-rows`` and ``--steps-per-call`` give the sweep the
    backend arguments JAX's harness gives its own."""
    from grayscott_tpu.bench import harness as jax_harness

    seen = {}

    def capture(name):
        def fake(names, **kw):
            seen[name] = kw["backend_kwargs"]
            return []
        return fake

    monkeypatch.setattr(harness, "sweep", capture("port"))
    monkeypatch.setattr(jax_harness, "sweep", capture("jax"))
    argv = ["--block-rows", "32", "--steps-per-call", "16"]
    harness.main(["--device", "cpu", *argv])
    jax_harness.main(argv)
    assert seen["port"] == seen["jax"] == {"block_rows": 32,
                                           "steps_per_call": 16}


def test_sweep_keys_are_jax():
    """The sweep's ``k``, ``tr`` and ``tc`` reach the backend under JAX's
    child's keywords (``scripts/_sweep_util.py``'s ``CHILD``)."""
    import os

    import grayscott_tpu

    path = os.path.join(os.path.dirname(os.path.dirname(
        grayscott_tpu.__file__)), "scripts", "_sweep_util.py")
    child = dict((key, kw) for kw, key in re.findall(
        r'(\w+)=cfg\.get\("(\w+)"', open(path).read()))
    for key in ("k", "tr", "tc"):
        assert _sweep_util.KEYS[key][0] == child[key]
    sim = _sweep_util.simulation({"k": 16, "tr": 32, "tc": 128,
                                  "boundary": "naive"}, device="cpu")
    assert (sim.steps_per_call, sim.block_rows, sim.block_cols) == \
        (16, 32, 128)


@pytest.mark.parametrize("cfg", [
    {"engine": "windowed", "k": 16, "tr": 32},
    {"tr": 64, "tc": 128}, {"k": 4}, {"engine": "mega"},
    {"engine": "windowed", "tc": None}])
def test_adopt_sweep_records_the_pins_as_jax(cfg):
    """A sweep result's record carries its ``tr``, ``k`` and, only where
    pinned, ``tc``, under JAX's rule for the engine
    (``scripts/adopt_sweep.py:59-104``; the default K the port's 8 where
    JAX's is 16)."""
    import importlib.util
    import os

    import grayscott_tpu

    path = os.path.join(os.path.dirname(os.path.dirname(
        grayscott_tpu.__file__)), "scripts", "adopt_sweep.py")
    spec = importlib.util.spec_from_file_location("jax_adopt_sweep", path)
    jax_adopt = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_adopt)
    res = {"config": cfg, "gcells_per_sec": 1.0}
    got, want = adopt_sweep.to_record(res), jax_adopt.to_record(res)
    for key in ("engine", "block_rows", "pack"):
        assert got[key] == want[key]
    assert ("block_cols" in got) == ("block_cols" in want)
    assert got.get("block_cols") == want.get("block_cols")
    assert got["steps_per_call"] == (cfg.get("k") or 8)
    assert want["steps_per_call"] == (cfg.get("k") or 16)
