"""The temporal depth and the tile pins of K1 and K4 on the CPU
(``ops/geometry.py``, ``backends/cuda.py``, ``bench/autotune.py``): the
geometry rule (what fits the shared memory a block may use, the default
dimension, the refusal with its bytes), the backend under the pins bit for
bit the oracle and the unpinned run, bf16 storage rounded once a K-step
block, the launch plan, and the tuner's candidates and records under the
pins. tests/test_torch_tile_pins_jax.py holds the same against the JAX
package; the kernels themselves run in tests/test_torch_gpu.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from grayscott_tpu import oracle
from grayscott_tpu.params import Parameters as JaxParameters
from grayscott_tpu_torch.backends.cuda import CudaSimulation
from grayscott_tpu_torch.bench import autotune
from grayscott_tpu_torch.errors import UnsupportedConfigError
from grayscott_tpu_torch.ops import geometry, packed, stencil, windowed
from grayscott_tpu_torch.params import (Parameters, fold_constants,
                                        kernel_constants, packed_constants)
from grayscott_tpu_torch.species import Species
from grayscott_tpu_torch.utils import cache

from conftest import random_uv

#: the pins the backend cases run: K alone (below, at and past the
#: compiled halo, the deepest), tiles alone, and both
PINS = [{"steps_per_call": 1}, {"steps_per_call": 4},
        {"steps_per_call": 12}, {"steps_per_call": 16},
        {"steps_per_call": 32}, {"block_rows": 8},
        {"block_rows": 16, "block_cols": 8}, {"block_cols": 13},
        {"block_rows": 8, "steps_per_call": 16},
        {"block_rows": 544, "block_cols": 64, "steps_per_call": 3}]
STENCILS = ["oono-puri", "5points", "pretty"]


@pytest.fixture(autouse=True)
def store(monkeypatch, tmp_path):
    """An empty autotune store of the test's own."""
    monkeypatch.setenv("GRAYSCOTT_CACHE_DIR", str(tmp_path / "store"))


def run(sim, u, v, steps):
    species = Species(u.shape, sim.build_storage(u, v), sim)
    sim.perform_steps(species, steps)
    return species


# -- the geometry rule -------------------------------------------------------


#: worked sizes: (K, block_rows, block_cols) -> (tile, halo, bytes, blocks
#: an SM)
WORKED = {
    (8, None, None): ((64, 64), 8, 102400, 2),
    (5, None, None): ((64, 64), 8, 102400, 2),
    (16, None, None): ((64, 64), 16, 147456, 1),
    (24, None, None): ((64, 64), 24, 200704, 1),
    (32, None, None): ((56, 56), 32, 230400, 1),
    (8, 64, 128): ((64, 128), 8, 184320, 1),
    (8, None, 256): ((32, 256), 8, 208896, 1),
    (8, 32, 256): ((32, 256), 8, 208896, 1),
    (8, 544, None): ((544, 8), 8, 215040, 1),
}


@pytest.mark.parametrize("pins", sorted(WORKED, key=str))
def test_worked_sizes(pins):
    """The tile, halo, bytes and blocks an SM of the worked sizes: an
    unpinned dimension 64, or the largest multiple of 8 whose window fits
    (both together when neither is pinned)."""
    k, tr, tc = pins
    g = geometry.resolve((4096, 4096), k, tr, tc)
    assert ((g.tr, g.tc), g.halo, g.bytes, g.blocks_per_sm) == WORKED[pins]
    assert g.compiled == (pins in ((8, None, None), (5, None, None)))


@pytest.mark.parametrize("pins,nbytes", [
    ((32, 64, 64), 262144), ((8, 544, 64), 716800), ((16, 64, 256), 442368),
    ((8, 8, 8192), 3151872)])
def test_window_past_the_shared_memory_is_refused_with_its_bytes(pins,
                                                                 nbytes):
    k, tr, tc = pins
    with pytest.raises(UnsupportedConfigError, match=f"needs {nbytes} B"):
        geometry.resolve((4096, 8192), k, tr, tc)
    with pytest.raises(UnsupportedConfigError, match=str(geometry.SMEM_OPTIN)):
        geometry.resolve((4096, 8192), k, tr, tc)


@pytest.mark.parametrize("k", list(range(1, 33)))
def test_every_accepted_pin_fits_and_the_next_size_is_refused(k):
    """For every K: each pinned square tile that resolves fits 232,448 B,
    and the first multiple of 8 past the largest that fits is refused,
    naming its bytes."""
    h = geometry.halo_for_steps(k)
    fits = [t for t in range(8, 257, 8)
            if geometry.window_bytes(t, t, h) <= geometry.SMEM_OPTIN]
    for t in fits:
        g = geometry.resolve((4096, 4096), k, t, t)
        assert (g.tr, g.tc, g.halo) == (t, t, h)
        assert g.bytes <= geometry.SMEM_OPTIN
    past = fits[-1] + 8
    with pytest.raises(UnsupportedConfigError,
                       match=f"{geometry.window_bytes(past, past, h)} B"):
        geometry.resolve((4096, 4096), k, past, past)


@pytest.mark.parametrize("value", [0, -8, 33, 1.5, True, "16"])
def test_steps_per_call_outside_1_32_raises_jax_value_error(value):
    with pytest.raises(ValueError, match=r"steps_per_call must be in \[1, "
                       r"32\]"):
        geometry.resolve((64, 64), value)
    with pytest.raises(ValueError, match="steps_per_call must be in"):
        CudaSimulation(Parameters(), device="cpu", steps_per_call=value)


@pytest.mark.parametrize("kw", [{"block_rows": 0}, {"block_cols": -1},
                                {"block_rows": 2.0}, {"block_cols": True}])
def test_bad_tile_raises_value_error(kw):
    with pytest.raises(ValueError, match="positive int"):
        CudaSimulation(Parameters(), device="cpu", **kw)


@pytest.mark.parametrize("shape,tr,want", [
    ((40, 48), 64, 40), ((33, 48), 64, 40), ((33, 48), 13, 13),
    ((1, 5), 256, 8), ((1080, 1920), 544, 544)])
def test_pinned_height_steps_down_past_the_padded_rows(shape, tr, want):
    """JAX's ``_tr``: while tr > 8 and tr > the rows rounded up to 8, tr
    -= 8 (``backends/pallas.py:284-287``)."""
    assert geometry.resolve(shape, 8, tr, 8).tr == want


@pytest.mark.parametrize("tc,want", [(48, 48), (200, 97), (97, 97),
                                     (13, 13)])
def test_width_of_the_domain_or_more_is_one_tile_column(tc, want):
    assert geometry.resolve((70, 97), 8, None, tc).tc == want


def test_stepped_area_ratio():
    """The halo recompute: 1.236 cells stepped per output cell-step at K =
    8 on 64x64 tiles, 1.544 at K = 16."""
    assert geometry.DEFAULT.stepped_ratio(8) == pytest.approx(1.2358, 1e-4)
    g = geometry.resolve((4096, 4096), 16)
    assert g.stepped_ratio(16) == pytest.approx(1.5444, 1e-4)


def test_interior_tiles_at_any_tile_shape():
    """``stencil.interior_tiles_at`` counts the interior tiles of any tile
    shape and halo, as a direct count of the windows inside the domain."""
    for shape in ((1080, 1920), (70, 97)):
        for g in (geometry.resolve(shape, 16), geometry.resolve(shape, 8, 32,
                                                                128),
                  geometry.resolve(shape, 24, 13, 37)):
            want = sum(
                i * g.tr - g.halo >= 0 and j * g.tc - g.halo >= 0
                and (i + 1) * g.tr + g.halo <= shape[0]
                and (j + 1) * g.tc + g.halo <= shape[1]
                for i in range(-(-shape[0] // g.tr))
                for j in range(-(-shape[1] // g.tc)))
            assert stencil.interior_tiles_at((0, 0), shape, shape,
                                             (g.tr, g.tc), g.halo) == want


# -- the backend under the pins ---------------------------------------------


@pytest.mark.parametrize("pins", PINS, ids=str)
@pytest.mark.parametrize("boundary", ["naive", "zero"])
@pytest.mark.parametrize("stencil_name", STENCILS)
def test_pins_bitwise_oracle_and_unpinned(rng, pins, boundary, stencil_name):
    """K1 under each pin: bit for bit ``oracle.run`` and the unpinned run
    (exact float32 results do not depend on K or the tiles)."""
    u, v = random_uv(rng, (37, 53))
    params = Parameters.with_stencil(stencil_name)
    sim = CudaSimulation(params, boundary, device="cpu", **pins)
    got = run(sim, u, v, 19)
    assert got.storage[0] == "windowed"
    plain = run(CudaSimulation(params, boundary, device="cpu",
                               engine="windowed"), u, v, 19)
    want = oracle.run(u, v, JaxParameters.with_stencil(stencil_name), 19,
                      boundary)
    for g, p, w in zip(got.uv_host(), plain.uv_host(), want):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, p)


@pytest.mark.parametrize("k", [1, 3, 8, 12, 16, 32])
def test_launch_plan_is_ceil_steps_over_k(monkeypatch, k):
    """``run_steps`` makes ceil(steps / K) launches of at most K steps, on
    the geometry the pins give: the compiled one for 64x64 tiles at
    K <= 8."""
    calls = []

    def spy(u, v, u_out, v_out, steps, consts, boundary, fold=False,
            geometry=None):
        calls.append((steps, geometry))
        u_out.copy_(u)
        v_out.copy_(v)

    monkeypatch.setattr(windowed, "multistep", spy)
    sim = CudaSimulation(Parameters(), "naive", device="cpu",
                         steps_per_call=k)
    species = Species((70, 97), sim.build_storage(
        *random_uv(np.random.RandomState(0), (70, 97))), sim)
    sim.perform_steps(species, 32)
    assert [s for s, _ in calls] == [k] * (32 // k) + (
        [32 % k] if 32 % k else [])
    g = calls[0][1]
    assert g == geometry.resolve((70, 97), k)
    assert g.compiled == (k <= 8)


@pytest.mark.parametrize("k", [4, 12, 16])
@pytest.mark.parametrize("boundary", ["naive", "zero"])
def test_bf16_rounds_once_a_k_step_block(rng, k, boundary):
    """bf16 storage under a K pin: ``stencil.run_bf16`` with a block of K
    (the oracle rounded to bf16 after every K steps), bit for bit; another
    K gives other bits."""
    u, v = random_uv(rng, (32, 48))
    sim = CudaSimulation(Parameters(), boundary, device="cpu",
                         dtype="bfloat16", steps_per_call=k)
    got = run(sim, u, v, 24).uv_host()
    bu, bv = (torch.from_numpy(x).to(torch.bfloat16) for x in (u, v))
    want = stencil.run_bf16(bu, bv, 24, kernel_constants(Parameters()),
                            boundary, block=k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.float().numpy())
    at8 = run(CudaSimulation(Parameters(), boundary, device="cpu",
                             dtype="bfloat16"), u, v, 24).uv_host()
    assert not np.array_equal(got[1], at8[1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fold_under_pins(rng, dtype):
    """The folded naive reaction under a K and tile pin: its plain version
    (bf16: rounded once a K-step block)."""
    u, v = random_uv(rng, (37, 53))
    sim = CudaSimulation(Parameters(), "naive", device="cpu", dtype=dtype,
                         naive_fold=True, steps_per_call=12, block_rows=16)
    got = run(sim, u, v, 24).uv_host()
    fc = fold_constants(Parameters())
    tu, tv = (torch.from_numpy(x) for x in (u, v))
    if dtype == "bfloat16":
        tu, tv = tu.to(torch.bfloat16), tv.to(torch.bfloat16)
        want = stencil.run_naive_fold_bf16(tu, tv, 24, fc, block=12)
    else:
        want = stencil.run_naive_fold(tu, tv, 24, fc)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.float().numpy())


@pytest.mark.parametrize("pins", [{"steps_per_call": 16},
                                  {"block_rows": 8},
                                  {"block_rows": 32, "steps_per_call": 3}])
def test_packed_pins_run_k4(rng, pins):
    """``pack='on'`` with a row tile and/or K runs K4 under them, bit for
    bit ``packed_run``; with ``block_cols`` it is refused with JAX's
    message."""
    u, v = random_uv(rng, (37, 53))
    sim = CudaSimulation(Parameters(), "zero", device="cpu", pack="on",
                         **pins)
    species = run(sim, u, v, 19)
    assert species.storage[0] == "packed"
    x = packed.pack_state(*(torch.from_numpy(a) for a in (u, v)))
    want = packed.unpack_state(packed.packed_run(
        x, 19, packed_constants(Parameters())), 53)
    for g, w in zip(species.uv_host(), want):
        np.testing.assert_array_equal(g, w.numpy())
    with pytest.raises(UnsupportedConfigError, match="no fold/column tiling"):
        CudaSimulation(Parameters(), "zero", device="cpu", pack="on",
                       block_cols=64, **pins)


@pytest.mark.parametrize("kwargs,storage", [
    ({"steps_per_call": 16}, "windowed"),
    ({"block_rows": 64}, "windowed"),
    ({"block_cols": 64, "pack": "auto"}, "windowed"),
    ({"steps_per_call": 16, "resident": "on"}, "resident"),
    ({"block_rows": 32, "resident": "on", "pack": "on"}, "respack"),
    ({"steps_per_call": 8, "engine": "mega"}, "mega"),
    ({"steps_per_call": 16, "engine": "windowed", "pack": "on"}, "packed"),
])
def test_pins_hold_auto_to_the_windowed_kernel(monkeypatch, kwargs,
                                               storage):
    """Under a K or tile pin ``auto`` runs K1, packs only on
    ``pack='on'`` and follows no record's engine (JAX's
    ``backends/pallas.py:447-460``, ``:485-497``, ``:526-532``);
    ``resident='on'`` still runs K3 (K5 packed), as JAX checks it first
    (``_use_resident``, ``:482-484``); ``engine='mega'`` takes K = 8."""
    monkeypatch.setattr(
        autotune, "lookup", lambda *a, **k: {"engine": "mega", "pack": True,
                                              "steps_per_call": 8})
    sim = CudaSimulation(Parameters(), "zero", device="cpu", **kwargs)
    u, v = random_uv(np.random.RandomState(1), (40, 48))
    assert sim.build_storage(u, v)[0] == storage


@pytest.mark.parametrize("kwargs,item", [
    ({"engine": "mega", "steps_per_call": 16}, "fixes steps-per-call"),
    # the megakernels' tile pins run (tests/test_torch_mega_pins.py), and
    # so do their window rings (tests/test_torch_ring_pins_jax.py): a lane
    # fold under the megakernel, and the values JAX's megakernels refuse
    ({"engine": "mega", "fold": 2}, "and no lane fold"),
    ({"engine": "mega", "block_rows": 12}, "unsupported for shape"),
    ({"engine": "mega", "pack": "on", "block_rows": 20},
     "with pack needs full-width"),
    ({"steps_per_call": 32, "block_rows": 64, "block_cols": 64},
     "262144 B"),
])
def test_pins_the_port_refuses(kwargs, item):
    with pytest.raises(UnsupportedConfigError, match=item):
        sim = CudaSimulation(Parameters(), "zero", device="cpu", **kwargs)
        sim.build_storage(*random_uv(np.random.RandomState(1), (64, 64)))


# -- records and the tuner ---------------------------------------------------


def put(key, **rec):
    store = cache.load_autotune()
    store[key] = {"engine": "windowed", "pack": False, "fold": 1,
                  "block_rows": None, "block_cols": None,
                  "steps_per_call": 8, "gcells_per_sec": 1.0, **rec}
    cache.save_autotune(store)
    return store[key]


@pytest.mark.parametrize("pins,rec,want", [
    # unpinned: the record's K and tiles
    ({}, {"steps_per_call": 16, "block_rows": 32, "block_cols": 128},
     (16, 32, 128)),
    # a K pin keys its own records: a record under it gives its tiles
    ({"steps_per_call": 16}, {"steps_per_call": 16, "block_rows": 32},
     (16, 32, 64)),
    # a tile pin: the record's K, the pinned tile
    ({"block_rows": 16}, {"steps_per_call": 12, "block_rows": 16,
                          "block_cols": 8}, (12, 16, 8)),
    # a record of another engine or layout gives nothing
    ({}, {"engine": "mega", "steps_per_call": 16}, (8, 64, 64)),
    ({}, {"pack": True, "steps_per_call": 16}, (8, 64, 64)),
])
def test_records_k_and_tiles_adopted_off_a_pin(pins, rec, want):
    """A record's K is adopted where K is not pinned, its tiles where they
    are not pinned (``backends/pallas.py:270-327``), from the record of
    the run's own pins (``autotune.key_for``), a windowed one of the run's
    layout."""
    params = Parameters()
    put(autotune.key_for(params, (1080, 1920), "naive", device="cpu",
                         **pins), **rec)
    sim = CudaSimulation(params, "naive", device="cpu", engine="windowed",
                         **pins)
    k, g = sim.plan_for((1080, 1920), False, sim.tuned((1080, 1920)))
    assert (k, g.tr, g.tc) == want


def test_tiles_of_another_k_do_not_transfer():
    """ADVICE.md #2: a record's tiles measured at another K are not
    adopted under a K pin; its K never crosses the pin either."""
    sim = CudaSimulation(Parameters(), "naive", device="cpu",
                         steps_per_call=16)
    rec = {"engine": "windowed", "pack": False, "steps_per_call": 8,
           "block_rows": 32, "block_cols": 128}
    k, g = sim.plan_for((1080, 1920), False, rec)
    assert (k, g.tr, g.tc) == (16, 64, 64)


@pytest.mark.parametrize("pins", [
    {"steps_per_call": 16}, {"steps_per_call": 4}, {"block_rows": 32},
    {"block_cols": 128}, {"block_rows": 8, "block_cols": 512},
    {"steps_per_call": 32, "block_rows": 64}])
def test_candidates_never_cross_a_pin(pins):
    """Under a K or tile pin the candidates are K1's under that pin (K 8
    and 16, and the three tile shapes, where open), each whose window
    fits the domain."""
    cands = autotune.default_candidates(Parameters(), "zero", "float32",
                                        (1080, 1920), **pins)
    assert cands
    for c in cands:
        assert c["engine"] == "windowed" and "pack" not in c
        for key, value in pins.items():
            assert c[key] == value
        geometry.resolve((1080, 1920), c["steps_per_call"],
                         c.get("block_rows"), c.get("block_cols"))
    if "steps_per_call" not in pins:
        assert {c["steps_per_call"] for c in cands} <= {8, 16}


def test_tuner_under_a_pin_keys_measures_and_is_followed(monkeypatch):
    """``autotune`` under a K pin measures only K1 at that K, persists the
    winner under the pinned key with the K and tiles it ran, and a run
    under the same pin adopts its tiles; an unpinned run does not see
    it."""
    monkeypatch.setattr(autotune, "STEPS", 16)
    params = Parameters()
    rec = autotune.autotune(params, (40, 48), "naive", device="cpu",
                            reps=1, steps_per_call=16)
    assert rec["steps_per_call"] == 16 and rec["engine"] == "windowed"
    assert {c["steps_per_call"] for c in rec["candidates"]} == {16}
    key = autotune.key_for(params, (40, 48), "naive", device="cpu",
                           steps_per_call=16)
    assert key.endswith("|k16") and list(cache.load_autotune()) == [key]
    sim = CudaSimulation(params, "naive", device="cpu", steps_per_call=16)
    assert sim.tuned((40, 48)) == rec
    assert CudaSimulation(params, "naive", device="cpu").tuned(
        (40, 48)) is None
