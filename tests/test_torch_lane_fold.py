"""The lane fold (``--pallas-fold F``) on the port against the JAX package
on the CPU: ``ops/lane_fold.py``'s copies of JAX's helpers equal JAX's, the
port's folded run (K1's folded entry, its plain version here) is bit for
bit its unfolded run and the oracle, and within JAX's own 1e-6
(``tests/test_fold.py:53``) of JAX's folded kernel in interpret mode; the
refusals are JAX's; ``auto`` folds only on a fold record, as JAX's
``_fold_factor`` decides; the tuner's fold candidates are JAX's."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from grayscott_tpu import oracle
from grayscott_tpu.backends.pallas import PallasSimulation
from grayscott_tpu.bench import autotune as jax_autotune
from grayscott_tpu.errors import UnsupportedConfigError as JaxUnsupported
from grayscott_tpu.ops import pallas_stencil as ps
from grayscott_tpu.params import Parameters as JaxParameters
from grayscott_tpu.params import STENCILS
from grayscott_tpu_torch.backends.cuda import CudaSimulation
from grayscott_tpu_torch.bench import autotune
from grayscott_tpu_torch.errors import UnsupportedConfigError
from grayscott_tpu_torch.ops import lane_fold, windowed
from grayscott_tpu_torch.params import Parameters, kernel_constants
from grayscott_tpu_torch.species import Species

from conftest import random_uv


def run_port(u, v, steps, boundary="zero", stencil="oono-puri", **kw):
    """(U, V) on the host after ``steps`` steps of the port's cuda backend
    on the CPU, and the storage tag that ran."""
    sim = CudaSimulation(Parameters.with_stencil(stencil), boundary,
                         device="cpu", tuned_lookup=False, **kw)
    species = Species(u.shape, sim.build_storage(u, v), sim)
    sim.perform_steps(species, steps)
    return species.uv_host(), species.storage[0]


def run_jax(u, v, steps, boundary="zero", params=None, **kw):
    """JAX's folded run in interpret mode (``tests/test_fold.py``'s
    ``run_folded``)."""
    sim = PallasSimulation(params or JaxParameters(), boundary=boundary,
                           interpret=True, **kw)
    species = sim.make_species(u.shape)
    species.storage = sim.build_storage(u, v)
    assert species.storage[0] == "folded"
    sim.perform_steps(species, steps)
    return species.uv_host()


# -- the helpers --------------------------------------------------------------


@pytest.mark.parametrize("r,f,tr", [
    (32, 2, 8), (37, 3, 8), (37, 3, 16), (1080, 2, 64), (1001, 3, 64),
    (4096, 8, 64), (2048, 8, 64), (16, 2, 8), (5, 4, 8), (1, 1, 8)])
def test_fold_geometry_matches_jax(r, f, tr):
    assert lane_fold.fold_geometry(r, f, tr) == ps.fold_geometry(r, f, tr)


@pytest.mark.parametrize("shape,f,tr,halo", [
    ((32, 16), 2, 8, 8), ((37, 24), 3, 8, 8), ((37, 24), 3, 16, 16),
    ((40, 8), 4, 8, 8)])
def test_fold_state_and_unfold_match_jax(rng, shape, f, tr, halo):
    """Even panels (32x16, F = 2), uneven ones with dead rows (37x24,
    F = 3), a deeper halo: JAX's folded layout bit for bit, and both
    unfold to the domain."""
    u, v = random_uv(rng, shape)
    got = lane_fold.fold_state(u, v, f, tr, halo)
    want = ps.fold_state(u, v, f, tr, halo)
    for g, w, x in zip(got, want, (u, v)):
        np.testing.assert_array_equal(g.numpy(), w)
        back = lane_fold.unfold_state(g, halo, f, shape[1], shape[0])
        np.testing.assert_array_equal(back.numpy(), x)
        np.testing.assert_array_equal(
            back.numpy(),
            np.asarray(ps.unfold_state(w, halo, f, shape[1], shape[0])))


@pytest.mark.parametrize("shape,f,tr,halo", [
    ((32, 16), 2, 8, 8), ((37, 24), 3, 8, 8), ((37, 24), 3, 16, 16),
    ((64, 8), 8, 8, 8), ((20, 4), 1, 8, 8)])
def test_fold_refresh_matches_jax(rng, shape, f, tr, halo):
    """Every cell of a folded state, halos holding stale values first,
    after the port's in-place refresh and JAX's."""
    rp = lane_fold.fold_geometry(shape[0], f, tr)
    x = rng.uniform(0, 1, (2 * halo + rp, f * shape[1])).astype(np.float32)
    got = torch.from_numpy(x.copy())
    lane_fold.fold_refresh(got, halo, f, shape[1], rp)
    want = np.asarray(ps.fold_refresh(jnp.asarray(x), halo, f, shape[1],
                                      rp))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("r,c", [
    (1080, 1920), (4096, 4096), (2048, 2048), (128, 256), (4096, 512),
    (2048, 256), (1001, 1920), (256, 384), (3000, 100), (64, 3839),
    (900, 640), (500, 1000), (1, 1)])
def test_choose_fold_matches_jax(r, c):
    """JAX's table (``tests/test_fold.py:141``) and more."""
    assert lane_fold.choose_fold(r, c) == ps.choose_fold(r, c)
    assert lane_fold.FOLD_TARGET_LANES == ps.FOLD_TARGET_LANES


# -- the folded run -----------------------------------------------------------


@pytest.mark.parametrize("shape,f,tr", [((32, 16), 2, 8), ((37, 24), 3, 8),
                                        ((37, 24), 3, None)])
@pytest.mark.parametrize("boundary", ["zero", "naive"])
@pytest.mark.parametrize("stencil", sorted(STENCILS))
@pytest.mark.parametrize("k", [1, 8, 16])
@pytest.mark.parametrize("steps", [1, 8, 19])
def test_folded_run_is_unfolded_and_oracle(rng, shape, f, tr, boundary,
                                           stencil, k, steps):
    """Bit for bit the same pins unfolded and the oracle: every panel steps
    at its global origin, the refresh runs before each K-step block (19
    steps leave a remainder block), the dead rows past R stay out."""
    u, v = random_uv(rng, shape)
    pins = dict(steps_per_call=k, block_rows=tr)
    (fu, fv), tag = run_port(u, v, steps, boundary, stencil, fold=f, **pins)
    assert tag == "folded"
    (pu, pv), tag = run_port(u, v, steps, boundary, stencil, **pins)
    assert tag == "windowed"
    ou, ov = oracle.run(u, v, JaxParameters.with_stencil(stencil), steps,
                        boundary)
    for got, want in ((fu, pu), (fv, pv), (fu, ou), (fv, ov)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,f,boundary,steps,jax_params", [
    ((32, 16), 2, "zero", 19, None),
    ((37, 24), 3, "zero", 9, None),
    ((32, 16), 2, "naive", 19, None),
    ((37, 24), 3, "naive", 9, None),
    ((32, 16), 2, "zero", 6, "runtime"),
])
def test_folded_run_matches_jax(rng, shape, f, boundary, steps, jax_params):
    """Within JAX's 1e-6 of its folded kernel in interpret mode on the same
    pins (``block_rows=8``; its shift algebra is a few ulp off the
    oracle's tree, which the port's is bit for bit), runtime parameters
    included (``tests/test_fold.py:106``)."""
    u, v = random_uv(rng, shape)
    params = dict(feed_rate=0.03, kill_rate=0.059) if jax_params else {}
    want = run_jax(u, v, steps, boundary, JaxParameters(**params), fold=f,
                   block_rows=8, runtime_params=bool(jax_params))
    sim = CudaSimulation(Parameters(**params), boundary, device="cpu",
                         tuned_lookup=False, fold=f, block_rows=8)
    species = Species(shape, sim.build_storage(u, v), sim)
    sim.perform_steps(species, steps)
    for got, w in zip(species.uv_host(), want):
        np.testing.assert_allclose(got, w, rtol=0, atol=1e-6)


def test_folded_layout_and_launches(rng):
    """The storage is JAX's layout at the port's panel stride (Rp of the
    panel's row tile: 576 at 1080 rows, F = 2, 64-row tiles), V alone
    comes out of ``extract_result``, and the CPU launches nothing."""
    shape = (1080, 128)
    u, v = random_uv(rng, shape)
    sim = CudaSimulation(Parameters(), "zero", device="cpu", fold=2)
    storage = sim.build_storage(u, v)
    assert storage[0] == "folded" and storage[6] == (2, 576)
    (k, g) = storage[5]
    assert (k, g.tr, g.halo) == (8, 64, 8)
    assert tuple(storage[1].shape) == (576 + 16, 256)
    np.testing.assert_array_equal(
        storage[1].numpy(), ps.fold_state(u, v, 2, 64, 8)[0])
    before = windowed.folded_launches
    storage = sim.run_steps(storage, shape, 3)
    assert windowed.folded_launches == before
    np.testing.assert_array_equal(
        sim.extract_result(storage, shape).numpy(),
        sim.extract_uv(storage, shape)[1].numpy())


def test_wrapper_checks_the_layout():
    """The folded entry's wrapper refuses a layout it does not hold."""
    g = windowed.COMPILED
    x = torch.zeros((16 + 64, 2 * 24))
    k = kernel_constants(Parameters())
    with pytest.raises(ValueError, match="panel stride"):
        windowed.folded_multistep(x, x.clone(), x.clone(), x.clone(), 8, k,
                                  "zero", (37, 24), 48 + 16,
                                  geometry=g._replace(tr=16))
    with pytest.raises(ValueError, match="a folded state"):
        windowed.folded_multistep(x, x.clone(), x.clone(), x.clone(), 8, k,
                                  "zero", (37, 24), 32, geometry=g)
    with pytest.raises(ValueError, match="steps"):
        windowed.folded_multistep(x, x.clone(), x.clone(), x.clone(), 9, k,
                                  "zero", (37, 24), 64, geometry=g)


# -- refusals -----------------------------------------------------------------


@pytest.mark.parametrize("kwargs,shape,text", [
    ({"fold": 2, "dtype": "bfloat16"}, (32, 16),
     "fold excludes bf16 storage and column tiling"),
    ({"fold": 2, "block_cols": 128}, (32, 256),
     "fold excludes bf16 storage and column tiling"),
    ({"fold": 2, "resident": "on"}, (32, 16),
     "resident='on' and a pinned lane fold conflict"),
    ({"fold": 2, "naive_fold": True, "boundary": "naive"}, (32, 16),
     "naive_fold excludes the lane-fold layout"),
    ({"fold": 3, "engine": "mega"}, (32, 16), "and no lane fold"),
    ({"fold": 2, "pack": "on"}, (32, 16),
     "pack requires the zero boundary, f32 storage, a separable stencil "
     "plan, and no fold/column tiling"),
    ({"fold": 2, "block_rows": 8, "steps_per_call": 16}, (16, 16),
     "fold=2 on a 16-row domain leaves panels of 8 rows < the 16-row halo"),
    ({"fold": 4, "block_rows": 8, "steps_per_call": 16}, (24, 16),
     "fold=4 on a 24-row domain leaves panels of 8 rows"),
    ({"fold": 0}, (32, 16), "fold must be auto/off/int >= 1"),
    ({"fold": "wide"}, (32, 16), "fold must be auto/off/int"),
])
def test_refusals_match_jax(rng, kwargs, shape, text):
    """JAX's refusals of the fold, with its class and text, when the
    simulation is built or its storage (the panel thinner than the halo
    there too): JAX's messages, the megakernel's only to its geometry."""
    kwargs = dict(kwargs)
    boundary = kwargs.pop("boundary", "zero")
    u, v = random_uv(rng, shape)
    outcomes = []
    for cls, params, errors in (
            (PallasSimulation, JaxParameters(), (JaxUnsupported, ValueError)),
            (CudaSimulation, Parameters(),
             (UnsupportedConfigError, ValueError))):
        extra = {"interpret": True} if cls is PallasSimulation else {
            "device": "cpu"}
        with pytest.raises(errors) as info:
            cls(params, boundary=boundary, tuned_lookup=False, **extra,
                **kwargs).build_storage(u, v)
        assert text in str(info.value)
        outcomes.append(isinstance(info.value, errors[0]))
    assert outcomes[0] == outcomes[1]


def test_naive_fold_at_any_width_runs(rng):
    """JAX's TPU run refuses a naive fold on a width that is not a multiple
    of 128 (its lane tile; ``backends/pallas.py:338-344``); its interpret
    mode computes it, and so does the port, the oracle bit for bit."""
    u, v = random_uv(rng, (32, 24))
    with pytest.raises(JaxUnsupported, match="multiple of 128"):
        PallasSimulation(JaxParameters(), boundary="naive", interpret=False,
                         fold=2, block_rows=8).build_storage(u, v)
    (fu, fv), tag = run_port(u, v, 9, "naive", fold=2)
    assert tag == "folded"
    ou, ov = oracle.run(u, v, JaxParameters(), 9, "naive")
    np.testing.assert_array_equal(fu, ou)
    np.testing.assert_array_equal(fv, ov)


# -- auto's record rule -------------------------------------------------------

#: a fold record of the tuner's schema
FOLD_RECORD = {"engine": "windowed", "block_rows": 32, "steps_per_call": 16,
               "block_cols": None, "fold": 2, "pack": False}


@pytest.mark.parametrize("kwargs,boundary,shape,record", [
    ({}, "zero", (64, 64), FOLD_RECORD),
    ({}, "naive", (64, 128), FOLD_RECORD),
    ({}, "naive", (64, 96), FOLD_RECORD),
    ({}, "zero", (64, 64), dict(FOLD_RECORD, fold=1)),
    ({}, "zero", (64, 64), dict(FOLD_RECORD, fold=None)),
    ({}, "zero", (64, 64), {"engine": "windowed", "pack": False}),
    ({}, "zero", (64, 64), None),
    ({"fold": "off"}, "zero", (64, 64), FOLD_RECORD),
    ({"fold": 3}, "zero", (64, 64), FOLD_RECORD),
    ({"fold": 1}, "zero", (64, 64), FOLD_RECORD),
    ({"dtype": "bfloat16"}, "zero", (64, 64), FOLD_RECORD),
    ({"block_cols": 128}, "zero", (64, 256), FOLD_RECORD),
    ({"resident": "on"}, "zero", (64, 64), FOLD_RECORD),
    ({"naive_fold": True}, "naive", (64, 128), FOLD_RECORD),
    ({"steps_per_call": 16}, "zero", (64, 64), FOLD_RECORD),
])
def test_auto_folds_as_jax_does(kwargs, boundary, shape, record):
    """The fold factor of a domain under the pins and the record: JAX's
    ``_fold_factor`` (its TPU path, which follows records; interpret mode
    never folds on ``auto``), the port's ``fold_for``."""
    jax_sim = PallasSimulation(JaxParameters(), boundary=boundary,
                               interpret=False, **kwargs)
    port = CudaSimulation(Parameters(), boundary, device="cpu", **kwargs)
    assert port.fold_for(shape, record) == \
        jax_sim._fold_factor(shape, record)


@pytest.mark.parametrize("kwargs,want", [
    ({}, ("folded", 2)),
    ({"engine": "windowed"}, ("folded", 2)),
    ({"engine": "mega"}, ("mega", None)),
    ({"pack": "on"}, ("megapack", None)),
    ({"resident": "on"}, ("resident", None)),
    ({"fold": "off"}, ("windowed", None)),
])
def test_a_fold_record_steers_auto(monkeypatch, rng, kwargs, want):
    """``auto`` folds on a fold record (its K, and its row tile where the K
    is the run's), an engine or layout pin wins over it (JAX: the
    megakernel and the packed layout run, the packed one on its own
    ranking, ``resident='on'`` runs K3), and with the fold off the
    record's K and tiles are dropped (``backends/pallas.py:633-636``) and
    its engine kept: K1 on its default tiles at K = 8."""
    monkeypatch.setattr(autotune, "lookup", lambda *a, **k: FOLD_RECORD)
    sim = CudaSimulation(Parameters(), "zero", device="cpu", **kwargs)
    u, v = random_uv(rng, (96, 64))
    storage = sim.build_storage(u, v)
    assert storage[0] == want[0]
    if want[0] == "folded":
        k, g = storage[5]
        assert storage[6][0] == want[1] and (k, g.tr) == (16, 32)
    if want[0] == "windowed":
        k, g = storage[5]
        assert (k, g.tr, g.tc) == (8, 64, 64)


# -- the tuner ----------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1080, 1920), (4096, 512), (2048, 256),
                                   (4096, 4096), (256, 384), (1080, 1000),
                                   (3000, 100)])
@pytest.mark.parametrize("boundary", ["zero", "naive"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fold_candidates_match_jax(shape, boundary, dtype):
    assert autotune.fold_candidates(shape, boundary, dtype) == \
        jax_autotune._fold_candidates(shape, boundary, dtype)


def test_fold_candidates_join_on_the_card_only():
    """JAX tries the fold on the TPU only (``bench/autotune.py:419-426``):
    the port's candidates on a CUDA device, none on the CPU, none without a
    shape or under a pin."""
    params, shape = Parameters(), (1080, 1920)
    cpu = autotune.default_candidates(params, "zero", shape=shape)
    card = autotune.default_candidates(params, "zero", shape=shape,
                                       device="cuda")
    assert card == cpu + [{"fold": 2, "steps_per_call": 16},
                          {"fold": 2, "steps_per_call": 8}]
    assert autotune.default_candidates(params, "zero", device="cuda") == \
        autotune.default_candidates(params, "zero")
    assert not any("fold" in c for c in autotune.default_candidates(
        params, "zero", shape=shape, device="cuda", steps_per_call=16))


def test_measured_record_keeps_its_fold(monkeypatch, tmp_path):
    """A fold candidate's record names the fold and the K it ran, and the
    backend follows it; an unfolded one keeps ``fold: 1``."""
    monkeypatch.setenv("GRAYSCOTT_CACHE_DIR", str(tmp_path))
    params, shape = Parameters(), (96, 64)
    rec = autotune.measure_config(params, shape, "zero", steps=8, reps=1,
                                  device="cpu", fold=2, steps_per_call=16)
    assert (rec["engine"], rec["fold"], rec["steps_per_call"],
            rec["pack"]) == ("windowed", 2, 16, False)
    plain = autotune.measure_config(params, shape, "zero", steps=8, reps=1,
                                    device="cpu", engine="windowed")
    assert plain["fold"] == 1
    sim = CudaSimulation(params, "zero", device="cpu")
    assert sim.fold_for(shape, rec) == 2
    assert sim.fold_for(shape, plain) == 1
