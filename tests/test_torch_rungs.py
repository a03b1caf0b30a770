"""The port's four plain rungs of the ladder (grayscott_tpu_torch/backends/
{naive,regular,fused,conv}.py) and the shift algebra they step
(ops/stencil.py: step_fast, step_runtime) on the CPU, mirroring
tests/test_backends.py and tests/test_goldens.py: against the numpy
oracle, the goldens, and JAX's rung of the same name on the same seeded
input. Every shape is 64x96 or smaller.

Tolerances: the oracle's tree is bitwise (naive rung); the shift algebra
reassociates the stencil sum, a few ulp a step (2e-7 one step, 3e-7 for
the other stencils, 1e-5 over 64 steps from the standard state, 2e-5 for
the goldens, as the JAX tests); against JAX's rung 1e-6 after 8 steps,
since XLA on the CPU contracts some multiply-adds that PyTorch rounds
twice."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from grayscott_tpu import oracle
from grayscott_tpu.backends import get_backend as jax_get_backend
from grayscott_tpu.ops import stencil as jax_stencil
from grayscott_tpu.params import Parameters as JaxParameters
from grayscott_tpu_torch.backends import (BACKENDS, best_backend_name,
                                          get_backend)
from grayscott_tpu_torch.bench import harness
from grayscott_tpu_torch.cli import shared, simulate
from grayscott_tpu_torch.ops import stencil
from grayscott_tpu_torch.params import STENCILS, Parameters
from grayscott_tpu_torch.species import initial_uv

RUNGS = ["naive", "regular", "fused", "conv"]
BOUNDARIES = ["naive", "zero"]
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
GOLDENS = [
    ("naive_oono_64x96_100", (64, 96), "oono-puri", "naive", 100, {}),
    ("zero_oono_48x64_64", (48, 64), "oono-puri", "zero", 64, {}),
    ("naive_pk_32x32_50", (32, 32), "patra-karttunen", "naive", 50, {}),
    ("naive_oono_fk_40x56_80", (40, 56), "oono-puri", "naive", 80,
     dict(feed_rate=0.03, kill_rate=0.062)),
]


def random_uv(shape, seed=42):
    rng = np.random.RandomState(seed)
    return tuple(rng.uniform(0.0, 1.0, shape).astype(np.float32)
                 for _ in range(2))


def run_rung(name, params, boundary, u, v, steps, **kw):
    sim = get_backend(name)(params, boundary=boundary, device="cpu", **kw)
    species = sim.make_species(u.shape)
    species.storage = sim.build_storage(u, v)
    sim.perform_steps(species, steps)
    return species.uv_host()


def run_jax_rung(name, params, boundary, u, v, steps, **kw):
    sim = jax_get_backend(name)(params, boundary=boundary, **kw)
    species = sim.make_species(u.shape)
    species.storage = sim.build_storage(u, v)
    sim.perform_steps(species, steps)
    return species.uv_host()


def assert_close(got, want, atol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=atol)


@pytest.mark.parametrize("rung", RUNGS)
@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_one_step_against_oracle(rung, boundary):
    u, v = random_uv((24, 33))
    got = run_rung(rung, Parameters(), boundary, u, v, 1)
    assert_close(got, oracle.step(u, v, JaxParameters(), boundary), 2e-7)


@pytest.mark.parametrize("rung", RUNGS)
@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("stencil_name", sorted(STENCILS))
def test_every_stencil_one_step(rung, boundary, stencil_name):
    u, v = random_uv((16, 17))
    got = run_rung(rung, Parameters.with_stencil(stencil_name), boundary,
                   u, v, 1)
    want = oracle.step(u, v, JaxParameters.with_stencil(stencil_name),
                       boundary)
    assert_close(got, want, 3e-7)


@pytest.mark.parametrize("rung", RUNGS)
@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_64_steps_from_the_standard_state(rung, boundary):
    shape = (48, 64)
    u0, v0 = initial_uv(shape)
    got = run_rung(rung, Parameters(), boundary, u0, v0, 64)
    assert_close(got, oracle.run(u0, v0, JaxParameters(), 64, boundary),
                 1e-5)


@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("stencil_name", sorted(STENCILS))
def test_naive_rung_is_bitwise_to_the_oracle(boundary, stencil_name):
    u, v = random_uv((20, 21))
    got = run_rung("naive", Parameters.with_stencil(stencil_name),
                   boundary, u, v, 5)
    want = oracle.run(u, v, JaxParameters.with_stencil(stencil_name), 5,
                      boundary)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("stencil_name", ["oono-puri", "5points"])
@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_runtime_weights_equal_static_weights(stencil_name, boundary):
    """fused(runtime_weights=True) steps every weight from tensors: within
    1e-6 of the oracle and of the static rung over 3 steps, and a swap of
    ``sim.params`` on the live simulation takes effect at the next call."""
    params = Parameters.with_stencil(stencil_name, feed_rate=0.02)
    jax_params = JaxParameters.with_stencil(stencil_name, feed_rate=0.02)
    u, v = random_uv((14, 19))
    sim = get_backend("fused")(params, boundary=boundary, device="cpu",
                               runtime_weights=True)
    species = sim.make_species(u.shape)
    species.storage = sim.build_storage(u, v)
    sim.perform_steps(species, 3)
    got = species.uv_host()
    assert_close(got, oracle.run(u, v, jax_params, 3, boundary), 1e-6)
    assert_close(got, run_rung("fused", params, boundary, u, v, 3), 1e-6)
    sim.params = Parameters.with_stencil("pretty", kill_rate=0.06)
    want = oracle.step(*got, JaxParameters.with_stencil(
        "pretty", kill_rate=0.06), boundary)
    sim.perform_steps(species, 1)
    assert_close(species.uv_host(), want, 1e-6)


@pytest.mark.parametrize("rung", RUNGS)
@pytest.mark.parametrize("name,shape,stencil_name,boundary,steps,kw",
                         GOLDENS)
def test_rung_meets_the_goldens(rung, name, shape, stencil_name, boundary,
                                steps, kw):
    golden = np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))
    u0, v0 = initial_uv(shape)
    got = run_rung(rung, Parameters.with_stencil(stencil_name, **kw),
                   boundary, u0, v0, steps)
    assert_close(got, (golden["u"], golden["v"]), 2e-5)


@pytest.mark.parametrize("rung", RUNGS)
@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("stencil_name", ["oono-puri", "5points"])
def test_rung_matches_the_jax_rung(rung, boundary, stencil_name, capsys):
    """atol 1e-6 after 8 steps on the same seeded input; the maximum is
    printed (pytest -s)."""
    u, v = random_uv((40, 56), seed=7)
    got = run_rung(rung, Parameters.with_stencil(stencil_name), boundary,
                   u, v, 8)
    want = run_jax_rung(rung, JaxParameters.with_stencil(stencil_name),
                        boundary, u, v, 8)
    err = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
    with capsys.disabled():
        print(f"\n{rung} {boundary} {stencil_name}: max|port - JAX| after "
              f"8 steps {err!r}")
    assert err <= 1e-6


@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_runtime_rung_matches_the_jax_runtime_rung(boundary):
    u, v = random_uv((40, 56), seed=8)
    params = Parameters(feed_rate=0.03)
    got = run_rung("fused", params, boundary, u, v, 8, runtime_weights=True)
    want = run_jax_rung("fused", JaxParameters(feed_rate=0.03), boundary,
                        u, v, 8, runtime_weights=True)
    assert_close(got, want, 1e-6)


@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("stencil_name", sorted(STENCILS))
def test_fused_is_bitwise_to_regular(boundary, stencil_name):
    params = Parameters.with_stencil(stencil_name)
    u, v = random_uv((33, 47))
    fused = run_rung("fused", params, boundary, u, v, 9)
    regular = run_rung("regular", params, boundary, u, v, 9)
    for f, r in zip(fused, regular):
        np.testing.assert_array_equal(f, r)


# -- the shift algebra against its JAX original ------------------------------


def jnp_to_np(x):
    return np.asarray(x)


@pytest.mark.parametrize("stencil_name", sorted(STENCILS))
@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_laplacian_fast_matches_jax(stencil_name, boundary):
    x = random_uv((21, 30), seed=3)[0]
    params = Parameters.with_stencil(stencil_name)
    jax_params = JaxParameters.with_stencil(stencil_name)
    got = stencil.laplacian_fast(torch.from_numpy(x), params, boundary)
    want = jax_stencil.laplacian_fast(x, jax_params, boundary)
    np.testing.assert_allclose(got.numpy(), jnp_to_np(want), rtol=0,
                               atol=1e-6)
    got = stencil.laplacian_shift(torch.from_numpy(x), params, boundary)
    want = jax_stencil.laplacian(x, jax_params, boundary)
    np.testing.assert_allclose(got.numpy(), jnp_to_np(want), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("n", [2, 3, 17])
def test_edge_sums_and_sepconv_match_jax(n):
    h = Parameters().separable_plan()[1]
    np.testing.assert_array_equal(stencil._edge_sums(n, h),
                                  jax_stencil._edge_sums(n, h))
    x = random_uv((n, n + 5), seed=n)[0]
    np.testing.assert_allclose(
        stencil._sepconv(torch.from_numpy(x), h).numpy(),
        jnp_to_np(jax_stencil._sepconv(x, h)), rtol=0, atol=1e-6)


@pytest.mark.parametrize("stencil_name", sorted(STENCILS))
def test_naive_strips_match_jax(stencil_name):
    """The strips of the anchored weights, static and from a tensor."""
    x = random_uv((13, 18), seed=5)[0]
    params = Parameters.with_stencil(stencil_name)
    got = stencil._naive_strips(torch.from_numpy(x), params)
    want = jax_stencil._naive_strips(
        x, JaxParameters.with_stencil(stencil_name))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), jnp_to_np(w), rtol=0,
                                   atol=1e-6)
    weights = torch.from_numpy(params.weights_array())
    traced = stencil.naive_edge_strip(torch.from_numpy(x[0]),
                                      torch.from_numpy(x[1]),
                                      weights[0:2, :])
    np.testing.assert_allclose(traced.numpy(), got[0].numpy(), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_step_runtime_and_rates_match_jax(boundary):
    params = Parameters(feed_rate=0.025, time_step=0.5)
    jax_params = JaxParameters(feed_rate=0.025, time_step=0.5)
    np.testing.assert_array_equal(stencil.rates_array(params).numpy(),
                                  jnp_to_np(jax_stencil.rates_array(
                                      jax_params)))
    u, v = random_uv((19, 26), seed=11)
    got = stencil.step_runtime(
        torch.from_numpy(u), torch.from_numpy(v),
        torch.from_numpy(params.weights_array()),
        stencil.rates_array(params), boundary)
    want = jax_stencil.step_runtime(
        u, v, jax_params.weights_array(),
        jax_stencil.rates_array(jax_params), boundary)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), jnp_to_np(w), rtol=0,
                                   atol=1e-6)


def test_step_fast_refuses_an_unknown_boundary():
    x = torch.zeros((4, 4))
    with pytest.raises(ValueError, match="boundary"):
        stencil.step_fast(x, x, Parameters(), "periodic")
    with pytest.raises(ValueError, match="boundary"):
        stencil.step_runtime(x, x, torch.zeros((3, 3)),
                             stencil.rates_array(Parameters()), "periodic")


# -- the registry and the selector -------------------------------------------


def test_registry_holds_six_backends():
    assert list(BACKENDS) == ["naive", "regular", "fused", "conv", "cuda",
                              "sharded"]
    with pytest.raises(ValueError, match="unknown backend"):
        get_backend("pallas")


def test_selector_picks_cuda_on_either_device(monkeypatch):
    """The port never picks a rung by itself: ``auto`` is ``cuda`` under
    ``--device cpu`` too (JAX picks ``fused`` without a TPU)."""
    monkeypatch.delenv("GRAYSCOTT_BACKEND", raising=False)
    assert best_backend_name() == best_backend_name((24, 32)) == "cuda"
    ns = simulate.build_parser().parse_args(["--device", "cpu"])
    assert shared.make_simulation(ns).name == "cuda"
    monkeypatch.setenv("GRAYSCOTT_BACKEND", "fused")
    assert best_backend_name() == "fused"


@pytest.mark.parametrize("rung", RUNGS)
def test_rungs_ignore_unknown_keywords_and_sweep(rung):
    """The harness passes ``engine=`` to every backend it sweeps."""
    sim = get_backend(rung)(Parameters(), device="cpu", engine="mega",
                            pack="on")
    assert sim.device == torch.device("cpu")
    results = harness.sweep([rung], domains=[(8, 16)], step_counts=[3],
                            reps=2, verbose=False, device="cpu",
                            backend_kwargs={"engine": "mega"})
    assert results[0].backend == rung and results[0].gcells_per_sec > 0


@pytest.mark.parametrize("rung", RUNGS)
def test_cli_runs_each_rung(rung, tmp_path):
    """``--backend <rung> --device cpu`` end to end; the frames equal the
    rung driven directly."""
    import h5py

    out = tmp_path / "o.h5"
    assert simulate.main(["-n", "2", "-r", "20", "-c", "28", "-e", "3",
                          "--backend", rung, "--device", "cpu",
                          "-o", str(out)]) == 0
    with h5py.File(out, "r") as f:
        frames = f["matrix"][:]
    u, v = initial_uv((20, 28))
    want = run_rung(rung, Parameters(), "naive", u, v, 6)[1]
    np.testing.assert_array_equal(frames[-1], want)
