"""The folded naive reaction (``--pallas-naive-fold on``; K1's and K2's fold
entries) and ``naive_fix`` ``store``/``slice`` in the port, on the CPU,
against the JAX package.

On the CPU the fold entries run their plain version,
``stencil.step_naive_fold`` (JAX's ``fast_fold`` tree, term for term), in
blocks of at most 8 steps on bf16 storage (``run_naive_fold_bf16``). The
tolerances, in JAX's own budgets (tests/test_mega.py:509-535):

- the port's fold against JAX's in interpret mode, both engines: atol 1e-6
  in float32, what the port's shift algebra holds to JAX
  (tests/test_torch_rungs.py:155), under JAX's fold budget of 3e-6
  (measured: at most 4.8e-7 after 16 steps; the two trees agree term for
  term, and XLA:CPU contracts some multiply-adds that the port rounds
  twice, one ulp in about a third of the cells after a step). bf16
  storage: within one bf16 ulp of the value, since an ulp of float32
  difference can tip a rounding;
- the fold against the port's exact naive path: 3e-6 after 16 steps;
  against ``oracle.run``: 1e-4 after 240 steps;
- windowed against mega: equal, since both run the same plain step in
  blocks of 8.

On a domain of one row or one column the anchored strips read the zeros
past the edge, as JAX's do, and the fold leaves the naive semantics there.

``naive_fix`` ``store`` and ``slice`` run the exact path: equal to
``select`` in the port, and within 1e-6 of JAX's runs of each (JAX's own
budgets: 3e-7 from its select path, which the port holds to 1e-6). The
JAX runs of the direct plan, of bf16 storage and of ``store``/``slice``
are in tests/test_torch_naive_fold_jax.py. The kernels are held against
these plain versions on the card by chip_smoke.py's phase 16 and
tests/test_torch_gpu.py."""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from grayscott_tpu import oracle
from grayscott_tpu.backends.pallas import PallasSimulation
from grayscott_tpu.errors import UnsupportedConfigError as JaxUnsupported
from grayscott_tpu.params import Parameters as JaxParameters
from grayscott_tpu_torch.backends.cuda import CudaSimulation, auto_engine
from grayscott_tpu_torch.errors import UnsupportedConfigError
from grayscott_tpu_torch.ops import checks, megakernel, stencil, windowed
from grayscott_tpu_torch.params import (Parameters, fold_constants,
                                        kernel_constants)

from conftest import random_uv

#: JAX's fold test shapes (tests/test_mega.py:509-554)
SHAPES = [(32, 16), (37, 16), (19, 32), (40, 16)]
#: one separable stencil and one with a direct plan
STENCILS = ["oono-puri", "5points"]
ENGINES = ["windowed", "mega"]

#: (shape, stencil, engine, dtype) of the JAX interpret runs: every shape
#: on both engines in float32 on the default stencil (here), the direct
#: plan and bf16 storage on two shapes (tests/test_torch_naive_fold_jax.py)
JAX_CASES = [(shape, "oono-puri", engine, "float32")
             for shape in SHAPES for engine in ENGINES]


def port_run(u, v, steps, stencil_name="oono-puri", **kw):
    """(U, V) of the port's cuda backend on the CPU after each of
    ``steps`` (a list of step counts, cumulative)."""
    sim = CudaSimulation(Parameters.with_stencil(stencil_name), "naive",
                         device="cpu", tuned_lookup=False, **kw)
    species = sim.make_species(u.shape)
    species.storage = sim.build_storage(u, v)
    out, done = [], 0
    for n in steps:
        sim.perform_steps(species, n - done)
        done = n
        out.append(species.uv_host())
    return out


def jax_run(u, v, steps, stencil_name="oono-puri", **kw):
    sim = PallasSimulation(JaxParameters.with_stencil(stencil_name),
                           boundary="naive", interpret=True, **kw)
    species = sim.make_species(u.shape)
    species.storage = sim.build_storage(u, v)
    out, done = [], 0
    for n in steps:
        sim.perform_steps(species, n - done)
        done = n
        out.append(tuple(np.asarray(x, np.float32)
                         for x in species.uv_host()))
    return out


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp of each value (its exponent's step, 2^-7 of it)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7).astype(np.float32)


def check_against_jax(rng, shape, stencil_name, engine, dtype):
    """The port's fold path against JAX's after 8 and 16 steps."""
    u, v = random_uv(rng, shape)
    kw = dict(engine=engine, naive_fold=True, dtype=dtype)
    got = port_run(u, v, [8, 16], stencil_name, **kw)
    want = jax_run(u, v, [8, 16], stencil_name, **kw)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if dtype == "float32":
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
            else:
                assert (np.abs(a - b) <= bf16_ulp(b)).all()


@pytest.mark.parametrize("shape,stencil_name,engine,dtype", JAX_CASES)
def test_fold_matches_jax(rng, shape, stencil_name, engine, dtype):
    check_against_jax(rng, shape, stencil_name, engine, dtype)


@pytest.mark.parametrize("stencil_name", STENCILS)
@pytest.mark.parametrize("shape", SHAPES)
def test_fold_within_budget_of_exact_naive(rng, shape, stencil_name):
    """JAX's 3e-6 against the bit-frozen path, here the port's exact
    naive step (bitwise the oracle), after 16 steps."""
    params = Parameters.with_stencil(stencil_name)
    u, v = (torch.from_numpy(x) for x in random_uv(rng, shape))
    fu, fv = stencil.run_naive_fold(u, v, 16, fold_constants(params))
    eu, ev = stencil.run(u, v, 16, kernel_constants(params), "naive")
    assert float((fu - eu).abs().max()) <= 3e-6
    assert float((fv - ev).abs().max()) <= 3e-6
    assert not torch.equal(fv, ev)  # the fold rounds otherwise


@pytest.mark.parametrize("stencil_name", STENCILS)
def test_fold_long_run_against_oracle(rng, stencil_name):
    """JAX's 1e-4 against the oracle after 240 steps
    (tests/test_mega.py:527-535)."""
    u, v = random_uv(rng, (40, 16))
    ou, ov = oracle.run(u, v, JaxParameters.with_stencil(stencil_name), 240,
                        "naive")
    (fu, fv), = port_run(u, v, [240], stencil_name, naive_fold=True)
    np.testing.assert_allclose(fu, ou, rtol=0, atol=1e-4)
    np.testing.assert_allclose(fv, ov, rtol=0, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("steps", [1, 8, 13, 16])
def test_windowed_equals_mega(rng, steps, dtype):
    """K1's plain path (launches of at most 8 steps) and K2's (time blocks
    of 8 and a remainder) run the same plain step and round at the same
    steps: equal, and the plain fold's own replay."""
    u, v = random_uv(rng, (37, 16))
    runs = [port_run(u, v, [steps], engine=e, naive_fold=True,
                     dtype=dtype)[0] for e in ENGINES]
    fc = fold_constants(Parameters())
    ut, vt = torch.from_numpy(u), torch.from_numpy(v)
    if dtype == "float32":
        want = stencil.run_naive_fold(ut, vt, steps, fc)
    else:
        want = stencil.run_naive_fold_bf16(ut.bfloat16(), vt.bfloat16(),
                                           steps, fc)
    for run in runs:
        for a, b in zip(run, want):
            assert np.array_equal(a, b.float().numpy())


@pytest.mark.parametrize("stencil_name", sorted(
    ["oono-puri", "5points", "pretty", "patra-karttunen"]))
@pytest.mark.parametrize("shape", [(1, 1), (1, 5), (4, 1), (2, 2), (5, 7)])
def test_fold_fields_hold_the_kernels_coefficients(shape, stencil_name):
    """The fields of the plain step hold, at every cell of row >= 1 and
    column >= 1, one of the four values the kernels take (``au``, ``bv``,
    indexed by last row and last column), bit for bit; and tiny domains
    step (every cell a strip cell or a last row or column), within the
    budget of the exact path from two rows and two columns up."""
    params = Parameters.with_stencil(stencil_name)
    fc = fold_constants(params)
    au, bv = stencil.fold_fields(shape, fc, torch.device("cpu"))
    r, c = shape
    for i in range(1, r):
        for j in range(1, c):
            k = 2 * (i == r - 1) + (j == c - 1)
            assert au[i, j].item() == fc.au[k]
            assert bv[i, j].item() == fc.bv[k]
    rng = np.random.RandomState(3)
    u, v = (torch.from_numpy(x) for x in random_uv(rng, shape))
    fu, fv = stencil.run_naive_fold(u, v, 3, fc)
    assert bool(torch.isfinite(fu).all() and torch.isfinite(fv).all())
    if min(shape) >= 2:
        eu, ev = stencil.run(u, v, 3, kernel_constants(params), "naive")
        assert float((fu - eu).abs().max()) <= 3e-6
        assert float((fv - ev).abs().max()) <= 3e-6


def test_fold_constants_follow_jax_host_arithmetic():
    """``au0``/``bv0`` and the edge sums round as
    ``pallas_stencil.py:568-576`` and ``_col_sums`` round them, and the
    dt != 1 constants reach the quadratic term."""
    for params in (Parameters(), Parameters(time_step=0.5),
                   Parameters.with_stencil("patra-karttunen")):
        fc = fold_constants(params)
        f32 = np.float32
        e = f32(params.time_step) * f32(params.feed_rate)
        assert fc.au0 == float(f32(1.0) - e)
        assert fc.bv0 == float(f32(1.0) + f32(params.time_step)
                               * params.min_feed_kill())
        assert fc.dt_is_one == (params.time_step == 1.0)
        h = params.separable_plan()[1]
        assert fc.row_sums == (float(f32(h[1] + h[2])), float(h.sum()),
                               float(f32(h[0] + h[1])))
        assert len(fc.kernel_floats()) == 25
    fc = fold_constants(Parameters.with_stencil("5points"))
    assert not fc.separable
    assert fc.direct_sums[1] == (1.0, 2.0, 1.0)


#: the knobs whose rules the port takes from JAX's constructor
#: (backends/pallas.py:161-252)
RULES = list(itertools.product(["naive", "zero"],
                               ["select", "store", "slice"],
                               [False, True], ["auto", "on"]))


def refusal(make):
    try:
        make()
    except (UnsupportedConfigError, JaxUnsupported) as err:
        return str(err)
    return None


@pytest.mark.parametrize("boundary,naive_fix,naive_fold,resident", RULES)
def test_refuses_what_jax_refuses(boundary, naive_fix, naive_fold,
                                  resident):
    kw = dict(naive_fix=naive_fix, naive_fold=naive_fold, resident=resident)
    port = refusal(lambda: CudaSimulation(Parameters(), boundary,
                                          device="cpu", **kw))
    jax = refusal(lambda: PallasSimulation(JaxParameters(), boundary,
                                           interpret=True, **kw))
    assert port == jax


@pytest.mark.parametrize("kw,combo", [
    (dict(boundary="zero"), "naive_fold+boundary"),
    (dict(boundary="naive", naive_fix="store"), "naive_fold+naive_fix"),
    (dict(boundary="naive", fold=2), "naive_fold+fold"),
    (dict(boundary="naive", resident="on"), "naive_fold+resident"),
])
def test_fold_refusals_match_jax(kw, combo):
    """JAX's matrix of naive_fold's refusals (tests/test_mega.py:568-579),
    each with JAX's message and a combo naming the knobs."""
    boundary = kw.pop("boundary")
    with pytest.raises(JaxUnsupported) as jax_err:
        PallasSimulation(JaxParameters(), boundary, interpret=True,
                         naive_fold=True, **kw)
    with pytest.raises(UnsupportedConfigError) as err:
        CudaSimulation(Parameters(), boundary, device="cpu",
                       naive_fold=True, **kw)
    assert str(err.value) == str(jax_err.value)
    assert err.value.combo == combo


def test_naive_fix_value_is_checked():
    for make in (lambda: CudaSimulation(Parameters(), device="cpu",
                                        naive_fix="patch"),
                 lambda: PallasSimulation(JaxParameters(), interpret=True,
                                          naive_fix="patch")):
        with pytest.raises(ValueError, match="select/store/slice"):
            make()


@pytest.mark.parametrize("shape", [(24, 32), (1080, 1920), (4096, 4096)])
@pytest.mark.parametrize("kw", [dict(naive_fold=True),
                                dict(naive_fix="store"),
                                dict(naive_fold=True, dtype="bfloat16")])
def test_auto_never_runs_the_resident_kernel(monkeypatch, shape, kw):
    """Under the fold and under ``store`` ``auto`` never picks K3, also
    against a record that says ``resident`` (``backends/pallas.py:489-490``):
    the record is ignored and the engine comes from ``auto_engine``
    without K3 (K1 with bf16 storage)."""
    sim = CudaSimulation(Parameters(), device="cpu", **kw)
    record = {"engine": "resident", "pack": False}
    monkeypatch.setattr(sim, "tuned", lambda shape: record)
    want = ("windowed" if kw.get("dtype") == "bfloat16"
            else auto_engine(shape, "naive", resident_ok=False))
    assert sim.layout_for(shape) == (False, want)
    assert want != "resident"
    plain = CudaSimulation(Parameters(), device="cpu")
    monkeypatch.setattr(plain, "tuned", lambda shape: record)
    assert plain.layout_for(shape) == (False, "resident")
    for engine in ENGINES:
        pinned = CudaSimulation(Parameters(), device="cpu", engine=engine,
                                **kw)
        assert pinned.layout_for(shape) == (False, engine)


@pytest.mark.parametrize("engine", ["auto", "windowed", "mega", "resident"])
@pytest.mark.parametrize("naive_fix", ["store", "slice"])
def test_naive_fix_runs_the_exact_path(rng, naive_fix, engine):
    """``store`` and ``slice`` give the port's ``select`` frames bit for
    bit on every engine that takes them (``store`` refuses K3)."""
    u, v = random_uv(rng, (37, 16))
    pins = ({"resident": "on"} if engine == "resident"
            else {"engine": engine})
    if naive_fix == "store" and engine == "resident":
        with pytest.raises(UnsupportedConfigError):
            port_run(u, v, [9], naive_fix=naive_fix, **pins)
        return
    got = port_run(u, v, [9], naive_fix=naive_fix, **pins)[0]
    want = port_run(u, v, [9], **pins)[0]
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


def test_slice_composes_with_the_fold(rng):
    """``naive_fix='slice'`` with the fold runs the fold (JAX's
    tests/test_slicetaps.py:84)."""
    u, v = random_uv(rng, (32, 16))
    got = port_run(u, v, [9], naive_fold=True, naive_fix="slice")[0]
    want = port_run(u, v, [9], naive_fold=True)[0]
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


def test_wrappers_check_the_fold_arguments():
    u = torch.zeros((8, 8))
    pair = megakernel.pair_state(u)
    fc = fold_constants(Parameters())
    with pytest.raises(TypeError, match="FoldConstants"):
        windowed.multistep(u, u.clone(), u.clone(), u.clone(), 1,
                           kernel_constants(Parameters()), "naive",
                           fold=True)
    with pytest.raises(ValueError, match="naive boundary"):
        windowed.multistep(u, u.clone(), u.clone(), u.clone(), 1, fc,
                           "zero", fold=True)
    with pytest.raises(ValueError, match="naive boundary"):
        megakernel.megastep(pair, pair.clone(), 1, 1, fc, "zero", fold=True)
    with pytest.raises(ValueError, match="steps"):
        windowed.multistep(u, u.clone(), u.clone(), u.clone(), 9, fc,
                           "naive", fold=True)
    checks.check_fold(fc, "naive")


def test_fold_counts_no_launch_on_the_cpu(rng):
    counts = (windowed.fold_launches, windowed.fold_bf16_launches,
              megakernel.fold_launches, megakernel.fold_bf16_launches)
    u, v = random_uv(rng, (24, 32))
    for engine in ENGINES:
        for dtype in ("float32", "bfloat16"):
            port_run(u, v, [9], engine=engine, dtype=dtype, naive_fold=True)
    assert counts == (windowed.fold_launches, windowed.fold_bf16_launches,
                      megakernel.fold_launches,
                      megakernel.fold_bf16_launches)
