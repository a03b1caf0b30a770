"""The port's K8 (grayscott_tpu_torch/ops/oplat.py and its entry script)
against the TPU kernel of scripts/oplat.py in Pallas interpret mode, and
the wrapper's checks. The CUDA kernel itself is held against its plain
version on the card by tests/test_torch_gpu.py."""

import functools
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from grayscott_tpu_torch.ops import oplat
from grayscott_tpu_torch.scripts import oplat as oplat_script

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_oplat():
    """scripts/oplat.py, loaded from its path (scripts/ is no package)."""
    spec = importlib.util.spec_from_file_location(
        "jax_oplat_script", os.path.join(REPO, "scripts", "oplat.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_jax_k8(module, x, steps, n_ops, rolls):
    """The TPU kernel in interpret mode, as oplat.run calls it."""
    return np.asarray(pl.pallas_call(
        functools.partial(module._kernel, steps=steps, n_ops=n_ops,
                          rolls=rolls),
        out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
        interpret=True)(x))


def seeded_input(shape):
    """Uniform in [0.5, 2), where the plain version's float64 multiply-add
    is exact and so equals the fused one."""
    return np.random.default_rng(0).uniform(0.5, 2.0, shape) \
        .astype(np.float32)


@pytest.mark.parametrize("rolls", [False, True])
@pytest.mark.parametrize("n_ops", [15, 45])
@pytest.mark.parametrize("shape", [(16, 128), (24, 256)])
def test_chain_matches_jax_k8(jax_oplat, shape, n_ops, rolls):
    """3 steps. Tolerance: none. The interpret run computes each
    multiply-add as one fused operation; the plain version rounds the exact
    float64 result once, which is the same number."""
    x = seeded_input(shape)
    want = run_jax_k8(jax_oplat, x, 3, n_ops, rolls)
    got = oplat.chain(torch.from_numpy(x), 3, n_ops, rolls)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        oplat.chain_reference(torch.from_numpy(x), 3, n_ops, rolls).numpy(),
        want)


def test_chain_differs_from_the_unfused_multiply_add():
    """The check above can tell: rounding the product and the sum apart
    gives another result."""
    x = torch.from_numpy(seeded_input((16, 128)))
    unfused = x
    for _ in range(3 * 15):
        unfused = unfused * oplat.MUL + oplat.ADD
    assert not torch.equal(oplat.chain(x, 3, 15, False), unfused)


def test_rolls_move_the_array():
    """A chain of three ops with rolls is two multiply-adds and one roll
    along rows; the next three roll along columns."""
    x = torch.from_numpy(seeded_input((16, 128)))
    fma = oplat.chain(x, 1, 2, True)  # j = 0, 1: no roll yet
    np.testing.assert_array_equal(oplat.chain(x, 1, 3, True).numpy(),
                                  np.roll(fma.numpy(), 1, axis=0))
    six = oplat.chain(x, 1, 6, True)
    step = oplat.chain(torch.roll(fma, 1, 0), 1, 2, False)
    np.testing.assert_array_equal(six.numpy(),
                                  np.roll(step.numpy(), 1, axis=1))


@pytest.mark.parametrize("n_ops,rolls,fmas", [
    (15, False, 15), (15, True, 10), (45, True, 30), (90, True, 60),
    (2, True, 2), (4, True, 3),
])
def test_fma_count(n_ops, rolls, fmas):
    assert oplat.fmas((3, 5), 7, n_ops, rolls) == 3 * 5 * 7 * fmas


def test_cpu_calls_do_not_count_as_launches():
    before = oplat.launches
    out = oplat.chain(torch.ones(16, 128), 3, 15, True)
    assert oplat.launches == before
    assert out.shape == (16, 128) and torch.isfinite(out).all()


@pytest.mark.parametrize("kwargs", [
    {"n_ops": 0}, {"steps": 0}, {"steps": 1.5}, {"grid": -1},
    {"rolls": 1}, {"x": torch.ones(4, 8, dtype=torch.float64)},
    {"x": torch.ones(2, 4, 8)}, {"x": torch.ones(8, 4).t()},
])
def test_chain_rejects_bad_arguments(kwargs):
    args = {"x": torch.ones(4, 8), "steps": 2, "n_ops": 3, "rolls": True,
            **kwargs}
    with pytest.raises(ValueError):
        oplat.chain(**args)


def test_measure_runs_on_the_cpu():
    before = oplat.launches
    seconds = oplat_script.measure((16, 128), 3, 15, True, device="cpu")
    assert 0 < seconds < 10
    assert oplat.launches == before


def test_sweep_and_fit_lines(capsys):
    records = oplat_script.sweep([(16, 128)], [15, 45], 2, device="cpu")
    assert [(r["n_ops"], r["rolls"]) for r in records] == [
        (15, False), (15, True), (45, False), (45, True)]
    keys = {"shape", "n_ops", "rolls", "us_per_step", "ns_per_op",
            "ps_per_cell_op", "device"}
    assert all(set(r) == keys for r in records)
    out = capsys.readouterr().out
    assert out.count("RESULT ") == 4
    fits = oplat_script.fits(records)
    assert [line.split(":")[0] for line in fits] == [
        "FIT shape=(16, 128) rolls=False", "FIT shape=(16, 128) rolls=True"]
