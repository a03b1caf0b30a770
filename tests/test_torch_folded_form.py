"""K1's folded entry in one launch, its CPU twin: the window of each panel
read from its neighbours' interior rows (``ops/lane_fold.py:panel_window``,
the plain version of ``csrc/windowed_folded.cuh``'s FoldLayout) and the halo
rows its first and last tile rows write
(``ops/windowed.py:folded_one_launch_reference``). It must be the first
form (``lane_fold.fold_refresh`` then ``folded_multistep_reference``) bit
for bit, halo rows included, and JAX's folded kernel in interpret mode
within its 1e-6. The folded split's refusals and plain versions
(``windowed.folded_ablation``) are checked here too; the kernels are held
bit for bit on the card by ``chip_smoke.py`` (phase 25) and
tests/test_torch_gpu.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from grayscott_tpu.backends.pallas import PallasSimulation
from grayscott_tpu.params import Parameters as JaxParameters
from grayscott_tpu_torch.ops import geometry, lane_fold, windowed
from grayscott_tpu_torch.params import (Parameters, kernel_constants,
                                        STENCILS)

from conftest import random_uv


def folded(u, v, f: int, tr: int, halo: int):
    return lane_fold.fold_state(u, v, f, tr, halo)


@pytest.mark.parametrize("shape,f,tr,halo", [
    ((32, 16), 2, 8, 8), ((37, 24), 3, 8, 8), ((80, 16), 8, 8, 16),
    ((100, 24), 3, 16, 16), ((9, 8), 1, 8, 8)])
def test_panel_window_is_the_refreshed_panel(rng, shape, f, tr, halo):
    """Each panel's window read from its neighbours' interior rows equals
    its columns after ``fold_refresh``, 0.0 past the first and last
    panel."""
    u, _ = random_uv(rng, shape)
    x, _ = folded(u, u, f, tr, halo)
    x[:halo] = float("nan")  # stale halo rows: the window never reads them
    x[-halo:] = float("nan")
    rp = lane_fold.fold_geometry(shape[0], f, tr)
    windows = [lane_fold.panel_window(x, halo, f, shape[1], rp, p)
               for p in range(f)]
    lane_fold.fold_refresh(x, halo, f, shape[1], rp)
    for p, w in enumerate(windows):
        assert torch.equal(w, x[:, p * shape[1]:(p + 1) * shape[1]])


@pytest.mark.parametrize("stencil", sorted(STENCILS))
@pytest.mark.parametrize("shape,f,k", [
    ((32, 16), 2, 8), ((37, 24), 3, 5), ((80, 16), 8, 16), ((100, 24), 3, 16),
    ((9, 8), 1, 8)])
@pytest.mark.parametrize("boundary", ["zero", "naive"])
def test_one_launch_is_the_first_form(rng, stencil, shape, f, k, boundary):
    """One launch (windows from the neighbours' interior rows, the halo
    rows written after) leaves the outputs and the input's halo rows of the
    refresh and the step bit for bit, on a state whose halo rows are
    stale."""
    consts = kernel_constants(Parameters.with_stencil(stencil))
    halo = geometry.halo_for_steps(k)
    tr = 8
    rp = lane_fold.fold_geometry(shape[0], f, tr)
    u, v = random_uv(rng, shape)
    a = list(folded(u, v, f, tr, halo))
    for x in a:
        x[:halo] = 3.0  # stale halos: the one launch must not read them
        x[-halo:] = -2.0
    b = [x.clone() for x in a]
    out_a = [torch.full_like(a[0], 7.0) for _ in range(2)]
    out_b = [x.clone() for x in out_a]
    windowed.folded_one_launch_reference(*a, *out_a, k, consts, boundary,
                                         shape, rp, halo)
    windowed.folded_multistep_reference(*b, *out_b, k, consts, boundary,
                                        shape, rp, halo)
    for got, want in zip(a + out_a, b + out_b):
        assert torch.equal(got, want)


def run_jax(u, v, steps: int, boundary: str, f: int, k: int):
    """JAX's folded run in interpret mode on 8-row tiles at K steps a
    call."""
    sim = PallasSimulation(JaxParameters(), boundary=boundary, interpret=True,
                           fold=f, block_rows=8, steps_per_call=k)
    species = sim.make_species(u.shape)
    species.storage = sim.build_storage(u, v)
    assert species.storage[0] == "folded"
    sim.perform_steps(species, steps)
    return species.uv_host()


#: (shape, F, K, boundary): F = 2, 3 and 8 each on both boundaries, K = 8
#: and 16 each on both (JAX's naive interpret run at F = 2, K = 16 alone
#: takes 50 s)
JAX_CASES = [((32, 16), 2, 16, "zero"), ((32, 16), 2, 8, "naive"),
             ((37, 24), 3, 8, "zero"), ((37, 24), 3, 16, "naive"),
             ((80, 16), 8, 16, "zero"), ((80, 16), 8, 8, "naive")]


@pytest.mark.parametrize("shape,f,k,boundary", JAX_CASES)
def test_one_launch_matches_jax(rng, shape, f, k, boundary):
    """One call of K steps of the one-launch twin (8-row tiles, the halo of
    K) within 1e-6 of JAX's folded kernel in interpret mode on the same
    pins (its shift algebra is a few ulp off the oracle's tree)."""
    consts = kernel_constants(Parameters())
    halo = geometry.halo_for_steps(k)
    rp = lane_fold.fold_geometry(shape[0], f, 8)
    u, v = random_uv(rng, shape)
    x = list(folded(u, v, f, 8, halo))
    out = [torch.zeros_like(x[0]) for _ in range(2)]
    windowed.folded_one_launch_reference(*x, *out, k, consts, boundary,
                                         shape, rp, halo)
    want = run_jax(u, v, k, boundary, f, k)
    for got, w in zip(out, want):
        got = lane_fold.unfold_state(got, halo, f, shape[1], shape[0])
        np.testing.assert_allclose(got.numpy(), w, rtol=0, atol=1e-6)


@pytest.mark.parametrize("part", sorted(windowed.FOLDED_ABLATIONS))
def test_folded_split_plain_versions(rng, part):
    """On the CPU each part of the folded split runs its plain version:
    part 1 refreshes the halo rows and steps nothing, part 2 steps the
    halo rows as they are (fresh here, so that it is the entry's), every
    other part is the entry's plain version (the refresh, then the
    step)."""
    shape, f, k = (100, 64), 2, 8
    consts = kernel_constants(Parameters())
    g = geometry.Geometry(64, 64, 8)
    rp = lane_fold.fold_geometry(shape[0], f, g.tr)
    u, v = random_uv(rng, shape)
    x = list(folded(u, v, f, g.tr, g.halo))
    if part == windowed.FOLDED_ABLATION_STEP:
        for t in x:  # the step alone reads the halo rows as they are
            lane_fold.fold_refresh(t, g.halo, f, shape[1], rp)
    out = [torch.zeros_like(x[0]) for _ in range(2)]
    y = [t.clone() for t in x + out]
    windowed.folded_ablation(part, *x, *out, k, consts, "naive", shape, rp, g)
    if part == windowed.FOLDED_ABLATION_REFRESH:
        for t in y[:2]:
            lane_fold.fold_refresh(t, g.halo, f, shape[1], rp)
    else:
        windowed.folded_multistep_reference(*y, k, consts, "naive", shape,
                                            rp, g.halo)
    for got, want in zip(x + out, y):
        assert torch.equal(got, want)


def test_folded_split_refusals(rng):
    """The split takes the naive boundary on the default stencils' tap set
    only, and its parts on compiled sizes 64x64 tiles at a halo of 8 or 16
    only."""
    shape = (100, 64)
    u, v = random_uv(rng, shape)
    g = geometry.Geometry(32, 32, 8)
    rp = lane_fold.fold_geometry(shape[0], 2, g.tr)
    x = list(folded(u, v, 2, g.tr, g.halo))
    out = [torch.zeros_like(x[0]) for _ in range(2)]
    consts = kernel_constants(Parameters())
    for part in windowed.FOLDED_ABLATION_FIXED:
        with pytest.raises(ValueError, match="compiles"):
            windowed.folded_ablation(part, *x, *out, 8, consts, "naive",
                                     shape, rp, g)
    with pytest.raises(ValueError, match="tap set"):
        windowed.folded_ablation(0, *x, *out, 8, consts, "zero", shape, rp, g)
    with pytest.raises(ValueError, match="tap set"):
        windowed.folded_ablation(0, *x, *out, 8,
                                 kernel_constants(Parameters.with_stencil(
                                     "5points")), "naive", shape, rp, g)
    with pytest.raises(ValueError, match="part must be"):
        windowed.folded_ablation(7, *x, *out, 8, consts, "naive", shape, rp,
                                 g)
