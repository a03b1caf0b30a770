"""The port's K9 (grayscott_tpu_torch/ops/ilpsplit.py and its entry
script): its plain version against the plain step and against the JAX
resident kernel K3 in Pallas interpret mode (scripts/ilpsplit.py itself
does not run at this tree: it calls make_window_stepper with an argument
list the function no longer takes; its docstring states that the split
equals the unsplit resident kernel bitwise, and that is what K9 is held
to), and the checks of the wrapper and of its ablation wrapper. The CUDA
kernel itself is held against its plain version and K3 on the card by
tests/test_torch_gpu.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from grayscott_tpu.backends.pallas import PallasSimulation
from grayscott_tpu_torch.ops import ilpsplit, stencil
from grayscott_tpu_torch.params import Parameters, kernel_constants
from grayscott_tpu_torch.scripts import ilpsplit as ilpsplit_script

from conftest import random_uv


def tensors(u, v):
    return torch.from_numpy(u.copy()), torch.from_numpy(v.copy())


@pytest.mark.parametrize("steps", [1, 5, 9])
@pytest.mark.parametrize("shape", [(70, 97), (45, 256)])
@pytest.mark.parametrize("boundary", ["naive", "zero"])
@pytest.mark.parametrize("split", [1, 2, 4, 8])
def test_split_reference_bitwise_equals_the_plain_step(rng, split, boundary,
                                                       shape, steps):
    """Tolerance: none. A slab's own rows read only true neighbours (the
    overlap rows, which see a false edge, are dropped), so every kept cell
    is the same float32 expression on the same inputs."""
    consts = kernel_constants(Parameters())
    u, v = tensors(*random_uv(rng, shape))
    su, sv = ilpsplit.split_reference(u, v, steps, consts, boundary, split)
    ru, rv = stencil.run(u, v, steps, consts, boundary)
    assert torch.equal(su, ru) and torch.equal(sv, rv)


@pytest.mark.parametrize("boundary", ["naive", "zero"])
@pytest.mark.parametrize("split", [1, 2, 3, 4])
def test_split_reference_in_tile_quanta(rng, split, boundary):
    """The card's slabs (whole rows of 32x32 tiles, the last one ragged)
    give the same result."""
    consts = kernel_constants(Parameters(time_step=0.5))
    u, v = tensors(*random_uv(rng, (100, 40)))
    got = ilpsplit.split_reference(u, v, 7, consts, boundary, split,
                                   quantum=ilpsplit.TILE)
    want = stencil.run(u, v, 7, consts, boundary)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def run_jax_k3(u, v, params, boundary, steps):
    """K3 in interpret mode, as tests/test_pallas.py runs it."""
    sim = PallasSimulation(params, boundary=boundary, resident="on",
                           interpret=True)
    species = sim.make_species(u.shape)
    species.storage = sim.build_storage(u, v)
    assert species.storage[0] == "resident"
    sim.perform_steps(species, steps)
    return species.uv_host()


@pytest.mark.parametrize("boundary", ["naive", "zero"])
@pytest.mark.parametrize("shape", [(24, 16), (17, 23)])
def test_split_matches_jax_k3(rng, params, boundary, shape):
    """7 steps in one call, every split. atol 2e-6 against JAX K3 (its zero
    path folds the update's linear terms, a few ulp off the oracle's
    rounding), as tests/test_torch_resident.py holds K3's port."""
    u, v = random_uv(rng, shape)
    ju, jv = run_jax_k3(u, v, params, boundary, 7)
    consts = kernel_constants(Parameters())
    for split in (1, 2, 4):
        bufs = [*tensors(u, v), torch.empty(shape), torch.empty(shape)]
        out = ilpsplit.split_multistep(*bufs, 7, consts, boundary, split)
        np.testing.assert_allclose(out[0].numpy(), ju, rtol=0, atol=2e-6)
        np.testing.assert_allclose(out[1].numpy(), jv, rtol=0, atol=2e-6)


@pytest.mark.parametrize("rows,split,quantum", [
    (1080, 2, 8), (1080, 4, 8), (1080, 2, 32), (1080, 8, 32), (1000, 8, 32),
    (4096, 8, 32), (70, 4, 1), (45, 8, 1), (70, 3, 32), (7, 7, 1),
])
def test_slab_height_rule(rows, split, quantum):
    """The heights sum to the rows; each slab starts on a quantum and is
    positive; all but the last are whole quanta; the quanta are shared
    equally with the remainder one each to the leading slabs."""
    heights = ilpsplit.slab_heights(rows, split, quantum)
    assert len(heights) == split and sum(heights) == rows
    assert all(h > 0 for h in heights)
    assert all(h % quantum == 0 for h in heights[:-1])
    quanta = [-(-h // quantum) for h in heights]
    assert quanta == sorted(quanta, reverse=True)
    assert quanta[0] - quanta[-1] <= 1


def test_slab_heights_match_the_jax_rule():
    """ilpsplit.py:49-56 at its own quantum (8 rows) on padded rows."""
    for rp in (1080, 1088, 2048, 16, 72):
        for split in (1, 2, 3, 4, 8):
            if rp // 8 < split:
                continue
            base = rp // split // 8 * 8
            heights = [base] * split
            extra, i = rp - base * split, 0
            while extra > 0:
                heights[i % split] += 8
                extra -= 8
                i += 1
            assert ilpsplit.slab_heights(rp, split, 8) == heights


@pytest.mark.parametrize("rows,split,quantum", [(70, 4, 32), (5, 6, 1),
                                                (8, 0, 1)])
def test_slab_heights_refuse_more_slabs_than_quanta(rows, split, quantum):
    with pytest.raises(ValueError):
        ilpsplit.slab_heights(rows, split, quantum)


@pytest.mark.parametrize("unroll", ["1", "4"])
def test_script_accepts_and_ignores_unroll(capsys, unroll):
    """The JAX script's --unroll groups the same steps in the same order:
    the port parses it, records nothing of it and runs the same steps."""
    assert ilpsplit_script.main(["--device", "cpu", "--shape", "40x33",
                                 "--steps", "3", "--splits", "1,2",
                                 "--unroll", unroll]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert "split=2: bitwise match vs split=1: True" in lines
    results = [ln for ln in lines if ln.startswith("RESULT ")]
    assert len(results) == 2 and all("unroll" not in ln for ln in results)


@pytest.mark.parametrize("steps", [1, 2, 7])
def test_split_multistep_returns_the_result_first(rng, steps):
    """The buffers come back with the result pair first, whatever the
    parity of the step count; the input tensors are the storage."""
    u, v = random_uv(rng, (9, 11))
    consts = kernel_constants(Parameters())
    bufs = [*tensors(u, v), torch.empty(9, 11), torch.empty(9, 11)]
    out = ilpsplit.split_multistep(*bufs, steps, consts, "naive", 2)
    assert {id(t) for t in out} == {id(t) for t in bufs}
    ru, rv = stencil.run(*tensors(u, v), steps, consts, "naive")
    assert torch.equal(out[0], ru) and torch.equal(out[1], rv)
    assert (out[0] is bufs[0]) == (steps % 2 == 0)


@pytest.mark.parametrize("kind", [
    "dtype", "aliased", "steps_zero", "split_zero",
    "split_over_rows", "grid_below_split", "grid", "boundary",
])
def test_split_multistep_rejects_bad_arguments(kind):
    bufs = [torch.rand(8, 12) for _ in range(4)]
    args = {"steps": 1, "boundary": "naive", "split": 2, "grid": 0}
    if kind == "dtype":
        bufs[1] = bufs[1].double()
    elif kind == "aliased":
        bufs[2] = bufs[0]
    elif kind == "steps_zero":
        args["steps"] = 0
    elif kind == "split_zero":
        args["split"] = 0
    elif kind == "split_over_rows":
        args["split"] = 9
    elif kind == "grid_below_split":
        args["grid"] = 1
    elif kind == "grid":
        args["grid"] = -1
    elif kind == "boundary":
        args["boundary"] = "periodic"
    with pytest.raises(ValueError):
        ilpsplit.split_multistep(*bufs, consts=kernel_constants(Parameters()),
                                 **args)


def test_cpu_calls_do_not_count_as_launches(rng):
    before = ilpsplit.launches
    u, v = random_uv(rng, (17, 23))
    ilpsplit.split_multistep(*tensors(u, v), torch.empty(17, 23),
                             torch.empty(17, 23), 5,
                             kernel_constants(Parameters()), "zero", 4)
    assert ilpsplit.launches == before


def test_script_main_on_the_cpu(capsys):
    rc = ilpsplit_script.main(["--device", "cpu", "--shape", "70x97",
                               "--steps", "5", "--splits", "1,2,4"])
    assert rc == 0
    lines = capsys.readouterr().out.splitlines()
    assert "split=1: bitwise match vs resident: True" in lines
    assert "split=2: bitwise match vs split=1: True" in lines
    assert "split=4: bitwise match vs split=1: True" in lines
    results = [ln for ln in lines if ln.startswith("RESULT ")]
    assert len(results) == 3
    assert sum(ln.startswith("BASELINE ") for ln in lines) == 1
    assert lines[-1] == "DONE"


@pytest.mark.parametrize("kind", [
    "part_unknown", "part_negative", "cpu", "steps_zero", "split_over_rows",
    "grid_below_split", "boundary", "aliased",
])
def test_split_ablation_rejects_bad_arguments(kind):
    """K9's ablation wrapper checks its arguments as
    ``ilpsplit.split_multistep`` does, refuses a part it does not have, and
    runs only on the card: on CPU tensors it raises, and no call counts a
    launch."""
    consts = kernel_constants(Parameters())
    bufs = [torch.rand(8, 12) for _ in range(4)]
    args = {"steps": 1, "boundary": "naive", "split": 2, "part": 0,
            "grid": 0}
    if kind == "part_unknown":
        args["part"] = max(ilpsplit.ABLATIONS) + 1
    elif kind == "part_negative":
        args["part"] = -1
    elif kind == "steps_zero":
        args["steps"] = 0
    elif kind == "split_over_rows":
        args["split"] = 9
    elif kind == "grid_below_split":
        args["grid"] = 1
    elif kind == "boundary":
        args["boundary"] = "periodic"
    elif kind == "aliased":
        bufs[2] = bufs[0]
    before = ilpsplit.launches
    with pytest.raises(ValueError):
        ilpsplit.split_ablation(*bufs, consts=consts, **args)
    assert ilpsplit.launches == before
