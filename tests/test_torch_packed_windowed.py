"""The CPU twin of K4's launch on the packed Hopper stepper
(grayscott_tpu_torch/ops/packed.py: ``packed_windowed_run``): each 64x64
tile steps its 80x80 window up to 8 times, the valid region shrinking a
cell a step; an interior tile's window is cut from the state with no
domain test, an edge tile's from the zero-padded state with its cells
outside the domain written as 0.0 every step. And the argument checks of
K4's ablation wrapper (``packed.packed_windowed_ablation``), which runs
only on the card.

Tolerance: none against ``packed.packed_run`` (the twin must equal it bit
for bit, NaN and Inf included); atol 1e-6 against the JAX packed kernel in
interpret mode, for the reason tests/test_torch_packed.py gives (XLA may
contract the packed tree into fused multiply-adds, a few ulp a step)."""

import numpy as np
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from grayscott_tpu.ops import pallas_stencil as ps
from grayscott_tpu.params import Parameters as JaxParameters
from grayscott_tpu_torch.ops import packed
from grayscott_tpu_torch.params import Parameters, packed_constants

#: see the module docstring
ATOL = 1e-6

SEPARABLE = ["oono-puri", "pretty", "patra-karttunen"]

#: ragged against the 64x64 tiles (70x97, 130x200), one tile narrower than
#: its window (19x16), a domain smaller than one tile (5x7), and interior
#: tiles (200x264: 6 of 20)
SHAPES = [(70, 97), (19, 16), (130, 200), (5, 7), (200, 264)]

STEPS = [1, 3, 8]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on one host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32)


def random_packed(shape, seed=0):
    rng = np.random.RandomState(seed)
    return packed.pack_state(*(torch.from_numpy(rng.uniform(0.0, 1.0, shape)
                                                .astype(np.float32))
                               for _ in range(2)))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("steps", STEPS)
@pytest.mark.parametrize("dt", [1.0, 0.5])
@pytest.mark.parametrize("stencil_name", SEPARABLE)
def test_packed_windowed_run_bitwise_equals_packed_run(stencil_name, dt,
                                                       steps, shape):
    pc = packed_constants(Parameters.with_stencil(stencil_name,
                                                  time_step=dt))
    x = random_packed(shape)
    got = packed.packed_windowed_run(x, steps, pc)
    assert torch.equal(bits(got), bits(packed.packed_run(x, steps, pc)))


@pytest.mark.parametrize("steps", STEPS)
@pytest.mark.parametrize("stencil_name", SEPARABLE)
def test_packed_windowed_run_keeps_nan_and_inf(stencil_name, steps):
    """NaN and +-Inf in interior and edge tiles and on the domain's edge
    spread exactly as through the plain packed run; the cells outside the
    domain stay 0.0, so no NaN leaks across U's last column into V's
    first."""
    pc = packed_constants(Parameters.with_stencil(stencil_name))
    x = random_packed((200, 264), seed=1)
    c = 264
    for (r, col), value in (((100, 150), np.nan), ((90, c + 140), np.inf),
                            ((120, 7), -np.inf), ((0, c + 5), np.nan),
                            ((70, c - 1), np.inf), ((199, 2 * c - 1),
                                                    -np.inf),
                            ((64, 63), np.nan)):  # a tile's corner
        x[r, col] = value
    got = packed.packed_windowed_run(x, steps, pc)
    want = packed.packed_run(x, steps, pc)
    assert torch.equal(bits(got), bits(want))
    assert not torch.isfinite(got).all()


@pytest.mark.parametrize("tile,halo", [(32, 8), (64, 4), (16, 2)])
def test_packed_windowed_run_other_geometries(tile, halo):
    """K4's ablation part 2 (32x32 tiles in 48x48 windows), and windows
    shallower than K: bit for bit at every step count the window takes."""
    pc = packed_constants(Parameters(time_step=0.5))
    x = random_packed((130, 97), seed=2)
    for steps in range(1, halo + 1):
        got = packed.packed_windowed_run(x, steps, pc, tile, halo)
        assert torch.equal(bits(got), bits(packed.packed_run(x, steps, pc)))


@pytest.mark.parametrize("steps", STEPS)
@pytest.mark.parametrize("shape", [(24, 16), (19, 16), (17, 23), (70, 97)])
def test_packed_windowed_run_matches_jax_packed_kernel(rng, shape, steps):
    """K4's reference: ``ps.packed_multistep`` in interpret mode, as
    tests/test_torch_packed.py holds the plain packed run to it."""
    r, c = shape
    u = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    v = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    x = ps.pack_state(u, v, tr=8, halo=ps.HALO)
    out = ps.packed_multistep(jnp.asarray(x), None, steps=steps, tr=8, r=r,
                              c=c, params=JaxParameters(), halo=ps.HALO,
                              interpret=True)
    want = ps.unpack_state(np.asarray(out), ps.HALO, r, c)
    got = packed.packed_windowed_run(
        packed.pack_state(torch.from_numpy(u), torch.from_numpy(v)), steps,
        packed_constants(Parameters()))
    for g, w in zip(packed.unpack_state(got, c), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL)


@pytest.mark.parametrize("steps", [0, 9])
def test_packed_windowed_run_refuses_steps_past_the_window(steps):
    with pytest.raises(ValueError):
        packed.packed_windowed_run(random_packed((8, 8)),
                                   packed_constants(Parameters()), steps)


@pytest.mark.parametrize("kind", [
    "part_unknown", "part_negative", "cpu", "steps_zero", "steps_over",
    "odd_width", "aliased",
])
def test_packed_windowed_ablation_rejects_bad_arguments(kind):
    """K4's ablation wrapper checks its arguments as ``packed.multistep``
    does, refuses a part it does not have, and runs only on the card: on
    CPU tensors it raises, and no call counts a launch."""
    pc = packed_constants(Parameters())
    x, x_out = torch.rand(8, 12), torch.rand(8, 12)
    before = packed.launches
    with pytest.raises(ValueError):
        if kind == "part_unknown":
            packed.packed_windowed_ablation(
                x, x_out, 1, pc, max(packed.WINDOWED_ABLATIONS) + 1)
        elif kind == "part_negative":
            packed.packed_windowed_ablation(x, x_out, 1, pc, -1)
        elif kind == "cpu":
            packed.packed_windowed_ablation(x, x_out, 1, pc, 0)
        elif kind == "steps_zero":
            packed.packed_windowed_ablation(x, x_out, 0, pc, 0)
        elif kind == "steps_over":
            packed.packed_windowed_ablation(x, x_out, packed.K + 1, pc, 0)
        elif kind == "odd_width":
            packed.packed_windowed_ablation(torch.rand(8, 11),
                                            torch.rand(8, 11), 1, pc, 0)
        else:
            packed.packed_windowed_ablation(x, x, 1, pc, 0)
    assert packed.launches == before
