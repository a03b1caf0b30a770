"""The species-packed path (``CudaSimulation(pack="on")``, K4-K6's plain
version, which the kernels equal bit for bit on the card) held to the
repo's numerical contract: the zero-boundary golden at the tolerance of
``tests/test_goldens.py`` (atol 2e-5), and a 1000-step run at 256x384 on
the zero boundary against the numpy oracle, beside JAX ``fused`` on the
same configuration.

The packed tree (the separable pass and the linear fold) rounds otherwise
than the oracle's 9 taps. After 1000 steps it is 1.1e-4 off the oracle
(8.7e-5 in V), where ``fused`` is 4.4e-6 off; both lie inside
``scripts/parity_check.py``'s bound of 1e-3. Over 100 steps the JAX packed
kernel in interpret mode drifts from the oracle as the port does (4.3e-6
against 4.1e-6), while the port stays within 6.6e-7 of it: the drift is
the packed tree's, inherited from the reference, not a fault of the port.
Each limit below is about twice the value measured on the CPU (the tests
print them; ``pytest -s``)."""

import os

import numpy as np
import pytest
import torch

from grayscott_tpu import oracle
from grayscott_tpu.backends import get_backend
from grayscott_tpu.backends.pallas import PallasSimulation
from grayscott_tpu.params import Parameters as JaxParameters
from grayscott_tpu.species import initial_uv
from grayscott_tpu_torch.backends.cuda import CudaSimulation
from grayscott_tpu_torch.params import Parameters

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                      "zero_oono_48x64_64.npz")
#: tests/test_goldens.py:56
GOLDEN_ATOL = 2e-5

#: scripts/parity_check.py's configuration (BASELINE config 1) on the zero
#: boundary
PARITY_SHAPE, PARITY_STEPS = (256, 384), 1000
#: max |d| over U and V after 1000 steps: the port packed against the
#: oracle (1.1e-4 measured) and JAX fused against it (4.4e-6)
PACKED_VS_ORACLE = 2e-4
FUSED_VS_ORACLE = 1e-5
#: scripts/parity_check.py's acceptance bound for every fast path
PARITY_BOUND = 1e-3
#: the few steps over which the port is held to the JAX packed kernel, and
#: the limit there (6.6e-7 measured)
FEW_STEPS = 100
PORT_VS_JAX_PACKED = 2e-6

#: the port's pins of each packed engine
PINS = {"windowed": {"engine": "windowed"}, "resident": {"resident": "on"},
        "mega": {"engine": "mega"}}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on one host, and
    these tensors are large enough that every worker would otherwise spread
    over every core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port_run(shape, steps, **pins):
    sim = CudaSimulation(Parameters(), "zero", device="cpu", pack="on",
                         **pins)
    species = sim.make_species(shape)
    sim.perform_steps(species, steps)
    return species.storage[0], species.uv_host()


@pytest.mark.parametrize("engine", sorted(PINS))
def test_packed_meets_zero_golden(engine):
    data = np.load(GOLDEN)
    tag, (u, v) = port_run((48, 64), 64, **PINS[engine])
    assert tag in ("packed", "respack", "megapack")
    print(f"{tag} after 64 steps, max |d| against the golden: "
          f"{drift((u, v), (data['u'], data['v']))!r}")
    np.testing.assert_allclose(u, data["u"], rtol=0, atol=GOLDEN_ATOL)
    np.testing.assert_allclose(v, data["v"], rtol=0, atol=GOLDEN_ATOL)


def drift(a, b) -> float:
    return max(float(np.abs(a[0] - b[0]).max()),
               float(np.abs(a[1] - b[1]).max()))


def test_packed_drift_over_1000_steps_beside_fused():
    want = oracle.run(*initial_uv(PARITY_SHAPE), JaxParameters(),
                      PARITY_STEPS, "zero")
    _, got = port_run(PARITY_SHAPE, PARITY_STEPS)
    fused = get_backend("fused")(JaxParameters(), boundary="zero")
    fs = fused.make_species(PARITY_SHAPE)
    fused.perform_steps(fs, PARITY_STEPS)
    print(f"after {PARITY_STEPS} steps at {PARITY_SHAPE}, zero boundary, "
          f"max|dV| (max|dU|) against the oracle: port packed "
          f"{float(np.abs(got[1] - want[1]).max())!r} "
          f"({float(np.abs(got[0] - want[0]).max())!r}), JAX fused "
          f"{float(np.abs(fs.uv_host()[1] - want[1]).max())!r} "
          f"({float(np.abs(fs.uv_host()[0] - want[0]).max())!r})")
    assert drift(fs.uv_host(), want) <= FUSED_VS_ORACLE
    assert drift(got, want) <= PACKED_VS_ORACLE
    assert drift(got, want) <= PARITY_BOUND
    assert np.isfinite(got[1]).all() and float(got[1].max()) > 0.1


def test_packed_drift_is_the_jax_packed_kernels():
    """Over a few steps the port stays much closer to the JAX packed kernel
    (interpret mode) than either stays to the oracle."""
    want = oracle.run(*initial_uv(PARITY_SHAPE), JaxParameters(), FEW_STEPS,
                      "zero")
    _, got = port_run(PARITY_SHAPE, FEW_STEPS)
    sim = PallasSimulation(JaxParameters(), boundary="zero", interpret=True,
                           pack="on", engine="windowed")
    species = sim.make_species(PARITY_SHAPE)
    assert species.storage[0] == "packed"
    sim.perform_steps(species, FEW_STEPS)
    jax_packed = species.uv_host()
    print(f"after {FEW_STEPS} steps at {PARITY_SHAPE}, zero boundary, max "
          f"|d| over U and V: port packed against the oracle "
          f"{drift(got, want)!r}, JAX packed against the oracle "
          f"{drift(jax_packed, want)!r}, port against JAX packed "
          f"{drift(got, jax_packed)!r}")
    assert drift(got, jax_packed) <= PORT_VS_JAX_PACKED
    assert drift(got, jax_packed) < 0.25 * drift(jax_packed, want)
    assert drift(got, jax_packed) < 0.25 * drift(got, want)
