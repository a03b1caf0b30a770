"""The port's simulate CLI (grayscott_tpu_torch/cli/simulate.py) end to
end on the CPU, against the JAX simulate on the Pallas windowed kernel in
interpret mode and against the numpy oracle."""

import h5py
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from grayscott_tpu import oracle
from grayscott_tpu.cli import simulate as jax_simulate
from grayscott_tpu.params import Parameters
from grayscott_tpu.species import initial_uv
from grayscott_tpu_torch.cli import shared
from grayscott_tpu_torch.cli import simulate

SMALL = ["-n", "3", "-r", "24", "-c", "32", "-e", "8"]


def frames(path):
    with h5py.File(path, "r") as f:
        return f["matrix"][:]


@pytest.mark.parametrize("boundary", ["naive", "zero"])
def test_simulate_matches_jax_pallas_and_oracle(tmp_path, boundary):
    """Each frame: atol 2e-6 against the JAX run (its zero path folds the
    update's linear terms, a few ulp off the oracle's rounding), and
    bitwise against the oracle."""
    port, ref = tmp_path / "port.h5", tmp_path / "jax.h5"
    args = SMALL + ["--boundary", boundary]
    assert simulate.main(args + ["--device", "cpu", "-o", str(port)]) == 0
    assert jax_simulate.main(args + [
        "--backend", "pallas", "--pallas-block-rows", "8", "-o", str(ref),
    ]) == 0
    got, want = frames(port), frames(ref)
    assert got.shape == want.shape == (3, 24, 32)
    u, v = initial_uv((24, 32))
    for i in range(3):
        np.testing.assert_allclose(got[i], want[i], rtol=0, atol=2e-6)
        u, v = oracle.run(u, v, Parameters(), 8, boundary)
        np.testing.assert_array_equal(got[i], v)


@pytest.mark.parametrize("boundary", ["naive", "zero"])
@pytest.mark.parametrize("flags,engine", [
    (["--pallas-resident", "on"], "resident"),
    (["--pallas-engine", "mega"], "mega"),
])
def test_simulate_engine_pins_match_jax_and_oracle(tmp_path, monkeypatch,
                                                   boundary, flags, engine):
    """The slice end to end: the port's simulate on K3 and on K2 against
    the JAX simulate with the same flags (its resident and mega kernels in
    interpret mode), atol 2e-6, and bitwise against the oracle."""
    port, ref = tmp_path / "port.h5", tmp_path / "jax.h5"
    args = SMALL + ["--boundary", boundary] + flags
    engines = []
    build_storage = simulate.shared.get_backend("cuda").build_storage

    def spy(self, u, v):
        storage = build_storage(self, u, v)
        engines.append(storage[0])
        return storage

    monkeypatch.setattr(simulate.shared.get_backend("cuda"),
                        "build_storage", spy)
    assert simulate.main(args + ["--device", "cpu", "-o", str(port)]) == 0
    assert engines == [engine]
    tiles = ["--pallas-block-rows", "8"] if engine == "mega" else []
    assert jax_simulate.main(args + ["--backend", "pallas", *tiles,
                                     "-o", str(ref)]) == 0
    got, want = frames(port), frames(ref)
    assert got.shape == want.shape == (3, 24, 32)
    u, v = initial_uv((24, 32))
    for i in range(3):
        np.testing.assert_allclose(got[i], want[i], rtol=0, atol=2e-6)
        u, v = oracle.run(u, v, Parameters(), 8, boundary)
        np.testing.assert_array_equal(got[i], v)


def test_run_hands_fresh_frames_in_order(params):
    """run() gives the sink one host copy per image, in order, each
    untouched by later batches (9 steps = one K-step launch + remainder)."""
    ns = simulate.build_parser().parse_args(
        ["-r", "17", "-c", "29", "--device", "cpu", "-f", "0.03"])
    sim = shared.make_simulation(ns)
    species = sim.make_species((17, 29))
    got = []
    simulate.run(sim, species, 3, 9, got.append)
    assert species.steps_performed == 27
    u, v = initial_uv((17, 29))
    for frame in got:
        u, v = oracle.run(u, v, sim.params, 9)
        np.testing.assert_array_equal(frame, v)
    np.testing.assert_array_equal(species.result_host(), got[-1])


def test_device_cuda_without_gpu_exits_nonzero(tmp_path, monkeypatch):
    """--device cuda never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        simulate.main(SMALL + ["--device", "cuda",
                               "-o", str(tmp_path / "x.h5")])
    assert exc.value.code not in (0, None)
    assert "--device cpu" in str(exc.value.code)
    assert not (tmp_path / "x.h5").exists()


def test_writer_failure_stops_the_run(tmp_path, monkeypatch):
    """A dead HDF5 writer aborts the run with its error, not a deadlock."""
    from grayscott_tpu_torch.io import hdf5

    def boom(self, result):
        raise OSError("disk full")

    monkeypatch.setattr(hdf5.Writer, "write", boom)
    with pytest.raises(OSError, match="disk full"):
        simulate.main(["-n", "6", "-r", "24", "-c", "32", "-e", "2",
                       "--device", "cpu", "--output-buffer", "1",
                       "-o", str(tmp_path / "x.h5")])
