"""Two-process ``simulate`` end to end on the CPU, in the shape of
tests/test_distributed_cli.py: ``python -m grayscott_tpu_torch.cli.simulate
--device cpu --backend sharded`` in two coordinated processes over gloo.
Process 0 alone writes the HDF5 file and logs "wrote N images", and its
last image is the oracle's; ``--checkpoint`` then ``--resume`` across a
full restart of both processes equals the straight run;
``GRAYSCOTT_COORDINATOR=auto`` reads torch's ``env://`` variables; and a
peer killed mid-run makes the survivor exit non-zero within its heartbeat
window, never hang.
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
h5py = pytest.importorskip("h5py")

from grayscott_tpu import oracle
from grayscott_tpu.params import Parameters
from grayscott_tpu.species import initial_uv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: a 2x2 mesh over two processes (a mesh row each), 4 steps an image
SHAPE = (48, 300)
BASE = ["--device", "cpu", "--backend", "sharded", "-r", str(SHAPE[0]),
        "-c", str(SHAPE[1]), "-e", "4", "--sharded-devices", "4",
        "--sharded-mesh-cols", "2", "--pallas-steps-per-call", "4"]
HEARTBEAT_S = 10


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def env_for(rank: int, port: int, tmp_path, auto: bool = False) -> dict:
    env = dict(os.environ, GRAYSCOTT_HEARTBEAT_S=str(HEARTBEAT_S),
               GRAYSCOTT_CACHE_DIR=str(tmp_path / "store"))
    if auto:
        env.update(GRAYSCOTT_COORDINATOR="auto", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), WORLD_SIZE="2", RANK=str(rank))
    else:
        env.update(GRAYSCOTT_COORDINATOR=f"127.0.0.1:{port}",
                   GRAYSCOTT_NUM_PROCESSES="2",
                   GRAYSCOTT_PROCESS_ID=str(rank))
    return env


def launch(rank: int, port: int, args: list, tmp_path, auto: bool = False):
    return subprocess.Popen(
        [sys.executable, "-u", "-m", "grayscott_tpu_torch.cli.simulate",
         *args], env=env_for(rank, port, tmp_path, auto), cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def run_pair(args: list, tmp_path, auto: bool = False,
             timeout: float = 120) -> list:
    port = free_port()
    procs = [launch(r, port, args, tmp_path, auto) for r in range(2)]
    outputs = []
    try:
        for p in procs:
            outputs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        pytest.fail("a distributed simulate timed out")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, text) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"rank {rank}:\n{text[-4000:]}"
    return outputs


def oracle_v(steps: int) -> np.ndarray:
    u0, v0 = initial_uv(SHAPE)
    return oracle.run(u0, v0, Parameters(), steps, "naive")[1]


def read(path) -> np.ndarray:
    with h5py.File(path, "r") as f:
        return f["matrix"][...]


@pytest.mark.parametrize("auto", [False, True])
def test_two_process_simulate(tmp_path, auto):
    """Both ranks compute and gather, rank 0 alone writes the file and
    logs the write, and every image is the oracle's; with
    ``GRAYSCOTT_COORDINATOR=auto`` the group forms from ``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE``."""
    out = tmp_path / "dist.h5"
    outputs = run_pair(BASE + ["-n", "3", "-o", str(out)], tmp_path, auto)
    data = read(out)
    assert data.shape == (3, *SHAPE)
    for i in range(3):
        np.testing.assert_array_equal(data[i], oracle_v(4 * (i + 1)))
    assert "wrote 3 images" in outputs[0]
    assert "wrote 3 images" not in outputs[1]
    for rank, text in enumerate(outputs):
        assert f"distributed: process {rank}/2 over gloo" in text
        assert f"process {rank} has image 1 of 3" in text
        assert "backend=sharded engine=shwin2d" in text


def test_checkpoint_resume_across_restart(tmp_path):
    """2 images, a checkpoint, a restart of both processes, 2 more from
    the checkpoint: the last image is the straight 4-image run's (16
    steps), and rank 0 alone wrote the checkpoint."""
    ck = tmp_path / "state.h5"
    outputs = run_pair(BASE + ["-n", "2", "-o", str(tmp_path / "a.h5"),
                               "--checkpoint", str(ck)], tmp_path)
    assert "checkpoint written" in outputs[0]
    assert "checkpoint written" not in outputs[1]
    run_pair(BASE + ["-n", "2", "-o", str(tmp_path / "b.h5"), "--resume",
                     str(ck)], tmp_path)
    straight = tmp_path / "straight.h5"
    run_pair(BASE + ["-n", "4", "-o", str(straight)], tmp_path)
    resumed = read(tmp_path / "b.h5")
    np.testing.assert_array_equal(resumed[-1], read(straight)[-1])
    np.testing.assert_array_equal(resumed[-1], oracle_v(16))


def test_peer_failure_aborts_survivor(tmp_path):
    """Rank 1 is killed once it has logged its first image; rank 0 exits
    non-zero within the heartbeat window plus 60 s, never hangs."""
    port = free_port()
    args = BASE + ["-n", "100000", "-o", str(tmp_path / "doomed.h5")]
    p0 = launch(0, port, args, tmp_path)
    p1 = launch(1, port, args, tmp_path)
    first = threading.Event()

    def watch() -> None:
        for line in p1.stdout:
            if "has image 1 of" in line:
                first.set()

    threading.Thread(target=watch, daemon=True).start()
    try:
        assert first.wait(timeout=120), "rank 1 logged no image"
        assert p0.poll() is None and p1.poll() is None, "a rank ended early"
        p1.send_signal(signal.SIGKILL)
        try:
            text = p0.communicate(timeout=HEARTBEAT_S + 60)[0]
        except subprocess.TimeoutExpired:
            pytest.fail("the survivor hung after its peer died")
        assert p0.returncode != 0, f"the survivor exited 0:\n{text[-3000:]}"
    finally:
        for p in (p0, p1):
            if p.poll() is None:
                p.kill()
            p.wait()
