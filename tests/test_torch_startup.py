"""The process group's start-up wait, held to JAX's: ``jax.distributed.
initialize`` gives the peers ``initialization_timeout`` (300 s by default)
to join and uses ``heartbeat_timeout_seconds`` only for failure detection,
so a process that starts later than the heartbeat still joins. The port's
``utils/distributed.py`` waits :data:`STARTUP_TIMEOUT_S` in its TCP store
and hands the heartbeat to the group as the collectives' timeout.
"""

from __future__ import annotations

import datetime
import inspect
import os
import socket
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from grayscott_tpu_torch.utils import distributed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the heartbeat of the late-start test, and how late rank 1 starts
HEARTBEAT_S = 3
LATE_S = 8

CHILD = textwrap.dedent("""
    import os, sys, time
    import torch
    import torch.distributed as dist
    from grayscott_tpu_torch.utils import distributed
    if os.environ["GRAYSCOTT_PROCESS_ID"] == "1":
        time.sleep(float(sys.argv[1]))
    assert distributed.maybe_initialize() is True
    x = torch.tensor([float(distributed.process_index() + 1)])
    dist.all_reduce(x)
    assert x.item() == 3.0, x
    dist.destroy_process_group()
    print("joined and reduced", flush=True)
""")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_late_peer_joins_the_group(tmp_path):
    """Rank 1 starts ``LATE_S`` after rank 0, past a heartbeat of
    ``HEARTBEAT_S``: both form the group, run one all-reduce and exit 0."""
    port = free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, GRAYSCOTT_COORDINATOR=f"127.0.0.1:{port}",
                   GRAYSCOTT_NUM_PROCESSES="2",
                   GRAYSCOTT_PROCESS_ID=str(rank),
                   GRAYSCOTT_HEARTBEAT_S=str(HEARTBEAT_S),
                   GRAYSCOTT_CACHE_DIR=str(tmp_path / "store"))
        procs.append(subprocess.Popen(
            [sys.executable, "-u", "-c", CHILD, str(LATE_S)], env=env,
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    outputs = []
    try:
        for p in procs:
            outputs.append(p.communicate(timeout=120)[0])
    except subprocess.TimeoutExpired:
        pytest.fail("the late-start group hung")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, text) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"rank {rank}:\n{text[-3000:]}"
        assert "joined and reduced" in text


def test_startup_timeout_is_jax_default():
    """The store's wait is the default of ``initialization_timeout`` in
    ``jax.distributed.initialize``'s signature."""
    jax = pytest.importorskip("jax")
    param = inspect.signature(jax.distributed.initialize).parameters[
        "initialization_timeout"]
    assert distributed.STARTUP_TIMEOUT_S == param.default


#: (variables, the store's host and port, whether this process hosts it,
#: the group's world size and rank) for each way of naming the group
CASES = {
    "tcp": ({"GRAYSCOTT_COORDINATOR": "host0:9876",
             "GRAYSCOTT_NUM_PROCESSES": "2", "GRAYSCOTT_PROCESS_ID": "1"},
            "host0", 9876, False, 2, 1),
    "tcp-ipv6": ({"GRAYSCOTT_COORDINATOR": "[::1]:9876",
                  "GRAYSCOTT_NUM_PROCESSES": "2",
                  "GRAYSCOTT_PROCESS_ID": "0"},
                 "::1", 9876, True, 2, 0),
    "env": ({"GRAYSCOTT_COORDINATOR": "auto", "MASTER_ADDR": "10.0.0.5",
             "MASTER_PORT": "2345", "WORLD_SIZE": "3", "RANK": "0"},
            "10.0.0.5", 2345, True, 3, 0),
    "env-agent-store": ({"GRAYSCOTT_COORDINATOR": "auto",
                         "MASTER_ADDR": "10.0.0.5", "MASTER_PORT": "2345",
                         "WORLD_SIZE": "3", "RANK": "0",
                         "TORCHELASTIC_USE_AGENT_STORE": "True"},
                        "10.0.0.5", 2345, False, 3, 0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_heartbeat_is_the_group_timeout(monkeypatch, case):
    """``maybe_initialize`` takes its store from torch's rendezvous, which
    waits ``STARTUP_TIMEOUT_S`` (process 0 its host, unless torchrun's
    agent hosts it), and passes the heartbeat as the group's timeout."""
    variables, host, port, master, world, rank = CASES[case]
    calls = {}

    class FakeStore:
        def __init__(self, **kwargs):
            calls["store"] = kwargs

    def fake_init(backend, **kwargs):
        calls["init"] = (backend, kwargs)

    rendezvous = sys.modules["torch.distributed.rendezvous"]
    monkeypatch.setattr(rendezvous, "TCPStore", FakeStore)
    monkeypatch.setattr(torch.distributed, "init_process_group", fake_init)
    for name in ("GRAYSCOTT_COORDINATOR", "GRAYSCOTT_NUM_PROCESSES",
                 "GRAYSCOTT_PROCESS_ID", "MASTER_ADDR", "MASTER_PORT",
                 "WORLD_SIZE", "RANK", "LOCAL_RANK",
                 "TORCHELASTIC_USE_AGENT_STORE"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("GRAYSCOTT_HEARTBEAT_S", "7")
    for name, value in variables.items():
        monkeypatch.setenv(name, value)
    monkeypatch.setattr(distributed, "local_device", lambda: None)
    assert distributed.maybe_initialize() is True
    store = calls["store"]
    assert (store["host_name"], store["port"], store["world_size"],
            store["is_master"], store["timeout"]) == (
        host, port, world, master,
        datetime.timedelta(seconds=distributed.STARTUP_TIMEOUT_S))
    backend, kwargs = calls["init"]
    assert backend == "gloo"
    assert isinstance(kwargs.pop("store"), FakeStore)
    assert kwargs == {"world_size": world, "rank": rank,
                      "timeout": datetime.timedelta(seconds=7)}


def test_group_joins_an_agent_store_on_the_port(monkeypatch):
    """Under torchrun the elastic agent hosts the store on MASTER_PORT
    and sets ``TORCHELASTIC_USE_AGENT_STORE=True``: rank 0 joins that
    store as a client (it must not host a second one on a port in use),
    and the group runs a collective."""
    import torch.distributed as dist

    agent = dist.TCPStore("127.0.0.1", 0, is_master=True,
                          wait_for_workers=False)
    for name in ("GRAYSCOTT_NUM_PROCESSES", "GRAYSCOTT_PROCESS_ID",
                 "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    for name, value in {"GRAYSCOTT_COORDINATOR": "auto",
                        "MASTER_ADDR": "127.0.0.1",
                        "MASTER_PORT": str(agent.port), "WORLD_SIZE": "1",
                        "RANK": "0", "TORCHELASTIC_USE_AGENT_STORE": "True",
                        "GRAYSCOTT_HEARTBEAT_S": str(HEARTBEAT_S)}.items():
        monkeypatch.setenv(name, value)
    monkeypatch.setattr(distributed, "local_device", lambda: None)
    try:
        assert distributed.maybe_initialize() is True
        x = torch.tensor([2.0])
        dist.all_reduce(x)
        assert x.item() == 2.0
        assert distributed.process_count() == 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
