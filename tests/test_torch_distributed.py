"""Two processes on the CPU: the port's ``utils/distributed.py`` and the
sharded windowed engine across processes, in the shape of
tests/test_distributed.py.

The variables' parsing and its refusals form no group. Two child
processes of the port join one gloo group over 127.0.0.1 and run every
case of :data:`CASES` (meshes 2x1, 4x1, 2x2 and 1x4: whole mesh rows and
half a mesh row a process; both boundaries; K 8 and 16; bf16; overlap on),
each from ``initial_uv`` and from a seeded random state, and gather U and
V on both ranks (``Species.uv_host``, collective). Each rank's result is
bit for bit the one-process port run on the same mesh, and the numpy
oracle's (bf16: the oracle rounded to bfloat16 once a K-step block, as
the one-process run is). The children also check the refusals: a shard
count the processes do not divide, a mesh whose split is no rectangle,
K7, another backend and ``--autotune``, on both ranks; and that a record
naming K7 runs the windowed engine there.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from grayscott_tpu import oracle
from grayscott_tpu.params import Parameters as JaxParameters
from grayscott_tpu.species import initial_uv
from grayscott_tpu_torch.backends.sharded import ShardedSimulation
from grayscott_tpu_torch.errors import UnsupportedConfigError
from grayscott_tpu_torch.parallel import halo
from grayscott_tpu_torch.params import Parameters
from grayscott_tpu_torch.species import Species
from grayscott_tpu_torch.utils import distributed

from test_torch_bf16 import to_bf16

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: steps of every case: two blocks and a remainder at K = 8, one block and
#: a remainder at K = 16
STEPS = 20
SEED = 7

#: id -> (shape, shards, mesh columns, boundary, K, dtype, overlap)
CASES = {
    "2x1-naive-k8": ((40, 48), 2, 1, "naive", 8, "float32", "off"),
    "2x1-zero-k16-bf16": ((40, 48), 2, 1, "zero", 16, "bfloat16", "off"),
    "4x1-naive-k16": ((72, 40), 4, 1, "naive", 16, "float32", "off"),
    "4x1-zero-k8-bf16": ((72, 40), 4, 1, "zero", 8, "bfloat16", "off"),
    "2x2-zero-k8-overlap": ((300, 300), 4, 2, "zero", 8, "float32", "on"),
    "2x2-naive-k16": ((48, 300), 4, 2, "naive", 16, "float32", "off"),
    "2x2-naive-k8-bf16-overlap": ((300, 300), 4, 2, "naive", 8, "bfloat16",
                                  "on"),
    "1x4-naive-k8-overlap": ((140, 560), 4, 4, "naive", 8, "float32", "on"),
    "1x4-zero-k16": ((24, 96), 4, 4, "zero", 16, "float32", "off"),
}

CHILD = r"""
import json, os, sys
sys.path.insert(0, os.environ["GS_REPO"])
import numpy as np
from grayscott_tpu_torch.backends.sharded import ShardedSimulation
from grayscott_tpu_torch.cli import shared, simulate
from grayscott_tpu_torch.errors import UnsupportedConfigError
from grayscott_tpu_torch.params import Parameters
from grayscott_tpu_torch.species import Species
from grayscott_tpu_torch.utils import distributed as dist
import torch

assert dist.maybe_initialize() is True
assert dist.process_count() == 2
rank, out = dist.process_index(), os.environ["GS_OUT"]
cases = json.loads(os.environ["GS_CASES"])
steps, seed = int(os.environ["GS_STEPS"]), int(os.environ["GS_SEED"])
report = {"refused": {}}
for name, (shape, n, cols, boundary, k, dtype, overlap) in cases.items():
    sim = ShardedSimulation(Parameters(), boundary, device="cpu",
                            n_devices=n, mesh_cols=cols, steps_per_call=k,
                            dtype=dtype, overlap=overlap, engine="windowed",
                            tuned_lookup=False)
    got = {}
    rng = np.random.RandomState(seed)
    u0 = rng.uniform(0, 1, shape).astype(np.float32)
    v0 = rng.uniform(0, 1, shape).astype(np.float32)
    for label, species in (
            ("init", sim.make_species(tuple(shape))),
            ("random", Species(tuple(shape), sim.build_storage(u0, v0),
                               sim))):
        sim.perform_steps(species, steps)
        got[label + "_u"], got[label + "_v"] = species.uv_host()
        got[label + "_result"] = species.result_host()
    np.savez(os.path.join(out, f"{name}-rank{rank}.npz"), **got)
    report[name] = {"split": sim.overlap_runs(tuple(shape)),
                    "local": list(sim.mesh.local_shape),
                    "origin": list(sim.mesh.origin),
                    "pairs": list(species.storage[1].shape)}

def refusal(label, build):
    try:
        build()
    except UnsupportedConfigError as e:
        report["refused"][label] = str(e)
    else:
        report["refused"][label] = None

refusal("3 shards", lambda: ShardedSimulation(
    Parameters(), device="cpu", n_devices=3, mesh_cols=1,
    engine="windowed").make_species((48, 48)))
refusal("3x2 mesh", lambda: ShardedSimulation(
    Parameters(), device="cpu", n_devices=6, mesh_cols=2,
    engine="windowed").make_species((96, 300)))
refusal("mega", lambda: ShardedSimulation(
    Parameters(), device="cpu", n_devices=2, engine="mega"))
for flags in (["--backend", "cuda"], ["--backend", "fused"],
              ["--backend", "sharded", "--autotune"]):
    ns = simulate.build_parser().parse_args(["--device", "cpu"] + flags)
    refusal(" ".join(flags), lambda: shared.make_simulation(ns))
ns = simulate.build_parser().parse_args(["--device", "cpu"])
report["auto"] = shared.make_simulation(ns).name
from grayscott_tpu_torch.bench import autotune
autotune.sharded_lookup = lambda *a, **k: {"engine": "mega", "mesh_cols": 1}
sim = ShardedSimulation(Parameters(), device="cpu", n_devices=2)
report["k7_record"] = sim.make_species((48, 48)).storage[0]
block = torch.full((3, 4), float(rank))
report["fetched"] = dist.fetch(block, dist.Blocks((2, 1), (5, 4))).tolist()
with open(os.path.join(out, f"report-rank{rank}.json"), "w") as f:
    json.dump(report, f)
print("RANK_OK", rank, flush=True)
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_pair(code: str, env_extra: dict, timeout: float = 120):
    """Run ``code`` in two processes of one gloo group; their outputs."""
    port = free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, GS_REPO=REPO,
                   GRAYSCOTT_COORDINATOR=f"127.0.0.1:{port}",
                   GRAYSCOTT_NUM_PROCESSES="2",
                   GRAYSCOTT_PROCESS_ID=str(rank),
                   GRAYSCOTT_HEARTBEAT_S="30", **env_extra)
        procs.append(subprocess.Popen(
            [sys.executable, "-u", "-c", code], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outputs = []
    try:
        for p in procs:
            outputs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        pytest.fail("a distributed child timed out (a hang in the group?)")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, text) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{text[-4000:]}"
        assert f"RANK_OK {rank}" in text
    return outputs


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """Both ranks' results of every case, and their reports."""
    out = tmp_path_factory.mktemp("distributed")
    run_pair(CHILD, {"GS_OUT": str(out), "GS_CASES": json.dumps(CASES),
                     "GS_STEPS": str(STEPS), "GS_SEED": str(SEED)})
    reports = [json.load(open(out / f"report-rank{r}.json"))
               for r in range(2)]
    results = {name: [dict(np.load(out / f"{name}-rank{r}.npz"))
                      for r in range(2)] for name in CASES}
    return results, reports


def states(shape):
    """The two initial states of every case: the box, and the seeded
    random state of the child."""
    rng = np.random.RandomState(SEED)
    u0 = rng.uniform(0, 1, shape).astype(np.float32)
    v0 = rng.uniform(0, 1, shape).astype(np.float32)
    return {"init": initial_uv(shape), "random": (u0, v0)}


@pytest.mark.parametrize("name", list(CASES))
def test_two_processes_equal_one(pair, name):
    """Every rank's U, V and result equal the one-process port run on the
    same mesh bit for bit, and the oracle's (bf16: rounded once a K-step
    block)."""
    results, reports = pair
    shape, n, cols, boundary, k, dtype, overlap = CASES[name]
    sim = ShardedSimulation(Parameters(), boundary, device="cpu",
                            n_devices=n, mesh_cols=cols, steps_per_call=k,
                            dtype=dtype, overlap=overlap, engine="windowed",
                            tuned_lookup=False)
    for label, (u0, v0) in states(shape).items():
        species = Species(shape, sim.build_storage(u0, v0), sim)
        sim.perform_steps(species, STEPS)
        want_u, want_v = species.uv_host()
        ou, ov = np.asarray(u0, np.float32), np.asarray(v0, np.float32)
        if dtype == "bfloat16":
            ou, ov = to_bf16(ou), to_bf16(ov)
        for block in [k] * (STEPS // k) + [STEPS % k]:
            ou, ov = oracle.run(ou, ov, JaxParameters(), block, boundary)
            if dtype == "bfloat16":
                ou, ov = to_bf16(ou), to_bf16(ov)
        np.testing.assert_array_equal(want_u, ou)
        np.testing.assert_array_equal(want_v, ov)
        for rank in range(2):
            got = results[name][rank]
            np.testing.assert_array_equal(got[label + "_u"], want_u)
            np.testing.assert_array_equal(got[label + "_v"], want_v)
            np.testing.assert_array_equal(got[label + "_result"], want_v)
    # each rank held its own block of the mesh, at its own place
    lr, lc = halo.split(n // cols, cols, 2)
    for rank, report in enumerate(reports):
        assert report[name]["local"] == [lr, lc]
        assert report[name]["pairs"][:2] == [lr, lc]
        pi, pj = divmod(rank, cols // lc)
        assert report[name]["origin"] == [pi * lr, pj * lc]
        assert report[name]["split"] == sim.overlap_runs(shape)
    assert report[name]["split"] == (overlap == "on")


@pytest.mark.parametrize("label,words", [
    ("3 shards", ("3 shards", "2 processes")),
    ("3x2 mesh", ("6 shards", "3x2 mesh", "2 processes")),
    ("mega", ("Queue 1 item 7.3", "2 processes")),
    ("--backend cuda", ("--backend cuda", "sharded")),
    ("--backend fused", ("--backend fused", "sharded")),
    ("--backend sharded --autotune", ("--autotune", "2 processes")),
])
def test_refusals_on_both_ranks(pair, label, words):
    """What the port does not run across processes raises on every rank,
    before any step, naming what is at fault."""
    for report in pair[1]:
        message = report["refused"][label]
        assert message is not None, label
        for word in words:
            assert word in message


def test_auto_runs_sharded_and_fetch_gathers(pair):
    """``--backend auto`` runs ``sharded`` in a group, a record that names
    K7 runs the windowed engine there, and ``fetch`` of the ranks' blocks
    gives every rank the whole array, cropped."""
    want = [[0.0] * 4] * 3 + [[1.0] * 4] * 2
    for report in pair[1]:
        assert report["auto"] == "sharded"
        assert report["k7_record"] == "shwin"
        assert report["fetched"] == want


@pytest.mark.parametrize("env,want", [
    ({}, None),
    ({"GRAYSCOTT_COORDINATOR": ""}, None),
    ({"GRAYSCOTT_COORDINATOR": "h:1", "GRAYSCOTT_NUM_PROCESSES": "4",
      "GRAYSCOTT_PROCESS_ID": "3"},
     {"init_method": "tcp://h:1", "world_size": 4, "rank": 3,
      "timeout": 100}),
    ({"GRAYSCOTT_COORDINATOR": "10.0.0.1:9876",
      "GRAYSCOTT_NUM_PROCESSES": "2", "GRAYSCOTT_PROCESS_ID": "0",
      "GRAYSCOTT_HEARTBEAT_S": "7"},
     {"init_method": "tcp://10.0.0.1:9876", "world_size": 2, "rank": 0,
      "timeout": 7}),
    ({"GRAYSCOTT_COORDINATOR": "auto", "MASTER_ADDR": "h",
      "MASTER_PORT": "5", "WORLD_SIZE": "8", "RANK": "2"},
     {"init_method": "env://", "world_size": 8, "rank": 2, "timeout": 100}),
])
def test_config_reads_the_variables(env, want):
    assert distributed.config(env) == want


@pytest.mark.parametrize("env,names", [
    ({"GRAYSCOTT_COORDINATOR": "h:1"}, "GRAYSCOTT_NUM_PROCESSES"),
    ({"GRAYSCOTT_COORDINATOR": "h:1", "GRAYSCOTT_NUM_PROCESSES": "2"},
     "GRAYSCOTT_PROCESS_ID"),
    ({"GRAYSCOTT_COORDINATOR": "h:1", "GRAYSCOTT_NUM_PROCESSES": "two",
      "GRAYSCOTT_PROCESS_ID": "0"}, "GRAYSCOTT_NUM_PROCESSES"),
    ({"GRAYSCOTT_COORDINATOR": "h:1", "GRAYSCOTT_NUM_PROCESSES": "0",
      "GRAYSCOTT_PROCESS_ID": "0"}, "GRAYSCOTT_NUM_PROCESSES"),
    ({"GRAYSCOTT_COORDINATOR": "h:1", "GRAYSCOTT_NUM_PROCESSES": "2",
      "GRAYSCOTT_PROCESS_ID": "2"}, "process id 2"),
    ({"GRAYSCOTT_COORDINATOR": "h:1", "GRAYSCOTT_NUM_PROCESSES": "2",
      "GRAYSCOTT_PROCESS_ID": "-1"}, "GRAYSCOTT_PROCESS_ID"),
    ({"GRAYSCOTT_COORDINATOR": "nohost", "GRAYSCOTT_NUM_PROCESSES": "2",
      "GRAYSCOTT_PROCESS_ID": "0"}, "GRAYSCOTT_COORDINATOR"),
    ({"GRAYSCOTT_COORDINATOR": "h:port", "GRAYSCOTT_NUM_PROCESSES": "2",
      "GRAYSCOTT_PROCESS_ID": "0"}, "GRAYSCOTT_COORDINATOR"),
    ({"GRAYSCOTT_COORDINATOR": "h:1", "GRAYSCOTT_NUM_PROCESSES": "2",
      "GRAYSCOTT_PROCESS_ID": "0", "GRAYSCOTT_HEARTBEAT_S": "0"},
     "GRAYSCOTT_HEARTBEAT_S"),
    ({"GRAYSCOTT_COORDINATOR": "auto"}, "MASTER_ADDR"),
    ({"GRAYSCOTT_COORDINATOR": "auto", "MASTER_ADDR": "h"}, "MASTER_PORT"),
    ({"GRAYSCOTT_COORDINATOR": "auto", "MASTER_ADDR": "h",
      "MASTER_PORT": "5", "RANK": "0"}, "WORLD_SIZE"),
    ({"GRAYSCOTT_COORDINATOR": "auto", "MASTER_ADDR": "h",
      "MASTER_PORT": "5", "WORLD_SIZE": "2"}, "RANK"),
])
def test_config_refuses_a_missing_or_malformed_variable(env, names):
    """A variable that is missing or malformed stops the run with a message
    that names it; no group is formed."""
    with pytest.raises(ValueError, match=names):
        distributed.config(env)
    assert not torch.distributed.is_initialized()


def test_one_process_is_untouched(monkeypatch):
    """Without the variable nothing starts: one process, rank 0, the
    primary; ``fetch`` copies, and a mesh holds every shard."""
    monkeypatch.delenv("GRAYSCOTT_COORDINATOR", raising=False)
    assert distributed.maybe_initialize() is False
    assert (distributed.process_count(), distributed.process_index(),
            distributed.is_primary()) == (1, 0, True)
    x = torch.arange(6.0).reshape(2, 3)
    got = distributed.fetch(x)
    x += 1
    np.testing.assert_array_equal(got, np.arange(6.0).reshape(2, 3))
    mesh = halo.make_mesh(4, 2, "cpu")
    assert (mesh.local_shape, mesh.origin, mesh.blocks((8, 8))) == (
        (2, 2), (0, 0), None)


@pytest.mark.parametrize("n_rows,n_cols,procs,want", [
    (2, 1, 2, (1, 1)), (4, 1, 2, (2, 1)), (2, 2, 2, (1, 2)),
    (1, 4, 2, (1, 2)), (2, 2, 4, (1, 1)), (2, 4, 4, (1, 2)),
    (1, 8, 4, (1, 2)), (4, 2, 2, (2, 2)), (3, 2, 2, None), (2, 3, 4, None),
    (3, 1, 2, None), (2, 3, 2, (1, 3)),
])
def test_split(n_rows, n_cols, procs, want):
    """Each process's block: whole mesh rows, or an equal part of one;
    any other split is refused with the shard count, the processes and
    the mesh."""
    assert halo.split(n_rows, n_cols, procs) == want
    if want is None:
        with pytest.raises(UnsupportedConfigError,
                           match=f"{n_rows}x{n_cols} mesh"):
            halo.Mesh(n_rows, n_cols, torch.device("cpu"), processes=procs)
        return
    for p in range(procs):
        mesh = halo.Mesh(n_rows, n_cols, torch.device("cpu"),
                         processes=procs, process=p)
        start = p * n_rows * n_cols // procs
        assert mesh.origin == divmod(start, n_cols)
        grid = mesh.process_grid
        assert grid[0] * want[0] == n_rows and grid[1] * want[1] == n_cols
