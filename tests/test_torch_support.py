"""The port's support matrix (``grayscott_tpu_torch/support.py``), in the
shape of tests/test_support.py: every ``rejected`` row raises
:class:`UnsupportedConfigError` on the port's backends, no row is rejected
for a ROADMAP.md item the port has done, every ``ok``, ``auto`` and
``pinned`` row builds and steps on the CPU, each row has its cases here,
and the table is the ``--help`` epilog of ``simulate`` and ``livesim`` and
the README's block."""

import argparse
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from grayscott_tpu_torch import support
from grayscott_tpu_torch.backends.cuda import CudaSimulation
from grayscott_tpu_torch.backends.sharded import ShardedSimulation
from grayscott_tpu_torch.cli import livesim, shared, simulate
from grayscott_tpu_torch.errors import UnsupportedConfigError
from grayscott_tpu_torch.params import Parameters

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (24, 32)

#: each row of the matrix -> its cases: (backend, kwargs), and for a
#: supported row the storage tag the case runs (None: not checked)
SUPPORTED = {
    "engine=windowed (K1) x any boundary x f32/bf16": [
        ("cuda", dict(engine="windowed"), "windowed"),
        ("cuda", dict(engine="windowed", boundary="zero",
                      dtype="bfloat16"), "windowed"),
        ("cuda", dict(engine="windowed", naive_fold=True), "windowed")],
    "engine=mega (K2) x any boundary x f32/bf16": [
        ("cuda", dict(engine="mega"), "mega"),
        ("cuda", dict(engine="mega", boundary="zero", dtype="bfloat16"),
         "mega"),
        ("cuda", dict(engine="mega", naive_fold=True, dtype="bfloat16"),
         "mega")],
    "resident (K3) x f32": [
        ("cuda", dict(resident="on"), "resident"),
        ("cuda", dict(resident="on", boundary="zero"), "resident")],
    "pack (K4, K5, K6) x zero boundary x f32 x separable stencil": [
        ("cuda", dict(pack="on", boundary="zero", engine="windowed"),
         "packed"),
        ("cuda", dict(pack="on", boundary="zero", resident="on"),
         "respack"),
        ("cuda", dict(pack="on", boundary="zero", engine="mega"),
         "megapack")],
    "bf16 storage x windowed/mega/sharded": [
        ("cuda", dict(dtype="bfloat16"), "windowed"),
        ("sharded", dict(dtype="bfloat16", engine="mega", n_devices=2),
         None)],
    "naive_fold x naive x windowed/mega x f32/bf16": [
        ("cuda", dict(naive_fold=True), "windowed"),
        ("cuda", dict(naive_fold=True, engine="mega"), "mega")],
    "naive_fix=store/slice x naive": [
        ("cuda", dict(naive_fix="store"), None),
        ("cuda", dict(naive_fix="slice", resident="on"), "resident")],
    "mega_depth 2..8 x mega (K2)": [
        ("cuda", dict(engine="mega", mega_depth=3), "mega"),
        ("cuda", dict(engine="mega", mega_depth=8, dtype="bfloat16"),
         "mega"),
        ("cuda", dict(pack="on", boundary="zero", engine="mega",
                      mega_depth=5), "megapack"),
        ("cuda", dict(engine="windowed", mega_depth=4), "windowed")],
    "mega_depth > 2 x block_rows/block_cols x mega (K2) x f32/bf16/fold": [
        ("cuda", dict(block_rows=64, engine="mega", mega_depth=3), "mega"),
        ("cuda", dict(block_cols=128, engine="mega", mega_depth=8), "mega"),
        ("cuda", dict(block_rows=8, block_cols=256, engine="mega",
                      mega_depth=4, naive_fold=True), "mega"),
        ("cuda", dict(block_rows=32, engine="mega", mega_depth=5,
                      dtype="bfloat16"), "mega")],
    "lane fold (fold > 1) x windowed (K1) x f32": [
        ("cuda", dict(fold=2), "folded"),
        ("cuda", dict(fold=2, boundary="zero", steps_per_call=16,
                      block_rows=16), "folded"),
        ("cuda", dict(fold=3, engine="windowed", stencil="5points"),
         "folded")],
    "mega_specialize x any engine": [
        ("cuda", dict(engine="mega", mega_specialize=True), "mega"),
        ("cuda", dict(mega_specialize=False, naive_fix="store"), None),
        ("cuda", dict(pack="on", boundary="zero", mega_specialize=True),
         None)],
    "steps_per_call 1..32 x windowed (K1, K4) x f32/bf16/fold": [
        ("cuda", dict(steps_per_call=8), "windowed"),
        ("cuda", dict(steps_per_call=8, engine="mega"), "mega"),
        ("cuda", dict(steps_per_call=16), "windowed"),
        ("cuda", dict(steps_per_call=4, dtype="bfloat16"), "windowed"),
        ("cuda", dict(steps_per_call=32, naive_fold=True), "windowed"),
        ("cuda", dict(steps_per_call=16, pack="on", boundary="zero"),
         "packed")],
    "block_rows/block_cols x windowed (K1, K4) x f32/bf16/fold": [
        ("cuda", dict(block_rows=64), "windowed"),
        ("cuda", dict(block_cols=128, dtype="bfloat16"), "windowed"),
        ("cuda", dict(block_rows=8, block_cols=16, naive_fold=True),
         "windowed"),
        ("cuda", dict(block_rows=32, pack="on", boundary="zero"),
         "packed")],
    "block_rows/block_cols x mega (K2) x f32/bf16/fold": [
        ("cuda", dict(engine="mega", block_rows=8), "mega"),
        ("cuda", dict(engine="mega", block_cols=128, dtype="bfloat16"),
         "mega"),
        ("cuda", dict(engine="mega", block_rows=16, block_cols=512,
                      naive_fold=True), "mega"),
        ("cuda", dict(engine="mega", block_rows=8, naive_fix="store"),
         "mega"),
        ("cuda", dict(engine="mega", block_rows=8, mega_depth=2), "mega")],
    "block_rows x mega x pack (K6)": [
        ("cuda", dict(engine="mega", pack="on", boundary="zero",
                      block_rows=8), "megapack"),
        ("cuda", dict(engine="mega", pack="on", boundary="zero",
                      block_rows=256), "megapack")],
    "sharded mega (K7) x 1-D/2-D mesh x f32/bf16": [
        ("sharded", dict(engine="mega", n_devices=2, mesh_cols=1), None),
        ("sharded", dict(engine="mega", n_devices=4, mesh_cols=2), None)],
    "block_rows/block_cols x sharded mega (K7) x 1-D/2-D mesh x f32/bf16": [
        ("sharded", dict(engine="mega", n_devices=2, mesh_cols=1,
                         block_rows=8), "shmega"),
        ("sharded", dict(engine="mega", n_devices=4, mesh_cols=2,
                         block_cols=128, dtype="bfloat16"), "shmega2d"),
        ("sharded", dict(engine="mega", n_devices=2, mesh_cols=1,
                         block_rows=16, block_cols=256), "shmega")],
    "sharded windowed (K1's shard entry) x 1-D/2-D mesh x f32/bf16": [
        ("sharded", dict(engine="windowed", n_devices=2, mesh_cols=1),
         None),
        ("sharded", dict(engine="windowed", n_devices=4, mesh_cols=2,
                         overlap="on", dtype="bfloat16"), None)],
    "steps_per_call 1..32/block_rows x sharded windowed x f32/bf16": [
        ("sharded", dict(engine="windowed", n_devices=1,
                         steps_per_call=32), "shwin"),
        ("sharded", dict(steps_per_call=3, block_rows=8, n_devices=2,
                         mesh_cols=1, dtype="bfloat16"), "shwin"),
        ("sharded", dict(steps_per_call=12, n_devices=2, mesh_cols=2,
                         overlap="on"), "shwin2d")],
}

#: rejected rows -> cases whose constructor raises UnsupportedConfigError:
#: (backend, kwargs)
REJECTED = {
    "bf16 storage x resident/pack/lane fold": [
        ("cuda", dict(dtype="bfloat16", resident="on")),
        ("cuda", dict(dtype="bfloat16", pack="on", boundary="zero")),
        ("cuda", dict(dtype="bfloat16", fold=2))],
}

#: other refusals the ok rows' notes name
CONFLICTS = [
    ("cuda", dict(resident="on", engine="mega")),
    ("cuda", dict(resident="on", naive_fold=True)),
    ("cuda", dict(resident="on", naive_fix="store")),
    ("cuda", dict(pack="on")),  # the naive boundary
    ("cuda", dict(pack="on", boundary="zero", stencil="5points")),
    ("cuda", dict(naive_fold=True, boundary="zero")),
    ("cuda", dict(naive_fold=True, naive_fix="store")),
    ("cuda", dict(naive_fix="slice", boundary="zero")),
    ("cuda", dict(mega_specialize=True, naive_fix="store")),
    ("cuda", dict(steps_per_call=16, engine="mega")),
    ("cuda", dict(block_cols=128, pack="on", boundary="zero")),
    ("sharded", dict(steps_per_call=16, engine="mega")),
    ("sharded", dict(block_cols=128, engine="windowed")),
    # the lane fold's refusals (JAX's), and a ring past shared memory
    ("cuda", dict(fold=2, resident="on")),
    ("cuda", dict(fold=2, block_cols=128)),
    ("cuda", dict(fold=2, naive_fold=True)),
    ("cuda", dict(fold=4, engine="mega")),
    ("cuda", dict(fold=2, pack="on", boundary="zero")),
    ("cuda", dict(fold=4, block_rows=8, steps_per_call=16)),
    ("cuda", dict(block_rows=24, block_cols=256, engine="mega",
                  mega_depth=3, shape=(200, 512))),
]


def build(backend, kwargs):
    """The simulation of ``kwargs``, and its storage of a domain of SHAPE
    (or ``kwargs["shape"]``) built: a refusal made when storage is built
    (JAX's) raises here too."""
    kwargs = dict(kwargs)
    params = Parameters.with_stencil(kwargs.pop("stencil", "oono-puri"))
    boundary = kwargs.pop("boundary", "naive")
    shape = kwargs.pop("shape", SHAPE)
    cls = CudaSimulation if backend == "cuda" else ShardedSimulation
    sim = cls(params, boundary, device="cpu", tuned_lookup=False, **kwargs)
    sim.make_species(shape)
    return sim


def test_every_row_has_cases():
    rows = {combo: status for combo, status, _ in support.MATRIX}
    assert set(rows) == set(SUPPORTED) | set(REJECTED) | {
        "GRAYSCOTT_COORDINATOR (several processes)"}
    assert all(rows[c] in ("ok", "auto", "pinned") for c in SUPPORTED)
    assert all(rows[c] == "rejected" for c in REJECTED)


@pytest.mark.parametrize("combo,backend,kwargs,tag", [
    (combo, *case) for combo, cases in SUPPORTED.items() for case in cases])
def test_supported_rows_build_and_step(combo, backend, kwargs, tag):
    sim = build(backend, kwargs)
    species = sim.make_species(SHAPE)
    if tag is not None:
        assert species.storage[0] == tag
    sim.perform_steps(species, 9)
    assert np.isfinite(species.result_host()).all()


@pytest.mark.parametrize("combo,backend,kwargs", [
    (combo, *case) for combo, cases in REJECTED.items() for case in cases])
def test_rejected_rows_raise(combo, backend, kwargs):
    with pytest.raises(UnsupportedConfigError):
        build(backend, kwargs)


@pytest.mark.parametrize("backend,kwargs", CONFLICTS)
def test_conflicts_raise(backend, kwargs):
    with pytest.raises(UnsupportedConfigError):
        build(backend, kwargs)


def test_coordinator_row_raises(monkeypatch):
    """The ``GRAYSCOTT_COORDINATOR`` row is ``ok``: its note names the
    windowed engine over gloo, process 0 writing, and Queue 1 item 7.3
    for K7 and NCCL; no row is rejected for Queue 1 item 7.2. Without a
    process group the variable changes nothing in ``make_simulation``
    (the two-process runs: tests/test_torch_distributed*.py)."""
    rows = {combo: (status, note) for combo, status, note in support.MATRIX}
    status, note = rows["GRAYSCOTT_COORDINATOR (several processes)"]
    assert status == "ok"
    for word in ("windowed", "gloo", "process 0", "Queue 1 item 7.3"):
        assert word in note
    assert not any("Queue 1 item 7.2" in n for _, st, n in support.MATRIX
                   if st == "rejected")
    monkeypatch.setenv("GRAYSCOTT_COORDINATOR", "localhost:1234")
    ns = simulate.build_parser().parse_args(["--device", "cpu"])
    assert shared.make_simulation(ns).name == "cuda"


@pytest.mark.parametrize("combo,item", [
    ("lane fold (fold > 1) x windowed (K1) x f32", "Queue 2 item 7"),
    ("mega_depth > 2 x block_rows/block_cols x mega (K2) x f32/bf16/fold",
     "Queue 2 item 12")])
def test_rejected_rows_name_their_item(combo, item):
    """A ROADMAP.md item the port has done (ROADMAP.md has it, marked
    done) is named by no rejected row: its row runs, and no refusal of its
    cases names the item."""
    queue, _, number = item.partition(" item ")
    roadmap = open(os.path.join(REPO, "ROADMAP.md")).read()
    section = roadmap.split(f"### {queue}:")[1].split("\n### ")[0]
    entry = section.split(f"Item {number}:")[1].split("\n- ")[0]
    assert "(done" in entry
    assert not any(item in note for _, status, note in support.MATRIX
                   if status == "rejected")
    rows = {c: st for c, st, _ in support.MATRIX}
    assert rows[combo] in ("auto", "pinned")
    for backend, kwargs, _ in SUPPORTED[combo]:
        sim = build(backend, kwargs)
        sim.perform_steps(sim.make_species(SHAPE), 1)


def test_matrix_renders_both_formats():
    md = support.render("markdown")
    txt = support.render("text")
    assert md.startswith("| configuration | status | notes |")
    assert "UnsupportedConfigError" in txt
    assert len(md.splitlines()) == len(support.MATRIX) + 2
    for combo, status, note in support.MATRIX:
        assert f"| {combo} | {status} | {note} |" in md
        assert combo in txt and f"[{status}] {note}" in txt


@pytest.mark.parametrize("module", [simulate, livesim])
def test_epilog_renders_in_help(module, capsys):
    parser = module.build_parser()
    assert parser.epilog == support.render("text")
    assert parser.formatter_class is argparse.RawDescriptionHelpFormatter
    with pytest.raises(SystemExit) as stop:
        parser.parse_args(["--help"])
    assert stop.value.code == 0
    out = capsys.readouterr().out
    assert "the port's support matrix" in out
    for combo, status, _ in support.MATRIX:
        assert combo in out


def test_matrix_in_readme():
    """The README's block is the markdown form, rendered from support.py."""
    readme = open(os.path.join(REPO, "README.md")).read()
    begin = readme.index("<!-- port-support-matrix:begin")
    end = readme.index("<!-- port-support-matrix:end -->")
    block = readme[begin:end]
    for line in support.render("markdown").splitlines():
        assert line in block
