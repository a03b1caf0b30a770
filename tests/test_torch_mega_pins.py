"""The megakernels' tile pins (K2, K6) on the CPU: the pin rule
(grayscott_tpu_torch/ops/geometry.py: ``mega_pins_ok``, ``mega_resolve``)
and every refusal, the backend's plain versions at pinned tiles bit for bit
the oracle, the CPU twins of the tile dispatch (``stencil.tiled_step`` and
``tiled_step_at``, ``packed.packed_tiled_step``) on ``tr`` x ``tc`` tiles,
the wrappers' checks, and the single-card tuner's tile candidates (JAX's
megakernel variants, mapped onto the port's tiles)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from grayscott_tpu import oracle
from grayscott_tpu.ops import megakernel as jax_mk
from grayscott_tpu_torch.backends.cuda import CudaSimulation
from grayscott_tpu_torch.bench import autotune
from grayscott_tpu_torch.errors import UnsupportedConfigError
from grayscott_tpu_torch.ops import geometry, megakernel, packed, stencil
from grayscott_tpu_torch.params import (Parameters, kernel_constants,
                                        packed_constants)
from grayscott_tpu_torch.species import Species

from conftest import random_uv

SHAPE = (40, 264)


def run(sim, u, v, steps):
    species = Species(u.shape, sim.build_storage(u, v), sim)
    sim.perform_steps(species, steps)
    return species


@pytest.mark.parametrize("tr", [None, 0, 4, 8, 12, 16])
@pytest.mark.parametrize("tc", [None, 64, 100, 128, 256, 384, 1000])
def test_pin_quanta_are_jax(tr, tc):
    """``mega_pins_ok`` takes what JAX's ``mega_ok`` takes of the pins
    (``grayscott_tpu/ops/megakernel.py:733``, ``:746-750``): a positive
    multiple of 8 rows and of 128 columns, on a domain wide enough for
    every column tile and a row tile of up to 16 (a larger one JAX
    refuses for its VMEM, a ceiling that the port's shared-memory check
    stands in for)."""
    c = 2048
    want = jax_mk.mega_ok((64, c), tr or None, tc=tc,
                          boundary="naive") if tr != 0 else False
    assert geometry.mega_pins_ok(tr if tr != 0 else 0, tc) == want


@pytest.mark.parametrize("shape,tr,tc,want", [
    ((1080, 1920), None, None, (64, 64)),
    ((1080, 1920), 8, None, (8, 64)),
    ((1080, 1920), None, 128, (64, 128)),
    ((1080, 1920), 32, 256, (32, 256)),
    ((1080, 1920), 64, 128, (64, 128)),
    ((1080, 1920), None, 512, (8, 512)),
    ((1080, 1920), None, 1920, (64, 64)),   # at least the width: unpinned
    ((40, 56), 1024, None, (40, 64)),       # steps down past the rows
    ((40, 56), 8, 128, (8, 64)),
])
def test_mega_resolve(shape, tr, tc, want):
    g = geometry.mega_resolve(shape, tr, tc)
    assert (g.tr, g.tc, g.halo) == (*want, 8)
    assert g.bytes <= geometry.SMEM_OPTIN
    assert g.compiled == (want == (64, 64))


def test_cover_is_one_tile_column():
    """On a 2-D mesh's shard a column tile at least as wide as the shard
    is one tile column across it (JAX's covering tile)."""
    assert geometry.mega_resolve((128, 96), 8, 128, cover=True).tc == 96
    assert geometry.mega_resolve((128, 96), 8, 128).tc == 64


@pytest.mark.parametrize("tr,tc", [(128, 256), (256, 128), (8, 640),
                                   (512, 512)])
def test_windows_past_the_shared_memory_are_refused(tr, tc):
    with pytest.raises(UnsupportedConfigError, match=r"needs \d+ B"):
        geometry.mega_resolve((4096, 4096), tr, tc)


@pytest.mark.parametrize("kwargs,match", [
    ({"block_rows": 12}, "unsupported for shape (40, 264) at tr=12, "
                         "tc=None"),
    ({"block_rows": 0}, "block_rows must be a positive int"),
    ({"block_cols": 100}, "unsupported for shape (40, 264) at tr=None, "
                          "tc=100"),
    ({"block_cols": 128, "naive_fix": "store"}, "at tr=None, tc=128"),
    ({"block_rows": 16, "mega_depth": 3}, "Queue 2 item 12"),
    ({"block_cols": 128, "mega_depth": 8}, "Queue 2 item 12"),
    ({"block_rows": 16, "steps_per_call": 16}, "fixes steps-per-call"),
    ({"block_rows": 256, "block_cols": 256}, "B of shared memory"),
])
def test_refusals(kwargs, match):
    """JAX's refusals with its class and text (``backends/pallas.py:
    414-428``: the quanta and a column tile under ``naive_fix='store'``),
    the shared memory's, and the window ring at a pinned tile (ROADMAP.md
    Queue 2 item 12)."""
    exc = ValueError if "positive int" in match else UnsupportedConfigError
    u, v = random_uv(np.random.RandomState(0), SHAPE)
    with pytest.raises(exc) as info:
        sim = CudaSimulation(Parameters(), device="cpu", engine="mega",
                             tuned_lookup=False, **kwargs)
        sim.build_storage(u, v)
    assert match in str(info.value)
    assert type(info.value) is exc


@pytest.mark.parametrize("kwargs", [
    {"block_rows": 20}, {"block_rows": 4}])
def test_packed_refusals(kwargs):
    u, v = random_uv(np.random.RandomState(0), (40, 56))
    with pytest.raises(UnsupportedConfigError,
                       match=r"with pack needs full-width windows .* "
                             r"shape \(40, 56\) packed to \(40, 112\)"):
        sim = CudaSimulation(Parameters(), "zero", device="cpu",
                             engine="mega", pack="on", tuned_lookup=False,
                             **kwargs)
        sim.build_storage(u, v)


@pytest.mark.parametrize("boundary", ["naive", "zero"])
@pytest.mark.parametrize("tiles", [(8, None), (None, 128), (16, 128),
                                   (24, 256), (64, None)])
def test_pinned_mega_is_the_oracle(boundary, tiles):
    """K2's plain version under each pin, two time blocks and a remainder:
    the oracle bit for bit, as unpinned; the storage carries the tiles."""
    u, v = random_uv(np.random.RandomState(1), SHAPE)
    sim = CudaSimulation(Parameters(), boundary, device="cpu",
                         engine="mega", block_rows=tiles[0],
                         block_cols=tiles[1], tuned_lookup=False)
    species = run(sim, u, v, 19)
    assert species.storage[0] == "mega"
    assert species.storage[3] == geometry.mega_resolve(SHAPE, *tiles)
    for got, want in zip(species.uv_host(),
                         oracle.run(u, v, Parameters(), 19, boundary)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tr", [8, 32, 1024])
def test_pinned_packed_mega_is_its_plain_version(tr):
    u, v = random_uv(np.random.RandomState(2), (40, 56))
    sim = CudaSimulation(Parameters(), "zero", device="cpu", engine="mega",
                         pack="on", block_rows=tr, tuned_lookup=False)
    species = run(sim, u, v, 13)
    assert species.storage[0] == "megapack"
    assert species.storage[2] == geometry.mega_resolve((40, 56), tr)
    x = packed.pack_state(*(torch.from_numpy(a) for a in (u, v)))
    want = packed.unpack_state(packed.packed_run(
        x, 13, packed_constants(Parameters())), 56)
    for got, w in zip(species.uv_host(), want):
        np.testing.assert_array_equal(got, w.numpy())


@pytest.mark.parametrize("extra", [{"dtype": "bfloat16"},
                                   {"naive_fold": True},
                                   {"naive_fold": True,
                                    "dtype": "bfloat16"}])
def test_pinned_storage_and_fold_equal_unpinned(extra):
    """bf16 storage and the fold round and fold where the unpinned K2 does
    (once a time block): the pinned run's frames are the unpinned run's
    bit for bit."""
    u, v = random_uv(np.random.RandomState(3), SHAPE)
    got, want = (run(CudaSimulation(Parameters(), device="cpu",
                                    engine="mega", tuned_lookup=False,
                                    **extra, **pins), u, v, 21).uv_host()
                 for pins in ({"block_rows": 16, "block_cols": 256}, {}))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_an_engine_mega_record_lends_its_tiles(monkeypatch):
    """An ``engine: mega`` record's tiles are adopted where the run pins
    none (``backends/pallas.py:390-396``), not under a pin of the same
    dimension, not from a windowed record, and not under a ring."""
    rec = {"engine": "mega", "pack": False, "block_rows": 16,
           "block_cols": 128, "steps_per_call": 8}
    monkeypatch.setattr(autotune, "lookup", lambda *a, **k: dict(rec))
    shape = SHAPE
    sim = CudaSimulation(Parameters(), device="cpu", engine="mega")
    assert sim.mega_plan_for(shape, False, sim.tuned(shape)) == \
        geometry.Geometry(16, 128, 8)
    sim = CudaSimulation(Parameters(), device="cpu", engine="mega",
                         block_rows=32)
    assert sim.mega_plan_for(shape, False, rec) == \
        geometry.Geometry(32, 128, 8)
    assert sim.mega_plan_for(shape, False, dict(rec, engine="windowed")) \
        == geometry.Geometry(32, 64, 8)
    ring = CudaSimulation(Parameters(), device="cpu", engine="mega",
                          mega_depth=4)
    assert ring.mega_plan_for(shape, False, rec) == geometry.DEFAULT


@pytest.mark.parametrize("tile", [(8, 64), (16, 128), (24, 8), (64, 64),
                                  (40, 264), (7, 13)])
@pytest.mark.parametrize("boundary", ["naive", "zero"])
def test_tiled_step_on_rectangles(tile, boundary):
    """The CPU twin of K2's and K7's interior dispatch on ``tr`` x ``tc``
    tiles: bitwise the plain step, NaN and Inf included."""
    u, v = (torch.from_numpy(x) for x in random_uv(
        np.random.RandomState(4), (70, 300)))
    u[30, 40] = float("nan")
    v[50, 200] = float("inf")
    consts = kernel_constants(Parameters())
    got = stencil.tiled_step(u, v, consts, boundary, tile, 8)
    want = stencil.step(u, v, consts, boundary)
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    at = stencil.tiled_step_at(u, v, consts, boundary, (-8, -8),
                               (90, 320), tile, 8, anchor=(0, 0))
    want = stencil.step_at(u, v, consts, boundary, (-8, -8), (90, 320))
    for g, w in zip(at, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.parametrize("tile", [(8, 64), (32, 64), (16, 24), (64, 64)])
def test_packed_tiled_step_on_rectangles(tile):
    """K6's twin on ``tr`` x ``tc`` tiles (its row-tile pin), bitwise the
    packed step; a square tile given as one edge is the same."""
    x = torch.from_numpy(np.concatenate(random_uv(
        np.random.RandomState(5), (70, 96)), axis=1))
    pc = packed_constants(Parameters())
    want = packed.packed_step(x, pc)
    got = packed.packed_tiled_step(x, pc, tile, 8)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if tile[0] == tile[1]:
        assert torch.equal(packed.packed_tiled_step(x, pc, tile[0], 8), got)
    assert packed.packed_tiles((70, 48), tile, 8) == packed.packed_tiles(
        (70, 48), geometry.tile_shape(tile), 8)


def test_wrappers_check_the_geometry():
    """A pinned geometry takes no ring, and its halo is the time block's."""
    up = torch.zeros((2, 24, 32))
    consts = kernel_constants(Parameters())
    with pytest.raises(ValueError, match="no window ring"):
        megakernel.megastep(up, up.clone(), 1, 8, consts, "naive",
                            depth=3, geometry=geometry.Geometry(8, 64, 8))
    with pytest.raises(ValueError, match="halo is its time block"):
        megakernel.megastep(up, up.clone(), 1, 8, consts, "naive",
                            geometry=geometry.Geometry(8, 64, 16))
    with pytest.raises(ValueError, match="halo is its time block"):
        megakernel.packed_megastep(torch.zeros((2, 24, 64)), 1, 8,
                                   packed_constants(Parameters()),
                                   geometry=geometry.Geometry(8, 64, 16))


def test_tuner_tile_candidates_map_jax():
    """JAX's megakernel tile variants (``bench/autotune.py:197-214``)
    mapped onto the port's 64x64 tiles: JAX's heuristic column-tiles a
    domain as wide as 16384, and its candidates there are the full-width
    form (no counterpart: a tile cannot span a row) and the double-width
    column tile; the port's tile is always column-tiled, so its candidates
    are the double-width column tile (128) where it is narrower than the
    domain, and the half row tile (32) where the domain is taller."""
    from grayscott_tpu.bench import autotune as jax_autotune

    wide = (4096, 16384)
    jax = [c for c in jax_autotune._engine_candidates(wide, "float32",
                                                      "naive")
           if c.get("engine") == "mega"]
    assert {"engine": "mega"} in jax
    assert any("block_cols" in c for c in jax)
    assert autotune.mega_candidates(wide) == [
        {"engine": "mega", "block_rows": 32},
        {"engine": "mega", "block_cols": 128}]
    assert autotune.mega_candidates((24, 200)) == [
        {"engine": "mega", "block_cols": 128}]
    assert autotune.mega_candidates((64, 96)) == [
        {"engine": "mega", "block_rows": 32}]
    assert autotune.mega_candidates((24, 96)) == []
    cands = autotune.default_candidates(Parameters(), "naive",
                                        shape=(1080, 1920))
    assert cands[-2:] == list(autotune.MEGA_EXTRA)
    assert not any(c.get("engine") == "mega" and c.get("pack")
                   and ("block_rows" in c or "block_cols" in c)
                   for c in autotune.default_candidates(
                       Parameters(), "zero", shape=(1080, 1920)))


def test_mega_record_carries_its_tiles(monkeypatch, tmp_path):
    """A measured K2 tile candidate's record names the tiles it ran."""
    monkeypatch.setenv("GRAYSCOTT_CACHE_DIR", str(tmp_path))
    rec = autotune.measure_config(Parameters(), (24, 200), "naive", steps=8,
                                  reps=1, device="cpu", engine="mega",
                                  block_cols=128)
    assert (rec["engine"], rec["block_rows"], rec["block_cols"],
            rec["steps_per_call"]) == ("mega", None, 128, 8)
