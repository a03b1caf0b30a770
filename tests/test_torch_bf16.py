"""bf16 storage in the port (``--pallas-dtype bfloat16``: K1, K1's shard
entry, K2 and K7 on bfloat16 buffers) on the CPU, against the JAX package.

On the CPU every wrapper runs its plain version (``stencil.run_bf16``, the
shard references on bfloat16 pairs). The contract is bitwise, tolerance
0.0: the JAX oracle run in blocks of 8 steps and a remainder, the state
rounded through ``jnp.bfloat16`` (to nearest even) after each block, is
the port's result, and it is JAX's interpret-mode bf16 windowed run
(``steps_per_call=8``) too; JAX's megakernel runs are held in
tests/test_torch_bf16_jax.py and its sharded windowed runs in
tests/test_torch_bf16_jax_sharded.py. Beside it: the float32 oracle within JAX's
own atol 0.05 (tests/test_pallas.py:test_bf16_fast_mode), storage and
views, the refusals and ``auto``'s choices against JAX's, the tuners' bf16
keys, the harness's ``--dtype``, snapshots, resume (from a checkpoint of
either package), livesim, and the wrappers' checks. The kernels are held
against these plain versions on the card by chip_smoke.py's phase 15 and
tests/test_torch_gpu.py."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from grayscott_tpu import oracle
from grayscott_tpu.backends.pallas import PallasSimulation
from grayscott_tpu.cli import simulate as jax_simulate
from grayscott_tpu.errors import UnsupportedConfigError as JaxUnsupported
from grayscott_tpu.params import Parameters as JaxParameters
from grayscott_tpu.species import initial_uv
from grayscott_tpu_torch.backends.cuda import CudaSimulation
from grayscott_tpu_torch.backends.sharded import ShardedSimulation
from grayscott_tpu_torch.bench import autotune, harness
from grayscott_tpu_torch.cli import livesim, shared, simulate
from grayscott_tpu_torch.errors import UnsupportedConfigError
from grayscott_tpu_torch.io import checkpoint
from grayscott_tpu_torch.ops import checks, megakernel, sharded_mega, stencil
from grayscott_tpu_torch.ops import windowed
from grayscott_tpu_torch.parallel import halo
from grayscott_tpu_torch.params import Parameters, kernel_constants
from grayscott_tpu_torch.species import Species
from grayscott_tpu_torch.utils import cache

from conftest import random_uv

SHAPES = [(32, 48), (37, 53)]
STEPS = [1, 12, 32]
BOUNDARIES = ["naive", "zero"]


@pytest.fixture(autouse=True)
def store(monkeypatch, tmp_path):
    """An empty autotune store of the test's own."""
    monkeypatch.setenv("GRAYSCOTT_CACHE_DIR", str(tmp_path / "store"))
    return tmp_path / "store"


def to_bf16(x) -> np.ndarray:
    """``x`` rounded to bfloat16 by JAX's type (to nearest even), as
    float32."""
    return np.asarray(np.asarray(x, np.float32).astype(jnp.bfloat16),
                      np.float32)


def oracle_bf16(u, v, params, steps, boundary):
    """The JAX oracle on bf16 storage: the state rounded once, then blocks
    of ``steps // 8`` x 8 steps and one of the remainder, rounded after
    each (grayscott_tpu/ops/pallas_stencil.py:970-993)."""
    u, v = to_bf16(u), to_bf16(v)
    n_full, rem = divmod(steps, 8)
    for k in [8] * n_full + ([rem] if rem else []):
        u, v = oracle.run(u, v, params, k, boundary)
        u, v = to_bf16(u), to_bf16(v)
    return u, v


def run_sim(sim, u, v, steps):
    species = Species(u.shape, sim.build_storage(u, v), sim)
    sim.perform_steps(species, steps)
    return species


def assert_bitwise(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# -- the port against the JAX package ---------------------------------------


@pytest.mark.parametrize("steps", STEPS)
@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("engine", ["auto", "windowed", "mega"])
def test_cuda_backend_equals_rounded_oracle(rng, params, engine, shape,
                                            boundary, steps):
    """Each engine of the ``cuda`` backend on bf16 storage is the oracle
    rounded per block, bit for bit (``auto`` runs K1)."""
    u, v = random_uv(rng, shape)
    sim = CudaSimulation(Parameters(), boundary, device="cpu",
                         dtype="bfloat16", engine=engine)
    species = run_sim(sim, u, v, steps)
    assert species.storage[0] == ("mega" if engine == "mega"
                                  else "windowed")
    assert_bitwise(species.uv_host(),
                   oracle_bf16(u, v, params, steps, boundary))


@pytest.mark.parametrize("steps", STEPS)
@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mesh", [(2, 1), (2, 2)])
def test_sharded_backend_equals_rounded_oracle(rng, params, mesh, shape,
                                               boundary, steps):
    """Both sharded engines on bf16 storage, the windowed one with overlap
    off and on, on 2x1 and 2x2: the oracle rounded per block, bit for
    bit."""
    u, v = random_uv(rng, shape)
    want = oracle_bf16(u, v, params, steps, boundary)
    for kwargs in ({"engine": "windowed", "overlap": "off"},
                   {"engine": "windowed", "overlap": "on"},
                   {"engine": "mega"}):
        sim = ShardedSimulation(Parameters(), boundary, device="cpu",
                                dtype="bfloat16", n_devices=mesh[0] * mesh[1],
                                mesh_cols=mesh[1], tuned_lookup=False,
                                **kwargs)
        species = run_sim(sim, u, v, steps)
        assert species.storage[1].dtype == torch.bfloat16
        assert_bitwise(species.uv_host(), want)


@pytest.mark.parametrize("steps", STEPS)
@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("shape", SHAPES)
def test_cuda_backend_equals_jax_windowed_bf16(rng, params, shape, boundary,
                                               steps):
    """JAX's windowed kernel on bf16 storage in interpret mode
    (``steps_per_call=8``) against the port's K1 path, bit for bit."""
    u, v = random_uv(rng, shape)
    sim = PallasSimulation(params, boundary=boundary, interpret=True,
                           dtype="bfloat16", engine="windowed",
                           steps_per_call=8)
    species = sim.make_species(shape)
    species.storage = sim.build_storage(u, v)
    sim.perform_steps(species, steps)
    port = CudaSimulation(Parameters(), boundary, device="cpu",
                          dtype="bfloat16", engine="windowed")
    assert_bitwise(run_sim(port, u, v, steps).uv_host(),
                   species.uv_host())


@pytest.mark.parametrize("name", ["5points", "pretty", "patra-karttunen"])
def test_other_stencils_within_one_ulp(rng, name):
    """The other stencils against JAX's windowed bf16 run: atol 2^-7, one
    bf16 ulp at 1.0 (JAX's kernel folds the zero path's linear terms, a few
    float32 ulp apart from the oracle's tree, which a rounding to bf16 can
    carry to one bf16 ulp); against the oracle rounded per block 0.0."""
    u, v = random_uv(rng, SHAPES[0])
    jp = JaxParameters.with_stencil(name)
    sim = PallasSimulation(jp, boundary="zero", interpret=True,
                           dtype="bfloat16", engine="windowed",
                           steps_per_call=8)
    species = sim.make_species(u.shape)
    species.storage = sim.build_storage(u, v)
    sim.perform_steps(species, 12)
    port = CudaSimulation(Parameters.with_stencil(name), "zero",
                          device="cpu", dtype="bfloat16")
    got = run_sim(port, u, v, 12).uv_host()
    for g, j in zip(got, species.uv_host()):
        np.testing.assert_allclose(g, j, rtol=0, atol=2.0 ** -7)
    assert_bitwise(got, oracle_bf16(u, v, jp, 12, "zero"))


@pytest.mark.parametrize("engine", ["windowed", "mega"])
@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_within_jax_atol_of_the_f32_oracle(params, engine, boundary):
    """bf16 storage keeps the dynamics within JAX's own atol 0.05 of the
    float32 oracle (tests/test_pallas.py:test_bf16_fast_mode: 16 steps
    from the initial state at 32x48), and it is not the float32 run."""
    u0, v0 = initial_uv((32, 48))
    ou, ov = oracle.run(u0, v0, params, 16, boundary)
    sim = CudaSimulation(Parameters(), boundary, device="cpu",
                         dtype="bfloat16", engine=engine)
    gu, gv = run_sim(sim, u0, v0, 16).uv_host()
    np.testing.assert_allclose(gu, ou, rtol=0, atol=0.05)
    np.testing.assert_allclose(gv, ov, rtol=0, atol=0.05)
    assert not np.array_equal(gv, ov)


# -- storage, views, refusals and auto ---------------------------------------


@pytest.mark.parametrize("engine", ["windowed", "mega"])
def test_storage_is_bf16_and_views_are_f32(rng, engine):
    """The state is stored in bfloat16, rounded once from float32 to
    nearest even; ``extract_uv`` and ``extract_result`` are float32 copies
    of it that no later step writes."""
    u, v = random_uv(rng, (24, 32))
    sim = CudaSimulation(Parameters(), device="cpu", dtype="bfloat16",
                         engine=engine)
    assert (sim.dtype, sim.storage_dtype, sim.fresh_result) == \
        ("bfloat16", torch.bfloat16, True)
    species = Species(u.shape, sim.build_storage(u, v), sim)
    tensors = [t for t in species.storage[1:] if isinstance(t, torch.Tensor)]
    assert len(tensors) == (4 if engine == "windowed" else 2)
    assert all(t.dtype == torch.bfloat16 for t in tensors)
    gu, gv = sim.extract_uv(species.storage, species.shape)
    assert gu.dtype == gv.dtype == torch.float32
    np.testing.assert_array_equal(gu.numpy(), to_bf16(u))
    np.testing.assert_array_equal(gv.numpy(), to_bf16(v))
    result = species.result()
    assert result.dtype == torch.float32
    np.testing.assert_array_equal(result.numpy(), gv.numpy())
    before = result.clone()
    sim.perform_steps(species, 3)
    assert torch.equal(result, before)  # a copy: the steps left it alone
    f32 = CudaSimulation(Parameters(), device="cpu", engine=engine)
    assert (f32.dtype, f32.fresh_result) == ("float32", False)


@pytest.mark.parametrize("kwargs,jax_kwargs", [
    ({"resident": "on"}, {"resident": "on"}),
    ({"pack": "on", "boundary": "zero"}, {"pack": "on", "boundary": "zero"}),
    ({"fold": 2}, {"fold": 2}),
])
def test_refusals_match_jax(kwargs, jax_kwargs):
    """bf16 storage with the resident kernel, the packed layout or a
    lane-fold pin is refused, as JAX refuses it (at construction, or when
    it builds storage)."""
    with pytest.raises(UnsupportedConfigError):
        CudaSimulation(Parameters(), device="cpu", dtype="bfloat16",
                       **kwargs)
    with pytest.raises(JaxUnsupported):
        sim = PallasSimulation(JaxParameters(), interpret=True,
                               dtype="bfloat16", **jax_kwargs)
        sim.build_storage(*initial_uv((32, 256)))


def test_unknown_dtype_raises_like_jax():
    for make in (lambda: CudaSimulation(Parameters(), device="cpu",
                                        dtype="float16"),
                 lambda: ShardedSimulation(Parameters(), device="cpu",
                                           dtype="float16"),
                 lambda: PallasSimulation(JaxParameters(), dtype="float16")):
        with pytest.raises(ValueError, match="unsupported dtype"):
            make()
    # the aliases JAX takes
    assert CudaSimulation(Parameters(), device="cpu",
                          dtype="bf16").dtype == "bfloat16"
    assert ShardedSimulation(Parameters(), device="cpu",
                             dtype="f32").dtype == "float32"


@pytest.mark.parametrize("shape,boundary", [((1080, 1920), "naive"),
                                            ((1080, 1920), "zero"),
                                            ((4096, 4096), "zero"),
                                            ((64, 64), "naive")])
def test_auto_without_a_record_runs_k1(monkeypatch, shape, boundary):
    """With no bf16 record ``auto`` runs K1, JAX's static default for bf16
    (backends/pallas.py:466-470): never K3, even where a float32 record
    ships (1080x1920 naive: K3), never the packed layout (a zero packed
    record ships for 4096^2)."""
    # the card's records, as a run on the card looks them up
    monkeypatch.setattr(autotune, "autotune_platform",
                        lambda device: "h100-80gb-hbm3-sm132")
    sim = CudaSimulation(Parameters(), boundary, device="cpu",
                         dtype="bfloat16")
    assert sim.layout_for(shape) == (False, "windowed")
    # float32 runs K3 (a record, or auto_engine at 64x64) or packs
    f32 = CudaSimulation(Parameters(), boundary, device="cpu")
    assert f32.layout_for(shape) != (False, "windowed")
    if shape == (64, 64):  # JAX's bf16 auto builds windowed storage too
        jax = PallasSimulation(JaxParameters(), boundary=boundary,
                               interpret=True, dtype="bfloat16")
        assert jax.build_storage(*initial_uv(shape))[0] == "windowed"


def put(key: str, **record) -> None:
    entries = cache.load_autotune()
    entries[key] = {"engine": "windowed", "block_rows": None,
                    "steps_per_call": 8, "block_cols": None, "fold": 1,
                    "pack": False, "gcells_per_sec": 1.0, **record}
    cache.save_autotune(entries)


def test_records_key_on_the_dtype_and_steer_only_their_own():
    """A bf16 record keys on ``:bfloat16``: it sends a bf16 run to its
    engine and leaves a float32 run alone, and a float32 record never
    steers a bf16 run; a record of the resident kernel (which bf16 never
    runs) is passed over. ``tuned()`` asks for the sim's dtype only."""
    shape, p = (24, 32), Parameters()
    f32_key = autotune.key_for(p, shape, "naive", device="cpu")
    bf16_key = autotune.key_for(p, shape, "naive", "bfloat16", "cpu")
    assert bf16_key == f32_key + ":bfloat16"
    bf16 = CudaSimulation(p, device="cpu", dtype="bfloat16")
    f32 = CudaSimulation(p, device="cpu")
    put(f32_key, engine="mega")
    assert bf16.engine_for(shape) == "windowed"
    assert f32.engine_for(shape) == "mega"
    put(bf16_key, engine="mega")
    put(f32_key, engine="resident")
    assert bf16.engine_for(shape) == "mega"
    assert f32.engine_for(shape) == "resident"
    assert bf16.tuned(shape)["engine"] == "mega"
    put(bf16_key, engine="resident")
    assert bf16.engine_for(shape) == "windowed"
    asked = []
    real = autotune.lookup

    def spy(*args, **kwargs):
        asked.append(kwargs.get("dtype"))
        return real(*args, **kwargs)

    autotune.lookup = spy
    try:
        bf16.tuned(shape)
        f32.tuned(shape)
    finally:
        autotune.lookup = real
    assert asked == ["bfloat16", "float32"]


def test_autotune_candidates_and_cli(monkeypatch):
    """With bf16 the tuner measures K1 and K2 only (JAX's
    ``_engine_candidates``: no resident, no packed), keys the winner on
    ``:bfloat16``, and ``--autotune --pallas-dtype bfloat16`` follows it;
    the sharded tuner takes bf16 too."""
    monkeypatch.setattr(autotune, "STEPS", 16)
    p = Parameters()
    assert autotune.default_candidates(p, "zero", "bfloat16") == [
        {"engine": "windowed"}, {"engine": "mega"},
        *autotune.WINDOWED_EXTRA, *autotune.MEGA_EXTRA]
    assert len(autotune.default_candidates(p, "zero")) == 13
    before = autotune.measurements
    ns = simulate.build_parser().parse_args(
        ["--autotune", "--device", "cpu", "--pallas-dtype", "bfloat16",
         "-r", "24", "-c", "32"])
    sim = shared.make_simulation(ns)
    assert autotune.measurements - before == 5 or \
        autotune.measurements - before == 7  # a close call measured again
    store = cache.load_autotune()
    assert list(store) == [autotune.key_for(p, (24, 32), "naive",
                                            "bfloat16", "cpu")]
    assert store[list(store)[0]]["engine"] == sim.engine_for((24, 32))
    ns = simulate.build_parser().parse_args(
        ["--autotune", "--device", "cpu", "--pallas-dtype", "bfloat16",
         "--backend", "sharded", "--sharded-devices", "2", "-r", "32",
         "-c", "32"])
    sim = shared.make_simulation(ns)
    keys = [k for k in cache.load_autotune() if "sharded" in k]
    assert len(keys) == 1 and ":bfloat16|sharded:n2" in keys[0]
    species = sim.make_species((32, 32))
    assert species.storage[1].dtype == torch.bfloat16


# -- the entry points -------------------------------------------------------


def test_harness_dtype_runs_on_the_cpu(tmp_path, capsys):
    """``--dtype bfloat16`` runs ``cuda`` and ``sharded`` on bf16 storage
    and labels their rows so; another backend prints JAX's note and runs
    float32 (grayscott_tpu/bench/harness.py:170-177)."""
    out = tmp_path / "sweep.json"
    assert harness.main(["--device", "cpu", "--smin", "3", "--smax", "3",
                         "--steps", "9", "--reps", "1", "--dtype",
                         "bfloat16", "--backends", "cuda,sharded,fused",
                         "-o", str(out)]) == 0
    rows = json.loads(out.read_text())
    assert {r["backend"]: r.get("dtype") for r in rows} == {
        "cuda": "bfloat16", "sharded": "bfloat16", "fused": None}
    assert "fused: dtype=bfloat16 unsupported, running float32" in \
        capsys.readouterr().out


@pytest.mark.parametrize("flags", [
    [], ["--pallas-engine", "mega"],
    ["--backend", "sharded", "--sharded-devices", "4"],
    ["--backend", "sharded", "--sharded-devices", "4", "--sharded-engine",
     "mega"],
])
def test_simulate_frames_and_snapshots(flags):
    """``simulate.run`` on bf16 storage: each frame is the oracle rounded
    per block; ``--snapshot-dtype bfloat16`` hands exactly the stored
    bits; a float32 snapshot takes the widened V as it is (no second
    copy)."""
    argv = ["--device", "cpu", "-r", "24", "-c", "32", "-e", "12",
            "--pallas-dtype", "bfloat16", *flags]
    frames = {}
    for snap in ("float32", "bfloat16"):
        ns = simulate.build_parser().parse_args(argv)
        sim = shared.make_simulation(ns)
        assert sim.fresh_result
        species = sim.make_species((24, 32))
        got = []
        clones = []
        real = torch.Tensor.clone

        def spy(self, *args, **kwargs):
            clones.append(self.shape)
            return real(self, *args, **kwargs)

        torch.Tensor.clone = spy
        try:
            simulate.run(sim, species, 3, 12, got.append, snap)
        finally:
            torch.Tensor.clone = real
        assert (24, 32) not in clones
        frames[snap] = got
    u, v = initial_uv((24, 32))
    for i in range(3):
        u, v = oracle_bf16(u, v, JaxParameters(), 12, "naive")
        np.testing.assert_array_equal(frames["float32"][i], v)
        np.testing.assert_array_equal(frames["bfloat16"][i], v)


@pytest.mark.parametrize("flags", [
    ["--pallas-engine", "windowed"], ["--pallas-engine", "mega"],
    ["--backend", "sharded", "--sharded-devices", "4", "--sharded-overlap",
     "on"],
])
def test_checkpoint_resume_is_bitwise(tmp_path, flags):
    """4 images, ``--checkpoint``, 4 images ``--resume``: bit for bit the
    8 images straight, on bf16 storage."""
    h5py = pytest.importorskip("h5py")
    common = ["--device", "cpu", "-r", "24", "-c", "32", "-e", "12",
              "--pallas-dtype", "bfloat16", *flags]
    full, a, b, ck = (tmp_path / f"{n}.h5" for n in ("full", "a", "b", "ck"))
    assert simulate.main(common + ["-n", "8", "-o", str(full)]) == 0
    assert simulate.main(common + ["-n", "4", "-o", str(a),
                                   "--checkpoint", str(ck)]) == 0
    assert simulate.main(common + ["-n", "4", "-o", str(b),
                                   "--resume", str(ck)]) == 0
    with h5py.File(full) as f, h5py.File(a) as fa, h5py.File(b) as fb:
        want = f["matrix"][:]
        got = np.concatenate([fa["matrix"][:], fb["matrix"][:]])
    np.testing.assert_array_equal(got, want)


def test_resume_from_a_jax_bf16_checkpoint(tmp_path):
    """JAX's simulate on bf16 storage writes a checkpoint after 4 images;
    the port resumes it on bf16 storage and continues bit for bit the
    port's 8 images straight (and JAX's 4 frames are the port's)."""
    h5py = pytest.importorskip("h5py")
    common = ["-r", "24", "-c", "32", "-e", "12", "--pallas-dtype",
              "bfloat16"]
    ck, ja, full, b = (tmp_path / f"{n}.h5"
                       for n in ("ck", "ja", "full", "b"))
    assert jax_simulate.main(common + ["--backend", "pallas", "-n", "4",
                                       "-o", str(ja), "--checkpoint",
                                       str(ck)]) == 0
    assert checkpoint.load_state(ck)[3] == 48
    port = common + ["--device", "cpu"]
    assert simulate.main(port + ["-n", "8", "-o", str(full)]) == 0
    assert simulate.main(port + ["-n", "4", "-o", str(b), "--resume",
                                 str(ck)]) == 0
    with h5py.File(full) as f, h5py.File(ja) as fa, h5py.File(b) as fb:
        want = f["matrix"][:]
        got = np.concatenate([fa["matrix"][:], fb["matrix"][:]])
    np.testing.assert_array_equal(got, want)


def test_livesim_runs_on_bf16_storage():
    """``livesim --pallas-dtype bfloat16``: the palette index pass reads
    the widened V (the oracle rounded per block)."""
    args = livesim.build_parser().parse_args(
        ["-r", "24", "-c", "32", "-e", "12", "--pallas-dtype", "bfloat16",
         "--device", "cpu"])
    src = livesim.FrameSource(args)
    assert src.sim.dtype == "bfloat16"
    idx = src.next_idx_bounded(1)
    _, v = oracle_bf16(*initial_uv((24, 32)), JaxParameters(), 12, "naive")
    want = livesim.palette_index(torch.from_numpy(v), len(src.lut))
    np.testing.assert_array_equal(idx, want.numpy())


# -- the wrappers and the shard layout --------------------------------------


def test_check_state_takes_bf16_and_refuses_a_mix():
    u = torch.zeros((8, 8), dtype=torch.bfloat16)
    checks.check_state((u,), (torch.empty_like(u),),
                       dtypes=checks.STORAGE_DTYPES)
    with pytest.raises(ValueError, match="one dtype"):
        checks.check_state((u,), (torch.empty((8, 8)),),
                           dtypes=checks.STORAGE_DTYPES)
    with pytest.raises(ValueError, match="float32"):
        checks.check_state((u,), (torch.empty_like(u),))  # f32-only kernels
    # the overlap test spans element_size() bytes: a bf16 output that
    # starts 2 bytes in overlaps, one 128 bytes on does not
    flat = torch.zeros(2 * 64 + 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="apart"):
        checks.check_state((flat[:64].view(8, 8),), (flat[1:65].view(8, 8),),
                           dtypes=checks.STORAGE_DTYPES)
    checks.check_state((flat[:64].view(8, 8),), (flat[64:128].view(8, 8),),
                       dtypes=checks.STORAGE_DTYPES)


def test_wrappers_take_bf16_and_count_apart(rng):
    """Each wrapper runs its bf16 plain version on the CPU (launching
    nothing): K1's and K2's equal ``run_bf16``; a mix of dtypes is
    refused."""
    consts = kernel_constants(Parameters())
    u, v = (torch.from_numpy(x).to(torch.bfloat16)
            for x in random_uv(rng, (24, 32)))
    counts = (windowed.bf16_launches, megakernel.bf16_launches,
              sharded_mega.bf16_launches, windowed.bf16_shard_launches)
    uo, vo = torch.empty_like(u), torch.empty_like(v)
    windowed.multistep(u, v, uo, vo, 7, consts, "zero")
    ru, rv = stencil.run_bf16(u, v, 7, consts, "zero")
    assert torch.equal(uo, ru) and torch.equal(vo, rv)
    up, vp = megakernel.pair_state(u), megakernel.pair_state(v)
    megakernel.megastep(up, vp, 3, 5, consts, "zero")
    ru, rv = megakernel.megastep_reference_bf16(u, v, 3, 5, consts, "zero")
    assert torch.equal(up[0], ru) and torch.equal(vp[0], rv)
    with pytest.raises(ValueError):
        windowed.multistep(u, v.float(), uo, vo, 7, consts, "zero")
    with pytest.raises(ValueError):
        megakernel.megastep(up, vp.float(), 1, 5, consts, "zero")
    assert counts == (windowed.bf16_launches, megakernel.bf16_launches,
                      sharded_mega.bf16_launches,
                      windowed.bf16_shard_launches)


def test_pair_state_keeps_bf16(rng):
    """A bf16 state makes a bf16 pair, slot 0 the state's bits."""
    x = torch.from_numpy(random_uv(rng, (8, 16))[0]).to(torch.bfloat16)
    pair = megakernel.pair_state(x)
    assert pair.dtype == torch.bfloat16 and pair.shape == (2, 8, 16)
    np.testing.assert_array_equal(pair[0].float().numpy(),
                                  to_bf16(x.float()))


@pytest.mark.parametrize("n,cols", [(4, 1), (4, 2)])
def test_shard_layout_and_exchange_on_bf16(rng, n, cols):
    """``mega_shard_state`` rounds into bf16 pairs, ``exchange_halos``
    moves bf16 cells as they are (it equals the float32 exchange rounded),
    and ``mega_unshard_result`` widens to a float32 copy."""
    shape = (37, 53)
    u, v = random_uv(rng, shape)
    mesh = halo.make_mesh(n, cols, "cpu")
    bu, bv = halo.mega_shard_state(u, v, mesh, torch.bfloat16)
    fu, _ = halo.mega_shard_state(to_bf16(u), to_bf16(v), mesh)
    assert bu.dtype == bv.dtype == torch.bfloat16
    assert torch.equal(bu.float(), fu)
    halo.exchange_halos(bu)
    halo.exchange_halos(fu)
    assert torch.equal(bu.float(), fu)
    out = halo.mega_unshard_result(bu, shape)
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), to_bf16(u))


def test_shard_references_on_bf16_pairs(rng):
    """K1's shard entry and K7 on bf16 pairs (their plain versions): 12
    steps of K7 (a block of 8 and one of 4) and of K1's shard entry (two
    launches with the exchange between) equal ``run_bf16`` on the whole
    domain, on a 2x2 mesh."""
    shape, consts = (37, 53), kernel_constants(Parameters())
    u, v = random_uv(rng, shape)
    ru, rv = stencil.run_bf16(torch.from_numpy(u).bfloat16(),
                              torch.from_numpy(v).bfloat16(), 12, consts,
                              "naive")
    mesh = halo.make_mesh(4, 2, "cpu")
    up, vp = halo.mega_shard_state(u, v, mesh, torch.bfloat16)
    for n_blocks, k in sharded_mega.launch_plan(12):
        halo.exchange_halos(up)
        halo.exchange_halos(vp)
        sharded_mega.sharded_megastep(up, vp, mesh, n_blocks, k, consts,
                                      "naive", shape)
    assert torch.equal(halo.mega_unshard_result(up, shape), ru.float())
    assert torch.equal(halo.mega_unshard_result(vp, shape), rv.float())
    up, vp = halo.mega_shard_state(u, v, mesh, torch.bfloat16)
    slot = 0
    for k in (8, 4):
        halo.exchange_halos(up, slot)
        halo.exchange_halos(vp, slot)
        windowed.shard_multistep(up, vp, mesh, slot, k, consts, "naive",
                                 shape)
        slot = 1 - slot
    assert torch.equal(halo.mega_unshard_result(up, shape, slot), ru.float())
    assert torch.equal(halo.mega_unshard_result(vp, shape, slot), rv.float())
