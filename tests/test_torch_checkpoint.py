"""Checkpoints, resume and bf16 snapshots of the port's simulate
(grayscott_tpu_torch/io/checkpoint.py, cli/simulate.py) on the CPU, against
the JAX package's: a full run equals a checkpointed split run bit for bit
on every backend, checkpoints load across the two packages, and bf16
snapshots are the float32 frames rounded through bf16."""

import h5py
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from grayscott_tpu.cli import simulate as jax_simulate
from grayscott_tpu.io import checkpoint as jax_checkpoint
from grayscott_tpu.params import Parameters as JaxParameters
from grayscott_tpu_torch.backends import get_backend
from grayscott_tpu_torch.cli import simulate
from grayscott_tpu_torch.io import checkpoint
from grayscott_tpu_torch.params import Parameters
from grayscott_tpu_torch.species import Species

#: the JAX command line of tests/test_checkpoint.py:35, on the CPU
COMMON = ["-r", "24", "-c", "32", "-e", "4", "--device", "cpu"]

SHARDED = ["--backend", "sharded", "--sharded-engine", "mega",
           "--sharded-devices", "4"]

#: backends and flags the split run is held on
SPLIT_RUNS = {
    "cuda-naive": ["--backend", "cuda"],
    "cuda-zero": ["--backend", "cuda", "--boundary", "zero"],
    "cuda-mega": ["--backend", "cuda", "--pallas-engine", "mega"],
    "cuda-pack": ["--backend", "cuda", "--boundary", "zero",
                  "--pallas-pack", "on"],
    "sharded": SHARDED,
    "sharded-cols": SHARDED + ["--sharded-mesh-cols", "2"],
    "naive": ["--backend", "naive"],
    "regular": ["--backend", "regular"],
    "fused": ["--backend", "fused"],
    "fused-zero": ["--backend", "fused", "--boundary", "zero"],
    "conv": ["--backend", "conv"],
}


def frames(path):
    with h5py.File(path, "r") as f:
        return f["matrix"][:]


def random_uv(shape, seed=42):
    rng = np.random.RandomState(seed)
    return tuple(rng.uniform(0.0, 1.0, shape).astype(np.float32)
                 for _ in range(2))


def test_state_roundtrip(tmp_path):
    u, v = random_uv((13, 17))
    p = Parameters(feed_rate=0.02)
    checkpoint.save_state(tmp_path / "ck.h5", u, v, p, steps_performed=77)
    u2, v2, p2, steps = checkpoint.load_state(tmp_path / "ck.h5")
    np.testing.assert_array_equal(u, u2)
    np.testing.assert_array_equal(v, v2)
    assert p2 == p and steps == 77
    assert u2.dtype == v2.dtype == np.float32


def test_save_refuses_mismatched_shapes(tmp_path):
    u, v = random_uv((4, 5))
    with pytest.raises(ValueError, match="shape mismatch"):
        checkpoint.save_state(tmp_path / "ck.h5", u, v[:3], Parameters())


def test_load_rejects_non_checkpoint(tmp_path):
    with h5py.File(tmp_path / "x.h5", "w") as f:
        f.create_dataset("matrix", data=np.zeros((1, 2, 2), np.float32))
    with pytest.raises(ValueError, match="not a grayscott-tpu checkpoint"):
        checkpoint.load_state(tmp_path / "x.h5")


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoints_load_across_the_packages(writer, tmp_path):
    """A file written by either package loads in the other: equal arrays
    bit for bit, equal Parameters, the same step count."""
    u, v = random_uv((11, 23), seed=5)
    path = tmp_path / "ck.h5"
    fields = dict(feed_rate=0.029, kill_rate=0.057, time_step=0.5)
    if writer == "port":
        checkpoint.save_state(path, u, v, Parameters.with_stencil(
            "patra-karttunen", **fields), 1234)
        ju, jv, jp, steps = jax_checkpoint.load_state(path)
        assert jp == JaxParameters.with_stencil("patra-karttunen", **fields)
    else:
        jax_checkpoint.save_state(path, u, v, JaxParameters.with_stencil(
            "patra-karttunen", **fields), 1234)
        ju, jv, jp, steps = checkpoint.load_state(path)
        assert jp == Parameters.with_stencil("patra-karttunen", **fields)
    np.testing.assert_array_equal(ju, u)
    np.testing.assert_array_equal(jv, v)
    assert steps == 1234
    assert checkpoint.FORMAT_VERSION == jax_checkpoint.FORMAT_VERSION


@pytest.mark.parametrize("run", sorted(SPLIT_RUNS))
def test_split_run_equals_full_run(run, tmp_path):
    """8 images straight == 4 images + --checkpoint + 4 images --resume,
    bit for bit (tests/test_checkpoint.py:33-56)."""
    common = COMMON + SPLIT_RUNS[run]
    full, a, b = (tmp_path / f"{n}.h5" for n in ("full", "a", "b"))
    ck = tmp_path / "ck.h5"
    assert simulate.main(common + ["-n", "8", "-o", str(full)]) == 0
    assert simulate.main(common + ["-n", "4", "-o", str(a),
                                   "--checkpoint", str(ck)]) == 0
    assert checkpoint.load_state(ck)[3] == 16
    assert simulate.main(common + ["-n", "4", "-o", str(b),
                                   "--resume", str(ck)]) == 0
    got = np.concatenate([frames(a), frames(b)])
    want = frames(full)
    assert got.shape == want.shape == (8, 24, 32)
    for i, (x, y) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(x, y, err_msg=f"frame {i}")


def test_resume_takes_the_checkpoint_shape_and_steps(tmp_path):
    """A resumed run simulates the checkpoint's domain, not -r/-c, and
    counts on from its step count."""
    u, v = random_uv((10, 14), seed=9)
    ck, out, ck2 = (tmp_path / n for n in ("ck.h5", "o.h5", "ck2.h5"))
    checkpoint.save_state(ck, u, v, Parameters(feed_rate=0.03), 40)
    assert simulate.main(COMMON + ["-n", "2", "-o", str(out), "--resume",
                                   str(ck), "--checkpoint", str(ck2)]) == 0
    assert frames(out).shape == (2, 10, 14)
    u2, v2, params, steps = checkpoint.load_state(ck2)
    assert steps == 48 and params == Parameters()
    sim = get_backend("naive")(Parameters(), device="cpu")
    species = Species(u.shape, sim.build_storage(u, v), sim)
    sim.perform_steps(species, 8)
    np.testing.assert_array_equal(species.result_host(), v2)


def test_resume_warns_on_other_parameters(tmp_path, monkeypatch):
    warnings = []
    from grayscott_tpu_torch.utils import logs

    logger = logs.init_logging()
    monkeypatch.setattr(logger, "warning",
                        lambda msg, *a: warnings.append(msg % a))
    u, v = random_uv((10, 14), seed=9)
    ck = tmp_path / "ck.h5"
    checkpoint.save_state(ck, u, v, Parameters(feed_rate=0.03), 40)
    assert simulate.main(COMMON + ["-n", "1", "-o", str(tmp_path / "o.h5"),
                                   "--resume", str(ck)]) == 0
    assert warnings == ["checkpoint parameters differ from CLI parameters; "
                        "using CLI parameters"]


@pytest.mark.parametrize("backend", ["cuda", "fused"])
def test_bf16_snapshots_are_the_f32_frames_rounded(backend, tmp_path):
    """The JAX command line of tests/test_cli.py:202-216 on the port: the
    file stays float32, its frames are the float32 run's rounded through
    bf16 bit for bit, and equal JAX's bf16 frames at that test's atol."""
    base = ["-n", "3", "-r", "24", "-c", "32", "-e", "4"]
    f32, bf16, ref = (tmp_path / f"{n}.h5" for n in ("f32", "bf16", "jax"))
    port = base + ["--backend", backend, "--device", "cpu"]
    assert simulate.main(port + ["-o", str(f32)]) == 0
    assert simulate.main(port + ["-o", str(bf16),
                                 "--snapshot-dtype", "bfloat16"]) == 0
    assert jax_simulate.main(base + ["--backend", "fused", "-o", str(ref),
                                     "--snapshot-dtype", "bfloat16"]) == 0
    va, vb, vj = frames(f32), frames(bf16), frames(ref)
    assert vb.dtype == np.float32
    rounded = torch.from_numpy(va).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(vb, rounded)
    assert np.abs(va - vb).max() > 0  # rounding actually happened
    np.testing.assert_allclose(vb, vj, rtol=0, atol=0.01)


def test_run_hands_bf16_frames_as_float32():
    """run() with snapshot_dtype='bfloat16' hands the sink float32 arrays,
    in order, each V of its batch rounded through bf16."""
    sim = get_backend("regular")(Parameters(), device="cpu")
    species = sim.make_species((17, 29))
    got = []
    simulate.run(sim, species, 3, 5, got.append, "bfloat16")
    ref = sim.make_species((17, 29))
    for frame in got:
        sim.perform_steps(ref, 5)
        assert frame.dtype == np.float32
        np.testing.assert_array_equal(
            frame, ref.result().to(torch.bfloat16).float().numpy())


def test_snapshot_dtype_flag_matches_jax_choices():
    port = simulate.build_parser()
    ref = jax_simulate.build_parser()
    for parser in (port, ref):
        ns = parser.parse_args([])
        assert (ns.snapshot_dtype, ns.checkpoint, ns.resume) == \
            ("float32", None, None)
        with pytest.raises(SystemExit):
            parser.parse_args(["--snapshot-dtype", "float16"])
    actions = {a.dest: a for a in port._actions}
    ref_actions = {a.dest: a for a in ref._actions}
    for dest in ("snapshot_dtype", "checkpoint", "resume"):
        assert actions[dest].choices == ref_actions[dest].choices
        assert actions[dest].help == ref_actions[dest].help
