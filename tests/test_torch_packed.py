"""The port's species-packed path (grayscott_tpu_torch/ops/packed.py, K6's
wrapper in ops/megakernel.py, the backend's ``pack="on"`` layout and
``--pallas-pack``) against the JAX package: the constants bit for bit, the
layout, and the plain packed step against the JAX packed kernels K4, K5
and K6 in Pallas interpret mode, alone and through ``simulate``. The CUDA
kernels themselves are held against the plain version on the card by
tests/test_torch_gpu.py and chip_smoke.py.

Tolerance of every comparison with a JAX kernel: atol 1e-6. Both compute
the same float32 tree, but XLA on the CPU contracts parts of it into fused
multiply-adds, so the JAX result is 1-2 ulp a step off the port's (each
operation rounded once); the worst seen here is 3.6e-7.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from grayscott_tpu.backends.pallas import PallasSimulation
from grayscott_tpu.cli import simulate as jax_simulate
from grayscott_tpu.ops import megakernel as jax_mk
from grayscott_tpu.ops import pallas_stencil as ps
from grayscott_tpu.params import Parameters as JaxParameters
from grayscott_tpu_torch.backends import cuda as cuda_backend
from grayscott_tpu_torch.backends.cuda import CudaSimulation
from grayscott_tpu_torch.cli import shared, simulate
from grayscott_tpu_torch.errors import UnsupportedConfigError
from grayscott_tpu_torch.ops import megakernel, packed
from grayscott_tpu_torch.params import Parameters, packed_constants

from conftest import random_uv

#: see the module docstring
ATOL = 1e-6

SEPARABLE = ["oono-puri", "pretty", "patra-karttunen"]
SHAPES = [(24, 16), (19, 16), (17, 23)]
STEPS = [1, 3, 8]


def port_run(u, v, steps, params=None):
    """The plain packed version from host (u, v); host (U, V)."""
    pc = packed_constants(params or Parameters())
    x = packed.pack_state(torch.from_numpy(u), torch.from_numpy(v))
    pu, pv = packed.unpack_state(packed.packed_run(x, steps, pc), u.shape[1])
    return pu.numpy(), pv.numpy()


def assert_close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=ATOL)


# -- constants ----------------------------------------------------------------


@pytest.mark.parametrize("preset", ["reference", "coral"])
@pytest.mark.parametrize("dt", [1.0, 0.5])
@pytest.mark.parametrize("stencil", SEPARABLE)
def test_packed_constants_equal_jax(stencil, dt, preset):
    """Bit for bit: the fold against ``reaction_operand(p)[0, 4:]``, the
    taps and the plan against ``Parameters.separable_plan()``."""
    port = Parameters.with_preset(preset, stencil, time_step=dt)
    ref = JaxParameters.with_preset(preset, stencil, time_step=dt)
    pc = packed_constants(port)
    operand = ps.reaction_operand(ref)[0, 4:]
    got = np.asarray([pc.dt, pc.cu, pc.cv, pc.e, pc.au, pc.bv], np.float32)
    np.testing.assert_array_equal(got, operand)
    kind, h, alpha = ref.separable_plan()
    assert (pc.h0, pc.h1) == (float(h[0]), float(h[1]))
    assert pc.dt_is_one == (dt == 1.0)
    assert pc.quadratic() == ((-1.0, 1.0) if dt == 1.0 else (-dt, dt))
    p_kind, p_h, p_alpha = port.separable_plan()
    assert p_kind == kind == "separable"
    np.testing.assert_array_equal(p_h, h)
    assert p_h.dtype == h.dtype and p_alpha == alpha
    assert type(p_alpha) is type(alpha)
    np.testing.assert_array_equal(port.corrected_weights(),
                                  ref.corrected_weights())
    for x in pc[:-1]:  # every constant is exactly a float32
        assert float(np.float32(x)) == x


def test_non_separable_stencil_is_refused():
    port = Parameters.with_stencil("5points")
    ref = JaxParameters.with_stencil("5points")
    assert port.separable_plan()[0] == ref.separable_plan()[0] == "direct"
    np.testing.assert_array_equal(port.separable_plan()[1],
                                  ref.separable_plan()[1])
    with pytest.raises(UnsupportedConfigError, match="pack"):
        packed_constants(port)


# -- layout -------------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES)
def test_pack_state_matches_jax_layout(rng, shape):
    r, c = shape
    u, v = random_uv(rng, shape)
    x = packed.pack_state(torch.from_numpy(u), torch.from_numpy(v))
    assert x.shape == (r, 2 * c) and x.dtype == torch.float32
    assert x.is_contiguous()
    ref = ps.pack_state(u, v, tr=8, halo=0)
    np.testing.assert_array_equal(x.numpy(), ref[:r])
    for got, want in zip(packed.unpack_state(x, c),
                         ps.unpack_state(ref, 0, r, c)):
        np.testing.assert_array_equal(got.numpy(), want)
    pu, pv = packed.unpack_state(x, c)
    np.testing.assert_array_equal(pu.numpy(), u)
    np.testing.assert_array_equal(pv.numpy(), v)


def test_pack_state_rejects_mismatched_species():
    with pytest.raises(ValueError):
        packed.pack_state(torch.zeros(3, 4), torch.zeros(3, 5))


# -- the plain packed step against the JAX packed kernels ---------------------


@pytest.mark.parametrize("steps", STEPS)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_packed_windowed(rng, shape, steps):
    """K4's reference: ``ps.packed_multistep`` in interpret mode."""
    r, c = shape
    u, v = random_uv(rng, shape)
    x = ps.pack_state(u, v, tr=8, halo=ps.HALO)
    out = ps.packed_multistep(jnp.asarray(x), None, steps=steps, tr=8, r=r,
                              c=c, params=JaxParameters(), halo=ps.HALO,
                              interpret=True)
    want = ps.unpack_state(np.asarray(out), ps.HALO, r, c)
    assert_close(port_run(u, v, steps), want)


@pytest.mark.parametrize("steps", STEPS)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_packed_resident(rng, shape, steps):
    """K5's reference: ``ps.packed_resident_multistep`` in interpret mode,
    on the JAX backend's layout (rows to 8, each species' columns to
    128)."""
    r, c = shape
    u, v = random_uv(rng, shape)
    x = ps.pack_state(u, v, tr=8, halo=0, cquant=128)
    out = ps.packed_resident_multistep(jnp.asarray(x), jnp.int32(steps),
                                       None, r=r, c=c,
                                       params=JaxParameters(),
                                       interpret=True)
    want = ps.unpack_state(np.asarray(out), 0, r, c)
    assert_close(port_run(u, v, steps), want)


@pytest.mark.parametrize("steps", STEPS)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_packed_mega(rng, shape, steps):
    """K6's reference: ``mk.packed_megastep`` in interpret mode, one time
    block of ``steps`` steps."""
    r, c = shape
    u, v = random_uv(rng, shape)
    x = jax_mk.mega_pack_state(u, v, 8)
    out = np.asarray(jax_mk.packed_megastep(
        jnp.asarray(x), jnp.int32(1), None, steps=steps, tr=8, r=r,
        params=JaxParameters(), interpret=True))
    h = jax_mk.MEGA_STEPS
    assert_close(port_run(u, v, steps),
                 (out[0, h:h + r, :c], out[0, h:h + r, c:2 * c]))


@pytest.mark.parametrize("dt", [1.0, 0.5])
@pytest.mark.parametrize("stencil", SEPARABLE)
def test_plain_matches_jax_packed_stencils(rng, stencil, dt):
    """Every separable stencil, and a time step other than 1 (the
    quadratic term's ``-dt``/``+dt`` coefficients), 8 steps at 17x23."""
    r, c = shape = (17, 23)
    u, v = random_uv(rng, shape)
    x = ps.pack_state(u, v, tr=8, halo=ps.HALO)
    ref = JaxParameters.with_stencil(stencil, time_step=dt)
    out = ps.packed_multistep(jnp.asarray(x), None, steps=8, tr=8, r=r, c=c,
                              params=ref, halo=ps.HALO, interpret=True)
    want = ps.unpack_state(np.asarray(out), ps.HALO, r, c)
    assert_close(port_run(u, v, 8, Parameters.with_stencil(
        stencil, time_step=dt)), want)


# -- the slice as a whole -----------------------------------------------------

#: the port's engine pins, and the JAX backend's for the same engine
PINS = {
    "windowed": ({"engine": "windowed"},
                 {"engine": "windowed", "block_rows": 8}),
    "resident": ({"resident": "on"}, {"resident": "on"}),
    "mega": ({"engine": "mega"}, {"engine": "mega", "block_rows": 8}),
}
TAGS = {"windowed": "packed", "resident": "respack", "mega": "megapack"}


def port_backend(u, v, steps, **pins):
    sim = CudaSimulation(Parameters(), "zero", device="cpu", pack="on",
                         **pins)
    species = sim.make_species(u.shape)
    species.storage = sim.build_storage(u, v)
    tag = species.storage[0]
    sim.perform_steps(species, steps)
    return tag, species.uv_host()


@pytest.mark.parametrize("steps", [1, 9, 20, 27])
@pytest.mark.parametrize("engine", sorted(PINS))
def test_backend_matches_jax_pallas_packed(rng, engine, steps):
    """``CudaSimulation(pack="on")`` on each engine against
    ``PallasSimulation(pack="on", interpret=True)`` on the same one; 9, 20
    and 27 steps add remainder launches to full ones."""
    shape = (19, 23)
    u, v = random_uv(rng, shape)
    port_pins, jax_pins = PINS[engine]
    tag, got = port_backend(u, v, steps, **port_pins)
    assert tag == TAGS[engine]
    sim = PallasSimulation(JaxParameters(), boundary="zero", interpret=True,
                           pack="on", **jax_pins)
    species = sim.make_species(shape)
    species.storage = sim.build_storage(u, v)
    assert species.storage[0] == tag
    sim.perform_steps(species, steps)
    assert_close(got, species.uv_host())


@pytest.mark.parametrize("steps", [8, 27])
def test_packed_engines_equal_each_other(rng, steps):
    """The three packed engines give the same state bit for bit."""
    u, v = random_uv(rng, (33, 41))
    got = {engine: port_backend(u, v, steps, **PINS[engine][0])[1]
           for engine in PINS}
    for engine in ("resident", "mega"):
        for a, b in zip(got[engine], got["windowed"]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("flags,tag", [
    ([], "packed"),
    (["--pallas-engine", "windowed"], "packed"),
    (["--pallas-resident", "on"], "respack"),
    (["--pallas-engine", "mega"], "megapack"),
])
def test_simulate_packed_matches_jax_cli(tmp_path, monkeypatch, flags, tag):
    """``simulate --boundary zero --pallas-pack on`` end to end on the CPU
    against the JAX simulate with the same flags, its packed kernels in
    interpret mode; every frame within ATOL."""
    import h5py

    port, ref = tmp_path / "port.h5", tmp_path / "jax.h5"
    args = ["-n", "3", "-r", "24", "-c", "32", "-e", "9", "--boundary",
            "zero", "--pallas-pack", "on", *flags]
    tags = []
    build_storage = CudaSimulation.build_storage

    def spy(self, u, v):
        storage = build_storage(self, u, v)
        tags.append(storage[0])
        return storage

    monkeypatch.setattr(CudaSimulation, "build_storage", spy)
    assert simulate.main(args + ["--device", "cpu", "-o", str(port)]) == 0
    assert tags == [tag]
    assert jax_simulate.main(args + ["--backend", "pallas",
                                     "--pallas-block-rows", "8",
                                     "-o", str(ref)]) == 0
    with h5py.File(port, "r") as p, h5py.File(ref, "r") as j:
        got, want = p["matrix"][:], j["matrix"][:]
    assert got.shape == want.shape == (3, 24, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_packed_snapshot_is_a_column_view(rng):
    """``species.result()`` of packed storage is a column slice, not
    contiguous; its clone is contiguous and ``simulate.run`` hands the
    frames of the plain packed version."""
    ns = simulate.build_parser().parse_args(
        ["-r", "17", "-c", "29", "--device", "cpu", "--boundary", "zero",
         "--pallas-pack", "on", "--pallas-engine", "windowed"])
    sim = shared.make_simulation(ns)
    species = sim.make_species((17, 29))
    view = species.result()
    assert view.shape == (17, 29) and not view.is_contiguous()
    assert view.clone().is_contiguous()
    frames = []
    simulate.run(sim, species, 3, 9, frames.append)
    x = species.storage[1]
    assert view.data_ptr() in (x.data_ptr() + 29 * 4,
                               species.storage[2].data_ptr() + 29 * 4)
    from grayscott_tpu_torch.species import initial_uv

    u, v = initial_uv((17, 29))
    for i, frame in enumerate(frames):
        np.testing.assert_array_equal(
            frame, port_run(u, v, 9 * (i + 1))[1])


# -- knobs, refusals, wrappers ------------------------------------------------


@pytest.mark.parametrize("kind", ["naive", "5points", "maybe"])
def test_pack_refusals(rng, kind):
    """The refusals of tests/test_pack.py, in the port and in the JAX
    backend alike: each a ValueError naming pack."""
    boundary, stencil, pack = "zero", "oono-puri", "on"
    if kind == "naive":
        boundary = "naive"
    elif kind == "5points":
        stencil = "5points"
    else:
        pack = "maybe"
    u, v = random_uv(rng, (16, 16))
    with pytest.raises(ValueError, match="pack"):
        CudaSimulation(Parameters.with_stencil(stencil), boundary,
                       device="cpu", pack=pack).build_storage(u, v)
    with pytest.raises(ValueError, match="pack"):
        PallasSimulation(JaxParameters.with_stencil(stencil),
                         boundary=boundary, interpret=True,
                         pack=pack).build_storage(u, v)


@pytest.mark.parametrize("pack", ["auto", "off"])
@pytest.mark.parametrize("boundary", ["naive", "zero"])
def test_auto_and_off_never_pack(rng, pack, boundary):
    """The default run and the headline rows keep their engines."""
    u, v = random_uv(rng, (16, 16))
    sim = CudaSimulation(Parameters(), boundary, device="cpu", pack=pack)
    assert sim.build_storage(u, v)[0] == cuda_backend.auto_engine(
        (16, 16), boundary)


@pytest.mark.parametrize("pins,engine", [
    ({}, "windowed"),
    ({"resident": "off"}, "windowed"),
    ({"engine": "windowed"}, "windowed"),
    ({"engine": "mega"}, "mega"),
    ({"resident": "on"}, "resident"),
])
def test_packed_engine_choice(pins, engine):
    for shape in ((24, 32), (1080, 1920), (4096, 4096)):
        sim = CudaSimulation(Parameters(), "zero", device="cpu", pack="on",
                             **pins)
        assert sim.engine_for(shape) == engine
    for shape in ((1080, 1920), (4096, 4096)):
        assert cuda_backend.auto_packed_engine(shape) in PINS
        assert cuda_backend.auto_packed_engine(
            shape, resident_ok=False) != "resident"


def test_pallas_pack_flag(monkeypatch):
    """``--pallas-pack`` takes the JAX values and, as the JAX flag does,
    defaults to ``GRAYSCOTT_PALLAS_PACK``; a value outside the choices
    there stops the parser."""
    monkeypatch.delenv("GRAYSCOTT_PALLAS_PACK", raising=False)
    assert simulate.build_parser().parse_args([]).pallas_pack == "auto"
    monkeypatch.setenv("GRAYSCOTT_PALLAS_PACK", "on")
    parser = simulate.build_parser()
    ns = parser.parse_args([])
    assert ns.pallas_pack == "on"
    assert CudaSimulation.args_from_namespace(ns)["pack"] == "on"
    ns = parser.parse_args(["--pallas-pack", "off"])
    assert CudaSimulation.args_from_namespace(ns)["pack"] == "off"
    with pytest.raises(SystemExit):
        parser.parse_args(["--pallas-pack", "maybe"])
    monkeypatch.setenv("GRAYSCOTT_PALLAS_PACK", "maybe")
    with pytest.raises(SystemExit):
        simulate.build_parser()


@pytest.mark.parametrize("kind", [
    "odd_width", "steps_over", "steps_zero", "aliased", "dtype",
    "resident_grid", "resident_steps_zero", "mega_not_pair",
    "mega_n_blocks_zero", "mega_steps_over",
])
def test_packed_wrappers_reject_bad_arguments(kind):
    pc = packed_constants(Parameters())
    x, x_out = torch.rand(8, 12), torch.rand(8, 12)
    with pytest.raises(ValueError):
        if kind == "odd_width":
            packed.multistep(torch.rand(8, 11), torch.rand(8, 11), 1, pc)
        elif kind == "steps_over":
            packed.multistep(x, x_out, packed.K + 1, pc)
        elif kind == "steps_zero":
            packed.multistep(x, x_out, 0, pc)
        elif kind == "aliased":
            packed.multistep(x, x, 1, pc)
        elif kind == "dtype":
            packed.multistep(x, x_out.half(), 1, pc)
        elif kind == "resident_grid":
            packed.resident_multistep(x, x_out, 1, pc, grid=-1)
        elif kind == "resident_steps_zero":
            packed.resident_multistep(x, x_out, 0, pc)
        elif kind == "mega_not_pair":
            megakernel.packed_megastep(torch.rand(3, 8, 12), 1, 1, pc)
        elif kind == "mega_n_blocks_zero":
            megakernel.packed_megastep(torch.rand(2, 8, 12), 0, 1, pc)
        else:
            megakernel.packed_megastep(torch.rand(2, 8, 12), 1,
                                       megakernel.MEGA_STEPS + 1, pc)


def test_cpu_calls_do_not_count_as_launches(rng):
    before = (packed.launches, packed.resident_launches,
              megakernel.packed_launches)
    u, v = random_uv(rng, (17, 23))
    for pins in (p for p, _ in PINS.values()):
        port_backend(u, v, 19, **pins)
    assert (packed.launches, packed.resident_launches,
            megakernel.packed_launches) == before


def test_resident_multistep_returns_result_first(rng):
    pc = packed_constants(Parameters())
    u, v = random_uv(rng, (9, 11))
    x = packed.pack_state(torch.from_numpy(u), torch.from_numpy(v))
    for steps in (1, 2, 5):
        a, b = x.clone(), torch.empty_like(x)
        out = packed.resident_multistep(a, b, steps, pc)
        assert out[0] is (a if steps % 2 == 0 else b)
        assert torch.equal(out[0], packed.packed_run(x, steps, pc))
