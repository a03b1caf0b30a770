"""The port's livesim (grayscott_tpu_torch/cli/livesim.py) on the CPU: a
port of every case of tests/test_livesim.py on ``--device cpu`` (the
``cuda`` backend standing in for ``pallas`` where the JAX case pins it),
then the port against JAX's livesim on the same flags: the headless PNGs
byte for byte, and the device-side palette index on seed-made fields."""

import http.client
import json
import os
import socket
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from grayscott_tpu.cli import livesim as jax_livesim
from grayscott_tpu_torch import native
from grayscott_tpu_torch.cli import livesim
from grayscott_tpu_torch.utils.logs import init_logging

CPU = ["--device", "cpu"]


def _source(argv):
    return livesim.FrameSource(livesim.build_parser().parse_args(argv + CPU))


def _free_port() -> int:
    """An ephemeral port: fixed test ports collide with servers left
    behind by other processes on the machine."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Web:
    """``src``'s web view served from a thread on a free port, shut down
    when the test ends."""

    def __init__(self, src, fps_cap=60.0):
        self.port = _free_port()
        self.server = livesim.make_server(src, self.port, fps_cap)
        self.thread = threading.Thread(
            target=livesim.serve,
            args=(self.server, init_logging(prefer_syslog=False)),
            daemon=True)
        self.thread.start()

    def conn(self):
        return http.client.HTTPConnection("127.0.0.1", self.port, timeout=10)

    def get(self, path):
        conn = self.conn()
        try:
            conn.request("GET", path)
            resp = conn.getresponse()
            return resp.status, resp.getheader("Content-Type"), resp.read()
        finally:
            conn.close()

    def json(self, path):
        status, _, body = self.get(path)
        assert status == 200
        return json.loads(body)

    def close(self):
        self.server.shutdown()
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()


@pytest.fixture
def web():
    servers = []

    def start(src, fps_cap=60.0):
        servers.append(Web(src, fps_cap))
        return servers[-1]

    yield start
    for w in servers:
        w.close()


# -- the JAX cases, ported ----------------------------------------------------


def test_headless_frames(tmp_path):
    rc = livesim.main(
        ["-r", "24", "-c", "32", "--backend", "fused",
         "--frames", "3", "--output-dir", str(tmp_path / "frames")] + CPU
    )
    assert rc == 0
    names = sorted(os.listdir(tmp_path / "frames"))
    assert names == ["0.png", "1.png", "2.png"]
    img = native.png_decode((tmp_path / "frames" / "2.png").read_bytes())
    assert img.shape == (24, 32, 3)
    assert img.max() > 0  # the V=1 box maps to bright INFERNO colors


def test_web_stream_smoke(web):
    pytest.importorskip("PIL")
    src = _source(["-r", "16", "-c", "16", "--backend", "fused"])
    w = web(src)
    conn = w.conn()
    conn.request("GET", "/stream")
    resp = conn.getresponse()
    assert resp.status == 200
    assert "multipart/x-mixed-replace" in resp.getheader("Content-Type")
    data = resp.read(4096)
    conn.close()
    assert b"image/jpeg" in data


def test_steps_per_frame_default_is_one():
    args = livesim.build_parser().parse_args(["--backend", "fused"])
    assert args.nbextrastep is None  # -> 1 in FrameSource (main.rs:77 analog)
    assert _source(["-r", "8", "-c", "8"]).steps_per_frame == 1


def test_web_controls(web):
    """/state, /set (live param change preserving state), /toggle, /reset."""
    src = _source(["-r", "16", "-c", "16", "--backend", "fused"])
    w = web(src)
    state = w.json("/state")
    assert state["paused"] is False
    assert state["feedrate"] == 0.014 and state["killrate"] == 0.054

    # advance a bit so the state is non-trivial, then change the physics
    src.next_rgb()
    before = src.species.uv_host()
    state = w.json("/set?feedrate=0.03&killrate=0.06&steps_per_frame=4")
    assert state["feedrate"] == 0.03 and state["killrate"] == 0.06
    assert state["steps_per_frame"] == 4
    after = src.species.uv_host()  # state carried over to the new sim
    np.testing.assert_array_equal(before[0], after[0])
    np.testing.assert_array_equal(before[1], after[1])

    state = w.json("/toggle")
    assert state["paused"] is True
    frame1 = src.frame()
    frame2 = src.frame()  # paused: no stepping, identical frame object
    assert frame1 is frame2
    state = w.json("/toggle")
    assert state["paused"] is False

    w.json("/reset")
    u, v = src.species.uv_host()
    assert u.max() == 1.0 and float(v.sum()) > 0  # standard init box


def test_set_params_reuses_cuda_kernels(monkeypatch):
    """Parameter sliders on the cuda backend neither rebuild the kernel
    library nor run the autotuner: the kernels take the parameters by
    value (the JAX case: no Mosaic recompile)."""
    from grayscott_tpu_torch.bench import autotune
    from grayscott_tpu_torch.ops import build

    calls = []
    for module, name in ((build, "build"), (build, "load"),
                         (autotune, "autotune")):
        real = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, _real=real, _n=name,
                            **k: calls.append(_n) or _real(*a, **k))
    src = _source(["-r", "16", "-c", "16", "--backend", "cuda"])
    engine = src.species.storage[0]
    src.next_rgb()
    before = src.species.result_host().copy()
    src.set_params(feedrate=0.03, killrate=0.06)
    src.next_rgb()
    assert calls == [], f"slider change rebuilt or retuned: {calls}"
    assert src.species.storage[0] == engine
    # the state carried over and the new physics actually applies (each
    # cold next_rgb fills the frames-in-flight pipeline — `depth`
    # frame-steps — and set_params dropped the in-flight frames)
    assert src.species.steps_performed == 2 * src.frames_in_flight
    assert not np.array_equal(src.species.result_host(), before)
    src.set_params(deltat=0.9)
    src.next_rgb()
    src.set_params(deltat=0.8, feedrate=0.04)
    src.next_rgb()
    assert calls == [] and src.species.storage[0] == engine
    assert src.state()["deltat"] == 0.8 and src.state()["feedrate"] == 0.04


def test_pause_before_first_frame_does_not_advance():
    """frame() while paused with nothing rendered yet must not advance
    the simulation."""
    src = _source(["-r", "16", "-c", "16", "--backend", "fused"])
    src.paused = True
    rgb = src.frame()
    assert rgb.shape == (16, 16, 3)
    assert src.species.steps_performed == 0
    # repeated paused frames stay put
    src.frame()
    assert src.species.steps_performed == 0
    # unpausing resumes the pipeline
    src.paused = False
    src.frame()
    assert src.species.steps_performed >= 1


@pytest.mark.parametrize("depth,frames", [(1, 3), (3, 3), (3, 5), (4, 2),
                                          (3, 1)])
def test_headless_drains_pipeline(tmp_path, depth, frames):
    """N headless outputs cost N frame-steps — the final in-flight frames
    are drained and rendered, not discarded — at any pipeline depth,
    including depth > N and N == 1."""
    src = _source(["-r", "16", "-c", "16", "--backend", "fused",
                   "--frames-in-flight", str(depth)])
    out = tmp_path / f"f{depth}_{frames}"
    rc = livesim.run_headless(src, frames, str(out))
    assert rc == 0
    assert len(os.listdir(out)) == frames
    assert src.species.steps_performed == frames * src.steps_per_frame
    assert not src._pending  # fully drained


def test_frames_in_flight_depth_and_ordering():
    """The pipeline keeps `depth` frames in flight at steady state, and
    every frame is shown exactly once, in order: consecutive next_idx
    results equal a serial replay of the same simulation."""
    def run(extra):
        src = _source(["-r", "16", "-c", "16", "--backend", "fused"] + extra)
        return src, [src.next_idx().copy() for _ in range(6)]

    src3, seq3 = run(["--frames-in-flight", "3"])
    assert src3.frames_in_flight == 3
    # steady state: depth-1 frames remain queued after each show
    assert len(src3._pending) == 2
    # dispatched = shown + in flight
    assert src3.species.steps_performed == 6 + 2
    src1, seq1 = run(["--frames-in-flight", "1"])
    for a, b in zip(seq3, seq1):
        np.testing.assert_array_equal(a, b)


def test_set_params_drops_stale_frames_at_depth():
    """A parameter edit discards ALL queued old-physics frames."""
    src = _source(["-r", "16", "-c", "16", "--backend", "fused",
                   "--frames-in-flight", "3"])
    src.next_idx()
    assert len(src._pending) == 2
    src.set_params(feedrate=0.05)
    assert len(src._pending) == 0


def test_pause_at_depth_keeps_queue_for_resume():
    """Pause before anything rendered shows the oldest in-flight frame
    without dispatching; the remaining queue survives for resume."""
    src = _source(["-r", "16", "-c", "16", "--backend", "fused",
                   "--frames-in-flight", "3"])
    src.next_idx()  # fill pipeline: 3 dispatched, 2 queued
    steps = src.species.steps_performed
    src._last_idx = None
    src.paused = True
    src.frame_idx()
    assert src.species.steps_performed == steps  # no new dispatch
    assert len(src._pending) == 1  # one shown, one kept
    src.paused = False
    src.frame_idx()  # resume: shows the kept frame, tops the queue up
    assert src.species.steps_performed > steps


def test_canvas_endpoints(web):
    """/palette.bin serves the LUT, /frame.bin serves raw palette indices
    (1 B/px) and advances the sim; the default page carries the canvas
    renderer."""
    src = _source(["-r", "16", "-c", "24", "--backend", "fused"])
    w = web(src, 30.0)
    st = w.json("/state")
    assert st["rows"] == 16 and st["cols"] == 24 and st["palette_n"] == 256
    _, _, pal = w.get("/palette.bin")
    assert len(pal) == 256 * 3
    _, _, frame = w.get("/frame.bin")
    assert len(frame) == 16 * 24  # 1 byte per pixel
    assert src.species.steps_performed >= 1  # the GET advanced the sim
    # LUT application reproduces the server-side colorize exactly
    idx = np.frombuffer(frame, np.uint8).reshape(16, 24)
    rgb = np.frombuffer(pal, np.uint8).reshape(-1, 3)[idx]
    assert rgb.shape == (16, 24, 3) and rgb.max() > 0
    _, _, page = w.get("/")
    page = page.decode()
    assert "canvas" in page and "/frame.bin" in page and "/palette.bin" in page


def test_frame_bin_honors_fps_cap(web):
    """--fps-cap bounds the pull path too: 5 back-to-back fetches at a 5
    fps cap take at least ~4 pacing intervals (200 ms each)."""
    src = _source(["-r", "16", "-c", "24", "--backend", "fused"])
    w = web(src, 5.0)
    conn = w.conn()
    conn.request("GET", "/frame.bin")
    conn.getresponse().read()
    t0 = time.time()
    for _ in range(5):
        conn.request("GET", "/frame.bin")
        conn.getresponse().read()
    conn.close()
    assert time.time() - t0 >= 0.6


@pytest.mark.parametrize("res", [64, 256, 512])
def test_diverged_field_nan_safe_index_any_palette(res):
    """NaNs from a diverged run map to palette index 0 on the device
    index path for every palette resolution."""
    src = _source(["-r", "8", "-c", "16", "--backend", "fused",
                   "--color-palette-resolution", str(res)])
    bad = torch.full((8, 16), float("nan"))
    idx = src._to_index(bad).numpy()
    assert idx.dtype == (np.int32 if res > 256 else np.uint8)
    assert idx.min() == 0 and idx.max() == 0
    rgb = src.lut[idx]  # must not IndexError
    assert rgb.shape == (8, 16, 3)


def test_headless_single_frame_costs_one_frame_step(tmp_path):
    """--frames 1 dispatches exactly one frame-step."""
    src = _source(["-r", "8", "-c", "16", "-e", "4", "--backend", "fused",
                   "--frames", "1", "--output-dir", str(tmp_path)])
    livesim.run_headless(src, 1, str(tmp_path))
    assert src.species.steps_performed == 4  # one 4-step frame


def test_set_params_is_atomic_on_bad_values():
    """A bad later value leaves NO earlier value applied."""
    src = _source(["-r", "8", "-c", "16", "--backend", "fused"])
    before = src.state()["feedrate"]
    with pytest.raises(ValueError):
        src.set_params(feedrate="0.03", killrate="abc")
    assert src.args.feedrate != 0.03
    assert src.state()["feedrate"] == before


# -- the port against JAX's livesim, and the port's own rules ---------------


def _pngs(directory):
    names = sorted(os.listdir(directory))
    return names, [(directory / n).read_bytes() for n in names]


def test_headless_pngs_byte_equal_to_jax(tmp_path):
    """--frames 6 -e 4 --backend naive: both are bitwise to the oracle, so
    the pictures are the same bytes; so are the port's cuda backend's
    (its plain version on the CPU)."""
    flags = ["-r", "24", "-c", "32", "-e", "4", "--frames", "6"]
    assert jax_livesim.main(flags + ["--backend", "naive", "--output-dir",
                                     str(tmp_path / "jax")]) == 0
    for backend in ("naive", "cuda"):
        assert livesim.main(flags + CPU + [
            "--backend", backend, "--output-dir",
            str(tmp_path / backend)]) == 0
    want = _pngs(tmp_path / "jax")
    assert want[0] == [f"{i}.png" for i in range(6)]
    assert _pngs(tmp_path / "naive") == want
    assert _pngs(tmp_path / "cuda") == want


@pytest.mark.parametrize("res", [2, 256, 257, 1000])
def test_palette_index_equals_jax(res):
    """The device index pass against JAX's on the same seed-made field,
    NaN and +-Inf included: the same indices, of the same dtype."""
    import jax.numpy as jnp

    rng = np.random.RandomState(res)
    v = rng.uniform(-0.3, 0.8, (33, 45)).astype(np.float32)
    v[2, :5] = np.nan
    v[4, 3:9] = np.inf
    v[5, 1:3] = -np.inf
    argv = ["-r", "8", "-c", "8", "--backend", "naive",
            "--color-palette-resolution", str(res)]
    ref = jax_livesim.FrameSource(jax_livesim.build_parser().parse_args(argv))
    want = np.asarray(ref._to_index(jnp.asarray(v)))
    got = _source(argv)._to_index(torch.from_numpy(v)).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_stream_without_pil_answers_501(web, monkeypatch):
    """/stream needs PIL; without it the answer says so (501) and nothing
    else is served under that path."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    src = _source(["-r", "16", "-c", "16", "--backend", "fused"])
    w = web(src)
    status, _, body = w.get("/stream")
    assert status == 501
    assert src.species.steps_performed == 0
    assert w.get("/nowhere")[0] == 404


def test_main_without_display_falls_back_to_web(monkeypatch):
    """No DISPLAY: the web view, as in JAX; the device still follows
    --device (cuda without a GPU stops)."""
    served = []
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.setattr(livesim, "run_web",
                        lambda src, port, fps, logger: served.append(
                            (src.sim.device.type, port)) or 0)
    assert livesim.main(["-r", "8", "-c", "8", "--port", "1234"] + CPU) == 0
    assert served == [("cpu", 1234)]
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            livesim.main(["-r", "8", "-c", "8"])
        assert len(served) == 1


def test_frames_needs_output_dir():
    assert livesim.main(["-r", "8", "-c", "8", "--frames", "2"] + CPU) == 2
