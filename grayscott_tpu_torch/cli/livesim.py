"""Live simulation visualizer: the port's ``grayscott_tpu/cli/livesim.py``.

Interface parity with the reference's ``livesim`` binary
(``livesim/src/main.rs:38-57``): shared simulation args, steps-per-frame
default 1 (``main.rs:77``), window sized to the domain, INFERNO palette with
amplitude scale 2 (``ui/src/lib.rs:115-123``,
``livesim/src/palette.rs:42-121``).

The palette *index* of each frame is computed on the device (a uint8
tensor, 4x smaller than f32, made on the launch stream right after the
frame's steps, since ``Species.result()`` views the live state) and copied
into a pinned host frame on a copy stream of the source's own, after an
event recorded on the launch stream, while the next frames step; it is
colorized on the host (or in the browser). Up to ``--frames-in-flight``
frames are in flight, each an (event, pinned frame) pair; the host waits
only on the oldest one's event. This is ``cli/simulate.py:run``'s copy
pattern. Three frontends, picked automatically:

- ``matplotlib`` window when a display is available (matplotlib imported
  inside :func:`run_window`);
- ``--web``: a dependency-free HTTP view on 127.0.0.1 (``--port``, default
  8000): the page colorizes raw palette indices in the browser; ``/stream``
  (MJPEG, for palettes above 256 colours) needs PIL, imported in its
  handler, and answers 501 without it;
- ``--frames N --output-dir D``: headless PNG dump through ``native/``
  (also the test hook).

With no DISPLAY, :func:`main` falls back to ``--web``. That is a choice of
front end, not of device: ``--device cuda`` (the default) without a GPU
still stops.
"""

from __future__ import annotations

import argparse
import io
import os
import sys
import threading
import time
from collections import deque

import numpy as np
import torch

from ..species import Species
from ..utils.logs import init_logging
from ..utils.palette import AMPLITUDE_SCALE, inferno_lut
from ..utils.runtime import apply_env_config
from . import shared


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="livesim", description="Gray-Scott reaction live simulation"
    )
    shared.add_shared_args(parser)
    parser.add_argument(
        "--web", action="store_true",
        help="Serve an MJPEG live stream over HTTP instead of opening a window",
    )
    parser.add_argument("--port", type=int, default=8000, help="HTTP port for --web")
    parser.add_argument(
        "--frames", type=int, default=0,
        help="Render N frames headlessly into --output-dir, then exit",
    )
    parser.add_argument("--output-dir", default=None, help="Directory for --frames")
    parser.add_argument(
        "--fps-cap", type=float, default=60.0, help="Maximum frames per second"
    )
    parser.add_argument(
        "--color-palette-resolution", type=int, default=256,
        help="Number of palette entries (livesim/src/main.rs:50-57 analog)",
    )
    parser.add_argument(
        "--frames-in-flight", type=int,
        default=int(os.environ.get("GRAYSCOTT_FRAMES_IN_FLIGHT", "3")),
        help="Device frames dispatched ahead of display (the reference's "
        "swapchain frames-in-flight depth, livesim/src/frames.rs:21-175; "
        "default 3). Deeper pipelines overlap several device->host "
        "transfers with host-side encode across a high-RTT link, at the "
        "cost of that many frames of display lag on the live controls",
    )
    return parser


def palette_index(v: torch.Tensor, n: int) -> torch.Tensor:
    """Device-side palette index of V for an ``n``-entry palette:
    clamp(scale * v, 0, 1) * (n - 1), in float32, cast to uint8 (int32
    above 256 colours), on ``v``'s device and current stream. NaNs (a
    diverged field, e.g. via the dt slider) map to index 0 like
    utils/palette.colorize — clamp propagates NaN, and a NaN cast lands at
    an arbitrary out-of-range LUT index that would IndexError any palette
    resolution != 256."""
    t = torch.nan_to_num(v * AMPLITUDE_SCALE, nan=0.0)
    idx = torch.clamp(t, 0.0, 1.0) * float(n - 1)
    return idx.to(torch.int32 if n > 256 else torch.uint8)


class FrameSource:
    """Runs the simulation and yields palette-indexed frames (uint8, or
    int32 above 256 colours) as host arrays.

    Supports live control (web frontend): pause/resume, parameter changes
    (feed/kill/dt rebuild the simulation — the kernels take the parameters
    by value, so the kernel library is neither rebuilt nor reloaded — while
    the concentration state carries over), and reset."""

    def __init__(self, args):
        self.args = args
        self.sim = shared.make_simulation(args)
        self.species = self.sim.make_species(shared.domain_shape(args))
        # steps per frame default 1 (livesim/src/main.rs:77)
        self.steps_per_frame = (
            args.nbextrastep if args.nbextrastep is not None else 1
        )
        self.lut = inferno_lut(getattr(args, "color_palette_resolution", 256))
        self.paused = False
        self._last_rgb: np.ndarray | None = None
        self._last_idx: np.ndarray | None = None
        # in-flight frames, oldest first, each (copy event or None, host
        # frame) (the reference's swapchain frames-in-flight analog,
        # livesim/src/frames.rs:21-175)
        self.frames_in_flight = max(
            1, int(getattr(args, "frames_in_flight", 3)))
        self._pending: deque = deque()
        self.device = self.sim.device
        self._copy = (torch.cuda.Stream(self.device)
                      if self.device.type == "cuda" else None)

    def _dispatch_frame(self):
        """Advance the simulation and start the copy of the new state's
        palette indices: returns (event, pinned host frame) on the card,
        whose copy runs on the source's copy stream while the host
        colorizes/encodes the PREVIOUS frame; (None, host frame) on the
        CPU."""
        self.sim.prepare_steps(self.species, self.steps_per_frame)
        # on the launch stream, before the next frame's steps overwrite the
        # state that result() views
        idx = self._to_index(self.species.result())
        if self._copy is None:
            return None, idx.numpy()
        launch = torch.cuda.current_stream(self.device)
        frame = torch.empty(idx.shape, dtype=idx.dtype, pin_memory=True)
        indexed = torch.cuda.Event()
        indexed.record(launch)
        self._copy.wait_event(indexed)
        with torch.cuda.stream(self._copy):
            frame.copy_(idx, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(self._copy)
        # the allocator may hand idx's memory to the next frame only once
        # the copy stream has read it
        idx.record_stream(self._copy)
        return copied, frame.numpy()

    @staticmethod
    def _arrived(pending) -> np.ndarray:
        """The host frame of an in-flight pair, once its copy is done."""
        copied, frame = pending
        if copied is not None:
            copied.synchronize()
        return frame

    def _to_index(self, v: torch.Tensor) -> torch.Tensor:
        return palette_index(v, len(self.lut))

    def next_idx(self) -> np.ndarray:
        """K-deep frame pipeline (the analog of the reference's
        swapchain frames-in-flight, livesim/src/frames.rs:21-175):
        frames N+1..N+K's steps and device->host copies are enqueued
        before frame N is consumed, so the copies overlap the host's
        encoding/serving of frame N. Returns the PALETTE-INDEX array — the
        cheapest per-pixel representation (1 B/px at <= 256 colors): the
        canvas web view ships these bytes straight to the browser and
        colorizes there (the browser as the reference's palette sampler,
        livesim/src/palette.rs:42-121)."""
        return self.next_idx_bounded(1 << 30)

    def next_idx_bounded(self, remaining: int) -> np.ndarray:
        """next_idx with a hard frame-step budget: the pipeline never
        holds more in-flight frames than outputs still to be shown, so
        N bounded calls dispatch EXACTLY N frame-steps in total and the
        final in-flight frames all get rendered (headless accounting —
        N outputs must cost N frame-steps, not N + depth - 1)."""
        while len(self._pending) < min(self.frames_in_flight,
                                       max(1, remaining)):
            self._pending.append(self._dispatch_frame())
        idx = self._arrived(self._pending.popleft())
        self._last_idx = idx
        return idx

    def next_rgb(self) -> np.ndarray:
        self._last_rgb = self.lut[self.next_idx()]
        return self._last_rgb

    def _current_idx(self) -> np.ndarray:
        """Palette indices of the CURRENT state, zero simulation steps."""
        return self._to_index(self.species.result()).cpu().numpy()

    def frame_idx(self) -> np.ndarray:
        """Next palette-index frame: advances unless paused.

        Paused with nothing rendered yet (pause before the first frame,
        or right after reset): show the oldest in-flight frame — or the
        current state — WITHOUT dispatching new frame-steps; next_idx()
        would advance the nominally-paused simulation (ADVICE r2). The
        rest of the in-flight queue is kept for resume."""
        if self.paused:
            if self._last_idx is None:
                if self._pending:
                    self._last_idx = self._arrived(self._pending.popleft())
                else:
                    self._last_idx = self._current_idx()
            return self._last_idx
        return self.next_idx()

    def frame(self) -> np.ndarray:
        """Next RGB frame to display: advances unless paused."""
        if self.paused and self._last_rgb is not None:
            return self._last_rgb
        self._last_rgb = self.lut[self.frame_idx()]
        return self._last_rgb

    # -- live controls -------------------------------------------------------

    def state(self) -> dict:
        p = self.sim.params
        return {
            "feedrate": float(p.feed_rate),
            "killrate": float(p.kill_rate),
            "deltat": float(p.time_step),
            "steps_per_frame": int(self.steps_per_frame),
            "paused": bool(self.paused),
            "backend": self.sim.name,
            "rows": int(self.species.shape[0]),
            "cols": int(self.species.shape[1]),
            "palette_n": int(len(self.lut)),
        }

    def set_params(self, feedrate=None, killrate=None, deltat=None,
                   steps_per_frame=None) -> None:
        """Apply new knob values; physics changes preserve the U/V state."""
        # parse EVERY value before applying ANY: a bad later value must
        # not leave args half-mutated with the sim not rebuilt (the next
        # unrelated /set would silently apply the rejected change)
        spf = None if steps_per_frame is None else max(1, int(steps_per_frame))
        updates = {}
        for attr, val in (("feedrate", feedrate), ("killrate", killrate),
                          ("deltat", deltat)):
            if val is not None:
                fval = float(val)
                if fval != getattr(self.args, attr, None):
                    updates[attr] = fval
        if spf is not None:
            self.steps_per_frame = spf
        changed = bool(updates)
        for attr, fval in updates.items():
            setattr(self.args, attr, fval)
        if changed:
            self._pending.clear()  # old-physics frames: don't show them
            u, v = self.species.uv_host()
            steps_done = self.species.steps_performed
            self.sim = shared.make_simulation(self.args)
            # carry the current state straight into the new sim's storage
            # (make_species would build a fresh init box only to discard it)
            self.species = Species(u.shape, self.sim.build_storage(u, v),
                                   self.sim)
            self.species.steps_performed = steps_done

    def reset(self) -> None:
        self.species = self.sim.make_species(shared.domain_shape(self.args))
        self._last_rgb = None
        self._last_idx = None
        self._pending.clear()


def run_headless(src: FrameSource, frames: int, outdir: str) -> int:
    from .. import native

    os.makedirs(outdir, exist_ok=True)
    width = max(len(str(max(frames - 1, 1))), 1)
    for i in range(frames):
        # the bounded pipeline drains itself: the last `depth` outputs
        # come straight from the in-flight queue, so N outputs dispatch
        # exactly N frame-steps (ADVICE r2) at any pipeline depth
        rgb = src.lut[src.next_idx_bounded(frames - i)]
        src._last_rgb = rgb
        path = os.path.join(outdir, f"{i:0{width}d}.png")
        with open(path, "wb") as f:
            f.write(native.png_encode(rgb))
    return 0


_WEB_PAGE = """<!doctype html>
<html><head><title>Gray-Scott livesim</title><style>
 body{background:#111;color:#ddd;margin:0;font:14px sans-serif}
 #bar{display:flex;gap:1.2em;align-items:center;padding:.5em .8em;
      background:#1c1c1c;flex-wrap:wrap}
 label{display:flex;gap:.4em;align-items:center}
 input[type=range]{width:9em} button{min-width:5em}
 img,canvas{width:100%;image-rendering:pixelated;display:block}
</style></head><body>
<div id="bar">
 <button id="pause">Pause</button>
 <button id="reset">Reset</button>
 <label>feed <input id="feedrate" type="range" min="0.001" max="0.12"
   step="0.001"><span id="feedrate_v"></span></label>
 <label>kill <input id="killrate" type="range" min="0.01" max="0.12"
   step="0.001"><span id="killrate_v"></span></label>
 <label>dt <input id="deltat" type="range" min="0.1" max="2.0"
   step="0.1"><span id="deltat_v"></span></label>
 <label>steps/frame <input id="steps_per_frame" type="number" min="1"
   max="1024" style="width:4.5em"></label>
 <span id="backend"></span>
 <span id="fps"></span>
</div>
<canvas id="view"></canvas>
<script>
const knobs=["feedrate","killrate","deltat","steps_per_frame"];
function show(k,v){const s=document.getElementById(k+"_v");
  if(s)s.textContent=(+v).toFixed(3).replace(/0+$/,"").replace(/\\.$/,"");}
function setPaused(p){document.getElementById("pause").textContent=
  p?"Resume":"Pause";}
for(const k of knobs){const e=document.getElementById(k);
  e.addEventListener("input",()=>show(k,e.value));
  e.addEventListener("change",()=>fetch("/set?"+k+"="+e.value));}
document.getElementById("pause").onclick=()=>
  fetch("/toggle").then(r=>r.json()).then(s=>setPaused(s.paused));
document.getElementById("reset").onclick=()=>fetch("/reset");
// Client-side colorization: the server streams raw PALETTE INDICES
// (1 B/px) and the browser applies the LUT into a canvas — the
// browser is the reference's palette sampler (livesim/src/palette.rs:
// 42-121). Halves host work vs MJPEG (no JPEG encode, no RGB
// expansion) and pipelines the next fetch behind the paint.
async function start(){
  const s=await (await fetch("/state")).json();
  for(const k of knobs){const e=document.getElementById(k);
    e.value=s[k];show(k,s[k]);}
  document.getElementById("backend").textContent="backend: "+s.backend;
  setPaused(s.paused);
  const cv=document.getElementById("view");
  if(s.palette_n>256){ // int32 indices: fall back to the MJPEG stream
    const img=document.createElement("img");img.src="/stream";
    cv.replaceWith(img);return;}
  const pal=new Uint8Array(await (await fetch("/palette.bin")).arrayBuffer());
  cv.width=s.cols;cv.height=s.rows;
  const ctx=cv.getContext("2d");
  const img=ctx.createImageData(s.cols,s.rows);
  const d=img.data;d.fill(255);
  let frames=0,t0=performance.now();
  let inflight=fetch("/frame.bin");
  async function loop(){
    const buf=new Uint8Array(await (await inflight).arrayBuffer());
    inflight=fetch("/frame.bin");   // next frame rides the paint
    for(let i=0,j=0;i<buf.length;i++,j+=4){const p=buf[i]*3;
      d[j]=pal[p];d[j+1]=pal[p+1];d[j+2]=pal[p+2];}
    ctx.putImageData(img,0,0);
    if(++frames%30==0){const t=performance.now();
      document.getElementById("fps").textContent=
        (30000/(t-t0)).toFixed(1)+" fps";t0=t;}
    requestAnimationFrame(loop);
  }
  loop();
}
start();
</script></body></html>"""

def make_server(src: FrameSource, port: int, fps_cap: float):
    """The web view's HTTP server on 127.0.0.1:``port``, not yet serving
    (:func:`serve`): the page, ``/state``, ``/toggle``, ``/reset``,
    ``/set``, ``/palette.bin``, ``/frame.bin`` (paced by ``fps_cap``) and
    ``/stream``."""
    import json
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import parse_qsl, urlparse

    boundary = b"grayscottframe"
    min_dt = 1.0 / max(fps_cap, 1e-3)
    lock = threading.Lock()  # one simulation, many viewers
    pace = {"next_t": 0.0}  # fps-cap pacing for the /frame.bin pull path

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _json(self, obj):
            body = json.dumps(obj).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/":
                body = _WEB_PAGE.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if url.path == "/state":
                with lock:
                    self._json(src.state())
                return
            if url.path == "/toggle":
                with lock:
                    src.paused = not src.paused
                    self._json(src.state())
                return
            if url.path == "/reset":
                with lock:
                    src.reset()
                    self._json(src.state())
                return
            if url.path == "/set":
                try:
                    kw = dict(parse_qsl(url.query))
                    with lock:
                        src.set_params(**{
                            k: v for k, v in kw.items()
                            if k in ("feedrate", "killrate", "deltat",
                                     "steps_per_frame")
                        })
                        self._json(src.state())
                except (TypeError, ValueError) as e:
                    self.send_error(400, str(e))
                return
            if url.path == "/palette.bin":
                body = np.ascontiguousarray(src.lut).tobytes()
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if url.path == "/frame.bin":
                # one raw palette-index frame (uint8, row-major): the
                # canvas page colorizes client-side. Each GET advances
                # the simulation by one frame unless paused — so the
                # --fps-cap applies HERE too, or the client's
                # requestAnimationFrame rate (60-144 Hz) would drive the
                # simulation past the user's bound. Claim a pacing slot
                # under the lock but SLEEP outside it: the slider/toggle/
                # stream handlers share the lock and must not stall for
                # up to 1/fps_cap per paced request.
                with lock:
                    now = time.time()
                    wait = pace["next_t"] - now
                    pace["next_t"] = max(now, pace["next_t"]) + min_dt
                if wait > 0:
                    # the FULL assigned wait: truncating to one interval
                    # would let N concurrent clients drive the sim at
                    # ~N x fps_cap (each slot is min_dt apart)
                    time.sleep(wait)
                with lock:
                    idx = src.frame_idx()
                body = np.ascontiguousarray(idx).tobytes()
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)
                return
            if url.path != "/stream":
                self.send_error(404)
                return
            try:
                from PIL import Image
            except ImportError:
                # the JPEG encoder is PIL's; say so rather than serve
                # something else under this path
                self.send_error(501, "/stream needs PIL (the MJPEG "
                                "encoder), which is not installed; the "
                                "page's canvas view (/frame.bin) needs "
                                "none at up to 256 palette colours")
                return
            self.send_response(200)
            self.send_header(
                "Content-Type",
                f"multipart/x-mixed-replace; boundary={boundary.decode()}",
            )
            self.end_headers()
            try:
                while True:
                    t0 = time.time()
                    with lock:
                        rgb = src.frame()
                    buf = io.BytesIO()
                    Image.fromarray(rgb, "RGB").save(buf, "JPEG", quality=85)
                    data = buf.getvalue()
                    self.wfile.write(b"--" + boundary + b"\r\n")
                    self.wfile.write(b"Content-Type: image/jpeg\r\n")
                    self.wfile.write(
                        f"Content-Length: {len(data)}\r\n\r\n".encode()
                    )
                    self.wfile.write(data)
                    self.wfile.write(b"\r\n")
                    dt = time.time() - t0
                    if dt < min_dt:
                        time.sleep(min_dt - dt)
            except (BrokenPipeError, ConnectionResetError):
                return

    return ThreadingHTTPServer(("127.0.0.1", port), Handler)


def serve(server, logger) -> int:
    """Serve ``server`` (:func:`make_server`) until ``server.shutdown()``
    or Ctrl-C, then close its socket."""
    port = server.server_address[1]
    logger.info("livesim web view at http://127.0.0.1:%d/", port)
    print(f"Serving live view at http://127.0.0.1:{port}/ (Ctrl-C to stop)",
          file=sys.stderr)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return 0


def run_web(src: FrameSource, port: int, fps_cap: float, logger) -> int:
    return serve(make_server(src, port, fps_cap), logger)


def run_window(src: FrameSource, fps_cap: float) -> int:
    import matplotlib

    matplotlib.use("TkAgg" if os.environ.get("DISPLAY") else "Agg")
    import matplotlib.pyplot as plt

    rows, cols = src.species.shape
    fig, ax = plt.subplots(figsize=(cols / 100, rows / 100), dpi=100)
    fig.canvas.manager.set_window_title("Gray-Scott reaction")
    ax.set_position((0, 0, 1, 1))
    ax.axis("off")
    im = ax.imshow(src.next_rgb())
    plt.show(block=False)
    min_dt = 1.0 / max(fps_cap, 1e-3)
    while plt.fignum_exists(fig.number):
        t0 = time.time()
        im.set_data(src.next_rgb())
        fig.canvas.draw_idle()
        fig.canvas.flush_events()
        dt = time.time() - t0
        if dt < min_dt:
            time.sleep(min_dt - dt)
    return 0


def main(argv=None) -> int:
    logger = init_logging()
    apply_env_config()
    args = build_parser().parse_args(argv)
    src = FrameSource(args)
    logger.info(
        "livesim backend=%s device=%s domain=%dx%d steps/frame=%d",
        src.sim.name, src.device, args.nbrow, args.nbcol,
        src.steps_per_frame,
    )
    if args.frames:
        if not args.output_dir:
            print("--frames requires --output-dir", file=sys.stderr)
            return 2
        return run_headless(src, args.frames, args.output_dir)
    if args.web:
        return run_web(src, args.port, args.fps_cap, logger)
    if not os.environ.get("DISPLAY"):
        logger.info("no DISPLAY; falling back to --web mode")
        return run_web(src, args.port, args.fps_cap, logger)
    return run_window(src, args.fps_cap)


if __name__ == "__main__":
    sys.exit(main())
