"""HDF5 -> PNG converter CLI: the port's
``grayscott_tpu/cli/data_to_pics.py``.

Argument-compatible with the reference's ``data-to-pics``
(``data-to-pics/src/main.rs:16-56``): ``-i/--input`` (default ``output.h5``),
``-o/--output-dir``, ``--input-buffer`` / ``--output-buffer`` (default 2)
and ``--output-threads`` (default 3). Filenames are zero-padded to
``ilog10(num_images) + 1`` digits (``main.rs:97-104``), pixels are
``INFERNO.eval_continuous(2.0 * v)`` (``main.rs:139-142``).

Same 3-stage pipeline as the reference: a reader thread streams HDF5
images, the main thread colorizes (threaded native C++ kernel with a
vectorized NumPy LUT fallback — the rayon row-split analog, see
grayscott_tpu_torch/native), and N writer threads encode PNGs natively
(C++ zlib encoder releasing the GIL, the `image`-crate-writer analog;
without a toolchain the plain Python encoder, which writes the same bytes,
where JAX's falls back to PIL).

The tool runs on the host alone and touches no device, as JAX's does. It
needs h5py (imported where the file is opened), and ``--gif`` needs PIL
(imported inside :func:`write_gif`).
"""

from __future__ import annotations

import argparse
import math
import os
import queue
import sys
import threading

import numpy as np

from ..io.hdf5 import Reader
from ..utils.logs import init_logging
from ..utils.palette import colorize
from ..utils.progress import ProgressBar
from .shared import bounded_put, simulation_output_path


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="data-to-pics",
        description="Convert Gray-Scott simulation output to images",
    )
    parser.add_argument("-i", "--input", default=None, help="Path to the input HDF5 file")
    parser.add_argument(
        "--input-buffer", type=int, default=2,
        help="Image buffer size between HDF5 I/O and conversion",
    )
    parser.add_argument(
        "-o", "--output-dir", required=True,
        help="Directory where output images will be saved",
    )
    parser.add_argument(
        "--output-buffer", type=int, default=2,
        help="Image buffer size between conversion and image I/O",
    )
    parser.add_argument(
        "--output-threads", type=int, default=3, help="Number of image I/O threads"
    )
    parser.add_argument(
        "--png-level", type=int, default=None, metavar="1-9",
        help="PNG compression: 1-3 = fast RLE strategy (default; the "
        "reference's image-crate writer uses the equivalent fdeflate "
        "fast path), 4-9 = standard deflate for smaller archival files",
    )
    parser.add_argument(
        "--gif", default=None, metavar="PATH",
        help="Additionally assemble an animated GIF of all frames "
        "(256-color INFERNO palette, nearest-index sampling: colors "
        "match the PNGs within one LUT step). The reference leaves "
        "movie assembly to external tools; this covers the common "
        "small-clip case with no extra dependencies.",
    )
    parser.add_argument(
        "--gif-fps", type=float, default=25.0,
        help="GIF playback rate in frames/second (default 25)",
    )
    return parser


def write_gif(path: str, h5path: str, fps: float) -> int:
    """Stream every frame of ``h5path`` into an animated GIF.

    Frames are 8-bit palette indices under the same INFERNO LUT and
    amplitude scale as the PNG path (``eval_continuous(2.0 * v)``,
    data-to-pics/src/main.rs:139-142), sampled nearest-index (within one
    LUT step of the PNGs' interpolated colors — GIF's 256-color model).
    Frames flow through a generator, so memory stays bounded at one
    frame regardless of clip length; this is a deliberate second pass
    over the file — GIF frames must arrive in order, while the PNG
    pipeline's writer pool completes out of order. Returns the number of
    frames written."""
    from PIL import Image

    from ..utils.palette import AMPLITUDE_SCALE, inferno_lut

    reader = Reader(h5path)
    lut = inferno_lut()
    count = [0]

    def frames():
        while True:
            img = reader.read()
            if img is None:
                return
            t = np.nan_to_num(
                np.clip(img * np.float32(AMPLITUDE_SCALE), 0.0, 1.0),
                nan=0.0, copy=False,
            )
            idx = (t * np.float32(len(lut) - 1)).round().astype(np.uint8)
            im = Image.fromarray(idx, "P")
            im.putpalette(lut.tobytes())
            count[0] += 1
            yield im

    try:
        gen = frames()
        try:
            first = next(gen)
        except StopIteration:
            # a zero-frame file would otherwise leak a bare StopIteration
            # out of this function after the PNG pass already succeeded
            raise ValueError(
                f"no frames in {h5path}; nothing to write to {path}"
            ) from None
        first.save(
            path, save_all=True, append_images=gen,
            duration=max(int(round(1000.0 / max(fps, 1e-3))), 1), loop=0,
        )
    finally:
        reader.close()
    return count[0]


def main(argv=None) -> int:
    logger = init_logging()
    from ..utils.runtime import apply_env_config

    apply_env_config()
    args = build_parser().parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)

    from .. import native

    png_level = args.png_level if args.png_level is not None \
        else native.PNG_LEVEL_DEFAULT
    if not 1 <= png_level <= 9:
        raise SystemExit(f"--png-level must be in 1-9, got {png_level}")

    reader = Reader(simulation_output_path(args.input))
    num_images = reader.num_images
    # Leading zeros to help Unix number sort (main.rs:97)
    width = int(math.log10(max(num_images, 1))) + 1
    progress = ProgressBar("Generating image", num_images)

    n_writers = max(args.output_threads, 1)
    in_q: queue.Queue = queue.Queue(maxsize=max(args.input_buffer, 1))
    out_q: queue.Queue = queue.Queue(maxsize=max(args.output_buffer, 1))
    # buffer-recycling return channels (the reference recycles snapshot
    # and image buffers the same way, data-to-pics/src/main.rs:80-110):
    # float input frames flow reader -> colorize -> back to the reader;
    # RGB frames flow colorize -> PNG writer -> back to colorize. Buffer
    # count is bounded by queue depth + pipeline stages in flight.
    in_free: queue.Queue = queue.Queue()
    rgb_free: queue.Queue = queue.Queue()
    errors: list[BaseException] = []

    def recycled(free_q: queue.Queue):
        try:
            return free_q.get_nowait()
        except queue.Empty:
            return None

    def read_thread() -> None:
        try:
            while True:
                img = reader.read(out=recycled(in_free))
                if img is None:
                    break
                in_q.put(img)
        except BaseException as e:  # pragma: no cover
            errors.append(e)
        finally:
            in_q.put(None)

    def write_thread() -> None:
        try:
            while True:
                item = out_q.get()
                if item is None:
                    return
                idx, rgb = item
                path = os.path.join(args.output_dir, f"{idx:0{width}d}.png")
                data = native.png_encode(rgb, level=png_level)
                with open(path, "wb") as f:
                    f.write(data)
                rgb_free.put(rgb)
                progress.inc(1)
        except BaseException as e:  # pragma: no cover
            errors.append(e)

    threading.Thread(target=read_thread, daemon=True).start()
    writers = [
        threading.Thread(target=write_thread, daemon=True)
        for _ in range(max(args.output_threads, 1))
    ]
    for t in writers:
        t.start()

    def put_checked(item) -> bool:
        # dead consumers = every PNG writer thread exited (shared.bounded_put)
        return bounded_put(
            out_q, item, lambda: not any(t.is_alive() for t in writers))

    idx = 0
    while True:
        img = in_q.get()
        if img is None or errors:
            break
        rgb = colorize(img, out=recycled(rgb_free))
        in_free.put(img)  # colorize consumed it; back to the reader
        if not put_checked((idx, rgb)):
            break
        idx += 1
    for _ in writers:
        put_checked(None)
    for t in writers:
        t.join()
    progress.finish()
    reader.close()
    if errors:
        raise errors[0]
    logger.info("wrote %d images to %s", idx, args.output_dir)
    if args.gif:
        n = write_gif(args.gif, simulation_output_path(args.input),
                      args.gif_fps)
        logger.info("wrote %d-frame GIF to %s", n, args.gif)
    return 0


if __name__ == "__main__":
    sys.exit(main())
