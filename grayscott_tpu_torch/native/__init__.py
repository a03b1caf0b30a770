"""Native (C++) host-pipeline components, loaded via ctypes: the port's
``grayscott_tpu/native/__init__.py``, with the colorizer and the PNG
encoder only.

``colorize.cpp`` is JAX's, verbatim: the threaded colorizer (the
reference's rayon row split, data-to-pics/src/main.rs:126-144), the Sub
filter + zlib PNG encoder (Z_RLE at levels 1-3) and
``gs_native_abi_version``. g++ builds it on first use (``g++ -O3 -shared
-fPIC -std=c++17 -pthread ... -lz``) into the build store
(``utils/cache.py:build_dir("native")``), never beside the source, under a
name that hashes the source and the flags.

Without g++ or zlib's header the port falls back, as JAX's does, but to
code of its own: :mod:`utils.palette`'s NumPy colorizer, and
:func:`png_encode_plain`, the same Sub filter in NumPy and the same zlib
stream through Python's ``zlib`` module (the card's machine has no PIL).
Both encoders write the same bytes. Which one runs is logged once
(:func:`encoder`). JAX's ``refstep.cpp`` is not ported: the port's tests
hold the port to JAX's NumPy oracle itself (ROADMAP.md Queue 1 item 10).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import struct
import subprocess
import threading
import zlib
from pathlib import Path

import numpy as np

from ..utils import cache

SOURCE = Path(__file__).resolve().parent / "colorize.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

#: the library's ABI version (``gs_native_abi_version`` in colorize.cpp)
ABI_VERSION = 4

_lock = threading.Lock()
_lib = None
_tried = False
_png_scratch = threading.local()


def library_path() -> Path:
    """The library's path in the build store, read at every call."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update("\0".join(GXX_FLAGS).encode())
    return cache.build_dir("native") / \
        f"libgs_native-{digest.hexdigest()[:16]}.so"


def gxx_version() -> str:
    """The first line of ``g++ --version``, or why there is none."""
    if shutil.which("g++") is None:
        return "g++ not found"
    try:
        out = subprocess.run(["g++", "--version"], capture_output=True,
                             text=True, check=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"g++ --version failed ({e})"
    return out.splitlines()[0].strip() if out else "?"


def build() -> Path | None:
    """Compile the library unless this source's one exists; None when g++
    (or zlib's header) is missing or the compile fails."""
    path = library_path()
    if path.exists():
        return path
    # compile to a private name, then rename: a reader never sees half a
    # file, and the fresh inode makes a later CDLL load the new image
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp),
                        "-lz"], check=True, capture_output=True,
                       timeout=120)
        os.replace(tmp, path)
    except (OSError, subprocess.SubprocessError):
        return None
    finally:
        tmp.unlink(missing_ok=True)
    return path


def _bind(path: Path):
    """CDLL + symbol binding; raises on an incompatible library."""
    lib = ctypes.CDLL(str(path))
    lib.gs_native_abi_version.restype = ctypes.c_int
    if lib.gs_native_abi_version() != ABI_VERSION:
        raise OSError("gs_native ABI version mismatch")
    lib.gs_colorize.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_float,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
    ]
    lib.gs_colorize.restype = None
    lib.gs_png_bound.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.gs_png_bound.restype = ctypes.c_size_t
    lib.gs_png_encode.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
    ]
    lib.gs_png_encode.restype = ctypes.c_size_t
    return lib


def load():
    """The native library handle, building it on first use (once per
    process); None if unavailable (callers fall back to NumPy and to
    :func:`png_encode_plain`)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = build()
        if path is not None:
            try:
                _lib = _bind(path)
            except (OSError, AttributeError):
                _lib = None
        logging.getLogger("grayscott_tpu_torch").info(
            "PNG encoder and colorizer: %s", encoder())
        return _lib


def encoder() -> str:
    """Which PNG encoder and colorizer run: the native library's, or the
    plain Python and NumPy ones (and why)."""
    if _lib is not None:
        return f"native ({library_path().name}, {gxx_version()})"
    return f"python (zlib {zlib.ZLIB_RUNTIME_VERSION}; no native library: " \
        f"{gxx_version()})"


#: Default PNG compression: the fast Z_RLE path (levels <= 3 in the C++
#: encoder) — the analog of the fdeflate fast encoder behind the
#: reference's `image`-crate PNG writer (data-to-pics/src/main.rs:98-104).
#: On smooth INFERNO fields it is ~5x faster than deflate level 6 and
#: smaller than plain level 1/2 output. Pass 4-9 for archival deflate.
PNG_LEVEL_DEFAULT = 2

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _rgb8(rgb: np.ndarray) -> np.ndarray:
    img = np.ascontiguousarray(rgb, dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {img.shape}")
    return img


def png_encode(rgb: np.ndarray, level: int = PNG_LEVEL_DEFAULT) -> bytes:
    """Encode an (H, W, 3) uint8 image as a PNG byte stream (zlib + Sub
    row filter, the analog of the reference's `image` crate writer on its
    output threads, data-to-pics/src/main.rs:98-104). ``level``: 1-3 =
    fast RLE strategy (the default, see PNG_LEVEL_DEFAULT), 4-9 = standard
    deflate at that level. The native encoder releases the GIL for the
    whole encode, so the data-to-pics output threads scale; without it,
    :func:`png_encode_plain` writes the same bytes."""
    img = _rgb8(rgb)
    lib = load()
    if lib is None:
        return png_encode_plain(img, level)
    h, w = img.shape[:2]
    cap = int(lib.gs_png_bound(w, h))
    # recycled per-thread scratch (the encoder runs on N writer threads)
    out = getattr(_png_scratch, "buf", None)
    if out is None or out.size < cap:
        out = np.empty(cap, dtype=np.uint8)
        _png_scratch.buf = out
    n = lib.gs_png_encode(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int(w), ctypes.c_int(h), ctypes.c_int(level),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_size_t(cap),
    )
    if n == 0:  # beyond zlib's one-call limit: Python's zlib streams it
        return png_encode_plain(img, level)
    return out[:n].tobytes()


def _chunk(tag: bytes, data: bytes) -> bytes:
    """One PNG chunk: length, type, payload, and the CRC of type and
    payload (PNG spec 5.3)."""
    return struct.pack(">I", len(data)) + tag + data + \
        struct.pack(">I", zlib.crc32(tag + data))


def png_encode_plain(rgb: np.ndarray,
                     level: int = PNG_LEVEL_DEFAULT) -> bytes:
    """:func:`png_encode` in plain Python: colorize.cpp's ``gs_png_encode``
    step by step (the Sub filter on every row, one zlib stream with the
    same window, memory level and strategy, the IHDR, IDAT and IEND
    chunks), so the bytes are the native encoder's."""
    img = _rgb8(rgb)
    h, w = img.shape[:2]
    rows = img.reshape(h, 3 * w)
    filtered = np.empty((h, 3 * w + 1), dtype=np.uint8)
    filtered[:, 0] = 1  # Sub filter
    filtered[:, 1:4] = rows[:, :3]
    np.subtract(rows[:, 3:], rows[:, :-3], out=filtered[:, 4:])
    z = zlib.compressobj(level, zlib.DEFLATED, 15, 8,
                         zlib.Z_RLE if level <= 3 else zlib.Z_DEFAULT_STRATEGY)
    idat = z.compress(filtered.tobytes()) + z.flush()
    # width, height, bit depth 8, truecolor RGB, deflate, filter method 0,
    # no interlace
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return _PNG_SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", idat) \
        + _chunk(b"IEND", b"")


def png_decode(data: bytes) -> np.ndarray:
    """The (H, W, 3) uint8 image of a PNG that :func:`png_encode` wrote
    (8-bit RGB, Sub filter on every row); raises ValueError on any other."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError("not a PNG stream")
    pos, ihdr, idat = 8, None, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(tag + body) != crc:
            raise ValueError(f"bad CRC in the {tag!r} chunk")
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        pos += 12 + length
    if ihdr is None or ihdr[2:] != (8, 2, 0, 0, 0):
        raise ValueError(f"not an 8-bit RGB PNG of this encoder: {ihdr}")
    w, h = ihdr[:2]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), dtype=np.uint8)
    raw = raw.reshape(h, 3 * w + 1)
    if not (raw[:, 0] == 1).all():
        raise ValueError("a row without the Sub filter")
    # Sub: each byte adds the byte one pixel to its left, modulo 256
    rows = raw[:, 1:].reshape(h, w, 3).astype(np.uint64)
    return (np.cumsum(rows, axis=1) % 256).astype(np.uint8)


def colorize(values: np.ndarray, lut: np.ndarray, scale: float,
             num_threads: int | None = None,
             out: np.ndarray | None = None) -> np.ndarray | None:
    """Native colorize; returns None if the library is unavailable.
    ``out``: optional recycled destination (shape + (3,), uint8,
    C-contiguous) — the buffer-recycling channel pattern of the
    reference's pipelines (data-to-pics/src/main.rs:80-110)."""
    lib = load()
    if lib is None:
        return None
    v = np.ascontiguousarray(values, dtype=np.float32)
    lut8 = np.ascontiguousarray(lut, dtype=np.uint8)
    if lut8.shape != (256, 3):
        raise ValueError(f"gs_colorize takes a (256, 3) table, got "
                         f"{lut8.shape}")
    if out is None or out.shape != v.shape + (3,) or out.dtype != np.uint8 \
            or not out.flags.c_contiguous:
        out = np.empty(v.shape + (3,), dtype=np.uint8)
    if num_threads is None:
        num_threads = min(os.cpu_count() or 1, 8)
    lib.gs_colorize(
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_size_t(v.size),
        lut8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_float(scale),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int(num_threads),
    )
    return out
