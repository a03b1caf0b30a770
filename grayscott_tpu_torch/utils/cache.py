"""The autotune store: the port's ``grayscott_tpu/utils/cache.py``, without
the XLA compilation cache (the kernels build into ``build/kernels/``,
``ops/build.py``).

Autotune records (the winning engine and layout per device, domain,
boundary, stencil and dtype) persist as JSON in ``autotune.json`` under
:func:`cache_dir`, written with an atomic rename. :func:`cache_dir` reads
``GRAYSCOTT_CACHE_DIR`` at every call (default
``~/.cache/grayscott_tpu_torch``), so a test or a script can point the
store elsewhere after the import.
"""

from __future__ import annotations

import json
import os
import tempfile


def cache_dir() -> str:
    """``GRAYSCOTT_CACHE_DIR``, else ``~/.cache/grayscott_tpu_torch``."""
    return os.environ.get(
        "GRAYSCOTT_CACHE_DIR",
        os.path.join(os.path.expanduser("~"), ".cache",
                     "grayscott_tpu_torch"))


def autotune_path() -> str:
    return os.path.join(cache_dir(), "autotune.json")


def load_autotune() -> dict:
    """The store's records by key; empty when there is no readable store."""
    try:
        with open(autotune_path()) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def save_autotune(entries: dict) -> None:
    """Replace the store with ``entries``: a temporary file in the same
    directory, renamed over the store, so a reader never sees half."""
    directory = cache_dir()
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(entries, f, indent=1)
        os.replace(tmp, autotune_path())
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def autotune_key(platform: str, shape, boundary: str, stencil: str,
                 kernel_version: int = 1, dtype: str = "float32") -> str:
    """The key of one tuning configuration, in the JAX format:
    ``v{kernel_version}:{platform}:{R}x{C}:{boundary}:{stencil}``, with
    ``:{dtype}`` appended for any dtype but float32. ``platform`` is
    ``utils.device.autotune_platform()``: the card's name and SM count, so
    a verdict measured on one card never pins another."""
    key = (
        f"v{kernel_version}:{platform}:{shape[0]}x{shape[1]}:"
        f"{boundary}:{stencil}"
    )
    if dtype not in ("float32", "f32", None):
        key += f":{dtype}"
    return key
