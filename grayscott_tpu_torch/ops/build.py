"""Build the port's CUDA kernels on first use, and load them with ctypes.

Every ``csrc/*.cu`` is compiled by its own ``nvcc``, all at once, and the
objects are linked into one shared library with a plain C interface (no
PyTorch headers, so a build takes seconds), written to the build store
(``utils/cache.py:build_dir``: ``$GRAYSCOTT_CACHE_DIR/kernels``, else
``build/kernels/`` beside the package, else, where that is not writable,
``~/.cache/grayscott_tpu_torch/kernels``) and named by a hash of the
sources, the headers they share (``csrc/*.cuh``) and the flags, so an
edit or a flag change builds anew and an unchanged tree reuses the
library. The pattern is that of
``grayscott_tpu/native/__init__.py``, without its fallback: a build or
load failure raises, since there is nothing else to run on a GPU.

``-fmad=false`` keeps every written float operation rounded once, as the
plain PyTorch step rounds it (the kernels' bitwise contract); ``-ftz`` is
left off so that denormals match PyTorch's IEEE kernels.

The redesigns' splits (``csrc/splits/*.cu``: each kernel with one part of
its design taken out, for timing what it costs) are a library of their
own, :data:`SPLITS`, built the same way on the first call of a split: no
main path runs them, so the library every run builds leaves them out.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import NamedTuple

from ..utils import cache

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xcompiler", "-fPIC",
    # registers, shared memory and spills of every kernel, into the log
    "-Xptxas", "-v",
)

#: seconds nvcc may take for the whole library
BUILD_TIMEOUT = 600


class Build(NamedTuple):
    path: Path
    seconds: float  # 0.0 when an existing library was reused
    log: str  # nvcc's and ptxas's report ("" when reused)


_lock = threading.Lock()
_libs: dict = {}


def nvcc_path() -> str:
    """``nvcc`` from ``$CUDA_HOME``, then ``PATH``, then the toolkit's
    default install prefix; raises ``FileNotFoundError`` when none has it."""
    candidates = []
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            candidates.append(Path(os.environ[var]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise FileNotFoundError(
        "nvcc not found (looked in $CUDA_HOME, $CUDA_PATH, PATH and the "
        "CUDA toolkit's default prefix); the CUDA kernels cannot be built")


#: the kernels every path runs (``csrc/*.cu``)
KERNELS = "kernels"
#: the splits' ablation parts (``csrc/splits/*.cu``)
SPLITS = "splits"


def sources(library: str = KERNELS) -> list[Path]:
    """The translation units of ``library``, one object each."""
    where = CSRC_DIR if library == KERNELS else CSRC_DIR / library
    return sorted(where.glob("*.cu"))


def library_path(library: str = KERNELS) -> Path:
    """``library``'s path in the build store, read at every call."""
    digest = hashlib.sha256()
    for src in sorted([*sources(library), *CSRC_DIR.glob("*.cuh")]):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update("\0".join(NVCC_FLAGS).encode())
    name = f"libgs_{library}-{digest.hexdigest()[:16]}.so"
    return cache.build_dir("kernels") / name


def _run(cmds: list[list[str]]) -> str:
    """Run the commands side by side; their joined output, or raise with
    the first that failed."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    try:
        outs = [p.communicate(timeout=BUILD_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed with exit code {p.returncode}:"
                               f"\n{' '.join(cmd)}\n{out}")
    return "".join(outs)


def build(library: str = KERNELS) -> Build:
    """Compile ``library`` unless this tree's one exists already."""
    path = library_path(library)
    if path.exists():
        return Build(path, 0.0, "")
    path.parent.mkdir(parents=True, exist_ok=True)
    # compile to private names, then rename: a reader never sees half a file
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    srcs = sources(library)
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in srcs]
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    try:
        log = _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                    for src, obj in zip(srcs, objs)])
        log += _run([[nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                      *(str(o) for o in objs)]])
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
    return Build(path, time.perf_counter() - t0, log)


def load(library: str = KERNELS) -> ctypes.CDLL:
    """``library``, built first if needed (once per process)."""
    with _lock:
        if library not in _libs:
            _libs[library] = ctypes.CDLL(str(build(library).path))
        return _libs[library]


def bind(name: str, argtypes: list,
         library: str = KERNELS) -> ctypes._CFuncPtr:
    """``library``'s C function ``name``, returning an int."""
    fn = getattr(load(library), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=16)
def fold_args(fc) -> tuple:
    """The constant arguments of a fold entry (K1's and K2's
    ``*_fold``): the ``params.FoldConstants`` as the C array of
    ``gs_fold_floats()`` floats that the entries take (read, never
    written), then its ``separable`` and ``dt_is_one`` flags; built once
    per constants."""
    floats = fc.kernel_floats()
    n = bind("gs_fold_floats", [])()
    if n != len(floats):
        raise RuntimeError(f"the fold entries take {n} constants; this "
                           f"wrapper passes {len(floats)}")
    return ((ctypes.c_float * n)(*floats), int(fc.separable),
            int(fc.dt_is_one))


def error_name(err: int) -> str:
    """CUDA's name for the error code a launch function returned."""
    fn = load().gs_cuda_error_string
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return fn(err).decode()
