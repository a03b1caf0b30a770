"""Build the port's CUDA kernels on first use, and load them with ctypes.

Every ``csrc/*.cu`` is compiled by its own ``nvcc``, all at once, and the
objects are linked into one shared library with a plain C interface (no
PyTorch headers, so a build takes seconds), written to ``build/kernels/``
beside the package and named by a hash of the sources, the headers they
share (``csrc/*.cuh``) and the flags, so an edit or a flag change builds
anew and an unchanged tree reuses the library. The pattern is that of
``grayscott_tpu/native/__init__.py``, without its fallback: a build or
load failure raises, since there is nothing else to run on a GPU.

``-fmad=false`` keeps every written float operation rounded once, as the
plain PyTorch step rounds it (the kernels' bitwise contract); ``-ftz`` is
left off so that denormals match PyTorch's IEEE kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import NamedTuple

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

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
_lib: ctypes.CDLL | None = None


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


def sources() -> list[Path]:
    """The translation units, one object each."""
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    digest = hashlib.sha256()
    for src in sorted([*sources(), *CSRC_DIR.glob("*.cuh")]):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update("\0".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libgs_kernels-{digest.hexdigest()[:16]}.so"


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


def build() -> Build:
    """Compile the library unless this tree's one exists already."""
    path = library_path()
    if path.exists():
        return Build(path, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to private names, then rename: a reader never sees half a file
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources()]
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    try:
        log = _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                    for src, obj in zip(sources(), objs)])
        log += _run([[nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                      *(str(o) for o in objs)]])
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
    return Build(path, time.perf_counter() - t0, log)


def load() -> ctypes.CDLL:
    """The kernel library, built first if needed (once per process)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build().path))
        return _lib


def bind(name: str, argtypes: list) -> ctypes._CFuncPtr:
    """The library's C function ``name``, returning an int."""
    fn = getattr(load(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def error_name(err: int) -> str:
    """CUDA's name for the error code a launch function returned."""
    fn = load().gs_cuda_error_string
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return fn(err).decode()
