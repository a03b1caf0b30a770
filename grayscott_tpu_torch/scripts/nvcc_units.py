"""How long nvcc takes for the port's kernel libraries, unit by unit.

``ops/build.py`` compiles every unit of a library at once, one ``nvcc``
each, so a library's build lasts as long as its slowest unit while the
host's cores share the work. This script repeats those compilations (the
same flags, into a temporary directory; the build store is not touched)
and times each unit and the whole:

- ``kernels``: the library that every run builds (``build.KERNELS``);
- ``splits``: the redesigns' ablation units (``build.SPLITS``), built on a
  split's first call;
- ``both``: every unit of both libraries at once, as one library would
  build them.

    python -m grayscott_tpu_torch.scripts.nvcc_units            # all three
    python -m grayscott_tpu_torch.scripts.nvcc_units kernels

Prints one ``nvcc <set> <unit>: <s> s`` line per unit, slowest first, and
one ``nvcc <set>: <n> units at once, <s> s wall, <cores> cores`` line per
set. Needs ``nvcc`` (the CUDA toolkit); no card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from ..ops import build

SETS = {"kernels": (build.KERNELS,), "splits": (build.SPLITS,),
        "both": (build.KERNELS, build.SPLITS)}


def _compile(src: Path, out: str) -> tuple[str, float, int]:
    t0 = time.perf_counter()
    proc = subprocess.run(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-c", "-o",
         os.path.join(out, f"{src.parent.name}_{src.stem}.o"), str(src)],
        capture_output=True, text=True, timeout=build.BUILD_TIMEOUT)
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout + proc.stderr)
    return src.name, time.perf_counter() - t0, proc.returncode


def time_set(name: str) -> int:
    """Compile the units of set ``name`` at once and print their times;
    the number of units that failed."""
    srcs = [src for library in SETS[name] for src in build.sources(library)]
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(srcs)) as pool:
            rows = list(pool.map(lambda src: _compile(src, out), srcs))
        wall = time.perf_counter() - t0
    for unit, seconds, rc in sorted(rows, key=lambda row: -row[1]):
        print(f"nvcc {name} {unit}: {seconds!r} s (rc {rc})")
    print(f"nvcc {name}: {len(srcs)} units at once, {wall!r} s wall, "
          f"{os.cpu_count()} cores", flush=True)
    return sum(rc != 0 for _, _, rc in rows)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="nvcc_units", description=__doc__.split("\n")[0])
    parser.add_argument("sets", nargs="*", choices=list(SETS),
                        help="which sets to time (default: all three, "
                        "one after the other)")
    args = parser.parse_args(argv)
    failed = sum(time_set(name) for name in args.sets or SETS)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
