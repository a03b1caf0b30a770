"""Compare the machine code of two trees' CUDA kernels, kernel by kernel.

Builds every ``csrc/*.cu`` and ``csrc/splits/*.cu`` of two source trees
with the library's flags
(``ops/build.py:NVCC_FLAGS``) into a cubin, one ``nvcc`` per source, all
at once, and reads each kernel's SASS (``cuobjdump -sass``) and ptxas's
report (registers, stack frame, spills). A kernel is the same in both
trees when its instructions are, addresses and encodings aside. What a
refactor of shared device code must show is that the kernels it was not
meant to change kept every instruction::

    python -m grayscott_tpu_torch.scripts.sass_diff OLD/csrc NEW/csrc \\
        --out build/sass_diff.json

Kernels are matched by their demangled names (``c++filt``, where it is
installed), with the namespaces given by ``--drop`` taken out, so a type
that moved between namespaces still matches, and a kernel that moved to
another source (a unit split in two) matches by its name alone. Needs
``nvcc`` and ``cuobjdump`` (the CUDA toolkit); exits 1 when either is
missing.
Prints one line a source and a summary; ``--out`` takes every kernel's
row as JSON.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from ..ops.build import NVCC_FLAGS, nvcc_path

ENTRY = re.compile(r"Compiling entry function '([^']+)'")
USED = re.compile(r"Used (\d+) registers")
FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                   r"(\d+) bytes spill loads")
FUNCTION = re.compile(r"^\s*Function : (\S+)")
INSTRUCTION = re.compile(r"/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;")


def compile_tree(csrc: Path, out: Path) -> dict:
    """{source name: (cubin path, ptxas log)} for every ``*.cu`` of csrc,
    built side by side."""
    nvcc = nvcc_path()
    flags = [f for f in NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
    out.mkdir(parents=True, exist_ok=True)

    def one(src: Path):
        cubin = out / f"{src.stem}.cubin"
        p = subprocess.run([nvcc, *flags, "-cubin", "-o", str(cubin),
                            str(src)], capture_output=True, text=True)
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{p.stderr[-4000:]}")
        return src.name, (cubin, p.stdout + p.stderr)

    sources = sorted([*csrc.glob("*.cu"), *csrc.glob("splits/*.cu")])
    with ThreadPoolExecutor(max_workers=len(sources) or 1) as pool:
        return dict(pool.map(one, sources))


def ptxas_rows(log: str) -> dict:
    """{mangled kernel: (registers, (stack, spill stores, spill loads))}"""
    rows, entry, frame = {}, None, None
    for line in log.splitlines():
        m = ENTRY.search(line)
        if m:
            entry, frame = m.group(1), None
            continue
        m = FRAME.search(line)
        if m and entry:
            frame = tuple(int(x) for x in m.groups())
            continue
        m = USED.search(line)
        if m and entry:
            rows[entry] = (int(m.group(1)), frame)
            entry = None
    return rows


def sass(cubin: Path) -> dict:
    """{mangled kernel: [instruction text, ...]} of a cubin."""
    p = subprocess.run(["cuobjdump", "-sass", str(cubin)],
                       capture_output=True, text=True, check=True)
    return parse_sass(p.stdout)


def parse_sass(text: str) -> dict:
    """{mangled kernel: [instruction text, ...]} of ``cuobjdump -sass``'s
    output: each instruction without its address and encoding."""
    functions, name = {}, None
    for line in text.splitlines():
        m = FUNCTION.match(line)
        if m:
            name = m.group(1)
            functions[name] = []
            continue
        m = INSTRUCTION.search(line)
        if m and name:
            functions[name].append(m.group(1))
    return functions


def demangle(names: list, drop: list) -> dict:
    """{mangled: the demangled name without the namespaces in ``drop``}"""
    plain = names
    if shutil.which("c++filt"):
        p = subprocess.run(["c++filt"], input="\n".join(names),
                           capture_output=True, text=True)
        if p.returncode == 0 and len(p.stdout.splitlines()) == len(names):
            plain = p.stdout.splitlines()
    out = {}
    for mangled, name in zip(names, plain):
        for ns in drop:
            name = name.replace(f"{ns}::", "")
        out[mangled] = name
    return out


def tree(csrc: Path, work: Path, drop: list) -> dict:
    """{(source, kernel): {"sass": [...], "registers": n, "frame": (...)}}"""
    rows = {}
    for source, (cubin, log) in compile_tree(csrc, work).items():
        report = ptxas_rows(log)
        code = sass(cubin)
        names = demangle(sorted(set(code) | set(report)), drop)
        for mangled, name in names.items():
            regs, frame = report.get(mangled, (None, None))
            rows[source, name] = {"sass": code.get(mangled, []),
                                  "registers": regs, "frame": frame}
    return rows


def compare(old: dict, new: dict) -> list:
    """One row a kernel of either tree. A kernel found in one source of the
    old tree and another of the new one alone (a unit split in two) is
    matched by its name: one row, its source "old -> new"."""
    gone = {key[1]: key for key in set(old) - set(new)}
    moved = {key: gone[key[1]] for key in set(new) - set(old)
             if key[1] in gone}
    out = []
    for key in sorted((set(old) | set(new)) - set(moved.values())):
        a, b = old.get(moved.get(key, key)), new.get(key)
        row = {"source": key[0], "kernel": key[1]}
        if key in moved:
            row["source"] = f"{moved[key][0]} -> {key[0]}"
        if a is None or b is None:
            row["status"] = "only new" if a is None else "only old"
        else:
            row["status"] = "same" if a["sass"] == b["sass"] else "differs"
        for tag, side in (("old", a), ("new", b)):
            if side is not None:
                row[f"{tag}_registers"] = side["registers"]
                row[f"{tag}_frame"] = side["frame"]
                row[f"{tag}_instructions"] = len(side["sass"])
        out.append(row)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old", type=Path, help="the first tree's csrc directory")
    ap.add_argument("new", type=Path, help="the second tree's csrc directory")
    ap.add_argument("--drop", action="append", default=[],
                    help="a namespace left out of the names that match "
                         "kernels (repeatable)")
    ap.add_argument("--out", type=Path, help="write every row as JSON here")
    args = ap.parse_args(argv)
    if not shutil.which("cuobjdump"):
        print("cuobjdump not found", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        with ThreadPoolExecutor(max_workers=2) as pool:
            old_f = pool.submit(tree, args.old, work / "old", args.drop)
            new_f = pool.submit(tree, args.new, work / "new", args.drop)
            rows = compare(old_f.result(), new_f.result())
    by_source = {}
    for r in rows:
        by_source.setdefault(r["source"], []).append(r["status"])
    for source, statuses in sorted(by_source.items()):
        counts = {s: statuses.count(s) for s in sorted(set(statuses))}
        print(f"sass_diff {source}: {counts}", flush=True)
    moved = [r for r in rows if r["status"] != "same"]
    for r in moved:
        print(f"sass_diff {r['status']}: {r['source']} {r['kernel']} "
              f"registers {r.get('old_registers')} -> "
              f"{r.get('new_registers')}, instructions "
              f"{r.get('old_instructions')} -> {r.get('new_instructions')}",
              flush=True)
    print(f"sass_diff: {len(rows)} kernels, "
          f"{len(rows) - len(moved)} the same, {len(moved)} not", flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
