"""``scripts/sass_diff.py``'s parsers and comparison on canned
``cuobjdump -sass`` and ptxas text (the script itself needs the CUDA
toolkit)."""

from __future__ import annotations

import shutil

import pytest

pytest.importorskip("torch")

from grayscott_tpu_torch.scripts import sass_diff  # noqa: E402

PTXAS = """\
ptxas info    : Compiling entry function '_Z1aPf' for 'sm_90a'
ptxas info    : Function properties for _Z1aPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 48 registers, used 1 barriers, 384 bytes cmem[0]
ptxas info    : Compiling entry function '_Z1bPf' for 'sm_90a'
ptxas info    : Function properties for _Z1bPf
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 64 registers, 384 bytes cmem[0]
"""

SASS = """\
\tcode for sm_90a
\t\tFunction : _Z1aPf
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;     /* 0x00000a00ff017b82 */
                                                              /* 0x000fe40000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;         /* 0x0000000000007919 */
\t\t..........
\t\tFunction : _Z1bPf
        /*0000*/                   EXIT ;                     /* 0x000000000000794d */
"""


def test_ptxas_rows_reads_registers_and_frames():
    assert sass_diff.ptxas_rows(PTXAS) == {"_Z1aPf": (48, (0, 0, 0)),
                                           "_Z1bPf": (64, (8, 4, 4))}


def test_parse_sass_keeps_instructions_without_addresses():
    assert sass_diff.parse_sass(SASS) == {
        "_Z1aPf": ["LDC R1, c[0x0][0x28]", "S2R R0, SR_TID.X"],
        "_Z1bPf": ["EXIT"]}


@pytest.mark.parametrize("new_b,status", [(["EXIT"], "same"),
                                          (["NOP", "EXIT"], "differs")])
def test_compare_marks_each_kernel(new_b, status):
    def tree(b):
        return {("k.cu", "a"): {"sass": ["EXIT"], "registers": 8,
                                "frame": (0, 0, 0)},
                ("k.cu", "b"): {"sass": b, "registers": 9,
                                "frame": (0, 0, 0)}}
    old = tree(["EXIT"])
    new = tree(new_b)
    new[("k.cu", "c")] = {"sass": [], "registers": 1, "frame": None}
    rows = {r["kernel"]: r for r in sass_diff.compare(old, new)}
    assert rows["a"]["status"] == "same"
    assert rows["b"]["status"] == status
    assert rows["b"]["new_instructions"] == len(new_b)
    assert rows["c"]["status"] == "only new"
    assert "old_registers" not in rows["c"]


def test_demangle_drops_namespaces():
    name = sass_diff.demangle(["_ZN2gs4sm906pinned1fEv"],
                              ["pinned"])["_ZN2gs4sm906pinned1fEv"]
    if shutil.which("c++filt"):
        assert name == "gs::sm90::f()"
    else:
        assert name == "_ZN2gs4sm906pinned1fEv"


@pytest.mark.skipif(shutil.which("cuobjdump") is not None,
                    reason="the CUDA toolkit is installed")
def test_main_needs_cuobjdump(tmp_path, capsys):
    assert sass_diff.main([str(tmp_path), str(tmp_path)]) == 1
    assert "cuobjdump not found" in capsys.readouterr().err
