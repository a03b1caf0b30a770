"""The kernel build (grayscott_tpu_torch/ops/build.py) on the CPU: what
names the library, and the sources it compiles. nvcc itself runs only on
the card's machine."""

import shutil

import pytest

torch = pytest.importorskip("torch")

from grayscott_tpu_torch.ops import build


def test_library_name_follows_sources_and_headers(tmp_path, monkeypatch):
    """An edit to a shared header (csrc/*.cuh) names a new library, as an
    edit to a source does, so a stale build is never reused."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, csrc)
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    headers = sorted(csrc.glob("*.cuh"))
    assert headers, "the kernels share a header"
    first = build.library_path()
    assert build.library_path() == first
    headers[0].write_text(headers[0].read_text() + "\n// edited\n")
    second = build.library_path()
    assert second != first
    source = build.sources()[0]
    source.write_text(source.read_text() + "\n// edited\n")
    assert build.library_path() not in (first, second)


def test_every_kernel_source_is_a_translation_unit():
    names = {s.name for s in build.sources()}
    assert {"windowed.cu", "resident.cu", "mega.cu", "packed.cu",
            "packed_resident.cu", "packed_mega.cu"} <= names
    assert not any(name.endswith(".cuh") for name in names)
