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


def test_splits_are_a_library_of_their_own():
    """The redesigns' ablation parts (csrc/splits/*.cu) build into their
    own library, on the first call of a split; the library every run
    builds leaves them out."""
    main = {s.name for s in build.sources()}
    splits = {s.name for s in build.sources(build.SPLITS)}
    assert {"mega_ring_ablation.cu", "windowed_pins_ablation.cu",
            "sharded_mega_ablation.cu", "windowed_folded_ablation.cu",
            "mega_pins_ablation.cu",
            "sharded_mega_pins_ablation.cu"} == splits
    assert not main & splits
    assert build.library_path(build.SPLITS).name.startswith("libgs_splits-")
    assert build.library_path().name.startswith("libgs_kernels-")
    assert build.library_path(build.SPLITS).parent == \
        build.library_path().parent


@pytest.mark.parametrize("name", ["kernels", "splits", "both"])
def test_nvcc_units_times_every_unit_of_its_set(monkeypatch, capsys, name):
    """``scripts/nvcc_units.py`` compiles each unit of its set once (here
    with a stand-in compiler that accepts anything) and prints a line for
    each and one for the set; ``both`` is every unit of both libraries."""
    from grayscott_tpu_torch.scripts import nvcc_units

    true = shutil.which("true")
    if true is None:
        pytest.skip("no `true` program to stand in for nvcc")
    monkeypatch.setattr(build, "nvcc_path", lambda: true)
    assert nvcc_units.main([name]) == 0
    lines = capsys.readouterr().out.splitlines()
    units = {"kernels": build.sources(build.KERNELS),
             "splits": build.sources(build.SPLITS)}
    want = (units["kernels"] + units["splits"] if name == "both"
            else units[name])
    assert sorted(line.split()[2][:-1] for line in lines[:-1]) == sorted(
        src.name for src in want)
    assert lines[-1].startswith(f"nvcc {name}: {len(want)} units at once")
