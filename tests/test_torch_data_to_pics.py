"""The port's data-to-pics (grayscott_tpu_torch/cli/data_to_pics.py) on a
file that the port's simulate wrote: the PNG directories that JAX's tool
and the port's write are byte for byte the same, at two compression
levels and two writer-thread counts; the GIF too; and the port's HDF5
``Reader`` reads what JAX's reads. Host only, as the tool is."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from grayscott_tpu.cli import data_to_pics as jax_data_to_pics
from grayscott_tpu.io import hdf5 as jax_hdf5
from grayscott_tpu_torch import native
from grayscott_tpu_torch.cli import data_to_pics, simulate
from grayscott_tpu_torch.io import hdf5
from grayscott_tpu_torch.utils import palette

IMAGES, SHAPE = 5, (24, 32)


@pytest.fixture(scope="module")
def h5file(tmp_path_factory):
    """5 images of 24x32, 8 steps apart, from the port's simulate on the
    plain version of the cuda backend."""
    path = tmp_path_factory.mktemp("d2p") / "port.h5"
    assert simulate.main([
        "-n", str(IMAGES), "-r", str(SHAPE[0]), "-c", str(SHAPE[1]),
        "-e", "8", "--device", "cpu", "-o", str(path)]) == 0
    return path


def _pngs(directory):
    names = sorted(os.listdir(directory))
    return names, [open(os.path.join(directory, n), "rb").read()
                   for n in names]


@pytest.mark.parametrize("threads", [1, 3])
@pytest.mark.parametrize("level", [2, 9])
def test_pngs_byte_equal_to_jax(h5file, tmp_path, level, threads):
    flags = ["-i", str(h5file), "--png-level", str(level),
             "--output-threads", str(threads)]
    assert jax_data_to_pics.main(
        flags + ["-o", str(tmp_path / "jax")]) == 0
    assert data_to_pics.main(flags + ["-o", str(tmp_path / "port")]) == 0
    names, got = _pngs(tmp_path / "port")
    jax_names, want = _pngs(tmp_path / "jax")
    # zero-padded to int(log10(5)) + 1 = 1 digit, as JAX's
    assert names == jax_names == [f"{i}.png" for i in range(IMAGES)]
    assert got == want
    # each picture is colorize() of its frame
    with hdf5.Reader(h5file) as reader:
        for frame, data in zip(reader, got):
            np.testing.assert_array_equal(native.png_decode(data),
                                          palette.colorize(frame))


def test_pngs_without_the_native_encoder(h5file, tmp_path, monkeypatch):
    """With no g++ (the fallback on a machine without a toolchain), the
    plain Python encoder and the NumPy colorizer write the same files."""
    flags = ["-i", str(h5file)]
    assert data_to_pics.main(flags + ["-o", str(tmp_path / "native")]) == 0
    monkeypatch.setattr(native, "load", lambda: None)
    assert data_to_pics.main(flags + ["-o", str(tmp_path / "plain")]) == 0
    assert _pngs(tmp_path / "plain") == _pngs(tmp_path / "native")


def test_zero_padded_names_for_many_images(tmp_path):
    """int(log10(n)) + 1 digits: 12 images are 00.png .. 11.png."""
    path = tmp_path / "many.h5"
    writer = hdf5.Writer(path, (3, 4), 12)
    for i in range(12):
        writer.write(np.full((3, 4), i / 24, np.float32))
    writer.close()
    assert data_to_pics.main(["-i", str(path), "-o",
                              str(tmp_path / "out")]) == 0
    names, _ = _pngs(tmp_path / "out")
    assert names == [f"{i:02d}.png" for i in range(12)]


def test_gif_same_frames_as_jax(h5file, tmp_path):
    pytest.importorskip("PIL")
    from PIL import Image

    gifs = {}
    for name, module in (("port", data_to_pics), ("jax", jax_data_to_pics)):
        gifs[name] = tmp_path / f"{name}.gif"
        assert module.main(["-i", str(h5file), "-o", str(tmp_path / name),
                            "--gif", str(gifs[name]), "--gif-fps", "10"]) == 0
    assert gifs["port"].read_bytes() == gifs["jax"].read_bytes()
    with Image.open(gifs["port"]) as im:
        assert im.n_frames == IMAGES and im.size == SHAPE[::-1]


def test_bad_png_level_stops(h5file, tmp_path):
    with pytest.raises(SystemExit):
        data_to_pics.main(["-i", str(h5file), "-o", str(tmp_path),
                           "--png-level", "0"])


def test_reader_matches_jax(h5file):
    """read(out=) decodes into the recycled buffer; a buffer of the wrong
    shape is replaced; both readers give the same frames, then None."""
    with hdf5.Reader(h5file) as port, jax_hdf5.Reader(h5file) as ref:
        assert port.image_shape == ref.image_shape == SHAPE
        assert port.num_images == ref.num_images == IMAGES
        buf = np.empty(SHAPE, np.float32)
        wrong = np.empty((3, 3), np.float32)
        for i in range(IMAGES):
            got = port.read(out=buf if i % 2 == 0 else wrong)
            want = ref.read()
            if i % 2 == 0:
                assert got is buf
            else:
                assert got is not wrong and got.shape == SHAPE
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)
        assert port.read() is None and ref.read() is None
    with hdf5.Reader(h5file) as port:
        frames = list(port)
    with jax_hdf5.Reader(h5file) as ref:
        want = list(ref)
    assert len(frames) == IMAGES
    for a, b in zip(frames, want):
        np.testing.assert_array_equal(a, b)


def test_reader_refuses_a_flat_dataset(tmp_path):
    import h5py

    path = tmp_path / "flat.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("matrix", data=np.zeros((3, 4), np.float32))
    with pytest.raises(ValueError):
        hdf5.Reader(path)
