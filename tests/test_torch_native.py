"""The port's native PNG encoder and its plain Python twin
(grayscott_tpu_torch/native) against JAX's ``native.png_encode``, byte for
byte, on seed-made images; and the stream decodes to the input with zlib
and NumPy alone. The port's library builds into the build store, never
beside its source."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from grayscott_tpu import native as jax_native
from grayscott_tpu_torch import native
from grayscott_tpu_torch.utils import palette

LEVELS = [1, 2, 9]


def _images():
    rng = np.random.RandomState(21)
    noise = rng.randint(0, 256, (37, 53, 3)).astype(np.uint8)
    v = rng.uniform(0.0, 0.5, (64, 96)).astype(np.float32)
    v[:, :48] = np.linspace(0.0, 0.5, 48, dtype=np.float32)
    field = palette.colorize(v)  # long runs of small deltas, as frames are
    return {"noise": noise, "field": field,
            "pixel": noise[:1, :1].copy(), "row": noise[:1].copy()}


def _need_native():
    if native.load() is None or jax_native.load() is None:
        pytest.skip("no C++ toolchain: the native encoder is not built")


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("image", ["noise", "field", "pixel", "row"])
def test_native_png_equals_jax_native(image, level):
    _need_native()
    rgb = _images()[image]
    got = native.png_encode(rgb, level)
    assert got == jax_native.png_encode(rgb, level)
    np.testing.assert_array_equal(native.png_decode(got), rgb)


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("image", ["noise", "field", "pixel", "row"])
def test_plain_python_png_equals_native(image, level):
    """The fallback encoder (the card's machine may lack g++) writes the
    native encoder's bytes: the same filter, zlib stream and chunks."""
    _need_native()
    rgb = _images()[image]
    assert native.png_encode_plain(rgb, level) == \
        native.png_encode(rgb, level)


def test_png_decodes_to_input_without_native(monkeypatch):
    monkeypatch.setattr(native, "load", lambda: None)
    rgb = _images()["field"]
    data = native.png_encode(rgb)
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    np.testing.assert_array_equal(native.png_decode(data), rgb)


def test_png_decode_refuses_a_damaged_stream():
    data = bytearray(native.png_encode_plain(_images()["noise"]))
    data[40] ^= 0xFF  # inside the IDAT payload: its CRC no longer holds
    with pytest.raises(ValueError):
        native.png_decode(bytes(data))
    with pytest.raises(ValueError):
        native.png_decode(b"GIF89a")


def test_encode_refuses_a_non_rgb_image():
    with pytest.raises(ValueError):
        native.png_encode(np.zeros((4, 5), np.uint8))


def test_library_builds_in_the_store_not_beside_the_source(tmp_path,
                                                           monkeypatch):
    """GRAYSCOTT_CACHE_DIR moves the library, which is built there (JAX's
    loader writes _gs_native.so into its package directory)."""
    if native.gxx_version().startswith("g++ not found"):
        pytest.skip("no g++")
    monkeypatch.setenv("GRAYSCOTT_CACHE_DIR", str(tmp_path))
    path = native.library_path()
    assert path.parent == tmp_path / "native"
    assert native.build() == path and path.exists()
    assert not list(native.SOURCE.parent.glob("*.so"))
    lib = native._bind(path)
    assert lib.gs_native_abi_version() == native.ABI_VERSION


def test_encoder_names_what_runs():
    if native.load() is None:
        assert native.encoder().startswith("python")
    else:
        assert native.encoder().startswith("native")
