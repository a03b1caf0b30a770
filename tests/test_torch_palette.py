"""The port's palette (grayscott_tpu_torch/utils/palette.py) against the
JAX one: the table at every tested resolution, and colorize through the
native colorizer and through the NumPy fallback, on the same seed-made
fields, NaN and +-Inf included. All exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from grayscott_tpu import native as jax_native
from grayscott_tpu.utils import palette as jax_palette
from grayscott_tpu_torch import native
from grayscott_tpu_torch.utils import palette

RESOLUTIONS = [2, 3, 17, 255, 256, 257, 1000, 4096]


def test_amplitude_constants():
    assert palette.MAX_AMPLITUDE == jax_palette.MAX_AMPLITUDE
    assert palette.AMPLITUDE_SCALE == jax_palette.AMPLITUDE_SCALE


@pytest.mark.parametrize("resolution", RESOLUTIONS)
def test_lut_equals_matplotlib_sampled_jax_lut(resolution):
    """matplotlib's inferno sampled by JAX, and the port's embedded 256
    rows with the colormap's index rule: the same table."""
    got = palette.inferno_lut(resolution)
    want = jax_palette.inferno_lut(resolution)
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape == (resolution, 3)
    np.testing.assert_array_equal(got, want)


def test_embedded_rows_are_the_256_table():
    np.testing.assert_array_equal(palette.INFERNO_256,
                                  jax_palette.inferno_lut(256))
    # every row distinct: an RGB pixel names its palette index
    assert len({tuple(row) for row in palette.INFERNO_256}) == 256


def _fields(seed: int):
    """Seed-made concentration fields: in range, out of range, and with
    NaN and +-Inf cells (a diverged run)."""
    rng = np.random.RandomState(seed)
    plain = rng.uniform(-0.2, 1.2, (41, 57)).astype(np.float32)
    bad = rng.uniform(0.0, 0.6, (41, 57)).astype(np.float32)
    bad[3, 7] = np.nan
    bad[10:12, :] = np.nan
    bad[20, 5:9] = np.inf
    bad[21, 1:4] = -np.inf
    large = rng.uniform(0.0, 0.55, (300, 301)).astype(np.float32)
    return {"plain": plain, "nan_inf": bad, "large": large}


@pytest.mark.parametrize("field", ["plain", "nan_inf", "large"])
def test_native_colorize_matches_jax(field):
    values = _fields(11)[field]
    if native.load() is None or jax_native.load() is None:
        pytest.skip("no C++ toolchain: the native colorizer is not built")
    got = native.colorize(values, palette.inferno_lut(),
                          palette.AMPLITUDE_SCALE)
    want = jax_native.colorize(values, jax_palette.inferno_lut(),
                               jax_palette.AMPLITUDE_SCALE)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(palette.colorize(values),
                                  jax_palette.colorize(values))


@pytest.mark.parametrize("field", ["plain", "nan_inf", "large"])
def test_numpy_colorize_fallback_matches_jax(field, monkeypatch):
    """Both packages' NumPy fallbacks, forced, and the native colorizer
    where there is one: the same pixels."""
    values = _fields(12)[field]
    native_rgb = palette.colorize(values)
    monkeypatch.setattr(native, "colorize", lambda *a, **k: None)
    monkeypatch.setattr(jax_native, "colorize", lambda *a, **k: None)
    got = palette.colorize(values)
    np.testing.assert_array_equal(got, jax_palette.colorize(values))
    np.testing.assert_array_equal(got, native_rgb)
    # NaN and -Inf map to the first colour, +Inf to the last
    if field == "nan_inf":
        np.testing.assert_array_equal(got[10], np.broadcast_to(
            palette.INFERNO_256[0], (57, 3)))
        np.testing.assert_array_equal(got[20, 5:9], np.broadcast_to(
            palette.INFERNO_256[-1], (4, 3)))
        np.testing.assert_array_equal(got[21, 1:4], np.broadcast_to(
            palette.INFERNO_256[0], (3, 3)))


def test_colorize_into_recycled_buffer():
    values = _fields(13)["plain"]
    out = np.zeros(values.shape + (3,), np.uint8)
    got = palette.colorize(values, out=out)
    assert got is out
    np.testing.assert_array_equal(out, jax_palette.colorize(values))
