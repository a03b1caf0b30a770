"""Colour palette of the pictures: the port's ``grayscott_tpu/utils/
palette.py``.

The reference's INFERNO gradient with its amplitude scale
(``ui/src/lib.rs:115-123``: ``MAX_AMPLITUDE = 0.5``, ``AMPLITUDE_SCALE =
2.0``) and the per-pixel ``eval_continuous(2.0 * v)`` of ``data-to-pics``
(``data-to-pics/src/main.rs:139-142``).

JAX's :func:`inferno_lut` samples matplotlib's ``inferno`` colormap, which
the card's machine lacks. That colormap is a 256-entry ``ListedColormap``
(its data is CC0): called on a float ``x`` it takes entry ``min(int(x *
256), 255)``, so every entry of a table at any resolution is one of the 256
rows of the table at 256. The port keeps those rows (:data:`INFERNO_256`,
768 bytes) and builds any resolution with the same index rule, over the
same float64 ``np.linspace(0, 1, resolution)``.
"""

from __future__ import annotations

import numpy as np

#: Reference: ui/src/lib.rs:119-123
MAX_AMPLITUDE = 0.5
AMPLITUDE_SCALE = 1.0 / MAX_AMPLITUDE

#: matplotlib's ``inferno`` colours, each channel ``round(255 * c)``, RGB
#: row by row (JAX's ``inferno_lut(256)``)
INFERNO_256 = np.frombuffer(bytes.fromhex(
    "00000401000501010601010802010a02020c02020e030210040312040314050417060419"
    "07051b08051d09061f0a07220b07240c08260d08290e092b10092d110a30120a32140b34"
    "150b37160b39180c3c190c3e1b0c411c0c431e0c451f0c48210c4a230c4c240c4f260c51"
    "280b53290b552b0b572d0b592f0a5b310a5c320a5e340a5f3609613809623909633b0964"
    "3d09653e0966400a67420a68440a68450a69470b6a490b6a4a0c6b4c0c6b4d0d6c4f0d6c"
    "510e6c520e6d540f6d550f6d57106e59106e5a116e5c126e5d126e5f136e61136e62146e"
    "64156e65156e67166e69166e6a176e6c186e6d186e6f196e71196e721a6e741a6e751b6e"
    "771c6d781c6d7a1d6d7c1d6d7d1e6d7f1e6c801f6c82206c84206b85216b87216b88226a"
    "8a226a8c23698d23698f24699025689225689326679526679727669827669a28659b2964"
    "9d29649f2a63a02a63a22b62a32c61a52c60a62d60a82e5fa92e5eab2f5ead305dae305c"
    "b0315bb1325ab3325ab43359b63458b73557b93556ba3655bc3754bd3853bf3952c03a51"
    "c13a50c33b4fc43c4ec63d4dc73e4cc83f4bca404acb4149cc4248ce4347cf4446d04545"
    "d24644d34743d44842d54a41d74b3fd84c3ed94d3dda4e3cdb503bdd513ade5238df5337"
    "e05536e15635e25734e35933e45a31e55c30e65d2fe75e2ee8602de9612bea632aeb6429"
    "eb6628ec6726ed6925ee6a24ef6c23ef6e21f06f20f1711ff1731df2741cf3761bf37819"
    "f47918f57b17f57d15f67e14f68013f78212f78410f8850ff8870ef8890cf98b0bf98c0a"
    "f98e09fa9008fa9207fa9407fb9606fb9706fb9906fb9b06fb9d07fc9f07fca108fca309"
    "fca50afca60cfca80dfcaa0ffcac11fcae12fcb014fcb216fcb418fbb61afbb81dfbba1f"
    "fbbc21fbbe23fac026fac228fac42afac62df9c72ff9c932f9cb35f8cd37f8cf3af7d13d"
    "f7d340f6d543f6d746f5d949f5db4cf4dd4ff4df53f4e156f3e35af3e55df2e661f2e865"
    "f2ea69f1ec6df1ed71f1ef75f1f179f2f27df2f482f3f586f3f68af4f88ef5f992f6fa96"
    "f8fb9af9fc9dfafda1fcffa4"
), dtype=np.uint8).reshape(256, 3)

_LUTS: dict[int, np.ndarray] = {}


def inferno_lut(resolution: int = 256) -> np.ndarray:
    """(resolution, 3) uint8 INFERNO lookup table (the livesim
    --color-palette-resolution analog, livesim/src/palette.rs:42-121)."""
    if resolution not in _LUTS:
        n = len(INFERNO_256)
        rows = np.minimum((np.linspace(0.0, 1.0, resolution) * n)
                          .astype(np.int64), n - 1)
        _LUTS[resolution] = INFERNO_256[rows]
    return _LUTS[resolution]


def colorize(values: np.ndarray, scale: float = AMPLITUDE_SCALE,
             out: np.ndarray | None = None) -> np.ndarray:
    """Map float concentrations to RGB8 via the INFERNO gradient.

    Equivalent to colorous ``Gradient::eval_continuous(scale * v)``: the
    input is clamped to [0, 1] and linearly interpolated in the 256-color
    table. Returns an (..., 3) uint8 array. Uses the multithreaded native
    C++ kernel (grayscott_tpu_torch/native) when available, NumPy otherwise.
    ``out``: optional recycled (..., 3) uint8 destination buffer.
    """
    from .. import native

    res = native.colorize(np.asarray(values), inferno_lut(), scale, out=out)
    if res is not None:
        return res
    lut = inferno_lut().astype(np.float32)
    n = len(lut)
    t = np.clip(values * np.float32(scale), 0.0, 1.0).astype(np.float32)
    # np.clip propagates NaN, and floor(NaN).astype(int32) below would be
    # an arbitrary (possibly out-of-range) LUT index: map a diverged
    # field's NaNs to 0, like the native kernel does
    t = np.nan_to_num(t, nan=0.0, copy=False)
    x = t * np.float32(n - 1)
    lo = np.floor(x).astype(np.int32)
    hi = np.minimum(lo + 1, n - 1)
    frac = (x - lo)[..., None]
    rgb = lut[lo] * (1.0 - frac) + lut[hi] * frac
    rgb += 0.5
    if out is not None and out.shape == rgb.shape \
            and out.dtype == np.uint8:
        np.copyto(out, rgb, casting="unsafe")
        return out
    return rgb.astype(np.uint8)
