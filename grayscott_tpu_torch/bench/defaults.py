"""Autotune verdicts measured on the card and shipped with the package: the
port's ``grayscott_tpu/bench/defaults.py``, with the records of the card
the port runs on (JAX's TPU records stay in the JAX package).

A fresh install has no autotune store, and ``pack="auto"`` packs only on a
measured record (``backends/cuda.py``). These are the winners of
``bench/autotune.py:autotune`` on the four configurations the default run
and the bench run (1080x1920 and 4096x4096, naive and zero, Oono-Puri,
float32), as ``chip_smoke.py``'s autotune phase measured them, in the
record schema the tuner persists. A local record always wins
(``bench/autotune.py:lookup`` reads this table only on a local miss).

The keys carry the card's name and SM count
(``utils/device.py:autotune_platform``): on any other card, and on the
CPU, ``lookup`` misses this table and the backend falls back to its
measured ranking (``backends/cuda.py:auto_engine``).
"""

from __future__ import annotations

#: key format: utils.cache.autotune_key (kernel version, platform, shape,
#: boundary, stencil[, dtype])
SHIPPED: dict[str, dict] = {
    # The four winners of chip_smoke.py's phase 12 on NVIDIA H100 80GB HBM3,
    # power limit 700.00 W (nvidia-smi), 1024 steps a candidate, the best
    # of 3 device times (CUDA events), ms per 1024 steps.
    #
    # The default run: K3 17.627, K1 18.258, K2 18.936 (K3 3.5 % ahead).
    "v1:h100-80gb-hbm3-sm132:1080x1920:naive:oono-puri": {
        "engine": "resident", "block_rows": None, "steps_per_call": 8,
        "block_cols": None, "fold": 1, "pack": False,
        "gcells_per_sec": 120.458, "device_gcells_per_sec": 120.458,
        "wall_gcells_per_sec": 120.208, "source": "shipped-h100-pr11",
    },
    # Packed K6 8.227, packed K4 8.727, K2 11.290, K1 11.857, packed K5
    # 13.655, K3 15.457: the packed megakernel, 0.73x K2's time.
    "v1:h100-80gb-hbm3-sm132:1080x1920:zero:oono-puri": {
        "engine": "mega", "block_rows": None, "steps_per_call": 8,
        "block_cols": None, "fold": 1, "pack": True,
        "gcells_per_sec": 258.101, "device_gcells_per_sec": 258.101,
        "wall_gcells_per_sec": 256.546, "source": "shipped-h100-pr11",
    },
    # The bench's naive row: K1 95.05, K2 106.72, K3 138.83.
    "v1:h100-80gb-hbm3-sm132:4096x4096:naive:oono-puri": {
        "engine": "windowed", "block_rows": None, "steps_per_call": 8,
        "block_cols": None, "fold": 1, "pack": False,
        "gcells_per_sec": 180.741, "device_gcells_per_sec": 180.741,
        "wall_gcells_per_sec": 180.571, "source": "shipped-h100-pr11",
    },
    # The bench's zero row: packed K4 58.51, packed K6 60.98, K1 81.55, K2
    # 84.28, packed K5 123.74, K3 127.17: the packed windowed kernel, 0.72x
    # K1's time.
    "v1:h100-80gb-hbm3-sm132:4096x4096:zero:oono-puri": {
        "engine": "windowed", "block_rows": None, "steps_per_call": 8,
        "block_cols": None, "fold": 1, "pack": True,
        "gcells_per_sec": 293.612, "device_gcells_per_sec": 293.612,
        "wall_gcells_per_sec": 292.853, "source": "shipped-h100-pr11",
    },
}
