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

``SHARDED`` holds the sharded tuner's records (``bench/autotune.py:
sharded_autotune``, keyed by ``sharded_key``), which
``sharded_lookup`` reads on a local miss: the default run's in 4 shards on
one card, where JAX ships none (its sharded verdicts belong to a
topology; here every shard shares the one card, so the card is the
topology). Without a record ``engine="auto"`` runs the windowed engine.
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

#: key format: bench/autotune.py:sharded_key (the single-card key, then the
#: shard count; no pin)
SHARDED: dict[str, dict] = {
    # The winner of chip_smoke.py's phase 12b on NVIDIA H100 80GB HBM3,
    # power limit 700.00 W (nvidia-smi): the default run in 4 shards on the
    # one card, 1024 steps a candidate, the best of 3 device times (CUDA
    # events around each call, the exchange and every launch), ms per 1024
    # steps. K7: 4x1 20.900 (its read-site entry on 68x64 tiles), 1x4
    # 21.904, 2x2 22.885. Windowed, overlap off / on: 4x1 40.918 / 47.587,
    # 2x2 55.417 / 82.808, 1x4 56.638 / 57.503 (the exchange's slice copies
    # set their pace from the host). K7 on 4x1 led K7 on 1x4, the record
    # before it, by 4.6 %; on 64x64 tiles K7 on 4x1 had taken 27.536 against
    # 1x4's 21.903.
    "v1:h100-80gb-hbm3-sm132:1080x1920:naive:oono-puri|sharded:n4": {
        "engine": "mega", "mesh_cols": 1, "mesh_rows": 4,
        "block_rows": None, "block_cols": None, "steps_per_call": 8,
        "overlap": False, "gcells_per_sec": 101.597,
        "device_gcells_per_sec": 101.597, "wall_gcells_per_sec": 101.132,
        "source": "shipped-h100-sharded",
    },
}
