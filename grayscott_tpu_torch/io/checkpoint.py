"""Simulation state checkpoints: the port's copy of
``grayscott_tpu/io/checkpoint.py``.

Both concentrations and the run's metadata in a small HDF5 file: datasets
``"u"`` and ``"v"`` (float32), attributes ``format_version``,
``steps_performed`` and ``params`` (the JSON of
``dataclasses.asdict(Parameters)``). The layout is the JAX package's, so a
file written by either package loads in the other. h5py is imported only
where a file is read or written, so the rest of the port runs without it.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Tuple

import numpy as np

from ..params import Parameters, Precision

FORMAT_VERSION = 1


def save_state(path: os.PathLike | str, u: np.ndarray, v: np.ndarray,
               params: Parameters, steps_performed: int = 0) -> None:
    import h5py

    u = np.asarray(u, dtype=Precision)
    v = np.asarray(v, dtype=Precision)
    if u.shape != v.shape:
        raise ValueError(f"u/v shape mismatch: {u.shape} vs {v.shape}")
    with h5py.File(path, "w") as f:
        f.create_dataset("u", data=u)
        f.create_dataset("v", data=v)
        f.attrs["format_version"] = FORMAT_VERSION
        f.attrs["steps_performed"] = steps_performed
        f.attrs["params"] = json.dumps(dataclasses.asdict(params))


def load_state(path: os.PathLike | str
               ) -> Tuple[np.ndarray, np.ndarray, Parameters, int]:
    import h5py

    with h5py.File(path, "r") as f:
        if int(f.attrs.get("format_version", -1)) != FORMAT_VERSION:
            raise ValueError(f"{path}: not a grayscott-tpu checkpoint")
        u = np.asarray(f["u"], dtype=Precision)
        v = np.asarray(f["v"], dtype=Precision)
        raw = json.loads(f.attrs["params"])
        raw["weights"] = tuple(tuple(row) for row in raw["weights"])
        params = Parameters(**raw)
        steps = int(f.attrs["steps_performed"])
    return u, v, params, steps
