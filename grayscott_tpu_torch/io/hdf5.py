"""HDF5 snapshot output: the port's copy of ``grayscott_tpu/io/hdf5.py``,
trimmed to the writer.

The reference's layout: one 3-D float32 dataset ``"matrix"`` of shape
``[num_images, rows, cols]``, chunked ``[1, rows, cols]`` (rows halved
until a chunk is under HDF5's 4 GiB limit), holding V. h5py is imported
only where a file is written, so the rest of the port runs without it.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from ..params import Precision

#: the dataset's name in the reference's files
DEFAULT_DATASET = "matrix"


def _chunk_shape(rows: int, cols: int, itemsize: int) -> Tuple[int, int, int]:
    """``(1, rows, cols)``, rows halved until the chunk is under 4 GiB."""
    r_chunk = rows
    while r_chunk > 1 and r_chunk * cols * itemsize >= 1 << 32:
        r_chunk = -(-r_chunk // 2)
    return (1, r_chunk, cols)


class Writer:
    """Streaming snapshot writer: one V frame per :meth:`write`."""

    def __init__(self, file_name: os.PathLike | str, shape: Tuple[int, int],
                 num_images: int, dataset_name: str = DEFAULT_DATASET):
        import h5py

        rows, cols = shape
        self._file = h5py.File(file_name, "w")
        self._dataset = self._file.create_dataset(
            dataset_name, shape=(num_images, rows, cols), dtype=Precision,
            chunks=_chunk_shape(rows, cols, np.dtype(Precision).itemsize))
        self._position = 0

    def write(self, result: np.ndarray) -> None:
        """Append one V snapshot."""
        self._dataset[self._position] = np.asarray(result, dtype=Precision)
        self._position += 1

    def close(self) -> None:
        """Flush and close the file."""
        self._file.close()
