"""HDF5 snapshot I/O: the port's copy of ``grayscott_tpu/io/hdf5.py``.

The reference's layout: one 3-D float32 dataset ``"matrix"`` of shape
``[num_images, rows, cols]``, chunked ``[1, rows, cols]`` (rows halved
until a chunk is under HDF5's 4 GiB limit), holding V. h5py is imported
only where a file is opened, so the rest of the port (``data-to-pics``
included) imports without it.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Tuple

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


class Reader:
    """Snapshot reader / iterator (``hdf5::Reader``, data/src/hdf5.rs:81-148)."""

    def __init__(
        self,
        file_name: os.PathLike | str,
        dataset_name: str = DEFAULT_DATASET,
    ):
        import h5py

        self._file = h5py.File(file_name, "r")
        self._dataset = self._file[dataset_name]
        if self._dataset.ndim != 3:
            raise ValueError("Dataset should be three-dimensional")
        self._position = 0

    @property
    def image_shape(self) -> Tuple[int, int]:
        return tuple(self._dataset.shape[1:])

    @property
    def num_images(self) -> int:
        return self._dataset.shape[0]

    def read(self, out: Optional[np.ndarray] = None) -> Optional[np.ndarray]:
        """Next snapshot, or None at the end. ``out``: optional recycled
        destination buffer (the buffer-recycling channel pattern of the
        reference's pipelines, data-to-pics/src/main.rs:80-110) — must
        match the image shape and dtype; decoded directly into it."""
        if self._position >= self.num_images:
            return None
        if out is not None and out.shape == self.image_shape \
                and out.dtype == np.dtype(Precision):
            self._dataset.read_direct(out, source_sel=np.s_[self._position])
        else:
            out = np.asarray(self._dataset[self._position], dtype=Precision)
        self._position += 1
        return out

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            img = self.read()
            if img is None:
                return
            yield img

    def close(self) -> None:
        self._file.close()

    def __enter__(self) -> "Reader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
