"""Argument checks that every kernel wrapper makes before it hands raw
pointers to a kernel: the kernels trust their pointers and shapes."""

from __future__ import annotations

from typing import Sequence

import torch

from ..params import FoldConstants
from . import stencil


def check_boundary(boundary: str) -> None:
    if boundary not in stencil.BOUNDARIES:
        raise ValueError(f"unknown boundary {boundary!r}; "
                         f"expected {stencil.BOUNDARIES}")


def check_fold(fc, boundary: str) -> None:
    """The fold entries' arguments: a ``FoldConstants`` on the naive
    boundary."""
    if not isinstance(fc, FoldConstants):
        raise TypeError(f"the folded naive reaction takes FoldConstants, "
                        f"got {type(fc).__name__}")
    if boundary != "naive":
        raise ValueError(f"the folded naive reaction applies to the naive "
                         f"boundary, got {boundary!r}")


def check_count(name: str, value, low: int, high: int | None = None) -> None:
    """``value`` is an int in ``[low, high]`` (no upper limit: None)."""
    if not (isinstance(value, int) and value >= low
            and (high is None or value <= high)):
        span = f"[{low}, {high}]" if high is not None else f">= {low}"
        raise ValueError(f"{name} must be an int {span}, got {value!r}")


#: the storage types of the kernels that take bf16 storage (K1, its shard
#: entry, K2, K7); every other kernel takes float32 only
STORAGE_DTYPES = (torch.float32, torch.bfloat16)


def check_state(inputs: Sequence[torch.Tensor],
                outputs: Sequence[torch.Tensor], ndim: int = 2,
                dtypes: Sequence[torch.dtype] = (torch.float32,)) -> None:
    """The kernels' state tensors: of one dtype among ``dtypes``,
    contiguous, of one shape with ``ndim`` dimensions, on one CPU or CUDA
    device; every output apart from every other tensor in memory (the
    kernels read other tiles' cells of their inputs while they write their
    outputs)."""
    tensors = (*inputs, *outputs)
    first = tensors[0]
    if first.device.type not in ("cpu", "cuda"):
        raise ValueError(f"tensors must lie on the CPU or a CUDA device, "
                         f"not {first.device}")
    if any(t.device != first.device for t in tensors):
        raise ValueError("the state tensors must share one device, got "
                         f"{[str(t.device) for t in tensors]}")
    if first.dtype not in dtypes or any(t.dtype != first.dtype
                                        for t in tensors):
        names = " or ".join(str(d).replace("torch.", "") for d in dtypes)
        raise ValueError(f"the state tensors must be {names}, all of one "
                         f"dtype, got {[t.dtype for t in tensors]}")
    if first.dim() != ndim or any(t.shape != first.shape for t in tensors):
        raise ValueError(f"the state tensors must be {ndim}-D of one shape, "
                         f"got {[tuple(t.shape) for t in tensors]}")
    if first.numel() == 0 or max(first.shape) >= 2 ** 31:
        raise ValueError(f"unsupported domain shape {tuple(first.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the state tensors must be contiguous")
    spans = [(t.data_ptr(), t.data_ptr() + t.element_size() * t.numel())
             for t in tensors]
    for i in range(len(inputs), len(tensors)):
        lo, hi = spans[i]
        if any(j != i and lo < b and a < hi for j, (a, b) in enumerate(spans)):
            raise ValueError("every output buffer must lie apart from the "
                             "other state buffers")
