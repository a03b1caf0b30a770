"""grayscott-tpu's PyTorch port: the Gray-Scott simulator on an NVIDIA GPU.

A second package beside ``grayscott_tpu`` (the JAX reference, which stays
as it is). Plain tensor code is PyTorch; the hot loops are CUDA C++
kernels written by hand for Hopper (``csrc/``), built with ``nvcc`` on
first use. The package imports ``torch`` and never ``jax``, and nothing of
the JAX package: it keeps its own copies of what it needs from there.
"""

from .params import DEFAULT_STENCIL, Parameters, Precision, STENCILS

__all__ = ["DEFAULT_STENCIL", "Parameters", "Precision", "STENCILS"]
