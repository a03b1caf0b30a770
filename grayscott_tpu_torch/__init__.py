"""grayscott-tpu's PyTorch port: the Gray-Scott simulator on an NVIDIA GPU.

A second package beside ``grayscott_tpu`` (the JAX reference, which stays
as it is). Plain tensor code is PyTorch; the hot loop is a CUDA C++ kernel
written by hand for Hopper (``csrc/windowed.cu``), built with ``nvcc`` on
first use. The package imports ``torch`` and never ``jax``; the JAX
package's numpy-only modules (``params``, ``errors``, ``oracle``,
``species.initial_uv``, ``io.hdf5``) are reused by import.
"""

from .params import DEFAULT_STENCIL, Parameters, Precision, STENCILS

__all__ = ["DEFAULT_STENCIL", "Parameters", "Precision", "STENCILS"]
