"""``cuda`` backend: the port's ``grayscott_tpu/backends/pallas.py``,
windowed engine only.

Storage is ``("windowed", u, v, u_next, v_next)``: plain ``(R, C)``
float32 tensors on the backend's device, no padding (the kernel masks the
domain edge itself). Each kernel launch reads ``(u, v)`` and writes
``(u_next, v_next)``, then the two pairs swap roles: the ping-pong pair is
updated in place, where the JAX backend gets fresh (donated) buffers from
every call. ``run_steps`` makes ``divmod(steps, K)`` full launches and one
remainder launch, as ``backends/pallas.py:858-887`` does; K = 8 is the
kernel's halo depth, as the JAX default ``ps.HALO``.

The JAX backend's other engines and layouts (resident, megakernel, packed,
lane-fold, bf16 storage, the naive fix-up modes) are not ported yet: asking
for one raises :class:`UnsupportedConfigError`.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from grayscott_tpu.errors import UnsupportedConfigError

from ..ops import windowed
from ..params import Parameters, kernel_constants
from .base import Simulation

#: knob -> the values the port runs (the JAX backend's names and values)
_SUPPORTED = {
    "engine": ("auto", "windowed"),
    "dtype": ("float32",),
    "fold": ("auto", "off", 1),
    "pack": ("auto", "off"),
    "naive_fix": ("select",),
}


class CudaSimulation(Simulation):
    name = "cuda"

    def __init__(self, params: Parameters, boundary: str = "naive",
                 device: str | torch.device = "cuda", engine: str = "auto",
                 dtype: str = "float32", fold: str | int = "auto",
                 pack: str = "auto", naive_fix: str = "select"):
        super().__init__(params, boundary, device)
        knobs = dict(engine=engine, dtype=dtype, fold=fold, pack=pack,
                     naive_fix=naive_fix)
        for knob, value in knobs.items():
            if value not in _SUPPORTED[knob]:
                raise UnsupportedConfigError(
                    f"{knob}={value!r} is not ported to the cuda backend "
                    f"yet; it runs {knob} in {_SUPPORTED[knob]}",
                    combo=knob)
        self.consts = kernel_constants(params)

    def build_storage(self, u: np.ndarray, v: np.ndarray):
        u_t, v_t = (
            torch.from_numpy(np.array(x, dtype=np.float32, order="C"))
            .to(self.device) for x in (u, v))
        return ("windowed", u_t, v_t, torch.empty_like(u_t),
                torch.empty_like(v_t))

    def extract_uv(self, storage, shape) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
        return storage[1], storage[2]

    def run_steps(self, storage, shape, steps: int):
        _, u, v, u_next, v_next = storage
        n_full, rem = divmod(steps, windowed.K)
        for k in [windowed.K] * n_full + ([rem] if rem else []):
            windowed.multistep(u, v, u_next, v_next, k, self.consts,
                               self.boundary)
            u, v, u_next, v_next = u_next, v_next, u, v
        return ("windowed", u, v, u_next, v_next)
