"""``sharded`` backend: the domain cut into a mesh of shards, stepped by the
sharded megakernel K7 (``ops/sharded_mega.py``). The port of the mega
engine of ``grayscott_tpu/backends/sharded.py``.

The storage is ``("shmega", u_pairs, v_pairs)`` on a 1-D row mesh and
``("shmega2d", u_pairs, v_pairs)`` on a 2-D mesh, the pairs in the layout of
``parallel/halo.py``. ``run_steps`` fills slot 0's halos
(``halo.exchange_halos``) and makes one launch of ``steps // 8`` time
blocks, then the same for one block of the remainder
(``sharded_mega.launch_plan``). The mesh is ``n_devices`` shards in
``mesh_cols`` columns, or, with ``mesh_cols`` None, the columns that
``halo.choose_mesh_cols`` picks for the first domain built, as in JAX.
Every shard lives on ``device``: one card runs them all in one launch.

What JAX's backend runs besides and the port does not yet raises
:class:`UnsupportedConfigError` naming its ROADMAP item, and nothing falls
back: the windowed engine (``engine="windowed"``, and ``engine="auto"``,
which falls back to it), bf16 storage, the tile pins, overlap and
autotune records.
"""

from __future__ import annotations

import argparse
from typing import Tuple

import numpy as np
import torch

from ..errors import UnsupportedConfigError
from ..ops import sharded_mega
from ..parallel import halo
from ..params import Parameters, kernel_constants
from .base import Simulation, env_default

ENGINES = ("auto", "windowed", "mega")
OVERLAP = ("auto", "on", "off")

_WINDOWED = ("ROADMAP.md Queue 1 item 7: the windowed sharded engine over "
             "torch.distributed")


class ShardedSimulation(Simulation):
    name = "sharded"

    def __init__(self, params: Parameters, boundary: str = "naive",
                 device: str | torch.device = "cuda",
                 n_devices: int | None = None, mesh_cols: int | None = None,
                 block_rows: int | None = None,
                 block_cols: int | None = None,
                 steps_per_call: int | None = None, dtype: str = "float32",
                 overlap: bool | str = "auto", engine: str = "auto",
                 tuned_lookup: bool = False):
        super().__init__(params, boundary, device)
        if engine not in ENGINES:
            raise ValueError(f"engine must be auto/windowed/mega, got "
                             f"{engine!r}")
        if isinstance(overlap, str) and overlap not in OVERLAP:
            raise ValueError(f"overlap must be auto/on/off or bool, got "
                             f"{overlap!r}")
        if engine != "mega":
            raise UnsupportedConfigError(
                f"sharded engine={engine!r} runs the windowed engine, which "
                f"is not ported yet ({_WINDOWED}); pin engine='mega'",
                combo="engine")
        if overlap in ("on", True):
            raise UnsupportedConfigError(
                "engine='mega' overlaps exchange with interior compute "
                "in-kernel; --sharded-overlap applies to the windowed "
                f"engine ({_WINDOWED})", combo="overlap")
        if steps_per_call not in (None, sharded_mega.MEGA_STEPS):
            raise UnsupportedConfigError(
                "engine='mega' fixes steps-per-call at its exchange depth "
                f"K={sharded_mega.MEGA_STEPS}; drop --pallas-steps-per-call",
                combo="steps_per_call")
        if dtype not in ("float32", "f32", None):
            raise UnsupportedConfigError(
                f"dtype={dtype!r}: bf16 storage is not ported yet "
                "(ROADMAP.md Queue 1 item 7)", combo="dtype")
        if block_rows is not None or block_cols is not None:
            raise UnsupportedConfigError(
                "the tile pins (block_rows, block_cols) are not ported yet "
                "(ROADMAP.md Queue 1 item 7); K7's tiles are 32x32",
                combo="tiles")
        if tuned_lookup:
            raise UnsupportedConfigError(
                "autotune records are not ported yet (ROADMAP.md Queue 1 "
                "item 4)", combo="tuned_lookup")
        if n_devices is not None and n_devices < 1:
            raise UnsupportedConfigError(
                f"n_devices must be >= 1, got {n_devices} (omit the flag "
                "to use every device)")
        if mesh_cols is not None and mesh_cols < 1:
            raise UnsupportedConfigError(
                f"mesh_cols must be >= 1, got {mesh_cols} (omit the flag "
                "for automatic factorization)")
        self.engine = engine
        self.consts = kernel_constants(params)
        self._n_devices = n_devices
        self.mesh = (None if mesh_cols is None
                     else halo.make_mesh(n_devices, mesh_cols, self.device))

    def _resolve_mesh(self, shape) -> halo.Mesh:
        """The mesh, chosen for the first domain built when no column
        count was pinned, and kept after."""
        if self.mesh is None:
            n = self._n_devices or halo.visible_cards(self.device)
            self.mesh = halo.make_mesh(n, halo.choose_mesh_cols(n, shape),
                                       self.device)
        return self.mesh

    def build_storage(self, u: np.ndarray, v: np.ndarray):
        mesh = self._resolve_mesh(u.shape)
        up, vp = halo.mega_shard_state(u, v, mesh)
        return ("shmega" if mesh.n_cols == 1 else "shmega2d", up, vp)

    def extract_uv(self, storage, shape) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
        return (halo.mega_unshard_result(storage[1], shape),
                halo.mega_unshard_result(storage[2], shape))

    def extract_result(self, storage, shape) -> torch.Tensor:
        return halo.mega_unshard_result(storage[2], shape)

    def run_steps(self, storage, shape, steps: int):
        _, up, vp = storage
        for n_blocks, k in sharded_mega.launch_plan(steps):
            # slot 0 enters with the halos of the last call or none; one
            # exchange makes them valid for the first time block
            # (grayscott_tpu/parallel/halo.py:530-537, :602-613)
            halo.exchange_halos(up)
            halo.exchange_halos(vp)
            sharded_mega.sharded_megastep(up, vp, self.mesh, n_blocks, k,
                                          self.consts, self.boundary, shape)
        return storage

    # -- CLI -----------------------------------------------------------------

    @classmethod
    def add_cli_args(cls, parser: argparse.ArgumentParser) -> None:
        """The JAX backend's flags, under its names and environment
        variables."""
        parser.add_argument(
            "--sharded-engine", choices=ENGINES,
            default=env_default("GRAYSCOTT_SHARDED_ENGINE", "auto",
                                choices=ENGINES),
            help="Multi-shard engine: 'mega' runs the whole step loop in "
            "one launch for all shards, with the halo exchange inside the "
            "kernel (K7; 1-D row meshes, or 8 directions on "
            "--sharded-mesh-cols > 1). 'windowed' and 'auto' (default; "
            "JAX falls back to windowed) are not ported yet",
        )
        parser.add_argument(
            "--sharded-devices", type=int,
            default=env_default("GRAYSCOTT_SHARDED_DEVICES", None, int),
            help="Number of shards in the mesh (default: one per visible "
            "card); more than the cards share a card",
        )
        parser.add_argument(
            "--sharded-mesh-cols", type=int,
            default=env_default("GRAYSCOTT_SHARDED_MESH_COLS", None, int),
            help="Mesh columns for 2-D spatial decomposition (default: "
            "auto — the (rows, cols) factorization minimizing per-shard "
            "halo exchange for the domain geometry, 1-D preferred; 1 "
            "forces row sharding only)",
        )
        parser.add_argument(
            "--sharded-overlap", choices=OVERLAP,
            default=env_default("GRAYSCOTT_SHARDED_OVERLAP", "auto",
                                choices=OVERLAP),
            help="Overlap of the halo exchange with interior compute in "
            "the windowed engine (not ported); 'on' raises with the mega "
            "engine, 'auto' (default) and 'off' run it",
        )

    @classmethod
    def args_from_namespace(cls, ns: argparse.Namespace) -> dict:
        return {
            "n_devices": getattr(ns, "sharded_devices", None),
            "mesh_cols": getattr(ns, "sharded_mesh_cols", None),
            "overlap": getattr(ns, "sharded_overlap", "auto"),
            "engine": getattr(ns, "sharded_engine", "auto"),
        }
