"""``sharded`` backend: the domain cut into a mesh of shards. The port of
``grayscott_tpu/backends/sharded.py`` and its two engines.

- ``windowed`` (K1 on the shard layout, ``ops/windowed.py:
  shard_multistep``): storage ``("shwin", u_pairs, v_pairs, slot, (K,
  tiles))`` on a 1-D row mesh and ``("shwin2d", ...)`` on a 2-D mesh, the
  pairs in the layout of ``parallel/halo.py`` at a halo of
  ``halo_for_steps(K)`` rows (and columns on a 2-D mesh, as JAX's
  ``chalo``), ``slot`` the current one, and the tiles
  ``ops/geometry.py:resolve`` gives each shard under the row-tile pin.
  ``run_steps`` makes ``divmod(steps, K)`` blocks, as ``sharded_run_blocks``
  does (``grayscott_tpu/parallel/halo.py:305-317``): each fills the halos
  of the current slot (``halo.exchange_halos``), makes one K1 launch over
  every shard into the other slot, and flips the slot. With ``overlap``
  on, a block where the split engages (``halo.overlap_engages``) makes two
  launches instead: the exchange runs on a copy stream of the
  simulation's own, after the launch stream's work, while the
  overlap-interior tiles, whose windows read no halo cell, step on the
  launch stream; the edge tiles step once the exchange is done. The two
  launches write disjoint cells, so the result equals the serialized one
  bit for bit. Where the split does not engage the block runs serialized,
  as in JAX.
- ``mega`` (K7, ``ops/sharded_mega.py``): storage ``("shmega", u_pairs,
  v_pairs, tiles)`` (``"shmega2d"`` on a 2-D mesh), slot 0 current, the
  tiles None (``sharded_mega.choose_tile`` picks 64x64 or 32x32) or those
  of the tile pins. ``run_steps`` fills slot 0's halos and makes one
  launch of ``steps // 8`` time blocks, then the same for one block of the
  remainder (``sharded_mega.launch_plan``).

The K and tile pins, as JAX's sharded backend takes them
(``grayscott_tpu/backends/sharded.py:86-139``, ``:263-364``): the windowed
engine runs any K in 1..32 (else JAX's ``ValueError``) and a row tile
(``block_rows``; ``block_cols`` raises JAX's refusal), bf16 storage
rounding once a K-step block; K7 keeps K = 8 (another raises JAX's
refusal) and takes ``block_rows`` (a positive multiple of 8) and
``block_cols`` (a positive multiple of 128: at least the domain's width is
unpinned on a row mesh, one tile column across the shard on a 2-D mesh),
else JAX's refusals when the storage is built. A window past the shared
memory a block may use raises naming its bytes, and so does a layout whose
shards are thinner than their halo (``halo.thin_shard``: JAX's exchange
does not check it, and its result turns to NaN there). The frames do not
depend on the tiles, nor, in float32, on K.

``engine="auto"`` (the default) and ``overlap="auto"`` follow the sharded
autotune record of the configuration (``bench/autotune.py:
sharded_lookup``: the store, else the records ``bench/defaults.py``
ships), as ``_adopt_record`` does in JAX (``:159-229``): pins always win,
a record fills in only what is left on ``auto``, and its overlap verdict
transfers only to the record's engine and mesh. Without a record ``auto``
runs ``windowed`` with overlap off. ``tuned_lookup=False`` ignores the
records (the tuner measures each candidate so). The mesh is ``n_devices``
shards in ``mesh_cols`` columns, or, with ``mesh_cols`` None, the record's
columns, else those ``halo.choose_mesh_cols`` picks for the first domain
built, as in JAX. Every shard lives on ``device``: one card runs them all.

``dtype="bfloat16"`` stores every shard's pairs in bfloat16, on both
engines and with ``overlap`` on or off, as JAX's sharded backend does:
each block of at most 8 steps runs in float32 and rounds its stored cells
once, before the exchange moves them, so both engines and the unsharded
``cuda`` backend agree bit for bit. Records key on the dtype.

With several processes (``GRAYSCOTT_COORDINATOR``,
``utils/distributed.py``) the mesh spans them: ``n_devices`` is the
global shard count (default: the processes times the cards each sees, so
2 for two processes on one card), each process holds its block of shards
(``parallel/halo.py``; a count the processes do not divide, or a split
into no rectangle, raises), K1's shard entry steps the block at its place
in the mesh, and ``halo.exchange`` sends the bands that cross processes
over gloo. ``extract_result`` gives this process's block, and
:meth:`blocks` tells ``utils/distributed.py:fetch`` how to assemble the
domain. The windowed engine runs every K, row tile, dtype and overlap
value it runs in one process, bit for bit; with overlap on, the interior
launch runs while the host moves the bands across processes, and the
edge launch waits for them. K7 (one launch over every shard on one card)
raises naming ROADMAP.md Queue 1 item 7.3, and a record that names it runs
the windowed engine.

Nothing falls back: what the port does not run raises
:class:`UnsupportedConfigError`.
"""

from __future__ import annotations

import argparse
import logging
from typing import Tuple

import numpy as np
import torch

from ..errors import UnsupportedConfigError
from ..ops import geometry, sharded_mega, windowed
from ..parallel import halo
from ..params import Parameters, kernel_constants
from ..utils import distributed
from .base import Simulation, env_default, storage_dtype

ENGINES = ("auto", "windowed", "mega")
OVERLAP = ("auto", "on", "off")

#: the depth of a block of either engine where K is not pinned, and K7's
#: only one
K = windowed.K

#: (engine, 2-D mesh) -> storage tag
TAGS = {("windowed", False): "shwin", ("windowed", True): "shwin2d",
        ("mega", False): "shmega", ("mega", True): "shmega2d"}

_logger = logging.getLogger("grayscott_tpu_torch")


class ShardedSimulation(Simulation):
    name = "sharded"
    #: extract_result reassembles the shards into a new tensor
    fresh_result = True

    def __init__(self, params: Parameters, boundary: str = "naive",
                 device: str | torch.device = "cuda",
                 n_devices: int | None = None, mesh_cols: int | None = None,
                 block_rows: int | None = None,
                 block_cols: int | None = None,
                 steps_per_call: int | None = None, dtype: str = "float32",
                 overlap: bool | str = "auto", engine: str = "auto",
                 tuned_lookup: bool = True):
        super().__init__(params, boundary, device)
        if engine not in ENGINES:
            raise ValueError(f"engine must be auto/windowed/mega, got "
                             f"{engine!r}")
        if isinstance(overlap, str):
            if overlap not in OVERLAP:
                raise ValueError(f"overlap must be auto/on/off or bool, got "
                                 f"{overlap!r}")
            overlap = "auto" if overlap == "auto" else overlap == "on"
        else:
            overlap = bool(overlap)
        #: the processes the mesh spans
        self.processes = distributed.process_count()
        if engine == "mega" and self.processes > 1:
            raise UnsupportedConfigError(
                f"engine='mega' (K7) runs every shard in one launch on one "
                f"card; across {self.processes} processes it waits for "
                "ROADMAP.md Queue 1 item 7.3 (K7 on several cards); use "
                "--sharded-engine windowed", combo="engine+distributed")
        if engine == "mega" and overlap is True:
            raise UnsupportedConfigError(
                "engine='mega' overlaps exchange with interior compute "
                "in-kernel; --sharded-overlap applies to the windowed "
                "engine", combo="overlap")
        if engine == "mega" and steps_per_call not in (None, K):
            # grayscott_tpu/backends/sharded.py:99-104
            raise UnsupportedConfigError(
                "engine='mega' fixes steps-per-call at its exchange depth "
                f"K={K}; drop --pallas-steps-per-call",
                combo="engine+steps_per_call")
        #: the storage dtype, by name and torch's
        self.dtype = storage_dtype(dtype)
        self.storage_dtype = getattr(torch, self.dtype)
        if block_cols is not None and engine != "mega":
            # grayscott_tpu/backends/sharded.py:106-111
            raise UnsupportedConfigError(
                "--pallas-block-cols pins the megakernel's column tile; "
                "the windowed sharded engine derives its own column "
                "layout (2-D meshes shard columns instead)",
                combo="block_cols")
        if steps_per_call is not None:
            geometry.check_steps_per_call(steps_per_call)
        for name, value in (("block_rows", block_rows),
                            ("block_cols", block_cols)):
            if value is not None and (isinstance(value, bool)
                                      or not isinstance(value, int)):
                raise ValueError(f"{name} must be an int, got {value!r}")
        if n_devices is not None and n_devices < 1:
            raise UnsupportedConfigError(
                f"n_devices must be >= 1, got {n_devices} (omit the flag "
                "to use every device)")
        if mesh_cols is not None and mesh_cols < 1:
            raise UnsupportedConfigError(
                f"mesh_cols must be >= 1, got {mesh_cols} (omit the flag "
                "for automatic factorization)")
        self._engine_req = engine
        self._overlap_req = overlap
        self._k_pin = steps_per_call
        #: the tile pins, and the tiles that run (the pins, then what a
        #: record of the same engine, mesh and K fills in)
        self.block_rows = block_rows
        self.block_cols = block_cols
        self.tile_rows = block_rows
        self.tile_cols = block_cols
        #: the windowed engine's K (K7 runs 8)
        self.steps_per_call = K if steps_per_call is None else steps_per_call
        self.engine = "windowed" if engine == "auto" else engine
        self.overlap = overlap is True
        self.tuned_lookup = tuned_lookup
        self.consts = kernel_constants(params)
        self._n_devices = n_devices
        self._mesh_cols_pin = mesh_cols
        self._adopted = False
        self._copy_stream = None
        self._serial_logged = False
        self.mesh = (None if mesh_cols is None
                     else halo.make_mesh(n_devices, mesh_cols, self.device))

    def _shards(self) -> int:
        return self._n_devices or halo.default_shards(self.device)

    def _adopt_record(self, shape) -> None:
        """Follow the sharded autotune record of this configuration in
        every knob left on ``auto`` (``grayscott_tpu/backends/sharded.py:
        159-229``): the engine (not ``mega`` under a pinned overlap, nor
        under a pinned K other than 8), the mesh when none was pinned, and
        the geometry verdicts only when this simulation runs the record's
        engine on the record's mesh: the windowed engine's K where K is not
        pinned, overlap where it is on ``auto``, and the record's tiles
        where they are not pinned and the record's K is the run's (a tile
        measured at another K does not transfer: ADVICE.md, round 5, #2).
        Latched on the first ``build_storage``, like the mesh."""
        if self._adopted:
            return
        self._adopted = True
        if not self.tuned_lookup:
            return
        from ..bench import autotune

        rec = autotune.sharded_lookup(
            self.params, shape, self.boundary, dtype=self.dtype,
            n_devices=self._shards(),
            mesh_cols=self._mesh_cols_pin,
            engine=None if self._engine_req == "auto" else self._engine_req,
            overlap=None if self._overlap_req == "auto"
            else self._overlap_req,
            steps_per_call=self._k_pin, block_rows=self.block_rows,
            block_cols=self.block_cols, device=self.device)
        if not rec:
            return
        eng = rec.get("engine")
        if self._engine_req == "auto" and eng in ENGINES[1:] and not (
                eng == "mega" and (self._overlap_req is True or
                                   self._k_pin not in (None, K) or
                                   self.processes > 1)):
            self.engine = eng
        if self.mesh is None and rec.get("mesh_cols"):
            self.mesh = halo.make_mesh(self._shards(), int(rec["mesh_cols"]),
                                       self.device)
        if eng != self.engine or int(rec.get("mesh_cols") or 1) != \
                self._resolve_mesh(shape).n_cols:
            return
        if self.engine == "windowed" and self._k_pin is None:
            tk = rec.get("steps_per_call")
            if tk and 1 <= int(tk) <= geometry.MAX_STEPS_PER_CALL:
                self.steps_per_call = int(tk)
        run_k = self.steps_per_call if self.engine == "windowed" else K
        if int(rec.get("steps_per_call") or K) == run_k:
            if self.tile_rows is None and rec.get("block_rows"):
                self.tile_rows = int(rec["block_rows"])
            if self.engine == "mega" and self.tile_cols is None and \
                    rec.get("block_cols"):
                self.tile_cols = int(rec["block_cols"])
        if self._overlap_req == "auto" and self.engine == "windowed":
            self.overlap = bool(rec.get("overlap"))

    def _resolve_mesh(self, shape) -> halo.Mesh:
        """The mesh, chosen for the first domain built when no column
        count was pinned, and kept after."""
        if self.mesh is None:
            n = self._shards()
            self.mesh = halo.make_mesh(n, halo.choose_mesh_cols(n, shape),
                                       self.device)
        return self.mesh

    def windowed_plan(self, shape) -> Tuple[int, "geometry.Geometry"]:
        """(K, tiles) of the windowed engine on a domain of ``shape``: the
        K (pinned, adopted, else 8) and each shard's tiles at its halo
        (``geometry.resolve`` of the shard under the row-tile pin)."""
        mesh = self._resolve_mesh(shape)
        r_loc, c_loc = halo.shard_extents(shape, mesh)
        k = self.steps_per_call
        return k, geometry.resolve((r_loc, c_loc), k, self.tile_rows, None)

    def mega_tiles(self, shape) -> "geometry.Geometry | None":
        """K7's tiles on a domain of ``shape`` under the tile pins (and a
        record's): None where neither is pinned (``sharded_mega.
        choose_tile`` picks), else ``geometry.mega_resolve`` of a shard;
        JAX's refusals of the values its K7 does not take
        (``grayscott_tpu/backends/sharded.py:354-364``)."""
        tr, tc = self.tile_rows, self.tile_cols
        if tr is not None and (tr < 8 or tr % 8):
            raise UnsupportedConfigError(
                "engine='mega' needs block_rows as a positive multiple of "
                f"8, got {tr}", combo="engine+tiles")
        if tc is not None and (tc < 128 or tc % 128):
            raise UnsupportedConfigError(
                "engine='mega' needs block_cols as a positive multiple of "
                f"128, got {tc}", combo="engine+tiles")
        if (tr, tc) == (None, None):
            return None
        mesh = self._resolve_mesh(shape)
        r_loc, c_loc = halo.shard_extents(shape, mesh)
        if mesh.n_cols == 1 and tc is not None and tc >= shape[1]:
            tc = None  # grayscott_tpu/backends/sharded.py:285-286
            if tr is None:
                return None
        return geometry.mega_resolve((r_loc, c_loc), tr, tc,
                                     cover=mesh.n_cols > 1)

    def overlap_runs(self, shape) -> bool:
        """Whether a windowed block of a domain of ``shape`` runs the
        overlap split: overlap on, the windowed engine, and the split
        engages on the mesh's shards at their tiles and halo."""
        if self.engine != "windowed" or not self.overlap:
            return False
        mesh = self._resolve_mesh(shape)
        r_loc, c_loc = halo.shard_extents(shape, mesh)
        _, g = self.windowed_plan(shape)
        return halo.overlap_engages(r_loc, c_loc, mesh.n_cols,
                                    (g.tr, g.tc), g.halo)

    def build_storage(self, u: np.ndarray, v: np.ndarray):
        self._adopt_record(u.shape)
        mesh = self._resolve_mesh(u.shape)
        tag = TAGS[self.engine, mesh.n_cols > 1]
        if self.engine == "mega":
            tiles = self.mega_tiles(u.shape)
            self.mesh = mesh.with_halo(halo.HALO)
            up, vp = halo.mega_shard_state(u, v, self.mesh,
                                           self.storage_dtype)
            return (tag, up, vp, tiles)
        plan = self.windowed_plan(u.shape)
        self.mesh = mesh.with_halo(plan[1].halo)
        thin = halo.thin_shard(u.shape, self.mesh)
        if thin:
            raise UnsupportedConfigError(
                f"{thin} (steps_per_call={plan[0]} on a {self.mesh.n_rows}x"
                f"{self.mesh.n_cols} mesh): a shard fills its neighbours' "
                "halos from its own interior; use fewer shards or a smaller "
                "--pallas-steps-per-call", combo="steps_per_call+shards")
        up, vp = halo.mega_shard_state(u, v, self.mesh, self.storage_dtype)
        return (tag, up, vp, 0, plan)

    @staticmethod
    def _windowed(storage) -> bool:
        return storage[0].startswith("shwin")

    def _slot_halo(self, storage) -> Tuple[int, int]:
        """(current slot, the layout's halo) of ``storage``."""
        if self._windowed(storage):
            return storage[3], storage[4][1].halo
        return 0, halo.HALO

    def _unshard(self, pairs, storage, shape) -> torch.Tensor:
        """The current slot's interiors of ``pairs``, cropped to ``shape``;
        with several processes this process's block, uncropped."""
        slot, h = self._slot_halo(storage)
        if self.processes > 1:
            return halo.mega_unshard_result(pairs, None, slot,
                                            self.mesh.with_halo(h))
        return halo.mega_unshard_result(pairs, shape, slot, h)

    def extract_uv(self, storage, shape) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
        return (self._unshard(storage[1], storage, shape),
                self._unshard(storage[2], storage, shape))

    def extract_result(self, storage, shape) -> torch.Tensor:
        return self._unshard(storage[2], storage, shape)

    def blocks(self, shape):
        return self.mesh.blocks(shape)

    def run_steps(self, storage, shape, steps: int):
        if self._windowed(storage):
            return self._run_windowed(storage, shape, steps)
        _, up, vp, tiles = storage
        for n_blocks, k in sharded_mega.launch_plan(steps):
            # slot 0 enters with the halos of the last call or none; one
            # exchange makes them valid for the first time block
            # (grayscott_tpu/parallel/halo.py:530-537, :602-613)
            halo.exchange_halos(up)
            halo.exchange_halos(vp)
            sharded_mega.sharded_megastep(up, vp, self.mesh, n_blocks, k,
                                          self.consts, self.boundary, shape,
                                          geometry=tiles)
        return storage

    def _run_windowed(self, storage, shape, steps: int):
        tag, up, vp, slot, plan = storage
        k_max, g = plan
        split = self.overlap_runs(shape)
        if self.overlap and not split and not self._serial_logged:
            self._serial_logged = True
            _logger.info("sharded windowed: no overlap-interior tile on "
                         "%s shards of %s; the blocks run serialized",
                         self.mesh.shape, tuple(shape))
        n_full, rem = divmod(steps, k_max)
        for k in [k_max] * n_full + ([rem] if rem else []):
            if split:
                self._overlapped_block(up, vp, slot, k, shape, g)
            else:
                halo.exchange(self.mesh, (up, vp), slot)
                windowed.shard_multistep(up, vp, self.mesh, slot, k,
                                         self.consts, self.boundary, shape,
                                         geometry=g)
            slot = 1 - slot
        return (tag, up, vp, slot, plan)

    def _overlapped_block(self, up, vp, slot: int, k: int, shape,
                          g: "geometry.Geometry") -> None:
        """One block split as ``body_overlap`` and ``body_overlap2d`` split
        it (``grayscott_tpu/parallel/halo.py:319-457``): the exchange of
        ``slot`` beside the overlap-interior launch, then the edge launch,
        on the tiles and halo of ``g``. On the CPU the three run in
        order. With several processes the interior launch is enqueued
        first: the exchange's host waits for the bands it sends, and the
        edge launch waits for what it received."""
        args = (self.mesh, slot, k, self.consts, self.boundary, shape)
        if self.device.type != "cuda":
            halo.exchange(self.mesh, (up, vp), slot)
            windowed.shard_multistep(up, vp, *args, part="interior",
                                     geometry=g)
            windowed.shard_multistep(up, vp, *args, part="edge", geometry=g)
            return
        launch = torch.cuda.current_stream(self.device)
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        copy = self._copy_stream
        # the exchange reads the interiors the last block wrote; the pairs
        # were made on the launch stream, and the copies allocate nothing
        # but the staging of the bands that cross processes
        copy.wait_stream(launch)
        if self.processes > 1:
            windowed.shard_multistep(up, vp, *args, part="interior",
                                     geometry=g)
        with torch.cuda.stream(copy):
            halo.exchange(self.mesh, (up, vp), slot)
        if self.processes == 1:
            windowed.shard_multistep(up, vp, *args, part="interior",
                                     geometry=g)
        launch.wait_stream(copy)
        windowed.shard_multistep(up, vp, *args, part="edge", geometry=g)

    # -- CLI -----------------------------------------------------------------

    @classmethod
    def add_cli_args(cls, parser: argparse.ArgumentParser) -> None:
        """The JAX backend's flags, under its names and environment
        variables."""
        parser.add_argument(
            "--sharded-engine", choices=ENGINES,
            default=env_default("GRAYSCOTT_SHARDED_ENGINE", "auto",
                                choices=ENGINES),
            help="Multi-shard engine: 'windowed' fills the halos between "
            "K1 launches over every shard, K steps a launch (8, or "
            "--pallas-steps-per-call 1..32; --pallas-block-rows pins its "
            "row tile); 'mega' runs "
            "the whole step loop in one launch for all shards, with the "
            "halo exchange inside the kernel (K7; 1-D row meshes, or 8 "
            "directions on --sharded-mesh-cols > 1; K = 8, its tiles pinned "
            "by --pallas-block-rows and --pallas-block-cols). 'auto' "
            "(default) follows a --autotune record for this configuration "
            "and falls back to windowed",
        )
        parser.add_argument(
            "--sharded-devices", type=int,
            default=env_default("GRAYSCOTT_SHARDED_DEVICES", None, int),
            help="Number of shards in the mesh (default: one per visible "
            "card, in every process of a GRAYSCOTT_COORDINATOR run); more "
            "than the cards share a card",
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
            help="Overlap the halo exchange with interior compute by "
            "splitting each block of the windowed engine into two "
            "launches: the tiles whose windows read no halo, beside the "
            "exchange on a copy stream, then the rest (bitwise the "
            "serialized run; where a shard has no such tile, serialized). "
            "'on' raises with the mega engine; 'auto' (default) follows a "
            "--autotune record and falls back to off",
        )

    @classmethod
    def args_from_namespace(cls, ns: argparse.Namespace) -> dict:
        return {
            "n_devices": getattr(ns, "sharded_devices", None),
            "mesh_cols": getattr(ns, "sharded_mesh_cols", None),
            "block_rows": getattr(ns, "pallas_block_rows", None),
            "block_cols": getattr(ns, "pallas_block_cols", None),
            "steps_per_call": getattr(ns, "pallas_steps_per_call", None),
            "dtype": getattr(ns, "pallas_dtype", "float32"),
            "overlap": getattr(ns, "sharded_overlap", "auto"),
            "engine": getattr(ns, "sharded_engine", "auto"),
        }
