"""Kernel autotuner: the port of ``grayscott_tpu/bench/autotune.py``, cut
to what the port's kernels run. It measures the ``cuda`` backend's engines
and layouts on the live device and persists the winner per (device,
domain, boundary, stencil, dtype) in the autotune store
(``utils/cache.py``); the backend's ``auto`` modes follow it
(``backends/cuda.py:CudaSimulation.layout_for``).

The candidates are every engine and layout the configuration runs: K1
(``engine="windowed"``), K2 (``engine="mega"``) and K3
(``resident="on"``) unpacked, and, on the zero boundary with float32 and a
separable stencil (JAX's ``_pack_candidates`` conditions), the same three
packed: K4, K6 and K5. With bf16 storage only K1 and K2 are candidates
(JAX's ``_engine_candidates``: the resident kernel and the packed layout
are float32-only), and the record keys on ``:bfloat16``, so a bf16 run
never follows a float32 record, nor the reverse. Beside K1's default
(K = 8 on 64x64 tiles) K1 also runs at K = 16 and on 32x128 and 128x32
tiles (``WINDOWED_EXTRA``), and K4 at K = 16 and on 32-row tiles
(``PACKED_EXTRA``: JAX's packed kernel takes a row tile and K, no column
tile), the port's counterpart of JAX's ``(block_rows, steps_per_call)``
candidates (``grayscott_tpu/bench/autotune.py:38-58``), and K2 on half
its row tile and on twice its column tile (``MEGA_EXTRA``: JAX's
megakernel tile variants, ``:185-214``, mapped onto the port's 64x64
tiles: the half row tile, and the double-width column tile where it is
narrower than the domain; JAX's full-width form has no counterpart, a
tile in shared memory cannot span a row, nor has its 1.3 row-halo bound,
which measures full-width windows). On the card, and on the float32
storage of a domain narrower than ``lane_fold.FOLD_TARGET_LANES``, K1
also runs folded (:func:`fold_candidates`: JAX's ``_fold_candidates``,
``:165-174``, ``choose_fold``'s F at K = 16 and K = 8; not on the naive
boundary with ``C % 128 != 0``), and every record keeps the ``fold`` it
ran (1 unfolded), which ``auto`` follows (``backends/cuda.py:
CudaSimulation.fold_for``). A record carries the K it ran
(``steps_per_call``) and the tile pins it ran (``block_rows``,
``block_cols``; None where the candidate left the tile to
``ops/geometry.py``'s default), which the backend adopts where the run
does not pin them (``backends/cuda.py:CudaSimulation.plan_for``,
``mega_plan_for``). A K or
tile pin restricts the candidates to K1 under that pin, at K 8 and 16 and
on the three tile shapes where unpinned, and keys the record on the pins
(:func:`key_for`), so that a record measured under a pin steers only runs
under the same pins (ADVICE.md #2, #3).

The sharded backend has a tuner of its own (:func:`sharded_autotune`, the
port of JAX's ``:556-818``), whose records key on the shard count and the
pins as well (:func:`sharded_key`) and which ``ShardedSimulation`` follows
through :func:`sharded_lookup`.

Each candidate runs with ``tuned_lookup=False`` (exactly what it pins).
On the card the candidates rank on device time (CUDA events around
``run_steps``, the best of ``reps``), with the wall rate (host clock
ending in a synchronise) kept beside it; on the CPU, where there is no
device time, on the wall rate, through the kernels' plain versions, and
such a record keys on ``cpu`` and never reaches the card. As in JAX the
ranking is on speed alone: the drift of the packed layout from the oracle
is ``scripts/parity_check.py``'s to check, not the tuner's to weigh.
"""

from __future__ import annotations

import time
from typing import Iterable, Mapping

import torch

from ..backends.cuda import K, CudaSimulation
from ..backends.sharded import ShardedSimulation
from ..errors import UnsupportedConfigError
from ..ops import geometry, lane_fold
from ..parallel import halo
from ..params import Parameters
from ..utils import cache
from ..utils.device import autotune_platform

#: the port's kernel version in every key: bump it when a kernel's redesign
#: can change the ranking, so older records stop pinning
KERNEL_VERSION = 1

#: the unpacked candidates (K1, K2, K3) and their packed twins (K4, K6, K5)
UNPACKED = ({"engine": "windowed"}, {"engine": "mega"}, {"resident": "on"})
PACKED = tuple({"pack": "on", **c} for c in UNPACKED)
#: K1's depth and tile candidates beside its default, and K4's
WINDOWED_EXTRA = ({"engine": "windowed", "steps_per_call": 16},
                  {"engine": "windowed", "block_rows": 32,
                   "block_cols": 128},
                  {"engine": "windowed", "block_rows": 128,
                   "block_cols": 32})
PACKED_EXTRA = ({"pack": "on", "engine": "windowed", "steps_per_call": 16},
                {"pack": "on", "engine": "windowed", "block_rows": 32})
#: K2's tile candidates beside its default 64x64 (JAX's megakernel tile
#: variants, grayscott_tpu/bench/autotune.py:197-214): half the row tile,
#: and twice the column tile (a multiple of 128, as JAX's pin rule asks)
MEGA_EXTRA = ({"engine": "mega", "block_rows": 32},
              {"engine": "mega", "block_cols": 128})
#: under a K or tile pin: the depths and the tiles (block_rows, block_cols)
#: of the candidates, where the pin leaves them open
PINNED_KS = (8, 16)
PINNED_TILES = ((None, None), (32, 128), (128, 32))

#: storage tag -> (engine, packed) as a record names them
_RAN = {"windowed": ("windowed", False), "mega": ("mega", False),
        "resident": ("resident", False), "packed": ("windowed", True),
        "megapack": ("mega", True), "respack": ("resident", True),
        "folded": ("windowed", False)}

#: fixed work a measurement: the same steps for every candidate
STEPS = 1024

#: the runner-up within this share of the winner is measured again
RECHECK = 0.97

#: measure_config and measure_sharded_config calls made (a second
#: ``--autotune`` of a domain makes none)
measurements = 0


def default_candidates(params: Parameters, boundary: str,
                       dtype: str = "float32", shape=None,
                       steps_per_call: int | None = None,
                       block_rows: int | None = None,
                       block_cols: int | None = None,
                       device: str | torch.device = "cpu") -> list[dict]:
    """Every engine and layout of ``(params, boundary, dtype)``: the three
    unpacked engines (K1 and K2 alone with bf16 storage, which K3 refuses:
    JAX's ``_engine_candidates``) and K1's depth and tile candidates, and
    the three packed ones and K4's where JAX's ``_pack_candidates`` would
    pack (zero boundary, float32, a separable plan); on a CUDA ``device``
    K1 folded (:func:`fold_candidates`), as JAX tries the fold on the TPU
    only (``:419-426``). Under a K or tile pin (:func:`pinned_candidates`),
    K1 alone under it."""
    if (steps_per_call, block_rows, block_cols) != (None, None, None):
        return pinned_candidates(shape, steps_per_call, block_rows,
                                 block_cols)
    mega = mega_candidates(shape)
    if dtype != "float32":
        return [dict(c) for c in (*UNPACKED, *WINDOWED_EXTRA, *mega)
                if "engine" in c]
    out = [dict(c) for c in (*UNPACKED, *WINDOWED_EXTRA, *mega)]
    if boundary == "zero" and dtype == "float32" and \
            params.separable_plan()[0] == "separable":
        out += [dict(c) for c in (*PACKED, *PACKED_EXTRA)]
    if shape is not None and torch.device(device).type == "cuda":
        out += fold_candidates(shape, boundary, dtype)
    return out


def fold_candidates(shape, boundary: str, dtype: str) -> list[dict]:
    """K1 folded (JAX's ``_fold_candidates``, ``grayscott_tpu/bench/
    autotune.py:165-174``): ``choose_fold``'s F at K = 16 and K = 8, on
    float32 storage, none where F is 1 or on the naive boundary with
    ``C % 128 != 0``."""
    r, c = shape
    if dtype != "float32":
        return []
    f = lane_fold.choose_fold(r, c)
    if f <= 1 or (boundary == "naive" and c % 128 != 0):
        return []
    return [dict(fold=f, steps_per_call=16), dict(fold=f, steps_per_call=8)]


def mega_candidates(shape=None) -> list[dict]:
    """The entries of MEGA_EXTRA that differ from K2's default tiles on
    ``shape`` and fit (``geometry.mega_resolve``): the half row tile where
    the domain is taller than it, the double-width column tile where the
    domain is wider than it (JAX: ``2 * tc < c``); both where ``shape`` is
    None."""
    out = []
    for cfg in MEGA_EXTRA:
        tr, tc = cfg.get("block_rows"), cfg.get("block_cols")
        if shape is not None:
            rows, cols = shape
            if (tr is not None and tr >= rows) or \
                    (tc is not None and tc >= cols):
                continue
            try:
                geometry.mega_resolve(tuple(shape), tr, tc)
            except UnsupportedConfigError:
                continue
        out.append(dict(cfg))
    return out


def pinned_candidates(shape, steps_per_call: int | None = None,
                      block_rows: int | None = None,
                      block_cols: int | None = None) -> list[dict]:
    """K1 under the pins: at each of PINNED_KS where K is not pinned, on
    each of PINNED_TILES where neither tile dimension is pinned, each
    whose window fits on ``shape`` (``geometry.resolve``; every one when
    ``shape`` is None). The pins never cross: every candidate carries
    them."""
    ks = (steps_per_call,) if steps_per_call is not None else PINNED_KS
    tiles = ([(block_rows, block_cols)]
             if (block_rows, block_cols) != (None, None) else PINNED_TILES)
    out = []
    for k in ks:
        for tr, tc in tiles:
            if shape is not None:
                try:
                    geometry.resolve(tuple(shape), k, tr, tc)
                except UnsupportedConfigError:
                    continue
            cfg = {"engine": "windowed", "steps_per_call": k,
                   "block_rows": tr, "block_cols": tc}
            out.append({key: v for key, v in cfg.items() if v is not None})
    return out


def measure_config(params: Parameters, shape, boundary: str,
                   steps: int | None = None, dtype: str = "float32",
                   reps: int = 3, device: str | torch.device = "cuda",
                   **config) -> dict:
    """One candidate (``config``: the backend's ``engine``, ``resident``
    and ``pack`` pins) with the autotune store ignored: what it ran, in
    the record schema, and its rates (``gcells_per_sec``, the device rate
    on the card and the wall rate on the CPU; ``wall_gcells_per_sec``;
    ``device_gcells_per_sec`` on the card)."""
    global measurements
    sim = CudaSimulation(params, boundary, device=device, dtype=dtype,
                         tuned_lookup=False, **config)
    species = sim.make_species(tuple(shape))
    tag = species.storage[0]
    engine, pack = _RAN[tag]
    measurements += 1
    folded = tag == "folded"
    k = species.storage[5 if folded else -1][0] if engine == "windowed" \
        else K
    tiles = ({"block_rows": config.get("block_rows"),
              "block_cols": config.get("block_cols")}
             if engine in ("windowed", "mega") else {})
    rec = {"engine": engine, "block_rows": None, "steps_per_call": k,
           "block_cols": None, "fold": species.storage[6][0] if folded else 1,
           "pack": pack, **tiles}
    rec.update(_measure_rates(sim, species, shape, steps or STEPS, reps))
    return rec


def _measure_rates(sim, species, shape, steps: int, reps: int) -> dict:
    """A warm-up of K steps (the kernels' build), then the best of
    ``reps`` runs of ``steps`` steps: CUDA events around ``run_steps`` on
    the card, and the host clock ending in a synchronise (a readback on
    the CPU)."""
    cuda = sim.device.type == "cuda"
    sim.prepare_steps(species, K)
    species.result()[:1, :128].sum().item()
    wall = device = float("inf")
    for _ in range(max(1, reps)):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        sim.prepare_steps(species, steps)
        if cuda:
            end.record()
            end.synchronize()
            device = min(device, start.elapsed_time(end) * 1e-3)
        else:
            species.result()[:1, :128].sum().item()
        wall = min(wall, time.perf_counter() - t0)
    cells = shape[0] * shape[1] * steps
    rec = {"gcells_per_sec": cells / wall / 1e9,
           "wall_gcells_per_sec": cells / wall / 1e9}
    if cuda:
        rec["device_gcells_per_sec"] = cells / device / 1e9
        rec["gcells_per_sec"] = rec["device_gcells_per_sec"]
    return rec


def key_for(params: Parameters, shape, boundary: str,
            dtype: str = "float32",
            device: str | torch.device = "cuda",
            steps_per_call: int | None = None,
            block_rows: int | None = None,
            block_cols: int | None = None) -> str:
    """The store key of a configuration on ``device``; under a K or tile
    pin, the pins after a ``|`` (``|k16:tr32``)."""
    key = cache.autotune_key(autotune_platform(device), shape, boundary,
                             params.stencil_name(), KERNEL_VERSION, dtype)
    pins = [f"{name}{value}" for name, value in (
        ("k", steps_per_call), ("tr", block_rows), ("tc", block_cols))
        if value is not None]
    return f"{key}|{':'.join(pins)}" if pins else key


def autotune(params: Parameters, shape, boundary: str = "naive",
             candidates: Iterable[Mapping] | None = None,
             persist: bool = True, verbose: bool = False,
             dtype: str = "float32", device: str | torch.device = "cuda",
             steps: int | None = None, reps: int = 3,
             steps_per_call: int | None = None,
             block_rows: int | None = None,
             block_cols: int | None = None) -> dict:
    """The best candidate of the configuration under the K and tile pins:
    the store's record when it holds one (nothing is measured), else each
    candidate measured, the first two measured again when the runner-up
    is within 3 % of the winner, and the winner persisted (``persist``)
    with the whole ``candidates`` table."""
    pins = dict(steps_per_call=steps_per_call, block_rows=block_rows,
                block_cols=block_cols)
    key = key_for(params, shape, boundary, dtype, device, **pins)
    store = cache.load_autotune()
    if key in store:
        return store[key]
    configs = [dict(c) for c in (candidates if candidates is not None
                                 else default_candidates(
                                     params, boundary, dtype, shape,
                                     **pins, device=device))]
    if not configs:
        raise UnsupportedConfigError(
            f"no autotune candidate runs the pins {pins} on "
            f"{shape[0]}x{shape[1]}; drop a pin or run without --autotune",
            combo="autotune")

    def measure(cfg):
        return measure_config(params, shape, boundary, steps, dtype, reps,
                              device, **cfg)

    return _tune(key, configs, measure, persist, verbose, _ran_label)


def _ran_label(res: dict) -> str:
    """What a candidate ran, in the verbose lines."""
    layout = " packed" if res["pack"] else (
        f" folded F={res['fold']}" if res["fold"] > 1 else "")
    return (f"{res['engine']}{layout} K={res['steps_per_call']} tiles "
            f"{res['block_rows']}x{res['block_cols']}")


def _tune(key: str, configs: list, measure, persist: bool, verbose: bool,
          ran) -> dict:
    """Each of ``configs`` measured (``measure(config)``; a refused one is
    kept in the table with its error), the fastest (the runner-up within
    RECHECK of it measured again, the better rate of each deciding), with
    the whole ``candidates`` table, persisted under ``key`` when
    ``persist``. ``ran(result)`` names what a candidate ran."""
    measured, pool = [], []
    for cfg in configs:
        try:
            res = measure(cfg)
        except UnsupportedConfigError as e:
            if verbose:
                print(f"{cfg}: refused ({e})", flush=True)
            measured.append({**cfg, "error": type(e).__name__})
            continue
        res["gcells_per_sec"] = round(res["gcells_per_sec"], 3)
        if verbose:
            print(f"{cfg}: {res['gcells_per_sec']:.3f} Gcell/s (ran "
                  f"{ran(res)})", flush=True)
        measured.append(res)
        pool.append((cfg, res))
    if not pool:
        raise RuntimeError("no autotune candidate ran")
    pool.sort(key=lambda p: p[1]["gcells_per_sec"], reverse=True)
    if len(pool) >= 2 and pool[1][1]["gcells_per_sec"] >= \
            RECHECK * pool[0][1]["gcells_per_sec"]:
        # within the noise of a measurement: the kernels are built now, so
        # measuring both again is cheap, and the better of each decides
        for cfg, res in pool[:2]:
            again = measure(cfg)
            res["gcells_per_sec"] = round(
                max(res["gcells_per_sec"], again["gcells_per_sec"]), 3)
            if verbose:
                print(f"{cfg}: measured again, {again['gcells_per_sec']:.3f}"
                      f" Gcell/s", flush=True)
        pool.sort(key=lambda p: p[1]["gcells_per_sec"], reverse=True)
    best = dict(pool[0][1], candidates=measured)
    if persist:
        store = cache.load_autotune()  # measuring took a while
        store[key] = best
        cache.save_autotune(store)
    return best


def lookup(params: Parameters, shape, boundary: str,
           dtype: str = "float32",
           device: str | torch.device = "cuda",
           steps_per_call: int | None = None,
           block_rows: int | None = None,
           block_cols: int | None = None) -> dict | None:
    """The best known record of the configuration on ``device`` under the
    K and tile pins: the local store first, then the records this package
    ships for the card (``bench/defaults.py``); None when neither has
    one."""
    key = key_for(params, shape, boundary, dtype, device, steps_per_call,
                  block_rows, block_cols)
    rec = cache.load_autotune().get(key)
    if rec is not None:
        return rec
    from .defaults import SHIPPED

    return SHIPPED.get(key)


# -- the sharded backend's tuner (grayscott_tpu/bench/autotune.py:556-818) --
#
# The candidates are JAX's (``_sharded_candidates``, ``:604-665``): on
# every mesh worth measuring, the windowed engine at K 16 and 8 with
# overlap off, with overlap on on the row tile ``tr_ov`` that makes the
# split engage, and at K = 16 on half the default row tile; and the
# megakernel K7. A record carries the K and tiles it ran. ADVICE.md (round
# 5) found three faults in the JAX tuner, which the port does not carry:
# the device time of a candidate is one CUDA-event interval around the
# whole call on the one card, exchange and launches, never a sum over
# shards (#1); a record's tile never transfers to another K (#2:
# ``ShardedSimulation._adopt_record``); and every pin reaches the
# candidates and the key (#3).


def sharded_key(params: Parameters, shape, boundary: str,
                dtype: str = "float32", n_devices: int = 1,
                mesh_cols: int | None = None, engine: str | None = None,
                overlap: bool | None = None,
                steps_per_call: int | None = None,
                device: str | torch.device = "cuda",
                block_rows: int | None = None,
                block_cols: int | None = None) -> str:
    """The store key of a sharded configuration: :func:`key_for`'s, then
    the shard count and every pin that restricts the candidates (mesh
    columns, engine, overlap, K, tiles), so that a record measured under a
    pin never steers a run without it, nor the other way round
    (``grayscott_tpu/bench/autotune.py:sharded_key``)."""
    key = f"{key_for(params, shape, boundary, dtype, device)}" \
        f"|sharded:n{n_devices}"
    if mesh_cols is not None:
        key += f":mc{mesh_cols}"
    if engine in ("windowed", "mega"):
        key += f":eng-{engine}"
    if overlap is not None:
        key += f":ov-{'on' if overlap else 'off'}"
    if steps_per_call is not None:
        key += f":k{steps_per_call}"
    if block_rows is not None:
        key += f":tr{block_rows}"
    if block_cols is not None:
        key += f":tc{block_cols}"
    return key


#: the sharded windowed engine's depths (JAX's ``for k in (16, 8)``)
SHARDED_KS = (16, 8)


def _sharded_candidates(shape, n: int, mesh_cols: int | None = None,
                        engine: str | None = None,
                        overlap: bool | None = None,
                        steps_per_call: int | None = None,
                        block_rows: int | None = None,
                        block_cols: int | None = None) -> list[dict]:
    """JAX's ``_sharded_candidates`` under the pins (None is unpinned), on
    each viable mesh (``halo.viable_mesh_cols``, else the 1-D one): the
    windowed engine at each of SHARDED_KS (the pinned K alone) with overlap
    off; with overlap on on JAX's row tile ``tr_ov = max(halo, r_loc // 3
    // 8 * 8)`` where the port's split engages on it
    (``halo.overlap_engages``, so that an overlap candidate runs the split,
    not the serialized fallback under its label); at K = 16 with overlap
    off on half the default row tile (``geometry.resolve``'s at K = 16);
    and the megakernel, which a pinned overlap on, a pinned K other than 8
    and a column pin on the windowed engine exclude. A row-tile pin
    replaces the candidates' row tiles; a column pin runs K7 alone, which
    takes it."""
    meshes = [mesh_cols] if mesh_cols else (
        halo.viable_mesh_cols(shape, n) or [1])
    engines = [engine] if engine in ("windowed", "mega") \
        else ["windowed", "mega"]
    if block_cols is not None:
        engines = [e for e in engines if e == "mega"]
    if steps_per_call not in (None, K):
        engines = [e for e in engines if e == "windowed"]
    ks = (steps_per_call,) if steps_per_call is not None else SHARDED_KS
    out = []

    def add(cfg):
        if block_rows is not None and cfg["engine"] == "windowed":
            cfg["block_rows"] = block_rows
        if cfg not in out:
            out.append(cfg)

    for nc in meshes:
        if n % nc:
            continue
        r_loc, c_loc = halo.shard_extents(shape,
                                          halo.Mesh(n // nc, nc, None))
        if "windowed" in engines:
            for k in ks:
                base = dict(engine="windowed", mesh_cols=nc,
                            steps_per_call=k)
                h = geometry.halo_for_steps(k)
                if overlap is not True:
                    add(dict(base, overlap=False))
                if overlap is not False:
                    # JAX's r_loc here is the unpadded ceil(R / n_rows)
                    tr_ov = block_rows or max(
                        h, -(-shape[0] // (n // nc)) // 3 // 8 * 8)
                    try:
                        g = geometry.resolve((r_loc, c_loc), k, tr_ov)
                    except UnsupportedConfigError:
                        g = None
                    if g and halo.overlap_engages(r_loc, c_loc, nc,
                                                  (g.tr, g.tc), g.halo):
                        add(dict(base, overlap=True, block_rows=tr_ov))
                if k == 16 and overlap is not True and block_rows is None:
                    try:
                        tr0 = geometry.resolve((r_loc, c_loc), k).tr
                    except UnsupportedConfigError:
                        continue
                    half = max(8, tr0 // 2 // 8 * 8)
                    if half < tr0:
                        add(dict(base, overlap=False, block_rows=half))
        if "mega" in engines and overlap is not True:
            cfg = dict(engine="mega", mesh_cols=nc)
            cfg.update({name: value for name, value in (
                ("block_rows", block_rows), ("block_cols", block_cols))
                if value is not None})
            add(cfg)
    return out


def measure_sharded_config(params: Parameters, shape, boundary: str,
                           steps: int | None = None, dtype: str = "float32",
                           reps: int = 3,
                           device: str | torch.device = "cuda",
                           n_devices: int | None = None, **config) -> dict:
    """One sharded candidate (``config``: the backend's ``engine``,
    ``mesh_cols``, ``overlap``, ``steps_per_call``, ``block_rows`` and
    ``block_cols`` pins) with the autotune store ignored: what actually ran
    (the engine, the mesh, its K and tile pins, and overlap only where the
    split engaged), in the record schema, and its rates, each one interval
    around the whole call (:func:`_measure_rates`: the exchange and every
    launch, on the one card)."""
    global measurements
    sim = ShardedSimulation(params, boundary, device=device, dtype=dtype,
                            n_devices=n_devices, tuned_lookup=False,
                            **config)
    species = sim.make_species(tuple(shape))
    measurements += 1
    mega = sim.engine == "mega"
    rec = {"engine": sim.engine, "mesh_cols": sim.mesh.n_cols,
           "mesh_rows": sim.mesh.n_rows, "block_rows": sim.tile_rows,
           "block_cols": sim.tile_cols if mega else None,
           "steps_per_call": K if mega else sim.steps_per_call,
           "overlap": sim.overlap_runs(shape)}
    rec.update(_measure_rates(sim, species, shape, steps or STEPS, reps))
    return rec


def _pin(value, unpinned=("auto", "", None)):
    return None if value in unpinned else value


def sharded_autotune(params: Parameters, shape, boundary: str = "naive",
                     dtype: str = "float32", n_devices: int | None = None,
                     mesh_cols: int | None = None, engine: str | None = None,
                     overlap=None, steps_per_call: int | None = None,
                     candidates: Iterable[Mapping] | None = None,
                     persist: bool = True, verbose: bool = False,
                     reps: int = 3, steps: int | None = None,
                     device: str | torch.device = "cuda",
                     block_rows: int | None = None,
                     block_cols: int | None = None) -> dict:
    """The best sharded candidate under the pins: the store's record when
    it holds one for the key (nothing is measured), else every candidate
    (:func:`_sharded_candidates`) measured with every pin (``dtype`` too),
    the first two again when within RECHECK, and
    the winner persisted with the whole ``candidates`` table. ``"auto"``
    pins are unpinned; ``overlap`` takes ``"on"``/``"off"`` or a bool."""
    n = n_devices or halo.visible_cards(torch.device(device))
    engine = _pin(engine)
    if isinstance(overlap, str):
        overlap = {"on": True, "off": False}.get(overlap)
    key = sharded_key(params, shape, boundary, dtype, n, mesh_cols, engine,
                      overlap, steps_per_call, device, block_rows,
                      block_cols)
    store = cache.load_autotune()
    if key in store:
        return store[key]
    configs = [dict(c) for c in (
        candidates if candidates is not None else _sharded_candidates(
            shape, n, mesh_cols, engine, overlap, steps_per_call,
            block_rows, block_cols))]
    if not configs:
        raise UnsupportedConfigError(
            f"no sharded autotune candidate runs the pins (mesh_cols="
            f"{mesh_cols}, engine={engine}, overlap={overlap}, "
            f"steps_per_call={steps_per_call}, block_rows={block_rows}, "
            f"block_cols={block_cols}) on {shape[0]}x{shape[1]} in {n} "
            "shards; drop a pin or run without --autotune",
            combo="autotune")

    def measure(cfg):
        cfg = dict(cfg)
        # the pins ride every candidate (a candidate's own K and tiles are
        # those of the pins where pinned)
        for name, value in (("steps_per_call", steps_per_call),
                            ("block_rows", block_rows),
                            ("block_cols", block_cols)):
            if value is not None:
                cfg[name] = value
        return measure_sharded_config(params, shape, boundary, steps, dtype,
                                      reps, device, n_devices=n, **cfg)

    return _tune(key, configs, measure, persist, verbose, lambda res: (
        f"{res['engine']} mesh {res['mesh_rows']}x{res['mesh_cols']} "
        f"K={res['steps_per_call']} tiles {res['block_rows']}x"
        f"{res['block_cols']} overlap {res['overlap']}"))


def sharded_lookup(params: Parameters, shape, boundary: str,
                   dtype: str = "float32", n_devices: int | None = None,
                   mesh_cols: int | None = None, engine: str | None = None,
                   overlap: bool | None = None,
                   steps_per_call: int | None = None,
                   device: str | torch.device = "cuda",
                   block_rows: int | None = None,
                   block_cols: int | None = None) -> dict | None:
    """The best known sharded record of the configuration and pins on
    ``device``: the local store first, then the records this package
    ships for the card (``bench/defaults.py``); None when neither has
    one."""
    n = n_devices or halo.visible_cards(torch.device(device))
    key = sharded_key(params, shape, boundary, dtype, n, mesh_cols,
                      _pin(engine), overlap, steps_per_call, device,
                      block_rows, block_cols)
    rec = cache.load_autotune().get(key)
    if rec is not None:
        return rec
    from .defaults import SHARDED

    return SHARDED.get(key)
