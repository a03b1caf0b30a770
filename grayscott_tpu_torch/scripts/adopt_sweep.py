"""Persist sweep results as autotune records: the port of
``scripts/adopt_sweep.py``.

``scripts/sweep.py`` measures pinned configurations, but the backend
follows winners only through the autotune store (``utils/cache.py``). This
tool reads one or more sweep logs (their ``RESULT`` lines; the JAX tool's
bare JSON lines too), groups the results by (shape, boundary, dtype), and
writes the best of each group as that key's record, marked ``"source":
"sweep"``, with every result considered in its ``candidates`` table.

A result replaces a stored record only when it is at least ``--margin``
(default 2 %) better in a matched unit (device against device when both
carry a device rate, else wall against wall) and, on the wall, beyond its
own CI95 (``bench/stats.py:significantly_better``); a replaced record
joins the ``candidates`` table. An ``engine=auto`` unpacked and unfolded
winner is persisted with ``engine: None`` (the backend's measured ranking
decides), which retires a stored pin; a ``fold`` winner keeps its F, since
``auto`` folds only on a record.

    python -m grayscott_tpu_torch.scripts.adopt_sweep sweep.log \\
        [more.log ...] [--dry-run] [--margin 1.02] [--platform NAME]

``--platform`` is the ``utils/device.py:autotune_platform`` string of the
card that ran the sweep (default: this machine's card).
"""

from __future__ import annotations

import argparse
import json
import sys

from ..bench import stats
from ..bench.autotune import K, KERNEL_VERSION
from ..params import Parameters
from ..utils import cache


def parse_results(paths: list[str]) -> list[dict]:
    """The results of sweep logs: each ``RESULT {json}`` line (or bare JSON
    line) that carries ``gcells_per_sec`` and ``config``."""
    out = []
    for path in paths:
        with open(path) as f:
            for line in f:
                line = line.strip().removeprefix("RESULT ")
                if not line.startswith("{"):
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if "gcells_per_sec" in rec and "config" in rec:
                    out.append(rec)
    return out


def to_record(res: dict) -> dict:
    """An autotune record from one result, in the schema the tuner
    persists (JAX's ``to_record``, ``scripts/adopt_sweep.py:59-104``): the
    engine the config pinned (``windowed`` under a ``tr`` or ``k`` pin,
    None for ``engine=auto``), ``pack``, the lane fold's F it pinned (1
    unpinned), the tile and depth pins it ran
    (``tr``, ``k`` (default 8) and, only where pinned, ``tc``) and the
    rates (the headline ``gcells_per_sec`` the device rate when the
    result has one)."""
    cfg = res["config"]
    if cfg.get("resident") == "on":
        engine = "resident"
    elif cfg.get("engine") == "mega":
        engine = "mega"
    elif cfg.get("engine") == "windowed" or cfg.get("tr") or cfg.get("k"):
        engine = "windowed"
    else:
        engine = None
    rec = {
        "engine": engine,
        "block_rows": cfg.get("tr"),
        "steps_per_call": cfg.get("k") or K,
        "fold": cfg.get("fold") if isinstance(cfg.get("fold"), int) else 1,
        "pack": cfg.get("pack") == "on",
        "wall_gcells_per_sec": round(res["gcells_per_sec"], 3),
        "gcells_per_sec": round(
            res.get("device_gcells_per_sec") or res["gcells_per_sec"], 3),
        "source": "sweep",
    }
    if res.get("device_gcells_per_sec"):
        rec["device_gcells_per_sec"] = round(res["device_gcells_per_sec"], 3)
    if res.get("stats"):
        rec["stats"] = res["stats"]
    if "tc" in cfg:
        # a present block_cols pins the width (None: the default rule)
        rec["block_cols"] = cfg["tc"]
    return rec


def group_results(results: list[dict], platform: str) -> dict:
    """The results by store key: (shape, boundary, dtype) on ``platform``,
    with the default stencil; the dtype the result ran (``ran``, the
    port's sweep), else the one its config names (JAX's lines)."""
    stencil = Parameters().stencil_name()
    by_key: dict[str, list[dict]] = {}
    for res in results:
        cfg = res["config"]
        dtype = res.get("ran", {}).get("dtype", cfg.get("dtype", "float32"))
        key = cache.autotune_key(
            platform, tuple(cfg.get("shape", (4096, 4096))),
            cfg.get("boundary", "zero"), stencil, KERNEL_VERSION, dtype)
        by_key.setdefault(key, []).append(res)
    return by_key


def adopt(store: dict, by_key: dict, margin: float = 1.02) -> bool:
    """Apply each group to ``store`` (in place); True when a record
    changed."""
    changed = False
    for key, group in by_key.items():
        # one unit for the whole group: device only when every result has
        # it (a device rate can be several times a wall rate)
        if all(r.get("device_gcells_per_sec") for r in group):
            ranked = sorted(group, key=lambda r: r["device_gcells_per_sec"],
                            reverse=True)
        else:
            ranked = sorted(group, key=lambda r: r["gcells_per_sec"],
                            reverse=True)
        best = to_record(ranked[0])
        prev = store.get(key)
        candidates = [to_record(r) for r in ranked]
        if prev:
            # the previous record joins the audit table, then its own
            prev_entry = {k: v for k, v in prev.items() if k != "candidates"}
            candidates += [c for c in [prev_entry]
                           + prev.get("candidates", [])
                           if c not in candidates]
        if prev and best.get("device_gcells_per_sec") and \
                prev.get("device_gcells_per_sec"):
            best_val = best["device_gcells_per_sec"]
            prev_val = prev["device_gcells_per_sec"]
            unit = "device"
        else:
            best_val = best.get("wall_gcells_per_sec",
                                best["gcells_per_sec"])
            prev_val = (prev or {}).get(
                "wall_gcells_per_sec",
                (prev or {}).get("gcells_per_sec", 0.0))
            unit = "wall"
        # a point win inside the challenger's own wall-clock CI95 is no
        # evidence; the margin gates the rest
        noisy_win = bool(prev and best.get("stats") and unit == "wall"
                         and not stats.significantly_better(best["stats"],
                                                            prev_val))
        if prev and (noisy_win or prev_val * margin >= best_val):
            why = ("within the challenger's CI95 noise band" if noisy_win
                   else f"{unit} {prev_val} * margin >= {best_val}")
            print(f"{key}: keep existing {prev.get('gcells_per_sec')} "
                  f"({why})")
            new = dict(prev, candidates=candidates)
        elif best["engine"] is None and not best["pack"] and \
                best["fold"] <= 1:
            print(f"{key}: best is engine=auto unpacked "
                  f"({best['gcells_per_sec']})"
                  + (f" — retiring the stored "
                     f"{prev.get('engine') or 'auto'} verdict "
                     f"(was {prev.get('gcells_per_sec')})" if prev
                     else " — candidates recorded"))
            new = dict(best, candidates=candidates)
        else:
            print(f"{key}: adopt {best['engine']}"
                  f"{' pack' if best['pack'] else ''} "
                  f"@ {best['gcells_per_sec']} Gcell/s"
                  + (f" (was {prev.get('gcells_per_sec')})" if prev
                     else ""))
            new = dict(best, candidates=candidates)
        if new != prev:
            store[key] = new
            changed = True
    return changed


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("logs", nargs="+", help="sweep log files")
    p.add_argument("--dry-run", action="store_true")
    p.add_argument("--margin", type=float, default=1.02,
                   help="replace an existing record only when better by "
                   "this factor (guards against run-to-run noise)")
    p.add_argument("--platform", default=None,
                   help="autotune_platform() of the card that ran the "
                   "sweep (default: this machine's card)")
    args = p.parse_args(argv)

    results = parse_results(args.logs)
    if not results:
        print("no RESULT lines found")
        return 1
    platform = args.platform
    if platform is None:
        import torch

        from ..utils.device import autotune_platform

        if not torch.cuda.is_available():
            p.error("no CUDA card here: pass --platform")
        platform = autotune_platform("cuda")
    store = cache.load_autotune()
    changed = adopt(store, group_results(results, platform), args.margin)
    if args.dry_run:
        print("(dry run: store not written)")
        return 0
    if changed:
        cache.save_autotune(store)
        print(f"wrote {cache.autotune_path()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
