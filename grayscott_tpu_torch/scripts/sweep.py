"""Hardware A/B sweep: the port of ``scripts/sweep.py``.

Each configuration pins the ``cuda`` backend's knobs under JAX's sweep
keys (``engine``, ``resident``, ``pack``, ``dtype``, ``fix``, ``nfold``,
``rt``, ``fold``, ``k``, ``depth``, ``spec``, ``tr``, ``tc``; the backend
refuses the values it does not run) on one shape, boundary, storage dtype
and step count, and prints one
``RESULT {json}`` line (``scripts/_sweep_util.py``); ``adopt_sweep`` turns
the winners into autotune records. The configurations run one after
another in this process. Every run is on the card unless ``--device cpu``
is given.

    python -m grayscott_tpu_torch.scripts.sweep --shape 1080x1920 \\
        --boundary zero --configs engine=windowed engine=mega \\
        resident=on pack=on:engine=mega > sweep.log
    # full config dicts (the keys above and shape, boundary, steps), a
    # path or inline; --dtype sets the storage dtype of every config
    python -m grayscott_tpu_torch.scripts.sweep --dtype bfloat16 \\
        --json '[{"engine": "mega", "depth": 4, "steps": 256}]'
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ..utils.runtime import PLATFORMS, default_device
from ._sweep_util import parse_pins, run_configs


def parse_shape(s: str) -> list[int]:
    r, c = s.lower().split("x")
    return [int(r), int(c)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--shape", type=parse_shape, default=[4096, 4096],
                   help="domain RxC (default 4096x4096)")
    p.add_argument("--boundary", default="zero", choices=["zero", "naive"])
    p.add_argument("--dtype", default=None, choices=["float32", "bfloat16"])
    p.add_argument("--steps", type=int, default=None,
                   help="steps per measurement (default 512)")
    p.add_argument("--configs", nargs="*", default=[],
                   metavar="KEY=VALUE[:KEY=VALUE]",
                   help="configs as the sweep's keys, e.g. engine=mega, "
                   "resident=on, pack=on:engine=windowed, "
                   "engine=mega:depth=4, nfold=on")
    p.add_argument("--json", default=None,
                   help="JSON list of full config dicts (a path or inline); "
                   "merged after --configs")
    p.add_argument("--device", default=default_device(),
                   choices=PLATFORMS,
                   help="'cuda' (default) runs on the card; 'cpu' the "
                   "plain versions")
    args = p.parse_args(argv)

    base = {"shape": args.shape, "boundary": args.boundary}
    if args.dtype:
        base["dtype"] = args.dtype
    if args.steps:
        base["steps"] = args.steps
    configs = [dict(base, **parse_pins(spec)) for spec in args.configs]
    if args.json:
        raw = args.json
        if os.path.exists(raw):
            with open(raw) as f:
                raw = f.read()
        configs += [dict(base, **extra) for extra in json.loads(raw)]
    if not configs:
        p.error("no configurations given (--configs or --json)")
    from ..cli.shared import require_device

    require_device(args.device)
    run_configs(configs, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
