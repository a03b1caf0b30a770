"""What the port's sweep needs of ``scripts/_sweep_util.py``: one
configuration after another, each measured and printed as a ``RESULT``
line. The JAX tool runs each configuration in a subprocess of its own,
against a compile ceiling of the TPU's compiler that the port's nvcc build
does not have, so here they all run in one process."""

from __future__ import annotations

import json

#: the pins a configuration takes, and its defaults
PINS = {"engine": "auto", "resident": "auto", "pack": "auto"}


def parse_pins(text: str) -> dict:
    """``"engine=mega:pack=on"`` -> ``{"engine": "mega", "pack": "on"}``
    (an empty text, no pins)."""
    pins = {}
    for item in filter(None, text.split(":")):
        key, sep, value = item.partition("=")
        if not sep:
            raise ValueError(f"expected key=value, got {item!r}")
        pins[key] = value
    return pins


def run_config(cfg: dict, device: str = "cuda") -> dict:
    """One configuration (``engine``, ``resident``, ``pack``, ``shape``,
    ``boundary``, ``steps``) on the ``cuda`` backend with the autotune
    store ignored: the JAX child's ``RESULT`` payload (the harness's
    ``compute`` workload, best of 5) with ``device_gcells_per_sec`` on the
    card (its ``device`` workload, best of 2) and what ran (``ran``)."""
    from ..backends.cuda import CudaSimulation
    from ..bench.harness import run_one
    from ..params import Parameters

    shape = tuple(cfg.get("shape", (4096, 4096)))
    sim = CudaSimulation(Parameters(), boundary=cfg.get("boundary", "zero"),
                         device=device, tuned_lookup=False,
                         **{k: cfg.get(k, v) for k, v in PINS.items()})
    packed, engine = sim.layout_for(shape)
    steps = cfg.get("steps", 512)
    res = run_one(sim, shape, steps, "compute", reps=5)
    out = {"config": cfg, **res.to_json(),
           "ran": {"engine": engine, "pack": packed}}
    if sim.device.type == "cuda":
        dres = run_one(sim, shape, steps, "device", reps=2)
        out["device_gcells_per_sec"] = round(dres.gcells_per_sec, 3)
    return out


def run_configs(configs, device: str = "cuda") -> None:
    """Each configuration in turn: a ``RESULT {json}`` line, or a JSON
    line with ``error`` when the backend refuses it; ``DONE`` last."""
    from ..errors import UnsupportedConfigError

    for cfg in configs:
        print(f"config {cfg} measuring...", flush=True)
        try:
            out = run_config(cfg, device)
        except UnsupportedConfigError as e:
            print(json.dumps({"config": cfg, "error": str(e)}), flush=True)
            continue
        print("RESULT " + json.dumps(out), flush=True)
    print("DONE", flush=True)
