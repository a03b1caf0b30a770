"""What the port's sweep needs of ``scripts/_sweep_util.py``: one
configuration after another, each measured and printed as a ``RESULT``
line. The JAX tool runs each configuration in a subprocess of its own,
against a compile ceiling of the TPU's compiler that the port's nvcc build
does not have, so here they all run in one process."""

from __future__ import annotations

import json

#: a configuration's keys, JAX's child's names (``scripts/_sweep_util.py:
#: 25-40``) -> the ``cuda`` backend's keyword and the child's default.
#: ``k``, ``tr`` and ``tc`` pin K1's (and K4's) depth and tiles
#: (``ops/geometry.py``). The backend refuses what it does not run (a lane
#: fold, the megakernels' tile pins), each naming its ROADMAP.md item.
KEYS = {
    "engine": ("engine", "auto"), "resident": ("resident", "auto"),
    "pack": ("pack", "auto"), "dtype": ("dtype", "float32"),
    "fix": ("naive_fix", "select"), "nfold": ("naive_fold", False),
    "rt": ("runtime_params", True), "fold": ("fold", "off"),
    "k": ("steps_per_call", None), "depth": ("mega_depth", None),
    "spec": ("mega_specialize", None), "tr": ("block_rows", None),
    "tc": ("block_cols", None),
}
#: where a configuration runs, not what
PLACE = ("shape", "boundary", "steps")

#: pins whose values are booleans or integers: the sweep's keys and the
#: backends' keywords (parity_check's ``cuda:naive_fold=off``)
BOOL_PINS = ("nfold", "rt", "spec", "naive_fold", "runtime_params",
             "mega_specialize")
INT_PINS = ("k", "depth", "tr", "tc", "steps", "steps_per_call",
            "mega_depth", "block_rows", "block_cols", "n_devices",
            "mesh_cols")
_BOOLS = {"on": True, "true": True, "1": True,
          "off": False, "false": False, "0": False}


def pin_value(key: str, value: str):
    """A pin's value: a boolean (on/off, true/false, 1/0) or an integer
    where the key takes one, an integer or ``auto``/``off`` for ``fold``,
    else the text; ValueError for a value the key cannot take."""
    if key in BOOL_PINS:
        if value.lower() not in _BOOLS:
            raise ValueError(f"{key} takes on/off, true/false or 1/0, got "
                             f"{value!r}")
        return _BOOLS[value.lower()]
    if key in INT_PINS or (key == "fold" and value not in ("auto", "off")):
        try:
            return int(value)
        except ValueError:
            raise ValueError(f"{key} takes an integer, got {value!r}") \
                from None
    return value


def parse_pins(text: str) -> dict:
    """``"engine=mega:pack=on:depth=4"`` -> ``{"engine": "mega", "pack":
    "on", "depth": 4}`` (an empty text, no pins); values converted by
    :func:`pin_value`."""
    pins = {}
    for item in filter(None, text.split(":")):
        key, sep, value = item.partition("=")
        if not sep:
            raise ValueError(f"expected key=value, got {item!r}")
        pins[key] = pin_value(key, value)
    return pins


def simulation(cfg: dict, device: str = "cuda"):
    """The ``cuda`` backend that runs ``cfg``, the autotune store ignored
    (JAX's child); UnsupportedConfigError for a key it has no counterpart
    of (``limit``, the TPU's VMEM limit) or a value it does not run."""
    from ..backends.cuda import CudaSimulation
    from ..errors import UnsupportedConfigError
    from ..params import Parameters

    unknown = sorted(set(cfg) - set(KEYS) - set(PLACE))
    if unknown:
        raise UnsupportedConfigError(
            f"the port's sweep has no counterpart of {unknown} (it runs "
            f"{sorted(KEYS)})", combo=",".join(unknown))
    return CudaSimulation(Parameters(), boundary=cfg.get("boundary", "zero"),
                          device=device, tuned_lookup=False,
                          **{kw: cfg.get(key, default)
                             for key, (kw, default) in KEYS.items()})


def run_config(cfg: dict, device: str = "cuda") -> dict:
    """One configuration (the keys of ``KEYS``, and ``shape``,
    ``boundary``, ``steps``) on the ``cuda`` backend with the autotune
    store ignored: the JAX child's ``RESULT`` payload (the harness's
    ``compute`` workload, best of 5) with ``device_gcells_per_sec`` on the
    card (its ``device`` workload, best of 2) and what ran (``ran``: the
    engine, the layout, the storage dtype, the folded naive reaction and
    the ring's depth)."""
    from ..bench.harness import run_one

    shape = tuple(cfg.get("shape", (4096, 4096)))
    sim = simulation(cfg, device)
    packed, engine = sim.layout_for(shape)
    steps = cfg.get("steps", 512)
    res = run_one(sim, shape, steps, "compute", reps=5)
    out = {"config": cfg, **res.to_json(),
           "ran": {"engine": engine, "pack": packed, "dtype": sim.dtype,
                   "nfold": sim.naive_fold, "depth": sim.mega_depth}}
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
