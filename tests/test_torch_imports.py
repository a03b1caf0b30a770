"""The port and chip_smoke.py import with jax and h5py blocked: the card's
machine has neither, and the port must not need them to run."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import importlib, json, pkgutil, sys
sys.modules["jax"] = None
sys.modules["h5py"] = None
import grayscott_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    grayscott_tpu_torch.__path__, "grayscott_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
print(json.dumps({
    "imported": names,
    "jax_loaded": sorted(m for m in sys.modules
                         if m == "jax" or m.startswith("jax.")
                         if sys.modules[m] is not None),
    "jax_package": sorted(m for m in sys.modules
                          if m.startswith(("grayscott_tpu.ops",
                                           "grayscott_tpu.backends"))),
}))
"""


@pytest.fixture(scope="module")
def probe():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_every_port_module_imports_without_jax_or_h5py(probe):
    expected = {
        "grayscott_tpu_torch.params", "grayscott_tpu_torch.species",
        "grayscott_tpu_torch.ops.stencil", "grayscott_tpu_torch.ops.build",
        "grayscott_tpu_torch.ops.windowed",
        "grayscott_tpu_torch.backends.base",
        "grayscott_tpu_torch.backends.cuda",
        "grayscott_tpu_torch.cli.shared", "grayscott_tpu_torch.cli.simulate",
        "grayscott_tpu_torch.utils.device",
    }
    assert expected <= set(probe["imported"])


def test_no_jax_module_was_loaded(probe):
    """Neither jax nor the JAX package's jax-importing modules (ops,
    backends) were pulled in by the port or chip_smoke.py."""
    assert probe["jax_loaded"] == []
    assert probe["jax_package"] == []
