"""What the port runs on: the port's ``grayscott_tpu/utils/device.py:
capability_dump``, reduced to the CUDA device, the toolkit and the card's
power limit (a card set below its maximum runs slower under load, so every
measurement is kept beside it); the string autotune records key on,
:func:`autotune_platform`; and the one timer of the measurement scripts,
:func:`time_call`.

    python -m grayscott_tpu_torch.utils.device
"""

from __future__ import annotations

import re
import subprocess
import time
from typing import Callable

import torch


def device_name(device: str) -> str:
    """The card's name, or what a CPU run's numbers are."""
    return (torch.cuda.get_device_name() if device == "cuda"
            else "the CPU (plain PyTorch, not a device rate)")


def autotune_platform(device: str | torch.device = "cuda") -> str:
    """The string autotune records key on (the port's ``grayscott_tpu/
    utils/device.py:autotune_platform``): on the card its name, lowercased,
    without the vendor, runs of other characters than letters and digits
    made one ``-``, and its SM count (``h100-80gb-hbm3-sm132``), never
    ``gpu`` or ``cuda`` alone, so a verdict measured on one card never pins
    another; on the CPU ``cpu``."""
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    props = torch.cuda.get_device_properties(device)
    name = re.sub(r"[^a-z0-9]+", "-", props.name.lower())
    name = name.strip("-").removeprefix("nvidia-")
    return f"{name}-sm{props.multi_processor_count}"


def time_call(fn: Callable[[], object], device: str, reps: int = 1,
              best_of: int = 3) -> float:
    """Seconds of one ``fn()``: after a warm call (which builds the
    kernels), the best of ``best_of`` rounds, each the mean of ``reps``
    calls between two CUDA events on the card (the host clock on the
    CPU)."""
    fn()
    best = float("inf")
    for _ in range(best_of):
        if device == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            end.synchronize()
            seconds = start.elapsed_time(end) * 1e-3
        else:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            seconds = time.perf_counter() - t0
        best = min(best, seconds / reps)
    return best


def nvidia_smi(query: str = "name,power.limit") -> str:
    """``nvidia-smi --query-gpu=<query> --format=csv,noheader``, as printed
    (one line per card); raises when the tool is missing or fails."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def nvcc_version() -> str:
    """The release line of ``nvcc --version``; raises when nvcc is missing."""
    from ..ops.build import nvcc_path

    out = subprocess.run(
        [nvcc_path(), "--version"], capture_output=True, text=True,
        check=True, timeout=60,
    ).stdout
    lines = [ln for ln in out.splitlines() if "release" in ln]
    return (lines or out.strip().splitlines() or ["?"])[-1].strip()


def capability_dump() -> str:
    lines = [f"torch {torch.__version__}; CUDA runtime {torch.version.cuda}; "
             f"cuda available: {torch.cuda.is_available()}"]
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            p = torch.cuda.get_device_properties(i)
            lines.append(
                f"  device {i}: {p.name}, sm_{p.major}{p.minor}, "
                f"{p.multi_processor_count} SMs, "
                f"{p.total_memory >> 20} MiB")
    for label, probe in (("nvcc", nvcc_version), ("nvidia-smi", nvidia_smi)):
        try:
            lines.append(f"{label}: {probe()}")
        except (OSError, subprocess.SubprocessError) as e:
            lines.append(f"{label}: unavailable ({e})")
    return "\n".join(lines)


if __name__ == "__main__":
    print(capability_dump())
