"""What the port runs on: the port's ``grayscott_tpu/utils/device.py:
capability_dump``, reduced to the CUDA device, the toolkit and the card's
power limit (a card set below its maximum runs slower under load, so every
measurement is kept beside it).

    python -m grayscott_tpu_torch.utils.device
"""

from __future__ import annotations

import subprocess

import torch


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
