"""The device checks shared by the scripts that measure or smoke-test the GPU:
stop unless JAX sees NVIDIA GPUs (no CPU fallback), and read the card's name
and power limit, which every device number is reported beside."""

from __future__ import annotations

import subprocess


def require_gpu(devices, count: int = 1, who: str = "this script") -> None:
    """Stop unless the first ``count`` JAX devices are GPUs."""
    platform = devices[0].platform if devices else "none"
    if platform != "gpu" or len(devices) < count:
        raise SystemExit(
            f"{who}: needs {count} NVIDIA GPU(s); JAX found "
            f"{len(devices)} {platform} device(s). No CPU fallback."
        )


def nvidia_smi() -> str:
    """The cards' name and power limit, one line per card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()
