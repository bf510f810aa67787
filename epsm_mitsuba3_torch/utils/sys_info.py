"""System information (counterpart of ``utils/sys_info.py``; the
reference's src/python/python/sys_info.py): the port's versions and the
devices it would run on."""
from __future__ import annotations

import platform
import subprocess


def _power_limits():
    """Each card's name and power limit as ``nvidia-smi`` reports them, or
    None where it does not answer."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]
    return lines if out.returncode == 0 and lines else None


def info() -> dict:
    """torch's and CUDA's versions, the device names and count (the CPU
    where CUDA is absent), the power limits where ``nvidia-smi``
    answers, and Python's version and platform."""
    import torch
    cuda = torch.cuda.is_available()
    n = torch.cuda.device_count() if cuda else 0
    return {
        "framework": "epsm_mitsuba3_torch",
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "backend": "cuda" if cuda else "cpu",
        "devices": ([torch.cuda.get_device_name(i) for i in range(n)]
                    if cuda else ["cpu"]),
        "device_count": n if cuda else 1,
        "power_limits": _power_limits() if cuda else None,
        "python": platform.python_version(),
        "platform": platform.platform(),
    }


def print_info():
    for k, v in info().items():
        print(f"{k:>14}: {v}")
