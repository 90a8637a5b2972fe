"""The card a run is on: its name, count, power limit and clocks."""

from __future__ import annotations

import subprocess
from typing import Dict

import torch

QUERY = "name,power.limit,clocks.sm,clocks.max.sm"


def identity() -> Dict[str, str]:
    """What ``torch`` and ``nvidia-smi`` say of the cards."""
    out = {"torch_name": torch.cuda.get_device_name(0),
           "count": str(torch.cuda.device_count()),
           "torch": torch.__version__, "cuda": str(torch.version.cuda)}
    try:
        smi = subprocess.run(
            ["nvidia-smi", f"--query-gpu={QUERY}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        out["nvidia_smi"] = smi.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        out["nvidia_smi"] = f"not read ({type(e).__name__})"
    return out


def line(info: Dict[str, str]) -> str:
    return (f"card: {info['torch_name']} x{info['count']}; nvidia-smi "
            f"({QUERY}): {info['nvidia_smi']}; torch {info['torch']}, "
            f"CUDA {info['cuda']}")
