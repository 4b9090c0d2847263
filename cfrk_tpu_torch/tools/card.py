"""What the counting tools share: the device they run on, the record
that names it, and the kernels' launch counts.

``onchip_validate``, ``onchip_fuzz``, ``fuzz_cli`` and ``scale_demo`` run
on the card unless the caller passes ``--device cpu``; with no visible
GPU, ``--device cuda`` exits with an error (no quiet CPU fallback).
"""

from __future__ import annotations

import subprocess

import torch

from ..cli import _resolve_device
from ..ops.cuda.build import KERNELS
from ..runtime.metrics import counters

resolve_device = _resolve_device


def add_device_argument(ap) -> None:
    ap.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="cuda (the default) runs the CUDA kernels and exits without a "
             "visible GPU; cpu runs the plain PyTorch route",
    )


def card_line() -> str | None:
    """``nvidia-smi``'s name and power limit of the first card, or None
    where there is no ``nvidia-smi``."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    lines = proc.stdout.strip().splitlines()
    return lines[0] if lines else None


def device_record(device: torch.device) -> dict:
    """The platform, card and versions a tool's record names."""
    on_gpu = device.type == "cuda"
    return {
        "platform": "gpu" if on_gpu else "cpu",
        "device_kind": torch.cuda.get_device_name(device) if on_gpu else "cpu",
        "device_count": torch.cuda.device_count() if on_gpu else 0,
        "card": card_line() if on_gpu else None,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }


def launches() -> dict:
    """Each kernel's launch count so far in this process (since the last
    ``runtime.metrics.reset()``)."""
    c = counters()
    return {name: c.get(f"cfrk.{name}.launches", 0) for name in KERNELS}


def launches_since(before: dict) -> dict:
    """Each kernel's launches since ``before``, a :func:`launches`."""
    return {name: n - before[name] for name, n in launches().items()}
