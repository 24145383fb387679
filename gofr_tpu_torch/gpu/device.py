"""Which device the port runs on, and what that card is.

Counterpart of gofr_tpu/tpu/device.py (``TPUDevices``), reduced to what a
single-card port needs: every entry point resolves its ``device`` argument
here, so "no card and the caller did not ask for the CPU" is one error in
one place rather than a silent CPU run.
"""

from __future__ import annotations

import subprocess

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the card. A CUDA device without a card raises; the CPU
    is used only when the caller names it (the tests do)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev


def device_info(device: str | torch.device | None = None) -> dict:
    """Name, memory and power limit of the card (raises without one).

    ``nvidia_smi`` is the raw line of ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` for this card, kept verbatim so a
    measurement can carry it beside its numbers."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"device_info describes a CUDA card, got {dev}")
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    props = torch.cuda.get_device_properties(index)
    smi = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=30,
    ).stdout.strip()
    return {
        "name": torch.cuda.get_device_name(index),
        "index": index,
        "count": torch.cuda.device_count(),
        "memory_bytes": int(props.total_memory),
        "sm_count": int(props.multi_processor_count),
        "capability": f"{props.major}.{props.minor}",
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "nvidia_smi": smi,
    }
