"""Which device the port runs on, what that card is, and the card as a
datasource.

Counterpart of gofr_tpu/tpu/device.py. Every entry point resolves its
``device`` argument here (``resolve_device``), so "no card and the caller
did not ask for the CPU" is one error in one place rather than a silent
CPU run. ``GPUDevices`` is ``TPUDevices``'s counterpart, the container's
``tpu`` datasource: the device the port serves on, the serving mesh, its
memory gauges and a health check, under the JAX package's config keys:

    TPU_DEVICES         cap the number of devices counted (default: all;
                        the port counts the one card it serves on)
    TPU_MESH            the mesh, e.g. "dp:1" (default: the one device the
                        port serves on); a mesh over more than one device
                        is refused: sharding across cards is not ported yet
                        (ROADMAP.md Queue A 9, parallel/)

The JAX datasource's compile counter (``record_compile``) has no eager
counterpart and is left out, as is its multi-host bring-up
(``JAX_COORDINATOR``), which waits for the same queue item.
"""

from __future__ import annotations

import math
import subprocess
from typing import Any

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


# the JAX package's mesh axis names (gofr_tpu/parallel/mesh.py:AXES)
MESH_AXES = ("dp", "fsdp", "pp", "ep", "sp", "tp")


def parse_mesh(text: str, n_devices: int) -> dict[str, int]:
    """``TPU_MESH`` in the JAX package's form (``"dp:2,tp:4"``, ``"tp=4"``,
    one axis of ``-1`` filled with the devices left), resolved against
    ``n_devices`` with its errors (gofr_tpu/parallel/mesh.py:39-83)."""
    pairs: list[tuple[str, int]] = []
    for part in text.replace("=", ":").split(","):
        part = part.strip()
        if not part:
            continue
        name, _, size_s = part.partition(":")
        name = name.strip()
        if name not in MESH_AXES:
            raise ValueError(f"unknown mesh axis {name!r}; valid: {MESH_AXES}")
        try:
            size = int(size_s)
        except ValueError:
            raise ValueError(f"bad mesh axis size in {part!r}") from None
        pairs.append((name, size))
    if not pairs:
        raise ValueError(f"empty mesh spec {text!r}")
    names = [n for n, _ in pairs]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate axis in mesh spec {text!r}")
    if sum(1 for _, s in pairs if s == -1) > 1:
        raise ValueError(f"at most one -1 axis allowed: {text!r}")
    fixed = math.prod(s for _, s in pairs if s != -1)
    if fixed <= 0:
        raise ValueError(f"mesh axis sizes must be positive: {tuple(pairs)}")
    mesh = {}
    for name, size in pairs:
        if size == -1:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"cannot fill axis {name!r}: {n_devices} devices not divisible by {fixed}")
            size = n_devices // fixed
        mesh[name] = size
    if math.prod(mesh.values()) > n_devices:
        raise ValueError(f"mesh {mesh} needs {math.prod(mesh.values())} devices, "
                         f"have {n_devices}")
    return mesh


class GPUDevices:
    """The card as a datasource (``TPUDevices``, gofr_tpu/tpu/device.py:58-138):
    the one device the port serves on, resolved with ``resolve_device``
    (the card unless ``device`` names the CPU) and capped by
    ``TPU_DEVICES``; the serving mesh; ``app_tpu_device_count`` set once
    and ``app_tpu_hbm_used_bytes`` / ``app_tpu_hbm_limit_bytes`` pushed
    from ``torch.cuda.mem_get_info`` (zeros on the CPU, as JAX reports a
    CPU backend); and a health check in JAX's shape with the card's name.
    Other visible cards are never touched: reading their memory would
    create a CUDA context on a card the port does not use."""

    def __init__(self, config, logger, metrics, device: str | torch.device | None = None):
        self.config = config
        self.logger = logger
        self.metrics = metrics
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            if self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
            visible = torch.cuda.device_count()
            self.platform = "gpu"
        else:
            visible = 1
            self.platform = self.device.type
        limit = config.get_int("TPU_DEVICES", 0)
        if limit > 0:
            visible = min(visible, limit)
        self.devices = [self.device]
        # a mesh is resolved against the visible cards (TPU_DEVICES-capped),
        # so one that spans more than the card served on is refused by name
        text = config.get("TPU_MESH")
        self.mesh = parse_mesh(text, visible) if text else {"dp": 1}
        if math.prod(self.mesh.values()) > 1:
            raise RuntimeError(
                f"TPU_MESH={text!r} spans {math.prod(self.mesh.values())} devices: the port "
                "serves on one card; sharding across cards is not ported yet (ROADMAP.md "
                "Queue A 9, parallel/)")
        self.name = torch.cuda.get_device_name(self.device) if self.platform == "gpu" else "cpu"
        metrics.set_gauge("app_tpu_device_count", len(self.devices))
        self._push_memory_gauges()
        logger.infof("GPU datasource: %d %s device(s) (%s), mesh %s",
                     len(self.devices), self.platform, self.name, self.mesh)

    # -- stats -----------------------------------------------------------------

    def memory_stats(self) -> dict[str, dict[str, int]]:
        """Memory of the device served on: ``bytes_in_use`` (total less
        free, every process's allocations on the card) and ``bytes_limit``
        (the card's total), keyed by device index; zeros on the CPU."""
        stats: dict[str, dict[str, int]] = {}
        for i, d in enumerate(self.devices):
            used = limit = 0
            if d.type == "cuda":
                try:
                    free, total = torch.cuda.mem_get_info(d)
                    used, limit = total - free, total
                except RuntimeError:  # a device hiccup reads as zeros
                    pass
            stats[str(d.index if d.index is not None else i)] = {
                "bytes_in_use": int(used), "bytes_limit": int(limit)}
        return stats

    def _push_memory_gauges(self) -> None:
        for dev_id, s in self.memory_stats().items():
            self.metrics.set_gauge("app_tpu_hbm_used_bytes", s["bytes_in_use"], device=dev_id)
            self.metrics.set_gauge("app_tpu_hbm_limit_bytes", s["bytes_limit"], device=dev_id)

    # -- health (container/health.go parity) -----------------------------------

    def health_check(self) -> dict[str, Any]:
        try:
            n = len(self.devices)
            if n == 0:
                return {"status": "DOWN", "details": {"error": "no devices visible"}}
            self._push_memory_gauges()
            return {
                "status": "UP",
                "details": {
                    "platform": self.platform,
                    "name": self.name,
                    "devices": n,
                    "mesh": dict(self.mesh),
                    "memory": self.memory_stats(),
                },
            }
        except Exception as e:  # noqa: BLE001
            return {"status": "DOWN", "details": {"error": str(e)}}
