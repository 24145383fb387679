"""Symmetric int8 row quantization of K/V (counterpart of the int8 row
helpers of gofr_tpu/ops/kvcache.py).

The int8 paged pool (``ops.paged.QPagedKVCache``) stores each K/V row of
``head_dim`` values as int8 plus one bf16 scale per row. These are the
format's three definitions, bit for bit those of the JAX package:

- ``quantize_row``    x → (int8 q, f32 scale) over the last axis (:103)
- ``fake_quant_row``  x → what the pool stores, dequantized (:148)
- ``dequantize_view`` int8 × scales → a dense view (:162)

The slot-layout parts of the JAX module (``SlotKVCache``,
``QSlotKVCache`` and their write/append paths) come with the slot-layout
slice of the port.
"""

from __future__ import annotations

import torch


def quantize_row(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over the last (head_dim) axis: (q int8, scale f32
    without the reduced axis). The scale is max(|x|, 1e-8) / 127; q is
    x / scale rounded half to even and clipped to ±127."""
    xf = x.float()
    s = torch.clamp(xf.abs().amax(dim=-1), min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127).to(torch.int8)
    return q, s


def fake_quant_row(x: torch.Tensor) -> torch.Tensor:
    """Round-trip ``x`` through int8 row quantization exactly as the pool
    stores it and the read path dequantizes it: the scale passes through
    the pool's bf16, and the cast/multiply order is ``dequantize_view``'s.
    Whole-prompt prefill attends to this, so a prompt attends to what a
    later read of its pages returns."""
    q, s = quantize_row(x)
    return q.to(x.dtype) * s.to(torch.bfloat16)[..., None].to(x.dtype)


def dequantize_view(cache_q: torch.Tensor, cache_s: torch.Tensor,
                    dtype: torch.dtype) -> torch.Tensor:
    """[..., S, D] quantized values × [..., S] scales → a dense ``dtype``
    view (the chunked-prefill read path; decode reads the pool itself)."""
    return cache_q.to(dtype) * cache_s[..., None].to(dtype)
