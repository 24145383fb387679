"""Rotary position embeddings, Llama half-split layout (counterpart of
gofr_tpu/ops/rope.py:14,30).

The cos/sin tables are float32 ``[max_len, head_dim // 2]``, built once per
model and indexed by position, so prefill and decode share one path.
"""

from __future__ import annotations

import torch


def rope_table(max_len: int, head_dim: int, theta: float = 10000.0,
               scaling: float = 1.0, device: str | torch.device = "cpu"
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each float32 [max_len, head_dim // 2]. ``scaling`` > 1 is
    linear position interpolation."""
    half = head_dim // 2
    inv_freq = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=device) / half))
    positions = torch.arange(max_len, dtype=torch.float32, device=device) / scaling
    angles = torch.outer(positions, inv_freq)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, cos_table: torch.Tensor,
               sin_table: torch.Tensor) -> torch.Tensor:
    """Rotate ``x`` [..., seq, heads, head_dim] by the angles at ``positions``
    [..., seq]: x1 is the first half, x2 the second (HF ``rotate_half``). The
    rotation runs in float32 (the tables' type) and casts back."""
    cos = cos_table[positions].unsqueeze(-2)  # [..., seq, 1, half]
    sin = sin_table[positions].unsqueeze(-2)
    x1, x2 = x.chunk(2, dim=-1)
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rotated.to(x.dtype)
