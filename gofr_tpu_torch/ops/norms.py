"""RMSNorm (counterpart of gofr_tpu/ops/norms.py:14).

Computed in float32 whatever the input type and cast back on exit: bf16
accumulation of the variance loses too much precision.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)
