"""RMSNorm and LayerNorm (counterpart of gofr_tpu/ops/norms.py:14, :22).

Computed in float32 whatever the input type and cast back on exit: bf16
accumulation of the variance loses too much precision. Both are XLA in
JAX, not Pallas kernels, so plain PyTorch is their port on every device.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-12) -> torch.Tensor:
    """(x - mean) / sqrt(var + eps) * weight + bias over the last axis, with
    the population variance (``jnp.var``'s), in f32."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    normed = (xf - mean) / torch.sqrt(var + eps)
    return (normed * weight.float() + bias.float()).to(x.dtype)
