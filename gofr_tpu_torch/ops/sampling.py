"""Token sampling (counterpart of gofr_tpu/ops/sampling.py:17,40).

Randomness comes from an explicit ``torch.Generator`` on the logits' device,
so a run is reproducible from its seed. The draws are not JAX's threefry
bits: the two are held to the same distribution, not the same tokens.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def truncate_logits(logits: torch.Tensor, top_k: int = 0, top_p: float = 1.0) -> torch.Tensor:
    """Mask (to NEG_INF) everything outside the top_k / nucleus top_p set
    along the last axis. The top-1 is always kept, so top_p=0 is greedy."""
    if 0 < top_k < logits.shape[-1]:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, torch.full_like(logits, NEG_INF), logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.softmax(sorted_logits, dim=-1).cumsum(dim=-1)
        # keep tokens while the cumulative probability BEFORE them is < top_p
        keep = torch.roll(cum, 1, dims=-1) < top_p
        keep[..., 0] = True
        inf = torch.full_like(sorted_logits, float("inf"))
        cutoff = torch.where(keep, sorted_logits, inf).min(dim=-1, keepdim=True).values
        logits = torch.where(logits < cutoff, torch.full_like(logits, NEG_INF), logits)
    return logits


def sample_token(logits: torch.Tensor, generator: torch.Generator | None, *,
                 temperature: torch.Tensor | float = 1.0, top_k: int = 0,
                 top_p: float = 1.0, do_sample: bool = True) -> torch.Tensor:
    """Next tokens from ``logits`` [B, V] → [B] int32. ``temperature`` is a
    scalar or per-row [B]; rows with temperature <= 0 are greedy, so greedy
    and sampled requests share one step."""
    greedy = logits.argmax(dim=-1).to(torch.int32)
    if not do_sample:
        return greedy
    temp = torch.as_tensor(temperature, dtype=torch.float32, device=logits.device)
    scaled = logits.float() / torch.clamp(temp[:, None] if temp.ndim == 1 else temp, min=1e-6)
    probs = torch.softmax(truncate_logits(scaled, top_k, top_p), dim=-1)
    sampled = torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)
    return torch.where(temp > 0, sampled, greedy)
