"""Batched multi-LoRA logits delta for a batch that mixes adapters
(counterpart of gofr_tpu/ops/lora.py).

Every lane of a prefill, decode or verify step names a slot of the device
adapter pool (``adapters.AdapterPool``); the lane's low-rank factors are
gathered out of the pool and its delta

    delta = scale[sel] * (x @ a[sel]) @ b[sel]

is added to the base model's logits at the head. LoRA at the head only
keeps the KV cache independent of the adapter, so the prefix cache serves
every adapter from the same pages.

Exactness (as in the JAX package): pool slot 0 is the base slot, all zeros
with scale 0, so a lane without an adapter gets a delta of exactly 0.0 and
its logits are bit-identical to an engine without adapters; ranks below
the pool's are zero-padded and add exact zeros; lanes never mix. The math
runs in f32 whatever the model's dtype. The JAX package computes it with
two einsums outside any Pallas kernel, so here it is plain PyTorch: one
gather per factor and two batched products.
"""

from __future__ import annotations

import torch


def lora_logits_delta(x: torch.Tensor, adapters) -> torch.Tensor:
    """Per-lane low-rank logits delta, gathered from the adapter pool.

    ``x`` is the hidden state entering the head, after the final norm:
    ``[N, E]`` (prefill's last rows, decode) or ``[N, T, E]`` (verify).
    ``adapters`` is ``(sel, a, b, scale)``: ``sel`` [N] the lanes' pool
    slots (0 = base), ``a`` [S, E, R], ``b`` [S, R, V] and ``scale`` [S]
    the pool. Returns the f32 delta shaped ``x.shape[:-1] + (V,)``."""
    sel, a, b, scale = adapters
    n, e = x.shape[0], x.shape[-1]
    aw = a.index_select(0, sel).float()               # [N, E, R]
    bw = b.index_select(0, sel).float()               # [N, R, V]
    low = torch.bmm(x.reshape(n, -1, e).float(), aw)  # [N, T, R]
    delta = torch.bmm(low, bw)                        # [N, T, V]
    delta = delta * scale.index_select(0, sel).float()[:, None, None]
    return delta.reshape(*x.shape[:-1], delta.shape[-1])


__all__ = ["lora_logits_delta"]
