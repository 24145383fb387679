"""Attention: batched GQA prefill and single-token paged decode
(counterpart of gofr_tpu/ops/attention.py).

Shapes follow the JAX package: activations [batch, seq, heads, head_dim],
query heads grouped under their KV head ([B, S, Hkv, G, D]) so K/V are
never repeated.

Two layers live here:

- the plain versions (``mha_attention_plain``, ``decode_attention_plain``,
  ``paged_decode_attention_plain``), straightforward PyTorch that mirrors
  the JAX XLA path op for op, bf16 roundings included;
- the public entry points (``mha_attention``, ``paged_decode_attention``),
  which make the one choice between the two: a tensor on the card goes to
  the CUDA kernel's launcher in ``ops/cuda`` (which launches or raises), a
  tensor on the CPU to the plain version. There is no fallback from one to
  the other.
"""

from __future__ import annotations

import torch

from gofr_tpu_torch.ops.cuda.flash_attention import flash_attention
from gofr_tpu_torch.ops.cuda.paged_decode import paged_decode
from gofr_tpu_torch.ops.paged import gather_kv

NEG_INF = -1e30


def _softmax(scores: torch.Tensor) -> torch.Tensor:
    """Softmax in f32 that returns zeros (not NaN) for fully masked rows
    (attention.py:160)."""
    m = scores.amax(dim=-1, keepdim=True)
    unnorm = torch.exp(scores - torch.clamp(m, min=NEG_INF / 2))
    return unnorm / torch.clamp(unnorm.sum(dim=-1, keepdim=True), min=1e-20)


def _per_batch(value: torch.Tensor | int | None, b: int, fill: int,
               device: torch.device) -> torch.Tensor:
    if value is None:
        value = fill
    return torch.as_tensor(value, dtype=torch.int32, device=device).expand(b)


def mha_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, q_offset: torch.Tensor | int = 0,
                        kv_lengths: torch.Tensor | None = None,
                        scale: float | None = None) -> torch.Tensor:
    """q [B, Sq, Hq, D]; k, v [B, Skv, Hkv, D] → [B, Sq, Hq, D]
    (attention.py:62). ``q_offset`` [B] or scalar shifts the query positions
    for causal masking (chunked prefill); ``kv_lengths`` [B] masks padded
    keys. Scores are taken in the input type and widened to f32, as XLA
    does for the JAX path."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, sq, hkv, hq // hkv, d)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).float() * scale
    kv_pos = torch.arange(skv, device=q.device)
    mask = torch.ones((b, sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        q_pos = torch.arange(sq, device=q.device)[None, :] + _per_batch(q_offset, b, 0, q.device)[:, None]
        mask = mask & (q_pos[:, :, None] >= kv_pos[None, None, :])
    if kv_lengths is not None:
        mask = mask & (kv_pos[None, None, :] < kv_lengths.to(q.device)[:, None, None])
    scores = torch.where(mask[:, None, None], scores, torch.full_like(scores, NEG_INF))
    probs = _softmax(scores)
    out = torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype), v)
    return out.reshape(b, sq, hq, d)


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                           lengths: torch.Tensor, *, scale: float | None = None) -> torch.Tensor:
    """q [B, Hq, D] against a head-major cache [B, Hkv, S, D], attending to
    positions < lengths[b] (attention.py:169, XLA branch) → [B, Hq, D]."""
    b, hq, d = q.shape
    _, hkv, smax, _ = k_cache.shape
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, hkv, hq // hkv, d)
    scores = torch.einsum("bkgd,bktd->bkgt", qg, k_cache).float() * scale
    mask = torch.arange(smax, device=q.device)[None, :] < lengths.to(q.device)[:, None]
    scores = torch.where(mask[:, None, None], scores, torch.full_like(scores, NEG_INF))
    probs = _softmax(scores)
    out = torch.einsum("bkgt,bktd->bkgd", probs.to(v_cache.dtype), v_cache)
    return out.reshape(b, hq, d)


def paged_decode_attention_plain(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                                 table: torch.Tensor, lengths: torch.Tensor, *,
                                 scale: float | None = None) -> torch.Tensor:
    """Decode against the paged pool by gathering each slot's logical view
    and running dense decode (attention.py:459-499)."""
    k_view, v_view = gather_kv(k_pool, v_pool, table)
    return decode_attention_plain(q, k_view, v_view, lengths, scale=scale)


def mha_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, q_offset: torch.Tensor | int = 0,
                  kv_lengths: torch.Tensor | None = None,
                  scale: float | None = None) -> torch.Tensor:
    """Prefill attention: the flash kernel on the card, the plain version on
    the CPU (same contract as ``mha_attention_plain``)."""
    attend = flash_attention if q.is_cuda else mha_attention_plain
    return attend(q, k, v, causal=causal, q_offset=q_offset, kv_lengths=kv_lengths, scale=scale)


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                           table: torch.Tensor, lengths: torch.Tensor, *,
                           scale: float | None = None) -> torch.Tensor:
    """Single-token decode against the paged pool: q [N, Hq, D]; pools
    [P, Hkv, page, D]; table [N, MaxP] (OOB entries == P); lengths [N]. The
    kernel on the card, the plain version on the CPU."""
    attend = paged_decode if q.is_cuda else paged_decode_attention_plain
    return attend(q, k_pool, v_pool, table, lengths, scale=scale)
