"""Attention: batched GQA prefill and single-token paged decode
(counterpart of gofr_tpu/ops/attention.py).

Shapes follow the JAX package: activations [batch, seq, heads, head_dim],
query heads grouped under their KV head ([B, S, Hkv, G, D]) so K/V are
never repeated.

Two layers live here:

- the plain versions (``mha_attention_plain``, ``decode_attention_plain``,
  ``paged_decode_attention_plain``, and ``decode_attention_q_plain`` with
  ``paged_decode_attention_q_plain`` / ``_q4_plain`` for the int8 and
  int4 pools), straightforward PyTorch that mirrors the JAX XLA path op
  for op, bf16 roundings included;
- the public entry points (``mha_attention``, ``paged_decode_attention``,
  ``paged_decode_attention_q``, ``paged_decode_attention_q4``), which make
  the one choice between the two: a tensor on the card goes to
  the CUDA kernel's launcher in ``ops/cuda`` (which launches or raises), a
  tensor on the CPU to the plain version. There is no fallback from one to
  the other.
"""

from __future__ import annotations

import torch

from gofr_tpu_torch.ops.cuda.flash_attention import flash_attention
from gofr_tpu_torch.ops.cuda.paged_decode import paged_decode
from gofr_tpu_torch.ops.cuda.paged_decode_q import paged_decode_q
from gofr_tpu_torch.ops.cuda.paged_decode_q4 import paged_decode_q4
from gofr_tpu_torch.ops.paged import (
    PagedKVCache,
    Q4PagedKVCache,
    QPagedKVCache,
    gather_kv,
    gather_kv_q,
    gather_kv_q4,
)

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


def decode_attention_q_plain(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                             k_scale: torch.Tensor, v_scale: torch.Tensor, lengths: torch.Tensor,
                             *, scale: float | None = None) -> torch.Tensor:
    """Decode against a quantized head-major cache (attention.py:219): q
    [B, Hq, D]; k/v values [B, Hkv, S, D] (int8, or unpacked int4) with
    per-position scales [B, Hkv, S]. The values convert to q's type at the
    product; ``k_scale`` multiplies the scores, ``v_scale`` the
    probabilities, which are then rounded to q's type before P.V."""
    b, hq, d = q.shape
    _, hkv, smax, _ = k_cache.shape
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, hkv, hq // hkv, d)
    scores = torch.einsum("bkgd,bktd->bkgt", qg, k_cache.to(q.dtype)).float()
    scores = scores * k_scale[:, :, None, :].float() * scale
    mask = torch.arange(smax, device=q.device)[None, :] < lengths.to(q.device)[:, None]
    scores = torch.where(mask[:, None, None], scores, torch.full_like(scores, NEG_INF))
    probs = _softmax(scores)
    pv = (probs * v_scale[:, :, None, :].float()).to(q.dtype)
    out = torch.einsum("bkgt,bktd->bkgd", pv, v_cache.to(q.dtype))
    return out.reshape(b, hq, d)


def paged_decode_attention_q_plain(q: torch.Tensor, kq_pool: torch.Tensor, vq_pool: torch.Tensor,
                                   ks_pool: torch.Tensor, vs_pool: torch.Tensor,
                                   table: torch.Tensor, lengths: torch.Tensor, *,
                                   scale: float | None = None) -> torch.Tensor:
    """Decode against the int8 pool by gathering each slot's int8 rows and
    scales and running ``decode_attention_q_plain`` (attention.py:359)."""
    gkq, gks = gather_kv_q(kq_pool, ks_pool, table)
    gvq, gvs = gather_kv_q(vq_pool, vs_pool, table)
    return decode_attention_q_plain(q, gkq, gvq, gks, gvs, lengths, scale=scale)


def paged_decode_attention_q4_plain(q: torch.Tensor, kq_pool: torch.Tensor, vq_pool: torch.Tensor,
                                    ks_pool: torch.Tensor, vs_pool: torch.Tensor,
                                    table: torch.Tensor, lengths: torch.Tensor, *,
                                    scale: float | None = None) -> torch.Tensor:
    """Decode against the packed int4 pool: gather, unpack after the gather,
    then ``decode_attention_q_plain`` (attention.py:433)."""
    gkq, gks = gather_kv_q4(kq_pool, ks_pool, table)
    gvq, gvs = gather_kv_q4(vq_pool, vs_pool, table)
    return decode_attention_q_plain(q, gkq, gvq, gks, gvs, lengths, scale=scale)


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


def paged_decode_attention_q(q: torch.Tensor, kq_pool: torch.Tensor, vq_pool: torch.Tensor,
                             ks_pool: torch.Tensor, vs_pool: torch.Tensor, table: torch.Tensor,
                             lengths: torch.Tensor, *, scale: float | None = None) -> torch.Tensor:
    """Single-token decode against the int8 pool: q [N, Hq, D]; values
    [P, Hkv, page, D] int8; scales [P, Hkv, page] bf16; table [N, MaxP]
    (OOB entries == P); lengths [N]. The kernel on the card, the plain
    version on the CPU."""
    attend = paged_decode_q if q.is_cuda else paged_decode_attention_q_plain
    return attend(q, kq_pool, vq_pool, ks_pool, vs_pool, table, lengths, scale=scale)


def paged_decode_attention_q4(q: torch.Tensor, kq_pool: torch.Tensor, vq_pool: torch.Tensor,
                              ks_pool: torch.Tensor, vs_pool: torch.Tensor, table: torch.Tensor,
                              lengths: torch.Tensor, *, scale: float | None = None) -> torch.Tensor:
    """Single-token decode against the packed int4 pool (values uint8
    [P, Hkv, page, D//2]); otherwise as ``paged_decode_attention_q``."""
    attend = paged_decode_q4 if q.is_cuda else paged_decode_attention_q4_plain
    return attend(q, kq_pool, vq_pool, ks_pool, vs_pool, table, lengths, scale=scale)


# Each pool format's decode attention, (entry point, plain version), called
# as fn(q, *cache.planes(layer), table, lengths).
DECODE_ATTENTION = {
    PagedKVCache: (paged_decode_attention, paged_decode_attention_plain),
    QPagedKVCache: (paged_decode_attention_q, paged_decode_attention_q_plain),
    Q4PagedKVCache: (paged_decode_attention_q4, paged_decode_attention_q4_plain),
}
