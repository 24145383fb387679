"""Attention: batched GQA prefill and single-token decode over the slot
cache and the paged pool (counterpart of gofr_tpu/ops/attention.py).

Shapes follow the JAX package: activations [batch, seq, heads, head_dim],
query heads grouped under their KV head ([B, S, Hkv, G, D]) so K/V are
never repeated.

Two layers live here:

- the plain versions (``mha_attention_plain``, ``decode_attention_plain``,
  ``paged_decode_attention_plain``, and ``decode_attention_q_plain`` with
  ``paged_decode_attention_q_plain`` / ``_q4_plain`` for the int8 and
  int4 pools), straightforward PyTorch that mirrors the JAX XLA path op
  for op, bf16 roundings included;
- the public entry points (``mha_attention``, ``decode_attention``,
  ``paged_decode_attention``, ``paged_decode_attention_q``,
  ``paged_decode_attention_q4``), which make the one choice between the
  two: a tensor on the card goes to the CUDA kernel's launcher in
  ``ops/cuda`` (which launches or raises), a tensor on the CPU to the plain
  version. There is no fallback from one to the other. The int8 slot
  decode ``decode_attention_q`` has no kernel: the TPU ran it as XLA.

``decode_attention_split_plain``, ``paged_decode_attention_split_plain`` and
``paged_decode_attention_q_split_plain`` repeat the split-and-merge
arithmetic of kernels F, A and D/E in PyTorch; only the tests and
``chip_smoke.py`` call them.
"""

from __future__ import annotations

import torch

from gofr_tpu_torch.ops.cuda.decode_attention import decode_attention as slot_decode
from gofr_tpu_torch.ops.cuda.flash_attention import flash_attention
from gofr_tpu_torch.ops.cuda.paged_decode import paged_decode
from gofr_tpu_torch.ops.cuda.paged_decode_q import paged_decode_q
from gofr_tpu_torch.ops.cuda.paged_decode_q4 import paged_decode_q4
from gofr_tpu_torch.ops.kvcache import QSlotKVCache, SlotKVCache
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


def _attend_in_runs(scores: torch.Tensor, v: torch.Tensor, lengths: torch.Tensor,
                    split_rows: int, *, p_dtype: torch.dtype | None = None,
                    v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """The split kernels' arithmetic (kernels A, D, E and F) on scores [B, Hkv,
    G, S] f32 and values v [B, Hkv, S, D] f32: positions at or past
    lengths[b] masked, the S positions cut into runs of ``split_rows``, each
    run's (max m, sum l, unnormalised acc) taken in f32 against its own
    max, with P.V weights p rounded to ``p_dtype`` (the bf16 kernels) or
    p * ``v_scale`` [B, Hkv, S] in f32, unrounded (the quantized ones); then
    the live runs (those starting before the length, clamped to [0, S])
    merged: run i rescaled by exp(m_i - M) with the safe-max rule, summed,
    and divided with the 1e-20 clamp. A slot of length 0 has no live run:
    zeros. Returns [B, Hkv, G, D] f32."""
    b, hkv, g, smax = scores.shape
    splits = -(-smax // split_rows)
    pad = splits * split_rows - smax
    length = lengths.to(scores.device).long().clamp(0, smax)
    live_pos = torch.arange(smax, device=scores.device)[None, :] < length[:, None]
    scores = torch.where(live_pos[:, None, None], scores, torch.full_like(scores, NEG_INF))
    runs = torch.nn.functional.pad(scores, (0, pad), value=NEG_INF).reshape(b, hkv, g, splits,
                                                                            split_rows)
    m = runs.amax(dim=-1)                                           # [B, Hkv, G, splits]
    p = torch.exp(runs - m.where(m > NEG_INF / 2, 0.0)[..., None])
    l = p.sum(dim=-1)
    v_runs = torch.nn.functional.pad(v, (0, 0, 0, pad)).reshape(b, hkv, splits, split_rows, -1)
    if v_scale is None:
        weights = p.to(p_dtype).float()
    else:
        weights = p * torch.nn.functional.pad(v_scale, (0, pad)).reshape(b, hkv, 1, splits, split_rows)
    acc = torch.einsum("bkgsr,bksrd->bkgsd", weights, v_runs)
    live = torch.arange(splits, device=scores.device)[None, :] < (-(-length // split_rows))[:, None]
    live = live[:, None, None]                                       # [B, 1, 1, splits]
    top = torch.where(live, m, torch.full_like(m, NEG_INF)).amax(dim=-1, keepdim=True)
    w = torch.where(live, torch.exp(m - top.where(top > NEG_INF / 2, 0.0)), torch.zeros_like(m))
    return (w[..., None] * acc).sum(dim=-2) / torch.clamp((w * l).sum(dim=-1), min=1e-20)[..., None]


def decode_attention_split_plain(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                                 lengths: torch.Tensor, split_rows: int, *,
                                 scale: float | None = None) -> torch.Tensor:
    """``decode_attention`` as kernel F computes it, for the tests: scores
    in f32, the slot cut into runs of ``split_rows`` positions whose
    probabilities are rounded to the cache's type before P.V, the live runs
    merged (``_attend_in_runs``)."""
    b, hq, d = q.shape
    _, hkv, smax, _ = k_cache.shape
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, hkv, hq // hkv, d).float()
    scores = torch.einsum("bkgd,bktd->bkgt", qg, k_cache.float()) * scale
    out = _attend_in_runs(scores, v_cache.float(), lengths, split_rows, p_dtype=v_cache.dtype)
    return out.reshape(b, hq, d).to(q.dtype)


def paged_decode_attention_split_plain(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                                       table: torch.Tensor, lengths: torch.Tensor, split_rows: int,
                                       *, scale: float | None = None) -> torch.Tensor:
    """``paged_decode_attention`` as kernel A computes it, for the tests:
    each slot's rows gathered through the table (OOB entries clamp to page
    P-1), scores in f32, the MaxP x page positions cut into runs of
    ``split_rows`` whose probabilities are rounded to the pool's type before
    P.V, the live runs merged: ``decode_attention_split_plain`` on the
    gathered view."""
    k_view, v_view = gather_kv(k_pool, v_pool, table)
    return decode_attention_split_plain(q, k_view, v_view, lengths, split_rows, scale=scale)


def paged_decode_attention_q_split_plain(q: torch.Tensor, kq_pool: torch.Tensor,
                                         vq_pool: torch.Tensor, ks_pool: torch.Tensor,
                                         vs_pool: torch.Tensor, table: torch.Tensor,
                                         lengths: torch.Tensor, split_rows: int, *, bits: int,
                                         scale: float | None = None) -> torch.Tensor:
    """``paged_decode_attention_q`` (``bits`` 8) or ``_q4`` (4) as kernels
    D and E compute it, for the tests: each slot's rows and scales gathered
    through the table (OOB entries clamp to page P-1), scores
    (q.k) * scale * ks in f32, the MaxP x page positions cut into runs of
    ``split_rows`` whose P.V weights are p * vs in f32, unrounded (the
    Pallas kernels' v_scale fold), the live runs merged
    (``_attend_in_runs``)."""
    gather = gather_kv_q if bits == 8 else gather_kv_q4
    kq, ks = gather(kq_pool, ks_pool, table)
    vq, vs = gather(vq_pool, vs_pool, table)
    b, hq, d = q.shape
    hkv = kq.shape[1]
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, hkv, hq // hkv, d).float()
    scores = torch.einsum("bkgd,bktd->bkgt", qg, kq.float()) * scale * ks[:, :, None].float()
    out = _attend_in_runs(scores, vq.float(), lengths, split_rows, v_scale=vs.float())
    return out.reshape(b, hq, d).to(q.dtype)


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


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     lengths: torch.Tensor, *, scale: float | None = None) -> torch.Tensor:
    """Single-token decode against the slot cache (attention.py:169): q
    [B, Hq, D]; layer slices [B, Hkv, Smax, D]; lengths [B], clamped to
    [0, Smax]. The kernel on the card, the plain version on the CPU."""
    attend = slot_decode if q.is_cuda else decode_attention_plain
    return attend(q, k_cache, v_cache, lengths, scale=scale)


def decode_attention_q(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                       k_scale: torch.Tensor, v_scale: torch.Tensor, lengths: torch.Tensor,
                       *, scale: float | None = None) -> torch.Tensor:
    """Single-token decode against the int8 slot cache (attention.py:219):
    values [B, Hkv, Smax, D] int8, scales [B, Hkv, Smax] bf16. Plain
    PyTorch on both devices: the TPU ran it as XLA, with no kernel to port."""
    return decode_attention_q_plain(q, k_cache, v_cache, k_scale, v_scale, lengths, scale=scale)


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


# Each cache format's decode attention, (entry point, plain version), called
# as fn(q, *cache.planes(layer, table), lengths): a paged pool's planes end
# with the block table, a slot cache takes none (lane n is slot n).
DECODE_ATTENTION = {
    SlotKVCache: (decode_attention, decode_attention_plain),
    QSlotKVCache: (decode_attention_q, decode_attention_q_plain),
    PagedKVCache: (paged_decode_attention, paged_decode_attention_plain),
    QPagedKVCache: (paged_decode_attention_q, paged_decode_attention_q_plain),
    Q4PagedKVCache: (paged_decode_attention_q4, paged_decode_attention_q4_plain),
}
