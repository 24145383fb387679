"""The packed-int4 row format of the int4 paged pool (counterpart of the
int4 helpers of gofr_tpu/ops/quant.py, :118-158).

Symmetric per-row int4 over the last (head_dim) axis, range ±7 (the -8
code is left unused so the scale max|x|/7 round-trips 0 and negation is
lossless). Two values pack per byte in SPLIT-HALF order: byte j of a
D-wide row holds element j in its low nibble and element j + D/2 in its
high nibble, each biased by +8. The pool (``ops.paged.Q4PagedKVCache``),
the decode kernel (``csrc/paged_decode_q.cu``) and the plain read path all
use these definitions.

The weight-only int8 products of the JAX module (``QTensor``, ``qdot``)
are not part of this slice.
"""

from __future__ import annotations

import torch

from gofr_tpu_torch.ops.kvcache import ieee_div


def quantize_row_int4(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int4 over the last axis: (q int8 in [-7, 7], scale f32
    without the reduced axis). Pack with ``pack_int4``. The scale is an IEEE
    quotient on either device (``ops.kvcache.ieee_div``)."""
    xf = x.float()
    s = ieee_div(torch.clamp(xf.abs().amax(dim=-1), min=1e-8), 7.0)
    q = torch.clamp(torch.round(xf / s[..., None]), -7, 7).to(torch.int8)
    return q, s


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """[..., D] int8 nibbles in [-8, 7] → [..., D//2] uint8, byte j =
    (q[j] + 8) | ((q[j + D/2] + 8) << 4). The cast to uint8 comes before
    the shift: a biased high nibble reaches 15 << 4 = 240."""
    d = q.shape[-1]
    lo = (q[..., : d // 2] + 8).to(torch.uint8)
    hi = (q[..., d // 2:] + 8).to(torch.uint8)
    return lo | (hi << 4)


def unpack_int4(b: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack_int4``: [..., D//2] uint8 → [..., D] int8 in
    [-8, 7], low nibbles first, then high."""
    bi = b.to(torch.int32)
    return torch.cat([(bi & 0xF) - 8, ((bi >> 4) & 0xF) - 8], dim=-1).to(torch.int8)


def fake_quant_row_int4(x: torch.Tensor) -> torch.Tensor:
    """Round-trip ``x`` through int4 row quantization exactly as the packed
    pool stores it and the read path dequantizes it, its scale through the
    pool's bf16 (the int4 analog of ``ops.kvcache.fake_quant_row``)."""
    q, s = quantize_row_int4(x)
    return q.to(x.dtype) * s.to(torch.bfloat16)[..., None].to(x.dtype)
