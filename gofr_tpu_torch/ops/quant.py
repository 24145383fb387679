"""Weight-only int8 for serving, and the packed-int4 row format of the
int4 paged pool (counterpart of gofr_tpu/ops/quant.py).

Weight-only int8 (gofr_tpu/ops/quant.py:35-100): every linear weight is
stored as int8 with one f32 scale per output channel, so a decode step,
which reads every weight once, reads half the bytes of bf16. The port
keeps ``nn.Linear``'s ``[out, in]`` layout, so a ``QTensor`` holds ``q``
int8 ``[out, in]`` (the contraction axis contiguous per output channel)
and ``s`` f32 ``[out]``, where the JAX package keeps ``[in, out]`` and
``[1, out]``. ``qdot`` is the product at every linear site of the model:
on a CUDA activation with a ``QTensor`` it launches the W8A16 kernel
(``ops/cuda/w8a16.py``, ``csrc/w8a16.cu``), on the CPU its plain version;
a plain tensor weight is ``F.linear``. ``quantize_tree`` returns a new
model whose block linears and head are ``QLinear``s.

The int4 row format: symmetric per-row int4 over the last (head_dim)
axis, range ±7 (the -8 code is left unused so the scale max|x|/7
round-trips 0 and negation is lossless). Two values pack per byte in
SPLIT-HALF order: byte j of a D-wide row holds element j in its low nibble
and element j + D/2 in its high nibble, each biased by +8. The pool
(``ops.paged.Q4PagedKVCache``), the decode kernel
(``csrc/paged_decode_q.cu``) and the plain read path all use these
definitions.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from gofr_tpu_torch.ops.cuda import w8a16 as w8a16_launcher
from gofr_tpu_torch.ops.kvcache import ieee_div


# -- weight-only int8 (gofr_tpu/ops/quant.py:35-100) ----------------------------


@dataclass
class QTensor:
    """An int8 weight and its per-output-channel scale: ``q`` int8
    ``[out, in]``, ``s`` f32 ``[out]``; the weight is ``q * s[:, None]``."""

    q: torch.Tensor
    s: torch.Tensor


def quantize(w: torch.Tensor) -> QTensor:
    """Symmetric per-output-channel int8 of a ``[out, in]`` weight: the
    scale is max|w| / 127 over the contraction axis (at least 1e-8), and q
    is w / scale rounded half to even and clipped to ±127, all in f32 as
    the JAX ``quantize`` computes it. Both divisions are IEEE quotients on
    either device (``ops.kvcache.ieee_div``), so the card quantizes bit for
    bit as the CPU does."""
    wf = w.float()
    s = torch.clamp(ieee_div(wf.abs().amax(dim=-1), 127.0), min=1e-8)
    q = torch.clamp(torch.round(wf / s[:, None]), -127, 127).to(torch.int8)
    return QTensor(q, s)


def qdot_plain(x: torch.Tensor, w: torch.Tensor | QTensor) -> torch.Tensor:
    """``x @ w.T`` for a plain weight or a ``QTensor``, in plain PyTorch:
    the int8 product is rounded to ``x``'s dtype, then multiplied by the
    scale cast to that dtype (gofr_tpu/ops/quant.py:61-70)."""
    if isinstance(w, QTensor):
        return F.linear(x, w.q.to(x.dtype)) * w.s.to(x.dtype)
    return F.linear(x, w)


def qdot(x: torch.Tensor, w: torch.Tensor | QTensor) -> torch.Tensor:
    """``x @ w.T`` at a linear site: a ``QTensor`` on a CUDA activation goes
    through the W8A16 kernel, one on the CPU through ``qdot_plain``; a plain
    weight is ``F.linear`` on either device."""
    if isinstance(w, QTensor) and x.is_cuda:
        return w8a16_launcher.w8a16(x, w.q, w.s)
    return qdot_plain(x, w)


class QLinear(nn.Module):
    """A bias-free linear layer on an int8 weight: ``q`` and ``s`` are
    buffers (so ``state_dict`` and ``to`` carry them), ``weight`` is the
    ``QTensor`` over them and ``forward`` is ``qdot``."""

    def __init__(self, q: torch.Tensor, s: torch.Tensor):
        super().__init__()
        self.register_buffer("q", q)
        self.register_buffer("s", s)

    @property
    def weight(self) -> QTensor:
        return QTensor(self.q, self.s)

    @classmethod
    def of(cls, linear: nn.Linear) -> "QLinear":
        """The int8 form of ``linear``'s weight (``quantize``)."""
        w = quantize(linear.weight.detach())
        return cls(w.q, w.s)

    @classmethod
    def empty(cls, out_features: int, in_features: int,
              device: str | torch.device | None = None) -> "QLinear":
        return cls(torch.empty(out_features, in_features, dtype=torch.int8, device=device),
                   torch.empty(out_features, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return qdot(x, self.weight)


# the linears quantize_tree replaces, by attribute name: the Llama's of
# JAX's _DEFAULT_KEYS (gofr_tpu/ops/quant.py:73), which also names the
# linears of families the port does not have yet
QUANTIZED_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head")


def quantize_tree(model: nn.Module) -> nn.Module:
    """A new model in which every ``nn.Linear`` held under a name in
    ``QUANTIZED_KEYS`` is a ``QLinear`` of its weight (``quantize``); every other
    parameter and buffer (the embedding, the norms) is shared with
    ``model``, which is left untouched, as JAX's functional
    ``quantize_tree`` leaves its input. A tied head stays the bf16
    embedding: ``embed`` is not a key."""
    new = copy.copy(model)
    new._parameters = dict(model._parameters)
    new._buffers = dict(model._buffers)
    new._modules = {
        name: (QLinear.of(child) if name in QUANTIZED_KEYS and isinstance(child, nn.Linear)
               else None if child is None else quantize_tree(child))
        for name, child in model._modules.items()}
    return new


def quantize_state(state: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """``quantize_tree`` on a state dict: each ``<...>.<key>.weight`` of a
    key in ``QUANTIZED_KEYS`` becomes that ``QLinear``'s ``q`` and ``s``, quantized
    from the weight in its own dtype; the rest is passed through."""
    out = {}
    for name, t in state.items():
        prefix, _, leaf = name.rpartition(".")
        if leaf == "weight" and prefix.rpartition(".")[2] in QUANTIZED_KEYS:
            w = quantize(t)
            out[f"{prefix}.q"], out[f"{prefix}.s"] = w.q, w.s
        else:
            out[name] = t
    return out


def quantized_bytes(model: nn.Module) -> int:
    """The bytes of every parameter and persistent buffer of ``model``
    (gofr_tpu/ops/quant.py:93): what its weights hold on the device."""
    return sum(t.numel() * t.element_size() for t in model.state_dict().values())


# -- int4 rows (gofr_tpu/ops/quant.py:118-158) -----------------------------------


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
