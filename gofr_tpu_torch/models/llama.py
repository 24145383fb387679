"""Llama-family decoder-only LM as an ``nn.Module`` (counterpart of
gofr_tpu/models/llama.py).

RMSNorm, RoPE, grouped-query attention, SwiGLU MLP, optional tied
embeddings. The JAX package keeps stacked ``[L, ...]`` parameter trees and
scans over layers; here each layer is a ``Block`` in a ``ModuleList`` and
the layer loop is a Python loop. Projections are ``nn.Linear`` without
bias, so a JAX ``x @ W`` with W [in, out] becomes a weight of [out, in]
(``params_from_jax`` transposes).

Entry points, each a method of ``Llama``:

- ``forward``            full causal pass, no cache (llama.py:206)
- ``prefill_paged``      prompts (or chunks at ``offsets``) written into
                         the paged pool, last-token logits (llama.py:617)
- ``decode_step_paged``  one token per slot, K/V appended through the
                         block table (llama.py:710)
- ``make_paged_cache``   an empty pool for this model (llama.py:587)

Attention and the KV append go through ``ops`` and so through the CUDA
kernels on the card. ``kernels=False`` runs the same step on their plain
versions instead, which is how the card-side check holds the kernels
against the plain path end to end (``prefill_paged`` and
``decode_step_paged``). This slice serves bf16 weights and a
bf16 pool only (no int8 weights, LoRA deltas or quantized pools).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gofr_tpu_torch.gpu.device import resolve_device
from gofr_tpu_torch.ops.attention import (
    mha_attention,
    mha_attention_plain,
    paged_decode_attention,
    paged_decode_attention_plain,
)
from gofr_tpu_torch.ops.norms import rms_norm
from gofr_tpu_torch.ops.paged import (
    PagedKVCache,
    append_tokens_paged,
    append_tokens_paged_plain,
    gather_kv,
    write_prompts_paged,
)
from gofr_tpu_torch.ops.rope import apply_rope, rope_table


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int | None = None
    rope_theta: float = 500000.0
    max_seq_len: int = 8192
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_size(self) -> int:
        return self.head_dim if self.head_dim is not None else self.hidden_size // self.num_heads

    @classmethod
    def llama3_8b(cls, **kw) -> "LlamaConfig":
        return cls(**{**dict(
            vocab_size=128256, hidden_size=4096, intermediate_size=14336,
            num_layers=32, num_heads=32, num_kv_heads=8, rope_theta=500000.0,
        ), **kw})

    @classmethod
    def one_b(cls, **kw) -> "LlamaConfig":
        return cls(**{**dict(
            vocab_size=32000, hidden_size=2048, intermediate_size=5632,
            num_layers=22, num_heads=32, num_kv_heads=4, rope_theta=10000.0,
        ), **kw})

    @classmethod
    def tiny(cls, **kw) -> "LlamaConfig":
        """Test-sized config, float32."""
        return cls(**{**dict(
            vocab_size=256, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=128,
            rope_theta=10000.0, dtype=torch.float32,
        ), **kw})


def _ops(kernels: bool):
    """(prefill attention, paged decode attention, KV append): the kernel
    entry points, or their plain versions."""
    if kernels:
        return mha_attention, paged_decode_attention, append_tokens_paged
    return mha_attention_plain, paged_decode_attention_plain, append_tokens_paged_plain


class Block(nn.Module):
    def __init__(self, cfg: LlamaConfig, **factory):
        super().__init__()
        e, m = cfg.hidden_size, cfg.intermediate_size
        hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_size
        self.attn_norm = nn.Parameter(torch.empty(e, **factory))
        self.wq = nn.Linear(e, hq * d, bias=False, **factory)
        self.wk = nn.Linear(e, hkv * d, bias=False, **factory)
        self.wv = nn.Linear(e, hkv * d, bias=False, **factory)
        self.wo = nn.Linear(hq * d, e, bias=False, **factory)
        self.mlp_norm = nn.Parameter(torch.empty(e, **factory))
        self.w_gate = nn.Linear(e, m, bias=False, **factory)
        self.w_up = nn.Linear(e, m, bias=False, **factory)
        self.w_down = nn.Linear(m, e, bias=False, **factory)


class Llama(nn.Module):
    """Weights are uninitialised after construction: build with ``init``
    (random, from a generator) or ``params_from_jax`` (the JAX tree)."""

    def __init__(self, cfg: LlamaConfig, device: str | torch.device | None = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        meta = dict(device="meta", dtype=cfg.dtype)
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, cfg.hidden_size, **meta))
        self.blocks = nn.ModuleList(Block(cfg, **meta) for _ in range(cfg.num_layers))
        self.final_norm = nn.Parameter(torch.empty(cfg.hidden_size, **meta))
        self.lm_head = (None if cfg.tie_embeddings
                        else nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False, **meta))
        self.to_empty(device=dev)
        self.requires_grad_(False)
        cos, sin = rope_table(cfg.max_seq_len, cfg.head_size, theta=cfg.rope_theta, device=dev)
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # -- pieces ----------------------------------------------------------------

    def _qkv(self, lp: Block, x: torch.Tensor):
        """x [B, S, E] → q [B, S, Hq, D], k/v [B, S, Hkv, D] (pre-rope)."""
        b, s, _ = x.shape
        d = self.cfg.head_size
        h = rms_norm(x, lp.attn_norm, self.cfg.norm_eps)
        return (lp.wq(h).view(b, s, -1, d), lp.wk(h).view(b, s, -1, d),
                lp.wv(h).view(b, s, -1, d))

    def _rope(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        return apply_rope(x, positions, self.rope_cos, self.rope_sin)

    def _mlp(self, lp: Block, x: torch.Tensor) -> torch.Tensor:
        h = rms_norm(x, lp.mlp_norm, self.cfg.norm_eps)
        return lp.w_down(F.silu(lp.w_gate(h)) * lp.w_up(h))

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        head = self.embed if self.lm_head is None else self.lm_head.weight
        return F.linear(x, head).float()

    # -- entry points ----------------------------------------------------------

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor, lengths: torch.Tensor | None = None) -> torch.Tensor:
        """tokens [B, S] → logits [B, S, V] (f32); ``lengths`` masks padded
        keys."""
        b, s = tokens.shape
        positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
        x = self.embed[tokens]
        for lp in self.blocks:
            q, k, v = self._qkv(lp, x)
            a = mha_attention(self._rope(q, positions), self._rope(k, positions), v,
                              causal=True, kv_lengths=lengths)
            x = x + lp.wo(a.reshape(b, s, -1))
            x = x + self._mlp(lp, x)
        return self._logits(x)

    @torch.no_grad()
    def prefill_paged(self, tokens: torch.Tensor, lengths: torch.Tensor, cache: PagedKVCache,
                      pages: torch.Tensor, offsets: torch.Tensor | None = None, *,
                      kernels: bool = True) -> tuple[torch.Tensor, PagedKVCache]:
        """Prefill prompts (or prompt chunks) through block-table rows.

        tokens [B, S] (padded), lengths [B] = live tokens in this call, pages
        [B, MaxP] (OOB = pool size). ``offsets`` [B] places the chunk at
        positions offsets .. offsets+S; chunked rows attend to the whole
        cache written so far through a gathered view, whole-prompt rows
        attend prompt-locally. Returns (last-token logits [B, V] f32, cache),
        the cache written in place."""
        attn, _, _ = _ops(kernels)
        b, s = tokens.shape
        off = (torch.zeros(b, dtype=torch.long, device=tokens.device) if offsets is None
               else offsets.long())
        positions = off[:, None] + torch.arange(s, device=tokens.device)[None]
        x = self.embed[tokens]
        for layer, lp in enumerate(self.blocks):
            q, k, v = self._qkv(lp, x)
            q, k = self._rope(q, positions), self._rope(k, positions)
            k_layer, v_layer = cache.k[layer], cache.v[layer]
            write_prompts_paged(k_layer, v_layer, pages, k, v, offsets)
            if offsets is None:
                a = attn(q, k, v, causal=True, kv_lengths=lengths)
            else:
                k_view, v_view = gather_kv(k_layer, v_layer, pages)
                a = attn(q, k_view.transpose(1, 2), v_view.transpose(1, 2),
                         causal=True, q_offset=off, kv_lengths=off + lengths)
            x = x + lp.wo(a.reshape(b, s, -1))
            x = x + self._mlp(lp, x)
        last = x[torch.arange(b, device=x.device), lengths.long() - 1]
        return self._logits(last), cache

    @torch.no_grad()
    def decode_step_paged(self, tokens: torch.Tensor, positions: torch.Tensor,
                          cache: PagedKVCache, table: torch.Tensor, *,
                          kernels: bool = True) -> tuple[torch.Tensor, PagedKVCache]:
        """One decode step over every slot: tokens [N] go to ``positions`` [N]
        through ``table`` [N, MaxP]. Returns (logits [N, V] f32, cache), the
        cache written in place. Lanes with an all-OOB table row write
        nothing and produce logits the caller ignores."""
        attn, append = _ops(kernels)[1:]
        n = tokens.shape[0]
        pos1 = positions.long()[:, None]
        lengths = positions + 1
        x = self.embed[tokens]
        for layer, lp in enumerate(self.blocks):
            q, k, v = self._qkv(lp, x[:, None])
            q, k, v = self._rope(q, pos1)[:, 0], self._rope(k, pos1)[:, 0], v[:, 0]
            k_layer, v_layer = cache.k[layer], cache.v[layer]
            append(k_layer, v_layer, table, positions, k, v)
            a = attn(q, k_layer, v_layer, table, lengths)
            x = x + lp.wo(a.reshape(n, -1))
            x = x + self._mlp(lp, x)
        return self._logits(x), cache

    def make_paged_cache(self, pages: int, page_size: int = 128) -> PagedKVCache:
        cfg = self.cfg
        return PagedKVCache.create(cfg.num_layers, pages, page_size, cfg.num_kv_heads,
                                   cfg.head_size, dtype=cfg.dtype, device=self.device)


# -- weights --------------------------------------------------------------------


def init(cfg: LlamaConfig, generator: torch.Generator,
         device: str | torch.device | None = None) -> Llama:
    """Random weights drawn from ``generator`` (which must live on
    ``device``): normal with std 1/sqrt(fan_in) for projections and 0.02 for
    the embedding and head, clipped at two standard deviations — the scales
    of the JAX ``init`` (llama.py:123), not its draws."""
    model = Llama(cfg, device)

    def fill(t: torch.Tensor, std: float) -> None:
        t.normal_(0.0, std, generator=generator).clamp_(-2 * std, 2 * std)

    with torch.no_grad():
        fill(model.embed, 0.02)
        model.final_norm.fill_(1.0)
        for blk in model.blocks:
            blk.attn_norm.fill_(1.0)
            blk.mlp_norm.fill_(1.0)
            for lin in (blk.wq, blk.wk, blk.wv, blk.wo, blk.w_gate, blk.w_up, blk.w_down):
                fill(lin.weight, lin.in_features ** -0.5)
        if model.lm_head is not None:
            fill(model.lm_head.weight, 0.02)
    return model


def tensor_from_numpy(a, device: str | torch.device = "cpu") -> torch.Tensor:
    """A numpy array as a torch tensor; ``ml_dtypes`` bf16 moves by its bit
    pattern (uint16 view), so no value is rounded on the way."""
    a = np.array(a)  # a writable, contiguous copy (JAX hands out read-only views)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(cfg: LlamaConfig, np_params: dict,
                    device: str | torch.device | None = None) -> Llama:
    """A ``Llama`` holding the weights of a JAX parameter tree (llama.py:123)
    given as numpy arrays: stacked ``[L, ...]`` blocks split into layers, and
    each ``x @ W`` weight [in, out] transposed into ``nn.Linear``'s
    [out, in]."""
    model = Llama(cfg, device)
    dev = model.device

    def t(a) -> torch.Tensor:
        return tensor_from_numpy(a, dev).to(cfg.dtype)

    blocks = np_params["blocks"]
    with torch.no_grad():
        model.embed.copy_(t(np_params["embed"]))
        model.final_norm.copy_(t(np_params["final_norm"]))
        if model.lm_head is not None:
            model.lm_head.weight.copy_(t(np_params["lm_head"]).T)
        for layer, blk in enumerate(model.blocks):
            blk.attn_norm.copy_(t(blocks["attn_norm"][layer]))
            blk.mlp_norm.copy_(t(blocks["mlp_norm"][layer]))
            for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
                getattr(blk, name).weight.copy_(t(blocks[name][layer]).T)
    return model
