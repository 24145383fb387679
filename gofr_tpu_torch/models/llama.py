"""Llama-family decoder-only LM as an ``nn.Module`` (counterpart of
gofr_tpu/models/llama.py).

RMSNorm, RoPE, grouped-query attention, SwiGLU MLP, optional tied
embeddings. The JAX package keeps stacked ``[L, ...]`` parameter trees and
scans over layers; here each layer is a ``Block`` in a ``ModuleList`` and
the layer loop is a Python loop. Projections are ``nn.Linear`` without
bias, so a JAX ``x @ W`` with W [in, out] becomes a weight of [out, in]
(``params_from_jax`` transposes).

Entry points, each a method of ``Llama``:

- ``forward``            full causal pass, no cache (llama.py:206), with
                         JAX's ``attn_fn`` / ``head_fn`` hooks
- ``prefill``            prompts (or chunks at ``offsets``) written into
                         the cache, last-token logits: slot rows on the slot
                         cache (llama.py:304), block-table rows on the paged
                         pool (``prefill_paged``, llama.py:617)
- ``decode_step``        one token per slot, K/V appended at each slot's
                         position: lane n is slot n on the slot cache
                         (llama.py:453), or through the block table on the
                         paged pool (``decode_step_paged``, llama.py:710)
- ``verify_step``        speculative decoding's verify forward: T tokens
                         per lane at its position, logits for all T
                         (llama.py:389; ``verify_step_paged``, :525)
- ``make_cache``         an empty slot cache (llama.py:505) and
  ``make_cache_q`` its int8 form (llama.py:512); ``make_paged_cache``
  an empty pool (llama.py:587), and ``make_paged_cache_q`` /
  ``make_paged_cache_q4`` its int8 and packed int4 forms (llama.py:595,
  605). Where the JAX functions branch on the cache's type (llama.py:
  333-378, 644-685, 735-739), ``prefill``, ``verify_step`` and
  ``decode_step`` call the cache's own per-layer operations
  (``ops.kvcache``, ``ops.paged``) and its format's decode attention
  (``ops.attention.DECODE_ATTENTION``), so one body serves both layouts
  and every format; ``prefill`` and ``verify_step`` share one layer loop.

Attention and the KV append go through ``ops`` and so through the CUDA
kernels on the card. ``kernels=False`` runs the same step on their plain
versions instead, which is how the card-side check holds the kernels
against the plain path end to end. Decode attention on the int8 slot
cache is plain PyTorch either way (the TPU ran it as XLA). On the card a
decode step makes no host sync on any cache: ``decode_step`` converts the
positions, lengths and table to int32 once per step, so no launcher casts
them per layer.

Every linear site is ``ops.quant.qdot`` on the layer's weight, as every
site of the JAX model is (llama.py:190-199, 230, 237, 300): an
``nn.Linear``'s weight, or the ``QTensor`` of a ``QLinear`` when the model
holds weight-only int8 (``ops.quant.quantize_tree``, or ``params_from_jax``
of a quantized JAX tree), which on the card goes through the W8A16
kernel; ``kernels=False`` takes ``qdot``'s plain version there too. The
entry points' ``adapters`` (the LoRA pool's lanes) add their delta of the
normed rows to the logits after the head product (``ops.lora``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gofr_tpu_torch.gpu.device import resolve_device
from gofr_tpu_torch.ops.attention import DECODE_ATTENTION, mha_attention, mha_attention_plain
from gofr_tpu_torch.ops.kvcache import QSlotKVCache, SlotKVCache
from gofr_tpu_torch.ops.lora import lora_logits_delta
from gofr_tpu_torch.ops.norms import rms_norm
from gofr_tpu_torch.ops.paged import AnyPagedKVCache, PagedKVCache, Q4PagedKVCache, QPagedKVCache
from gofr_tpu_torch.ops.quant import QLinear, qdot, qdot_plain
from gofr_tpu_torch.ops.rope import apply_rope, rope_table


AnyKVCache = SlotKVCache | QSlotKVCache | AnyPagedKVCache


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


def _linear(in_features: int, out_features: int, int8: bool, **factory) -> nn.Module:
    """A bias-free linear layer: ``nn.Linear``, or an empty ``QLinear``."""
    if int8:
        return QLinear.empty(out_features, in_features, factory["device"])
    return nn.Linear(in_features, out_features, bias=False, **factory)


# the family's registry entries (models/__init__.py) and flags
# (llama.py:64, 150, 153): per-lane adapters, every linear site ``qdot``,
# ``prefill`` taking chunk offsets on the slot cache
CONFIG = LlamaConfig
TASKS = ("generate",)
SUPPORTS_ADAPTERS = True
QUANTIZABLE = True
SLOT_CHUNKED_PREFILL = True


class Block(nn.Module):
    def __init__(self, cfg: LlamaConfig, int8: bool = False, **factory):
        super().__init__()
        e, m = cfg.hidden_size, cfg.intermediate_size
        hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_size
        self.attn_norm = nn.Parameter(torch.empty(e, **factory))
        self.wq = _linear(e, hq * d, int8, **factory)
        self.wk = _linear(e, hkv * d, int8, **factory)
        self.wv = _linear(e, hkv * d, int8, **factory)
        self.wo = _linear(hq * d, e, int8, **factory)
        self.mlp_norm = nn.Parameter(torch.empty(e, **factory))
        self.w_gate = _linear(e, m, int8, **factory)
        self.w_up = _linear(e, m, int8, **factory)
        self.w_down = _linear(m, e, int8, **factory)


class Llama(nn.Module):
    """Weights are uninitialised after construction: build with ``init``
    (random, from a generator) or ``params_from_jax`` (the JAX tree). With
    ``int8`` the block linears and the head are ``QLinear``s (a tied head
    stays the embedding)."""

    def __init__(self, cfg: LlamaConfig, device: str | torch.device | None = None,
                 int8: bool = False):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        meta = dict(device="meta", dtype=cfg.dtype)
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, cfg.hidden_size, **meta))
        self.blocks = nn.ModuleList(Block(cfg, int8, **meta) for _ in range(cfg.num_layers))
        self.final_norm = nn.Parameter(torch.empty(cfg.hidden_size, **meta))
        self.lm_head = (None if cfg.tie_embeddings
                        else _linear(cfg.hidden_size, cfg.vocab_size, int8, **meta))
        self.to_empty(device=dev)
        self.requires_grad_(False)
        cos, sin = rope_table(cfg.max_seq_len, cfg.head_size, theta=cfg.rope_theta, device=dev)
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # -- pieces ----------------------------------------------------------------

    def _qkv(self, lp: Block, x: torch.Tensor, dot=qdot):
        """x [B, S, E] → q [B, S, Hq, D], k/v [B, S, Hkv, D] (pre-rope);
        ``dot`` is ``qdot`` or its plain version."""
        b, s, _ = x.shape
        d = self.cfg.head_size
        h = rms_norm(x, lp.attn_norm, self.cfg.norm_eps)
        return (dot(h, lp.wq.weight).view(b, s, -1, d), dot(h, lp.wk.weight).view(b, s, -1, d),
                dot(h, lp.wv.weight).view(b, s, -1, d))

    def _rope(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        return apply_rope(x, positions, self.rope_cos, self.rope_sin)

    def _mlp(self, lp: Block, x: torch.Tensor, dot=qdot) -> torch.Tensor:
        h = rms_norm(x, lp.mlp_norm, self.cfg.norm_eps)
        return dot(F.silu(dot(h, lp.w_gate.weight)) * dot(h, lp.w_up.weight), lp.w_down.weight)

    def _logits(self, x: torch.Tensor, adapters=None, dot=qdot) -> torch.Tensor:
        """f32 logits of hidden states ``x``, plus the lanes' LoRA delta
        of the normed rows (in the model's dtype) when ``adapters`` is
        given."""
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        head = self.embed if self.lm_head is None else self.lm_head.weight
        logits = dot(x, head).float()
        if adapters is not None:
            logits = logits + lora_logits_delta(x, adapters)
        return logits

    # -- entry points ----------------------------------------------------------

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor, lengths: torch.Tensor | None = None,
                attn_fn=None, head_fn=None) -> torch.Tensor:
        """tokens [B, S] → logits [B, S, V] (f32); ``lengths`` masks padded
        keys. ``attn_fn`` replaces ``mha_attention`` (same contract), and
        ``head_fn(x, head)`` the head product of the normed states ``x``
        with the head weight (the embedding when tied, a ``QTensor`` in
        int8), as JAX's hooks do (llama.py:206-239): the quality plane's
        fake-quantized K/V and LoRA head."""
        b, s = tokens.shape
        attn = attn_fn or mha_attention
        positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
        x = self.embed[tokens]
        for lp in self.blocks:
            q, k, v = self._qkv(lp, x)
            a = attn(self._rope(q, positions), self._rope(k, positions), v,
                     causal=True, kv_lengths=lengths)
            x = x + qdot(a.reshape(b, s, -1), lp.wo.weight)
            x = x + self._mlp(lp, x)
        if head_fn is None:
            return self._logits(x)
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        head = self.embed if self.lm_head is None else self.lm_head.weight
        return head_fn(x, head).float()

    def _cached_layers(self, tokens: torch.Tensor, lengths: torch.Tensor, cache: AnyKVCache,
                       rows: torch.Tensor, offsets: torch.Tensor | None,
                       attn, dot) -> torch.Tensor:
        """The layer loop of ``prefill`` and ``verify_step``: tokens [B, S]
        written into the cache at ``offsets`` (0 when None) through ``rows``
        and attended, each row to its first ``lengths`` tokens; returns the
        hidden states [B, S, E] before the final norm. Rope angles clamp to
        the table's last row, as JAX's gather clamps them, since an idle
        verify lane sits past the cache."""
        b, s = tokens.shape
        off = (torch.zeros(b, dtype=torch.long, device=tokens.device) if offsets is None
               else offsets.long())
        positions = off[:, None] + torch.arange(s, device=tokens.device)[None]
        rope_pos = positions.clamp(max=self.cfg.max_seq_len - 1)
        view_rows = rows
        if offsets is not None and rows.dim() == 1:
            # an OOB slot id (a warmup row) reads the last slot, as JAX's
            # gather clamps: its writes drop and its output is discarded
            view_rows = rows.long().clamp(0, cache.num_slots - 1)
        x = self.embed[tokens]
        for layer, lp in enumerate(self.blocks):
            q, k, v = self._qkv(lp, x, dot)
            q, k = self._rope(q, rope_pos), self._rope(k, rope_pos)
            cache.write(layer, rows, k, v, offsets)
            if offsets is None:
                a = attn(q, cache.stored(k), cache.stored(v), causal=True, kv_lengths=lengths)
            else:
                k_view, v_view = cache.read(layer, view_rows, self.cfg.dtype)
                a = attn(q, k_view.transpose(1, 2), v_view.transpose(1, 2),
                         causal=True, q_offset=off, kv_lengths=off + lengths)
            x = x + dot(a.reshape(b, s, -1), lp.wo.weight)
            x = x + self._mlp(lp, x, dot)
        return x

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, lengths: torch.Tensor, cache: AnyKVCache,
                rows: torch.Tensor, offsets: torch.Tensor | None = None, *,
                kernels: bool = True, adapters=None) -> tuple[torch.Tensor, AnyKVCache]:
        """Prefill prompts (or prompt chunks) into the cache.

        tokens [B, S] (padded), lengths [B] = live tokens in this call, rows
        = where each prompt goes: slot ids [B] on a slot cache, block-table
        rows [B, MaxP] (OOB = pool size) on a paged pool. ``offsets`` [B]
        places the chunk at positions offsets .. offsets+S; chunked rows
        attend to the whole cache written so far through a dense view,
        whole-prompt rows attend prompt-locally. On a quantized cache
        whole-prompt rows attend to their fake-quantized k/v (what the cache
        stores) and chunked rows to the dequantized view (llama.py:343-367,
        644-685). Returns (last-token logits [B, V] f32, cache), the cache
        written in place."""
        attn = mha_attention if kernels else mha_attention_plain
        dot = qdot if kernels else qdot_plain
        x = self._cached_layers(tokens, lengths, cache, rows, offsets, attn, dot)
        last = x[torch.arange(tokens.shape[0], device=x.device), lengths.long() - 1]
        return self._logits(last, adapters, dot), cache

    @torch.no_grad()
    def verify_step(self, tokens: torch.Tensor, positions: torch.Tensor, cache: AnyKVCache,
                    table: torch.Tensor | None = None, *,
                    kernels: bool = True, adapters=None) -> tuple[torch.Tensor, AnyKVCache]:
        """Speculative decoding's verify forward (llama.py:389, 525): tokens
        [N, T] per lane, the input token and T-1 drafts, written and attended
        at ``positions[n]`` .. ``positions[n] + T - 1``: lane n in slot n of
        a slot cache (``table`` None), or through ``table`` [N, MaxP] in a
        paged pool. It is ``prefill`` with offsets, each lane attending to
        the dense view of what its cache holds up to and including its T
        tokens. Returns (logits [N, T, V] f32, the next-token distribution
        after each of the T tokens; cache), the cache written in place.
        Draft K/V past the accepted prefix go stale but are always
        rewritten before they are attended: the next round writes from the
        new input position. A lane whose writes drop (an all-OOB table row,
        positions past the slot) gives logits the caller ignores."""
        attn = mha_attention if kernels else mha_attention_plain
        dot = qdot if kernels else qdot_plain
        n, t = tokens.shape
        rows = torch.arange(n, device=tokens.device) if table is None else table
        lengths = torch.full((n,), t, dtype=torch.long, device=tokens.device)
        x = self._cached_layers(tokens, lengths, cache, rows, positions, attn, dot)
        return self._logits(x, adapters, dot), cache

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, positions: torch.Tensor, cache: AnyKVCache,
                    table: torch.Tensor | None = None, *,
                    kernels: bool = True, adapters=None) -> tuple[torch.Tensor, AnyKVCache]:
        """One decode step over every slot: tokens [N] go to ``positions``
        [N], lane n into slot n of a slot cache (``table`` None), or through
        ``table`` [N, MaxP] into a paged pool. Returns (logits [N, V] f32,
        cache), the cache written in place. A lane whose write drops (an
        all-OOB table row, a position past the slot) produces logits the
        caller ignores; its rope angle clamps to the table's last row, as
        JAX's gather clamps it, since an idle slot lane may sit at
        ``max_seq_len``. Positions, lengths and the table go to the kernels
        as int32, converted here once per step."""
        attn = DECODE_ATTENTION[type(cache)][0 if kernels else 1]
        dot = qdot if kernels else qdot_plain
        n = tokens.shape[0]
        pos1 = positions.long().clamp(max=self.cfg.max_seq_len - 1)[:, None]
        positions = positions.to(torch.int32).contiguous()
        lengths = positions + 1
        if table is not None:
            table = table.to(torch.int32).contiguous()
        x = self.embed[tokens]
        for layer, lp in enumerate(self.blocks):
            q, k, v = self._qkv(lp, x[:, None], dot)
            q, k, v = self._rope(q, pos1)[:, 0], self._rope(k, pos1)[:, 0], v[:, 0]
            cache.append(layer, table, positions, k, v, kernels=kernels)
            a = attn(q, *cache.planes(layer, table), lengths)
            x = x + dot(a.reshape(n, -1), lp.wo.weight)
            x = x + self._mlp(lp, x, dot)
        return self._logits(x, adapters, dot), cache

    # the JAX package's names for the paged pool's entry points (the same bodies)
    prefill_paged = prefill
    decode_step_paged = decode_step
    verify_step_paged = verify_step

    def make_cache(self, slots: int, max_len: int | None = None) -> SlotKVCache:
        """An empty slot cache of ``max_len`` positions per slot (default
        ``max_seq_len``) in the model's dtype (llama.py:505)."""
        cfg = self.cfg
        return SlotKVCache.create(cfg.num_layers, slots, max_len or cfg.max_seq_len,
                                  cfg.num_kv_heads, cfg.head_size, dtype=cfg.dtype,
                                  device=self.device)

    def make_cache_q(self, slots: int, max_len: int | None = None) -> QSlotKVCache:
        """The int8 slot cache (llama.py:512)."""
        cfg = self.cfg
        return QSlotKVCache.create(cfg.num_layers, slots, max_len or cfg.max_seq_len,
                                   cfg.num_kv_heads, cfg.head_size, device=self.device)

    def make_paged_cache(self, pages: int, page_size: int = 128) -> PagedKVCache:
        cfg = self.cfg
        return PagedKVCache.create(cfg.num_layers, pages, page_size, cfg.num_kv_heads,
                                   cfg.head_size, dtype=cfg.dtype, device=self.device)

    def make_paged_cache_q(self, pages: int, page_size: int = 128) -> QPagedKVCache:
        """The int8 pool (llama.py:595)."""
        cfg = self.cfg
        return QPagedKVCache.create(cfg.num_layers, pages, page_size, cfg.num_kv_heads,
                                    cfg.head_size, device=self.device)

    def make_paged_cache_q4(self, pages: int, page_size: int = 128) -> Q4PagedKVCache:
        """The packed int4 pool (llama.py:605); head_dim must be even."""
        cfg = self.cfg
        return Q4PagedKVCache.create(cfg.num_layers, pages, page_size, cfg.num_kv_heads,
                                     cfg.head_size, device=self.device)


# the model class the engine builds and looks its layouts up on
MODEL = Llama


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


BLOCK_WEIGHTS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _linear_state(prefix: str, w, layer: int | None = None) -> dict[str, torch.Tensor]:
    """A JAX ``x @ W`` weight as the port's linear layer's tensors: W [in,
    out] transposed into ``nn.Linear``'s [out, in]; a quantized leaf (a
    ``QTensor`` with ``q`` [in, out] int8 and ``s`` [1, out] f32) as a
    ``QLinear``'s ``q`` [out, in] and ``s`` [out], bit for bit. ``layer``
    picks one layer of a stacked ``[L, ...]`` leaf."""
    pick = (lambda a: a) if layer is None else (lambda a: a[layer])
    if hasattr(w, "q") and hasattr(w, "s"):
        return {f"{prefix}.q": tensor_from_numpy(pick(w.q)).T.contiguous(),
                f"{prefix}.s": tensor_from_numpy(pick(w.s))[0]}
    return {f"{prefix}.weight": tensor_from_numpy(pick(w)).T}


def jax_state(np_params: dict) -> dict[str, torch.Tensor]:
    """A JAX parameter tree (llama.py:123) given as numpy arrays, as CPU
    tensors under the names of ``Llama.state_dict()``, in the tree's
    dtypes: stacked ``[L, ...]`` blocks split into layers, and each linear
    weight in the port's layout (``_linear_state``), quantized or not."""
    state = {"embed": tensor_from_numpy(np_params["embed"]),
             "final_norm": tensor_from_numpy(np_params["final_norm"])}
    if "lm_head" in np_params:
        state.update(_linear_state("lm_head", np_params["lm_head"]))
    blocks = np_params["blocks"]
    for layer in range(len(blocks["attn_norm"])):
        for name in ("attn_norm", "mlp_norm"):
            state[f"blocks.{layer}.{name}"] = tensor_from_numpy(blocks[name][layer])
        for name in BLOCK_WEIGHTS:
            state.update(_linear_state(f"blocks.{layer}.{name}", blocks[name], layer))
    return state


def params_from_jax(cfg: LlamaConfig, np_params: dict,
                    device: str | torch.device | None = None) -> Llama:
    """A ``Llama`` holding the weights of a JAX parameter tree (llama.py:123)
    given as numpy arrays (``jax_state``): floating weights cast to the
    config's dtype; a tree quantized by ``quantize_tree`` gives a model of
    ``QLinear``s holding its int8 weights and f32 scales as they are."""
    state = jax_state(np_params)
    model = Llama(cfg, device, int8="blocks.0.wq.q" in state)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            t.copy_(state[name].to(t.dtype))
    return model
