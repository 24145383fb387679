"""GPT-2 decoder-only LM as an ``nn.Module`` (counterpart of
gofr_tpu/models/gpt2.py).

Learned position embeddings, pre-LayerNorm blocks, a tanh-GELU MLP and a
head tied to the token embedding. Multi-head attention (as many KV heads
as query heads), head dim 64 at every published width. The JAX package
keeps stacked ``[L, ...]`` trees and scans; here each layer is a ``Block``
of bias-free linears (``nn.Linear``, or ``QLinear`` in int8) beside their
biases, a JAX ``x @ W + b`` with W [in, out] becoming a weight of [out, in]
(``params_from_jax`` transposes). The biases are added after the product,
as the JAX model adds them after ``qdot`` (gpt2.py:113-115, 137), so an
int8 model keeps them in its dtype.

Entry points, each a method of ``GPT2``, with the signatures of the port's
``Llama``:

- ``forward``       full causal pass, no cache (gpt2.py:126), with the
                    quality plane's ``attn_fn`` / ``head_fn`` hooks
- ``prefill``       prompts (or chunks at ``offsets``) written into the slot
                    cache, last-token logits (gpt2.py:147)
- ``verify_step``   speculative decoding's verify forward: T tokens per
                    lane, logits for all T (gpt2.py:185)
- ``decode_step``   one token per slot, K/V appended at its position
                    (gpt2.py:217)
- ``make_cache``    an empty slot cache (gpt2.py:243). There is no paged
                    pool and no int8 cache: the engine serves GPT-2 on the
                    bf16 slot cache, as the JAX engine does.

The entry points take ``adapters`` as ``Llama``'s do, for the engine's
step programs, which pass it; it must be None: the family has no per-lane
adapters (no ``SUPPORTS_ADAPTERS``), and the engine refuses them.

The learned position embedding is read at each position clamped to
``max_seq_len - 1`` (gpt2.py:154, 192, 223): an idle slot lane writes at
and past the slot's end, where an unclamped row would be out of range.
Attention and the KV append go through ``ops``, so on the card through
kernel C's, F's and G's head-dim-64 builds; ``kernels=False`` runs their
plain versions (and ``qdot``'s) instead. The head is the product with
``wte`` itself (gpt2.py:143), so ``state_dict`` holds the embedding once.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gofr_tpu_torch.gpu.device import resolve_device
from gofr_tpu_torch.models.llama import _linear, _linear_state, tensor_from_numpy
from gofr_tpu_torch.ops.attention import DECODE_ATTENTION, mha_attention, mha_attention_plain
from gofr_tpu_torch.ops.kvcache import SlotKVCache
from gofr_tpu_torch.ops.norms import layer_norm
from gofr_tpu_torch.ops.quant import qdot, qdot_plain


@dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_seq_len: int = 1024
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.float32

    @property
    def head_size(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def intermediate_size(self) -> int:
        return 4 * self.hidden_size

    @classmethod
    def small(cls, **kw) -> "GPT2Config":
        return cls(**kw)  # gpt2 (124M) defaults

    @classmethod
    def tiny(cls, **kw) -> "GPT2Config":
        return cls(**{**dict(vocab_size=256, hidden_size=32, num_layers=2, num_heads=4,
                             max_seq_len=128), **kw})


# the family's registry entries (models/__init__.py) and flags
# (gpt2.py:58-61): every linear site is ``qdot``, and ``prefill`` takes
# chunk offsets on the slot cache
CONFIG = GPT2Config
TASKS = ("generate",)
QUANTIZABLE = True
SLOT_CHUNKED_PREFILL = True

# the block's linears, each followed by its bias, and its LayerNorms
LINEARS = (("wq", "bq"), ("wk", "bk"), ("wv", "bv"), ("wo", "bo"), ("w_fc", "b_fc"),
           ("w_proj", "b_proj"))
NORMS = ("ln1_g", "ln1_b", "ln2_g", "ln2_b")


class Block(nn.Module):
    def __init__(self, cfg: GPT2Config, int8: bool = False, **factory):
        super().__init__()
        e, m = cfg.hidden_size, cfg.intermediate_size
        widths = {"wq": (e, e), "wk": (e, e), "wv": (e, e), "wo": (e, e), "w_fc": (e, m),
                  "w_proj": (m, e)}
        for name in NORMS:
            setattr(self, name, nn.Parameter(torch.empty(e, **factory)))
        for name, bias in LINEARS:
            fan_in, fan_out = widths[name]
            setattr(self, name, _linear(fan_in, fan_out, int8, **factory))
            setattr(self, bias, nn.Parameter(torch.empty(fan_out, **factory)))


class GPT2(nn.Module):
    """Weights are uninitialised after construction: build with ``init``
    (random, from a generator) or ``params_from_jax`` (the JAX tree). With
    ``int8`` the block linears are ``QLinear``s; the tied head stays the
    embedding."""

    def __init__(self, cfg: GPT2Config, device: str | torch.device | None = None,
                 int8: bool = False):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        meta = dict(device="meta", dtype=cfg.dtype)
        self.wte = nn.Parameter(torch.empty(cfg.vocab_size, cfg.hidden_size, **meta))
        self.wpe = nn.Parameter(torch.empty(cfg.max_seq_len, cfg.hidden_size, **meta))
        self.blocks = nn.ModuleList(Block(cfg, int8, **meta) for _ in range(cfg.num_layers))
        self.lnf_g = nn.Parameter(torch.empty(cfg.hidden_size, **meta))
        self.lnf_b = nn.Parameter(torch.empty(cfg.hidden_size, **meta))
        self.to_empty(device=dev)
        self.requires_grad_(False)

    @property
    def device(self) -> torch.device:
        return self.wte.device

    # -- pieces ----------------------------------------------------------------

    def _embed(self, tokens: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        """Token plus learned position embedding, the position clamped to
        the table's last row (gpt2.py:154)."""
        return self.wte[tokens] + self.wpe[positions.clamp(max=self.cfg.max_seq_len - 1)]

    def _qkv(self, lp: Block, x: torch.Tensor, dot=qdot):
        """x [B, S, E] → q, k, v [B, S, H, D] (gpt2.py:110): ln1, then each
        product and its bias."""
        b, s, _ = x.shape
        d = self.cfg.head_size
        h = layer_norm(x, lp.ln1_g, lp.ln1_b, self.cfg.norm_eps)
        return tuple((dot(h, getattr(lp, w).weight) + getattr(lp, bias)).view(b, s, -1, d)
                     for w, bias in LINEARS[:3])

    def _mlp(self, lp: Block, x: torch.Tensor, dot=qdot) -> torch.Tensor:
        h = layer_norm(x, lp.ln2_g, lp.ln2_b, self.cfg.norm_eps)
        h = F.gelu(dot(h, lp.w_fc.weight) + lp.b_fc, approximate="tanh")
        return dot(h, lp.w_proj.weight) + lp.b_proj

    def _block(self, lp: Block, x: torch.Tensor, a: torch.Tensor, dot=qdot) -> torch.Tensor:
        """The residual adds after attention's output ``a`` [B, S, H, D]."""
        x = x + dot(a.reshape(*x.shape[:-1], -1), lp.wo.weight) + lp.bo
        return x + self._mlp(lp, x, dot)

    def _final(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.lnf_g, self.lnf_b, self.cfg.norm_eps)

    def _logits(self, x: torch.Tensor, dot=qdot) -> torch.Tensor:
        """f32 logits of hidden states ``x`` through the tied head."""
        return dot(self._final(x), self.wte).float()

    # -- entry points ----------------------------------------------------------

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor, lengths: torch.Tensor | None = None,
                attn_fn=None, head_fn=None) -> torch.Tensor:
        """tokens [B, S] → logits [B, S, V] (f32); ``lengths`` masks padded
        keys. ``attn_fn`` replaces ``mha_attention`` and ``head_fn(x, head)``
        the head product of the normed states with ``wte``, as
        ``Llama.forward``'s hooks do (the quality plane's)."""
        b, s = tokens.shape
        attn = attn_fn or mha_attention
        x = self._embed(tokens, torch.arange(s, device=tokens.device)[None])
        for lp in self.blocks:
            q, k, v = self._qkv(lp, x)
            x = self._block(lp, x, attn(q, k, v, causal=True, kv_lengths=lengths))
        if head_fn is None:
            return self._logits(x)
        return head_fn(self._final(x), self.wte).float()

    def _cached_layers(self, tokens: torch.Tensor, lengths: torch.Tensor, cache: SlotKVCache,
                       rows: torch.Tensor, offsets: torch.Tensor | None, attn, dot) -> torch.Tensor:
        """The layer loop of ``prefill`` and ``verify_step`` (gpt2.py:159-175,
        197-208): tokens [B, S] written into slots ``rows`` at ``offsets``
        (0 when None) and attended, each row to its first ``lengths`` tokens
        (prompt-locally), or with offsets to the slot's whole view up to
        offset + length; returns the hidden states before the final norm."""
        b, s = tokens.shape
        off = (torch.zeros(b, dtype=torch.long, device=tokens.device) if offsets is None
               else offsets.long())
        x = self._embed(tokens, off[:, None] + torch.arange(s, device=tokens.device)[None])
        # an OOB slot id (a warmup row) reads the last slot, as a gather
        # clamps: its writes drop and its output is discarded
        view_rows = rows.long().clamp(0, cache.num_slots - 1)
        for layer, lp in enumerate(self.blocks):
            q, k, v = self._qkv(lp, x, dot)
            cache.write(layer, rows, k, v, offsets)
            if offsets is None:
                a = attn(q, k, v, causal=True, kv_lengths=lengths)
            else:
                k_view, v_view = cache.read(layer, view_rows, self.cfg.dtype)
                a = attn(q, k_view.transpose(1, 2), v_view.transpose(1, 2),
                         causal=True, q_offset=off, kv_lengths=off + lengths)
            x = self._block(lp, x, a, dot)
        return x

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, lengths: torch.Tensor, cache: SlotKVCache,
                rows: torch.Tensor, offsets: torch.Tensor | None = None, *,
                kernels: bool = True, adapters=None) -> tuple[torch.Tensor, SlotKVCache]:
        """Prefill prompts (or chunks at ``offsets``) into slots ``rows``
        [B]: tokens [B, S] padded, lengths [B] live tokens in this call.
        Returns (last-token logits [B, V] f32, cache), written in place."""
        attn = mha_attention if kernels else mha_attention_plain
        dot = qdot if kernels else qdot_plain
        x = self._cached_layers(tokens, lengths, cache, rows, offsets, attn, dot)
        last = x[torch.arange(tokens.shape[0], device=x.device), lengths.long() - 1]
        return self._logits(last, dot), cache

    @torch.no_grad()
    def verify_step(self, tokens: torch.Tensor, positions: torch.Tensor, cache: SlotKVCache,
                    table: None = None, *, kernels: bool = True,
                    adapters=None) -> tuple[torch.Tensor, SlotKVCache]:
        """Speculative decoding's verify forward (gpt2.py:185): tokens [N, T]
        of lane n written into slot n at ``positions[n]`` .. + T - 1 and
        attended there; logits [N, T, V] f32 for all T."""
        attn = mha_attention if kernels else mha_attention_plain
        dot = qdot if kernels else qdot_plain
        n, t = tokens.shape
        rows = torch.arange(n, device=tokens.device)
        lengths = torch.full((n,), t, dtype=torch.long, device=tokens.device)
        x = self._cached_layers(tokens, lengths, cache, rows, positions, attn, dot)
        return self._logits(x, dot), cache

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, positions: torch.Tensor, cache: SlotKVCache,
                    table: None = None, *, kernels: bool = True,
                    adapters=None) -> tuple[torch.Tensor, SlotKVCache]:
        """One decode step (gpt2.py:217): token n goes into slot n at
        ``positions[n]``, attending to positions < positions[n] + 1.
        Positions and lengths go to the kernels as int32, converted here
        once per step. Returns (logits [N, V] f32, cache)."""
        attn = DECODE_ATTENTION[type(cache)][0 if kernels else 1]
        dot = qdot if kernels else qdot_plain
        n = tokens.shape[0]
        x = self._embed(tokens, positions.long())
        positions = positions.to(torch.int32).contiguous()
        lengths = positions + 1
        for layer, lp in enumerate(self.blocks):
            q, k, v = (t[:, 0] for t in self._qkv(lp, x[:, None], dot))
            cache.append(layer, None, positions, k.contiguous(), v.contiguous(), kernels=kernels)
            a = attn(q.contiguous(), *cache.planes(layer), lengths)
            x = self._block(lp, x, a.reshape(n, -1), dot)
        return self._logits(x, dot), cache

    def make_cache(self, slots: int, max_len: int | None = None) -> SlotKVCache:
        """An empty slot cache of ``max_len`` positions per slot (default
        ``max_seq_len``) in the model's dtype (gpt2.py:243)."""
        cfg = self.cfg
        return SlotKVCache.create(cfg.num_layers, slots, max_len or cfg.max_seq_len,
                                  cfg.num_heads, cfg.head_size, dtype=cfg.dtype,
                                  device=self.device)


# the model class the engine builds and looks its layouts up on
MODEL = GPT2


# -- weights --------------------------------------------------------------------


def init(cfg: GPT2Config, generator: torch.Generator,
         device: str | torch.device | None = None) -> GPT2:
    """Random weights drawn from ``generator`` (which must live on
    ``device``): truncated normal (±2 std) with std 0.02 for the embeddings
    and every linear, zero biases, unit LayerNorm gains — the scales of the
    JAX ``init`` (gpt2.py:64), not its draws."""
    model = GPT2(cfg, device)

    def fill(t: torch.Tensor) -> None:
        draw = torch.empty(t.shape, dtype=torch.float32, device=t.device)
        t.copy_(nn.init.trunc_normal_(draw, std=0.02, a=-0.04, b=0.04, generator=generator))

    with torch.no_grad():
        fill(model.wte)
        fill(model.wpe)
        model.lnf_g.fill_(1.0)
        model.lnf_b.zero_()
        for blk in model.blocks:
            for name in NORMS:
                getattr(blk, name).fill_(1.0 if name.endswith("_g") else 0.0)
            for name, bias in LINEARS:
                fill(getattr(blk, name).weight)
                getattr(blk, bias).zero_()
    return model


def jax_state(np_params: dict) -> dict[str, torch.Tensor]:
    """A JAX GPT-2 tree (gpt2.py:64) given as numpy arrays, as CPU tensors
    under the names of ``GPT2.state_dict()``, in the tree's dtypes: the
    stacked ``[L, ...]`` blocks split into layers, each linear weight in the
    port's layout (``models.llama._linear_state``), quantized or not."""
    state = {name: tensor_from_numpy(np_params[name]) for name in ("wte", "wpe", "lnf_g", "lnf_b")}
    blocks = np_params["blocks"]
    for layer in range(len(np.asarray(blocks["ln1_g"]))):
        for name in NORMS:
            state[f"blocks.{layer}.{name}"] = tensor_from_numpy(blocks[name][layer])
        for name, bias in LINEARS:
            state.update(_linear_state(f"blocks.{layer}.{name}", blocks[name], layer))
            state[f"blocks.{layer}.{bias}"] = tensor_from_numpy(blocks[bias][layer])
    return state


def params_from_jax(cfg: GPT2Config, np_params: dict,
                    device: str | torch.device | None = None) -> GPT2:
    """A ``GPT2`` holding the weights of a JAX parameter tree given as numpy
    arrays (``jax_state``): floating weights cast to the config's dtype; a
    tree quantized by ``quantize_tree`` gives a model of ``QLinear``s
    holding its int8 weights and f32 scales as they are."""
    state = jax_state(np_params)
    model = GPT2(cfg, device, int8="blocks.0.wq.q" in state)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            t.copy_(state[name].to(t.dtype))
    return model
