"""BERT encoder for embedding serving as an ``nn.Module`` (counterpart of
gofr_tpu/models/bert.py; BASELINE.md configuration #1).

Post-LayerNorm transformer encoder: word, position and token-type
embeddings, then per layer attention and an exact-erf GELU MLP, each
followed by a residual LayerNorm (bert.py:108-131). The JAX package keeps
stacked ``[L, ...]`` trees and scans; here each layer is a ``BertBlock`` of
``nn.Linear``s with bias, a JAX ``x @ W + b`` with W [in, out] becoming a
weight of [out, in] (``params_from_jax`` transposes).

Entry points, each a method of ``Bert``:

- ``encode``        tokens [B, S] (and lengths [B]) → hidden states
                    [B, S, E] (bert.py:108)
- ``embed_pooled``  length-masked mean of the hidden states, L2-normalised,
                    f32 [B, E]: the embedding endpoint's payload (bert.py:134)

Attention goes through ``ops.attention.mha_attention`` (non-causal, keys
masked by ``lengths``), so through kernel C's head-dim-64 build on the card;
``kernels=False`` runs its plain version instead, which is how the
card-side check holds the kernel against the plain path end to end. The
LayerNorms, GELU and linears are plain PyTorch on every device, as they are
XLA in JAX. Positions are ``arange(S)`` over the padded length and token
types default to zeros, so a padded query attends like a real one and is
then masked out of the mean, as in JAX.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from gofr_tpu_torch.gpu.device import resolve_device
from gofr_tpu_torch.models.llama import tensor_from_numpy
from gofr_tpu_torch.ops.attention import mha_attention, mha_attention_plain
from gofr_tpu_torch.ops.norms import layer_norm


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_seq_len: int = 512
    type_vocab_size: int = 2
    norm_eps: float = 1e-12
    dtype: torch.dtype = torch.float32

    @property
    def head_size(self) -> int:
        return self.hidden_size // self.num_heads

    @classmethod
    def base(cls, **kw) -> "BertConfig":
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw) -> "BertConfig":
        return cls(**{**dict(
            vocab_size=256, hidden_size=32, intermediate_size=64,
            num_layers=2, num_heads=2, max_seq_len=64,
        ), **kw})


# the family's registry entries (models/__init__.py)
CONFIG = BertConfig
TASKS = ("embed",)


# the block's linears: (port name, JAX weight, JAX bias)
LINEARS = (("wq", "wq", "bq"), ("wk", "wk", "bk"), ("wv", "wv", "bv"), ("wo", "wo", "bo"),
           ("w_inter", "w_inter", "b_inter"), ("w_out", "w_out", "b_out"))
NORMS = ("attn_norm_w", "attn_norm_b", "mlp_norm_w", "mlp_norm_b")


class BertBlock(nn.Module):
    def __init__(self, cfg: BertConfig, **factory):
        super().__init__()
        e, m = cfg.hidden_size, cfg.intermediate_size
        self.wq, self.wk, self.wv, self.wo = (nn.Linear(e, e, **factory) for _ in range(4))
        self.w_inter = nn.Linear(e, m, **factory)
        self.w_out = nn.Linear(m, e, **factory)
        for name in NORMS:
            setattr(self, name, nn.Parameter(torch.empty(e, **factory)))


class Bert(nn.Module):
    """Weights are uninitialised after construction: build with ``init``
    (random, from a generator) or ``params_from_jax`` (the JAX tree)."""

    def __init__(self, cfg: BertConfig, device: str | torch.device | None = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        meta = dict(device="meta", dtype=cfg.dtype)
        e = cfg.hidden_size
        self.word_embed = nn.Parameter(torch.empty(cfg.vocab_size, e, **meta))
        self.pos_embed = nn.Parameter(torch.empty(cfg.max_seq_len, e, **meta))
        self.type_embed = nn.Parameter(torch.empty(cfg.type_vocab_size, e, **meta))
        self.embed_norm_w = nn.Parameter(torch.empty(e, **meta))
        self.embed_norm_b = nn.Parameter(torch.empty(e, **meta))
        self.blocks = nn.ModuleList(BertBlock(cfg, **meta) for _ in range(cfg.num_layers))
        # the pooler is in the JAX tree (and HF's) but neither entry point reads it
        self.pooler = nn.Linear(e, e, **meta)
        self.to_empty(device=dev)
        self.requires_grad_(False)

    @property
    def device(self) -> torch.device:
        return self.word_embed.device

    def encode(self, tokens: torch.Tensor, lengths: torch.Tensor | None = None,
               token_types: torch.Tensor | None = None, *, kernels: bool = True) -> torch.Tensor:
        """tokens [B, S] → hidden states [B, S, E] in the config's dtype
        (bert.py:108); ``lengths`` [B] masks the padded keys."""
        cfg = self.cfg
        b, s = tokens.shape
        if token_types is None:
            token_types = torch.zeros_like(tokens)
        x = (self.word_embed[tokens] + self.pos_embed[:s][None]
             + self.type_embed[token_types]).to(cfg.dtype)
        x = layer_norm(x, self.embed_norm_w, self.embed_norm_b, cfg.norm_eps)
        attend = mha_attention if kernels else mha_attention_plain
        d = cfg.head_size
        for lp in self.blocks:
            q = lp.wq(x).view(b, s, -1, d)
            k = lp.wk(x).view(b, s, -1, d)
            v = lp.wv(x).view(b, s, -1, d)
            attn = attend(q, k, v, causal=False, kv_lengths=lengths).reshape(b, s, -1)
            x = layer_norm(x + lp.wo(attn), lp.attn_norm_w, lp.attn_norm_b, cfg.norm_eps)
            inter = F.gelu(lp.w_inter(x))
            x = layer_norm(x + lp.w_out(inter), lp.mlp_norm_w, lp.mlp_norm_b, cfg.norm_eps)
        return x

    def embed_pooled(self, tokens: torch.Tensor, lengths: torch.Tensor, *,
                     kernels: bool = True) -> torch.Tensor:
        """Mean-pooled, L2-normalised sentence embeddings [B, E] in f32
        (bert.py:134): the mean over each row's first ``lengths`` positions,
        divided by max(length, 1), over max(norm, 1e-12)."""
        hidden = self.encode(tokens, lengths, kernels=kernels).float()
        mask = (torch.arange(tokens.shape[1], device=tokens.device)[None]
                < lengths[:, None]).float()
        summed = torch.einsum("bse,bs->be", hidden, mask)
        pooled = summed / torch.clamp(lengths[:, None].float(), min=1.0)
        return pooled / torch.clamp(torch.linalg.vector_norm(pooled, dim=-1, keepdim=True),
                                    min=1e-12)


def init(cfg: BertConfig, generator: torch.Generator,
         device: str | torch.device | None = None) -> Bert:
    """Random weights drawn from ``generator`` (which must live on
    ``device``) at the scales of the JAX ``init`` (bert.py:50), not its
    draws: normal clipped at two standard deviations, 0.02 for the
    embeddings, 1/sqrt(fan_in) for the projections; zero biases, unit norm
    weights."""
    model = Bert(cfg, device)

    def fill(t: torch.Tensor, std: float) -> None:
        t.normal_(0.0, std, generator=generator).clamp_(-2 * std, 2 * std)

    with torch.no_grad():
        for t in (model.word_embed, model.pos_embed, model.type_embed):
            fill(t, 0.02)
        model.embed_norm_w.fill_(1.0)
        model.embed_norm_b.zero_()
        linears = [model.pooler] + [getattr(blk, name) for blk in model.blocks
                                    for name, _, _ in LINEARS]
        for lin in linears:
            fill(lin.weight, lin.in_features ** -0.5)
            lin.bias.zero_()
        for blk in model.blocks:
            for name in NORMS:
                getattr(blk, name).fill_(1.0 if name.endswith("_w") else 0.0)
    return model


def load_stacked(model: nn.Module, state: dict[str, torch.Tensor], blocks: dict,
                 linears: tuple, norms: tuple) -> None:
    """Fill ``model`` from ``state`` (its non-block tensors) and a stacked
    JAX ``blocks`` tree: each layer's linears (W [in, out] transposed, bias
    as it is) and norm vectors; floating weights cast to the model's
    dtype."""
    for layer in range(len(blocks[norms[0]])):
        prefix = f"blocks.{layer}"
        for port, w, b in linears:
            state[f"{prefix}.{port}.weight"] = tensor_from_numpy(blocks[w][layer]).T
            state[f"{prefix}.{port}.bias"] = tensor_from_numpy(blocks[b][layer])
        for name in norms:
            state[f"{prefix}.{name}"] = tensor_from_numpy(blocks[name][layer])
    with torch.no_grad():
        for name, t in model.state_dict().items():
            t.copy_(state[name].to(t.dtype))


def params_from_jax(cfg: BertConfig, np_params: dict,
                    device: str | torch.device | None = None) -> Bert:
    """A ``Bert`` holding the weights of a JAX parameter tree (bert.py:50)
    given as numpy arrays, the stacked ``[L, ...]`` blocks split into
    layers."""
    model = Bert(cfg, device)
    state = {name: tensor_from_numpy(np_params[name])
             for name in ("word_embed", "pos_embed", "type_embed", "embed_norm_w", "embed_norm_b")}
    state["pooler.weight"] = tensor_from_numpy(np_params["pooler_w"]).T
    state["pooler.bias"] = tensor_from_numpy(np_params["pooler_b"])
    load_stacked(model, state, np_params["blocks"], LINEARS, NORMS)
    return model
