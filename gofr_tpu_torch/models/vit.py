"""Vision Transformer classifier as an ``nn.Module`` (counterpart of
gofr_tpu/models/vit.py; BASELINE.md configuration #3, pub/sub → ViT).

Pre-LayerNorm encoder: the image cut into patches (``patchify``), each
patch embedded by one matmul, a CLS token prepended and positions added;
per layer attention and an exact-erf GELU MLP, each after a LayerNorm and
added back to the residual; a final LayerNorm, and the CLS position's
logits in f32 (vit.py:121-149), or its embedding when the config has no
head (``num_classes`` 0). Layers are ``ViTBlock``s of ``nn.Linear``s with
bias (``params_from_jax`` transposes the JAX [in, out] weights).

Attention goes through ``ops.attention.mha_attention`` (non-causal, all
197 positions at 224 / 16), so through kernel C's head-dim-64 build on
the card; ``forward(..., kernels=False)`` runs its plain version instead.
The rest is plain PyTorch on every device, as it is XLA in JAX.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from gofr_tpu_torch.gpu.device import resolve_device
from gofr_tpu_torch.models.bert import load_stacked
from gofr_tpu_torch.models.llama import tensor_from_numpy
from gofr_tpu_torch.ops.attention import mha_attention, mha_attention_plain
from gofr_tpu_torch.ops.norms import layer_norm


@dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    num_channels: int = 3
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    num_classes: int = 1000
    norm_eps: float = 1e-12
    dtype: torch.dtype = torch.float32

    @property
    def head_size(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @classmethod
    def large(cls, **kw) -> "ViTConfig":
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw) -> "ViTConfig":
        return cls(**{**dict(
            image_size=32, patch_size=8, hidden_size=32, intermediate_size=64,
            num_layers=2, num_heads=2, num_classes=10,
        ), **kw})


# the family's registry entries (models/__init__.py)
CONFIG = ViTConfig
TASKS = ("classify",)


LINEARS = (("wq", "wq", "bq"), ("wk", "wk", "bk"), ("wv", "wv", "bv"), ("wo", "wo", "bo"),
           ("w_inter", "w_inter", "b_inter"), ("w_out", "w_out", "b_out"))
NORMS = ("norm1_w", "norm1_b", "norm2_w", "norm2_b")


class ViTBlock(nn.Module):
    def __init__(self, cfg: ViTConfig, **factory):
        super().__init__()
        e, m = cfg.hidden_size, cfg.intermediate_size
        self.wq, self.wk, self.wv, self.wo = (nn.Linear(e, e, **factory) for _ in range(4))
        self.w_inter = nn.Linear(e, m, **factory)
        self.w_out = nn.Linear(m, e, **factory)
        for name in NORMS:
            setattr(self, name, nn.Parameter(torch.empty(e, **factory)))


def patchify(cfg: ViTConfig, images: torch.Tensor) -> torch.Tensor:
    """images [B, H, W, C] → patches [B, N, P*P*C], row-major within a
    patch (vit.py:110), the order the JAX patch weights take."""
    b, h, w, c = images.shape
    p = cfg.patch_size
    x = images.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // p) * (w // p), p * p * c)


class ViT(nn.Module):
    """Weights are uninitialised after construction: build with ``init``
    (random, from a generator) or ``params_from_jax`` (the JAX tree)."""

    def __init__(self, cfg: ViTConfig, device: str | torch.device | None = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        meta = dict(device="meta", dtype=cfg.dtype)
        e = cfg.hidden_size
        patch_dim = cfg.patch_size * cfg.patch_size * cfg.num_channels
        self.cls_token = nn.Parameter(torch.empty(1, e, **meta))
        self.pos_embed = nn.Parameter(torch.empty(cfg.num_patches + 1, e, **meta))
        self.patch = nn.Linear(patch_dim, e, **meta)
        self.blocks = nn.ModuleList(ViTBlock(cfg, **meta) for _ in range(cfg.num_layers))
        self.final_norm_w = nn.Parameter(torch.empty(e, **meta))
        self.final_norm_b = nn.Parameter(torch.empty(e, **meta))
        self.head = nn.Linear(e, cfg.num_classes, **meta) if cfg.num_classes else None
        self.to_empty(device=dev)
        self.requires_grad_(False)

    @property
    def device(self) -> torch.device:
        return self.pos_embed.device

    def forward(self, images: torch.Tensor, *, kernels: bool = True) -> torch.Tensor:
        """images [B, H, W, C] → logits [B, num_classes] in f32, or the CLS
        embedding [B, E] in f32 when the config has no head (vit.py:121)."""
        cfg = self.cfg
        b = images.shape[0]
        x = self.patch(patchify(cfg, images).to(cfg.dtype))  # [B, N, E]
        cls = self.cls_token[None].expand(b, 1, cfg.hidden_size).to(cfg.dtype)
        x = torch.cat([cls, x], dim=1) + self.pos_embed[None]
        s, d = x.shape[1], cfg.head_size
        attend = mha_attention if kernels else mha_attention_plain
        for lp in self.blocks:
            h = layer_norm(x, lp.norm1_w, lp.norm1_b, cfg.norm_eps)
            q = lp.wq(h).view(b, s, -1, d)
            k = lp.wk(h).view(b, s, -1, d)
            v = lp.wv(h).view(b, s, -1, d)
            x = x + lp.wo(attend(q, k, v, causal=False).reshape(b, s, -1))
            h2 = layer_norm(x, lp.norm2_w, lp.norm2_b, cfg.norm_eps)
            x = x + lp.w_out(F.gelu(lp.w_inter(h2)))
        x = layer_norm(x, self.final_norm_w, self.final_norm_b, cfg.norm_eps)
        cls_out = x[:, 0].float()
        if self.head is None:
            return cls_out
        return F.linear(cls_out, self.head.weight.float(), self.head.bias.float())


def init(cfg: ViTConfig, generator: torch.Generator,
         device: str | torch.device | None = None) -> ViT:
    """Random weights drawn from ``generator`` (which must live on
    ``device``) at the scales of the JAX ``init`` (vit.py:56), not its
    draws: normal clipped at two standard deviations, 0.02 for the
    positions, 1/sqrt(fan_in) for the projections and the head; a zero CLS
    token and biases, unit norm weights."""
    model = ViT(cfg, device)

    def fill(t: torch.Tensor, std: float) -> None:
        t.normal_(0.0, std, generator=generator).clamp_(-2 * std, 2 * std)

    with torch.no_grad():
        model.cls_token.zero_()
        fill(model.pos_embed, 0.02)
        linears = [model.patch] + [getattr(blk, name) for blk in model.blocks
                                   for name, _, _ in LINEARS]
        if model.head is not None:
            linears.append(model.head)
        for lin in linears:
            fill(lin.weight, lin.in_features ** -0.5)
            lin.bias.zero_()
        for blk in model.blocks:
            for name in NORMS:
                getattr(blk, name).fill_(1.0 if name.endswith("_w") else 0.0)
        model.final_norm_w.fill_(1.0)
        model.final_norm_b.zero_()
    return model


def params_from_jax(cfg: ViTConfig, np_params: dict,
                    device: str | torch.device | None = None) -> ViT:
    """A ``ViT`` holding the weights of a JAX parameter tree (vit.py:56)
    given as numpy arrays, the stacked ``[L, ...]`` blocks split into
    layers."""
    model = ViT(cfg, device)
    state = {name: tensor_from_numpy(np_params[name])
             for name in ("cls_token", "pos_embed", "final_norm_w", "final_norm_b")}
    state["patch.weight"] = tensor_from_numpy(np_params["patch_w"]).T
    state["patch.bias"] = tensor_from_numpy(np_params["patch_b"])
    if cfg.num_classes:
        state["head.weight"] = tensor_from_numpy(np_params["head_w"]).T
        state["head.bias"] = tensor_from_numpy(np_params["head_b"])
    load_stacked(model, state, np_params["blocks"], LINEARS, NORMS)
    return model
