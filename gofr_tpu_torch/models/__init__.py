"""Model families of the port (counterpart of gofr_tpu.models), the family
registry (models/__init__.py:22-26, base.py:81-90), and ``ModelSpec``, what
``App.serve_model`` consumes (models/base.py:55).

A family is a module with its config class (``CONFIG``), the tasks its
model serves (``TASKS``), ``init(cfg, generator, device)`` for random
weights and ``params_from_jax(cfg, tree, device)`` for a JAX parameter
tree given as numpy arrays: ``llama`` and ``gpt2`` generate, ``bert``
embeds (a ``BatchEngine``), ``vit`` classifies images (a ``BatchEngine``).
A generate family also names its model class (``MODEL``, whose methods
say which caches it has), ``jax_state`` (a tree as the model's state
dict, for ``adopt_weights``) and JAX's flags (``QUANTIZABLE``,
``SLOT_CHUNKED_PREFILL``, ``SUPPORTS_ADAPTERS``; absent is false).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Any

import torch

from gofr_tpu_torch.models import bert, gpt2, llama, vit
from gofr_tpu_torch.models.bert import BertConfig
from gofr_tpu_torch.models.gpt2 import GPT2Config
from gofr_tpu_torch.models.llama import LlamaConfig
from gofr_tpu_torch.models.vit import ViTConfig

TASKS = ("generate", "embed", "classify")


@dataclass
class ModelSpec:
    """The serving-side description of a model that ``gpu.engine.
    build_engine`` turns into a running engine.

    family: "llama" | "gpt2" | "bert" | "vit" (``register_family`` adds
            more)
    config: the family's config (``LlamaConfig``, ``GPT2Config``,
            ``BertConfig``, ``ViTConfig``), a dict of overrides of its
            defaults, or None for the defaults (``resolve_config``)
    task: "generate" (llama, gpt2), "embed" (bert) or "classify" (vit)
    weights: None for random weights drawn from the engine's ``seed``; the
             family's model already built; or a JAX parameter tree as numpy
             arrays (the family's ``params_from_jax``). Checkpoint paths and
             Hugging Face ids wait for ``train/`` and ``convert.py``.
    tokenizer: an object with ``encode``/``decode`` (e.g.
             ``utils.tokenizer.ByteTokenizer``), or None for id inputs
    dtype: the weights' torch dtype (it replaces the config's; the card
             serves bf16 and f32)
    """

    family: str
    config: Any = None
    task: str = "generate"
    weights: Any = None
    tokenizer: Any = None
    dtype: torch.dtype = torch.bfloat16


_FAMILIES: dict[str, Any] = {}


def register_family(name: str, module: Any) -> None:
    _FAMILIES[name] = module


def get_family(name: str):
    try:
        return _FAMILIES[name]
    except KeyError:
        raise KeyError(f"unknown model family {name!r}; registered: {sorted(_FAMILIES)}") from None


def family_of(model: Any):
    """The family module a model was built by (its class's module)."""
    return sys.modules[type(model).__module__]


def family_of_config(cfg: Any):
    """The registered family whose config class ``cfg`` is."""
    for module in _FAMILIES.values():
        if type(cfg) is module.CONFIG:
            return module
    raise KeyError(f"no registered family takes a {type(cfg).__name__}")


def resolve_config(family: str, config: Any):
    """The config a spec names (engine.py:3984): a config as it is, a dict
    as overrides of the family's defaults, None as the defaults."""
    if config is not None and not isinstance(config, dict):
        return config
    cls = get_family(family).CONFIG
    return cls(**config) if isinstance(config, dict) else cls()


register_family("llama", llama)
register_family("gpt2", gpt2)
register_family("bert", bert)
register_family("vit", vit)

__all__ = ["TASKS", "ModelSpec", "BertConfig", "GPT2Config", "LlamaConfig", "ViTConfig", "bert",
           "family_of", "family_of_config", "get_family", "gpt2", "llama", "register_family",
           "resolve_config", "vit"]
