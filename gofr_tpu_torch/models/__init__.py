"""Model families of the port (counterpart of gofr_tpu.models), and
``ModelSpec``, what ``App.serve_model`` consumes (models/base.py:55)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch


@dataclass
class ModelSpec:
    """The serving-side description of a model that ``gpu.engine.
    build_engine`` turns into a running engine.

    family: "llama" (the one family ported so far)
    config: the family's config (``models.llama.LlamaConfig``)
    task: "generate" (embed and classify wait for BatchEngine)
    weights: None for random weights drawn from the engine's ``seed``; a
             ``Llama`` already built; or a JAX parameter tree as numpy
             arrays (``models.llama.params_from_jax``). Checkpoint paths
             and Hugging Face ids wait for ``train/`` and ``convert.py``.
    tokenizer: an object with ``encode``/``decode`` (e.g.
             ``utils.tokenizer.ByteTokenizer``), or None for id prompts
    dtype: the weights' torch dtype
    """

    family: str
    config: Any
    task: str = "generate"
    weights: Any = None
    tokenizer: Any = None
    dtype: torch.dtype = torch.bfloat16
