"""gofr_tpu_torch — the PyTorch and CUDA port of gofr_tpu's serving path.

The JAX package ``gofr_tpu`` is the reference; this package sits beside it
and imports nothing from it (what it needs, it keeps its own copy of). The
layout mirrors the JAX package so each module has an obvious counterpart:

- ``gpu/device.py``      device resolution and card facts (tpu/device.py)
- ``gpu/programs.py``    the prefill and decode step functions (tpu/programs.py)
- ``gpu/engine.py``      continuous batching over the paged pool (tpu/engine.py)
- ``models/llama.py``    the Llama family as an ``nn.Module`` (models/llama.py)
- ``ops/``               norms, rope, sampling, the paged pool, attention
- ``ops/cuda/``          the hand-written Hopper kernels and their loader
- ``csrc/``              the kernels' CUDA C++ sources, built with nvcc at
                         first use into ``build/`` (never committed)

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card they raise instead of quietly running on the CPU.
"""

from __future__ import annotations

__all__ = ["__version__"]

__version__ = "0.1.0"
