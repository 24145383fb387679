"""Kernel E: decode attention over the packed int4 paged pool.

Replaces gofr_tpu/ops/pallas/paged_decode.py ``paged_decode_attention_q4``
(:314). The CUDA source is ``csrc/paged_decode_q.cu`` (entry point
``gofr_paged_decode_q4``): kernel D's template with the split-half nibble
row format of ``ops/quant.py``, split and merged as kernel D is. Its plain
version is ``ops.attention.paged_decode_attention_q4_plain`` (gather,
unpack, dense decode); ``ops.attention.paged_decode_attention_q4`` chooses
between the two by the tensor's device.

Built at head dim 128 and 64, as kernel D, for a bf16 q and, under an f32
model, an f32 q (entry points ``gofr_paged_decode_q4_f32`` and
``gofr_paged_decode_q4_d64_f32``: the f32 q split into three bf16 pieces
whose products with the nibbles are summed in f32, f32 out, as D's f32-q
build). Each build counts its launches under its own name:
``paged_decode_q4`` (128, bf16 q), ``paged_decode_q4_d64`` (64),
``paged_decode_q4_f32`` (128, f32 q) and ``paged_decode_q4_d64_f32``. All
take the split plan the autotuner pinned for ``paged_decode_q4`` at their
own pool and query dtype (``int4/bfloat16``, ``int4/float32``:
``paged_decode_q.pin_dtype``).
"""

from __future__ import annotations

import torch

from gofr_tpu_torch.ops import cuda
from gofr_tpu_torch.ops.cuda.paged_decode_q import launch_quantized

# Agreement with the plain version on the same inputs (q bf16, a pool
# written by ops.paged.write_prompts_paged_q4 from random bf16 K/V); the
# plain version rounds the scores and p * vs to bf16, the kernel does not.
# At the slice's shapes on an H100 (700 W) they differ by at most 2.0e-3 on
# outputs of RMS 0.05, and an RMS difference of 0.47% of the output's RMS;
# lanes on and one past split boundaries by 1.5e-5 against the split's
# plain version. Limits, kernel A's: 5e-3 and 1.2%. The nearest planted
# fault, split boundaries overlapping by one row, moved the outputs by 0.036
# and 6.6% of their RMS; swapped nibble halves by 0.35 and 1.4x; a bias of
# 7, a scale left out and one key past the length (a whole row in the empty
# slot) by 0.40..4.0 and 1.5..7.9x (scripts/torch_kernel_mutants.py). The
# 64 build, held to the same limits at Llama one_b's step, read 2.0e-3 and
# 0.48% on an H100 (700 W), split boundaries 9.8e-4; its own planted faults,
# the high nibbles' columns 64 up instead of 32 (for q) and a 128-wide row
# stride, moved the outputs by 0.22 / 89% and 1.0 / 160%.
MAX_ABS = 5e-3
RMS_REL = 1.2e-2
# The f32-q builds against the f32 plain version (q.k in f32 on the nibble
# values, p * vs unrounded): as D's f32-q builds, the three-piece split
# keeps every bit of q and each piece's product with a nibble is exact, so
# they differ by the order of f32 sums alone. Limits, D's f32 ones: 1e-4 on
# any element and 2e-5 on the RMS ratio.
F32 = cuda.Limits(MAX_ABS=1e-4, RMS_REL=2e-5)
# the C entry point of each build, by (head dim, query type)
ENTRY = {(128, torch.bfloat16): "gofr_paged_decode_q4",
         (64, torch.bfloat16): "gofr_paged_decode_q4_d64",
         (128, torch.float32): "gofr_paged_decode_q4_f32",
         (64, torch.float32): "gofr_paged_decode_q4_d64_f32"}


def paged_decode_q4(q: torch.Tensor, kq_pool: torch.Tensor, vq_pool: torch.Tensor,
                    ks_pool: torch.Tensor, vs_pool: torch.Tensor, table: torch.Tensor,
                    lengths: torch.Tensor, *, scale: float | None = None) -> torch.Tensor:
    """q [N, Hq, D] bf16 or f32 against packed uint8 pool layer slices
    [P, Hkv, page, D//2] with bf16 scales [P, Hkv, page], through the block
    table [N, MaxP] (OOB entries == P), masked by lengths [N] → [N, Hq, D]
    in q's type. D is 128 or 64. Launches the kernel, or raises."""
    return launch_quantized("paged_decode_q4", _COUNTED, ENTRY, torch.uint8, 2,
                            q, kq_pool, vq_pool, ks_pool, vs_pool, table, lengths, scale)


def paged_decode_q4_d64(q: torch.Tensor, kq_pool: torch.Tensor, vq_pool: torch.Tensor,
                        ks_pool: torch.Tensor, vs_pool: torch.Tensor, table: torch.Tensor,
                        lengths: torch.Tensor, **kw) -> torch.Tensor:
    """Kernel E's head-dim-64 build under its own name: ``paged_decode_q4``
    on q and pools of head dim 64 (any other raises)."""
    cuda.require(q.shape[-1] == 64, f"paged_decode_q4_d64 takes head_dim 64, got {q.shape[-1]}")
    return paged_decode_q4(q, kq_pool, vq_pool, ks_pool, vs_pool, table, lengths, **kw)


def paged_decode_q4_f32(q: torch.Tensor, kq_pool: torch.Tensor, vq_pool: torch.Tensor,
                        ks_pool: torch.Tensor, vs_pool: torch.Tensor, table: torch.Tensor,
                        lengths: torch.Tensor, **kw) -> torch.Tensor:
    """Kernel E's f32-q build under its own name: ``paged_decode_q4`` on an
    f32 q (any other type raises); counted by head dim as
    ``paged_decode_q4_f32`` (128) or ``paged_decode_q4_d64_f32``."""
    cuda.require(q.dtype == torch.float32, f"paged_decode_q4_f32 takes an f32 q, got {q.dtype}")
    return paged_decode_q4(q, kq_pool, vq_pool, ks_pool, vs_pool, table, lengths, **kw)


def paged_decode_q4_d64_f32(q: torch.Tensor, kq_pool: torch.Tensor, vq_pool: torch.Tensor,
                            ks_pool: torch.Tensor, vs_pool: torch.Tensor, table: torch.Tensor,
                            lengths: torch.Tensor, **kw) -> torch.Tensor:
    """Kernel E's f32-q build at head dim 64 under its own name (any other
    type or head dim raises)."""
    cuda.require(q.shape[-1] == 64,
                 f"paged_decode_q4_d64_f32 takes head_dim 64, got {q.shape[-1]}")
    return paged_decode_q4_f32(q, kq_pool, vq_pool, ks_pool, vs_pool, table, lengths, **kw)


paged_decode_q4.launches = 0
paged_decode_q4_d64.launches = 0
paged_decode_q4_f32.launches = 0
paged_decode_q4_d64_f32.launches = 0
_COUNTED = {(128, torch.bfloat16): paged_decode_q4, (64, torch.bfloat16): paged_decode_q4_d64,
            (128, torch.float32): paged_decode_q4_f32,
            (64, torch.float32): paged_decode_q4_d64_f32}
