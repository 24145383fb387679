"""Kernel E: decode attention over the packed int4 paged pool.

Replaces gofr_tpu/ops/pallas/paged_decode.py ``paged_decode_attention_q4``
(:314). The CUDA source is ``csrc/paged_decode_q.cu`` (entry point
``gofr_paged_decode_q4``): kernel D's template with the split-half nibble
row format of ``ops/quant.py``, split and merged as kernel D is. Its plain
version is ``ops.attention.paged_decode_attention_q4_plain`` (gather,
unpack, dense decode); ``ops.attention.paged_decode_attention_q4`` chooses
between the two by the tensor's device.
"""

from __future__ import annotations

import torch

from gofr_tpu_torch.ops.cuda.paged_decode_q import HEAD_DIM, launch_quantized

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
# slot) by 0.40..4.0 and 1.5..7.9x (scripts/torch_kernel_mutants.py).
MAX_ABS = 5e-3
RMS_REL = 1.2e-2


def paged_decode_q4(q: torch.Tensor, kq_pool: torch.Tensor, vq_pool: torch.Tensor,
                    ks_pool: torch.Tensor, vs_pool: torch.Tensor, table: torch.Tensor,
                    lengths: torch.Tensor, *, scale: float | None = None) -> torch.Tensor:
    """q [N, Hq, D] bf16 against packed uint8 pool layer slices
    [P, Hkv, page, D//2] with bf16 scales [P, Hkv, page], through the block
    table [N, MaxP] (OOB entries == P), masked by lengths [N] → [N, Hq, D].
    Launches the kernel, or raises."""
    return launch_quantized(paged_decode_q4, "gofr_paged_decode_q4", torch.uint8, HEAD_DIM // 2,
                            q, kq_pool, vq_pool, ks_pool, vs_pool, table, lengths, scale)


paged_decode_q4.launches = 0
