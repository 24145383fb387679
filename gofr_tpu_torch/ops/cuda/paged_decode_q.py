"""Kernel D: decode attention over the int8 paged pool.

Replaces gofr_tpu/ops/pallas/paged_decode.py ``paged_decode_attention_q``
(:195). The CUDA source is ``csrc/paged_decode_q.cu`` (entry point
``gofr_paged_decode_q``), shared with kernel E, the int4 pool's
(``ops/cuda/paged_decode_q4.py``), and kernel A, the bf16 pool's
(``ops/cuda/paged_decode.py``); its header note says what bounds it
(device-memory bytes) and how the design answers that. It is split over
the sequence into ``decode_attention.split_plan``'s runs (kernel F's plan,
over the MaxP x page positions a table row holds), merged by a second
kernel launched from the same entry point. Its plain version is
``ops.attention.paged_decode_attention_q_plain`` (gather, then dense
decode); ``ops.attention.paged_decode_attention_q`` chooses between the two
by the tensor's device. ``ops.attention.paged_decode_attention_q_split_plain``
repeats the split and merge arithmetic in PyTorch for the tests.
"""

from __future__ import annotations

import ctypes

import torch

from gofr_tpu_torch.ops import cuda
from gofr_tpu_torch.ops.cuda.decode_attention import split_scratch
from gofr_tpu_torch.ops.cuda.paged_decode import HEAD_DIM, MAX_GROUP

# Agreement with the plain version on the same inputs (q bf16, a pool
# written by ops.paged.write_prompts_paged_q from random bf16 K/V). The
# plain version rounds the scores and p * vs to bf16 where the kernel keeps
# both in f32, as the TPU kernel does. At the slice's shapes (live lengths
# 699..1591 and an empty slot; 192 rows x 11 splits) on an H100 (700 W)
# they differ by at most 2.0e-3 on outputs of RMS 0.05, and an RMS
# difference of 0.45% of the output's RMS; lanes on and one past split
# boundaries by 2.4e-4 and 0.002% against the split's plain version. Limits,
# kernel A's: 5e-3 on any element and 1.2% on the RMS. The nearest planted
# fault, split boundaries overlapping by one row, moved the outputs by 0.030
# and 6.5% of their RMS; one key past the length (a whole row in the empty
# slot) and a K or V scale left out by 4.0..12 and 7.2..45x
# (scripts/torch_kernel_mutants.py).
MAX_ABS = 5e-3
RMS_REL = 1.2e-2
_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]


def launch_quantized(wrapper, entry: str, values_dtype: torch.dtype, row_width: int,
                     q: torch.Tensor, kq_pool: torch.Tensor, vq_pool: torch.Tensor,
                     ks_pool: torch.Tensor, vs_pool: torch.Tensor, table: torch.Tensor,
                     lengths: torch.Tensor, scale: float | None) -> torch.Tensor:
    """Check the inputs of a quantized-pool decode kernel (table and
    lengths int32 and contiguous on the card, as ``Llama.decode_step``
    converts them once per step), launch C entry point ``entry`` (the split
    kernel and its merge) and count the launch on ``wrapper``; raise on
    anything the kernel does not take and on a CUDA error."""
    name = wrapper.__name__
    cuda.require(all(t.is_cuda for t in (q, kq_pool, vq_pool, ks_pool, vs_pool)),
                 f"{name} takes tensors on the card")
    n, hq, d = q.shape
    pool, hkv, page, width = kq_pool.shape
    cuda.require(q.dtype == torch.bfloat16 and kq_pool.dtype == vq_pool.dtype == values_dtype
                 and ks_pool.dtype == vs_pool.dtype == torch.bfloat16,
                 f"{name} takes bf16 q and scales and {values_dtype} pools, got q {q.dtype}, "
                 f"pools {kq_pool.dtype}/{vq_pool.dtype}, scales {ks_pool.dtype}/{vs_pool.dtype}")
    cuda.require(d == HEAD_DIM and width == row_width and vq_pool.shape == kq_pool.shape
                 and ks_pool.shape == vs_pool.shape == (pool, hkv, page),
                 f"{name} takes head_dim {HEAD_DIM} (rows of {row_width} B) and scales "
                 f"[P, Hkv, page], got q {tuple(q.shape)} pool {tuple(kq_pool.shape)} "
                 f"scales {tuple(ks_pool.shape)}")
    cuda.require(hq % hkv == 0 and hq // hkv <= MAX_GROUP,
                 f"{name} takes up to {MAX_GROUP} query heads per KV head, got {hq}/{hkv}")
    cuda.require(all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (kq_pool, vq_pool))
                 and ks_pool.is_contiguous() and vs_pool.is_contiguous(),
                 f"{name} pools must be contiguous and 16-byte aligned")
    cuda.require(table.is_cuda and lengths.is_cuda and table.dtype == lengths.dtype == torch.int32
                 and table.dim() == 2 and table.shape[0] == n and lengths.shape == (n,)
                 and table.is_contiguous() and lengths.is_contiguous(),
                 f"{name} takes an int32 table [N, MaxP] and lengths [N], contiguous on the card")
    scale = scale if scale is not None else d ** -0.5
    q = q.contiguous()
    out = torch.empty_like(q)
    if n == 0:
        return out
    maxp = table.shape[1]
    split_rows, splits, scratch = split_scratch(q, hkv, maxp * page, name,
                                               (n, hq, hkv, d, page, maxp, pool))
    fn = cuda.bind(entry, _ARGTYPES)
    rc = fn(q.data_ptr(), kq_pool.data_ptr(), vq_pool.data_ptr(), ks_pool.data_ptr(),
            vs_pool.data_ptr(), table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), n, hkv, hq // hkv, pool, page, maxp, split_rows, splits, scale,
            cuda.stream_of(q))
    cuda.check(rc, name)
    wrapper.launches += 1
    return out


def paged_decode_q(q: torch.Tensor, kq_pool: torch.Tensor, vq_pool: torch.Tensor,
                   ks_pool: torch.Tensor, vs_pool: torch.Tensor, table: torch.Tensor,
                   lengths: torch.Tensor, *, scale: float | None = None) -> torch.Tensor:
    """q [N, Hq, D] bf16 against int8 pool layer slices [P, Hkv, page, D]
    with bf16 scales [P, Hkv, page], through the block table [N, MaxP]
    (OOB entries == P), masked by lengths [N] → [N, Hq, D]. Launches the
    kernel, or raises."""
    return launch_quantized(paged_decode_q, "gofr_paged_decode_q", torch.int8, HEAD_DIM,
                            q, kq_pool, vq_pool, ks_pool, vs_pool, table, lengths, scale)


paged_decode_q.launches = 0
