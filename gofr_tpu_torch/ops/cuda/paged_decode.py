"""Kernel A: decode attention over the bf16 paged pool.

Replaces gofr_tpu/ops/pallas/paged_decode.py ``paged_decode_attention``
(:94). The CUDA source is ``csrc/paged_decode_q.cu`` (entry point
``gofr_paged_decode``), the template of kernels D and E with bf16 rows
(``Bf16Rows``: no scale planes, P.V on the tensor cores on p rounded to
bf16); its header note says what bounds it (device-memory bytes) and how
the design answers that. It is split over the sequence into
``decode_attention.split_plan``'s runs (over the MaxP x page positions a
table row holds), merged by a second kernel launched from the same entry
point. Its plain version is ``ops.attention.paged_decode_attention_plain``
(gather, then dense decode); ``ops.attention.paged_decode_attention``
chooses between the two by the tensor's device.
``ops.attention.paged_decode_attention_split_plain`` repeats the split and
merge arithmetic in PyTorch for the tests.
"""

from __future__ import annotations

import ctypes

import torch

from gofr_tpu_torch.ops import cuda
from gofr_tpu_torch.ops.cuda.decode_attention import split_scratch

HEAD_DIM = 128
MAX_GROUP = 8
# Agreement with the plain version on the same bf16 inputs. The plain
# version rounds the scores to bf16 where the kernel keeps them in f32, and
# each rounds its output to bf16, so they differ by a few bf16 ulps: at the
# slice's shapes (live lengths 699..1591 and an empty slot; 192 rows x 11
# splits) on an H100 (700 W) at most 2.0e-3 on outputs of RMS 0.05, and an
# RMS difference of 0.48% of the output's RMS; lanes on and one past split
# boundaries by 2.0e-3 and 0.18% against the split's plain version. Limits:
# 5e-3 on any element and 1.2% on the RMS. The nearest planted fault, the
# last live key dropped, moved the outputs by 0.035 and 3.0% of their RMS;
# split boundaries overlapping by one row by 0.049 and 6.8%; one key past
# the length (a whole row in the empty slot) by 3.2 and 7.1x
# (scripts/torch_kernel_mutants.py).
MAX_ABS = 5e-3
RMS_REL = 1.2e-2
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]


def paged_decode(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                 table: torch.Tensor, lengths: torch.Tensor, *,
                 scale: float | None = None) -> torch.Tensor:
    """q [N, Hq, D] against pool layer slices [P, Hkv, page, D] through the
    block table [N, MaxP] (OOB entries == P), masked by lengths [N] →
    [N, Hq, D]. Table and lengths are int32 and contiguous on the card
    (``Llama.decode_step`` converts them once per step). Launches the
    kernel (and its merge), or raises."""
    cuda.require(q.is_cuda and k_pool.is_cuda and v_pool.is_cuda,
                 "paged_decode takes tensors on the card")
    n, hq, d = q.shape
    pool, hkv, page, _ = k_pool.shape
    cuda.require(q.dtype == k_pool.dtype == v_pool.dtype == torch.bfloat16,
                 f"paged_decode takes bf16 q and pools, got {q.dtype}/{k_pool.dtype}/{v_pool.dtype}")
    cuda.require(d == HEAD_DIM and k_pool.shape[3] == d and v_pool.shape == k_pool.shape,
                 f"paged_decode takes head_dim {HEAD_DIM}, got q {tuple(q.shape)} pool {tuple(k_pool.shape)}")
    cuda.require(hq % hkv == 0 and hq // hkv <= MAX_GROUP,
                 f"paged_decode takes up to {MAX_GROUP} query heads per KV head, got {hq}/{hkv}")
    cuda.require(all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (k_pool, v_pool)),
                 "paged_decode pools must be contiguous and 16-byte aligned")
    cuda.require(table.is_cuda and lengths.is_cuda and table.dtype == lengths.dtype == torch.int32
                 and table.dim() == 2 and table.shape[0] == n and lengths.shape == (n,)
                 and table.is_contiguous() and lengths.is_contiguous(),
                 "paged_decode takes an int32 table [N, MaxP] and lengths [N], contiguous on the card")
    scale = scale if scale is not None else d ** -0.5
    q = q.contiguous()
    out = torch.empty_like(q)
    if n == 0:
        return out
    maxp = table.shape[1]
    split_rows, splits, scratch = split_scratch(q, hkv, maxp * page)
    fn = cuda.bind("gofr_paged_decode", _ARGTYPES)
    rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), table.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), scratch.data_ptr(), n, hkv, hq // hkv, pool, page,
            maxp, split_rows, splits, scale, cuda.stream_of(q))
    cuda.check(rc, "paged_decode")
    paged_decode.launches += 1
    return out


paged_decode.launches = 0
