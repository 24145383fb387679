"""Kernel A: decode attention over the paged pool, bf16 or f32.

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

``Bf16Rows`` is a template built at head dim 128 (Llama-3-8B) and 64 (Llama
``one_b``); ``paged_decode`` takes either and any other raises. The f32
pool (an f32 Llama in its own dtype) goes to kernel F's f32 body with the
pool's address policy (``csrc/paged_decode.cu`` ``PoolRows``, entry points
``gofr_paged_decode_f32`` and ``gofr_paged_decode_d64_f32``): 32-row f32
tiles, one block-table entry a tile, P unrounded, the merge and the output
in f32; it takes page sizes that are a multiple of 32. Each build counts
its launches under its own name: ``paged_decode`` (128, bf16),
``paged_decode_d64`` (64, bf16), ``paged_decode_f32`` (128, f32) and
``paged_decode_d64_f32``. A launch takes the split plan pinned at its own
pool dtype (``autotune.dtype_name``), so a pin measured on one build never
steers another's.
"""

from __future__ import annotations

import ctypes

import torch

from gofr_tpu_torch.ops import autotune, cuda
from gofr_tpu_torch.ops.cuda.decode_attention import split_scratch

HEAD_DIMS = (128, 64)
DTYPES = (torch.bfloat16, torch.float32)
# an f32 tile is 32 rows, which must not straddle a page
F32_PAGE_MULTIPLE = 32
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
# (scripts/torch_kernel_mutants.py). The 64 build, held to the same
# limits, read 2.0e-3 and 0.48% at Llama one_b's step (the same lengths,
# Hq 32, Hkv 4, page 128; 128 rows x 16 splits), the nearest planted fault,
# the last live key dropped, 0.019 / 2.4%, split boundaries overlapping by
# one row 0.041 / 7.8%, and its own faults, half of each output row never
# summed and a 128-wide row stride, 0.25 / 70% and 0.39 / 141%.
MAX_ABS = 5e-3
RMS_REL = 1.2e-2
# The f32 builds against the f32 plain version: both take scores and P.V in
# f32 with P unrounded, so they differ by the order of f32 sums alone. On
# an H100 (700 W) at the slice's shapes (Hq 32, Hkv 8, page 128; 192 rows
# x 11 splits) the 128 build read 1.5e-7 on outputs of RMS 0.05 and 3.4e-7
# of the RMS, the 64 build at one_b's step 1.4e-7 and 3.1e-7, split edges
# included. Limits, kernel F's f32 ones: 1e-4 on any element and 2e-5 on
# the RMS ratio. The nearest planted faults (scripts/torch_kernel_mutants.py):
# P rounded to bf16 moved the outputs by 3.1e-4 / 1.3e-3 of the RMS (3.3e-4
# / 1.3e-3 at 64), and the last tile of each page read through the next
# page's table entry by 0.077 / 24% (0.12 / 26%).
F32 = cuda.Limits(MAX_ABS=1e-4, RMS_REL=2e-5)
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
# the C entry point of each build, by (head dim, type)
ENTRY = {(128, torch.bfloat16): "gofr_paged_decode", (64, torch.bfloat16): "gofr_paged_decode_d64",
         (128, torch.float32): "gofr_paged_decode_f32",
         (64, torch.float32): "gofr_paged_decode_d64_f32"}


def paged_decode(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                 table: torch.Tensor, lengths: torch.Tensor, *,
                 scale: float | None = None) -> torch.Tensor:
    """q [N, Hq, D] against pool layer slices [P, Hkv, page, D] through the
    block table [N, MaxP] (OOB entries == P), masked by lengths [N] →
    [N, Hq, D] in q's type. D is 128 or 64; q and the pools are all bf16 or
    all f32 (f32 pools with page % 32 == 0). Table and lengths are int32
    and contiguous on the card (``Llama.decode_step`` converts them once
    per step). Launches the kernel (and its merge), or raises."""
    cuda.require(q.is_cuda and k_pool.is_cuda and v_pool.is_cuda,
                 "paged_decode takes tensors on the card")
    n, hq, d = q.shape
    pool, hkv, page, _ = k_pool.shape
    cuda.require(q.dtype == k_pool.dtype == v_pool.dtype and q.dtype in DTYPES,
                 f"paged_decode takes bf16 or f32 q and pools of one type, got "
                 f"{q.dtype}/{k_pool.dtype}/{v_pool.dtype}")
    cuda.require(q.dtype != torch.float32 or page % F32_PAGE_MULTIPLE == 0,
                 f"paged_decode takes f32 pools with pages of a multiple of {F32_PAGE_MULTIPLE} "
                 f"positions, got {page}")
    cuda.require(d in HEAD_DIMS and k_pool.shape[3] == d and v_pool.shape == k_pool.shape,
                 f"paged_decode takes head_dim 128 or 64, got q {tuple(q.shape)} "
                 f"pool {tuple(k_pool.shape)}")
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
    build = d, q.dtype
    # the pin's dims end with the pool's dtype, as the engine names it
    split_rows, splits, scratch = split_scratch(
        q, hkv, maxp * page, "paged_decode",
        (n, hq, hkv, d, page, maxp, pool, autotune.dtype_name(q.dtype)))
    fn = cuda.bind(ENTRY[build], _ARGTYPES)
    rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), table.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), scratch.data_ptr(), n, hkv, hq // hkv, pool, page,
            maxp, split_rows, splits, scale, cuda.stream_of(q))
    cuda.check(rc, _COUNTED[build].__name__)
    _COUNTED[build].launches += 1
    return out


def paged_decode_d64(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                     table: torch.Tensor, lengths: torch.Tensor, **kw) -> torch.Tensor:
    """Kernel A's head-dim-64 build under its own name: ``paged_decode`` on
    q and pools of head dim 64 (any other raises)."""
    cuda.require(q.shape[-1] == 64, f"paged_decode_d64 takes head_dim 64, got {q.shape[-1]}")
    return paged_decode(q, k_pool, v_pool, table, lengths, **kw)


def paged_decode_f32(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                     table: torch.Tensor, lengths: torch.Tensor, **kw) -> torch.Tensor:
    """Kernel A's f32 build under its own name: ``paged_decode`` on f32 q
    and pools (any other type raises); counted by head dim as
    ``paged_decode_f32`` (128) or ``paged_decode_d64_f32``."""
    cuda.require(q.dtype == torch.float32, f"paged_decode_f32 takes f32 q, got {q.dtype}")
    return paged_decode(q, k_pool, v_pool, table, lengths, **kw)


def paged_decode_d64_f32(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                         table: torch.Tensor, lengths: torch.Tensor, **kw) -> torch.Tensor:
    """Kernel A's f32 build at head dim 64 under its own name (any other
    type or head dim raises)."""
    cuda.require(q.shape[-1] == 64, f"paged_decode_d64_f32 takes head_dim 64, got {q.shape[-1]}")
    return paged_decode_f32(q, k_pool, v_pool, table, lengths, **kw)


paged_decode.launches = 0
paged_decode_d64.launches = 0
paged_decode_f32.launches = 0
paged_decode_d64_f32.launches = 0
_COUNTED = {(128, torch.bfloat16): paged_decode, (64, torch.bfloat16): paged_decode_d64,
            (128, torch.float32): paged_decode_f32, (64, torch.float32): paged_decode_d64_f32}
