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

``Int8Rows`` is a template built at head dim 128 (Llama-3-8B) and 64 (Llama
``one_b``); ``paged_decode_q`` takes either and any other raises. Each build
counts its launches under its own name: ``paged_decode_q.launches`` those
at 128, ``paged_decode_q_d64.launches`` those at 64. Both take the split
plan the autotuner pinned for the op ``paged_decode_q``.
"""

from __future__ import annotations

import ctypes

import torch

from gofr_tpu_torch.ops import cuda
from gofr_tpu_torch.ops.cuda.decode_attention import split_scratch
from gofr_tpu_torch.ops.cuda.paged_decode import MAX_GROUP

HEAD_DIMS = (128, 64)

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
# (scripts/torch_kernel_mutants.py). The 64 build, held to the same limits
# at Llama one_b's step (Hq 32, Hkv 4, page 128, the same lengths; 128 rows
# x 16 splits), read 1.5e-3 and 0.47% on an H100 (700 W), split boundaries
# 6e-5 against the split's plain version; its own planted faults, the 128
# build's fragment walk (32 B a quad thread) and a 128-wide row stride,
# moved the outputs by 0.27 / 94% and 0.98 / 160%, and the final sum
# unguarded past column 64 faulted the CUDA context.
MAX_ABS = 5e-3
RMS_REL = 1.2e-2
# the C entry point of each build
ENTRY = {128: "gofr_paged_decode_q", 64: "gofr_paged_decode_q_d64"}
_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]


def launch_quantized(op: str, counted: dict, entries: dict, values_dtype: torch.dtype,
                     per_byte: int, q: torch.Tensor, kq_pool: torch.Tensor,
                     vq_pool: torch.Tensor, ks_pool: torch.Tensor, vs_pool: torch.Tensor,
                     table: torch.Tensor, lengths: torch.Tensor,
                     scale: float | None) -> torch.Tensor:
    """Check the inputs of a quantized-pool decode kernel (rows of D /
    ``per_byte`` bytes, D in ``HEAD_DIMS``; table and lengths int32 and
    contiguous on the card, as ``Llama.decode_step`` converts them once per
    step), launch the C entry point ``entries[D]`` (the split kernel and
    its merge) at the plan pinned for ``op``, and count the launch on
    ``counted[D]``; raise on anything the kernel does not take and on a
    CUDA error."""
    cuda.require(all(t.is_cuda for t in (q, kq_pool, vq_pool, ks_pool, vs_pool)),
                 f"{op} takes tensors on the card")
    n, hq, d = q.shape
    pool, hkv, page, width = kq_pool.shape
    cuda.require(q.dtype == torch.bfloat16 and kq_pool.dtype == vq_pool.dtype == values_dtype
                 and ks_pool.dtype == vs_pool.dtype == torch.bfloat16,
                 f"{op} takes bf16 q and scales and {values_dtype} pools, got q {q.dtype}, "
                 f"pools {kq_pool.dtype}/{vq_pool.dtype}, scales {ks_pool.dtype}/{vs_pool.dtype}")
    cuda.require(d in HEAD_DIMS and width == d // per_byte and vq_pool.shape == kq_pool.shape
                 and ks_pool.shape == vs_pool.shape == (pool, hkv, page),
                 f"{op} takes head_dim 128 or 64 (rows of head_dim / {per_byte} B) and scales "
                 f"[P, Hkv, page], got q {tuple(q.shape)} pool {tuple(kq_pool.shape)} "
                 f"scales {tuple(ks_pool.shape)}")
    cuda.require(hq % hkv == 0 and hq // hkv <= MAX_GROUP,
                 f"{op} takes up to {MAX_GROUP} query heads per KV head, got {hq}/{hkv}")
    cuda.require(all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (kq_pool, vq_pool))
                 and ks_pool.is_contiguous() and vs_pool.is_contiguous(),
                 f"{op} pools must be contiguous and 16-byte aligned")
    cuda.require(table.is_cuda and lengths.is_cuda and table.dtype == lengths.dtype == torch.int32
                 and table.dim() == 2 and table.shape[0] == n and lengths.shape == (n,)
                 and table.is_contiguous() and lengths.is_contiguous(),
                 f"{op} takes an int32 table [N, MaxP] and lengths [N], contiguous on the card")
    scale = scale if scale is not None else d ** -0.5
    q = q.contiguous()
    out = torch.empty_like(q)
    if n == 0:
        return out
    maxp = table.shape[1]
    # the pin's dims end with the pool's kv dtype, as the engine names it
    split_rows, splits, scratch = split_scratch(
        q, hkv, maxp * page, op,
        (n, hq, hkv, d, page, maxp, pool, "int8" if per_byte == 1 else "int4"))
    fn = cuda.bind(entries[d], _ARGTYPES)
    rc = fn(q.data_ptr(), kq_pool.data_ptr(), vq_pool.data_ptr(), ks_pool.data_ptr(),
            vs_pool.data_ptr(), table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), n, hkv, hq // hkv, pool, page, maxp, split_rows, splits, scale,
            cuda.stream_of(q))
    cuda.check(rc, counted[d].__name__)
    counted[d].launches += 1
    return out


def paged_decode_q(q: torch.Tensor, kq_pool: torch.Tensor, vq_pool: torch.Tensor,
                   ks_pool: torch.Tensor, vs_pool: torch.Tensor, table: torch.Tensor,
                   lengths: torch.Tensor, *, scale: float | None = None) -> torch.Tensor:
    """q [N, Hq, D] bf16 against int8 pool layer slices [P, Hkv, page, D]
    with bf16 scales [P, Hkv, page], through the block table [N, MaxP]
    (OOB entries == P), masked by lengths [N] → [N, Hq, D]. D is 128 or
    64. Launches the kernel, or raises."""
    return launch_quantized("paged_decode_q", _COUNTED, ENTRY, torch.int8, 1,
                            q, kq_pool, vq_pool, ks_pool, vs_pool, table, lengths, scale)


def paged_decode_q_d64(q: torch.Tensor, kq_pool: torch.Tensor, vq_pool: torch.Tensor,
                       ks_pool: torch.Tensor, vs_pool: torch.Tensor, table: torch.Tensor,
                       lengths: torch.Tensor, **kw) -> torch.Tensor:
    """Kernel D's head-dim-64 build under its own name: ``paged_decode_q``
    on q and pools of head dim 64 (any other raises)."""
    cuda.require(q.shape[-1] == 64, f"paged_decode_q_d64 takes head_dim 64, got {q.shape[-1]}")
    return paged_decode_q(q, kq_pool, vq_pool, ks_pool, vs_pool, table, lengths, **kw)


paged_decode_q.launches = 0
paged_decode_q_d64.launches = 0
_COUNTED = {128: paged_decode_q, 64: paged_decode_q_d64}
