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
``one_b``); ``paged_decode_q`` takes either and any other raises. The query
is bf16, or f32 under an f32 model (entry points ``gofr_paged_decode_q_f32``
and ``gofr_paged_decode_q_d64_f32``: the f32 q split into three bf16 pieces
whose products with the int8 K are summed in f32, f32 out). Each build
counts its launches under its own name: ``paged_decode_q`` (128, bf16 q),
``paged_decode_q_d64`` (64), ``paged_decode_q_f32`` (128, f32 q) and
``paged_decode_q_d64_f32``. All take the split plan the autotuner pinned
for the op ``paged_decode_q`` at their own pool and query dtype
(``int8/bfloat16``, ``int8/float32``: ``pin_dtype``), so a plan tuned on
one build never steers the other.
"""

from __future__ import annotations

import ctypes

import torch

from gofr_tpu_torch.ops import autotune, cuda
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
# The f32-q builds against the f32 plain version (q.k in f32 on the int8
# values, p * vs unrounded): the three-piece split keeps every bit of q and
# each piece's product with an int8 value is exact, so they differ by the
# order of f32 sums alone. On an H100 (700 W) at the slice's shapes the
# 128 build read 6.9e-7 on outputs of RMS 0.05 and 7.1e-7 of the RMS, the
# 64 build at one_b's step 3.6e-7 and 4.6e-7, split edges included.
# Limits, kernel F's f32 ones: 1e-4 on any element and 2e-5 on the RMS
# ratio, absolute limits for pools written from unit-scale rows (rows of
# up to 30, as phase 3's timed quantizing appends leave in their pools,
# scale the outputs and their error with them). The nearest planted fault (scripts/torch_kernel_mutants.py), q rounded to
# bf16 once (the m and l pieces dropped), moved the outputs by 4.9e-4 /
# 1.7e-3 of the RMS (6.4e-4 / 1.7e-3 at 64).
F32 = cuda.Limits(MAX_ABS=1e-4, RMS_REL=2e-5)
# the C entry point of each build, by (head dim, query type)
ENTRY = {(128, torch.bfloat16): "gofr_paged_decode_q", (64, torch.bfloat16): "gofr_paged_decode_q_d64",
         (128, torch.float32): "gofr_paged_decode_q_f32",
         (64, torch.float32): "gofr_paged_decode_q_d64_f32"}
_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]


def pin_dtype(kv_quantize: str, q_dtype: torch.dtype) -> str:
    """The dtype a quantized pool's split plan is pinned and recorded at:
    the pool's format and the query's dtype, ``int8/float32`` (the
    engine's ``_kv_dtype`` names its pool so)."""
    return f"{kv_quantize}/{autotune.dtype_name(q_dtype)}"


def launch_quantized(op: str, counted: dict, entries: dict, values_dtype: torch.dtype,
                     per_byte: int, q: torch.Tensor, kq_pool: torch.Tensor,
                     vq_pool: torch.Tensor, ks_pool: torch.Tensor, vs_pool: torch.Tensor,
                     table: torch.Tensor, lengths: torch.Tensor,
                     scale: float | None) -> torch.Tensor:
    """Check the inputs of a quantized-pool decode kernel (rows of D /
    ``per_byte`` bytes, D in ``HEAD_DIMS``; q of a type ``entries`` builds;
    table and lengths int32 and contiguous on the card, as
    ``Llama.decode_step`` converts them once per step), launch the C entry
    point ``entries[D, q.dtype]`` (the split kernel and its merge) at the
    plan pinned for ``op`` at ``pin_dtype``, and count the launch on
    ``counted[D, q.dtype]``; raise on anything the kernel does not take and
    on a CUDA error."""
    cuda.require(all(t.is_cuda for t in (q, kq_pool, vq_pool, ks_pool, vs_pool)),
                 f"{op} takes tensors on the card")
    n, hq, d = q.shape
    pool, hkv, page, width = kq_pool.shape
    q_types = sorted({dt for _, dt in entries}, key=str)
    cuda.require(q.dtype in q_types,
                 f"{op} takes a {' or '.join(autotune.dtype_name(t) for t in q_types)} q, got "
                 f"{q.dtype}")
    cuda.require(kq_pool.dtype == vq_pool.dtype == values_dtype
                 and ks_pool.dtype == vs_pool.dtype == torch.bfloat16,
                 f"{op} takes bf16 scales and {values_dtype} pools, got "
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
    build = d, q.dtype
    # the pin's dims end with the pool's format and q's dtype, as the engine
    # names them
    split_rows, splits, scratch = split_scratch(
        q, hkv, maxp * page, op,
        (n, hq, hkv, d, page, maxp, pool, pin_dtype("int8" if per_byte == 1 else "int4", q.dtype)))
    fn = cuda.bind(entries[build], _ARGTYPES)
    rc = fn(q.data_ptr(), kq_pool.data_ptr(), vq_pool.data_ptr(), ks_pool.data_ptr(),
            vs_pool.data_ptr(), table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), n, hkv, hq // hkv, pool, page, maxp, split_rows, splits, scale,
            cuda.stream_of(q))
    cuda.check(rc, counted[build].__name__)
    counted[build].launches += 1
    return out


def paged_decode_q(q: torch.Tensor, kq_pool: torch.Tensor, vq_pool: torch.Tensor,
                   ks_pool: torch.Tensor, vs_pool: torch.Tensor, table: torch.Tensor,
                   lengths: torch.Tensor, *, scale: float | None = None) -> torch.Tensor:
    """q [N, Hq, D] bf16 or f32 against int8 pool layer slices
    [P, Hkv, page, D] with bf16 scales [P, Hkv, page], through the block
    table [N, MaxP] (OOB entries == P), masked by lengths [N] → [N, Hq, D]
    in q's type. D is 128 or 64. Launches the kernel, or raises."""
    return launch_quantized("paged_decode_q", _COUNTED, ENTRY, torch.int8, 1,
                            q, kq_pool, vq_pool, ks_pool, vs_pool, table, lengths, scale)


def paged_decode_q_d64(q: torch.Tensor, kq_pool: torch.Tensor, vq_pool: torch.Tensor,
                       ks_pool: torch.Tensor, vs_pool: torch.Tensor, table: torch.Tensor,
                       lengths: torch.Tensor, **kw) -> torch.Tensor:
    """Kernel D's head-dim-64 build under its own name: ``paged_decode_q``
    on q and pools of head dim 64 (any other raises)."""
    cuda.require(q.shape[-1] == 64, f"paged_decode_q_d64 takes head_dim 64, got {q.shape[-1]}")
    return paged_decode_q(q, kq_pool, vq_pool, ks_pool, vs_pool, table, lengths, **kw)


def paged_decode_q_f32(q: torch.Tensor, kq_pool: torch.Tensor, vq_pool: torch.Tensor,
                       ks_pool: torch.Tensor, vs_pool: torch.Tensor, table: torch.Tensor,
                       lengths: torch.Tensor, **kw) -> torch.Tensor:
    """Kernel D's f32-q build under its own name: ``paged_decode_q`` on an
    f32 q (any other type raises); counted by head dim as
    ``paged_decode_q_f32`` (128) or ``paged_decode_q_d64_f32``."""
    cuda.require(q.dtype == torch.float32, f"paged_decode_q_f32 takes an f32 q, got {q.dtype}")
    return paged_decode_q(q, kq_pool, vq_pool, ks_pool, vs_pool, table, lengths, **kw)


def paged_decode_q_d64_f32(q: torch.Tensor, kq_pool: torch.Tensor, vq_pool: torch.Tensor,
                           ks_pool: torch.Tensor, vs_pool: torch.Tensor, table: torch.Tensor,
                           lengths: torch.Tensor, **kw) -> torch.Tensor:
    """Kernel D's f32-q build at head dim 64 under its own name (any other
    type or head dim raises)."""
    cuda.require(q.shape[-1] == 64,
                 f"paged_decode_q_d64_f32 takes head_dim 64, got {q.shape[-1]}")
    return paged_decode_q_f32(q, kq_pool, vq_pool, ks_pool, vs_pool, table, lengths, **kw)


paged_decode_q.launches = 0
paged_decode_q_d64.launches = 0
paged_decode_q_f32.launches = 0
paged_decode_q_d64_f32.launches = 0
_COUNTED = {(128, torch.bfloat16): paged_decode_q, (64, torch.bfloat16): paged_decode_q_d64,
            (128, torch.float32): paged_decode_q_f32, (64, torch.float32): paged_decode_q_d64_f32}
