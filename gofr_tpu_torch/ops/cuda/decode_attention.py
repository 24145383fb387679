"""Kernel F: decode attention over the slot cache, bf16 or f32.

Replaces gofr_tpu/ops/pallas/decode_attention.py ``decode_attention``
(:85). The CUDA source is ``csrc/paged_decode.cu``, with the slot cache's
row addressing (``SlotRows``), split over the sequence into
``split_plan``'s runs and merged by a second kernel launched from the same
entry point; its header note says what bounds it (device-memory bytes) and
how the design answers that. Its plain version is
``ops.attention.decode_attention_plain``; ``ops.attention.decode_attention``
chooses between the two by the tensor's device.
``ops.attention.decode_attention_split_plain`` repeats the split and merge
arithmetic in PyTorch for the tests.

The kernel is one template built at head dim 128 (Llama) and 64 (GPT-2),
each on bf16 and on f32 planes (the f32 models: GPT-2 small in its own
dtype); ``decode_attention`` takes any of the four and raises on any other
head dim or type. Each build counts its launches under its own name:
``decode_attention`` (128, bf16), ``decode_attention_d64`` (64, bf16),
``decode_attention_f32`` (128, f32) and ``decode_attention_d64_f32``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from gofr_tpu_torch.ops import autotune, cuda

HEAD_DIMS = (128, 64)
DTYPES = (torch.bfloat16, torch.float32)
MAX_GROUP = 8
# Agreement with the plain version on the same bf16 inputs. The arithmetic
# is kernel A's (paged_decode_q.cu), and so is the plain version's, so the
# two differ as A and its plain version do: by a few bf16 ulps, the plain
# version rounding the scores to bf16 where the kernel keeps them in f32.
# The split changes only the order of the f32 sums (each run's
# probabilities are taken against its own max, then rescaled in the merge).
# On an H100 (700 W) at the slice's shapes (8 live slots of 699..1591, an
# empty slot, Smax 2176; 192 rows x 12 splits) the split kernel was off by
# 1.95e-3 and 0.49% of the output's RMS, 7.3e-4 / 0.52% on a lane past the
# slot, and 1.95e-3 / 0.20% on lanes on and one past split boundaries
# (against the split's plain version). The nearest planted fault, a length
# not clamped to Smax, read 8.0e-3 / 3.6% on the lane past the slot; split
# boundaries overlapping by one row 0.058 / 6.6%, the last split left out
# of the merge 0.14 / 34% (scripts/torch_kernel_mutants.py). Limits: those
# of A, 5e-3 on any element and 1.2% on the RMS ratio. The 64 build, held to
# the same limits, read 1.95e-3 and 0.49% at GPT-2's step (8 live slots of
# 297..908 and an empty one, Hq = Hkv 12, Smax 1024; 128 rows x 8 splits),
# the nearest planted fault, the last live key dropped, 0.031 / 3.3%, split
# boundaries overlapping by one row 0.042 / 6.9%, and its own faults, half
# of each output row never summed and a 128-wide row stride, 0.42 / 71% and
# 0.69 / 140% (the same H100, scripts/torch_kernel_mutants.py).
MAX_ABS = 5e-3
RMS_REL = 1.2e-2
# The f32 builds against the f32 plain version: both take scores and P.V
# in f32 with P unrounded (the TPU kernel casts P to v.dtype), so they
# differ by the order of f32 sums alone, a few ulps of an output of order
# 1. Limits: 1e-4 on any element (the f32 parity contract of the CPU
# tests' 1e-5, loosened for sums of up to 2176 terms in another order) and
# 2e-5 on the RMS ratio. A P rounded to bf16 moves a lane of a few hundred
# keys by ~1e-4 (scripts/torch_kernel_mutants.py).
F32 = cuda.Limits(MAX_ABS=1e-4, RMS_REL=2e-5)
TILE = 64
# Blocks the split aims at over the whole (slot, KV head, split) grid:
# about 8 per SM of an H100's 132. Three fit on an SM at once (70 KB of
# shared memory each), and at the engine's lengths about half of them find
# no live row and exit at once.
SPLIT_BLOCKS = 1024
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
# the C entry point of each build, by (head dim, type)
ENTRY = {(128, torch.bfloat16): "gofr_decode_attention",
         (64, torch.bfloat16): "gofr_decode_attention_d64",
         (128, torch.float32): "gofr_decode_attention_f32",
         (64, torch.float32): "gofr_decode_attention_d64_f32"}


def split_plan(n: int, hkv: int, smax: int) -> tuple[int, int]:
    """(split_rows, splits) for ``n`` slots of ``hkv`` KV heads and ``smax``
    positions: runs of a whole number of 64-row tiles, as many per (slot,
    head) as bring the grid to about ``SPLIT_BLOCKS`` blocks, and enough of
    them to cover the slot. A function of the shapes alone: the lengths live
    on the card, and reading them here would stall the host every layer."""
    tiles = max(1, math.ceil(smax / TILE))
    per_lane = max(1, math.ceil(SPLIT_BLOCKS / max(1, n * hkv)))
    split_rows = TILE * math.ceil(tiles / per_lane)
    return split_rows, max(1, math.ceil(smax / split_rows))


def split_candidates(n: int, hkv: int, smax: int) -> list[int]:
    """The ``split_rows`` the warmup autotuner races (``ops/autotune.py``):
    ``split_plan``'s first, so that it wins a tie, then a half, twice and
    four times it and one split over the whole slot, each a whole number of
    64-row tiles, at least one tile and at most the whole slot, without
    repeats."""
    rows = split_plan(n, hkv, smax)[0]
    whole = TILE * max(1, math.ceil(smax / TILE))
    out: list[int] = []
    for r in (rows, rows // 2, rows * 2, rows * 4, whole):
        r = min(whole, max(TILE, r // TILE * TILE))
        if r not in out:
            out.append(r)
    return out


def split_scratch(q: torch.Tensor, hkv: int, smax: int, op: str | None = None,
                  dims: tuple = ()) -> tuple[int, int, torch.Tensor]:
    """(split_rows, splits) for ``q``'s N lanes of ``hkv`` KV heads over
    ``smax`` positions, and the f32 scratch of each split's (acc[D], m, l)
    per query row, [N, Hq, splits, D + 2], that only the merge reads (empty
    with one split). The rows are the plan the autotuner pinned for ``op``
    when the launch's ``dims`` (the tuner's shape key, then the cache's
    dtype name, ``autotune.pin_dims``) are the ones it was measured at,
    else ``split_plan``'s. Shared by the split decode launchers (kernels A,
    D, E and F)."""
    n, hq, d = q.shape
    split_rows = autotune.pinned_plan(op, dims) if op else None
    if split_rows is None:
        split_rows, splits = split_plan(n, hkv, smax)
    else:
        splits = max(1, math.ceil(smax / split_rows))
    scratch = torch.empty(n * hq * splits * (d + 2) if splits > 1 else 0, dtype=torch.float32,
                          device=q.device)
    return split_rows, splits, scratch


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     lengths: torch.Tensor, *, scale: float | None = None) -> torch.Tensor:
    """q [B, Hq, D] against slot-cache layer slices [B, Hkv, Smax, D],
    attending to positions < lengths[b] (clamped to [0, Smax]) →
    [B, Hq, D] in q's type. D is 128 or 64; q and the caches are all bf16
    or all f32. ``lengths`` is int32 and contiguous on the card (the
    models' ``decode_step`` converts it once per step). Launches the kernel
    (and its merge), or raises."""
    cuda.require(q.is_cuda and k_cache.is_cuda and v_cache.is_cuda,
                 "decode_attention takes tensors on the card")
    b, hq, d = q.shape
    _, hkv, smax, _ = k_cache.shape
    cuda.require(q.dtype == k_cache.dtype == v_cache.dtype and q.dtype in DTYPES,
                 f"decode_attention takes bf16 or f32 q and caches of one type, got "
                 f"{q.dtype}/{k_cache.dtype}/{v_cache.dtype}")
    cuda.require(d in HEAD_DIMS and k_cache.shape == (b, hkv, smax, d) and v_cache.shape == k_cache.shape,
                 f"decode_attention takes head_dim 128 or 64 and one cache row per query row, "
                 f"got q {tuple(q.shape)} cache {tuple(k_cache.shape)}")
    cuda.require(hq % hkv == 0 and hq // hkv <= MAX_GROUP,
                 f"decode_attention takes up to {MAX_GROUP} query heads per KV head, got {hq}/{hkv}")
    cuda.require(k_cache.is_contiguous() and v_cache.is_contiguous(),
                 "decode_attention caches must be contiguous")
    cuda.require(lengths.is_cuda and lengths.dtype == torch.int32 and lengths.shape == (b,)
                 and lengths.is_contiguous(),
                 "decode_attention takes int32 lengths [B], contiguous on the card")
    scale = scale if scale is not None else d ** -0.5
    q = q.contiguous()
    out = torch.empty_like(q)
    if b == 0:
        return out
    build = d, q.dtype
    split_rows, splits, scratch = split_scratch(
        q, hkv, smax, "decode", (b, hq, hkv, d, smax, autotune.dtype_name(q.dtype)))
    fn = cuda.bind(ENTRY[build], _ARGTYPES)
    rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), b, hkv, hq // hkv, smax, split_rows, splits, scale,
            cuda.stream_of(q))
    cuda.check(rc, "decode_attention")
    _COUNTED[build].launches += 1
    return out


def decode_attention_d64(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                         lengths: torch.Tensor, **kw) -> torch.Tensor:
    """Kernel F's head-dim-64 build under its own name: ``decode_attention``
    on q and caches of head dim 64 (any other raises)."""
    cuda.require(q.shape[-1] == 64, f"decode_attention_d64 takes head_dim 64, got {q.shape[-1]}")
    return decode_attention(q, k_cache, v_cache, lengths, **kw)


def decode_attention_f32(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                         lengths: torch.Tensor, **kw) -> torch.Tensor:
    """Kernel F's f32 build under its own name: ``decode_attention`` on f32
    q and caches (any other type raises); counted by head dim as
    ``decode_attention_f32`` (128) or ``decode_attention_d64_f32``."""
    cuda.require(q.dtype == torch.float32, f"decode_attention_f32 takes f32 q, got {q.dtype}")
    return decode_attention(q, k_cache, v_cache, lengths, **kw)


def decode_attention_d64_f32(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                             lengths: torch.Tensor, **kw) -> torch.Tensor:
    """Kernel F's f32 build at head dim 64 under its own name (any other
    type or head dim raises)."""
    cuda.require(q.shape[-1] == 64, f"decode_attention_d64_f32 takes head_dim 64, got {q.shape[-1]}")
    return decode_attention_f32(q, k_cache, v_cache, lengths, **kw)


decode_attention.launches = 0
decode_attention_d64.launches = 0
decode_attention_f32.launches = 0
decode_attention_d64_f32.launches = 0
_COUNTED = {(128, torch.bfloat16): decode_attention, (64, torch.bfloat16): decode_attention_d64,
            (128, torch.float32): decode_attention_f32,
            (64, torch.float32): decode_attention_d64_f32}
