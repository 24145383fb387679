"""Kernel F: decode attention over the bf16 slot cache.

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
"""

from __future__ import annotations

import ctypes
import math

import torch

from gofr_tpu_torch.ops import cuda

HEAD_DIM = 128
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
# of A, 5e-3 on any element and 1.2% on the RMS ratio.
MAX_ABS = 5e-3
RMS_REL = 1.2e-2
TILE = 64
# Blocks the split aims at over the whole (slot, KV head, split) grid:
# about 8 per SM of an H100's 132. Three fit on an SM at once (70 KB of
# shared memory each), and at the engine's lengths about half of them find
# no live row and exit at once.
SPLIT_BLOCKS = 1024
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]


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


def split_scratch(q: torch.Tensor, hkv: int, smax: int) -> tuple[int, int, torch.Tensor]:
    """``split_plan``'s (split_rows, splits) for ``q``'s N lanes of ``hkv``
    KV heads over ``smax`` positions, and the f32 scratch of each split's
    (acc[D], m, l) per query row, [N, Hq, splits, D + 2], that only the
    merge reads (empty with one split). Shared by the split decode
    launchers (kernels A, D, E and F)."""
    n, hq, d = q.shape
    split_rows, splits = split_plan(n, hkv, smax)
    scratch = torch.empty(n * hq * splits * (d + 2) if splits > 1 else 0, dtype=torch.float32,
                          device=q.device)
    return split_rows, splits, scratch


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     lengths: torch.Tensor, *, scale: float | None = None) -> torch.Tensor:
    """q [B, Hq, D] against slot-cache layer slices [B, Hkv, Smax, D],
    attending to positions < lengths[b] (clamped to [0, Smax]) →
    [B, Hq, D]. ``lengths`` is int32 and contiguous on the card
    (``Llama.decode_step`` converts it once per step). Launches the kernel
    (and its merge), or raises."""
    cuda.require(q.is_cuda and k_cache.is_cuda and v_cache.is_cuda,
                 "decode_attention takes tensors on the card")
    b, hq, d = q.shape
    _, hkv, smax, _ = k_cache.shape
    cuda.require(q.dtype == k_cache.dtype == v_cache.dtype == torch.bfloat16,
                 f"decode_attention takes bf16 q and caches, got "
                 f"{q.dtype}/{k_cache.dtype}/{v_cache.dtype}")
    cuda.require(d == HEAD_DIM and k_cache.shape == (b, hkv, smax, d) and v_cache.shape == k_cache.shape,
                 f"decode_attention takes head_dim {HEAD_DIM} and one cache row per query row, "
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
    split_rows, splits, scratch = split_scratch(q, hkv, smax)
    fn = cuda.bind("gofr_decode_attention", _ARGTYPES)
    rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), b, hkv, hq // hkv, smax, split_rows, splits, scale,
            cuda.stream_of(q))
    cuda.check(rc, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
