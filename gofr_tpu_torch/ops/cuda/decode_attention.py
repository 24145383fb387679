"""Kernel F: decode attention over the bf16 slot cache.

Replaces gofr_tpu/ops/pallas/decode_attention.py ``decode_attention``
(:85). The CUDA source is ``csrc/paged_decode.cu``, the kernel template of
kernel A with the slot cache's row addressing (``SlotRows``); its header
note says what bounds it (device-memory bytes) and how the design answers
that. Its plain version is ``ops.attention.decode_attention_plain``;
``ops.attention.decode_attention`` chooses between the two by the tensor's
device.
"""

from __future__ import annotations

import ctypes

import torch

from gofr_tpu_torch.ops import cuda
from gofr_tpu_torch.ops.cuda.paged_decode import HEAD_DIM, MAX_GROUP

# Agreement with the plain version on the same bf16 inputs. The arithmetic
# is kernel A's (the same template), and so is the plain version's, so the
# two differ as A and its plain version do: by a few bf16 ulps, the plain
# version rounding the scores to bf16 where the kernel keeps them in f32.
# On an H100 (700 W) at the slice's shapes (8 live slots of 699..1591, an
# empty slot, Smax 2176) the clean kernel is off by at most 1.95e-3 and
# 0.53% of the output's RMS, and by 7.3e-4 / 0.52% on a lane past the
# slot. The nearest planted fault, a length not clamped to Smax, reads
# 7.9e-3 / 3.6% on that lane; a key past the length or the last key
# dropped reads 3.3 / 687% and 0.033 / 3.1% (scripts/torch_kernel_mutants.py).
# Limits: those of A, 5e-3 on any element and 1.2% on the RMS ratio.
MAX_ABS = 5e-3
RMS_REL = 1.2e-2
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     lengths: torch.Tensor, *, scale: float | None = None) -> torch.Tensor:
    """q [B, Hq, D] against slot-cache layer slices [B, Hkv, Smax, D],
    attending to positions < lengths[b] (clamped to [0, Smax]) →
    [B, Hq, D]. Launches the kernel, or raises."""
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
    cuda.require(lengths.shape == (b,), "decode_attention lengths must have B rows")
    scale = scale if scale is not None else d ** -0.5
    q = q.contiguous()
    lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    if b == 0:
        return out
    fn = cuda.bind("gofr_decode_attention", _ARGTYPES)
    rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), b, hkv, hq // hkv, smax, scale, cuda.stream_of(q))
    cuda.check(rc, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
