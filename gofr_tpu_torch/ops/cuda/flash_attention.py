"""Kernel C: flash (blocked online-softmax) prefill attention.

Replaces gofr_tpu/ops/pallas/flash_attention.py ``flash_attention`` (:108).
The bf16 build is ``csrc/flash_attention.cu`` (tensor cores, ``mma.sync``),
the f32 build ``csrc/flash_attention_f32.cu`` (3xTF32 on ``wgmma`` fed by
TMA, a producer warpgroup that splits and transposes the tiles, P
unrounded), both with the recurrence shared with the decode kernels in
``csrc/online_softmax.cuh``; each header note says what bounds it and how
the design answers that. Its plain version is
``ops.attention.mha_attention_plain``; ``ops.attention.mha_attention``
chooses between the two by the tensor's device.

Each build is instantiated at head dim 128 (Llama) and 64 (BERT-base,
ViT-L/16, GPT-2); ``flash_attention`` takes any of the four and any other
head dim or type raises. Each build counts its launches
under its own name: ``flash_attention`` (128, bf16),
``flash_attention_d64`` (64, bf16), ``flash_attention_f32`` (128, f32)
and ``flash_attention_d64_f32`` (``cuda.launch_counts()`` lists them
apart).
"""

from __future__ import annotations

import ctypes

import torch

from gofr_tpu_torch.ops import cuda

HEAD_DIMS = (128, 64)
DTYPES = (torch.bfloat16, torch.float32)
# Agreement with the plain version on the same bf16 inputs. The two differ
# by where they round to bf16 (the kernel's P is rounded to bf16 for the
# tensor cores as the plain version's probabilities are, but its scores stay
# f32); a row that attends to few keys has outputs of a few units, so the
# largest difference is one bf16 ulp of such a value (2^-6). On an H100
# (700 W) the tensor-core kernel read 0.0156 and 0.39..0.43% of the
# output's RMS at every phase-3 case (4 x 512 and 4 x 1024 causal, full and
# ragged with offsets, a chunk of 200 queries after offsets). Limits: 3e-2
# on any element and 1.2% on the RMS. The nearest planted fault, one key
# past kv_length, read 0.77 / 6.3%; O's rescale skipped 2.6 / 36%, a k16
# half dropped from P.V 2.3 / 41%, the causal diagonal masked 4.8 / 44%
# (scripts/torch_kernel_mutants.py). The 64 build is held to the same
# limits (its rows sum half the products, so its error is no larger).
MAX_ABS = 3e-2
RMS_REL = 1.2e-2
# The f32 build against the f32 plain version on the same f32 inputs: the
# 3xTF32 products leave out only lo * lo (under 2^-20 of a product) and P
# is not rounded, so the two differ by about 1e-6 of the output's scale
# (tests/test_torch_flash_f32_tiles.py emulates the body's tiles, split and
# key order against the Pallas kernel). Limits: 1e-4 on any element, the
# f32 parity contract (the CPU tests hold the plain version to the Pallas
# kernel at 1e-5), and 2e-5 on the RMS ratio. One pass of TF32 (the lo terms
# dropped) moves scores of order 10 by 1e-2, an output by ~1e-3.
F32 = cuda.Limits(MAX_ABS=1e-4, RMS_REL=2e-5)
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
_SHARED_ARGTYPES = [ctypes.c_int]
# the C entry point of each build, by (head dim, type)
ENTRY = {(128, torch.bfloat16): "gofr_flash_attention", (64, torch.bfloat16): "gofr_flash_attention",
         (128, torch.float32): "gofr_flash_attention_f32",
         (64, torch.float32): "gofr_flash_attention_d64_f32"}


def shared_bytes(d: int) -> int:
    """Dynamic shared memory a block of the f32 build at head dim ``d``
    takes (its source's layout; 0 for another d)."""
    return cuda.bind("gofr_flash_attention_f32_shared_bytes", _SHARED_ARGTYPES)(d)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: torch.Tensor | int = 0,
                    kv_lengths: torch.Tensor | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """q [B, Sq, Hq, D]; k, v [B, Skv, Hkv, D] → [B, Sq, Hq, D], causal with a
    per-batch ``q_offset``, keys masked by ``kv_lengths`` [B]; fully masked
    rows give zeros. D is 128 or 64; q/k/v are all bf16 or all f32, and the
    output is in their type. Launches the kernel, or raises."""
    cuda.require(q.is_cuda and k.is_cuda and v.is_cuda, "flash_attention takes tensors on the card")
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    cuda.require(q.dtype == k.dtype == v.dtype and q.dtype in DTYPES,
                 f"flash_attention takes bf16 or f32 q/k/v of one type, got "
                 f"{q.dtype}/{k.dtype}/{v.dtype}")
    cuda.require(d in HEAD_DIMS and k.shape == v.shape == (b, skv, hkv, d),
                 f"flash_attention takes head_dim 128 or 64, got q {tuple(q.shape)} "
                 f"k {tuple(k.shape)}")
    cuda.require(hq % hkv == 0, f"query heads {hq} not divisible by kv heads {hkv}")
    scale = scale if scale is not None else d ** -0.5
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if q.dtype == torch.float32:  # the f32 build's TMA maps take 16-byte aligned tensors
        q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    # a Python offset is filled in on the card: copying it from the host
    # would synchronise the stream on every call (every prefill layer)
    offsets = (torch.full((b,), int(q_offset), dtype=torch.int32, device=q.device)
               if isinstance(q_offset, int) else
               q_offset.to(device=q.device, dtype=torch.int32).expand(b).contiguous())
    lengths = (torch.full((b,), skv, dtype=torch.int32, device=q.device) if kv_lengths is None
               else kv_lengths.to(device=q.device, dtype=torch.int32).contiguous())
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    build = d, q.dtype
    fn = cuda.bind(ENTRY[build], _ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), offsets.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), b, sq, skv, hq, hkv, d, int(causal), scale, cuda.stream_of(q))
    cuda.check(rc, "flash_attention")
    _COUNTED[build].launches += 1
    # chunked prefill passes its offsets as a tensor, whole prompts as 0
    flash_attention.offset_launches += not isinstance(q_offset, int)
    return out


def flash_attention_d64(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        **kw) -> torch.Tensor:
    """Kernel C's head-dim-64 instantiation under its own name:
    ``flash_attention`` on q/k/v of head dim 64 (any other raises)."""
    cuda.require(q.shape[-1] == 64, f"flash_attention_d64 takes head_dim 64, got {q.shape[-1]}")
    return flash_attention(q, k, v, **kw)


def flash_attention_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        **kw) -> torch.Tensor:
    """Kernel C's f32 build under its own name: ``flash_attention`` on f32
    q/k/v (any other type raises); counted by head dim as
    ``flash_attention_f32`` (128) or ``flash_attention_d64_f32``."""
    cuda.require(q.dtype == torch.float32, f"flash_attention_f32 takes f32 q, got {q.dtype}")
    return flash_attention(q, k, v, **kw)


def flash_attention_d64_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            **kw) -> torch.Tensor:
    """Kernel C's f32 build at head dim 64 under its own name (any other
    type or head dim raises)."""
    cuda.require(q.shape[-1] == 64, f"flash_attention_d64_f32 takes head_dim 64, got {q.shape[-1]}")
    return flash_attention_f32(q, k, v, **kw)


flash_attention.launches = 0
flash_attention.offset_launches = 0  # of all launches, those with per-row offsets
flash_attention_d64.launches = 0
flash_attention_f32.launches = 0
flash_attention_d64_f32.launches = 0
_COUNTED = {(128, torch.bfloat16): flash_attention, (64, torch.bfloat16): flash_attention_d64,
            (128, torch.float32): flash_attention_f32,
            (64, torch.float32): flash_attention_d64_f32}
