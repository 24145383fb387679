"""Kernel C: flash (blocked online-softmax) prefill attention.

Replaces gofr_tpu/ops/pallas/flash_attention.py ``flash_attention`` (:108).
The CUDA source is ``csrc/flash_attention.cu`` (tensor cores, ``mma.sync``)
with the recurrence shared with the decode kernels in
``csrc/online_softmax.cuh``; the header note says what bounds it (bytes at
4 x 512, operations at 4 x 1024) and how the design answers that. Its plain version
is ``ops.attention.mha_attention_plain``; ``ops.attention.mha_attention``
chooses between the two by the tensor's device.

The kernel is one template instantiated at head dim 128 (Llama) and 64
(BERT-base, ViT-L/16, GPT-2); ``flash_attention`` takes either and any
other raises. Each instantiation counts its launches under its own name:
``flash_attention.launches`` those at 128, ``flash_attention_d64.launches``
those at 64 (``cuda.launch_counts()`` lists them apart).
"""

from __future__ import annotations

import ctypes

import torch

from gofr_tpu_torch.ops import cuda

HEAD_DIMS = (128, 64)
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
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: torch.Tensor | int = 0,
                    kv_lengths: torch.Tensor | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """q [B, Sq, Hq, D]; k, v [B, Skv, Hkv, D] → [B, Sq, Hq, D], causal with a
    per-batch ``q_offset``, keys masked by ``kv_lengths`` [B]; fully masked
    rows give zeros. D is 128 or 64. Launches the kernel, or raises."""
    cuda.require(q.is_cuda and k.is_cuda and v.is_cuda, "flash_attention takes tensors on the card")
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    cuda.require(q.dtype == k.dtype == v.dtype == torch.bfloat16,
                 f"flash_attention takes bf16 q/k/v, got {q.dtype}/{k.dtype}/{v.dtype}")
    cuda.require(d in HEAD_DIMS and k.shape == v.shape == (b, skv, hkv, d),
                 f"flash_attention takes head_dim 128 or 64, got q {tuple(q.shape)} "
                 f"k {tuple(k.shape)}")
    cuda.require(hq % hkv == 0, f"query heads {hq} not divisible by kv heads {hkv}")
    scale = scale if scale is not None else d ** -0.5
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
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
    fn = cuda.bind("gofr_flash_attention", _ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), offsets.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), b, sq, skv, hq, hkv, d, int(causal), scale, cuda.stream_of(q))
    cuda.check(rc, "flash_attention")
    _COUNTED[d].launches += 1
    # chunked prefill passes its offsets as a tensor, whole prompts as 0
    flash_attention.offset_launches += not isinstance(q_offset, int)
    return out


def flash_attention_d64(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        **kw) -> torch.Tensor:
    """Kernel C's head-dim-64 instantiation under its own name:
    ``flash_attention`` on q/k/v of head dim 64 (any other raises)."""
    cuda.require(q.shape[-1] == 64, f"flash_attention_d64 takes head_dim 64, got {q.shape[-1]}")
    return flash_attention(q, k, v, **kw)


flash_attention.launches = 0
flash_attention.offset_launches = 0  # of all launches, those with per-row offsets
flash_attention_d64.launches = 0
_COUNTED = {128: flash_attention, 64: flash_attention_d64}
