"""Kernel A: decode attention over the bf16 paged pool.

Replaces gofr_tpu/ops/pallas/paged_decode.py ``paged_decode_attention``
(:94). The CUDA source is ``csrc/paged_decode.cu``; its header note says
what bounds it (device-memory bytes) and how the design answers that.
Its plain version is ``ops.attention.paged_decode_attention_plain`` (gather,
then dense decode); ``ops.attention.paged_decode_attention`` chooses
between the two by the tensor's device.
"""

from __future__ import annotations

import ctypes

import torch

from gofr_tpu_torch.ops import cuda

HEAD_DIM = 128
# Agreement with the plain version on the same bf16 inputs. The plain
# version rounds the scores to bf16 where the kernel keeps them in f32, and
# each rounds its output to bf16, so they differ by a few bf16 ulps: at the
# slice's shapes (live lengths 699..1591) at most 1.2e-3 on outputs of RMS
# 0.05, and an RMS difference of 0.48% of the output's RMS. Limits: 5e-3 on
# any element and 1.2% on the RMS. A planted fault (one key past or short
# of the length, a live page skipped, a key left out of P.V) moved the
# outputs by 0.020..0.23 and 3.0%..41% (scripts/torch_kernel_mutants.py).
MAX_ABS = 5e-3
RMS_REL = 1.2e-2
MAX_GROUP = 8
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]


def paged_decode(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                 table: torch.Tensor, lengths: torch.Tensor, *,
                 scale: float | None = None) -> torch.Tensor:
    """q [N, Hq, D] against pool layer slices [P, Hkv, page, D] through the
    block table [N, MaxP] (OOB entries == P), masked by lengths [N] →
    [N, Hq, D]. Launches the kernel, or raises."""
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
    cuda.require(k_pool.is_contiguous() and v_pool.is_contiguous(), "paged_decode pools must be contiguous")
    cuda.require(table.shape[0] == n and lengths.shape == (n,), "paged_decode table/lengths must have N rows")
    scale = scale if scale is not None else d ** -0.5
    q = q.contiguous()
    table = table.to(device=q.device, dtype=torch.int32).contiguous()
    lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    if n == 0:
        return out
    fn = cuda.bind("gofr_paged_decode", _ARGTYPES)
    rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), table.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), n, hkv, hq // hkv, pool, page,
            table.shape[1], scale, cuda.stream_of(q))
    cuda.check(rc, "paged_decode")
    paged_decode.launches += 1
    return out


paged_decode.launches = 0
