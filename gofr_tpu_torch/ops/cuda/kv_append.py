"""Kernel B: the per-step KV append into the paged pool, in place.

Replaces gofr_tpu/ops/pallas/kv_append.py ``append_tokens_paged_inplace``
(:110). The CUDA source is ``csrc/kv_append.cu``; its header note says what
bounds it and why the kernel needs no reserved sink page. Its plain
version is ``ops.paged.append_tokens_paged_plain``, and the two agree bit
for bit; ``ops.paged.append_tokens_paged`` chooses between them by the
tensor's device.
"""

from __future__ import annotations

import ctypes

import torch

from gofr_tpu_torch.ops import cuda

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def kv_append(k_layer: torch.Tensor, v_layer: torch.Tensor, table: torch.Tensor,
              positions: torch.Tensor, k_new: torch.Tensor,
              v_new: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Write k_new/v_new [N, Hkv, D] into the layer slices [P, Hkv, page, D]
    at each slot's position, in place, and return the slices. Launches the
    kernel, or raises."""
    cuda.require(k_layer.is_cuda and v_layer.is_cuda, "kv_append takes pools on the card")
    pool, hkv, page, d = k_layer.shape
    n = k_new.shape[0]
    cuda.require(v_layer.shape == k_layer.shape and v_layer.dtype == k_layer.dtype,
                 "kv_append: k and v pools differ")
    cuda.require(k_layer.element_size() == 2, f"kv_append takes a 16-bit pool, got {k_layer.dtype}")
    cuda.require(k_layer.is_contiguous() and v_layer.is_contiguous(), "kv_append pools must be contiguous")
    cuda.require(k_new.shape == (n, hkv, d) and v_new.shape == (n, hkv, d),
                 f"kv_append rows must be [N, {hkv}, {d}], got {tuple(k_new.shape)}")
    cuda.require(table.shape[0] == n and positions.shape == (n,), "kv_append table/positions must have N rows")
    if n == 0:
        return k_layer, v_layer
    k_new = k_new.to(k_layer.dtype).contiguous()
    v_new = v_new.to(k_layer.dtype).contiguous()
    table = table.to(device=k_layer.device, dtype=torch.int32).contiguous()
    positions = positions.to(device=k_layer.device, dtype=torch.int32).contiguous()
    fn = cuda.bind("gofr_kv_append", _ARGTYPES)
    rc = fn(k_layer.data_ptr(), v_layer.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            table.data_ptr(), positions.data_ptr(), n, table.shape[1], pool, hkv, page, d,
            cuda.stream_of(k_layer))
    cuda.check(rc, "kv_append")
    kv_append.launches += 1
    return k_layer, v_layer


kv_append.launches = 0
