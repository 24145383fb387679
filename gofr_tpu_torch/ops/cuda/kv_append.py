"""The per-step KV appends, in place: kernel B into the paged pool and
kernel G into the slot cache.

B replaces gofr_tpu/ops/pallas/kv_append.py ``append_tokens_paged_inplace``
(:110), G ``append_tokens_inplace`` (:61). The CUDA source of both is
``csrc/kv_append.cu``; its header note says what bounds them and why they
need no reserved sink page. Their plain versions are
``ops.paged.append_tokens_paged_plain`` and ``ops.kvcache.
append_tokens_plain``; ``ops.paged.append_tokens_paged`` and
``ops.kvcache.append_tokens`` choose by the tensor's device. Limit against
the plain versions: bit-exact, since each kernel copies 16-bit patterns.
"""

from __future__ import annotations

import ctypes

import torch

from gofr_tpu_torch.ops import cuda

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_SLOT_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


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


def kv_append_slot(k_layer: torch.Tensor, v_layer: torch.Tensor, positions: torch.Tensor,
                   k_new: torch.Tensor, v_new: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Write k_new/v_new [N, Hkv, D] into slot-cache layer slices
    [N, Hkv, Smax, D] at ``positions`` [N], in place, dropping a position
    outside [0, Smax), and return the slices. Launches the kernel, or
    raises."""
    cuda.require(k_layer.is_cuda and v_layer.is_cuda, "kv_append_slot takes caches on the card")
    n, hkv, smax, d = k_layer.shape
    cuda.require(v_layer.shape == k_layer.shape and v_layer.dtype == k_layer.dtype,
                 "kv_append_slot: k and v caches differ")
    cuda.require(k_layer.element_size() == 2,
                 f"kv_append_slot takes a 16-bit cache, got {k_layer.dtype}")
    cuda.require(k_layer.is_contiguous() and v_layer.is_contiguous(),
                 "kv_append_slot caches must be contiguous")
    cuda.require(k_new.shape == (n, hkv, d) and v_new.shape == (n, hkv, d),
                 f"kv_append_slot rows must be [{n}, {hkv}, {d}], got {tuple(k_new.shape)}")
    cuda.require(positions.shape == (n,), "kv_append_slot positions must have N rows")
    if n == 0:
        return k_layer, v_layer
    k_new = k_new.to(k_layer.dtype).contiguous()
    v_new = v_new.to(k_layer.dtype).contiguous()
    positions = positions.to(device=k_layer.device, dtype=torch.int32).contiguous()
    fn = cuda.bind("gofr_kv_append_slot", _SLOT_ARGTYPES)
    rc = fn(k_layer.data_ptr(), v_layer.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            positions.data_ptr(), n, hkv, smax, d, cuda.stream_of(k_layer))
    cuda.check(rc, "kv_append_slot")
    kv_append_slot.launches += 1
    return k_layer, v_layer


kv_append_slot.launches = 0
