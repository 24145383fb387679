"""The per-step KV appends, in place, one launch per layer for both planes:
kernel B into the bf16 paged pool, G into the bf16 slot cache, and the
port's own B-q, B-q4 and G-q, which quantize each row (int8, or packed
int4) and append it with its bf16 scale to the int8 pool, the int4 pool
and the int8 slot cache.

B replaces gofr_tpu/ops/pallas/kv_append.py ``append_tokens_paged_inplace``
(:110), G ``append_tokens_inplace`` (:61); the JAX package runs the
quantized appends as XLA (gofr_tpu/ops/paged.py:344, :438, gofr_tpu/ops/
kvcache.py:132). All five are one template in ``csrc/kv_append.cu``, whose
header note says what bounds them (the launch) and why this design.

Their plain versions: ``ops.paged.append_tokens_paged_plain`` (B),
``ops.kvcache.append_tokens_plain`` (G), and per plane
``ops.paged.append_tokens_paged_q`` (B-q), ``append_tokens_paged_q4``
(B-q4) and ``ops.kvcache.append_tokens_q`` (G-q). Limit against them:
bit-exact, values and scales. B and G copy 16-bit patterns; the others
quantize in f32 with IEEE division and round half to even, as the plain
versions do.

The launchers take what the model hands them and convert nothing: rows
[N, Hkv, 128] in the cache's 16-bit type (bf16 for the quantized caches),
``positions`` [N] and ``table`` [N, MaxP] int32 and contiguous on the card
(``Llama.decode_step`` converts both once per step). They validate, launch
and count, with one check each of what the pointers they pass need (on
the card, shapes, types, contiguous); the C entry points refuse rows that
are not 8-byte aligned before they launch.
"""

from __future__ import annotations

import ctypes

import torch

from gofr_tpu_torch.ops import cuda

HEAD_DIM = 128
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_SLOT_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_Q_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_SLOT_Q_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
# what each launcher takes, the message of its one check
_TAKES = "takes contiguous tensors on the card: "
_POOL_INDEX = "int32 table [N, MaxP] and positions [N]"
_B_TAKES = (f"kv_append {_TAKES}two 16-bit pools [P, Hkv, page, 128] of one type, rows "
            f"[N, Hkv, 128] of that type, {_POOL_INDEX}")
_G_TAKES = (f"kv_append_slot {_TAKES}two 16-bit caches [N, Hkv, Smax, 128] of one type, rows "
            "[N, Hkv, 128] of that type, int32 positions [N]")
_BQ_TAKES = (f"kv_append_q {_TAKES}int8 pools [P, Hkv, page, 128] with bf16 scales [P, Hkv, page], "
             f"bf16 rows [N, Hkv, 128], {_POOL_INDEX}")
_BQ4_TAKES = (f"kv_append_q4 {_TAKES}uint8 pools [P, Hkv, page, 64] with bf16 scales [P, Hkv, page], "
              f"bf16 rows [N, Hkv, 128], {_POOL_INDEX}")
_GQ_TAKES = (f"kv_append_slot_q {_TAKES}int8 caches [N, Hkv, Smax, 128] with bf16 scales "
             "[N, Hkv, Smax], bf16 rows [N, Hkv, 128], int32 positions [N]")


def _planes(k_layer: torch.Tensor, v_layer: torch.Tensor, dtype: torch.dtype, row: int) -> bool:
    """K and V layer slices of one shape, rows of ``row`` ``dtype``
    elements, contiguous on the card."""
    return (k_layer.is_cuda and v_layer.is_cuda and k_layer.dtype == v_layer.dtype == dtype
            and k_layer.shape[-1] == row and v_layer.shape == k_layer.shape
            and k_layer.is_contiguous() and v_layer.is_contiguous())


def _scales(k_scale: torch.Tensor, v_scale: torch.Tensor, shape: torch.Size) -> bool:
    """bf16 scale planes of ``shape``, contiguous on the card."""
    return (k_scale.is_cuda and v_scale.is_cuda and k_scale.dtype == v_scale.dtype == torch.bfloat16
            and k_scale.shape == v_scale.shape == shape
            and k_scale.is_contiguous() and v_scale.is_contiguous())


def _rows(k_new: torch.Tensor, v_new: torch.Tensor, n: int, hkv: int, dtype: torch.dtype) -> bool:
    """New rows [N, Hkv, 128] of ``dtype``, contiguous on the card."""
    return (k_new.is_cuda and v_new.is_cuda and k_new.dtype == v_new.dtype == dtype
            and k_new.shape == v_new.shape == (n, hkv, HEAD_DIM)
            and k_new.is_contiguous() and v_new.is_contiguous())


def _slot_index(positions: torch.Tensor, n: int) -> bool:
    """int32 positions [N], contiguous on the card."""
    return (positions.is_cuda and positions.dtype == torch.int32 and positions.shape == (n,)
            and positions.is_contiguous())


def _pool_index(table: torch.Tensor, positions: torch.Tensor, n: int) -> bool:
    """``_slot_index``'s positions and an int32 table [N, MaxP], contiguous
    on the card."""
    return (_slot_index(positions, n) and table.is_cuda and table.dtype == torch.int32
            and table.dim() == 2 and table.shape[0] == n and table.is_contiguous())


def kv_append(k_layer: torch.Tensor, v_layer: torch.Tensor, table: torch.Tensor,
              positions: torch.Tensor, k_new: torch.Tensor,
              v_new: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel B: write k_new/v_new [N, Hkv, D] into the layer slices
    [P, Hkv, page, D] (16-bit) at each slot's position through ``table``
    [N, MaxP], in place, and return the slices. Launches the kernel, or
    raises."""
    pool, hkv, page, d = k_layer.shape
    n = k_new.shape[0]
    cuda.require(_planes(k_layer, v_layer, k_layer.dtype, HEAD_DIM) and k_layer.element_size() == 2
                 and _rows(k_new, v_new, n, hkv, k_layer.dtype) and _pool_index(table, positions, n),
                 _B_TAKES)
    if n == 0:
        return k_layer, v_layer
    fn = cuda.bind("gofr_kv_append", _ARGTYPES)
    cuda.check(fn(k_layer.data_ptr(), v_layer.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
                  table.data_ptr(), positions.data_ptr(), n, table.shape[1], pool, hkv, page, d,
                  cuda.stream_of(k_layer)), "kv_append")
    kv_append.launches += 1
    return k_layer, v_layer


kv_append.launches = 0


def kv_append_slot(k_layer: torch.Tensor, v_layer: torch.Tensor, positions: torch.Tensor,
                   k_new: torch.Tensor, v_new: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel G: write k_new/v_new [N, Hkv, D] into slot-cache layer slices
    [N, Hkv, Smax, D] (16-bit) at ``positions`` [N], in place, dropping a
    position outside [0, Smax), and return the slices. Launches the kernel,
    or raises."""
    n, hkv, smax, d = k_layer.shape
    cuda.require(_planes(k_layer, v_layer, k_layer.dtype, HEAD_DIM) and k_layer.element_size() == 2
                 and _rows(k_new, v_new, n, hkv, k_layer.dtype) and _slot_index(positions, n),
                 _G_TAKES)
    if n == 0:
        return k_layer, v_layer
    fn = cuda.bind("gofr_kv_append_slot", _SLOT_ARGTYPES)
    cuda.check(fn(k_layer.data_ptr(), v_layer.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
                  positions.data_ptr(), n, hkv, smax, d, cuda.stream_of(k_layer)), "kv_append_slot")
    kv_append_slot.launches += 1
    return k_layer, v_layer


kv_append_slot.launches = 0


def _pool_q(launcher, entry: str, values_dtype: torch.dtype, row_bytes: int, takes: str,
            k_layer, v_layer, k_scale, v_scale, table, positions, k_new, v_new) -> tuple:
    pool, hkv, page, _ = k_layer.shape
    n = k_new.shape[0]
    cuda.require(_planes(k_layer, v_layer, values_dtype, row_bytes)
                 and _scales(k_scale, v_scale, k_layer.shape[:-1])
                 and _rows(k_new, v_new, n, hkv, torch.bfloat16) and _pool_index(table, positions, n),
                 takes)
    if n > 0:
        fn = cuda.bind(entry, _Q_ARGTYPES)
        cuda.check(fn(k_layer.data_ptr(), v_layer.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
                      k_new.data_ptr(), v_new.data_ptr(), table.data_ptr(), positions.data_ptr(), n,
                      table.shape[1], pool, hkv, page, HEAD_DIM, cuda.stream_of(k_layer)),
                   launcher.__name__)
        launcher.launches += 1
    return k_layer, v_layer, k_scale, v_scale


def kv_append_q(k_layer: torch.Tensor, v_layer: torch.Tensor, k_scale: torch.Tensor,
                v_scale: torch.Tensor, table: torch.Tensor, positions: torch.Tensor,
                k_new: torch.Tensor, v_new: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Kernel B-q: quantize k_new/v_new [N, Hkv, D] bf16 to int8 rows and
    append them, with their bf16 scales, to the int8 pool's layer slices
    (values [P, Hkv, page, D], scales [P, Hkv, page]) through ``table``, in
    place, by B's drop rule; returns the four slices. Launches the kernel,
    or raises."""
    return _pool_q(kv_append_q, "gofr_kv_append_q", torch.int8, HEAD_DIM, _BQ_TAKES,
                   k_layer, v_layer, k_scale, v_scale, table, positions, k_new, v_new)


kv_append_q.launches = 0


def kv_append_q4(k_layer: torch.Tensor, v_layer: torch.Tensor, k_scale: torch.Tensor,
                 v_scale: torch.Tensor, table: torch.Tensor, positions: torch.Tensor,
                 k_new: torch.Tensor, v_new: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Kernel B-q4: as ``kv_append_q`` into the packed int4 pool (values
    uint8 [P, Hkv, page, D//2], byte j holding elements j and j + D/2)."""
    return _pool_q(kv_append_q4, "gofr_kv_append_q4", torch.uint8, HEAD_DIM // 2, _BQ4_TAKES,
                   k_layer, v_layer, k_scale, v_scale, table, positions, k_new, v_new)


kv_append_q4.launches = 0


def kv_append_slot_q(k_layer: torch.Tensor, v_layer: torch.Tensor, k_scale: torch.Tensor,
                     v_scale: torch.Tensor, positions: torch.Tensor, k_new: torch.Tensor,
                     v_new: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Kernel G-q: quantize k_new/v_new [N, Hkv, D] bf16 to int8 rows and
    append them, with their bf16 scales, to the int8 slot cache's layer
    slices (values [N, Hkv, Smax, D], scales [N, Hkv, Smax]) at
    ``positions``, in place, dropping a position outside [0, Smax); returns
    the four slices. Launches the kernel, or raises."""
    n, hkv, smax, _ = k_layer.shape
    cuda.require(_planes(k_layer, v_layer, torch.int8, HEAD_DIM)
                 and _scales(k_scale, v_scale, k_layer.shape[:-1])
                 and _rows(k_new, v_new, n, hkv, torch.bfloat16) and _slot_index(positions, n),
                 _GQ_TAKES)
    if n > 0:
        fn = cuda.bind("gofr_kv_append_slot_q", _SLOT_Q_ARGTYPES)
        cuda.check(fn(k_layer.data_ptr(), v_layer.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
                      k_new.data_ptr(), v_new.data_ptr(), positions.data_ptr(), n, hkv, smax, HEAD_DIM,
                      cuda.stream_of(k_layer)), "kv_append_slot_q")
        kv_append_slot_q.launches += 1
    return k_layer, v_layer, k_scale, v_scale


kv_append_slot_q.launches = 0
