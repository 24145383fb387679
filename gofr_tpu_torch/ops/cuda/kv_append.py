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

All five are built at head dim 128 (Llama-3-8B) and 64 (GPT-2, Llama
``one_b``), each build counted under its own name: ``kv_append`` /
``kv_append_d64``, ``kv_append_slot`` / ``kv_append_slot_d64``,
``kv_append_q`` / ``kv_append_q_d64``, ``kv_append_q4`` /
``kv_append_q4_d64`` and ``kv_append_slot_q`` / ``kv_append_slot_q_d64``.
G and B are also built for f32 caches (the f32 models: GPT-2 small in its
own dtype, Llama on the f32 slot cache and the f32 pool), counted as
``kv_append_slot_f32`` / ``kv_append_slot_d64_f32`` and ``kv_append_f32``
/ ``kv_append_d64_f32``: ``kv_append_slot`` and ``kv_append`` route 4-byte
planes there. B-q takes f32 rows too (an f32 model on the int8 pool: the
row quantized from its own f32 values), counted as ``kv_append_q_f32`` /
``kv_append_q_d64_f32``; so do B-q4 (an f32 model on the int4 pool),
counted as ``kv_append_q4_f32`` / ``kv_append_q4_d64_f32``, and G-q (on the
int8 slot cache), counted as ``kv_append_slot_q_f32`` /
``kv_append_slot_q_d64_f32``.

The launchers take what the model hands them and convert nothing: rows
[N, Hkv, D] in the model's type (bf16 or f32, on every cache),
``positions`` [N] and ``table`` [N, MaxP] int32 and contiguous on the card
(``Llama.decode_step`` converts both once per step). They validate, launch
and count, with one check each of what the pointers they pass need (on
the card, shapes, types, contiguous); the C entry points refuse rows that
are not 8-byte aligned (16 for f32 rows of 128 into the f32 caches and the
int8 ones) before they launch.
Limit against the plain versions on f32 rows: bit for bit, as on bf16
rows; the nearest planted faults (scripts/torch_kernel_mutants.py), B-q,
B-q4 and G-q reading their f32 rows as bf16 halves, are caught by that
check.
"""

from __future__ import annotations

import ctypes

import torch

from gofr_tpu_torch.ops import cuda

HEAD_DIMS = (128, 64)
# the C entry point of each build
ENTRY = {(128, torch.bfloat16): "gofr_kv_append", (64, torch.bfloat16): "gofr_kv_append_d64",
         (128, torch.float32): "gofr_kv_append_f32", (64, torch.float32): "gofr_kv_append_d64_f32"}
SLOT_ENTRY = {(128, torch.bfloat16): "gofr_kv_append_slot",
              (64, torch.bfloat16): "gofr_kv_append_slot_d64",
              (128, torch.float32): "gofr_kv_append_slot_f32",
              (64, torch.float32): "gofr_kv_append_slot_d64_f32"}
Q_ENTRY = {(128, torch.bfloat16): "gofr_kv_append_q", (64, torch.bfloat16): "gofr_kv_append_q_d64",
           (128, torch.float32): "gofr_kv_append_q_f32",
           (64, torch.float32): "gofr_kv_append_q_d64_f32"}
Q4_ENTRY = {(128, torch.bfloat16): "gofr_kv_append_q4", (64, torch.bfloat16): "gofr_kv_append_q4_d64",
            (128, torch.float32): "gofr_kv_append_q4_f32",
            (64, torch.float32): "gofr_kv_append_q4_d64_f32"}
SLOT_Q_ENTRY = {(128, torch.bfloat16): "gofr_kv_append_slot_q",
                (64, torch.bfloat16): "gofr_kv_append_slot_q_d64",
                (128, torch.float32): "gofr_kv_append_slot_q_f32",
                (64, torch.float32): "gofr_kv_append_slot_q_d64_f32"}
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_SLOT_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_Q_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_SLOT_Q_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
# what each launcher takes, the message of its one check
_TAKES = "takes contiguous tensors on the card: "
_POOL_INDEX = "int32 table [N, MaxP] and positions [N]"
_B_TAKES = (f"kv_append {_TAKES}two 16-bit or f32 pools [P, Hkv, page, D] of one type, rows "
            f"[N, Hkv, D] of that type, D 128 or 64, {_POOL_INDEX}")
_G_TAKES = (f"kv_append_slot {_TAKES}two 16-bit or f32 caches [N, Hkv, Smax, D] of one type, "
            "rows [N, Hkv, D] of that type, D 128 or 64, int32 positions [N]")
_BQ_TAKES = (f"kv_append_q {_TAKES}int8 pools [P, Hkv, page, D] with bf16 scales [P, Hkv, page], "
             f"bf16 or f32 rows [N, Hkv, D], D 128 or 64, {_POOL_INDEX}")
_BQ4_TAKES = (f"kv_append_q4 {_TAKES}uint8 pools [P, Hkv, page, D/2] with bf16 scales "
              f"[P, Hkv, page], bf16 or f32 rows [N, Hkv, D], D 128 or 64, {_POOL_INDEX}")
_GQ_TAKES = (f"kv_append_slot_q {_TAKES}int8 caches [N, Hkv, Smax, D] with bf16 scales "
             "[N, Hkv, Smax], bf16 or f32 rows [N, Hkv, D], D 128 or 64, int32 positions [N]")


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


def _rows(k_new: torch.Tensor, v_new: torch.Tensor, n: int, hkv: int, dtype: torch.dtype,
          d: int) -> bool:
    """New rows [N, Hkv, d] of ``dtype``, contiguous on the card."""
    return (k_new.is_cuda and v_new.is_cuda and k_new.dtype == v_new.dtype == dtype
            and k_new.shape == v_new.shape == (n, hkv, d)
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
    [P, Hkv, page, D] (16-bit, or f32) at each slot's position through
    ``table`` [N, MaxP], in place, and return the slices. 16-bit pools go
    to the bf16 rows' build, f32 pools to the f32 build. Launches the
    kernel, or raises."""
    pool, hkv, page, d = k_layer.shape
    n = k_new.shape[0]
    size = k_layer.element_size()
    cuda.require(d in HEAD_DIMS and _planes(k_layer, v_layer, k_layer.dtype, d)
                 and (size == 2 or k_layer.dtype == torch.float32)
                 and _rows(k_new, v_new, n, hkv, k_layer.dtype, d)
                 and _pool_index(table, positions, n), _B_TAKES)
    if n == 0:
        return k_layer, v_layer
    build = d, torch.bfloat16 if size == 2 else torch.float32
    fn = cuda.bind(ENTRY[build], _ARGTYPES)
    cuda.check(fn(k_layer.data_ptr(), v_layer.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
                  table.data_ptr(), positions.data_ptr(), n, table.shape[1], pool, hkv, page, d,
                  cuda.stream_of(k_layer)), _COUNTED[build].__name__)
    _COUNTED[build].launches += 1
    return k_layer, v_layer


def kv_append_d64(k_layer: torch.Tensor, v_layer: torch.Tensor, table: torch.Tensor,
                  positions: torch.Tensor, k_new: torch.Tensor,
                  v_new: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel B's head-dim-64 build under its own name: ``kv_append`` on
    pools and rows of head dim 64 (any other raises)."""
    cuda.require(k_layer.shape[-1] == 64, f"kv_append_d64 takes head_dim 64, got {k_layer.shape[-1]}")
    return kv_append(k_layer, v_layer, table, positions, k_new, v_new)


def kv_append_f32(k_layer: torch.Tensor, v_layer: torch.Tensor, table: torch.Tensor,
                  positions: torch.Tensor, k_new: torch.Tensor,
                  v_new: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel B's f32 build under its own name: ``kv_append`` on f32 pools
    and rows (any other type raises); counted by head dim as
    ``kv_append_f32`` (128) or ``kv_append_d64_f32``."""
    cuda.require(k_layer.dtype == torch.float32, f"kv_append_f32 takes f32 pools, got {k_layer.dtype}")
    return kv_append(k_layer, v_layer, table, positions, k_new, v_new)


def kv_append_d64_f32(k_layer: torch.Tensor, v_layer: torch.Tensor, table: torch.Tensor,
                      positions: torch.Tensor, k_new: torch.Tensor,
                      v_new: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel B's f32 build at head dim 64 under its own name (any other
    type or head dim raises)."""
    cuda.require(k_layer.shape[-1] == 64,
                 f"kv_append_d64_f32 takes head_dim 64, got {k_layer.shape[-1]}")
    return kv_append_f32(k_layer, v_layer, table, positions, k_new, v_new)


kv_append.launches = 0
kv_append_d64.launches = 0
kv_append_f32.launches = 0
kv_append_d64_f32.launches = 0
_COUNTED = {(128, torch.bfloat16): kv_append, (64, torch.bfloat16): kv_append_d64,
            (128, torch.float32): kv_append_f32, (64, torch.float32): kv_append_d64_f32}


def kv_append_slot(k_layer: torch.Tensor, v_layer: torch.Tensor, positions: torch.Tensor,
                   k_new: torch.Tensor, v_new: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel G: write k_new/v_new [N, Hkv, D] into slot-cache layer slices
    [N, Hkv, Smax, D] (16-bit, or f32) at ``positions`` [N], in place,
    dropping a position outside [0, Smax), and return the slices. 16-bit
    planes go to the bf16 rows' build, f32 planes to the f32 build.
    Launches the kernel, or raises."""
    n, hkv, smax, d = k_layer.shape
    size = k_layer.element_size()
    cuda.require(d in HEAD_DIMS and _planes(k_layer, v_layer, k_layer.dtype, d)
                 and (size == 2 or k_layer.dtype == torch.float32)
                 and _rows(k_new, v_new, n, hkv, k_layer.dtype, d)
                 and _slot_index(positions, n), _G_TAKES)
    if n == 0:
        return k_layer, v_layer
    build = d, torch.bfloat16 if size == 2 else torch.float32
    fn = cuda.bind(SLOT_ENTRY[build], _SLOT_ARGTYPES)
    cuda.check(fn(k_layer.data_ptr(), v_layer.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
                  positions.data_ptr(), n, hkv, smax, d, cuda.stream_of(k_layer)), "kv_append_slot")
    _SLOT_COUNTED[build].launches += 1
    return k_layer, v_layer


def kv_append_slot_d64(k_layer: torch.Tensor, v_layer: torch.Tensor, positions: torch.Tensor,
                       k_new: torch.Tensor, v_new: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel G's head-dim-64 build under its own name: ``kv_append_slot``
    on caches and rows of head dim 64 (any other raises)."""
    cuda.require(k_layer.shape[-1] == 64,
                 f"kv_append_slot_d64 takes head_dim 64, got {k_layer.shape[-1]}")
    return kv_append_slot(k_layer, v_layer, positions, k_new, v_new)


def kv_append_slot_f32(k_layer: torch.Tensor, v_layer: torch.Tensor, positions: torch.Tensor,
                       k_new: torch.Tensor, v_new: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel G's f32 build under its own name: ``kv_append_slot`` on f32
    caches and rows (any other type raises); counted by head dim as
    ``kv_append_slot_f32`` (128) or ``kv_append_slot_d64_f32``."""
    cuda.require(k_layer.dtype == torch.float32,
                 f"kv_append_slot_f32 takes f32 caches, got {k_layer.dtype}")
    return kv_append_slot(k_layer, v_layer, positions, k_new, v_new)


def kv_append_slot_d64_f32(k_layer: torch.Tensor, v_layer: torch.Tensor, positions: torch.Tensor,
                           k_new: torch.Tensor,
                           v_new: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel G's f32 build at head dim 64 under its own name (any other
    type or head dim raises)."""
    cuda.require(k_layer.shape[-1] == 64,
                 f"kv_append_slot_d64_f32 takes head_dim 64, got {k_layer.shape[-1]}")
    return kv_append_slot_f32(k_layer, v_layer, positions, k_new, v_new)


kv_append_slot.launches = 0
kv_append_slot_d64.launches = 0
kv_append_slot_f32.launches = 0
kv_append_slot_d64_f32.launches = 0
_SLOT_COUNTED = {(128, torch.bfloat16): kv_append_slot, (64, torch.bfloat16): kv_append_slot_d64,
                 (128, torch.float32): kv_append_slot_f32,
                 (64, torch.float32): kv_append_slot_d64_f32}


def _pool_q(counted: dict, entries: dict, values_dtype: torch.dtype, per_byte: int, takes: str,
            k_layer, v_layer, k_scale, v_scale, table, positions, k_new, v_new) -> tuple:
    """A quantizing pool append: its checks (rows of a type ``entries``
    builds), then the C entry point ``entries[D, rows' dtype]``, counted on
    ``counted`` under the same key."""
    pool, hkv, page, _ = k_layer.shape
    n, d = k_new.shape[0], k_new.shape[-1]
    cuda.require(d in HEAD_DIMS and _planes(k_layer, v_layer, values_dtype, d // per_byte)
                 and _scales(k_scale, v_scale, k_layer.shape[:-1])
                 and (d, k_new.dtype) in entries and _rows(k_new, v_new, n, hkv, k_new.dtype, d)
                 and _pool_index(table, positions, n), takes)
    build = d, k_new.dtype
    if n > 0:
        fn = cuda.bind(entries[build], _Q_ARGTYPES)
        cuda.check(fn(k_layer.data_ptr(), v_layer.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
                      k_new.data_ptr(), v_new.data_ptr(), table.data_ptr(), positions.data_ptr(), n,
                      table.shape[1], pool, hkv, page, d, cuda.stream_of(k_layer)),
                   counted[build].__name__)
        counted[build].launches += 1
    return k_layer, v_layer, k_scale, v_scale


def kv_append_q(k_layer: torch.Tensor, v_layer: torch.Tensor, k_scale: torch.Tensor,
                v_scale: torch.Tensor, table: torch.Tensor, positions: torch.Tensor,
                k_new: torch.Tensor, v_new: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Kernel B-q: quantize k_new/v_new [N, Hkv, D] bf16 or f32 to int8
    rows and append them, with their bf16 scales, to the int8 pool's layer
    slices (values [P, Hkv, page, D], scales [P, Hkv, page]) through
    ``table``, in place, by B's drop rule; returns the four slices. D is 128
    or 64. Launches the kernel, or raises."""
    return _pool_q(_Q_COUNTED, Q_ENTRY, torch.int8, 1, _BQ_TAKES,
                   k_layer, v_layer, k_scale, v_scale, table, positions, k_new, v_new)


def kv_append_q_d64(k_layer: torch.Tensor, v_layer: torch.Tensor, k_scale: torch.Tensor,
                    v_scale: torch.Tensor, table: torch.Tensor, positions: torch.Tensor,
                    k_new: torch.Tensor, v_new: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Kernel B-q's head-dim-64 build under its own name: ``kv_append_q``
    on rows of head dim 64 (any other raises)."""
    cuda.require(k_new.shape[-1] == 64, f"kv_append_q_d64 takes head_dim 64, got {k_new.shape[-1]}")
    return kv_append_q(k_layer, v_layer, k_scale, v_scale, table, positions, k_new, v_new)


def kv_append_q_f32(k_layer: torch.Tensor, v_layer: torch.Tensor, k_scale: torch.Tensor,
                    v_scale: torch.Tensor, table: torch.Tensor, positions: torch.Tensor,
                    k_new: torch.Tensor, v_new: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Kernel B-q's f32-row build under its own name: ``kv_append_q`` on f32
    rows (any other type raises); counted by head dim as
    ``kv_append_q_f32`` (128) or ``kv_append_q_d64_f32``."""
    cuda.require(k_new.dtype == torch.float32, f"kv_append_q_f32 takes f32 rows, got {k_new.dtype}")
    return kv_append_q(k_layer, v_layer, k_scale, v_scale, table, positions, k_new, v_new)


def kv_append_q_d64_f32(k_layer: torch.Tensor, v_layer: torch.Tensor, k_scale: torch.Tensor,
                        v_scale: torch.Tensor, table: torch.Tensor, positions: torch.Tensor,
                        k_new: torch.Tensor, v_new: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Kernel B-q's f32-row build at head dim 64 under its own name (any
    other type or head dim raises)."""
    cuda.require(k_new.shape[-1] == 64,
                 f"kv_append_q_d64_f32 takes head_dim 64, got {k_new.shape[-1]}")
    return kv_append_q_f32(k_layer, v_layer, k_scale, v_scale, table, positions, k_new, v_new)


kv_append_q.launches = 0
kv_append_q_d64.launches = 0
kv_append_q_f32.launches = 0
kv_append_q_d64_f32.launches = 0
_Q_COUNTED = {(128, torch.bfloat16): kv_append_q, (64, torch.bfloat16): kv_append_q_d64,
              (128, torch.float32): kv_append_q_f32, (64, torch.float32): kv_append_q_d64_f32}


def kv_append_q4(k_layer: torch.Tensor, v_layer: torch.Tensor, k_scale: torch.Tensor,
                 v_scale: torch.Tensor, table: torch.Tensor, positions: torch.Tensor,
                 k_new: torch.Tensor, v_new: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Kernel B-q4: as ``kv_append_q`` into the packed int4 pool (values
    uint8 [P, Hkv, page, D//2], byte j holding elements j and j + D/2)."""
    return _pool_q(_Q4_COUNTED, Q4_ENTRY, torch.uint8, 2, _BQ4_TAKES,
                   k_layer, v_layer, k_scale, v_scale, table, positions, k_new, v_new)


def kv_append_q4_d64(k_layer: torch.Tensor, v_layer: torch.Tensor, k_scale: torch.Tensor,
                     v_scale: torch.Tensor, table: torch.Tensor, positions: torch.Tensor,
                     k_new: torch.Tensor, v_new: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Kernel B-q4's head-dim-64 build under its own name: ``kv_append_q4``
    on rows of head dim 64 (any other raises)."""
    cuda.require(k_new.shape[-1] == 64,
                 f"kv_append_q4_d64 takes head_dim 64, got {k_new.shape[-1]}")
    return kv_append_q4(k_layer, v_layer, k_scale, v_scale, table, positions, k_new, v_new)


def kv_append_q4_f32(k_layer: torch.Tensor, v_layer: torch.Tensor, k_scale: torch.Tensor,
                     v_scale: torch.Tensor, table: torch.Tensor, positions: torch.Tensor,
                     k_new: torch.Tensor, v_new: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Kernel B-q4's f32-row build under its own name: ``kv_append_q4`` on
    f32 rows (any other type raises); counted by head dim as
    ``kv_append_q4_f32`` (128) or ``kv_append_q4_d64_f32``."""
    cuda.require(k_new.dtype == torch.float32, f"kv_append_q4_f32 takes f32 rows, got {k_new.dtype}")
    return kv_append_q4(k_layer, v_layer, k_scale, v_scale, table, positions, k_new, v_new)


def kv_append_q4_d64_f32(k_layer: torch.Tensor, v_layer: torch.Tensor, k_scale: torch.Tensor,
                         v_scale: torch.Tensor, table: torch.Tensor, positions: torch.Tensor,
                         k_new: torch.Tensor, v_new: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Kernel B-q4's f32-row build at head dim 64 under its own name (any
    other type or head dim raises)."""
    cuda.require(k_new.shape[-1] == 64,
                 f"kv_append_q4_d64_f32 takes head_dim 64, got {k_new.shape[-1]}")
    return kv_append_q4_f32(k_layer, v_layer, k_scale, v_scale, table, positions, k_new, v_new)


kv_append_q4.launches = 0
kv_append_q4_d64.launches = 0
kv_append_q4_f32.launches = 0
kv_append_q4_d64_f32.launches = 0
_Q4_COUNTED = {(128, torch.bfloat16): kv_append_q4, (64, torch.bfloat16): kv_append_q4_d64,
               (128, torch.float32): kv_append_q4_f32, (64, torch.float32): kv_append_q4_d64_f32}


def kv_append_slot_q(k_layer: torch.Tensor, v_layer: torch.Tensor, k_scale: torch.Tensor,
                     v_scale: torch.Tensor, positions: torch.Tensor, k_new: torch.Tensor,
                     v_new: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Kernel G-q: quantize k_new/v_new [N, Hkv, D] bf16 or f32 to int8
    rows and append them, with their bf16 scales, to the int8 slot cache's
    layer slices (values [N, Hkv, Smax, D], scales [N, Hkv, Smax]) at
    ``positions``, in place, dropping a position outside [0, Smax); returns
    the four slices. D is 128 or 64. Launches the kernel, or raises."""
    n, hkv, smax, d = k_layer.shape
    cuda.require(d in HEAD_DIMS and _planes(k_layer, v_layer, torch.int8, d)
                 and _scales(k_scale, v_scale, k_layer.shape[:-1])
                 and (d, k_new.dtype) in SLOT_Q_ENTRY and _rows(k_new, v_new, n, hkv, k_new.dtype, d)
                 and _slot_index(positions, n), _GQ_TAKES)
    build = d, k_new.dtype
    if n > 0:
        fn = cuda.bind(SLOT_Q_ENTRY[build], _SLOT_Q_ARGTYPES)
        cuda.check(fn(k_layer.data_ptr(), v_layer.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
                      k_new.data_ptr(), v_new.data_ptr(), positions.data_ptr(), n, hkv, smax, d,
                      cuda.stream_of(k_layer)), _SLOT_Q_COUNTED[build].__name__)
        _SLOT_Q_COUNTED[build].launches += 1
    return k_layer, v_layer, k_scale, v_scale


def kv_append_slot_q_d64(k_layer: torch.Tensor, v_layer: torch.Tensor, k_scale: torch.Tensor,
                         v_scale: torch.Tensor, positions: torch.Tensor, k_new: torch.Tensor,
                         v_new: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Kernel G-q's head-dim-64 build under its own name:
    ``kv_append_slot_q`` on caches and rows of head dim 64 (any other
    raises)."""
    cuda.require(k_layer.shape[-1] == 64,
                 f"kv_append_slot_q_d64 takes head_dim 64, got {k_layer.shape[-1]}")
    return kv_append_slot_q(k_layer, v_layer, k_scale, v_scale, positions, k_new, v_new)


def kv_append_slot_q_f32(k_layer: torch.Tensor, v_layer: torch.Tensor, k_scale: torch.Tensor,
                         v_scale: torch.Tensor, positions: torch.Tensor, k_new: torch.Tensor,
                         v_new: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Kernel G-q's f32-row build under its own name: ``kv_append_slot_q``
    on f32 rows (any other type raises); counted by head dim as
    ``kv_append_slot_q_f32`` (128) or ``kv_append_slot_q_d64_f32``."""
    cuda.require(k_new.dtype == torch.float32,
                 f"kv_append_slot_q_f32 takes f32 rows, got {k_new.dtype}")
    return kv_append_slot_q(k_layer, v_layer, k_scale, v_scale, positions, k_new, v_new)


def kv_append_slot_q_d64_f32(k_layer: torch.Tensor, v_layer: torch.Tensor, k_scale: torch.Tensor,
                             v_scale: torch.Tensor, positions: torch.Tensor, k_new: torch.Tensor,
                             v_new: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Kernel G-q's f32-row build at head dim 64 under its own name (any
    other type or head dim raises)."""
    cuda.require(k_layer.shape[-1] == 64,
                 f"kv_append_slot_q_d64_f32 takes head_dim 64, got {k_layer.shape[-1]}")
    return kv_append_slot_q_f32(k_layer, v_layer, k_scale, v_scale, positions, k_new, v_new)


kv_append_slot_q.launches = 0
kv_append_slot_q_d64.launches = 0
kv_append_slot_q_f32.launches = 0
kv_append_slot_q_d64_f32.launches = 0
_SLOT_Q_COUNTED = {(128, torch.bfloat16): kv_append_slot_q, (64, torch.bfloat16): kv_append_slot_q_d64,
                   (128, torch.float32): kv_append_slot_q_f32,
                   (64, torch.float32): kv_append_slot_q_d64_f32}
