"""Paged (block) KV pool: fixed-size pages plus per-slot block tables
(counterpart of gofr_tpu/ops/paged.py).

One physical pool per plane, ``k, v: [L, P, Hkv, page, D]`` — the same
head-major layout as the JAX pool (paged.py:173) — and each serving slot
owns an ordered list of page ids, its block table. Logical position ``p``
of slot ``s`` lives at ``(table[s, p // page], p % page)``.

Out-of-bounds convention: table entries for unallocated pages point at
page id P (one past the pool). A write there is dropped; a read clamps to
page P-1 and is masked by the slot's length downstream.

Three pool formats (paged.py:170-287): ``PagedKVCache`` holds K/V in the
model's dtype; ``QPagedKVCache`` holds them as int8 rows and
``Q4PagedKVCache`` as packed int4 rows (``ops.quant``), each with one bf16
scale per (page, head, position) in ``ks``/``vs``. The quantized writes,
appends and gathers work on one plane (values plus scales) at a time, as
the JAX functions do. The quantized append has no kernel: the TPU ran it
as XLA, and here it is plain PyTorch on the card too. Each pool class
carries its format's per-layer operations (``write``, ``append``,
``stored``, ``read``, ``planes``), so the model never branches on the
format.

Unlike the JAX package, whose arrays are immutable, the port writes the
pool IN PLACE: a layer slice ``cache.k[l]`` is a view, and the write paths
below update it and return it. Nothing else holds a copy of the pool, so
this saves a pool-sized copy per write.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar

import torch

from gofr_tpu_torch.ops.cuda.kv_append import kv_append
from gofr_tpu_torch.ops.kvcache import dequantize_view, fake_quant_row, quantize_row
from gofr_tpu_torch.ops.quant import fake_quant_row_int4, pack_int4, quantize_row_int4, unpack_int4


class _PoolShape:
    @property
    def num_layers(self) -> int:
        return self.k.shape[0]

    @property
    def num_pages(self) -> int:
        return self.k.shape[1]

    @property
    def page_size(self) -> int:
        return self.k.shape[3]


@dataclass
class PagedKVCache(_PoolShape):
    """K/V in the model's dtype. Each pool format offers the model the same
    per-layer operations: ``write`` (prompts or chunks), ``append`` (one
    decode row per slot), ``stored`` (what a read of a written row returns),
    ``read`` (dense logical views through a table) and ``planes`` (the
    tensors its decode attention takes)."""

    k: torch.Tensor  # [L, P, Hkv, page, D]
    v: torch.Tensor  # [L, P, Hkv, page, D]

    @classmethod
    def create(cls, layers: int, pages: int, page_size: int, kv_heads: int,
               head_dim: int, dtype: torch.dtype = torch.bfloat16,
               device: str | torch.device = "cpu") -> "PagedKVCache":
        shape = (layers, pages, kv_heads, page_size, head_dim)
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))

    def write(self, layer: int, pages: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
              offsets: torch.Tensor | None = None) -> None:
        write_prompts_paged(self.k[layer], self.v[layer], pages, k_new, v_new, offsets)

    def append(self, layer: int, table: torch.Tensor, positions: torch.Tensor,
               k_new: torch.Tensor, v_new: torch.Tensor, *, kernels: bool = True) -> None:
        append = append_tokens_paged if kernels else append_tokens_paged_plain
        append(self.k[layer], self.v[layer], table, positions, k_new, v_new)

    @staticmethod
    def stored(x: torch.Tensor) -> torch.Tensor:
        return x

    def read(self, layer: int, pages: torch.Tensor,
             dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
        return gather_kv(self.k[layer], self.v[layer], pages)

    def planes(self, layer: int) -> tuple[torch.Tensor, ...]:
        return self.k[layer], self.v[layer]


@dataclass
class _ScaledPagedKVCache(_PoolShape):
    """Quantized K/V rows with one bf16 scale per (page, head, position).
    A subclass names its row format's one-plane functions; the quantized
    append has no kernel, so ``append`` is plain PyTorch either way."""

    k: torch.Tensor   # [L, P, Hkv, page, row width]
    v: torch.Tensor
    ks: torch.Tensor  # bf16 [L, P, Hkv, page]
    vs: torch.Tensor  # bf16 [L, P, Hkv, page]

    values_dtype: ClassVar[torch.dtype]
    write_plane: ClassVar
    append_plane: ClassVar
    gather_plane: ClassVar
    stored: ClassVar

    @staticmethod
    def row_width(head_dim: int) -> int:
        return head_dim

    @classmethod
    def create(cls, layers: int, pages: int, page_size: int, kv_heads: int,
               head_dim: int, device: str | torch.device = "cpu"):
        shape = (layers, pages, kv_heads, page_size, cls.row_width(head_dim))
        sshape = (layers, pages, kv_heads, page_size)
        return cls(k=torch.zeros(shape, dtype=cls.values_dtype, device=device),
                   v=torch.zeros(shape, dtype=cls.values_dtype, device=device),
                   ks=torch.zeros(sshape, dtype=torch.bfloat16, device=device),
                   vs=torch.zeros(sshape, dtype=torch.bfloat16, device=device))

    def _plane_pairs(self, layer: int):
        return (self.k[layer], self.ks[layer]), (self.v[layer], self.vs[layer])

    def write(self, layer: int, pages: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
              offsets: torch.Tensor | None = None) -> None:
        for (values, scales), new in zip(self._plane_pairs(layer), (k_new, v_new)):
            self.write_plane(values, scales, pages, new, offsets)

    def append(self, layer: int, table: torch.Tensor, positions: torch.Tensor,
               k_new: torch.Tensor, v_new: torch.Tensor, *, kernels: bool = True) -> None:
        for (values, scales), new in zip(self._plane_pairs(layer), (k_new, v_new)):
            self.append_plane(values, scales, table, positions, new)

    def read(self, layer: int, pages: torch.Tensor,
             dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
        k, v = (dequantize_view(*self.gather_plane(values, scales, pages), dtype)
                for values, scales in self._plane_pairs(layer))
        return k, v

    def planes(self, layer: int) -> tuple[torch.Tensor, ...]:
        return self.k[layer], self.v[layer], self.ks[layer], self.vs[layer]


def kv_plane_bytes_per_position(layers: int, kv_heads: int, head_dim: int,
                                kv_dtype: str = "bf16") -> int:
    """Bytes one position takes across every plane of a pool (paged.py:290):
    bf16 K+V; int8 K+V plus the two bf16 scales; packed int4 K+V (half a
    byte per element) plus the scales."""
    if kv_dtype == "int4":
        per = 2 * (head_dim // 2) + 4
    elif kv_dtype == "int8":
        per = 2 * head_dim + 4
    else:
        per = 2 * head_dim * 2
    return layers * kv_heads * per


def _locate(pages: torch.Tensor, pos: torch.Tensor, page: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(physical page, in-page offset) per logical position, as paged.py:162:
    the logical page clamps into the table; OOB rows carry page id P."""
    logical = torch.clamp(torch.div(pos, page, rounding_mode="floor"), 0, pages.shape[1] - 1)
    return torch.gather(pages, 1, logical), pos % page


def _prompt_targets(pages: torch.Tensor, b: int, s: int, pool: int, page: int,
                    offsets: torch.Tensor | None):
    """Where prompt rows [B, S] land: (keep [B, S], page, in-page offset of
    each kept row). Rows whose page is P are dropped (paged.py:495)."""
    pos = torch.arange(s, device=pages.device)[None, :].expand(b, s)
    if offsets is not None:
        pos = pos + offsets[:, None]
    pp, off = _locate(pages.long(), pos.long(), page)
    keep = pp < pool
    return keep, pp[keep], off[keep]


def _append_targets(table: torch.Tensor, positions: torch.Tensor, pool: int, page: int):
    """Where each slot's new row lands: (keep [N], page, in-page offset of
    each kept row). A row is dropped when ``pos < 0``, when ``pos // page
    >= MaxP``, or when the table entry is not a pool page — the rule of the
    TPU append kernel (ops/pallas/kv_append.py:148-154)."""
    maxp = table.shape[1]
    pos = positions.long()
    logical = torch.div(pos, page, rounding_mode="floor")
    entry = torch.gather(table.long(), 1, torch.clamp(logical, 0, maxp - 1)[:, None])[:, 0]
    keep = (pos >= 0) & (logical < maxp) & (entry >= 0) & (entry < pool)
    return keep, entry[keep], (pos % page)[keep]


def _gather_plane(plane: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Logical [N, Hkv, MaxP * page, ...] view of each slot's rows of a
    plane [P, Hkv, page, ...]. OOB entries clamp to page P-1; callers mask
    by length."""
    n, maxp = table.shape
    pool, hkv, page = plane.shape[:3]
    safe = torch.clamp(table.long(), 0, pool - 1)
    rest = plane.shape[3:]
    order = (0, 2, 1, 3, *range(4, 4 + len(rest)))
    return plane[safe].permute(order).reshape(n, hkv, maxp * page, *rest)


def write_prompts_paged(k_layer: torch.Tensor, v_layer: torch.Tensor, pages: torch.Tensor,
                        k_new: torch.Tensor, v_new: torch.Tensor,
                        offsets: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Write prompts (or prompt chunks at ``offsets``) [B, S, Hkv, D] through
    block-table rows ``pages`` [B, MaxP] into a layer slice [P, Hkv, page, D],
    in place. Rows whose page is P are dropped (paged.py:495)."""
    pool, _, page, _ = k_layer.shape
    keep, rows, offs = _prompt_targets(pages, *k_new.shape[:2], pool, page, offsets)
    k_layer[rows, :, offs] = k_new[keep].to(k_layer.dtype)
    v_layer[rows, :, offs] = v_new[keep].to(v_layer.dtype)
    return k_layer, v_layer


def append_tokens_paged_plain(k_layer: torch.Tensor, v_layer: torch.Tensor, table: torch.Tensor,
                              positions: torch.Tensor, k_new: torch.Tensor,
                              v_new: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the KV append kernel (ops/cuda/kv_append.py): write
    one K/V row [N, Hkv, D] per slot at page ``table[n, pos // page]``, row
    ``pos % page``, in place, by the drop rule of ``_append_targets``."""
    pool, _, page, _ = k_layer.shape
    keep, rows, offs = _append_targets(table, positions, pool, page)
    k_layer[rows, :, offs] = k_new[keep].to(k_layer.dtype)
    v_layer[rows, :, offs] = v_new[keep].to(v_layer.dtype)
    return k_layer, v_layer


def append_tokens_paged(k_layer: torch.Tensor, v_layer: torch.Tensor, table: torch.Tensor,
                        positions: torch.Tensor, k_new: torch.Tensor,
                        v_new: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Append one token's K/V per slot (paged.py:519): the CUDA kernel for a
    pool on the card, its plain version for one on the CPU."""
    append = kv_append if k_layer.is_cuda else append_tokens_paged_plain
    return append(k_layer, v_layer, table, positions, k_new, v_new)


def gather_kv(k_layer: torch.Tensor, v_layer: torch.Tensor,
              table: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Logical [N, Hkv, MaxP * page, D] view of each slot's cache (paged.py:
    620). OOB entries clamp to page P-1; callers mask by length."""
    return _gather_plane(k_layer, table), _gather_plane(v_layer, table)


# -- quantized pools: one plane (values + scales) at a time ---------------------------


def _write_quantized(cache_q: torch.Tensor, cache_s: torch.Tensor, pages: torch.Tensor,
                     rows_q: torch.Tensor, rows_s: torch.Tensor,
                     offsets: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor]:
    pool, _, page = cache_s.shape
    keep, rows, offs = _prompt_targets(pages, *rows_q.shape[:2], pool, page, offsets)
    cache_q[rows, :, offs] = rows_q[keep]
    cache_s[rows, :, offs] = rows_s[keep].to(cache_s.dtype)
    return cache_q, cache_s


def _append_quantized(cache_q: torch.Tensor, cache_s: torch.Tensor, table: torch.Tensor,
                      positions: torch.Tensor, rows_q: torch.Tensor,
                      rows_s: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    pool, _, page = cache_s.shape
    keep, rows, offs = _append_targets(table, positions, pool, page)
    cache_q[rows, :, offs] = rows_q[keep]
    cache_s[rows, :, offs] = rows_s[keep].to(cache_s.dtype)
    return cache_q, cache_s


def write_prompts_paged_q(cache_q: torch.Tensor, cache_s: torch.Tensor, pages: torch.Tensor,
                          new: torch.Tensor, offsets: torch.Tensor | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize prompts (or chunks at ``offsets``) [B, S, Hkv, D] to int8
    rows and write them into one plane [P, Hkv, page, D] and its scales
    [P, Hkv, page] through ``pages`` [B, MaxP], in place (paged.py:322)."""
    q, sc = quantize_row(new)
    return _write_quantized(cache_q, cache_s, pages, q, sc, offsets)


def append_tokens_paged_q(cache_q: torch.Tensor, cache_s: torch.Tensor, table: torch.Tensor,
                          positions: torch.Tensor, new: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize one row [N, Hkv, D] per slot to int8 and append it to one
    plane, in place (paged.py:344), by the drop rule of ``_append_targets``
    (the JAX XLA append clamps a position past the table instead)."""
    q, sc = quantize_row(new)
    return _append_quantized(cache_q, cache_s, table, positions, q, sc)


def gather_kv_q(cache_q: torch.Tensor, cache_s: torch.Tensor,
                table: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Logical ([N, Hkv, MaxP * page, D] int8, [N, Hkv, MaxP * page] scale)
    views of each slot's plane (paged.py:399)."""
    return _gather_plane(cache_q, table), _gather_plane(cache_s, table)


def write_prompts_paged_q4(cache_q: torch.Tensor, cache_s: torch.Tensor, pages: torch.Tensor,
                           new: torch.Tensor, offsets: torch.Tensor | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The int4 analog of ``write_prompts_paged_q``: quantize to nibbles and
    pack two per byte into a plane [P, Hkv, page, D//2] (paged.py:415)."""
    q, sc = quantize_row_int4(new)
    return _write_quantized(cache_q, cache_s, pages, pack_int4(q), sc, offsets)


def append_tokens_paged_q4(cache_q: torch.Tensor, cache_s: torch.Tensor, table: torch.Tensor,
                           positions: torch.Tensor, new: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The int4 analog of ``append_tokens_paged_q`` (paged.py:438)."""
    q, sc = quantize_row_int4(new)
    return _append_quantized(cache_q, cache_s, table, positions, pack_int4(q), sc)


def gather_kv_q4(cache_q: torch.Tensor, cache_s: torch.Tensor,
                 table: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Logical ([N, Hkv, MaxP * page, D] int8 in [-8, 7], scale) views of
    each slot's packed plane, unpacked after the gather (paged.py:477)."""
    return unpack_int4(_gather_plane(cache_q, table)), _gather_plane(cache_s, table)


class QPagedKVCache(_ScaledPagedKVCache):
    """int8 pool (paged.py:200): k, v int8 [L, P, Hkv, page, D]."""

    values_dtype = torch.int8
    write_plane = staticmethod(write_prompts_paged_q)
    append_plane = staticmethod(append_tokens_paged_q)
    gather_plane = staticmethod(gather_kv_q)
    stored = staticmethod(fake_quant_row)


class Q4PagedKVCache(_ScaledPagedKVCache):
    """Packed-int4 pool (paged.py:238): k, v uint8 [L, P, Hkv, page, D//2],
    byte j of a row holding elements j and j + D/2 (``ops.quant.pack_int4``).
    A zero byte decodes to -8, so unwritten rows are kept out of attention
    by the slot's length, never by their zero scale."""

    values_dtype = torch.uint8
    write_plane = staticmethod(write_prompts_paged_q4)
    append_plane = staticmethod(append_tokens_paged_q4)
    gather_plane = staticmethod(gather_kv_q4)
    stored = staticmethod(fake_quant_row_int4)

    @staticmethod
    def row_width(head_dim: int) -> int:
        if head_dim % 2:
            raise ValueError(f"int4 packing needs an even head_dim, got {head_dim}")
        return head_dim // 2


AnyPagedKVCache = PagedKVCache | QPagedKVCache | Q4PagedKVCache
