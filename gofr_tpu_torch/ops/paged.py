"""Paged (block) KV pool: fixed-size pages plus per-slot block tables
(counterpart of gofr_tpu/ops/paged.py).

One physical pool per plane, ``k, v: [L, P, Hkv, page, D]`` — the same
head-major layout as the JAX pool (paged.py:173) — and each serving slot
owns an ordered list of page ids, its block table. Logical position ``p``
of slot ``s`` lives at ``(table[s, p // page], p % page)``.

Out-of-bounds convention: table entries for unallocated pages point at
page id P (one past the pool). A write there is dropped; a read clamps to
page P-1 and is masked by the slot's length downstream.

Unlike the JAX package, whose arrays are immutable, the port writes the
pool IN PLACE: a layer slice ``cache.k[l]`` is a view, and the write paths
below update it and return it. Nothing else holds a copy of the pool, so
this saves a pool-sized copy per write.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from gofr_tpu_torch.ops.cuda.kv_append import kv_append


@dataclass
class PagedKVCache:
    k: torch.Tensor  # [L, P, Hkv, page, D]
    v: torch.Tensor  # [L, P, Hkv, page, D]

    @classmethod
    def create(cls, layers: int, pages: int, page_size: int, kv_heads: int,
               head_dim: int, dtype: torch.dtype = torch.bfloat16,
               device: str | torch.device = "cpu") -> "PagedKVCache":
        shape = (layers, pages, kv_heads, page_size, head_dim)
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))

    @property
    def num_layers(self) -> int:
        return self.k.shape[0]

    @property
    def num_pages(self) -> int:
        return self.k.shape[1]

    @property
    def page_size(self) -> int:
        return self.k.shape[3]


def _locate(pages: torch.Tensor, pos: torch.Tensor, page: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(physical page, in-page offset) per logical position, as paged.py:162:
    the logical page clamps into the table; OOB rows carry page id P."""
    logical = torch.clamp(torch.div(pos, page, rounding_mode="floor"), 0, pages.shape[1] - 1)
    return torch.gather(pages, 1, logical), pos % page


def write_prompts_paged(k_layer: torch.Tensor, v_layer: torch.Tensor, pages: torch.Tensor,
                        k_new: torch.Tensor, v_new: torch.Tensor,
                        offsets: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Write prompts (or prompt chunks at ``offsets``) [B, S, Hkv, D] through
    block-table rows ``pages`` [B, MaxP] into a layer slice [P, Hkv, page, D],
    in place. Rows whose page is P are dropped (paged.py:495)."""
    b, s = k_new.shape[:2]
    pool, _, page, _ = k_layer.shape
    pos = torch.arange(s, device=pages.device)[None, :].expand(b, s)
    if offsets is not None:
        pos = pos + offsets[:, None]
    pp, off = _locate(pages.long(), pos.long(), page)
    keep = pp < pool
    rows, offs = pp[keep], off[keep]
    k_layer[rows, :, offs] = k_new[keep].to(k_layer.dtype)
    v_layer[rows, :, offs] = v_new[keep].to(v_layer.dtype)
    return k_layer, v_layer


def append_tokens_paged_plain(k_layer: torch.Tensor, v_layer: torch.Tensor, table: torch.Tensor,
                              positions: torch.Tensor, k_new: torch.Tensor,
                              v_new: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the KV append kernel (ops/cuda/kv_append.py): write
    one K/V row [N, Hkv, D] per slot at page ``table[n, pos // page]``, row
    ``pos % page``, in place. A row is dropped when ``pos < 0``, when
    ``pos // page >= MaxP``, or when the table entry is not a pool page —
    the rule of the TPU kernel (ops/pallas/kv_append.py:148-154)."""
    pool, _, page, _ = k_layer.shape
    maxp = table.shape[1]
    pos = positions.long()
    logical = torch.div(pos, page, rounding_mode="floor")
    entry = torch.gather(table.long(), 1, torch.clamp(logical, 0, maxp - 1)[:, None])[:, 0]
    keep = (pos >= 0) & (logical < maxp) & (entry >= 0) & (entry < pool)
    rows, offs = entry[keep], (pos % page)[keep]
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
    n, maxp = table.shape
    pool, hkv, page, d = k_layer.shape
    safe = torch.clamp(table.long(), 0, pool - 1)

    def view(layer: torch.Tensor) -> torch.Tensor:
        return layer[safe].permute(0, 2, 1, 3, 4).reshape(n, hkv, maxp * page, d)

    return view(k_layer), view(v_layer)
