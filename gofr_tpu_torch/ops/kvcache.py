"""The slot KV cache and the int8 row format (counterpart of
gofr_tpu/ops/kvcache.py).

The slot layout is one buffer per plane, ``[L, slots, Hkv, Smax, D]``,
head-major as in the JAX package (kvcache.py:30): each serving slot owns
``Smax`` positions, prefill writes a prompt at its offset and each decode
step appends one row per slot at ``positions[slot]``. ``SlotKVCache`` holds
K/V in the model's dtype; ``QSlotKVCache`` (kvcache.py:62) holds them as
int8 rows with one bf16 scale per (slot, head, position) in ``ks``/``vs``.
There is no int4 slot format: the JAX engine refuses it (engine.py:1176).

Each slot cache class offers the model the per-layer operations the paged
pool classes do (``ops.paged``): ``write``, ``append``, ``stored``,
``read`` and ``planes``, so the model never branches on the layout.

The writes and appends drop what lies outside the cache, as the JAX ones
do: a slot row outside ``[0, Slots)`` or a position outside ``[0, Smax)``.
They work without a host sync (no boolean-mask index, no ``.item()``): a
dropped row is aimed at a clamped location inside the cache and carries the
value that location ends the call with, so it rewrites what is there. On
the card the appends are one kernel launch per layer for both planes
(``ops.cuda.kv_append``: G, and G-q for the int8 cache, which the TPU ran
as XLA).
Unlike the JAX package, whose arrays are immutable, the port writes IN
PLACE: ``cache.k[l]`` is a view, and the writes update it.

The int8 row format, bit for bit that of the JAX package, is shared with
the int8 paged pool (``ops.paged.QPagedKVCache``):

- ``quantize_row``    x → (int8 q, f32 scale) over the last axis (:103)
- ``fake_quant_row``  x → what the cache stores, dequantized (:148)
- ``dequantize_view`` int8 × scales → a dense view (:162)
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from gofr_tpu_torch.ops.cuda.kv_append import kv_append_slot, kv_append_slot_q


def ieee_div(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` rounded as IEEE division, on the CPU and on the card alike.
    PyTorch's CUDA division by a Python number multiplies by its reciprocal,
    which misses the quotient by an ulp for some ``a``; the JAX package, the
    CPU and the append kernels divide.
    A 0-dim divisor on ``a``'s device takes the true division, with no copy
    from the host."""
    return a / a.new_full((), b)


def quantize_row(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over the last (head_dim) axis: (q int8, scale f32
    without the reduced axis). The scale is max(|x|, 1e-8) / 127; q is
    x / scale rounded half to even and clipped to ±127. Both divisions are
    IEEE quotients on either device (``ieee_div``)."""
    xf = x.float()
    s = ieee_div(torch.clamp(xf.abs().amax(dim=-1), min=1e-8), 127.0)
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127).to(torch.int8)
    return q, s


def fake_quant_row(x: torch.Tensor) -> torch.Tensor:
    """Round-trip ``x`` through int8 row quantization exactly as the pool
    stores it and the read path dequantizes it: the scale passes through
    the pool's bf16, and the cast/multiply order is ``dequantize_view``'s.
    Whole-prompt prefill attends to this, so a prompt attends to what a
    later read of its pages returns."""
    q, s = quantize_row(x)
    return q.to(x.dtype) * s.to(torch.bfloat16)[..., None].to(x.dtype)


def dequantize_view(cache_q: torch.Tensor, cache_s: torch.Tensor,
                    dtype: torch.dtype) -> torch.Tensor:
    """[..., S, D] quantized values × [..., S] scales → a dense ``dtype``
    view (the chunked-prefill read path; decode reads the pool itself)."""
    return cache_q.to(dtype) * cache_s[..., None].to(dtype)


# -- slot-layout writes and appends: one layer slice [Slots, Hkv, Smax, ...] ------------


def _prompt_targets(slots: torch.Tensor, b: int, s: int, num_slots: int, smax: int,
                    offsets: torch.Tensor | None):
    """Where prompt rows [B, S] land in a layer slice: (slot [B, S], position
    [B, S], source [B, S]), where source is the flat index b * S + s of the
    prompt row that location ends the call holding, or -1 if it keeps its
    own. Rows outside the cache are dropped, as JAX's ``.at[].set`` drops
    them (kvcache.py:127,186): each is aimed at its clamped location, whose
    source names the row written there, if any, so every write to one
    location carries the same value. A negative slot or position is dropped
    too (no caller passes one)."""
    dev = slots.device
    pos = torch.arange(s, device=dev)[None, :].expand(b, s)
    if offsets is not None:
        pos = pos + offsets.long()[:, None]
    row = slots.long()[:, None].expand(b, s)
    keep = (row >= 0) & (row < num_slots) & (pos >= 0) & (pos < smax)
    # one spare row and column take the dropped rows' writes
    src = torch.full((num_slots + 1, smax + 1), -1, dtype=torch.long, device=dev)
    src[torch.where(keep, row, num_slots), torch.where(keep, pos, smax)] = \
        torch.arange(b * s, device=dev).view(b, s)
    row, pos = row.clamp(0, num_slots - 1), pos.clamp(0, smax - 1)
    return row, pos, src[row, pos]


def _write_rows(layer: torch.Tensor, row: torch.Tensor, pos: torch.Tensor,
                source: torch.Tensor, new: torch.Tensor) -> None:
    """layer[row, :, pos] = new[source] where source >= 0, else what is
    there; ``new`` is [M, Hkv, ...] in the layer's dtype."""
    old = layer[row, :, pos]
    keep = (source >= 0).view(*source.shape, *[1] * (old.dim() - source.dim()))
    layer[row, :, pos] = torch.where(keep, new[source.clamp(min=0)], old)


def _lane_targets(positions: torch.Tensor, smax: int):
    """Lane n appends to slot n at ``positions[n]``: (lanes, clamped
    positions, keep [N]). A position outside [0, Smax) is dropped, as the
    JAX select lowering drops it (kvcache.py:235-239); lanes write distinct
    slots, so a dropped lane may rewrite its own clamped row."""
    pos = positions.long()
    lanes = torch.arange(pos.shape[0], device=pos.device)
    return lanes, pos.clamp(0, smax - 1), (pos >= 0) & (pos < smax)


def _append_rows(layer: torch.Tensor, lanes: torch.Tensor, pos: torch.Tensor,
                 keep: torch.Tensor, new: torch.Tensor) -> None:
    old = layer[lanes, :, pos]
    layer[lanes, :, pos] = torch.where(keep.view(-1, *[1] * (old.dim() - 1)), new, old)


def write_prompts(k_layer: torch.Tensor, v_layer: torch.Tensor, slots: torch.Tensor,
                  k_new: torch.Tensor, v_new: torch.Tensor,
                  offsets: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Write prompts (or prompt chunks at ``offsets``) [B, S, Hkv, D] into
    slot rows ``slots`` [B] of a layer slice [Slots, Hkv, Smax, D], in place
    (kvcache.py:168)."""
    b, s = k_new.shape[:2]
    row, pos, source = _prompt_targets(slots, b, s, k_layer.shape[0], k_layer.shape[2], offsets)
    for layer, new in ((k_layer, k_new), (v_layer, v_new)):
        _write_rows(layer, row, pos, source, new.reshape(b * s, *new.shape[2:]).to(layer.dtype))
    return k_layer, v_layer


def append_tokens_plain(k_layer: torch.Tensor, v_layer: torch.Tensor, positions: torch.Tensor,
                        k_new: torch.Tensor, v_new: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the slot append kernel (``ops.cuda.kv_append.
    kv_append_slot``): write one K/V row [N, Hkv, D] per slot at
    ``positions`` [N] of a layer slice [N, Hkv, Smax, D], in place; a
    position outside [0, Smax) is dropped."""
    lanes, pos, keep = _lane_targets(positions, k_layer.shape[2])
    for layer, new in ((k_layer, k_new), (v_layer, v_new)):
        _append_rows(layer, lanes, pos, keep, new.to(layer.dtype))
    return k_layer, v_layer


def append_tokens(k_layer: torch.Tensor, v_layer: torch.Tensor, positions: torch.Tensor,
                  k_new: torch.Tensor, v_new: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Append one token's K/V per slot (kvcache.py:203): the CUDA kernel for
    a cache on the card, its plain version for one on the CPU."""
    append = kv_append_slot if k_layer.is_cuda else append_tokens_plain
    return append(k_layer, v_layer, positions, k_new, v_new)


def write_prompts_q(cache_q: torch.Tensor, cache_s: torch.Tensor, slots: torch.Tensor,
                    new: torch.Tensor, offsets: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize prompts (or chunks at ``offsets``) [B, S, Hkv, D] to int8
    rows and write them into one plane [Slots, Hkv, Smax, D] and its scales
    [Slots, Hkv, Smax] at slot rows ``slots``, in place (kvcache.py:112)."""
    b, s = new.shape[:2]
    q, sc = quantize_row(new)
    row, pos, source = _prompt_targets(slots, b, s, cache_q.shape[0], cache_q.shape[2], offsets)
    _write_rows(cache_q, row, pos, source, q.reshape(b * s, *q.shape[2:]))
    _write_rows(cache_s, row, pos, source, sc.reshape(b * s, -1).to(cache_s.dtype))
    return cache_q, cache_s


def append_tokens_q(cache_q: torch.Tensor, cache_s: torch.Tensor, positions: torch.Tensor,
                    new: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize one row [N, Hkv, D] per slot to int8 and append it to one
    plane, in place (kvcache.py:132); a position outside [0, Smax) is
    dropped. The plain version of kernel G-q (``ops.cuda.kv_append.
    kv_append_slot_q``), which does both planes in one launch."""
    q, sc = quantize_row(new)
    lanes, pos, keep = _lane_targets(positions, cache_q.shape[2])
    _append_rows(cache_q, lanes, pos, keep, q)
    _append_rows(cache_s, lanes, pos, keep, sc.to(cache_s.dtype))
    return cache_q, cache_s


# -- the slot caches -----------------------------------------------------------------


class _SlotShape:
    @property
    def num_layers(self) -> int:
        return self.k.shape[0]

    @property
    def num_slots(self) -> int:
        return self.k.shape[1]

    @property
    def max_len(self) -> int:
        return self.k.shape[3]


@dataclass
class SlotKVCache(_SlotShape):
    """K/V in the model's dtype. The per-layer operations are those of
    ``ops.paged.PagedKVCache``, with slot ids [B] where the pool takes
    block-table rows, and no table at decode: lane n is slot n."""

    k: torch.Tensor  # [L, Slots, Hkv, Smax, D]
    v: torch.Tensor

    @classmethod
    def create(cls, layers: int, slots: int, max_len: int, kv_heads: int, head_dim: int,
               dtype: torch.dtype = torch.bfloat16,
               device: str | torch.device = "cpu") -> "SlotKVCache":
        shape = (layers, slots, kv_heads, max_len, head_dim)
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))

    def write(self, layer: int, slots: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
              offsets: torch.Tensor | None = None) -> None:
        write_prompts(self.k[layer], self.v[layer], slots, k_new, v_new, offsets)

    def append(self, layer: int, table: None, positions: torch.Tensor,
               k_new: torch.Tensor, v_new: torch.Tensor, *, kernels: bool = True) -> None:
        append = append_tokens if kernels else append_tokens_plain
        append(self.k[layer], self.v[layer], positions, k_new, v_new)

    @staticmethod
    def stored(x: torch.Tensor) -> torch.Tensor:
        return x

    def read(self, layer: int, slots: torch.Tensor,
             dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
        rows = slots.long()
        return self.k[layer][rows], self.v[layer][rows]

    def planes(self, layer: int, table: None = None) -> tuple[torch.Tensor, ...]:
        return self.k[layer], self.v[layer]


@dataclass
class QSlotKVCache(_SlotShape):
    """int8 K/V rows with one bf16 scale per (slot, head, position)
    (kvcache.py:62). Its append is kernel G-q for a cache on the card, and
    ``append_tokens_q`` plane by plane on the CPU or with
    ``kernels=False``; its decode attention is plain PyTorch on either
    device."""

    k: torch.Tensor   # int8 [L, Slots, Hkv, Smax, D]
    v: torch.Tensor
    ks: torch.Tensor  # bf16 [L, Slots, Hkv, Smax]
    vs: torch.Tensor

    @classmethod
    def create(cls, layers: int, slots: int, max_len: int, kv_heads: int, head_dim: int,
               device: str | torch.device = "cpu") -> "QSlotKVCache":
        shape = (layers, slots, kv_heads, max_len, head_dim)
        sshape = (layers, slots, kv_heads, max_len)
        return cls(k=torch.zeros(shape, dtype=torch.int8, device=device),
                   v=torch.zeros(shape, dtype=torch.int8, device=device),
                   ks=torch.zeros(sshape, dtype=torch.bfloat16, device=device),
                   vs=torch.zeros(sshape, dtype=torch.bfloat16, device=device))

    def _plane_pairs(self, layer: int):
        return (self.k[layer], self.ks[layer]), (self.v[layer], self.vs[layer])

    def write(self, layer: int, slots: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
              offsets: torch.Tensor | None = None) -> None:
        for (values, scales), new in zip(self._plane_pairs(layer), (k_new, v_new)):
            write_prompts_q(values, scales, slots, new, offsets)

    def append(self, layer: int, table: None, positions: torch.Tensor,
               k_new: torch.Tensor, v_new: torch.Tensor, *, kernels: bool = True) -> None:
        if kernels and self.k.is_cuda:
            kv_append_slot_q(self.k[layer], self.v[layer], self.ks[layer], self.vs[layer], positions,
                             k_new, v_new)
            return
        for (values, scales), new in zip(self._plane_pairs(layer), (k_new, v_new)):
            append_tokens_q(values, scales, positions, new)

    stored = staticmethod(fake_quant_row)

    def read(self, layer: int, slots: torch.Tensor,
             dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
        rows = slots.long()
        k, v = (dequantize_view(values[rows], scales[rows], dtype)
                for values, scales in self._plane_pairs(layer))
        return k, v

    def planes(self, layer: int, table: None = None) -> tuple[torch.Tensor, ...]:
        return self.k[layer], self.v[layer], self.ks[layer], self.vs[layer]
