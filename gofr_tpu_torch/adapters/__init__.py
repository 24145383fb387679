"""Multi-LoRA adapters: the host registry and the device pool (counterpart
of gofr_tpu/adapters/__init__.py).

Many fine-tuned variants of one base model share one engine: each lane of
a step gathers its adapter's factors out of a device pool, so one step
serves a batch that mixes adapters (``ops/lora.py`` holds the math and its
exactness contract). Two tiers:

- **Host tier**, :class:`AdapterRegistry`: the registered specs (numpy
  factors) within a host budget, which never evicts (an adapter that was
  registered and then dropped would turn requests into errors:
  registration past the budget raises instead), and each adapter's cap on
  requests in flight (429 past it).
- **Device tier**, :class:`AdapterPool`: ``S`` fixed-shape pool slots on
  the device, referenced by the engine slots decoding with each adapter,
  evicted least recently used at zero references (eviction forgets the
  device copy; the next acquire uploads again). Slot 0 is the all-zeros
  base adapter that lanes without an adapter select.

The pool's tensors go to every step as arguments, so an upload or an
eviction changes data, never a shape.
"""

from __future__ import annotations

import hashlib
import threading
from dataclasses import dataclass

import numpy as np
import torch

from gofr_tpu_torch.gpu.device import resolve_device
from gofr_tpu_torch.http.errors import TooManyRequests

__all__ = [
    "AdapterPool",
    "AdapterRegistry",
    "AdapterSpec",
    "random_adapter",
]


@dataclass
class AdapterSpec:
    """One registered LoRA adapter (a host-tier record, adapters:53).

    ``a`` is the down-projection ``[embed, rank]`` and ``b`` the
    up-projection ``[rank, vocab]`` (LoRA at the head, ``ops/lora.py``);
    ``scale`` is the usual alpha / rank. ``max_concurrency`` caps its
    submitted but unfinished requests (0 = no cap)."""

    name: str
    a: np.ndarray
    b: np.ndarray
    scale: float = 1.0
    max_concurrency: int = 0

    def __post_init__(self):
        self.a = np.asarray(self.a, np.float32)
        self.b = np.asarray(self.b, np.float32)
        if self.a.ndim != 2 or self.b.ndim != 2 or self.a.shape[1] != self.b.shape[0]:
            raise ValueError(
                f"adapter {self.name!r}: a must be [embed, rank] and b "
                f"[rank, vocab] with matching rank; got {self.a.shape} / "
                f"{self.b.shape}")

    @property
    def rank(self) -> int:
        return int(self.a.shape[1])

    @property
    def nbytes(self) -> int:
        return int(self.a.nbytes + self.b.nbytes)


def random_adapter(name: str, embed: int, vocab: int, *, rank: int = 4,
                   scale: float = 1.0, seed: int = 0, **kw) -> AdapterSpec:
    """A random adapter from ``seed`` for tests, examples and the smoke run
    (adapters:89): the JAX package's numpy draws, so both packages build the
    same factors from the same seed. Magnitudes ~1e-1, so deltas move the
    logits without drowning them."""
    rng = np.random.default_rng(seed)
    return AdapterSpec(
        name=name,
        a=rng.standard_normal((embed, rank)).astype(np.float32) * 0.1,
        b=rng.standard_normal((rank, vocab)).astype(np.float32) * 0.1,
        scale=scale, **kw)


class AdapterRegistry:
    """The host tier (adapters:101): registration, the host budget, the
    per-adapter caps on requests in flight. Thread-safe: registration comes
    from callers, ``admit`` from ``submit``, lookups from the device
    thread."""

    def __init__(self, host_budget_mb: float = 256.0):
        self.host_budget_bytes = int(host_budget_mb * (1 << 20))
        self._specs: dict[str, AdapterSpec] = {}
        self._inflight: dict[str, int] = {}
        self._lock = threading.Lock()

    def register(self, spec: AdapterSpec, pool: "AdapterPool | None" = None) -> None:
        """Admit ``spec`` into the host tier. Raises when the host budget
        would overflow, or when it replaces an adapter that lanes of
        ``pool`` still reference (new weights under a request in flight
        would mix adapters within it)."""
        with self._lock:
            current = self._specs.get(spec.name)
            total = sum(s.nbytes for n, s in self._specs.items()
                        if n != spec.name) + spec.nbytes
            if total > self.host_budget_bytes:
                raise ValueError(
                    f"adapter {spec.name!r} ({spec.nbytes >> 20} MiB) would "
                    f"overflow the adapter host budget "
                    f"({self.host_budget_bytes >> 20} MiB); registered "
                    f"adapters are never evicted: raise the budget or "
                    f"unregister first")
            if current is not None and pool is not None:
                pool.invalidate(spec.name)  # raises while lanes reference it
            self._specs[spec.name] = spec

    def unregister(self, name: str, pool: "AdapterPool | None" = None) -> None:
        with self._lock:
            if pool is not None:
                pool.invalidate(name)
            self._specs.pop(name, None)

    def get(self, name: str) -> AdapterSpec:
        with self._lock:
            spec = self._specs.get(name)
        if spec is None:
            raise KeyError(f"unknown adapter {name!r}; registered: "
                           f"{sorted(self._specs)}")
        return spec

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._specs)

    def digest(self) -> str:
        """Order-independent fingerprint of the registered set (names,
        ranks, scales; not the factors' bytes), for a handoff peer to check
        it agrees on which adapters exist."""
        h = hashlib.blake2b(digest_size=8)
        with self._lock:
            for name in sorted(self._specs):
                s = self._specs[name]
                h.update(f"{name}:{s.rank}:{s.scale:.6g}\n".encode())
        return h.hexdigest()

    def admit(self, name: str) -> AdapterSpec:
        """Resolve ``name`` and take one share of its cap. Raises
        ``KeyError`` for an unknown adapter and ``TooManyRequests`` (429) at
        the cap; the share goes back through :meth:`release` when the
        request completes."""
        spec = self.get(name)
        if spec.max_concurrency:
            with self._lock:
                if self._inflight.get(name, 0) >= spec.max_concurrency:
                    raise TooManyRequests(
                        f"adapter {name!r} at its concurrency cap "
                        f"({spec.max_concurrency})", retry_after=1.0)
                self._inflight[name] = self._inflight.get(name, 0) + 1
        return spec

    def release(self, name: str) -> None:
        with self._lock:
            if name in self._inflight:
                self._inflight[name] = max(0, self._inflight[name] - 1)

    def stats(self) -> dict:
        with self._lock:
            return {
                "registered": len(self._specs),
                "host_bytes": sum(s.nbytes for s in self._specs.values()),
                "host_budget_bytes": self.host_budget_bytes,
                "inflight": {k: v for k, v in self._inflight.items() if v},
            }


class AdapterPool:
    """The device tier (adapters:199): ``slots`` fixed-shape pool entries.

    The device state is three f32 tensors, ``a [S, E, R]``, ``b [S, R, V]``
    and ``scale [S]``, on ``device`` (the card unless the caller names the
    CPU). The slot map, references and LRU ticks are host bookkeeping under
    the engine's state lock: acquire and release happen where KV pages are
    claimed and freed. Ranks up to ``rank`` fit; a shorter one is
    zero-padded on upload, which adds exact zeros to the delta.

    An upload stages the padded factors in pinned host memory and copies
    them with ``non_blocking=True``, so it never waits on the card; the
    staging buffers stay with their pool slot until the slot's next upload
    (PyTorch's pinned-memory allocator also holds a freed buffer until the
    copies that read it have run)."""

    BASE_SLOT = 0

    def __init__(self, slots: int, embed: int, vocab: int, rank: int, *,
                 device: str | torch.device | None = None):
        if slots < 2:
            raise ValueError("adapter pool needs >= 2 slots (slot 0 is the "
                             "reserved base-model slot)")
        self.device = resolve_device(device)
        self.slots, self.embed, self.vocab, self.rank = slots, embed, vocab, rank
        f32 = dict(dtype=torch.float32, device=self.device)
        self.a = torch.zeros((slots, embed, rank), **f32)
        self.b = torch.zeros((slots, rank, vocab), **f32)
        self.scale = torch.zeros((slots,), **f32)
        self._staged: dict[int, tuple[torch.Tensor, ...]] = {}
        self._slot_of: dict[str, int] = {}
        self._name_of: dict[int, str] = {}
        self._refs = [0] * slots
        self._tick = 0
        self._lru = [0] * slots
        self.uploads = 0
        self.evictions = 0

    @property
    def pool_bytes(self) -> int:
        return int(self.a.nbytes + self.b.nbytes + self.scale.nbytes)

    @classmethod
    def slots_for_budget(cls, pool_mb: float, embed: int, vocab: int,
                         rank: int) -> int:
        """How many pool slots fit in ``pool_mb`` MiB of f32 factors."""
        per_slot = 4 * (embed * rank + rank * vocab)
        return max(2, int(pool_mb * (1 << 20)) // max(1, per_slot))

    def acquire(self, spec: AdapterSpec) -> int | None:
        """Pin ``spec`` into a pool slot (uploading it if it is not
        resident) and take one reference. Returns the slot, or None when
        every slot is referenced by a live lane: the caller requeues the
        request, as on KV page exhaustion."""
        slot = self._slot_of.get(spec.name)
        if slot is None:
            slot = self._pick_victim()
            if slot is None:
                return None
            self._upload(slot, spec)
        self._refs[slot] += 1
        self._tick += 1
        self._lru[slot] = self._tick
        return slot

    def release(self, slot: int) -> None:
        """Drop one reference. Slot 0, the base adapter, is never counted."""
        if slot != self.BASE_SLOT and self._refs[slot] > 0:
            self._refs[slot] -= 1

    def invalidate(self, name: str) -> None:
        """Forget the device copy of ``name`` (its weights are replaced or
        it is unregistered). Raises while lanes still reference it."""
        slot = self._slot_of.get(name)
        if slot is None:
            return
        if self._refs[slot] > 0:
            raise ValueError(
                f"adapter {name!r} has {self._refs[slot]} in-flight "
                f"lane(s); drain before replacing its weights")
        self._forget(slot)

    def _pick_victim(self) -> int | None:
        best, best_tick = None, None
        for s in range(1, self.slots):
            if self._refs[s]:
                continue
            if s not in self._name_of:       # an empty slot: take it at once
                return s
            if best_tick is None or self._lru[s] < best_tick:
                best, best_tick = s, self._lru[s]
        if best is not None:
            self._forget(best)
            self.evictions += 1
        return best

    def _forget(self, slot: int) -> None:
        name = self._name_of.pop(slot, None)
        if name is not None:
            self._slot_of.pop(name, None)

    def _upload(self, slot: int, spec: AdapterSpec) -> None:
        r = spec.rank
        if r > self.rank:
            raise ValueError(
                f"adapter {spec.name!r} rank {r} exceeds the pool rank "
                f"{self.rank} (adapter_rank)")
        pin = self.device.type == "cuda"
        a = torch.zeros((self.embed, self.rank), dtype=torch.float32, pin_memory=pin)
        b = torch.zeros((self.rank, self.vocab), dtype=torch.float32, pin_memory=pin)
        scale = torch.full((1,), spec.scale, dtype=torch.float32, pin_memory=pin)
        a[:, :r] = torch.from_numpy(spec.a)
        b[:r] = torch.from_numpy(spec.b)
        self.a[slot].copy_(a, non_blocking=pin)
        self.b[slot].copy_(b, non_blocking=pin)
        self.scale[slot:slot + 1].copy_(scale, non_blocking=pin)
        self._staged[slot] = (a, b, scale)
        self._slot_of[spec.name] = slot
        self._name_of[slot] = spec.name
        self.uploads += 1

    def stats(self) -> dict:
        return {
            "slots": self.slots,
            "resident": len(self._slot_of),
            "referenced": sum(1 for s in range(1, self.slots) if self._refs[s]),
            "rank": self.rank,
            "pool_bytes": self.pool_bytes,
            "uploads": self.uploads,
            "evictions": self.evictions,
        }
