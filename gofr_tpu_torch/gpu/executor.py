"""Device dispatch of ``GenerateEngine`` (counterpart of
gofr_tpu/tpu/executor.py): batched and chunked prefill, and the prefix
cache's host tier, its swap-ins and spills. The decode half (decode chunks,
speculative rounds, and the fold of every entry) is ``gpu/decode.py``.

Every device call the engine makes rides one bounded in-flight queue,
``eng._dq``, as an ``Entry``. A dispatch copies its results (token ids,
never logits) to the host behind the call and returns at once;
``decode.process_decode`` later takes the oldest entry, waits for its copy
and folds it into the slots, while every younger call runs on the card.

On the card each readback is a non-blocking copy into pinned host memory
followed by a CUDA event (``Readback``): the fold waits on that event
alone, so an older entry's readback never waits for the calls queued after
it (``.cpu()``, ``.tolist()`` and ``.item()`` would: they wait for the
whole stream). Host inputs go up the same way (``to_device``): staged in
pinned memory and copied without blocking. The pinned buffers come from
PyTorch's caching host allocator, which records an event on each
non-blocking copy and reuses a block only once that event has passed, so a
buffer is never rewritten under a copy still in flight (the hazard the JAX
engine's ``STAGING_RING`` guards, engine.py:2666-2695). On the CPU the same
code reduces to plain copies, and each call has run when it returns.

Every call goes on the current stream, in dispatch order: that order is
what keeps a page freed while an older call is in flight, then handed to
another slot, from being written before the old call's writes, and a
swap-in ahead of the tail chunk that reads its pages (JAX gets the same
from the data dependencies on its donated cache).

Locking, as in the JAX executor: the scheduler (``gpu/engine.py``)
snapshots what a dispatch needs into a plan under the state lock; the
dispatch runs outside it, on the engine's device thread.
"""

from __future__ import annotations

import time
from typing import TYPE_CHECKING, Any

import numpy as np
import torch

from gofr_tpu_torch.gpu.planner import next_bucket
from gofr_tpu_torch.gpu.programs import prefill_chunk, prefill_sample
from gofr_tpu_torch.ops.paged import swap_in_pages

if TYPE_CHECKING:
    from gofr_tpu_torch.gpu.engine import GenerateEngine, _Slot


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` without a host sync: on the card it is
    staged in pinned memory and copied without blocking (a pageable copy
    would wait for the whole stream)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class Readback:
    """Device results on their way to the host: on the card, a
    non-blocking copy of each into pinned memory and an event recorded
    after the copies; on the CPU, plain copies. ``wait`` blocks on the event
    alone, then hands the host tensors over. With no tensors it is a marker
    that the work dispatched before it has run."""

    __slots__ = ("host", "event")

    def __init__(self, device: torch.device, *tensors: torch.Tensor):
        if device.type == "cuda":
            self.host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
            for h, t in zip(self.host, tensors):
                h.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = [t.detach().clone() for t in tensors]
            self.event = None

    def wait(self) -> list[torch.Tensor]:
        if self.event is not None:
            self.event.synchronize()
        return self.host


class Entry:
    """One device call in flight on ``eng._dq``: its kind ("prefill",
    "chunk", "swapin", "plain" or "spec"), its ``Readback``, what its fold
    needs (``meta``) and the monotonic time it was dispatched."""

    __slots__ = ("kind", "result", "meta", "t0")

    def __init__(self, kind: str, result: Readback, meta: Any, t0: float):
        self.kind, self.result, self.meta, self.t0 = kind, result, meta, t0


def enqueue(eng: GenerateEngine, entry: Entry) -> None:
    """Put a dispatched call on the in-flight queue and count it."""
    eng._dq.append(entry)
    st = eng._pipeline
    st["dq_max"] = max(st["dq_max"], len(eng._dq))
    st["dispatched"][entry.kind] = st["dispatched"].get(entry.kind, 0) + 1


class PrefillPlan:
    """One batched prefill, taken under the state lock by
    ``engine._admit_prefill`` (executor.py:52): the claimed (slot index,
    slot) pairs in batch order, the plan's length bucket (the width of the
    token history's seed) and, on the paged layout, a copy of their table
    rows."""

    __slots__ = ("batch", "len_bucket", "table_rows", "t0")

    def __init__(self, batch: list[tuple[int, _Slot]], len_bucket: int,
                 table_rows: np.ndarray | None, t0: float):
        self.batch, self.len_bucket, self.table_rows, self.t0 = batch, len_bucket, table_rows, t0


class ChunkPlan:
    """One prefill chunk, taken under the state lock by
    ``engine._advance_chunked`` (executor.py:73): the slot and its index, the
    chunk's length and offset, whether it ends the prompt, and its rows (a
    copy of the table row, or the slot id)."""

    __slots__ = ("idx", "slot", "chunk", "offset", "last", "rows", "t0")

    def __init__(self, idx: int, slot: _Slot, chunk: int, offset: int, last: bool,
                 rows: np.ndarray, t0: float):
        self.idx, self.slot, self.chunk, self.offset = idx, slot, chunk, offset
        self.last, self.rows, self.t0 = last, rows, t0


def dispatch_prefill(eng: GenerateEngine, plan: PrefillPlan) -> None:
    """Dispatch one batched prefill (executor.py:95): the batch padded to
    its longest prompt, the first token of each row left on the queue for
    ``engine._fold_prefill``. The slot ids are the rows on the slot layout,
    and the proposer's rows; the history takes the padding of the plan's
    length bucket, as the JAX program writes it (programs.seed_history)."""
    batch = plan.batch
    tokens = np.zeros((len(batch), max(s.prompt_len for _, s in batch)), np.int64)
    for row, (_, s) in enumerate(batch):
        tokens[row, :s.prompt_len] = s.prompt_tokens
    temps = np.array([s.temperature for _, s in batch], np.float32)
    idxs = np.array([i for i, _ in batch], np.int64)
    dev = eng.device
    slot_ids = to_device(idxs, dev) if plan.table_rows is None or eng._aux is not None else None
    first = prefill_sample(
        eng.model, eng.cache, to_device(tokens, dev),
        to_device(np.array([s.prompt_len for _, s in batch], np.int64), dev),
        slot_ids if plan.table_rows is None else to_device(plan.table_rows, dev),
        to_device(temps, dev), eng._generator, top_k=eng.top_k, top_p=eng.top_p,
        do_sample=bool(temps.max() > 0), aux=eng._aux, slots=slot_ids, width=plan.len_bucket,
        adapters=eng._adapter_args(np.array([s.adapter_slot for _, s in batch])))
    enqueue(eng, Entry("prefill", Readback(dev, first), batch, plan.t0))


def dispatch_chunk(eng: GenerateEngine, plan: ChunkPlan) -> None:
    """Dispatch one prefill chunk (executor.py:148); the last chunk's
    sampled token rides the queue to ``engine._fold_chunk``, an earlier
    chunk's entry only marks that it has run."""
    s, offset, chunk = plan.slot, plan.offset, plan.chunk
    dev = eng.device
    tok = prefill_chunk(
        eng.model, eng.cache, to_device(s.prompt_tokens[None, offset:offset + chunk], dev),
        to_device(np.array([offset], np.int64), dev), to_device(plan.rows, dev),
        to_device(np.array([s.temperature], np.float32), dev), eng._generator, plan.last,
        top_k=eng.top_k, top_p=eng.top_p, do_sample=s.temperature > 0, aux=eng._aux,
        slots=None if eng._aux is None else to_device(np.array([plan.idx], np.int64), dev),
        width=next_bucket(chunk, eng.prefill_buckets),
        adapters=eng._adapter_args(np.array([s.adapter_slot])))
    result = Readback(dev) if tok is None else Readback(dev, tok)
    enqueue(eng, Entry("chunk", result, (plan.idx, s, chunk, offset, plan.last), plan.t0))


def dispatch_swapins(eng: GenerateEngine) -> bool:
    """Dispatch one upload per prefix hit that ``engine._prefix_hit``
    staged (executor.py:183): the hit's host pages, stacked per plane on
    the card, written into the pages it claimed (``ops.paged.
    swap_in_pages``). The pages were claimed and the nodes promoted at the
    hit; ``engine._fold_swapin`` settles the nodes. Each upload is timed on
    the card by a pair of events (on the CPU by the host clock, the copy
    being done when it returns). Every id is a pool page, so none is
    padded. Returns whether one was dispatched."""
    items, eng._pending_swapins = eng._pending_swapins, []
    dev = eng.device
    for idx, slot, keys, pids, payloads in items:
        t0 = time.monotonic()
        if dev.type == "cuda":
            timer: Any = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            timer[0].record()
        else:
            timer = time.perf_counter()
        stacks = [torch.stack([page[p].to(dev, non_blocking=True) for page in payloads], dim=1)
                  for p in range(len(payloads[0]))]
        swap_in_pages(eng.cache, to_device(np.asarray(pids, np.int64), dev), stacks)
        if dev.type == "cuda":
            timer[1].record()
        else:
            timer = time.perf_counter() - timer
        nbytes = len(pids) * eng._page_bytes
        enqueue(eng, Entry("swapin", Readback(dev),
                           (idx, slot, keys, len(pids), nbytes, timer), t0))
    return bool(items)


def swapin_seconds(timer: Any) -> float:
    """The upload's time: the events' interval on the card (both have run
    once its entry's readback has), the host clock's on the CPU."""
    if isinstance(timer, tuple):
        return timer[0].elapsed_time(timer[1]) / 1e3
    return float(timer)


def materialize_spills(eng: GenerateEngine) -> None:
    """Move staged spills to host memory, outside the state lock
    (executor.py:229): eviction copied each spilled page on the card and
    started the copy to pinned host memory, and left the node holding the
    device copy; here the device thread waits for the host copy and swaps
    it in. A node dropped or promoted in between keeps what it has."""
    items, eng._pending_spills = eng._pending_spills, []
    for key, staged in items:
        host = tuple(staged.wait())
        with eng._state_lock:
            if eng._prefix is not None:
                eng._prefix.replace_host_payload(key, host)
