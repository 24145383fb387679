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

With the perf plane on (``eng.perf``), each dispatch prices its call from
host state alone (prompt lengths, chunk offsets, bytes uploaded) into a
``StepPerf`` that rides the entry; the fold stamps its ready time where
the readback's wait returns.

``warmup`` is the body of ``GenerateEngine.warmup`` (executor.py:258
``warmup_compile``): every call the engine can dispatch, once at each shape
the planner can pick, on rows that are all out of bounds.
"""

from __future__ import annotations

import time
from typing import TYPE_CHECKING, Any

import numpy as np
import torch

from gofr_tpu_torch.gpu.planner import next_bucket, pow2_buckets
from gofr_tpu_torch.gpu.programs import (
    Draft,
    decode_chunk,
    prefill_chunk,
    prefill_sample,
    spec_chunk,
)
from gofr_tpu_torch.metrics.perf import StepPerf
from gofr_tpu_torch.ops import cuda
from gofr_tpu_torch.ops.paged import gather_page, page_planes, swap_in_pages

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
    that the work dispatched before it has run. A ``timed`` readback also
    records an event before its copies, so ``seconds`` gives the copies'
    time on the card (the host clock's on the CPU)."""

    __slots__ = ("host", "event", "start", "cpu_s")

    def __init__(self, device: torch.device, *tensors: torch.Tensor, timed: bool = False):
        self.start, self.cpu_s = None, 0.0
        if device.type == "cuda":
            self.host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
            if timed:
                # after the pinned buffers exist: a first use allocates them
                # on the host, which must not count as the copies' time
                self.start = torch.cuda.Event(enable_timing=True)
                self.start.record()
            for h, t in zip(self.host, tensors):
                h.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event(enable_timing=timed)
            self.event.record()
        else:
            t0 = time.perf_counter()
            self.host = [t.detach().clone() for t in tensors]
            self.event = None
            self.cpu_s = time.perf_counter() - t0

    def wait(self) -> list[torch.Tensor]:
        if self.event is not None:
            self.event.synchronize()
        return self.host

    def seconds(self) -> float:
        """A timed readback's copy time, once ``wait`` has returned."""
        if self.start is not None:
            return self.start.elapsed_time(self.event) / 1e3
        return self.cpu_s


class Entry:
    """One device call in flight on ``eng._dq``: its kind ("prefill",
    "chunk", "swapin", "plain" or "spec"), its ``Readback``, what its fold
    needs (``meta``), the monotonic time it was dispatched, its batch
    occupancy and signature (the flight recorder's step entry, as the JAX
    queue's entries carry them) and its perf-plane record (None with the
    plane off)."""

    __slots__ = ("kind", "result", "meta", "t0", "occupancy", "sig", "pstep")

    def __init__(self, kind: str, result: Readback, meta: Any, t0: float,
                 occupancy: float = 1.0, sig: tuple = (), pstep: StepPerf | None = None):
        self.kind, self.result, self.meta, self.t0 = kind, result, meta, t0
        self.occupancy, self.sig, self.pstep = occupancy, sig, pstep


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
    token history's seed) and batch bucket (the occupancy's denominator,
    as the JAX batch is padded to it) and, on the paged layout, a copy of
    their table rows."""

    __slots__ = ("batch", "len_bucket", "batch_bucket", "table_rows", "t0")

    def __init__(self, batch: list[tuple[int, _Slot]], len_bucket: int, batch_bucket: int,
                 table_rows: np.ndarray | None, t0: float):
        self.batch, self.len_bucket, self.batch_bucket = batch, len_bucket, batch_bucket
        self.table_rows, self.t0 = table_rows, t0


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
    pstep = (eng.perf.step_prefill(sum(s.prompt_len for _, s in batch), plan.t0)
             if eng.perf is not None else None)
    enqueue(eng, Entry("prefill", Readback(dev, first), batch, plan.t0,
                       len(batch) / plan.batch_bucket,
                       ("prefill", plan.len_bucket, plan.batch_bucket), pstep))


def dispatch_chunk(eng: GenerateEngine, plan: ChunkPlan) -> None:
    """Dispatch one prefill chunk (executor.py:148); the last chunk's
    sampled token rides the queue to ``engine._fold_chunk``, an earlier
    chunk's entry only marks that it has run."""
    s, offset, chunk = plan.slot, plan.offset, plan.chunk
    lb = next_bucket(chunk, eng.prefill_buckets)
    dev = eng.device
    tok = prefill_chunk(
        eng.model, eng.cache, to_device(s.prompt_tokens[None, offset:offset + chunk], dev),
        to_device(np.array([offset], np.int64), dev), to_device(plan.rows, dev),
        to_device(np.array([s.temperature], np.float32), dev), eng._generator, plan.last,
        top_k=eng.top_k, top_p=eng.top_p, do_sample=s.temperature > 0, aux=eng._aux,
        slots=None if eng._aux is None else to_device(np.array([plan.idx], np.int64), dev),
        width=lb, adapters=eng._adapter_args(np.array([s.adapter_slot])))
    result = Readback(dev) if tok is None else Readback(dev, tok)
    pstep = eng.perf.step_chunk(chunk, offset, plan.t0) if eng.perf is not None else None
    enqueue(eng, Entry("chunk", result, (plan.idx, s, chunk, offset, plan.last), plan.t0,
                       chunk / lb, ("prefill_chunk", lb, 1), pstep))


def dispatch_swapins(eng: GenerateEngine) -> bool:
    """Dispatch one upload per prefix hit that ``engine._prefix_hit``
    staged (executor.py:183): the hit's host pages, stacked per plane on
    the card, written into the pages it claimed (``ops.paged.
    swap_in_pages``). The pages were claimed and the nodes promoted at the
    hit; ``engine._fold_swapin`` settles the nodes. Each upload is timed on
    the card by a pair of events (on the CPU by the host clock, the copy
    being done when it returns). Every id is a pool page, so none is
    padded (JAX pads the upload to a bucket of pages, so its occupancy
    falls below 1 and its bytes count the padding). Returns whether one
    was dispatched."""
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
        pstep = eng.perf.step_swapin(nbytes, t0) if eng.perf is not None else None
        enqueue(eng, Entry("swapin", Readback(dev), (idx, slot, keys, len(pids), nbytes, timer),
                           t0, 1.0, ("swapin", len(pids)), pstep))
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


def gather_pages(eng: GenerateEngine, pages: list[int]) -> list[Readback]:
    """Copy each pool page of ``pages`` out for a KV handoff (executor.py:245
    ``gather_pages``): one ``ops.paged.gather_page`` clone a page and a timed
    ``Readback`` of it into pinned memory, dispatched and never waited on.
    The caller holds the state lock: the pool is written in place, so the
    clones must be enqueued on the stream before any later call can reuse a
    page (JAX's functional updates give it that for free); the exporter
    waits on the readbacks outside every engine lock. Each page arrives as
    a host-tier payload, one tensor per plane, [L, ...]."""
    return [Readback(eng.device, *gather_page(eng.cache, p), timed=True) for p in pages]


def warmup(eng: GenerateEngine, lbs: list[int], bbs: list[int]) -> int:
    """Run every call the engine can dispatch once, as JAX's
    ``warmup_compile`` (executor.py:258-381) compiles each program, and
    return how many: a batched prefill at each length bucket x batch bucket;
    a chunk at each length bucket (both layouts chunk); one decode chunk,
    or one speculative round with ``spec_tokens``; and with the prefix
    cache's host tier, a page gather and an upload at each swap-in width
    of JAX's ladder (powers of two up to ``pages_per_slot``). Scoped by the
    engine's role, as JAX's: a prefill worker skips the decode chunk (and
    warms the page gather its handoff export makes, host tier or not), a
    decode worker the batched-prefill ladder; both keep the chunks (the
    decode side prefills what a handed-off prefix leaves through them). On
    the card the kernel library is loaded (built where stale) first.

    What the calls cost the first time (the library, cuBLAS's handles and
    heuristics per shape, the caching allocator's growth, pinned staging)
    is paid here and not by the first requests. Nothing live is touched:
    every prefill and chunk row goes through an out-of-bounds table row
    (paged) or slot id (slot), whose writes the source maps drop; every
    decode lane is masked as an idle lane is (an all-OOB table row at
    position 0, or the slot's end; a speculative lane's history length
    past the cache); every swap-in id is out of bounds. No carry is kept,
    and sampling draws from a generator of its own, so the engine's sampled
    streams are those of an engine never warmed. A token history is not
    seeded (its rows are slot ids, which have no out-of-bounds row); a
    draft model's slot cache is, through the same dropped rows. The engine
    runs this with nothing in flight (``GenerateEngine.warmup``)."""
    dev = eng.device
    if dev.type == "cuda":
        cuda.lib()
    gen = torch.Generator(device=dev).manual_seed(0)
    paged = eng._table is not None
    n, k = eng.num_slots, eng.decode_chunk
    draft = eng._aux if isinstance(eng._aux, Draft) else None
    sampling = dict(top_k=eng.top_k, top_p=eng.top_p, do_sample=False)

    def host(shape, value, dtype=np.int64) -> torch.Tensor:
        return to_device(np.full(shape, value, dtype), dev)

    def prompt_args(b: int) -> dict:
        """A prefill's rows (all OOB), its draft's slots (all OOB) and its
        base-adapter lanes, for a batch of ``b``."""
        rows = (host((b, eng.pages_per_slot), eng.total_pages, np.int32) if paged
                else host(b, n))
        return dict(rows=rows, temps=host(b, 0, np.float32), aux=draft,
                    slots=None if draft is None else host(b, n),
                    adapters=eng._adapter_args(np.zeros(b, np.int64)), **sampling)

    count = 0
    for lb in lbs if eng.role != "decode" else ():
        for nb in bbs:
            first = prefill_sample(eng.model, eng.cache, host((nb, lb), 0), host(nb, 1),
                                   generator=gen, width=lb, **prompt_args(nb))
            Readback(dev, first).wait()
            count += 1
    for lb in lbs:
        tok = prefill_chunk(eng.model, eng.cache, host((1, lb), 0), host(1, 0), generator=gen,
                            last=True, width=lb, **prompt_args(1))
        Readback(dev, tok).wait()
        count += 1
    table = host((n, eng.pages_per_slot), eng.total_pages, np.int32) if paged else None
    lanes = dict(table=table, temps=host(n, 0, np.float32), steps=k, generator=gen,
                 top_k=eng.top_k, top_p=eng.top_p, adapters=eng._adapter_args(np.zeros(n, np.int64)),
                 use_host=host(n, True, np.bool_))
    if eng.role != "prefill":
        if not eng.spec_tokens:
            out, _carry = decode_chunk(eng.model, eng.cache, host(n, 0),
                                       host(n, eng._idle_position), do_sample=False,
                                       prev_last=host(n, 0, np.int32), **lanes)
            Readback(dev, out).wait()
        else:
            idle = (eng.pages_per_slot * eng.page_size if paged else eng.cache_len) + 1
            toks, accs, _carry = spec_chunk(eng.model, eng.cache, eng._aux, host(n, 0),
                                            host(n, idle), g=eng.spec_tokens,
                                            carry=(host(n, 0, np.int32), host(n, 0)), **lanes)
            Readback(dev, toks, accs).wait()
        count += 1
    host_tier = paged and eng._prefix is not None and bool(eng._prefix.host_budget)
    if paged and eng._prefix is not None and (host_tier or eng.role == "prefill"):
        gather_pages(eng, [0])[0].wait()
        count += 1
    if host_tier:
        for wb in pow2_buckets(1, eng.pages_per_slot):
            payload = [torch.zeros((plane.shape[0], wb, *plane.shape[2:]), dtype=plane.dtype,
                                   pin_memory=dev.type == "cuda")
                       for plane in page_planes(eng.cache)]
            swap_in_pages(eng.cache, host(wb, eng.total_pages), payload)
            Readback(dev).wait()
            count += 1
    return count
