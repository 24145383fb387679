"""Decode dispatch and the fold of every in-flight entry for
``GenerateEngine`` (counterpart of gofr_tpu/tpu/decode.py).

The engine's device thread calls these once a loop turn. Every device call
rides the engine's one in-flight queue ``eng._dq`` (``gpu/executor.py``):
plain decode chunks and speculative rounds, dispatched here, and the
batched and chunked prefills and the prefix cache's swap-ins, dispatched by
the executor. ``process_decode`` takes the OLDEST entry, waits for its
readback while every younger call runs on the card, and folds it into the
slots.

Decode can run ahead of its readback because the state it depends on stays
on the card: the last token of a lane's chunk in flight (``eng._prev_last``)
and, for speculative rounds, the (token, history length) carry
(``eng._spec_carry``) and the token history. A lane with a chunk in flight
decodes from its speculative position ``pos + k * inflight`` and takes its
input from the carry; a lane whose speculative position reaches its length
limit is masked until its chunks fold, so no chunk writes past the slack
the cache keeps. A speculative round on the paged layout claims pages for
its worst case, ``pos + chunk_span * (inflight + 1) - 1``, and the fold
gives back what the accepted tokens did not reach once the lane has no
round in flight (decode.py:83-95, engine.py:2943).

Every dispatch plans under the state lock and calls the card outside it;
every fold waits outside it and takes it for the bookkeeping. A fold
discards a lane whose slot changed since the dispatch (freed, preempted,
reassigned), by identity. With the adapter plane on, each lane's
adapter-pool slot goes to the device with the other per-lane inputs
(decode.py:28, 59); a lane without an adapter, and an idle lane, select the
base slot 0.

Each dispatch prices its call for the perf plane from host state (lanes,
chunk length, the pages or positions its attention streams; decode.py:
191, 258, 354), and ``process_decode`` stamps the entry's ready time as
soon as its readback's wait returns (decode.py:377-380). Each fold then
records its step (``eng._record_step``: histograms, perf plane, flight
recorder) and counts its tokens and speculation as the JAX folds do.
"""

from __future__ import annotations

import time
from typing import TYPE_CHECKING

import numpy as np
import torch

from gofr_tpu_torch.gpu.executor import Entry, Readback, enqueue, to_device
from gofr_tpu_torch.gpu.programs import decode_chunk, spec_chunk

if TYPE_CHECKING:
    from gofr_tpu_torch.gpu.engine import GenerateEngine, _Slot


def dispatch_decode(eng: GenerateEngine) -> bool:
    """Dispatch one chunk of ``decode_chunk`` steps over every decoding
    lane (decode.py:266). On the paged layout each lane first gets pages
    for the chunk's writes, and the table goes out with every other row
    OOB: a slot mid-chunked-prefill owns real pages that an idle lane's
    write at position 0 would corrupt. On the slot layout an idle lane sits
    at the slot's end, where its writes drop. Returns whether a chunk was
    dispatched."""
    with eng._state_lock:
        n, k = eng.num_slots, eng.decode_chunk
        lanes = []
        for i in eng._active():
            s = eng.slots[i]
            p = s.pos + k * s.inflight
            if p >= s.max_total:
                continue  # ends when its chunks in flight fold
            lanes.append((i, s, p))
        if not lanes:
            return False
        if eng._table is not None:
            for i, s, p in list(lanes):
                eng._alloc_lane_pages(i, s, p + k - 1)
            lanes = [(i, s, p) for i, s, p in lanes if eng.slots[i] is s]
            if not lanes:
                return False
        tokens = np.zeros(n, np.int64)
        positions = np.full(n, eng._idle_position, np.int64)
        temps = np.zeros(n, np.float32)
        sel = np.zeros(n, np.int64)
        use_host = np.zeros(n, np.bool_)
        for i, s, p in lanes:
            if s.inflight == 0:
                # the host knows the lane's last token; else the carry of
                # its chunk in flight supplies it
                tokens[i], use_host[i] = s.last_token, True
            positions[i], temps[i], sel[i] = p, s.temperature, s.adapter_slot
        table = None if eng._table is None else eng._masked_table([i for i, _, _ in lanes])
        for _, s, _ in lanes:
            s.inflight += 1
        # the positions this chunk's attention streams, a dispatch-time
        # floor: pages touched on the pool, positions on the slot cache
        if eng._table is not None:
            hist = sum(len(eng._slot_pages[i]) for i, _, _ in lanes) * eng.page_size
        else:
            hist = sum(p + 1 for _, _, p in lanes)
        t0 = time.monotonic()
    dev = eng.device
    prev = eng._prev_last if eng._prev_last is not None else torch.zeros(
        n, dtype=torch.int32, device=dev)
    out, eng._prev_last = decode_chunk(
        eng.model, eng.cache, to_device(tokens, dev), to_device(positions, dev),
        None if table is None else to_device(table, dev), to_device(temps, dev), k,
        eng._generator, top_k=eng.top_k, top_p=eng.top_p, do_sample=bool(temps.max() > 0),
        adapters=eng._adapter_args(sel), prev_last=prev, use_host=to_device(use_host, dev))
    pstep = eng.perf.step_decode(len(lanes), k, hist, t0) if eng.perf is not None else None
    enqueue(eng, Entry("plain", Readback(dev, out), [(i, s) for i, s, _ in lanes], t0,
                       len(lanes) / n, ("decode", n, k), pstep))
    return True


def dispatch_spec(eng: GenerateEngine) -> bool:
    """Dispatch one chunk of ``decode_chunk`` speculative rounds on the slot
    layout (decode.py:199): per lane the input token and history length
    from the host, or (a round in flight) from the device carry. Returns
    whether a chunk was dispatched."""
    return _dispatch_spec(eng, paged=False)


def dispatch_spec_paged(eng: GenerateEngine) -> bool:
    """``dispatch_spec`` on the paged layout (decode.py:110): each lane's
    table first grows to its worst case, ``pos + chunk_span * (inflight +
    1) - 1``, since the card cannot claim pages mid-chunk and the fold that
    would narrow the estimate has not happened; ``_fold_spec`` gives the
    surplus back. Returns whether a chunk was dispatched or a claim
    preempted."""
    return _dispatch_spec(eng, paged=True)


def _dispatch_spec(eng: GenerateEngine, paged: bool) -> bool:
    """A lane that does not decode passes a history length past the
    history (and, on the paged layout, an all-OOB table row), so its writes
    drop."""
    with eng._state_lock:
        n, k, span, g = eng.num_slots, eng.decode_chunk, eng.chunk_span, eng.spec_tokens
        lanes = [(i, eng.slots[i]) for i in eng._active()
                 if eng.slots[i].pos + span * eng.slots[i].inflight < eng.slots[i].max_total]
        if not lanes:
            return False
        if paged:
            for i, s in list(lanes):
                eng._alloc_lane_pages(i, s, s.pos + span * (s.inflight + 1) - 1)
            lanes = [(i, s) for i, s in lanes if eng.slots[i] is s]
            if not lanes:
                return True  # the claims preempted
        idle = (eng.pages_per_slot * eng.page_size if paged else eng.cache_len) + 1
        tokens = np.zeros(n, np.int64)
        hlen = np.full(n, idle, np.int64)
        use_host = np.ones(n, np.bool_)
        temps = np.zeros(n, np.float32)
        sel = np.zeros(n, np.int64)
        for i, s in lanes:
            if s.inflight == 0:
                tokens[i], hlen[i] = s.last_token, s.pos + 1
            else:
                use_host[i] = False  # the device carry owns (token, hlen)
            temps[i], sel[i] = s.temperature, s.adapter_slot
        table = eng._masked_table([i for i, _ in lanes]) if paged else None
        for _, s in lanes:
            s.inflight += 1
        # the positions this round's attention streams: the pages it can
        # touch on the pool, each lane's worst case on the slot cache
        if paged:
            hist = sum(len(eng._slot_pages[i]) for i, _ in lanes) * eng.page_size
        else:
            hist = sum(min(s.pos + span * s.inflight + 1, s.max_total) for _, s in lanes)
        t0 = time.monotonic()
    dev = eng.device
    carry = eng._spec_carry
    if carry is None:
        carry = (torch.zeros(n, dtype=torch.int32, device=dev),
                 torch.zeros(n, dtype=torch.long, device=dev))
    toks, accs, eng._spec_carry = spec_chunk(
        eng.model, eng.cache, eng._aux, to_device(tokens, dev), to_device(hlen, dev),
        None if table is None else to_device(table, dev), to_device(temps, dev), k, g,
        eng._generator, top_k=eng.top_k, top_p=eng.top_p, adapters=eng._adapter_args(sel),
        carry=carry, use_host=to_device(use_host, dev))
    pstep = eng.perf.step_spec(len(lanes), k, g, hist, t0) if eng.perf is not None else None
    enqueue(eng, Entry("spec", Readback(dev, toks, accs), (lanes, g), t0, len(lanes) / n,
                       ("decode_spec", n, k, g), pstep))
    return True


def process_decode(eng: GenerateEngine) -> bool:
    """Wait for the OLDEST entry's readback, outside the state lock, and
    fold it (decode.py:361): every kind, plain and speculative decode
    chunks, batched prefills, prefill chunks and swap-ins. The wait is
    timed. Returns whether an entry was folded."""
    if not eng._dq:
        return False
    entry = eng._dq.popleft()
    t = time.perf_counter()
    host = [h.numpy() for h in entry.result.wait()]
    if entry.pstep is not None:
        # the result is on the host: from here on it is fold time, not
        # device time
        entry.pstep.t_ready = time.monotonic()
    st = eng._pipeline
    st["fold_wait_s"] += time.perf_counter() - t
    kind = entry.kind
    if kind == "swapin":
        eng._fold_swapin(entry)
    elif kind == "prefill":
        eng._fold_prefill(host[0], entry)
    elif kind == "chunk":
        eng._fold_chunk(host[0] if host else None, entry)
    else:
        with eng._state_lock:
            # attributed over the lanes dispatched: a lane freed in flight
            # still had device time spent on its behalf
            lanes = entry.meta[0] if kind == "spec" else entry.meta
            dev_s = eng._record_step("decode_spec" if kind == "spec" else "decode",
                                     time.monotonic() - entry.t0, entry.occupancy, entry.sig,
                                     entry.pstep, eng._adapter_ids([s for _, s in lanes]))
            if kind == "spec":
                _fold_spec(eng, host[0], host[1], *entry.meta, dev_s)
            else:
                _fold_plain(eng, host[0], entry.meta, dev_s)
    st["folds"] += 1  # last: a reader that sees every call folded sees its effects
    return True


def _fold_plain(eng: GenerateEngine, out: np.ndarray, lanes: list[tuple[int, _Slot]],
                dev_s: float = 0.0) -> None:
    """Hand each lane its chunk's tokens [N, k] until EOS or its length
    ends it; the rest of the chunk is dropped. Each live lane is charged
    the step's device seconds, and every token taken is counted. Caller
    holds the state lock."""
    now = time.monotonic()
    taken = 0
    for i, s in lanes:
        if eng.slots[i] is not s:
            continue  # freed, preempted or reassigned while in flight
        s.inflight -= 1
        if dev_s:
            kw = s.request.kw
            kw["_dev_decode_s"] = kw.get("_dev_decode_s", 0.0) + dev_s
        if eng._dropped(s.request, now):
            eng._free_slot(i)
            continue
        for tok in out[i]:
            _take(eng, s, int(tok))
            taken += 1
            if eng._maybe_finish(i):
                break
    eng.metrics.increment_counter("app_tpu_tokens_total", taken)


def _take(eng: GenerateEngine, s: _Slot, tok: int) -> None:
    s.generated.append(tok)
    s.last_token = tok
    s.pos += 1
    eng._emit(s, tok)


def _fold_spec(eng: GenerateEngine, toks: np.ndarray, accs: np.ndarray,
               lanes: list[tuple[int, _Slot]], g: int, dev_s: float = 0.0) -> None:
    """Replay a chunk's rounds into the slots (decode.py:39): ``toks`` [K,
    n, g+1], ``accs`` [K, n], ``g`` the round length at dispatch. A lane
    emits acc + 1 tokens a round until EOS or its length ends it, and the
    rest of the chunk is dropped. Every lane folded is charged K * g
    proposals and credited each round's accepts up to the round that ends
    it, as the JAX engine counts them, in the engine's counters and on its
    request (which ``spec_accept_totals`` sums by adapter when it
    completes); a lane discarded in flight counts on neither side. A paged
    lane that goes on decoding with no round left in flight gives back the
    pages past its next write. A folded lane is charged the round's
    device seconds, and the tokens emitted are counted. Caller holds the
    state lock."""
    k = accs.shape[0]
    now = time.monotonic()
    accepted = trimmed = folded = emitted = 0
    for i, s in lanes:
        if eng.slots[i] is not s:
            continue  # freed, preempted or reassigned while in flight
        s.inflight = max(0, s.inflight - 1)
        if eng._dropped(s.request, now):
            eng._free_slot(i)
            continue
        folded += 1
        kw = s.request.kw
        if dev_s:
            kw["_dev_decode_s"] = kw.get("_dev_decode_s", 0.0) + dev_s
        kw["_spec_proposed"] = kw.get("_spec_proposed", 0) + k * g
        for kk in range(k):
            a = int(accs[kk, i])
            accepted += a
            kw["_spec_accepted"] = kw.get("_spec_accepted", 0) + a
            for tok in toks[kk, i, :a + 1]:
                _take(eng, s, int(tok))
                emitted += 1
                if eng._maybe_finish(i):
                    break
            if eng.slots[i] is not s:
                break
        if eng._table is not None and eng.slots[i] is s and s.inflight == 0:
            # only with no round in flight: a round in flight may write any
            # page claimed at its dispatch
            trimmed += eng._trim_lane_pages(i, max(s.pos - 1, 0))
    proposed = k * g * folded
    eng.counters["spec_proposed"] += proposed
    eng.counters["spec_accepted"] += accepted
    eng.counters["spec_rejected"] += proposed - accepted
    eng.counters["spec_pages_trimmed"] += trimmed
    eng.counters["spec_rounds"] += k
    eng.metrics.increment_counter("app_tpu_tokens_total", emitted)
    eng.metrics.increment_counter("app_tpu_spec_proposed", proposed)
    eng.metrics.increment_counter("app_tpu_spec_accepted", accepted)
    if trimmed:
        eng.metrics.increment_counter("app_tpu_spec_pages_trimmed_total", trimmed)
    if proposed - accepted > 0:
        eng.metrics.increment_counter("app_tpu_spec_tokens_rejected_total", proposed - accepted)
