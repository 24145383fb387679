"""One decode chunk of ``GenerateEngine`` (counterpart of
gofr_tpu/tpu/decode.py): plain decode steps, or speculative rounds.

The JAX engine dispatches these onto a pipeline of device calls and folds
each one when it reads it back. The port's engine is synchronous (the JAX
engine at ``pipeline_depth`` 1): each function here runs its chunk and
folds it into the slots before it returns. So a speculative round on the
paged layout claims pages for its worst case, ``pos + chunk_span - 1``, as
the JAX engine does with no round in flight (decode.py:110), and gives back
after the fold the pages that the tokens accepted did not reach
(decode.py:95, engine.py:2943); preemption then decides as the JAX engine
does. Both run on the device thread with the state lock held, and return
whether a slot changed. With the adapter plane on, each lane's adapter-pool
slot goes to the device with the other per-lane inputs (decode.py:28, 59:
the packs' ``sel`` row); a lane without an adapter, and an idle lane,
select the base slot 0.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np

from gofr_tpu_torch.gpu.programs import decode_chunk, spec_chunk

if TYPE_CHECKING:
    from gofr_tpu_torch.gpu.engine import GenerateEngine, _Slot


def decode_round(eng: GenerateEngine) -> bool:
    """``decode_chunk`` decode steps over every decoding slot (decode.py:
    265). On the paged layout each lane first gets pages for the chunk's
    writes, and the table goes out with every other row OOB: a slot
    mid-chunked-prefill owns real pages that an idle lane's write at
    position 0 would corrupt."""
    lanes, changed = eng._decoding_lanes(eng.decode_chunk)
    if not lanes:
        return changed
    n = eng.num_slots
    tokens = np.zeros(n, np.int64)
    positions = np.full(n, eng._idle_position, np.int64)
    temps = np.zeros(n, np.float32)
    sel = np.zeros(n, np.int64)
    for i, s in lanes:
        tokens[i], positions[i], temps[i] = s.generated[-1], s.pos, s.temperature
        sel[i] = s.adapter_slot
    out = decode_chunk(
        eng.model, eng.cache, eng._to_device(tokens), eng._to_device(positions),
        None if eng._table is None else eng._to_device(eng._masked_table(lanes)),
        eng._to_device(temps), eng.decode_chunk, eng._generator, top_k=eng.top_k,
        top_p=eng.top_p, do_sample=bool(temps.max() > 0), adapters=eng._adapter_args(sel),
    ).cpu().numpy()
    for i, s in lanes:
        for tok in out[i]:
            s.generated.append(int(tok))
            s.pos += 1
            eng._emit(s, int(tok))
            if eng._maybe_finish(i):
                break
    return True


def spec_round(eng: GenerateEngine) -> bool:
    """``decode_chunk`` speculative rounds over every decoding slot
    (``dispatch_spec`` / ``dispatch_spec_paged``, decode.py:110-264, with
    the fold). A lane's input token is its last one and its history length
    ``pos + 1``; a lane that does not decode passes a length past the
    history (and, on the paged layout, an all-OOB table row), so its writes
    drop."""
    lanes, changed = eng._decoding_lanes(eng.chunk_span)
    if not lanes:
        return changed
    n = eng.num_slots
    idle = (eng.pages_per_slot * eng.page_size if eng._table is not None
            else eng.cache_len) + 1
    tokens = np.zeros(n, np.int64)
    hlen = np.full(n, idle, np.int64)
    temps = np.zeros(n, np.float32)
    sel = np.zeros(n, np.int64)
    for i, s in lanes:
        tokens[i], hlen[i], temps[i] = s.generated[-1], s.pos + 1, s.temperature
        sel[i] = s.adapter_slot
    toks, accs = spec_chunk(
        eng.model, eng.cache, eng._aux, eng._to_device(tokens), eng._to_device(hlen),
        None if eng._table is None else eng._to_device(eng._masked_table(lanes)),
        eng._to_device(temps), eng.decode_chunk, eng.spec_tokens, eng._generator,
        top_k=eng.top_k, top_p=eng.top_p, adapters=eng._adapter_args(sel))
    fold_spec(eng, toks.cpu().numpy(), accs.cpu().numpy(), lanes)
    return True


def fold_spec(eng: GenerateEngine, toks: np.ndarray, accs: np.ndarray,
              lanes: list[tuple[int, _Slot]]) -> None:
    """Replay a chunk's rounds into the slots (``_fold_spec``, decode.py:
    39): ``toks`` [K, n, g+1], ``accs`` [K, n]. A lane emits acc + 1 tokens
    a round until EOS or its length ends it, and the rest of the chunk is
    dropped. Every lane is charged K * g proposals and credited each
    round's accepts up to the round that ends it, as the JAX engine counts
    them, in the engine's counters and on its request (which
    ``spec_accept_totals`` sums by adapter when it completes). A paged lane
    that goes on decoding gives back the pages past its next write."""
    k, g = accs.shape[0], eng.spec_tokens
    accepted = trimmed = 0
    for i, s in lanes:
        kw = s.request.kw
        kw["_spec_proposed"] = kw.get("_spec_proposed", 0) + k * g
        for kk in range(k):
            a = int(accs[kk, i])
            accepted += a
            kw["_spec_accepted"] = kw.get("_spec_accepted", 0) + a
            for tok in toks[kk, i, :a + 1]:
                s.generated.append(int(tok))
                s.pos += 1
                eng._emit(s, int(tok))
                if eng._maybe_finish(i):
                    break
            if eng.slots[i] is not s:
                break
        if eng._table is not None and eng.slots[i] is s:
            trimmed += eng._trim_lane_pages(i, max(s.pos - 1, 0))
    proposed = k * g * len(lanes)
    eng.counters["spec_proposed"] += proposed
    eng.counters["spec_accepted"] += accepted
    eng.counters["spec_rejected"] += proposed - accepted
    eng.counters["spec_pages_trimmed"] += trimmed
    eng.counters["spec_rounds"] += k
