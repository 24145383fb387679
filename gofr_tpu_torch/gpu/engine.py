"""Continuous-batching generation over the paged KV pool or the slot KV
cache (counterpart of gofr_tpu/tpu/engine.py ``GenerateEngine`` and
``build_engine``).

A device thread owns the model, the cache and every slot. Callers
``submit`` prompts onto a queue and get a ``Request`` future back. Each
loop turn the thread, in the JAX engine's order (engine.py:3296-3386),

1. admits: moves queued requests into the pending list (a prompt longer
   than the largest prefill bucket into the chunked list), claims a free
   slot for each waiting long prompt, then lets ``plan_prefill`` (EDF plus
   bucket affinity, ``gpu/planner.py``) choose one batch of the rest and
   dispatches its prefill, padded to its longest chosen prompt; then the
   host tier's spills and swap-ins (below);
2. dispatches one chunk of the oldest-admitted long prompt, so decode keeps
   stepping between its chunks;
3. dispatches ``decode_chunk`` decode steps over every decoding slot;
4. folds the oldest calls in flight until at most ``pipeline_depth`` - 1
   remain (all of them when the turn dispatched nothing): each fold hands
   the slots their first or next tokens, until EOS or their length limit;
   a finished request frees its slot at once.

Every device call rides one in-flight queue (``gpu/executor.py``,
``gpu/decode.py``): a dispatch copies its token ids to the host behind the
call and returns, and the fold of an older call waits only for that copy
while the younger ones run on the card. At ``pipeline_depth`` 2 (the
default, as engine.py:955 has it) one call stays in flight across turns;
at 1 the turn folds each phase before the next: fully synchronous, the
operator's debugging setting. Greedy tokens are the same at every depth.
A lane whose chunk is in flight decodes on from the carry its last token
left on the card.

``kv_layout`` picks the cache. On the paged layout (the default, as
engine.py:4118 picks it for llama) pages are taken on demand: a batched
prompt gets its prompt's pages at admission (when the most urgent prompt
cannot, admission stops), a chunk gets its chunk's, and a decoding lane
grows its table before each decode chunk. When the pool runs short the
prefix cache gives up its least-recently-used pages, and then the newest
slot is preempted: freed and requeued with what it generated folded into
its prompt, to be prefilled again (preemption by recompute); its calls in
flight are discarded at their folds. Pages are refcounted, since the
prefix cache (``gpu/prefix.py``, on by default) splices a cached prompt
prefix into several slots' tables; a prompt whose hit covers at least half
of it takes the chunked path, which prefills only the rest. With
``prefix_host_mb`` > 0 the cache spills the pages it gives up to pinned
host memory instead of dropping them (engine.py:2752), and a later hit
swaps them back into fresh pages on the in-flight queue, ahead of the
chunk that reads them (engine.py:2834-2906, 3560). The decode table goes
out with every row but the decoding lanes' all OOB, so those lanes' writes
drop. On the slot layout each slot owns ``cache_len`` positions
(engine.py:1321), a request needs only a free slot, long prompts chunk
too, and lanes that do not decode sit at position ``cache_len``, so their
writes drop (tpu/decode.py:309-315).

``spec_tokens`` = g > 0 turns on speculative decoding (engine.py:1022):
step 3 becomes ``decode_chunk`` speculative rounds (``gpu/decode.py``,
``gpu/programs.spec_chunk``), each proposing g tokens per lane and
verifying them in one forward, so a round emits 1 .. g + 1 tokens. The
proposal is prompt lookup in the lane's token history, which the prefills
write on the device, or, with ``spec_draft`` (slot layout only), g + 1
steps of a small draft model on its own slot cache, which the prefills
fill too. Greedy tokens equal plain decode's; sampled ones are
distributed as plain decode's. On the paged layout a round first claims
pages for its worst case, ``pos + chunk_span * (inflight + 1) - 1``, and
gives back what the accepted tokens did not need once no round of the lane
is in flight (engine.py:2943).

``generate(stream=True)`` returns an iterator of the tokens as they are
decoded: ids, or text pieces by incremental detokenization with a
tokenizer (engine.py:3872).

``adapter_slots`` (or ``adapter_pool_mb``) turns on the adapter plane
(engine.py:1455-1493): requests may name a registered LoRA adapter
(``submit(..., adapter_id=...)``), and each admission binds its adapter to
a slot of the device pool (``adapters.AdapterPool``), so one step serves a
batch that mixes adapters; when every pool slot is referenced the request
waits, as on page exhaustion, and the reference drops when its slot is
freed or preempted. The prefix cache stays shared across adapters: LoRA
sits at the head, so K/V do not depend on it. ``adopt_weights`` swaps in
new weights between loop turns with no request dropped: it preempts every
slot, resets the caches and copies the weights in place
(engine.py:2155-2264), after folding every call in flight. QoS, handoff,
lockstep, checkpoint adoption, autotune and the perf plane are not ported
yet.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import logging
import math
import queue
import threading
import time
from typing import Any

import numpy as np
import torch

from gofr_tpu_torch.adapters import AdapterPool, AdapterRegistry, AdapterSpec
from gofr_tpu_torch.gpu import decode, executor
from gofr_tpu_torch.gpu.device import resolve_device
from gofr_tpu_torch.gpu.planner import plan_prefill, pow2_buckets
from gofr_tpu_torch.gpu.prefix import PrefixCache
from gofr_tpu_torch.gpu.programs import Draft, SpecAux, new_history
from gofr_tpu_torch.http import errors
from gofr_tpu_torch.models import ModelSpec
from gofr_tpu_torch.models.llama import (
    AnyKVCache,
    Llama,
    LlamaConfig,
    init,
    jax_state,
    params_from_jax,
)
from gofr_tpu_torch.ops.paged import gather_page

log = logging.getLogger(__name__)


# cache formats: the model's dtype, int8 rows, packed int4 rows (paged only)
KV_QUANTIZE = ("", "int8", "int4")
KV_LAYOUTS = ("paged", "slot")
# ``GenerateEngine.counters``: preemptions, tokens served from the prefix
# cache (those of them from its host tier too), prefix lookups and misses
# (engine.py's app_tpu_prefix_* metrics), pages evicted from the device
# tier (spilled or dropped) and of them spilled to the host tier, host
# pages dropped to keep its budget, pages and bytes swapped back in,
# prefill chunks (those at a non-zero offset too), and speculation's draft
# tokens proposed, accepted and rejected, the over-claimed pages given back
# after a round (app_tpu_spec_*), and its rounds, one verify forward each
COUNTERS = ("preemptions", "prefix_hit_tokens", "prefix_host_hit_tokens", "prefix_lookups",
            "prefix_misses", "prefix_evicted_pages", "prefix_spilled_pages",
            "prefix_host_dropped_pages", "prefix_swapin_pages", "prefix_swapin_bytes",
            "prefill_chunks", "prefill_chunks_at_offset", "spec_proposed", "spec_accepted",
            "spec_rejected", "spec_pages_trimmed", "spec_rounds")


def make_pool(model: Llama, kv_quantize: str, rows: int, row_len: int,
              kv_layout: str = "paged") -> AnyKVCache:
    """An empty KV cache for ``model`` in the format ``kv_quantize`` (one of
    ``KV_QUANTIZE``): ``rows`` pages of ``row_len`` positions on the paged
    layout, ``rows`` slots of ``row_len`` positions on the slot layout."""
    make = {("paged", ""): model.make_paged_cache, ("paged", "int8"): model.make_paged_cache_q,
            ("paged", "int4"): model.make_paged_cache_q4, ("slot", ""): model.make_cache,
            ("slot", "int8"): model.make_cache_q}[kv_layout, kv_quantize]
    return make(rows, row_len)


class EngineClosed(RuntimeError):
    pass


class RequestTimeout(errors.RequestTimeout, TimeoutError):
    """408 on HTTP, as the JAX engine's (http/errors.py); a TimeoutError
    to a caller in Python."""


class RequestCancelled(RuntimeError):
    pass


class Request:
    """The future of one generation: ``result()`` blocks, ``cancel()`` frees
    its slot at the device loop's next turn. A streamed request also gets
    each token (or text piece) on ``stream_q`` as it is decoded, and None
    once it completes."""

    _ids = itertools.count()

    def __init__(self, inputs: Any, kw: dict[str, Any], timeout: float | None,
                 stream: bool = False):
        self.id = next(Request._ids)
        self.inputs = inputs
        self.kw = kw
        self.enqueued_at = time.monotonic()
        self.deadline = self.enqueued_at + timeout if timeout else None
        self.stream_q: queue.SimpleQueue | None = queue.SimpleQueue() if stream else None
        self.cancelled = False
        self.cancel_reason: str | None = None
        self._done = threading.Event()
        self._lock = threading.Lock()
        self._finished = False
        self._result: Any = None
        self._error: BaseException | None = None
        self._callbacks: list = []

    def add_done_callback(self, fn) -> None:
        """Call ``fn(request)`` once it completes, however it ends (at once
        if it has)."""
        with self._lock:
            if not self._finished:
                self._callbacks.append(fn)
                return
        fn(self)

    def complete(self, result: Any = None, error: BaseException | None = None) -> None:
        """First writer wins (a late result after ``stop`` is ignored). The
        done callbacks run before a waiter wakes; one that raises is logged
        and the rest still run."""
        with self._lock:
            if self._finished:
                return
            self._result, self._error = result, error
            self._finished = True
            for fn in self._callbacks:
                try:
                    fn(self)
                except Exception:  # noqa: BLE001 - a bad callback must not kill the loop
                    log.exception("done callback of request %d failed", self.id)
            if self.stream_q is not None:
                self.stream_q.put(None)  # the end of the stream
            self._done.set()

    def outcome(self) -> tuple[Any, BaseException | None]:
        """(result, error) once complete (engine.py:150): the non-blocking
        accessor a done callback's waiter reads."""
        if not self._finished:
            raise RuntimeError("request is not complete")
        return self._result, self._error

    def cancel(self, reason: str = "cancelled") -> None:
        if not self.cancelled:
            self.cancel_reason = reason
        self.cancelled = True

    def result(self, timeout: float | None = None) -> Any:
        wait = timeout
        if self.deadline is not None:
            budget = max(0.0, self.deadline - time.monotonic())
            wait = budget if wait is None else min(wait, budget)
        if not self._done.wait(wait):
            self.cancel("timeout")
            raise RequestTimeout()
        if self._error is not None:
            raise self._error
        return self._result

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now > self.deadline


class StreamIterator:
    """The tokens (or text pieces) of a streamed generation as they are
    decoded (engine.py:909). ``cancel()`` frees the slot, for a transport
    whose client went away; the iterator then raises the request's
    error."""

    def __init__(self, req: Request, per_token_timeout: float | None):
        self._req = req
        self._timeout = per_token_timeout or 3600.0

    def __iter__(self) -> "StreamIterator":
        return self

    def __next__(self) -> Any:
        try:
            item = self._req.stream_q.get(timeout=self._timeout)
        except queue.Empty:
            self._req.cancel("timeout")
            raise RequestTimeout() from None
        if item is None:
            self._req.stream_q.put(None)  # a finished stream stays finished
            if self._req._error is not None:
                raise self._req._error
            raise StopIteration
        return item

    def cancel(self, reason: str = "client_disconnect") -> None:
        self._req.cancel(reason)

    def result(self, timeout: float | None = None) -> dict:
        """The streamed request's own result, as ``generate`` returns it."""
        return self._req.result(timeout if timeout is not None else self._timeout)


class _Slot:
    """One admitted generation. While it prefills, ``written`` is how much
    of the prompt the cache holds by the folds read so far (a prefix hit
    starts it past 0), ``dispatched`` how much of it the calls dispatched
    write (the chunk frontier, engine.py:885-888), ``generated`` is empty
    and ``last_token`` None; from its first token on, ``generated`` holds
    every output token of this admission folded so far, ``last_token`` the
    last of them, ``pos`` is where its K/V go on the next decode step, and
    ``inflight`` counts its decode chunks dispatched and not yet folded.
    ``adapter_id`` names its LoRA adapter (None: the base model) and
    ``adapter_slot`` the adapter-pool slot it holds a reference to (0: the
    base slot, never counted)."""

    __slots__ = ("request", "prompt_tokens", "prompt_len", "max_total", "eos", "temperature",
                 "admit_seq", "written", "dispatched", "generated", "last_token", "pos",
                 "inflight", "adapter_id", "adapter_slot")

    def __init__(self, request: Request, toks: np.ndarray, max_len: int,
                 eos: int | None, admit_seq: int, adapter: tuple[str | None, int] = (None, 0)):
        self.request = request
        self.prompt_tokens = toks
        self.prompt_len = int(toks.shape[0])
        self.max_total = min(self.prompt_len + request.kw["max_new_tokens"], max_len)
        self.eos = eos
        self.temperature = request.kw["temperature"]
        self.admit_seq = admit_seq
        self.written = 0
        self.dispatched = 0
        self.generated: list[int] = []
        self.last_token: int | None = None
        self.pos = self.prompt_len
        self.inflight = 0
        self.adapter_id, self.adapter_slot = adapter


class GenerateEngine:
    """Continuous batching for a ``Llama`` on the paged pool or the slot
    cache.

    ``device`` is where the engine runs (the card unless the caller asks for
    the CPU) and must be the model's device. ``max_len`` caps prompt plus
    generation per request. ``kv_layout`` is ``"paged"`` (``page_size`` and
    ``total_pages`` size the pool; default: every slot can hold a
    ``max_len`` request; fewer pages serve the usual load and preempt under
    a burst) or ``"slot"`` (``cache_len`` positions per slot).
    ``kv_quantize`` picks the cache's format: ``""`` the model's dtype,
    ``"int8"`` or, on the paged layout only, ``"int4"`` quantized rows with
    bf16 scales (2x or 4x the positions in the same memory).
    ``prefill_buckets`` (default 16, 32, ... up to ``max_len``) are the
    planner's length buckets; a prompt longer than the largest is prefilled
    in chunks of that length. ``prefix_cache`` keeps full prompt pages for
    later prompts that share them (paged layout only). ``spec_tokens`` > 0
    decodes speculatively, proposing that many tokens a round by prompt
    lookup, or by the draft model of ``spec_draft`` = (its ``LlamaConfig``,
    its ``Llama``; slot layout only, on the engine's device, sharing the
    target's vocabulary). ``adapter_slots`` > 0 (or ``adapter_pool_mb``,
    from which the slots are derived) turns on the adapter plane: a device
    pool of that many slots of rank up to ``adapter_rank``, slot 0 the base,
    and a host registry of ``adapter_host_mb``. ``pipeline_depth`` (1..4,
    default 2; ``decode_pipeline`` is its alias) bounds the device calls in
    flight. ``prefix_host_mb`` > 0 gives the prefix cache a host tier of
    that many MiB of pinned memory (at least one page, else it stays
    off)."""

    def __init__(self, model: Llama, *, device: str | torch.device | None = None,
                 slots: int = 8, max_len: int = 2048, prefill_buckets: list[int] | None = None,
                 max_prefill_batch: int = 4, decode_chunk: int = 8,
                 eos_token_id: int | None = None, top_k: int = 0, top_p: float = 1.0,
                 tokenizer: Any = None, default_timeout: float | None = None, seed: int = 0,
                 page_size: int = 128, total_pages: int | None = None,
                 prefix_cache: bool = True, kv_quantize: str = "", kv_layout: str = "paged",
                 spec_tokens: int = 0, spec_draft: tuple[LlamaConfig, Llama] | None = None,
                 adapter_slots: int = 0, adapter_rank: int = 16, adapter_pool_mb: float = 0.0,
                 adapter_host_mb: float = 256.0, pipeline_depth: int | None = None,
                 decode_pipeline: int = 2, prefix_host_mb: float = 0.0):
        if kv_layout not in KV_LAYOUTS:
            raise ValueError(f"kv_layout {kv_layout!r}: use 'slot' or 'paged'")
        if kv_quantize not in KV_QUANTIZE:
            raise ValueError(f"kv_quantize={kv_quantize!r}: use '', 'int8' or 'int4'")
        if kv_quantize == "int4" and kv_layout != "paged":
            raise ValueError("kv_quantize='int4' needs kv_layout='paged' (packed-nibble "
                             "pages); the slot layout supports '' or 'int8'")
        self.spec_tokens = max(0, int(spec_tokens))
        if spec_draft is not None:
            if not self.spec_tokens:
                raise ValueError("spec_draft requires spec_tokens > 0")
            if kv_layout != "slot":
                raise ValueError(
                    "spec_draft (draft-model speculative decoding) is slot-layout only (v1): "
                    "the paged layout's page allocation would need the draft cache paged "
                    "too — use kv_layout='slot' or drop spec_draft")
        self.device = resolve_device(device)
        if model.device.type != self.device.type or (
                self.device.index is not None and model.device.index != self.device.index):
            raise ValueError(f"model lives on {model.device}, engine device is {self.device}")
        self.model = model
        self.cfg: LlamaConfig = model.cfg
        self.num_slots = slots
        self.decode_chunk = max(1, decode_chunk)
        # positions one chunk can write past max_len: decode_chunk steps, or
        # decode_chunk rounds of g + 1 positions and g for the draft's
        # last step (engine.py:1113)
        g = self.spec_tokens
        self.chunk_span = self.decode_chunk * (g + 1) + g if g else self.decode_chunk
        self.max_len = min(max_len, self.cfg.max_seq_len - self.chunk_span)
        self.prefill_buckets = (sorted(prefill_buckets) if prefill_buckets
                                else pow2_buckets(16, self.max_len))
        # a prompt past the largest bucket is prefilled this much per turn
        self.prefill_chunk = self.prefill_buckets[-1]
        self.max_prefill_batch = max_prefill_batch
        self.eos_token_id = eos_token_id
        self.top_k, self.top_p = top_k, top_p
        self.tokenizer = tokenizer
        self.default_timeout = default_timeout
        self.kv_layout = kv_layout
        self.kv_quantize = kv_quantize
        # the device calls in flight (engine.py:1086-1090)
        depth = pipeline_depth if pipeline_depth is not None else decode_pipeline
        self.pipeline_depth = max(1, min(4, int(depth)))
        self._prefix: PrefixCache | None = None
        if kv_layout == "paged":
            self.page_size = page_size
            # the table covers the positions a chunk writes past max_len
            # (engine.py:1201)
            self.pages_per_slot = math.ceil((self.max_len + self.chunk_span) / page_size)
            self.total_pages = total_pages or slots * self.pages_per_slot
            if self.total_pages < self.pages_per_slot:
                raise ValueError(f"total_pages {self.total_pages} < pages_per_slot "
                                 f"{self.pages_per_slot}: one max-length request cannot fit")
            self.cache = make_pool(model, kv_quantize, self.total_pages, page_size)
            self._free_pages = list(range(self.total_pages))
            # slots and the prefix cache hold shares of a page; it returns to
            # the free list when its count reaches 0
            self._page_refs = np.zeros(self.total_pages, np.int64)
            self._slot_pages: list[list[int]] = [[] for _ in range(slots)]
            # OOB convention: unallocated entries point one past the pool
            self._table: np.ndarray | None = np.full((slots, self.pages_per_slot),
                                                     self.total_pages, np.int32)
            self._idle_position = 0
            # a page's bytes over every plane: the host tier's unit
            # (engine.py:1258)
            self._page_bytes = sum(t.nbytes for t in vars(self.cache).values()) // self.total_pages
            host_budget = int(max(0.0, float(prefix_host_mb)) * (1 << 20))
            if host_budget and host_budget < self._page_bytes:
                log.warning("prefix_host_mb=%g is below one page (%d bytes); host tier off",
                            prefix_host_mb, self._page_bytes)
                host_budget = 0
            if prefix_cache:
                self._prefix = PrefixCache(page_size, host_budget_bytes=host_budget)
        else:
            # a chunk never writes past the slot; a multiple of 128 where the
            # model allows it (engine.py:1321)
            self.cache_len = min(math.ceil((self.max_len + self.chunk_span) / 128) * 128,
                                 self.cfg.max_seq_len)
            self.cache = make_pool(model, kv_quantize, slots, self.cache_len, "slot")
            self._table = None
            # lanes that do not decode write at and past the slot's end,
            # where the append drops (tpu/decode.py:309-315)
            self._idle_position = self.cache_len
        # the proposer's state: the token history (its width the slot's
        # positions), or the draft model and its slot cache (engine.py:2549)
        self._aux: SpecAux = None
        if spec_draft is not None:
            self._aux = self._draft(*spec_draft)
        elif self.spec_tokens:
            width = (self.pages_per_slot * page_size if kv_layout == "paged"
                     else self.cache_len)
            self._aux = new_history(slots, width, self.device)
        # the adapter plane (engine.py:1455-1493): off, nothing changes. As
        # there, any non-zero slot count turns it on with at least 2 slots,
        # and the rank is at least 1
        ad_slots, ad_rank = int(adapter_slots), max(1, int(adapter_rank))
        if adapter_pool_mb and not ad_slots:
            ad_slots = AdapterPool.slots_for_budget(float(adapter_pool_mb), self.cfg.hidden_size,
                                                    self.cfg.vocab_size, ad_rank)
        self.adapters: AdapterRegistry | None = None
        self._adapter_pool: AdapterPool | None = None
        if ad_slots:
            self._adapter_pool = AdapterPool(max(2, ad_slots), self.cfg.hidden_size,
                                             self.cfg.vocab_size, ad_rank, device=self.device)
            self.adapters = AdapterRegistry(host_budget_mb=float(adapter_host_mb))
        # lifetime (accepted, proposed) draft tokens by adapter, summed from
        # each request as it completes (engine.py:536)
        self._spec_totals: dict[str, list[float]] = {}
        self._totals_lock = threading.Lock()
        # full-model adoptions so far, and one waiting for the loop
        self.weights_epoch = 0
        self._pending_weights: tuple[dict, threading.Event] | None = None
        self._swap_lock = threading.Lock()
        self.slots: list[_Slot | None] = [None] * slots
        self._admit_seq = 0
        # what admission did, for callers and the smoke run
        self.counters = dict.fromkeys(COUNTERS, 0)
        # the in-flight queue of device calls (``executor.Entry``), the
        # carries on the card of the decode chunk and spec round last
        # dispatched, the host tier's staged swap-ins and spills, and what
        # the queue did (``pipeline_stats``)
        self._dq: collections.deque[executor.Entry] = collections.deque()
        self._prev_last: torch.Tensor | None = None
        self._spec_carry: tuple[torch.Tensor, torch.Tensor] | None = None
        self._pending_swapins: list[tuple] = []
        self._pending_spills: list[tuple] = []
        self._pipeline: dict[str, Any] = {
            "dq_max": 0, "dq_carried_max": 0, "dispatched": {}, "folds": 0, "fold_wait_s": 0.0,
            "busy_turns": 0, "busy_turn_s": 0.0, "swapin_s": 0.0}
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self._queue: queue.Queue[Request] = queue.Queue()
        # prompts that fit a bucket, and longer ones that chunk
        self._pending: list[tuple[Request, np.ndarray]] = []
        self._pending_long: list[tuple[Request, np.ndarray]] = []
        # guards the slots, pages and caches' bookkeeping: held by the
        # device thread while it plans a dispatch or folds one (never while
        # it waits on the card), and by the audits
        self._state_lock = threading.Lock()
        self._stop = threading.Event()
        self._error: BaseException | None = None
        self._thread = threading.Thread(target=self._run, name="gofr-torch-engine", daemon=True)
        self._thread.start()

    def _draft(self, cfg: LlamaConfig, model: Llama) -> Draft:
        """Check a draft model against the engine (engine.py:1328) and give it
        a slot cache of the engine's slots and cache length."""
        if model.cfg != cfg:
            raise ValueError("spec_draft's model was built for another config than its cfg")
        if cfg.max_seq_len < self.cache_len:
            raise ValueError(f"spec_draft max_seq_len {cfg.max_seq_len} < engine cache length "
                             f"{self.cache_len}: the draft cache must cover every position the "
                             "target serves")
        if cfg.vocab_size != self.cfg.vocab_size:
            raise ValueError(f"spec_draft vocabulary {cfg.vocab_size} differs from the target's "
                             f"{self.cfg.vocab_size}: its proposals are the target's token ids")
        if model.device != self.model.device:
            raise ValueError(f"spec_draft lives on {model.device}, the engine on "
                             f"{self.model.device}")
        return Draft(model, make_pool(model, "", self.num_slots, self.cache_len, "slot"))

    # -- caller side -----------------------------------------------------------

    def submit(self, prompt: Any, max_new_tokens: int = 64, temperature: float = 0.0,
               timeout: float | None = None, stream: bool = False, **kw: Any) -> Request:
        """Non-blocking enqueue; returns the Request future (with
        ``stream``, one whose ``stream_q`` gets the tokens as they come).
        ``eos_token_id`` in ``kw`` overrides the engine's. ``adapter_id``
        in ``kw`` names a registered LoRA adapter (engine.py:434-455): an
        unknown one, or one named on an engine without the adapter plane,
        raises ValueError, and one at its cap raises ``TooManyRequests``;
        the request's share of the cap goes back when it completes,
        however it ends. ``_on_submit`` in ``kw`` is called with the
        Request as soon as it exists (a transport tracks it to cancel);
        a ``timeout`` of 0 or less raises ``DeadlineExceeded`` (504)."""
        if self._stop.is_set() or self._error is not None:
            raise EngineClosed("engine stopped") from self._error
        # a transport's hook: it gets the Request the moment it exists, to
        # cancel it if the client goes away (engine.py:421)
        on_submit = kw.pop("_on_submit", None)
        timeout = timeout if timeout is not None else self.default_timeout
        if timeout is not None and timeout <= 0:
            # the propagated deadline is already spent (engine.py:426-432)
            raise errors.DeadlineExceeded("request deadline already expired at submission")
        if "adapter_id" in kw:  # the public spelling of the routing key
            kw["_adapter"] = kw.pop("adapter_id")
        aname = kw.get("_adapter") or None
        if aname:
            if self.adapters is None:
                raise ValueError(f"request names adapter {aname!r} but this engine has no "
                                 "adapter plane (set adapter_slots or adapter_pool_mb)")
            try:
                self.adapters.admit(aname)
            except KeyError as e:
                raise ValueError(str(e.args[0]) if e.args else str(e)) from None
        req = Request(prompt, {**kw, "max_new_tokens": int(max_new_tokens),
                               "temperature": float(temperature)}, timeout, stream)
        if aname:
            req.add_done_callback(lambda _r, _n=aname: self.adapters.release(_n))
        req.add_done_callback(self._observe_done)
        if on_submit is not None:
            on_submit(req)
        self._queue.put(req)
        return req

    def _observe_done(self, req: Request) -> None:
        """Add a completed request's draft tokens to its adapter's totals
        (engine.py:534-543), however it ended."""
        proposed = req.kw.get("_spec_proposed")
        if proposed:
            with self._totals_lock:
                tot = self._spec_totals.setdefault(req.kw.get("_adapter") or "base", [0.0, 0.0])
                tot[0] += float(req.kw.get("_spec_accepted", 0))
                tot[1] += float(proposed)

    def generate(self, prompt: Any, max_new_tokens: int = 64, temperature: float = 0.0,
                 timeout: float | None = None, stream: bool = False,
                 **kw: Any) -> dict | StreamIterator:
        """Blocking generate: ``{"tokens", "text", "finish_reason", "ttft_s",
        "decode_s", "prefix_hit_tokens", "preemptions"}``. Greedy when
        temperature is 0. ``stream=True`` returns a ``StreamIterator`` over
        the tokens as they come (text pieces with a tokenizer), ``timeout``
        then bounding the wait for each."""
        req = self.submit(prompt, max_new_tokens, temperature, timeout, stream, **kw)
        timeout = timeout if timeout is not None else self.default_timeout
        return StreamIterator(req, timeout) if stream else req.result(timeout)

    def infer(self, inputs: Any, **kw: Any) -> dict | StreamIterator:
        """``generate`` under the name every engine answers (engine.py:2006)."""
        return self.generate(inputs, **kw)

    def stop(self) -> None:
        """End the loop (it settles its calls in flight on the way out) and
        fail every request still queued or in a slot."""
        self._stop.set()
        self._thread.join(timeout=30.0)
        self._fail_all(EngineClosed("engine stopped"))

    def pipeline_stats(self) -> dict[str, Any]:
        """What the in-flight queue did: the depth; the longest queue seen,
        right after a dispatch (``dq_max``: the calls left in flight plus
        what one turn dispatches, a prefill, swap-ins, a chunk and a decode
        chunk) and at the end of a turn (``dq_carried_max``: the calls in
        flight while the host plans the next turn, at most depth - 1); the
        calls dispatched by kind; the folds and the seconds they waited on
        their readbacks; the loop turns that dispatched or folded work and
        their host seconds; and the swap-ins' seconds on the card."""
        with self._state_lock:
            return {"depth": self.pipeline_depth, **self._pipeline,
                    "dispatched": dict(self._pipeline["dispatched"])}

    def health_check(self) -> dict[str, Any]:
        """What ``Container.health`` reports for this engine
        (engine.py:677): DOWN once the loop died with an error, DEGRADED
        when its thread is not running (after ``stop``), else UP with the
        requests not yet in a slot. The thread starts with the engine,
        where the JAX App starts it in ``arun``."""
        if self._error is not None:
            return {"status": "DOWN", "details": {"error": str(self._error)}}
        backlog = self._queue.qsize() + len(self._pending) + len(self._pending_long)
        return {"status": "UP" if self._thread.is_alive() else "DEGRADED",
                "details": {"queue_depth": backlog}}

    def spec_accept_totals(self) -> dict[str, tuple[float, float]]:
        """Lifetime (accepted, proposed) draft tokens of speculative decoding
        by adapter, "base" for requests without one, summed over completed
        requests (engine.py:1877); empty before the first completes."""
        with self._totals_lock:
            return {k: (v[0], v[1]) for k, v in self._spec_totals.items()}

    # -- the adapter plane (engine.py:2078-2152) ----------------------------------

    def register_adapter(self, spec: AdapterSpec) -> None:
        """Install (or replace) a named LoRA adapter. Registration is host
        side; the upload happens at the first admission that names it.
        Replacing an adapter that a live lane references raises, and so
        does a rank above the pool's."""
        if self.adapters is None:
            raise RuntimeError("engine built without the adapter plane; set adapter_slots "
                               "or adapter_pool_mb")
        if spec.rank > self._adapter_pool.rank:
            raise ValueError(f"adapter {spec.name!r} rank {spec.rank} exceeds the pool rank "
                             f"{self._adapter_pool.rank} (adapter_rank)")
        with self._state_lock:
            self.adapters.register(spec, pool=self._adapter_pool)

    def unregister_adapter(self, name: str) -> None:
        """Remove an adapter from both tiers; raises while a lane references
        it."""
        if self.adapters is None:
            return
        with self._state_lock:
            self.adapters.unregister(name, pool=self._adapter_pool)

    def adapter_stats(self) -> dict[str, Any]:
        """Both tiers' occupancy and the weights epoch."""
        if self.adapters is None:
            return {"enabled": False, "weights_epoch": self.weights_epoch}
        with self._state_lock:
            pool = self._adapter_pool.stats()
        return {"enabled": True, "registry": self.adapters.stats(), "pool": pool,
                "weights_epoch": self.weights_epoch}

    def adapters_digest(self) -> str:
        """The registered set's fingerprint ("" without the plane)."""
        return self.adapters.digest() if self.adapters is not None else ""

    def _adapter_args(self, sel: np.ndarray) -> tuple | None:
        """The ``adapters`` argument of a step: the lanes' pool slots
        ``sel`` on the device with the pool's tensors; None without the
        plane, so the step runs exactly as before."""
        p = self._adapter_pool
        if p is None:
            return None
        return (self._to_device(sel.astype(np.int64)), p.a, p.b, p.scale)

    def _acquire_adapter(self, req: Request) -> tuple[str | None, int] | str | None:
        """Bind ``req``'s adapter to a pool slot at admission: ``(name,
        slot)``, ``(None, 0)`` for the base model, ``"wait"`` when every pool
        slot is referenced (the caller requeues), or None when the adapter
        was unregistered since submission (the request fails here)."""
        name = req.kw.get("_adapter")
        if not name or self.adapters is None:
            return (None, 0)
        try:
            spec = self.adapters.get(name)
        except KeyError as e:
            req.complete(error=ValueError(str(e.args[0]) if e.args else str(e)))
            return None
        slot = self._adapter_pool.acquire(spec)
        return "wait" if slot is None else (name, slot)

    def free_pages(self) -> int:
        if self._table is None:
            raise RuntimeError("the slot layout has no pages")
        return len(self._free_pages)

    def page_pool_stats(self) -> dict | None:
        """The pool's pages by holder (engine.py:1938): free, held by slots
        (a shared page once per slot), held by the prefix cache; occupancy
        (the share not free) and fragmentation (the share of slot-held
        positions no live sequence has written yet). None on the slot
        layout."""
        if self._table is None:
            return None
        with self._state_lock:
            free = len(self._free_pages)
            held = sum(len(p) for p in self._slot_pages)
            cached = len(self._prefix) if self._prefix is not None else 0
            host = (self._prefix.host_pages, self._prefix.host_bytes) if self._prefix else (0, 0)
            live = sum(s.pos if s.generated else s.written for s in self.slots if s is not None)
        covered = held * self.page_size
        pool_bytes = sum(t.nbytes for t in vars(self.cache).values())
        return {"total_pages": self.total_pages, "free_pages": free, "slot_pages": held,
                "prefix_pages": cached, "prefix_host_pages": host[0], "prefix_host_bytes": host[1],
                "page_bytes": pool_bytes // self.total_pages,
                "pool_bytes": pool_bytes, "occupancy": 1.0 - free / self.total_pages,
                "fragmentation": 1.0 - min(1.0, live / covered) if covered else 0.0}

    def check_page_refs(self) -> None:
        """Audit the pool's accounting (gofr_tpu/testutil.py:47-130); raises
        AssertionError on the first breach. Each page's count equals its
        holders (slot page lists and the prefix cache's device nodes), a
        page is free exactly when its count is 0, the free list holds no
        page twice, each table row lists its slot's pages with OOB entries
        past them, and an empty slot holds no pages; in the prefix cache a
        device node holds no payload and a host node one and no pending
        upload, the child counts match the parent links, and the tiers'
        page and byte counts match the nodes. No-op on the slot layout."""
        if self._table is None:
            return
        with self._state_lock:
            refs = np.zeros(self.total_pages, np.int64)
            for pages in self._slot_pages:
                np.add.at(refs, pages, 1)
            if self._prefix is not None:
                np.add.at(refs, self._prefix.pages(), 1)
            _audit((refs == self._page_refs).all(),
                   f"refcounts {self._page_refs.tolist()} differ from the holders {refs.tolist()}")
            free = set(self._free_pages)
            _audit(len(free) == len(self._free_pages), "the free list holds a page twice")
            for p in range(self.total_pages):
                _audit((p in free) == (refs[p] == 0), f"page {p}: free and held disagree")
            for i, pages in enumerate(self._slot_pages):
                row = self._table[i]
                _audit(list(row[:len(pages)]) == pages,
                       f"slot {i}: table row differs from its pages")
                _audit(bool((row[len(pages):] == self.total_pages).all()),
                       f"slot {i}: table entries past its pages are not OOB")
                _audit(self.slots[i] is not None or not pages, f"empty slot {i} holds pages")
            if self._prefix is not None:
                _audit_tiers(self._prefix)

    # -- live weight adoption (engine.py:2155-2264) --------------------------------

    def adopt_weights(self, new_params: Any, *, timeout_s: float | None = 30.0) -> int:
        """Serve new weights from the next loop turn on, with no restart and
        no request dropped: the loop preempts every slot (its request goes
        back to the queue with what it generated folded into its prompt, to
        be prefilled again on the new weights), resets the KV cache, the
        prefix cache and the proposer's state, copies the new weights into
        the model's parameters in place (no buffer moves) and bumps
        ``weights_epoch``, which it returns. ``new_params`` takes the forms
        ``build_engine`` takes: a ``Llama``, or a JAX parameter tree as
        numpy arrays; on a draft engine, the target alone (the draft keeps
        its weights) or ``{"t": target, "d": draft}``. A tree of another
        structure, shape or dtype raises ValueError. Blocks up to
        ``timeout_s`` (None: stage and return); applied at once when the
        loop is not running."""
        staged = self._match_weights(new_params)
        done = threading.Event()
        with self._swap_lock:
            self._pending_weights = (staged, done)
        if not self._thread.is_alive():
            self._apply_pending_weights()
            return self.weights_epoch
        if timeout_s is not None and not done.wait(timeout_s):
            raise TimeoutError(f"weight adoption not applied within {timeout_s:.1f}s")
        return self.weights_epoch

    def _match_weights(self, new_params: Any) -> dict[str, dict[str, torch.Tensor]]:
        """The replacement's tensors by model ("t", and "d" for a draft it
        names), each checked against the serving parameters: the same names,
        shapes and dtypes, or ValueError."""
        draft = self._aux.model if isinstance(self._aux, Draft) else None
        parts = (new_params if draft is not None and isinstance(new_params, dict)
                 and set(new_params) == {"t", "d"} else {"t": new_params})
        staged = {}
        for key, new in parts.items():
            model = self.model if key == "t" else draft
            try:
                state = (dict(new.named_parameters()) if isinstance(new, Llama)
                         else jax_state(new))
            except (KeyError, TypeError, IndexError) as e:
                raise ValueError(f"adopt_weights: not a Llama or a Llama parameter tree ({e!r})"
                                 ) from None
            serving = dict(model.named_parameters())
            if set(state) != set(serving):
                raise ValueError("adopt_weights: replacement tree structure does not match the "
                                 "serving tree (same config required)")
            for name, old in serving.items():
                t = state[name]
                if tuple(t.shape) != tuple(old.shape) or t.dtype != old.dtype:
                    raise ValueError(f"adopt_weights: {name} {tuple(t.shape)}/{t.dtype} != "
                                     f"serving {tuple(old.shape)}/{old.dtype}")
            staged[key] = state
        return staged

    def _apply_pending_weights(self) -> None:
        """The loop's half of the adoption, at a turn boundary
        (engine.py:2236): fold every call in flight, preempt every slot,
        reset the per-epoch device state, copy the weights, bump the
        epoch."""
        with self._swap_lock:
            pending, self._pending_weights = self._pending_weights, None
        if pending is None:
            return
        staged, done = pending
        while self._dq:
            decode.process_decode(self)
        with self._state_lock:
            while self._preempt_newest():
                pass
        self._reset_device_state()
        with torch.no_grad():
            for key, state in staged.items():
                model = self.model if key == "t" else self._aux.model
                for name, p in model.named_parameters():
                    p.copy_(state[name])
        self.weights_epoch += 1
        log.warning("weights adopted (weights epoch %d); slot-resident work requeued",
                    self.weights_epoch)
        done.set()

    def _reset_device_state(self) -> None:
        """Every per-epoch piece of device state back to a new engine's
        (engine.py:2391), with every slot already empty: the calls in flight
        settled and the carries dropped, the KV cache and the proposer's
        history or draft cache zeroed in place, and on the paged layout the
        prefix cache (both tiers) emptied, its pages given back, and the
        host tier's staged work dropped."""
        self._drain_device_state()
        caches = [self.cache] + ([self._aux.cache] if isinstance(self._aux, Draft) else [])
        for cache in caches:
            for t in vars(cache).values():
                t.zero_()
        if isinstance(self._aux, torch.Tensor):
            self._aux.zero_()
        with self._state_lock:
            self._pending_swapins, self._pending_spills = [], []
            if self._prefix is not None:
                for p in self._prefix.clear():
                    self._unref_page(p)

    def _drain_device_state(self) -> None:
        """Settle every call still in flight, then drop the queue and the
        carries (engine.py:2342): a crashed or stopped loop may leave calls
        running, and their buffers must not be handed to the next epoch's
        work while they write. A call that failed is settled all the same.
        Never under the state lock: a wedged call would hold it."""
        for entry in list(self._dq):
            try:
                entry.result.wait()
            except Exception:  # noqa: BLE001 - a failed call is settled either way
                log.debug("an in-flight call failed while settling", exc_info=True)
        self._dq.clear()
        self._prev_last = None
        self._spec_carry = None

    # -- device thread ---------------------------------------------------------

    def _run(self) -> None:
        """The loop (engine.py:3296-3386): admit, then one chunk of one long
        prompt, then one decode chunk, each dispatched onto the in-flight
        queue; then fold the oldest calls until ``pipeline_depth`` - 1 are
        left while work keeps coming, all of them when the turn found none.
        At depth 1 each phase is folded before the next. On the way out,
        stopped or crashed, the calls in flight are settled."""
        try:
            while not self._stop.is_set():
                if self._pending_weights is not None:
                    self._apply_pending_weights()
                self._turn()
        except Exception as e:  # noqa: BLE001 - the loop's boundary: fail every waiter
            log.exception("generate engine loop crashed")
            self._error = e
        finally:
            self._drain_device_state()
        if self._error is not None:
            self._fail_all(self._error)

    def _turn(self) -> None:
        depth = self.pipeline_depth
        t = time.perf_counter()
        processed = False
        admitted = self._admit()
        if depth == 1:
            processed = self._fold_all() or processed
        chunked = self._advance_chunked()
        if depth == 1:
            processed = self._fold_all() or processed
        if not self.spec_tokens:
            dispatched = decode.dispatch_decode(self)
        elif self._table is None:
            dispatched = decode.dispatch_spec(self)
        else:
            dispatched = decode.dispatch_spec_paged(self)
        busy = admitted or chunked or dispatched
        while len(self._dq) > (depth - 1 if busy else 0):
            processed = decode.process_decode(self) or processed
        st = self._pipeline
        st["dq_carried_max"] = max(st["dq_carried_max"], len(self._dq))
        if busy or processed:
            st["busy_turns"] += 1
            st["busy_turn_s"] += time.perf_counter() - t
            return
        try:
            req = self._queue.get(timeout=0.05)
        except queue.Empty:
            return
        with self._state_lock:
            self._accept(req)

    def _fold_all(self) -> bool:
        folded = False
        while self._dq:
            folded = decode.process_decode(self) or folded
        return folded

    def _fail_all(self, error: BaseException) -> None:
        with self._state_lock:
            for i, s in enumerate(self.slots):
                if s is not None:
                    s.request.complete(error=error)
                    self._free_slot(i)
            pending, self._pending, self._pending_long = (self._pending + self._pending_long,
                                                          [], [])
        for req, _ in pending:
            req.complete(error=error)
        while True:
            try:
                self._queue.get_nowait().complete(error=error)
            except queue.Empty:
                break

    def _encode(self, inputs: Any) -> np.ndarray:
        if isinstance(inputs, str):
            if self.tokenizer is None:
                raise ValueError("string prompt but the engine has no tokenizer")
            inputs = self.tokenizer.encode(inputs)
        return np.asarray(inputs, dtype=np.int64).reshape(-1)

    def _accept(self, req: Request) -> None:
        """Move a queued request to the pending list (or, when longer than
        the largest bucket, the chunked one; engine.py:3390), or complete it
        with the error its prompt raises."""
        try:
            toks = self._encode(req.inputs)
            if not toks.shape[0]:
                raise ValueError("prompt must be a non-empty token sequence")
            if toks.shape[0] >= self.max_len:
                raise ValueError(f"prompt length {toks.shape[0]} >= engine max_len {self.max_len}")
            if toks.min() < 0 or toks.max() >= self.cfg.vocab_size:
                raise ValueError(f"prompt token outside [0, {self.cfg.vocab_size})")
            if req.kw["max_new_tokens"] < 1:
                raise ValueError("max_new_tokens must be >= 1")
        except ValueError as e:
            req.complete(error=e)
            return
        self._enqueue(req, toks)

    def _enqueue(self, req: Request, toks: np.ndarray) -> None:
        if toks.shape[0] > self.prefill_buckets[-1]:
            self._pending_long.append((req, toks))
        else:
            self._pending.append((req, toks))

    def _drain(self) -> None:
        while True:
            try:
                self._accept(self._queue.get_nowait())
            except queue.Empty:
                return

    @staticmethod
    def _dropped(req: Request, now: float) -> bool:
        """Complete a cancelled or expired request with its error; returns
        whether it was."""
        if req.expired(now):
            req.complete(error=RequestTimeout())
        elif req.cancelled:
            req.complete(error=RequestCancelled(req.cancel_reason))
        else:
            return False
        return True

    def _free_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    def _claim(self, idx: int, req: Request, toks: np.ndarray,
               adapter: tuple[str | None, int] = (None, 0)) -> _Slot:
        slot = _Slot(req, toks, self.max_len, req.kw.get("eos_token_id", self.eos_token_id),
                     self._admit_seq, adapter)
        self._admit_seq += 1
        self.slots[idx] = slot
        return slot

    # -- admission (engine.py:3390-3866) -----------------------------------------

    def _admit(self) -> bool:
        """One admission round (engine.py:3560): plan, claim and dispatch a
        batched prefill, then move the spills eviction staged to host
        memory, then dispatch the swap-ins the prefix hits staged. A
        swap-in goes out before any chunk of its slot can (the loop's next
        step), so on the one stream the upload lands before its pages are
        read. Returns whether work was dispatched or a slot claimed on the
        chunked path."""
        busy = self._admit_prefill()
        if self._pending_spills:
            executor.materialize_spills(self)
        if self._pending_swapins:
            busy = executor.dispatch_swapins(self) or busy
        return busy

    def _admit_long(self) -> None:
        """Claim a free slot for each waiting long prompt, with its prefix
        hit and its adapter (engine.py:3424). No device work:
        ``_advance_chunked`` streams the prompt into the cache one chunk per
        loop turn. When every adapter-pool slot is referenced, the prompt
        goes back to the head of the queue. Caller holds the state lock."""
        while self._pending_long and None in self.slots:
            req, toks = self._pending_long.pop(0)
            if self._dropped(req, time.monotonic()):
                continue
            ad = self._acquire_adapter(req)
            if ad is None:
                continue  # unregistered since submission; the request failed
            if ad == "wait":
                self._pending_long.insert(0, (req, toks))
                break
            idx = self._free_slots()[0]
            self._prefix_hit(idx, self._claim(idx, req, toks, ad), toks)

    def _admit_prefill(self) -> bool:
        """Plan and claim one batch under the state lock, then dispatch its
        prefill outside it (engine.py:3624-3832). The claimed slots stay
        reserved, prefilling, until ``_fold_prefill`` gives them their first
        tokens.

        ``plan_prefill`` picks the batch over the pending prompts' lengths
        and deadlines (EDF, bucket affinity); expired requests fail. A prompt
        whose prefix hit covers at least half of it takes the chunked path,
        which prefills only the rest. On the paged layout each remaining
        prompt needs pages for its prompt now; when the leader cannot get
        them, admission stops and the rest wait, so later arrivals cannot
        starve it. The batch is padded to its longest chosen prompt, not to
        the plan's length bucket: the bucket bounds XLA's compile cache,
        and eager PyTorch has none; the chosen set is the reference's.

        With the adapter plane on, each chosen request first binds its
        adapter (engine.py:3673-3766): once the pool is fully referenced,
        it and the rest of the batch go back to the pending list, and a
        request that page exhaustion bounces back gives its reference
        up. Returns whether a prefill was dispatched or a slot claimed on
        the chunked path."""
        with self._state_lock:
            self._drain()
            self._admit_long()
            if not self._pending:
                return False
            now = time.monotonic()
            self._pending = [(r, t) for r, t in self._pending
                             if not (r.cancelled and self._dropped(r, now))]
            free = self._free_slots()
            plan = plan_prefill([t.shape[0] for _, t in self._pending],
                                [int(r.deadline * 1e6) if r.deadline else 0
                                 for r, _ in self._pending],
                                int(now * 1e6), len(free), self.max_prefill_batch,
                                self.prefill_buckets)
            for i in plan.expired:
                self._pending[i][0].complete(error=RequestTimeout())
            ready = [self._pending[i] for i in plan.chosen]
            taken = set(plan.chosen) | set(plan.expired)
            self._pending = [p for i, p in enumerate(self._pending) if i not in taken]

            # each chosen request's adapter, bound before any slot or page
            # is claimed
            ad_of: dict[int, tuple[str | None, int]] = {}
            if self.adapters is not None:
                bound, wait = [], False
                for req, toks in ready:
                    ad = None if wait else self._acquire_adapter(req)
                    if ad is None and not wait:
                        continue  # unregistered since submission; the request failed
                    if wait or ad == "wait":
                        wait = True
                        self._pending.append((req, toks))
                        continue
                    ad_of[id(req)] = ad
                    bound.append((req, toks))
                ready = bound

            claimed = False
            if self._prefix is not None:
                still = []
                for req, toks in ready:
                    chain = self._usable_hit(toks)
                    if 2 * len(chain) * self.page_size >= toks.shape[0]:
                        idx = self._free_slots()[0]
                        slot = self._claim(idx, req, toks, ad_of.get(id(req), (None, 0)))
                        self._prefix_hit(idx, slot, toks, chain)
                        claimed = True
                    else:
                        still.append((req, toks))
                ready = still
                free = self._free_slots()
            if self._table is not None:
                admitted, exhausted = [], False
                for req, toks in ready:
                    if not exhausted and self._ensure_pages(free[len(admitted)],
                                                            toks.shape[0] - 1):
                        admitted.append((req, toks))
                    else:
                        exhausted = True
                        if id(req) in ad_of:
                            self._adapter_pool.release(ad_of.pop(id(req))[1])
                        self._pending.append((req, toks))
                ready = admitted
            if not ready:
                return claimed
            if self._prefix is not None:
                # a batched admission serves nothing from the cache
                self.counters["prefix_lookups"] += len(ready)
                self.counters["prefix_misses"] += len(ready)
            rows = free[:len(ready)]
            batch = []
            for idx, (req, toks) in zip(rows, ready):
                slot = self._claim(idx, req, toks, ad_of.get(id(req), (None, 0)))
                slot.dispatched = slot.prompt_len  # the whole prompt in this call
                batch.append((idx, slot))
            table_rows = None if self._table is None else self._table[rows].copy()
            prefill = executor.PrefillPlan(batch, plan.len_bucket, table_rows, time.monotonic())
        executor.dispatch_prefill(self, prefill)
        return True

    def _fold_prefill(self, first: np.ndarray, batch: list[tuple[int, _Slot]]) -> None:
        """A batched prefill's fold (engine.py:3834): each slot claimed at
        its dispatch takes its first token and starts decoding; a slot freed
        or reassigned since is skipped, one cancelled or expired freed."""
        with self._state_lock:
            now = time.monotonic()
            for row, (idx, s) in enumerate(batch):
                if self.slots[idx] is not s:
                    continue  # freed, preempted or reassigned while in flight
                if self._dropped(s.request, now):
                    self._free_slot(idx)
                    continue
                self._activate_lane(idx, s, int(first[row]))

    def _advance_chunked(self) -> bool:
        """Dispatch the next chunk of the oldest-admitted prefilling slot
        (engine.py:3467): pages for the chunk first, preempting newer slots
        if the pool is short. ``dispatched`` moves on at once, so several
        chunks of one prompt may be in flight; ``_fold_chunk`` moves
        ``written``, and the last chunk's fold starts the slot decoding.
        Returns whether a chunk was dispatched or a slot changed."""
        with self._state_lock:
            pre = [i for i, s in enumerate(self.slots)
                   if s is not None and s.last_token is None and s.dispatched < s.prompt_len]
            if not pre:
                return False
            idx = min(pre, key=lambda i: self.slots[i].admit_seq)
            s = self.slots[idx]
            if self._dropped(s.request, time.monotonic()):
                self._free_slot(idx)
                return True
            offset = s.dispatched
            chunk = min(s.prompt_len - offset, self.prefill_chunk)
            if self._table is not None:
                while not self._ensure_pages(idx, offset + chunk - 1):
                    if not self._preempt_newest(except_slot=idx):
                        self._free_slot(idx)
                        s.request.complete(error=RuntimeError(
                            "KV page pool exhausted for a single request"))
                        return True
                rows = self._table[idx:idx + 1].copy()
            else:
                rows = np.array([idx], np.int64)
            last = offset + chunk == s.prompt_len
            s.dispatched = offset + chunk
            self.counters["prefill_chunks"] += 1
            self.counters["prefill_chunks_at_offset"] += offset > 0
            plan = executor.ChunkPlan(idx, s, chunk, offset, last, rows, time.monotonic())
        executor.dispatch_chunk(self, plan)
        return True

    def _fold_chunk(self, first: np.ndarray | None, meta: tuple) -> None:
        """A prefill chunk's fold (engine.py:3522): the cache holds the
        chunk; after the last one the slot takes its first token. A slot
        freed or reassigned since is skipped, one cancelled or expired
        freed."""
        idx, s, chunk, _, last = meta
        with self._state_lock:
            if self.slots[idx] is not s:
                return  # freed, preempted or reassigned while in flight
            if self._dropped(s.request, time.monotonic()):
                self._free_slot(idx)
                return
            s.written += chunk
            if last:
                self._activate_lane(idx, s, int(first[0]))

    def _fold_swapin(self, meta: tuple) -> None:
        """A swap-in's fold (engine.py:3592): the upload has landed, so its
        promoted nodes settle, whatever became of the slot (the pages hold
        what their nodes say; nothing needs undoing), and the upload is
        counted."""
        _, _, keys, n_pages, nbytes, timer = meta
        with self._state_lock:
            if self._prefix is not None:
                for key in keys:
                    self._prefix.settle(key)
            self.counters["prefix_swapin_pages"] += n_pages
            self.counters["prefix_swapin_bytes"] += nbytes
            self._pipeline["swapin_s"] += executor.swapin_seconds(timer)

    def _activate_lane(self, idx: int, s: _Slot, tok: int) -> None:
        """The slot's prompt is in the cache: give it its first token, keep
        its full prompt pages in the prefix cache, and start it decoding
        (engine.py:3031). Caller holds the state lock."""
        s.written = s.prompt_len
        s.generated = [tok]
        s.last_token = tok
        s.pos = s.prompt_len
        # a preempted request keeps the time of its first token
        s.request.kw.setdefault("_first_token_at", time.monotonic())
        self._prefix_insert(idx)
        self._emit(s, tok)
        self._maybe_finish(idx)

    # -- decode (tpu/decode.py; dispatch and fold live in gpu/decode.py) ------------

    def _active(self) -> list[int]:
        """The slots that decode: their prompt is in the cache
        (engine.py:3027)."""
        return [i for i, s in enumerate(self.slots) if s is not None and s.last_token is not None]

    def _masked_table(self, live: list[int]) -> np.ndarray:
        """A copy of the block table with every row but the ``live`` lanes'
        all OOB (engine.py:2966)."""
        table = np.full_like(self._table, self.total_pages)
        table[live] = self._table[live]
        return table

    # the stream detokenizer's bounds (engine.py:3872): the flushed tokens
    # kept as context for the next piece, and the most held back at once
    STREAM_CTX_TOKENS = 8
    STREAM_TAIL_MAX = 32

    def _stream_diff(self, kw: dict, tail: list[int]) -> str:
        """decode(ctx + tail) minus decode(ctx): the next piece."""
        ctx = kw.get("_stream_ctx", [])
        if not ctx:
            return self.tokenizer.decode(tail)
        return self.tokenizer.decode(ctx + tail)[len(self.tokenizer.decode(ctx)):]

    def _emit(self, s: _Slot, tok: int) -> None:
        """Stream one decoded token (engine.py:3882): its id without a
        tokenizer, else the text it completes. Ids wait in a tail while
        their text ends in U+FFFD (a split UTF-8 character), up to
        ``STREAM_TAIL_MAX`` of them; a piece is decoded against the last
        ``STREAM_CTX_TOKENS`` flushed ids, so a tokenizer whose text depends
        on context streams the text ``decode`` gives the whole. The state
        lives on the request, so it survives a preemption; EOS is not
        streamed."""
        q = s.request.stream_q
        if q is None or tok == s.eos:
            return
        if self.tokenizer is None:
            q.put(tok)
            return
        kw = s.request.kw
        tail = kw.setdefault("_stream_tail", [])
        tail.append(tok)
        piece = self._stream_diff(kw, tail)
        if (piece and not piece.endswith("\ufffd")) or len(tail) > self.STREAM_TAIL_MAX:
            if piece:
                q.put(piece)
            kw["_stream_ctx"] = (kw.get("_stream_ctx", []) + tail)[-self.STREAM_CTX_TOKENS:]
            tail.clear()

    def _maybe_finish(self, idx: int) -> bool:
        s = self.slots[idx]
        if s.eos is not None and s.generated[-1] == s.eos:
            finish, tokens = "stop", s.generated[:-1]
        elif s.prompt_len + len(s.generated) >= s.max_total:
            finish, tokens = "length", list(s.generated)
        else:
            return False
        tail = s.request.kw.get("_stream_tail")
        if tail and s.request.stream_q is not None:
            # what the tail still holds, so the joined stream is the text
            piece = self._stream_diff(s.request.kw, tail)
            if piece:
                s.request.stream_q.put(piece)
            tail.clear()
        now = time.monotonic()
        self._free_slot(idx)
        kw = s.request.kw
        # tokens generated before a preemption lead the result (engine.py:3920)
        tokens = list(kw.get("_prior_tokens", [])) + tokens
        s.request.complete(result={
            "tokens": tokens,
            "text": self.tokenizer.decode(tokens) if self.tokenizer is not None else None,
            "finish_reason": finish,
            "ttft_s": kw["_first_token_at"] - s.request.enqueued_at,
            "decode_s": now - kw["_first_token_at"],
            "prefix_hit_tokens": kw.get("_prefix_hit_tokens", 0),
            "prefix_host_tokens": kw.get("_prefix_host_tokens", 0),
            "preemptions": kw.get("_preemptions", 0),
        })
        return True

    # -- pages (engine.py:2658-3022) -------------------------------------------

    def _ref_page(self, p: int) -> None:
        self._page_refs[p] += 1

    def _unref_page(self, p: int) -> None:
        self._page_refs[p] -= 1
        if self._page_refs[p] == 0:
            self._free_pages.append(p)

    def _free_slot(self, idx: int) -> None:
        """Vacate a slot; on the paged layout it gives up its share of each
        page (a page the prefix cache or another slot holds stays), and its
        adapter-pool reference drops (engine.py:2731)."""
        if self._table is not None:
            pages, self._slot_pages[idx] = self._slot_pages[idx], []
            self._table[idx] = self.total_pages
            for p in pages:
                self._unref_page(p)
        s = self.slots[idx]
        if s is not None and self._adapter_pool is not None:
            self._adapter_pool.release(s.adapter_slot)
        self.slots[idx] = None

    def _evict_prefix_page(self) -> bool:
        """Take least-recently-used prefix-cache leaves off the device tier
        until a page lands on the free list (a page a slot still holds frees
        nothing); False when the cache runs out first (engine.py:2752).
        With the host tier on, a page is spilled rather than dropped: a copy
        of it is made on the card and its copy to pinned host memory started
        here, with no wait (the state lock is held), and
        ``executor.materialize_spills`` swaps the host copy into the node
        outside the lock. Caller holds the state lock."""
        if self._prefix is None:
            return False
        while not self._free_pages:
            if self._prefix.host_budget:
                picked = self._prefix.spill_lru()
                if picked is None:
                    break
                key, p = picked
                payload = gather_page(self.cache, p)
                staged = executor.Readback(self.device, *payload)
                self.counters["prefix_host_dropped_pages"] += self._prefix.commit_spill(
                    key, payload, self._page_bytes)
                self._pending_spills.append((key, staged))
                self.counters["prefix_spilled_pages"] += 1
            else:
                p = self._prefix.evict_lru()
                if p is None:
                    break
            self.counters["prefix_evicted_pages"] += 1
            self._unref_page(p)
        return bool(self._free_pages)

    def _ensure_pages(self, idx: int, upto_pos: int) -> bool:
        """Grow slot ``idx``'s table until it covers position ``upto_pos``;
        False when the pool runs out, after giving back the pages this call
        took, so a slot left unclaimed strands none (engine.py:2794)."""
        need = upto_pos // self.page_size + 1
        cur = self._slot_pages[idx]
        added = 0
        while len(cur) < need:
            if not self._free_pages and not self._evict_prefix_page():
                for _ in range(added):
                    p = cur.pop()
                    self._table[idx, len(cur)] = self.total_pages
                    self._unref_page(p)
                return False
            p = self._free_pages.pop()
            self._page_refs[p] = 1
            self._table[idx, len(cur)] = p
            cur.append(p)
            added += 1
        return True

    def _alloc_lane_pages(self, idx: int, s: _Slot, upto_pos: int) -> None:
        """Grow a decoding lane's table to cover ``upto_pos``, preempting the
        newest other slot while the pool is short (engine.py:2926)."""
        if self.slots[idx] is not s:
            return  # preempted by an earlier lane's growth
        while not self._ensure_pages(idx, upto_pos):
            if not self._preempt_newest(except_slot=idx):
                self._free_slot(idx)
                s.request.complete(error=RuntimeError("KV page pool exhausted for a single request"))
                return

    def _trim_lane_pages(self, idx: int, keep_pos: int) -> int:
        """Give back slot ``idx``'s pages past the one holding ``keep_pos``
        (engine.py:2943): the surplus of a speculative round's worst-case
        claim. A page the prefix cache or another slot holds stays. Returns
        the shares given back."""
        keep = keep_pos // self.page_size + 1
        cur = self._slot_pages[idx]
        released = 0
        while len(cur) > keep:
            p = cur.pop()
            self._table[idx, len(cur)] = self.total_pages
            self._unref_page(p)
            released += 1
        return released

    def _preempt_newest(self, except_slot: int | None = None) -> bool:
        """Free the most recently admitted slot other than ``except_slot``,
        decoding or prefilling (LIFO keeps nearly done requests running), and
        requeue its request with what it generated folded into its prompt:
        preemption by recompute (engine.py:2977). Greedy decoding resumes
        where it stopped."""
        candidates = [(s.admit_seq, i) for i, s in enumerate(self.slots)
                      if s is not None and i != except_slot]
        if not candidates:
            return False
        _, idx = max(candidates)
        s = self.slots[idx]
        self._free_slot(idx)
        kw = s.request.kw
        kw["_preemptions"] = kw.get("_preemptions", 0) + 1
        kw["_prior_tokens"] = list(kw.get("_prior_tokens", [])) + s.generated
        kw["max_new_tokens"] = max(1, kw["max_new_tokens"] - len(s.generated))
        self._enqueue(s.request, np.concatenate([s.prompt_tokens,
                                                 np.asarray(s.generated, np.int64)]))
        self.counters["preemptions"] += 1
        return True

    # -- the prefix cache (engine.py:2817-2924) -------------------------------------

    def _usable_hit(self, toks: np.ndarray) -> list:
        """The cached chain, across both tiers, covering a prefix of
        ``toks``, capped below the prompt's length so its last token's
        logits are recomputed."""
        if self._prefix is None:
            return []
        chain = self._prefix.lookup_tiered(toks)
        return chain[:(toks.shape[0] - 1) // self.page_size]

    def _prefix_hit(self, idx: int, slot: _Slot, toks: np.ndarray,
                    chain: list | None = None) -> None:
        """Splice the cached prefix of ``toks`` into a freshly claimed slot's
        table; its prefill starts after it (engine.py:2834-2906). A device
        node's page takes a share; a host node takes a free page (the chain
        stops where none is free: table rows stay contiguous), is promoted
        onto it, pending, and its upload is staged for ``_admit`` to
        dispatch. Caller holds the state lock."""
        if self._prefix is None:
            return
        self.counters["prefix_lookups"] += 1
        if chain is None:
            chain = self._usable_hit(toks)
        pages: list[int] = []
        keys, pids, payloads = [], [], []
        for key, node in chain:
            if node.page_id >= 0:
                p = node.page_id
                self._ref_page(p)
            else:
                if not self._free_pages:
                    break  # no page to swap into: the tail recomputes
                p = self._free_pages.pop()
                # two shares at once: this slot's and the cache's
                self._page_refs[p] = 2
                keys.append(key)
                pids.append(p)
                payloads.append(node.host)
                self._prefix.promote(key, p)
            pages.append(p)
        if not pages:
            self.counters["prefix_misses"] += 1
            return
        self._slot_pages[idx] = pages
        self._table[idx, :len(pages)] = pages
        slot.written = slot.dispatched = len(pages) * self.page_size
        host_tokens = len(pids) * self.page_size
        self.counters["prefix_hit_tokens"] += slot.written
        self.counters["prefix_host_hit_tokens"] += host_tokens
        kw = slot.request.kw
        kw["_prefix_hit_tokens"] = kw.get("_prefix_hit_tokens", 0) + slot.written
        kw["_prefix_host_tokens"] = kw.get("_prefix_host_tokens", 0) + host_tokens
        if pids:
            self._pending_swapins.append((idx, slot, keys, pids, payloads))

    def _prefix_insert(self, idx: int) -> None:
        """Keep the full prompt pages of a slot that just finished its
        prefill; the cache takes a share of each page it did not hold."""
        s = self.slots[idx]
        if self._prefix is None or s is None:
            return
        n_full = s.prompt_len // self.page_size
        for p in self._prefix.insert(s.prompt_tokens, self._slot_pages[idx][:n_full]):
            self._ref_page(p)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return executor.to_device(a, self.device)


def _audit(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(f"page pool audit: {msg}")


def _audit_tiers(cache: PrefixCache) -> None:
    """The prefix cache's two tiers against their nodes (testutil.py:
    96-130)."""
    dev = host = host_bytes = 0
    children = {k: [0, 0] for k in cache._nodes}
    for node in cache._nodes.values():
        if node.page_id >= 0:
            dev += 1
            _audit(node.host is None and node.host_nbytes == 0,
                   "a device-tier node holds a host payload")
        else:
            host += 1
            _audit(node.host is not None and not node.pending,
                   "a host-tier node lost its payload or waits on an upload")
            host_bytes += node.host_nbytes
        counts = children.get(node.parent_key)
        if counts is not None:
            counts[0] += 1
            counts[1] += node.page_id >= 0
    for key, node in cache._nodes.items():
        _audit([node.children, node.dev_children] == children[key],
               f"node {key}: child counts {node.children}/{node.dev_children} differ from "
               f"its children {children[key]}")
    _audit(len(cache) == dev and cache.host_pages == host and cache.host_bytes == host_bytes,
           "the tiers' page or byte counts differ from their nodes")


_PRESETS = {"llama3_8b": LlamaConfig.llama3_8b, "one_b": LlamaConfig.one_b,
            "tiny": LlamaConfig.tiny}


def _model(cfg: LlamaConfig, params: Any, dev: torch.device, seed: int) -> Llama:
    """``params`` as a ``Llama`` already built, a JAX parameter tree as
    numpy arrays (``params_from_jax``), or None for random weights drawn on
    ``dev`` from ``seed``."""
    if isinstance(params, Llama):
        return params
    if params is not None:
        return params_from_jax(cfg, params, dev)
    return init(cfg, torch.Generator(device=dev).manual_seed(seed), dev)


def engine_knobs(conf: Any, kw: dict[str, Any]) -> dict[str, Any]:
    """The engine knobs of the ``ENGINE_*`` and ``ADAPTER_*`` keys of
    ``conf``, read as the JAX ``build_engine`` reads them
    (engine.py:4085-4370); a knob's keyword in ``kw`` wins over its key and
    is popped.

    A knob the port lacks raises ValueError naming its ROADMAP.md item:
    ``ENGINE_QUANTIZE``, ``ENGINE_ROLE`` other than ``both``,
    ``ADAPTER_HOTSWAP_DIR``. No knob is ignored."""
    quantize = str(kw.pop("quantize", None) or conf.get_or_default("ENGINE_QUANTIZE", ""))
    if quantize == "int8":
        raise ValueError("ENGINE_QUANTIZE=int8: weight-only int8 is not ported yet "
                         "(ROADMAP.md Queue A 3)")
    if quantize:
        raise ValueError(f"ENGINE_QUANTIZE={quantize!r}: only 'int8' is supported")
    role = str(kw.pop("role", None) or conf.get_or_default("ENGINE_ROLE", "both"))
    if role != "both":
        raise ValueError(f"ENGINE_ROLE={role!r}: disaggregated serving is not ported yet "
                         "(ROADMAP.md Queue A 6); the port serves role 'both'")
    if kw.pop("adapter_hotswap_dir", None) or conf.get_or_default("ADAPTER_HOTSWAP_DIR", ""):
        raise ValueError("ADAPTER_HOTSWAP_DIR: checkpoint adoption is not ported yet "
                         "(ROADMAP.md Queue A 9, train/); adopt_weights takes weights in memory")
    depth = kw.pop("pipeline_depth", kw.pop("decode_pipeline", None))
    if depth is None:
        depth = conf.get_int("ENGINE_PIPELINE", 0) or conf.get_int("ENGINE_DECODE_PIPELINE", 2)
    host_mb = kw.pop("prefix_host_mb", None)
    if host_mb is None:
        host_mb = conf.get_float("ENGINE_PREFIX_HOST_MB", 0.0)

    # ENGINE_KV_DTYPE is the canonical spelling, ENGINE_KV_QUANTIZE its
    # legacy alias (engine.py:4237-4250)
    kv_quantize = kw.pop("kv_quantize", None)
    kv_dtype = str(conf.get_or_default("ENGINE_KV_DTYPE", "")).lower()
    if kv_quantize is None and kv_dtype:
        if kv_dtype not in ("bf16", "bfloat16", "int8", "int4"):
            raise ValueError(f"ENGINE_KV_DTYPE={kv_dtype!r}: use bf16, int8 or int4")
        kv_quantize = "" if kv_dtype in ("bf16", "bfloat16") else kv_dtype
    elif kv_quantize is None:
        kv_quantize = conf.get_or_default("ENGINE_KV_QUANTIZE", "")

    def pick(name: str, key: str, get, default):
        return kw.pop(name) if name in kw else get(key, default)

    return {
        "slots": int(pick("slots", "ENGINE_SLOTS", conf.get_int, 8)),
        "max_len": int(pick("max_len", "ENGINE_MAX_LEN", conf.get_int, 2048)),
        "decode_chunk": int(pick("decode_chunk", "ENGINE_DECODE_CHUNK", conf.get_int, 8)),
        "max_prefill_batch": int(pick("max_prefill_batch", "ENGINE_PREFILL_BATCH",
                                      conf.get_int, 4)),
        "kv_layout": str(pick("kv_layout", "ENGINE_KV_LAYOUT", conf.get_or_default, "paged")),
        "kv_quantize": str(kv_quantize),
        "page_size": int(pick("page_size", "ENGINE_PAGE_SIZE", conf.get_int, 128)),
        "total_pages": int(pick("total_pages", "ENGINE_TOTAL_PAGES", conf.get_int, 0)) or None,
        "prefix_cache": bool(pick("prefix_cache", "ENGINE_PREFIX_CACHE", conf.get_bool, True)),
        "spec_tokens": int(pick("spec_tokens", "ENGINE_SPEC_TOKENS", conf.get_int, 0)),
        "default_timeout": pick("default_timeout", "ENGINE_TIMEOUT", conf.get_float, 0.0) or None,
        "adapter_slots": int(pick("adapter_slots", "ADAPTER_SLOTS", conf.get_int, 0)),
        "adapter_rank": int(pick("adapter_rank", "ADAPTER_RANK", conf.get_int, 16)),
        "adapter_pool_mb": float(pick("adapter_pool_mb", "ADAPTER_POOL_MB", conf.get_float, 0.0)),
        "adapter_host_mb": float(pick("adapter_host_mb", "ADAPTER_HOST_MB", conf.get_float,
                                      256.0)),
        "pipeline_depth": int(depth),
        "prefix_host_mb": float(host_mb),
    }


def build_engine(config: str | LlamaConfig | ModelSpec = "llama3_8b", container: Any = None, *,
                 params: Any = None, device: str | torch.device | None = None, seed: int = 0,
                 spec_draft: tuple[str | LlamaConfig, Any] | None = None,
                 **kw: Any) -> GenerateEngine:
    """An engine for a Llama model, in one of two forms.

    ``build_engine(spec, container, **kw)`` is the App's (engine.py:4036):
    the model is the ``ModelSpec``'s (its config, weights, tokenizer and
    dtype), the knobs come from the container's config (``engine_knobs``)
    with ``kw`` winning, the eos id from the tokenizer unless
    ``eos_token_id`` is given, and a random model is announced with the
    logger's warn.

    ``build_engine(preset_or_config, params=..., **kw)`` is the direct one:
    a preset name or a ``LlamaConfig``, and ``kw`` straight to
    ``GenerateEngine``.

    Weights (``params``, or the spec's ``weights``): a ``Llama`` already
    built, a JAX parameter tree as numpy arrays (``params_from_jax``), or —
    when None — random weights drawn on ``device`` from ``seed``.
    ``spec_draft`` = (a config, its weights in any of those forms) is the
    draft model of speculative decoding (engine.py:4140), its random
    weights drawn from ``seed`` + 1. Runs on the card unless ``device``
    says otherwise."""
    if isinstance(config, ModelSpec):
        spec = config
        if container is None or params is not None:
            raise TypeError("build_engine(spec, container): the knobs come from the container's "
                            "config and the weights from spec.weights")
        if spec.family != "llama":
            raise ValueError(f"model family {spec.family!r} is not ported; the port serves "
                             "'llama'")
        if spec.task != "generate":
            raise ValueError(f"task {spec.task!r}: BatchEngine (embed, classify) is not ported "
                             "yet (ROADMAP.md Queue A 9)")
        if isinstance(spec.weights, str) or isinstance(spec.tokenizer, str):
            raise ValueError("checkpoint paths, Hugging Face ids and tokenizer names are not "
                             "ported yet (ROADMAP.md Queue A 9): pass weights as a Llama or a "
                             "parameter tree, and a tokenizer object")
        cfg = spec.config
        if spec.dtype is not None and cfg.dtype != spec.dtype:
            cfg = dataclasses.replace(cfg, dtype=spec.dtype)
        kw = {**engine_knobs(container.config, kw), **kw}
        if kw.get("eos_token_id") is None and spec.tokenizer is not None:
            kw["eos_token_id"] = spec.tokenizer.eos_token_id
        kw.setdefault("tokenizer", spec.tokenizer)
        params = spec.weights
        if params is None:
            container.logger.warn(f"model {spec.family}: no weights given — randomly "
                                  "initialized (dev/bench mode)")
    elif container is not None:
        raise TypeError("build_engine: a container goes with a ModelSpec")
    else:
        cfg = _PRESETS[config]() if isinstance(config, str) else config
    dev = resolve_device(device)
    model = _model(cfg, params, dev, seed)
    if spec_draft is not None:
        dcfg = _PRESETS[spec_draft[0]]() if isinstance(spec_draft[0], str) else spec_draft[0]
        spec_draft = (dcfg, _model(dcfg, spec_draft[1], dev, seed + 1))
    return GenerateEngine(model, device=dev, seed=seed, spec_draft=spec_draft, **kw)
