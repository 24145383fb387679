"""Continuous-batching generation over the paged KV pool (counterpart of
gofr_tpu/tpu/engine.py ``GenerateEngine`` and ``build_engine``).

A device thread owns the model, the pool and every slot. Callers ``submit``
prompts onto a queue and get a ``Request`` future back. Each loop turn the
thread

1. moves queued requests into a pending list, rejecting bad prompts;
2. admits pending requests while a slot and enough free pages exist: the
   pages a request can ever write (prompt plus ``max_new_tokens``, capped at
   ``max_len``) are taken from the free list at admission, and the batch is
   prefilled at once, padded to its longest prompt and masked by lengths;
3. runs ``decode_chunk`` decode steps over every slot and hands each slot its
   tokens until EOS or its length limit; a finished request returns its
   pages to the free list at once.

Lanes without a request keep an all-OOB table row, so their writes drop.
Reserving a request's pages at admission means a running request never
waits for pages and nothing is preempted; the JAX engine allocates on
demand and preempts instead, which this slice leaves for later, with the
prefix cache, chunked admission, speculative decoding, QoS, adapters,
handoff, lockstep, autotune and the perf plane.
"""

from __future__ import annotations

import itertools
import logging
import math
import queue
import threading
import time
from typing import Any

import numpy as np
import torch

from gofr_tpu_torch.gpu.device import resolve_device
from gofr_tpu_torch.gpu.programs import decode_chunk, prefill_sample
from gofr_tpu_torch.models.llama import Llama, LlamaConfig, init, params_from_jax
from gofr_tpu_torch.ops.paged import AnyPagedKVCache

log = logging.getLogger(__name__)


# pool formats: the model's dtype, int8 rows, packed int4 rows
KV_QUANTIZE = ("", "int8", "int4")


def make_pool(model: Llama, kv_quantize: str, pages: int, page_size: int) -> AnyPagedKVCache:
    """An empty pool of ``pages`` pages for ``model`` in the format
    ``kv_quantize`` (one of ``KV_QUANTIZE``)."""
    make = {"": model.make_paged_cache, "int8": model.make_paged_cache_q,
            "int4": model.make_paged_cache_q4}[kv_quantize]
    return make(pages, page_size)


class EngineClosed(RuntimeError):
    pass


class RequestTimeout(TimeoutError):
    pass


class RequestCancelled(RuntimeError):
    pass


class Request:
    """The future of one generation: ``result()`` blocks, ``cancel()`` frees
    its slot at the device loop's next turn."""

    _ids = itertools.count()

    def __init__(self, inputs: Any, kw: dict[str, Any], timeout: float | None):
        self.id = next(Request._ids)
        self.inputs = inputs
        self.kw = kw
        self.enqueued_at = time.monotonic()
        self.deadline = self.enqueued_at + timeout if timeout else None
        self.cancelled = False
        self.cancel_reason: str | None = None
        self._done = threading.Event()
        self._lock = threading.Lock()
        self._result: Any = None
        self._error: BaseException | None = None

    def complete(self, result: Any = None, error: BaseException | None = None) -> None:
        """First writer wins (a late result after ``stop`` is ignored)."""
        with self._lock:
            if self._done.is_set():
                return
            self._result, self._error = result, error
            self._done.set()

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
            raise RequestTimeout(f"request {self.id} timed out")
        if self._error is not None:
            raise self._error
        return self._result

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now > self.deadline


class _Slot:
    """One admitted generation. ``generated`` holds every output token so
    far; ``pos`` is where the last one's K/V goes on the next decode step."""

    __slots__ = ("request", "prompt_len", "max_total", "eos", "temperature",
                 "generated", "pos", "first_token_at")

    def __init__(self, request: Request, prompt_len: int, max_total: int,
                 eos: int | None, temperature: float, first_token: int):
        self.request = request
        self.prompt_len = prompt_len
        self.max_total = max_total
        self.eos = eos
        self.temperature = temperature
        self.generated = [first_token]
        self.pos = prompt_len
        self.first_token_at = time.monotonic()


class GenerateEngine:
    """Continuous batching for a ``Llama`` on the paged pool.

    ``device`` is where the engine runs (the card unless the caller asks for
    the CPU) and must be the model's device. ``max_len`` caps prompt plus
    generation per request; ``page_size`` and ``total_pages`` size the pool
    (default: every slot can hold a ``max_len`` request). ``kv_quantize``
    picks the pool's format: ``""`` the model's dtype, ``"int8"`` or
    ``"int4"`` quantized rows with bf16 scales (2x or 4x the positions in
    the same memory); page reservation is the same for all three."""

    def __init__(self, model: Llama, *, device: str | torch.device | None = None,
                 slots: int = 8, max_len: int = 2048, max_prefill_batch: int = 4,
                 decode_chunk: int = 8, eos_token_id: int | None = None, top_k: int = 0,
                 top_p: float = 1.0, tokenizer: Any = None,
                 default_timeout: float | None = None, seed: int = 0,
                 page_size: int = 128, total_pages: int | None = None,
                 kv_quantize: str = ""):
        if kv_quantize not in KV_QUANTIZE:
            raise ValueError(f"kv_quantize={kv_quantize!r}: use '', 'int8' or 'int4'")
        self.device = resolve_device(device)
        if model.device.type != self.device.type or (
                self.device.index is not None and model.device.index != self.device.index):
            raise ValueError(f"model lives on {model.device}, engine device is {self.device}")
        self.model = model
        self.cfg: LlamaConfig = model.cfg
        self.num_slots = slots
        self.decode_chunk = max(1, decode_chunk)
        # positions written in a chunk run up to max_len + decode_chunk - 2
        self.max_len = min(max_len, self.cfg.max_seq_len - self.decode_chunk)
        self.max_prefill_batch = max_prefill_batch
        self.eos_token_id = eos_token_id
        self.top_k, self.top_p = top_k, top_p
        self.tokenizer = tokenizer
        self.default_timeout = default_timeout
        self.page_size = page_size
        self.pages_per_slot = math.ceil(self.max_len / page_size)
        self.total_pages = total_pages or slots * self.pages_per_slot
        if self.total_pages < self.pages_per_slot:
            raise ValueError(f"total_pages {self.total_pages} < pages_per_slot "
                             f"{self.pages_per_slot}: one max-length request cannot fit")
        self.cache = make_pool(model, kv_quantize, self.total_pages, page_size)
        self._free_pages = list(range(self.total_pages))
        self._slot_pages: list[list[int]] = [[] for _ in range(slots)]
        # OOB convention: unallocated entries point one past the pool
        self._table = np.full((slots, self.pages_per_slot), self.total_pages, np.int32)
        self.slots: list[_Slot | None] = [None] * slots
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self._queue: queue.Queue[Request] = queue.Queue()
        self._pending: list[tuple[Request, list[int]]] = []
        self._stop = threading.Event()
        self._error: BaseException | None = None
        self._thread = threading.Thread(target=self._run, name="gofr-torch-engine", daemon=True)
        self._thread.start()

    # -- caller side -----------------------------------------------------------

    def submit(self, prompt: Any, max_new_tokens: int = 64, temperature: float = 0.0,
               timeout: float | None = None, **kw: Any) -> Request:
        """Non-blocking enqueue; returns the Request future. ``eos_token_id``
        in ``kw`` overrides the engine's."""
        if self._stop.is_set() or self._error is not None:
            raise EngineClosed("engine stopped") from self._error
        req = Request(prompt, {**kw, "max_new_tokens": int(max_new_tokens),
                               "temperature": float(temperature)},
                      timeout if timeout is not None else self.default_timeout)
        self._queue.put(req)
        return req

    def generate(self, prompt: Any, max_new_tokens: int = 64, temperature: float = 0.0,
                 timeout: float | None = None, **kw: Any) -> dict:
        """Blocking generate: ``{"tokens", "text", "finish_reason", "ttft_s",
        "decode_s"}``. Greedy when temperature is 0."""
        req = self.submit(prompt, max_new_tokens, temperature, timeout, **kw)
        return req.result(timeout if timeout is not None else self.default_timeout)

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=30.0)
        self._fail_all(EngineClosed("engine stopped"))

    def free_pages(self) -> int:
        return len(self._free_pages)

    # -- device thread ---------------------------------------------------------

    def _run(self) -> None:
        try:
            while not self._stop.is_set():
                self._drain()
                admitted = self._admit()
                if any(s is not None for s in self.slots):
                    self._decode()
                elif not admitted:
                    try:
                        self._accept(self._queue.get(timeout=0.05))
                    except queue.Empty:
                        pass
        except Exception as e:  # noqa: BLE001 - the loop's boundary: fail every waiter
            log.exception("generate engine loop crashed")
            self._error = e
            self._fail_all(e)

    def _fail_all(self, error: BaseException) -> None:
        for i, s in enumerate(self.slots):
            if s is not None:
                s.request.complete(error=error)
                self._free_slot(i)
        for req, _ in self._pending:
            req.complete(error=error)
        self._pending = []
        while True:
            try:
                self._queue.get_nowait().complete(error=error)
            except queue.Empty:
                break

    def _encode(self, inputs: Any) -> list[int]:
        if isinstance(inputs, str):
            if self.tokenizer is None:
                raise ValueError("string prompt but the engine has no tokenizer")
            return list(self.tokenizer.encode(inputs))
        return [int(t) for t in np.asarray(inputs).reshape(-1)]

    def _accept(self, req: Request) -> None:
        """Move a queued request to the pending list, or complete it with the
        error its prompt raises."""
        try:
            toks = self._encode(req.inputs)
            if not toks:
                raise ValueError("prompt must be a non-empty token sequence")
            if len(toks) >= self.max_len:
                raise ValueError(f"prompt length {len(toks)} >= engine max_len {self.max_len}")
            if min(toks) < 0 or max(toks) >= self.cfg.vocab_size:
                raise ValueError(f"prompt token outside [0, {self.cfg.vocab_size})")
            if req.kw["max_new_tokens"] < 1:
                raise ValueError("max_new_tokens must be >= 1")
        except ValueError as e:
            req.complete(error=e)
            return
        self._pending.append((req, toks))

    def _drain(self) -> None:
        while True:
            try:
                self._accept(self._queue.get_nowait())
            except queue.Empty:
                return

    def _admit(self) -> bool:
        """Prefill as many pending requests as slots, pages and the batch cap
        allow, in arrival order. Returns whether any were admitted."""
        batch: list[tuple[int, Request, list[int], int]] = []
        while self._pending and len(batch) < self.max_prefill_batch:
            req, toks = self._pending[0]
            if req.cancelled or req.expired(time.monotonic()):
                self._pending.pop(0)
                req.complete(error=RequestTimeout() if req.expired(time.monotonic())
                             else RequestCancelled(req.cancel_reason))
                continue
            free = [i for i, s in enumerate(self.slots)
                    if s is None and i not in {b[0] for b in batch}]
            max_total = min(len(toks) + req.kw["max_new_tokens"], self.max_len)
            need = math.ceil(max_total / self.page_size)
            if not free or need > len(self._free_pages):
                break
            self._pending.pop(0)
            idx = free[0]
            pages, self._free_pages = self._free_pages[:need], self._free_pages[need:]
            self._slot_pages[idx] = pages
            self._table[idx, :need] = pages
            batch.append((idx, req, toks, max_total))
        if not batch:
            return False

        width = max(len(toks) for _, _, toks, _ in batch)
        tokens = np.zeros((len(batch), width), np.int64)
        for row, (_, _, toks, _) in enumerate(batch):
            tokens[row, :len(toks)] = toks
        temps = [req.kw["temperature"] for _, req, _, _ in batch]
        first = prefill_sample(
            self.model, self.cache, self._to_device(tokens),
            self._to_device(np.array([len(t) for _, _, t, _ in batch], np.int64)),
            self._to_device(self._table[[idx for idx, *_ in batch]]),
            self._to_device(np.array(temps, np.float32)), self._generator,
            top_k=self.top_k, top_p=self.top_p, do_sample=max(temps) > 0,
        ).tolist()
        for (idx, req, toks, max_total), tok in zip(batch, first):
            self.slots[idx] = _Slot(req, len(toks), max_total,
                                    req.kw.get("eos_token_id", self.eos_token_id),
                                    req.kw["temperature"], int(tok))
            self._maybe_finish(idx)
        return True

    def _decode(self) -> None:
        now = time.monotonic()
        for i, s in enumerate(self.slots):
            if s is not None and (s.request.cancelled or s.request.expired(now)):
                s.request.complete(error=RequestTimeout() if s.request.expired(now)
                                   else RequestCancelled(s.request.cancel_reason))
                self._free_slot(i)
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return
        tokens = np.zeros(self.num_slots, np.int64)
        positions = np.zeros(self.num_slots, np.int64)
        temps = np.zeros(self.num_slots, np.float32)
        for i in active:
            s = self.slots[i]
            tokens[i], positions[i], temps[i] = s.generated[-1], s.pos, s.temperature
        out = decode_chunk(
            self.model, self.cache, self._to_device(tokens), self._to_device(positions),
            self._to_device(self._table), self._to_device(temps), self.decode_chunk,
            self._generator, top_k=self.top_k, top_p=self.top_p, do_sample=bool(temps.max() > 0),
        ).cpu().numpy()
        for i in active:
            s = self.slots[i]
            for tok in out[i]:
                s.generated.append(int(tok))
                s.pos += 1
                if self._maybe_finish(i):
                    break

    def _maybe_finish(self, idx: int) -> bool:
        s = self.slots[idx]
        if s.eos is not None and s.generated[-1] == s.eos:
            finish, tokens = "stop", s.generated[:-1]
        elif s.prompt_len + len(s.generated) >= s.max_total:
            finish, tokens = "length", list(s.generated)
        else:
            return False
        now = time.monotonic()
        self._free_slot(idx)
        s.request.complete(result={
            "tokens": tokens,
            "text": self.tokenizer.decode(tokens) if self.tokenizer is not None else None,
            "finish_reason": finish,
            "ttft_s": s.first_token_at - s.request.enqueued_at,
            "decode_s": now - s.first_token_at,
        })
        return True

    def _free_slot(self, idx: int) -> None:
        self._free_pages.extend(self._slot_pages[idx])
        self._slot_pages[idx] = []
        self._table[idx] = self.total_pages
        self.slots[idx] = None

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device, non_blocking=False)


_PRESETS = {"llama3_8b": LlamaConfig.llama3_8b, "one_b": LlamaConfig.one_b,
            "tiny": LlamaConfig.tiny}


def build_engine(config: str | LlamaConfig = "llama3_8b", *, params: Any = None,
                 device: str | torch.device | None = None, seed: int = 0,
                 **kw: Any) -> GenerateEngine:
    """An engine for a Llama config (a preset name or a ``LlamaConfig``).
    Weights: ``params`` as a ``Llama`` already built, a JAX parameter tree
    as numpy arrays (``params_from_jax``), or — when None — random weights
    drawn on ``device`` from ``seed``. Runs on the card unless ``device``
    says otherwise; ``kw`` goes to ``GenerateEngine``."""
    dev = resolve_device(device)
    cfg = _PRESETS[config]() if isinstance(config, str) else config
    if isinstance(params, Llama):
        model = params
    elif params is not None:
        model = params_from_jax(cfg, params, dev)
    else:
        model = init(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    return GenerateEngine(model, device=dev, seed=seed, **kw)
