"""The quality plane: shadow-score sampled traffic against a reference
configuration (the port's own copy of gofr_tpu/metrics/quality.py).

For a sampled share of completed requests (``QUALITY_SHADOW_RATE``), the
request's exact emitted tokens are re-scored, teacher-forced (no
re-sampling, so the check is deterministic), through two arms:

- the **serving arm**: the served weights, the live pool's K/V format as a
  fake-quantized round trip (``ops.kvcache.fake_quant_row`` on int8,
  ``ops.quant.fake_quant_row_int4`` on int4, each with the pool's bf16
  scale) and the request's LoRA head;
- the **reference arm**: the same weights, dense K/V, no adapter.

Both arms are one ``Llama.forward`` over ``prompt + emitted`` padded to a
power-of-two bucket and masked by its length, so on the card both run
prefill attention through kernel C (``ops.attention.mha_attention``), the
serving arm on fake-quantized K/V. Only the rows that predicted the emitted
tokens reach the head product (``teacher_forced_rows``): Llama-3-8B's
logits over a 2048 bucket would take 1.05 GB in f32.

Per-token divergence rolls up into ``app_tpu_quality_{logprob_delta, kl,
top1_agree, first_divergence_token, samples_total, good_total}`` labelled
by what served the request (``kv_dtype``, ``backend``: ``cuda`` on the
card, ``plain`` on the CPU, where JAX names ``pallas`` / ``xla``;
``adapter``), and into the SLO engine's ``quality`` objective. Each scored
sample keeps its replay payload (prompt ids, emitted tokens, report) for
``snapshot``, which ``/debug/quality`` and the SLO capture bundles serve.

Scoring runs on the engine's device thread on idle loop turns only, one
arm a turn, and claims no slot and no page. A scorer fault is counted in
``errors`` and the sample dropped, never raised, except a kernel that does
not build, load or launch (``ops.cuda.KernelError``, and a CUDA error the
card raises): that propagates to the engine loop, which logs it and
restarts, since no kernel falls back. With the rate at 0 (the default) the
engine never builds the plane.
"""

from __future__ import annotations

import collections
import random
import threading
import time
from typing import Any, Callable

import numpy as np
import torch

from gofr_tpu_torch.ops import cuda
from gofr_tpu_torch.ops.attention import mha_attention
from gofr_tpu_torch.ops.kvcache import fake_quant_row
from gofr_tpu_torch.ops.lora import lora_logits_delta
from gofr_tpu_torch.ops.quant import fake_quant_row_int4, qdot

__all__ = [
    "QualityPlane",
    "divergence_report",
    "make_adapter_head_fn",
    "make_serving_attn_fn",
    "teacher_forced_rows",
]

# faults the scorer never absorbs: a kernel that failed, or the card's own
# error (a sticky fault every later call raises too)
KERNEL_FAULTS: tuple[type[BaseException], ...] = (
    (cuda.KernelError,) + ((torch.AcceleratorError,) if hasattr(torch, "AcceleratorError")
                           else ()))
# the same faults where PyTorch raises them as a plain RuntimeError: a CUDA
# error, or a cuBLAS or cuDNN status from a library product of the forward
DEVICE_FAULT_MARKS = ("CUDA error", "CUBLAS_STATUS_", "CUDNN_STATUS_", "cuDNN error")


def is_device_fault(e: BaseException) -> bool:
    """Whether ``e`` is a kernel's or the card's fault, which the scorer
    raises to the loop and never counts as its own."""
    return isinstance(e, KERNEL_FAULTS) or (
        isinstance(e, RuntimeError) and any(m in str(e) for m in DEVICE_FAULT_MARKS))


# -- scoring helpers (quality.py:55-178) ------------------------------------------


def _pow2_bucket(n: int, max_len: int) -> int:
    """The padded length of a shadow sequence: a power of two from 16, at
    most ``max_len`` (but never below ``n``), as JAX's bucket ladder."""
    b = 16
    while b < n:
        b *= 2
    return max(n, min(b, max_len)) if max_len else b


_ATTN_CACHE: dict[str, Any] = {}


def make_serving_attn_fn(kv_dtype: str):
    """The serving arm's attention: K/V through the live pool's row
    quantization and its bf16 scale, then ``mha_attention`` (kernel C on
    the card). None for a dense pool, where the serving arm is the
    reference. One function object per format."""
    kv_dtype = kv_dtype or "bf16"
    if kv_dtype in ("", "bf16", "dense"):
        return None
    if kv_dtype in _ATTN_CACHE:
        return _ATTN_CACHE[kv_dtype]
    if kv_dtype == "int8":
        fq = fake_quant_row
    elif kv_dtype == "int4":
        fq = fake_quant_row_int4
    else:
        raise ValueError(f"unknown kv_dtype {kv_dtype!r}: use bf16, int8 or int4")

    def attn(q, k, v, *, causal=True, kv_lengths=None):
        return mha_attention(q, fq(k), fq(v), causal=causal, kv_lengths=kv_lengths)

    _ATTN_CACHE[kv_dtype] = attn
    return attn


def make_adapter_head_fn(a: np.ndarray, b: np.ndarray, scale: float,
                         device: str | torch.device = "cpu"):
    """The head hook of a request's LoRA adapter, as serving computes it
    (``ops.lora.lora_logits_delta`` over a one-slot pool in f32): the base
    product in the model's dtype plus the f32 low-rank delta, so a zero
    delta leaves the base logits bit for bit."""
    pool = (torch.zeros(1, dtype=torch.long, device=device),
            torch.as_tensor(np.asarray(a, np.float32), device=device)[None],
            torch.as_tensor(np.asarray(b, np.float32), device=device)[None],
            torch.tensor([float(scale)], dtype=torch.float32, device=device))

    def head_fn(x, head):
        # x [1, T, E] is lora_logits_delta's [N, T, E] verify layout
        return qdot(x, head).float() + lora_logits_delta(x, pool)

    return head_fn


def _base_head(x, head):
    return qdot(x, head)


def teacher_forced_rows(model, prompt, emitted, *, attn_fn=None, head_fn=None) -> np.ndarray:
    """The logits that predicted each emitted token, teacher-forced: the
    whole ``prompt + emitted`` through ``model.forward`` (padded to its
    power-of-two bucket, masked by its length), rows ``[len(prompt) - 1,
    + T)``, f32 ``[T, vocab]`` on the host. Only those rows reach the
    head product; the function is JAX's ``teacher_forced_rows``
    (quality.py:125) row for row. Deterministic: the same inputs give
    the same bucket and the same rows, bit for bit."""
    seq = [int(x) for x in prompt] + [int(x) for x in emitted]
    n, t = len(seq), len(emitted)
    if t < 1 or len(prompt) < 1:
        raise ValueError("teacher-forced scoring needs >=1 prompt and emitted token")
    bucket = _pow2_bucket(n, int(getattr(model.cfg, "max_seq_len", 0)))
    padded = torch.zeros((1, bucket), dtype=torch.long)
    padded[0, :n] = torch.tensor(seq, dtype=torch.long)
    dev = model.device
    lo = len(prompt) - 1
    head = head_fn or _base_head

    def rows_head(x, w):
        return head(x[:, lo:lo + t], w)

    logits = model.forward(padded.to(dev), torch.tensor([n], device=dev), attn_fn, rows_head)
    return logits[0].float().cpu().numpy()


def _log_softmax(rows: np.ndarray) -> np.ndarray:
    z = rows.astype(np.float64)
    z = z - z.max(axis=-1, keepdims=True)
    return z - np.log(np.exp(z).sum(axis=-1, keepdims=True))


def divergence_report(serving_rows: np.ndarray, ref_rows: np.ndarray,
                      emitted) -> dict[str, Any]:
    """Per-token divergence of one emitted sequence (quality.py:156):
    the serving minus the reference log-prob of each emitted token (mean
    and max absolute), KL(serving || reference) per position (mean, max),
    ``top1_agree``, the share of positions where the reference argmax is
    the token the engine emitted (so a live corruption the arms cannot
    reproduce still shows), ``first_divergence`` (-1: none) and the
    per-token ``agree`` mask."""
    emitted = np.asarray(list(emitted), np.int64)
    t = emitted.shape[0]
    ls = _log_softmax(serving_rows)
    lr = _log_softmax(ref_rows)
    idx = np.arange(t)
    delta = ls[idx, emitted] - lr[idx, emitted]
    kl = (np.exp(ls) * (ls - lr)).sum(axis=-1)
    ref_top1 = lr.argmax(axis=-1)
    agree = ref_top1 == emitted
    first = int(np.argmax(~agree)) if not agree.all() else -1
    return {
        "tokens": int(t),
        "logprob_delta_mean_abs": float(np.abs(delta).mean()),
        "logprob_delta_max_abs": float(np.abs(delta).max()),
        "kl_mean": float(np.maximum(kl, 0.0).mean()),
        "kl_max": float(np.maximum(kl, 0.0).max()),
        "top1_agree": float(agree.mean()),
        "first_divergence": first,
        "agree": [int(x) for x in agree],
    }


# -- the plane (quality.py:181-400) -----------------------------------------------


class QualityPlane:
    """An engine's shadow-scoring state machine.

    ``maybe_capture`` (device thread, at a request's completion) samples
    finished requests into a bounded pending queue, dropping the oldest
    under pressure. ``step`` (device thread, idle turns) runs ONE arm of one
    sample a call and says whether it did work. ``snapshot`` (any thread)
    serves ``/debug/quality`` and the capture bundles. ``model_fn`` returns
    the model being served, read at each arm, so a weight adoption is
    scored with the weights it installed."""

    def __init__(self, model_fn: Callable[[], Any], *, metrics=None, slo=None,
                 rate: float = 0.0, seed: int = 0, kv_dtype: str = "bf16",
                 backend_fn: Callable[[], str] | None = None,
                 adapter_fn: Callable[[str], tuple | None] | None = None,
                 max_pending: int = 16, max_tokens: int = 64,
                 top1_min: float = 0.9, kl_max: float = 1.0, recent: int = 32):
        self.model_fn = model_fn
        self.metrics = metrics
        self.slo = slo
        self.rate = max(0.0, min(1.0, float(rate)))
        self.kv_dtype = kv_dtype or "bf16"
        self.backend_fn = backend_fn
        self.adapter_fn = adapter_fn
        self.max_pending = max(1, int(max_pending))
        self.max_tokens = max(1, int(max_tokens))
        self.top1_min = float(top1_min)
        self.kl_max = float(kl_max)
        # the seeded schedule of JAX's plane: one seed and completion order
        # pick the same requests
        self._rng = random.Random((int(seed) << 1) ^ 0x9E3779B9)
        self._pending: collections.deque = collections.deque()
        self._inflight: dict[str, Any] | None = None
        self._recent: collections.deque = collections.deque(maxlen=max(1, int(recent)))
        self._lock = threading.Lock()
        self.samples = 0   # fully scored
        self.good = 0      # scored and within thresholds
        self.dropped = 0   # sampled, then evicted from the pending queue
        self.errors = 0    # scoring faults (never raised to serving)
        # one head hook per adapter and factors
        self._head_cache: dict[str, tuple[tuple, Any]] = {}

    # -- capture (at a request's completion) ----------------------------------

    def maybe_capture(self, prompt_tokens, emitted, *, adapter: str | None = None,
                      qos_class: str | None = None, weights_epoch: int = 0,
                      request_id: Any = None) -> bool:
        """Roll the dice for one finished request; when it is picked,
        queue a sample (a copy of its ids; the device work comes later)."""
        if self.rate <= 0.0 or len(emitted) < 1 or len(prompt_tokens) < 1:
            return False
        if self.rate < 1.0 and self._rng.random() >= self.rate:
            return False
        sample = {
            "request_id": request_id,
            "prompt": [int(x) for x in prompt_tokens],
            "emitted": [int(x) for x in emitted[: self.max_tokens]],
            "emitted_total": int(len(emitted)),
            "adapter": adapter,
            "qos_class": qos_class,
            "weights_epoch": int(weights_epoch),
            "ts": time.time(),
        }
        if adapter and self.adapter_fn is not None:
            # the factors now: the registry entry may be replaced before an
            # idle turn scores the sample
            sample["_adapter_factors"] = self.adapter_fn(adapter)
        with self._lock:
            self._pending.append(sample)
            while len(self._pending) > self.max_pending:
                self._pending.popleft()
                self.dropped += 1
                if self.metrics is not None:
                    self.metrics.increment_counter("app_tpu_quality_shadow_dropped_total", 1)
        return True

    @property
    def pending(self) -> int:
        with self._lock:
            n = len(self._pending)
        return n + (1 if self._inflight is not None else 0)

    # -- scoring (idle turns) -----------------------------------------------------

    def step(self) -> bool:
        """Run one arm of one sample; True when it did device work (the
        loop then looks for traffic before the next arm). A fault is
        counted and the sample dropped; a kernel's or the card's fault is
        raised (``is_device_fault``). An asynchronous fault surfaces inside
        the arm: its rows' copy to the host waits for the card."""
        s = self._inflight
        if s is None:
            with self._lock:
                if not self._pending:
                    return False
                s = self._inflight = self._pending.popleft()
        try:
            if "_serving_rows" not in s:
                s["_serving_rows"] = self._score(s, serving=True)
                return True
            ref_rows = self._score(s, serving=False)
            self._finalize(s, s.pop("_serving_rows"), ref_rows)
        except Exception as e:  # noqa: BLE001 - a diagnostics plane, never fatal to serving
            if is_device_fault(e):
                self._inflight = None
                raise
            with self._lock:
                self.errors += 1
            self._inflight = None
        else:
            if "_serving_rows" not in s:
                self._inflight = None
        return True

    def _score(self, s: dict[str, Any], *, serving: bool) -> np.ndarray:
        model = self.model_fn()
        attn_fn = make_serving_attn_fn(self.kv_dtype) if serving else None
        head_fn = None
        if serving:
            factors = s.get("_adapter_factors")
            if factors is not None:
                a, b, scale = factors
                key = (id(a), id(b), float(scale))
                cached = self._head_cache.get(s["adapter"])
                if cached is None or cached[0] != key:
                    cached = (key, make_adapter_head_fn(a, b, scale, model.device))
                    self._head_cache[s["adapter"]] = cached
                head_fn = cached[1]
        return teacher_forced_rows(model, s["prompt"], s["emitted"], attn_fn=attn_fn,
                                   head_fn=head_fn)

    def _finalize(self, s: dict[str, Any], serving_rows: np.ndarray,
                  ref_rows: np.ndarray) -> None:
        report = divergence_report(serving_rows, ref_rows, s["emitted"])
        ok = report["top1_agree"] >= self.top1_min and report["kl_mean"] <= self.kl_max
        labels = {
            "kv_dtype": self.kv_dtype,
            "backend": self.backend_fn() if self.backend_fn is not None else "plain",
            "adapter": s.get("adapter") or "base",
        }
        m = self.metrics
        if m is not None:
            m.record_histogram("app_tpu_quality_logprob_delta",
                               report["logprob_delta_mean_abs"], **labels)
            m.record_histogram("app_tpu_quality_kl", report["kl_mean"], **labels)
            m.set_gauge("app_tpu_quality_top1_agree", report["top1_agree"], **labels)
            if report["first_divergence"] >= 0:
                m.record_histogram("app_tpu_quality_first_divergence_token",
                                   report["first_divergence"], **labels)
            m.increment_counter("app_tpu_quality_samples_total", 1, **labels)
            if ok:
                m.increment_counter("app_tpu_quality_good_total", 1, **labels)
        if self.slo is not None:
            observe = getattr(self.slo, "observe_quality", None)
            if callable(observe):
                observe(s.get("qos_class"), ok)
        entry = {k: v for k, v in s.items() if not k.startswith("_")}
        entry["labels"] = labels
        entry["ok"] = ok
        entry["report"] = report
        with self._lock:
            self.samples += 1
            if ok:
                self.good += 1
            self._recent.append(entry)

    # -- host side ---------------------------------------------------------------------

    def drain(self, timeout: float = 30.0) -> bool:
        """Block until the engine's idle turns have scored every pending
        sample, or ``timeout`` passes (tests and the smoke run)."""
        deadline = time.monotonic() + timeout
        while self.pending:
            if time.monotonic() > deadline:
                return False
            time.sleep(0.01)
        return True

    def snapshot(self, *, replay: bool = True) -> dict[str, Any]:
        """The plane's totals and its recent per-sample reports, with their
        replay payloads (prompt, emitted) unless ``replay`` is False."""
        with self._lock:
            recent = list(self._recent)
            out = {
                "rate": self.rate,
                "kv_dtype": self.kv_dtype,
                "pending": len(self._pending) + (1 if self._inflight else 0),
                "samples": self.samples,
                "good": self.good,
                "dropped": self.dropped,
                "errors": self.errors,
                "thresholds": {"top1_min": self.top1_min, "kl_max": self.kl_max},
            }
        if not replay:
            recent = [{k: v for k, v in e.items() if k not in ("prompt", "emitted")}
                      for e in recent]
        out["recent"] = recent
        return out
