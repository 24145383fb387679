"""Warmup-time split-plan autotuner for the decode attention kernels (the
port's counterpart of gofr_tpu/ops/autotune.py).

The JAX tuner races two backends, Pallas and XLA, for each decode attention
op. The port has one backend, its hand-written kernels; their plain PyTorch
versions exist for the tests and are never served. What the port races
instead is the **split plan** of the same kernel: kernels A, D, E and F cut
each slot into runs of ``split_rows`` positions (``ops/cuda/
decode_attention.split_plan``, a rule on the shapes alone), and the tuner
times the rule's plan against a few others (``split_candidates``) on the
engine's shapes at ``engine.warmup()``, pins the rule's plan unless
another is clearly faster (below), and every
launch the engine drives inside its ``decision_scope`` at the measured shape
takes the pinned plan. The op keys are JAX's: ``decode`` (F, the bf16 slot
cache), ``paged_decode`` (A), ``paged_decode_q`` (D) and ``paged_decode_q4``
(E). A record's ``backend`` field holds the plan's name, ``rows<N>``
(``plan_name``), so the cache file keeps JAX's format.

Differences from JAX:

- ``enabled(device)`` is false on the CPU, the counterpart of JAX standing
  down under the Pallas interpreter: a plain version's timings say nothing
  about the card. ``GOFR_AUTOTUNE=0`` still turns the tuner off.
  ``GOFR_PALLAS`` is not read: the port has no Pallas/XLA choice.
- The default timer is best-of-3 on CUDA events after one untimed burst,
  each of the 3 a burst of ``BURST`` back-to-back calls: around one call
  alone the events also time the launcher's host work, which on the H100
  is as long as the kernel (A and F: 29-50 us of host a launch against
  29-42 us of device time, scripts/torch_launcher_cost.py, NVIDIA H100
  80GB HBM3, 700 W). It returns the best burst and the spread of the
  three (``Timing``). The untimed burst is there because the candidate
  timed first, the rule's plan, read the largest spread of the five plans
  in four of five engines after a single untimed call (chip_smoke.py
  paged_autotune and app_transports, NVIDIA H100 80GB HBM3, 700 W). It
  runs only inside warmup, before the engine serves.
- The first candidate is the rule's plan, and it stays pinned unless
  another beats it by more than the timer's spread (the larger of the
  two candidates' ``spread``): between plans whose times differ by less
  than the timer can tell apart, the tuner keeps the rule, so two runs of
  the same shapes pin the same plan. On timings without a spread (a bare
  float, as the tests give) this is JAX's rule, the fastest, the first
  on a tie.
- Only ``Disqualified`` (a plan whose output disagrees with the rule's)
  loses quietly, recorded under ``errors``. Anything else a candidate
  raises, and anything the rule's plan raises, propagates: a kernel that
  fails fails warmup, as a device fault is never absorbed. JAX records
  every failing candidate and pins ``xla`` when all fail; the port has no
  everywhere-correct second backend to pin.
- The cache file is ``GOFR_AUTOTUNE_CACHE`` with ``.torch`` appended.
  JAX's ``_load_cache`` keeps only entries whose backend is ``pallas`` or
  ``xla`` and its ``_persist`` rewrites the file from that filtered read,
  so one shared file would lose each package's entries to the other's next
  write. This module's ``_load_cache`` keeps only ``rows<N>`` entries.
- A pin carries the shape it was measured at (``decision_scope(pins,
  shapes)``): ``pinned_plan(op, dims)`` answers only for those dims, so a
  launch of another shape (a spec draft's, a test's) keeps the rule's plan.
- The engine times each plan as JAX does, at full occupancy and full
  lengths: the worst case the shapes allow, not the ragged lengths it
  serves, which the shape key cannot see. Whether a pin moves decode
  tok/s end to end is for a benchmark cell to show.

Decisions persist keyed by ``device_kind|op|shape|kv_dtype`` (``|role=`` for
a role worker), so a restarted engine's warmup pins without touching the
card. Corrupt files, version mismatches and malformed entries are ignored
(re-measured), never fatal.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import re
import time
from typing import Any, Callable, NamedTuple

FORMAT_VERSION = 1
CACHE_SUFFIX = ".torch"
BURST = 10
_PLAN = re.compile(r"^rows(\d+)$")

# {op: (split_rows, shape dims)} pinned for the launches inside a
# decision_scope, read by ops/cuda/decode_attention.split_scratch
_PINS: contextvars.ContextVar[dict[str, tuple[int, tuple[int, ...]]] | None] = (
    contextvars.ContextVar("gofr_torch_autotune_pins", default=None))

# the most recent report an engine's tuner produced in this process
_LAST_REPORT: dict[str, Any] | None = None


class Disqualified(RuntimeError):
    """A candidate plan whose output disagrees with the rule's plan: it
    loses, recorded under ``errors``, and warmup goes on."""


class Timing(NamedTuple):
    """What the default timer gives: seconds a call (the best burst) and
    the spread of its bursts (slowest less best), in seconds."""
    best: float
    spread: float


def enabled(device: Any = None) -> bool:
    """Should warmup measure and pin? Only for an engine on the card, and
    not under ``GOFR_AUTOTUNE=0``."""
    if os.environ.get("GOFR_AUTOTUNE", "") == "0":
        return False
    return getattr(device, "type", device) == "cuda"


def cache_path() -> str | None:
    base = os.environ.get("GOFR_AUTOTUNE_CACHE")
    return base + CACHE_SUFFIX if base else None


def plan_name(split_rows: int) -> str:
    return f"rows{int(split_rows)}"


def plan_rows(name: str) -> int | None:
    """The ``split_rows`` a plan name stands for, or None for a name that
    is not a plan (a JAX backend, garbage)."""
    m = _PLAN.match(name) if isinstance(name, str) else None
    return int(m.group(1)) if m else None


@contextlib.contextmanager
def decision_scope(pins: dict[str, str], shapes: dict[str, str]):
    """Pin ``{op: plan}`` for every launch inside the scope, each at its
    shape key in ``shapes``."""
    tok = _PINS.set({op: (plan_rows(name), tuple(int(d) for d in shapes[op].split("x")))
                     for op, name in pins.items()} or None)
    try:
        yield
    finally:
        _PINS.reset(tok)


def pinned_plan(op: str, dims: tuple[int, ...]) -> int | None:
    """The ``split_rows`` pinned for ``op`` when the launch's ``dims`` are
    the ones it was measured at; else None. One context-variable read
    when nothing is pinned, a tuple compare when something is."""
    pins = _PINS.get()
    if pins:
        pin = pins.get(op)
        if pin is not None and pin[1] == dims:
            return pin[0]
    return None


def shape_key(*dims: int) -> str:
    return "x".join(str(int(d)) for d in dims)


def entry_key(device_kind: str, op: str, shape: str, kv_dtype: str, role: str = "") -> str:
    """Cache key; a role worker's ``role`` is appended, as in JAX (the
    port shards no pool, so JAX's ``|shard=`` never applies)."""
    key = "|".join((str(device_kind), op, shape, str(kv_dtype)))
    if role and role != "both":
        key += f"|role={role}"
    return key


def set_last_report(report: dict[str, Any] | None) -> None:
    global _LAST_REPORT
    _LAST_REPORT = report


def last_report() -> dict[str, Any] | None:
    return _LAST_REPORT


def _default_timer(fn: Callable[[], Any], repeats: int = 3) -> Timing:
    """Seconds a call on the card's events: the best of ``repeats`` bursts
    of ``BURST`` calls, after one untimed burst, and the bursts' spread."""
    import torch

    for _ in range(BURST):
        fn()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(BURST):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1000.0 / BURST)
    return Timing(min(times), max(times) - min(times))


def _load_cache(path: str | None, logger: Any = None) -> dict[str, dict]:
    """Entries from the cache file; {} for a missing, corrupt or stale file
    (a bad cache costs one re-measure, never a failed warmup)."""
    if not path or not os.path.exists(path):
        return {}
    try:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
        if not isinstance(doc, dict) or doc.get("version") != FORMAT_VERSION:
            raise ValueError(f"version {doc.get('version')!r} != {FORMAT_VERSION}")
        entries = doc.get("entries")
        if not isinstance(entries, dict):
            raise ValueError("no entries dict")
        return {key: rec for key, rec in entries.items()
                if isinstance(rec, dict) and plan_rows(rec.get("backend")) is not None}
    except Exception as e:  # noqa: BLE001 - a corrupt or stale cache is re-measured
        if logger is not None:
            logger.warn(f"ignoring autotune cache {path}: {e}")
        return {}


class Autotuner:
    """Times plan candidates per (op, shape, kv dtype) and records the
    winner. ``timer`` is injectable (the tests pin fake timings);
    ``cache_file`` carries decisions across restarts."""

    def __init__(self, device_kind: str = "cpu", cache_file: str | None = None,
                 timer: Callable[[Callable[[], Any]], float] | None = None,
                 logger: Any = None, role: str = ""):
        self.device_kind = device_kind
        self.cache_file = cache_file
        self.timer = timer or _default_timer
        self.logger = logger
        self.role = role if role not in ("", "both") else ""
        self.decisions: dict[str, dict] = {}  # op -> decision record
        self._cache = _load_cache(cache_file, logger)  # lookups only
        self._own: dict[str, dict] = {}  # keys this tuner decided (persisted)

    def measure(self, op: str, shape: str, kv_dtype: str,
                candidates: dict[str, Callable[[], Any]]) -> str:
        """Pin a plan for ``op``: a cache hit, else the rule's plan (the
        first candidate) unless another beats it by more than the timer's
        spread (then the fastest of those, the first on a tie), else the
        only one, untimed. A candidate that raises ``Disqualified`` loses
        and is recorded under ``errors``; anything else raised, and any
        failure of the rule's plan, propagates."""
        key = entry_key(self.device_kind, op, shape, kv_dtype, self.role)
        cached = self._cache.get(key)
        if cached is not None and cached.get("backend") in candidates:
            rec = {"backend": cached["backend"], "shape": shape, "kv_dtype": kv_dtype,
                   "timings_ms": cached.get("timings_ms", {}), "source": "cache"}
            self.decisions[op] = rec
            return rec["backend"]

        if len(candidates) == 1:
            backend = next(iter(candidates))
            rec = {"backend": backend, "shape": shape, "kv_dtype": kv_dtype,
                   "timings_ms": {}, "source": "only_candidate"}
        else:
            timings: dict[str, float] = {}
            spreads: dict[str, float] = {}
            errors: dict[str, str] = {}
            rule = next(iter(candidates))
            for name, fn in candidates.items():
                try:
                    t = self.timer(fn)
                except Disqualified as e:
                    if name == rule:
                        raise
                    errors[name] = str(e)[:200]
                    continue
                best, spread = t if isinstance(t, tuple) else (t, 0.0)
                timings[name] = round(best * 1000.0, 4)
                spreads[name] = round(spread * 1000.0, 4)
            beat = [n for n in timings
                    if timings[n] + max(spreads[n], spreads[rule]) < timings[rule]]
            backend = min(beat, key=lambda n: timings[n]) if beat else rule
            rec = {"backend": backend, "shape": shape, "kv_dtype": kv_dtype,
                   "timings_ms": timings, "source": "measured"}
            if any(spreads.values()):
                rec["spread_ms"] = spreads
            if errors:
                rec["errors"] = errors
        self.decisions[op] = rec
        self._persist(key, rec)
        return rec["backend"]

    def _persist(self, key: str, rec: dict) -> None:
        entry = {"backend": rec["backend"], "timings_ms": rec.get("timings_ms", {}),
                 "at": time.time()}
        self._cache[key] = entry
        self._own[key] = entry
        if not self.cache_file:
            return
        try:
            # read-merge-write of only the keys this tuner decided, so a
            # fresher measurement of another process survives; the rename
            # is atomic, so a crash never leaves a torn file
            merged = _load_cache(self.cache_file, self.logger)
            merged.update(self._own)
            tmp = f"{self.cache_file}.tmp.{os.getpid()}"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump({"version": FORMAT_VERSION, "entries": merged}, f, indent=1)
            os.replace(tmp, self.cache_file)
        except Exception as e:  # noqa: BLE001 - persistence saves a re-measure, no more
            if self.logger is not None:
                self.logger.warn(f"could not persist autotune cache {self.cache_file}: {e}")

    def pins(self) -> dict[str, str]:
        return {op: rec["backend"] for op, rec in self.decisions.items()}

    def shapes(self) -> dict[str, str]:
        return {op: rec["shape"] for op, rec in self.decisions.items()}

    def report(self) -> dict[str, Any]:
        out: dict[str, Any] = {"device_kind": self.device_kind, "decisions": dict(self.decisions)}
        if self.role:
            out["role"] = self.role
        return out


__all__ = [
    "Autotuner", "Disqualified", "Timing", "cache_path", "decision_scope", "enabled",
    "entry_key", "last_report", "pinned_plan", "plan_name", "plan_rows", "set_last_report",
    "shape_key",
]
