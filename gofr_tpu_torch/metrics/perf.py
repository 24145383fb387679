"""Live engine performance plane: per-step roofline attribution (the
port's own copy of gofr_tpu/metrics/perf.py, priced against the H100).

An analytical per-step cost model (FLOPs + HBM bytes from the step's
ACTUAL shapes) divided by measured per-step device time against a
``device name -> (peak FLOPs, peak HBM bytes/s)`` table, yielding live
windowed ``app_tpu_{mfu,mbu}{kind,kv_dtype}`` gauges (the JAX package's
names), per-kind device-time histograms, and a pipeline-bubble ratio on
the engine's in-flight queue ``_dq``.

Device time is the JAX plane's: device-queue residency, dispatch to the
moment the fold's readback returned (``t_ready``, stamped where
``Readback.wait`` returns), clipped against the previous step's ready
time so overlapped calls never double-count. It is NOT a CUDA-event
interval: on a host-bound loop a step's residency includes the time the
card waited for the host to launch it, and the plane's MBU reads that
way.

Three design rules keep the plane honest:

* **Exact bytes, not nominal dtypes.** The per-position KV footprint is
  read off the live pool tensors (``sum(t.nbytes) / positions``), and the
  weight bytes from ``ops.quant.quantized_bytes``.
* **Sum parts, never average ratios.** Every merge point (engines in one
  container) sums FLOPs/bytes numerators and ``device_s * peak`` capacity
  denominators; the ratio is derived once, at the edge.
  ``aggregate([a, b]) == aggregate([a + b])`` exactly.
* **No host sync.** Every input is host state: slot positions, page
  counts, pool byte sizes from ``nbytes``.

FLOPs convention: ``2 * n_params * tokens`` (the forward-pass MAC count).
Attention FLOPs are *excluded* — on the decode path they are bandwidth,
not compute, which is exactly why the bytes side DOES count the streamed
history. MFU here is therefore a slight *under*-estimate at long context;
MBU is the honest number this plane exists for.

Peak resolution order (first hit wins), per component (the JAX package's
override names):

1. ``GOFR_TPU_PEAK_TFLOPS`` / ``GOFR_TPU_PEAK_GBS`` — operator says so.
2. ``GOFR_DEVICE_PEAKS`` — JSON ``{"name-substring": [tflops, gbs]}``
   for a card the builtin table hasn't met yet.
3. The builtin table: the H100 SXM part (``NVIDIA H100 80GB HBM3``) at its
   data sheet's dense bf16 989 TFLOP/s and 3.35 TB/s, which assume the
   700 W power limit. The ``cpu`` entry is a NOMINAL reference envelope
   (1 TFLOP/s, 50 GB/s) so CPU runs exercise the full plane end to end;
   it is not a hardware claim and is labelled ``nominal`` wherever it
   surfaces.
4. Unknown device (the PCIe H100 among them), no override: peaks degrade
   to ``None`` — utilization gauges go unreported rather than wrong; raw
   FLOPs/bytes/seconds still flow.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Iterable

# H100 SXM (``torch.cuda.get_device_name``: "NVIDIA H100 80GB HBM3") data
# sheet: dense bf16 tensor-core FLOP/s and HBM3 bytes/s at its 700 W
# limit. chip_smoke.py prices its kernels' bounds with the same pair.
H100_SXM_BF16_FLOPS = 989e12
H100_SXM_HBM_BYTES_PER_S = 3.35e12

# Substring match on the lowered device name, longest key first.
DEFAULT_PEAKS: dict[str, tuple[float, float]] = {
    "h100 80gb hbm3": (H100_SXM_BF16_FLOPS, H100_SXM_HBM_BYTES_PER_S),
    # NOMINAL envelope for CPU runs (see module docstring) — makes the
    # full MFU/MBU plane light up under tests without a card.
    "cpu": (1e12, 50e9),
}


def device_peaks(device_kind: str) -> tuple[float, float] | None:
    """Resolve ``device_kind`` (a card's name, or ``cpu``) to
    ``(peak_flops_per_s, peak_hbm_bytes_per_s)`` or None for an unknown
    card (resolution order in the module docstring).
    Env is read per call — tests and late operator overrides both want
    that, and this runs at scrape/snapshot cadence, never per step."""
    kind = (device_kind or "").lower()
    flops = bw = None
    table = dict(DEFAULT_PEAKS)
    raw = os.environ.get("GOFR_DEVICE_PEAKS", "")
    if raw:
        try:
            for k, v in json.loads(raw).items():
                table[str(k).lower()] = (float(v[0]) * 1e12, float(v[1]) * 1e9)
        except (ValueError, TypeError, IndexError, KeyError):
            pass  # a malformed override must not take the plane down
    for key in sorted(table, key=len, reverse=True):
        if key in kind:
            flops, bw = table[key]
            break
    env_f = os.environ.get("GOFR_TPU_PEAK_TFLOPS")
    if env_f:
        try:
            flops = float(env_f) * 1e12
        except ValueError:
            pass
    env_b = os.environ.get("GOFR_TPU_PEAK_GBS")
    if env_b:
        try:
            bw = float(env_b) * 1e9
        except ValueError:
            pass
    if flops is None or bw is None:
        return None
    return flops, bw


# -- occupancy bands (step controller evidence keys) -------------------------

# Slot-occupancy bands the control plane buckets evidence by: a knob that
# wins at a packed batch ("hi") can lose at a near-empty one ("lo"), so
# pins are per band. Boundaries are coarse on purpose — finer bands would
# starve each bucket of evidence at the controller's tick cadence.
OCCUPANCY_BANDS: tuple[tuple[str, float], ...] = (
    ("lo", 0.35), ("mid", 0.70), ("hi", float("inf")))


def occupancy_band(occupancy: float | None) -> str:
    """Map a step's batch occupancy (0..1) to its evidence band."""
    occ = 0.0 if occupancy is None else float(occupancy)
    for name, hi in OCCUPANCY_BANDS:
        if occ < hi:
            return name
    return OCCUPANCY_BANDS[-1][0]


# -- per-step cost model -----------------------------------------------------


class CostModel:
    """Analytical FLOPs/bytes for one engine's step kinds, from the
    engine's ACTUAL geometry: parameter count/bytes (post-quantization),
    the exact per-position KV-pool footprint, and the paged-pool page
    byte size. Pure arithmetic — every method is safe under any lock."""

    __slots__ = ("n_params", "weight_bytes", "kv_bytes_per_pos",
                 "page_bytes", "page_size", "kv_dtype", "kv_shards")

    def __init__(self, *, n_params: float, weight_bytes: float,
                 kv_bytes_per_pos: float, page_bytes: float = 0.0,
                 page_size: int = 0, kv_dtype: str = "bf16",
                 kv_shards: int = 1):
        self.n_params = float(n_params)
        self.weight_bytes = float(weight_bytes)
        # on a tp-sharded pool (JAX; the port serves one card, 1) the
        # engine passes PER-DEVICE byte figures: every roofline this model
        # prices is a per-device bound
        self.kv_bytes_per_pos = float(kv_bytes_per_pos)
        self.page_bytes = float(page_bytes)
        self.page_size = int(page_size)
        self.kv_dtype = kv_dtype or "bf16"
        self.kv_shards = max(1, int(kv_shards))

    def prefill(self, tokens: int) -> tuple[float, float]:
        """Batched prefill of ``tokens`` real prompt tokens (padding
        excluded): one weight pass + every position's KV write."""
        flops = 2.0 * self.n_params * tokens
        bytes_ = self.weight_bytes + tokens * self.kv_bytes_per_pos
        return flops, bytes_

    def chunk(self, chunk: int, offset: int) -> tuple[float, float]:
        """One prefill chunk at ``offset``: the chunk's weight pass and
        KV writes, plus the attention re-read of everything cached so
        far (chunked prefill's extra bandwidth cost vs one-shot)."""
        flops = 2.0 * self.n_params * chunk
        bytes_ = (self.weight_bytes
                  + (offset + chunk) * self.kv_bytes_per_pos   # attn read
                  + chunk * self.kv_bytes_per_pos)             # writes
        return flops, bytes_

    def decode(self, lanes: int, k: int, hist_positions: int) -> tuple[float, float]:
        """One decode chunk: ``k`` sequential micro-steps over ``lanes``
        lanes. Weights stream once per micro-step; each micro-step's
        attention reads the lanes' combined history (``hist_positions``
        — pages-touched * page_size on paged, positions on slot, a
        dispatch-time floor since history grows within the chunk); each
        emitted token writes its KV row."""
        flops = 2.0 * self.n_params * lanes * k
        bytes_ = (k * self.weight_bytes
                  + k * hist_positions * self.kv_bytes_per_pos
                  + lanes * k * self.kv_bytes_per_pos)
        return flops, bytes_

    def spec(self, lanes: int, k: int, g: int,
             hist_positions: int) -> tuple[float, float]:
        """One speculative round: ``k`` micro-steps, each verifying
        ``g`` drafts + 1 bonus position per lane on the target — the
        work is done for every proposed position whether or not the
        fold accepts it (rejection waste shows up as MFU spent without
        tokens emitted, which is the point of metering it)."""
        flops = 2.0 * self.n_params * lanes * k * (g + 1)
        bytes_ = (k * self.weight_bytes
                  + k * hist_positions * self.kv_bytes_per_pos
                  + lanes * k * (g + 1) * self.kv_bytes_per_pos)
        return flops, bytes_

    def swapin(self, nbytes: float) -> tuple[float, float]:
        """Host->device page upload: pure transfer, no FLOPs."""
        return 0.0, float(nbytes)

    def handoff_export(self, pages: int) -> tuple[float, float]:
        """Device->host copy of ``pages`` pool pages for a prefill-role
        KV handoff: pure transfer, no FLOPs."""
        return 0.0, pages * self.page_bytes

    def describe(self) -> dict[str, float | str]:
        return {
            "n_params": self.n_params,
            "weight_bytes": self.weight_bytes,
            "kv_bytes_per_pos": round(self.kv_bytes_per_pos, 6),
            "page_bytes": self.page_bytes,
            "page_size": self.page_size,
            "kv_dtype": self.kv_dtype,
            "kv_shards": self.kv_shards,
        }


class StepPerf:
    """One dispatched device call's perf record: cost filled at dispatch
    from the step's actual shapes, timestamps stamped along the ``_dq``
    lifecycle (``t_dispatch`` at dispatch, ``t_ready`` right after the
    blocking readback), residency derived at fold by
    :meth:`PerfPlane.note` — ``device_s`` is the step's device-queue
    residency with pipeline overlap deduplicated, ``bubble_s`` the
    device-idle-while-work-queued gap in front of it."""

    __slots__ = ("kind", "flops", "bytes", "t_dispatch", "t_ready",
                 "device_s", "bubble_s", "fold_s")

    def __init__(self, kind: str, flops: float, bytes_: float, t_dispatch: float):
        self.kind = kind
        self.flops = float(flops)
        self.bytes = float(bytes_)
        self.t_dispatch = float(t_dispatch)
        self.t_ready: float | None = None
        self.device_s: float = 0.0
        self.bubble_s: float = 0.0
        self.fold_s: float = 0.0


class _SumRing:
    """Windowed float sums: ``buckets`` slots of ``width`` seconds each,
    recycled by epoch stamp (the slo.py ``_WindowRing`` discipline — no
    timers, O(buckets) on read, O(1) on write)."""

    __slots__ = ("_width", "_buckets", "_sums", "_epoch")

    def __init__(self, window_s: float, buckets: int = 30):
        self._width = max(window_s, 1e-6) / buckets
        self._buckets = buckets
        self._sums: list[dict[str, float]] = [{} for _ in range(buckets)]
        self._epoch = [-1] * buckets

    def add(self, now: float, **vals: float) -> None:
        idx = int(now / self._width)
        slot = idx % self._buckets
        if self._epoch[slot] != idx:
            self._epoch[slot] = idx
            self._sums[slot] = {}
        bucket = self._sums[slot]
        for k, v in vals.items():
            bucket[k] = bucket.get(k, 0.0) + v

    def sums(self, now: float, since: float | None = None) -> dict[str, float]:
        """Window sums; ``since`` (absolute seconds, same clock as ``add``)
        additionally drops buckets that started at or before it — the
        step controller reads per-tick deltas this way instead of the
        full rolling window, at bucket granularity."""
        idx = int(now / self._width)
        lo = idx - self._buckets + 1
        if since is not None:
            lo = max(lo, int(since / self._width) + 1)
        out: dict[str, float] = {}
        for slot in range(self._buckets):
            if self._epoch[slot] < lo:
                continue
            for k, v in self._sums[slot].items():
                out[k] = out.get(k, 0.0) + v
        return out


class PerfPlane:
    """One engine's live roofline accounting. Thread-safe: the device
    thread notes folded steps, and scrape/debug threads snapshot.

    Device-time semantics: with the pipeline overlapped, per-entry
    dispatch->ready spans double-count the device (entry t's wait covers
    entry t+1's compute). ``note`` therefore clips each step's residency
    to ``t_ready - max(t_dispatch, previous t_ready)`` — consecutive
    steps tile the device timeline exactly, so the window's
    ``device_s`` sum is true busy time. The gap in front of a step
    (``t_dispatch - floor``) is the PIPELINE BUBBLE: the device sat
    idle while this work existed. The engine loop calls
    :meth:`mark_no_work` from its idle branch so genuinely-empty
    periods (no queued work at all) advance the floor instead of
    counting as bubble."""

    def __init__(self, model: CostModel, device_kind: str,
                 *, window_s: float = 60.0, buckets: int = 30):
        self.model = model
        self.device_kind = str(device_kind)
        self.window_s = float(window_s)
        self._lock = threading.Lock()
        self._ring = _SumRing(self.window_s, buckets)
        self._gap_floor: float | None = None

    # -- step lifecycle (dispatch side: pure cost arithmetic) ---------------

    def step(self, kind: str, flops: float, bytes_: float,
             t_dispatch: float) -> StepPerf:
        return StepPerf(kind, flops, bytes_, t_dispatch)

    def step_prefill(self, tokens: int, t0: float) -> StepPerf:
        return self.step("prefill", *self.model.prefill(tokens), t0)

    def step_chunk(self, chunk: int, offset: int, t0: float) -> StepPerf:
        return self.step("prefill_chunk", *self.model.chunk(chunk, offset), t0)

    def step_decode(self, lanes: int, k: int, hist_positions: int,
                    t0: float) -> StepPerf:
        return self.step("decode", *self.model.decode(lanes, k, hist_positions), t0)

    def step_spec(self, lanes: int, k: int, g: int, hist_positions: int,
                  t0: float) -> StepPerf:
        return self.step("decode_spec",
                         *self.model.spec(lanes, k, g, hist_positions), t0)

    def step_swapin(self, nbytes: float, t0: float) -> StepPerf:
        return self.step("swapin", *self.model.swapin(nbytes), t0)

    # -- fold side ----------------------------------------------------------

    def note(self, p: StepPerf, now: float, band: str | None = None) -> StepPerf:
        """Account one folded step (engine `_record_step` calls this with
        ``t_ready`` stamped). Returns ``p`` with residency filled.
        ``band`` (an :func:`occupancy_band` label) additionally files the
        step under its band-labeled window — the step controller's
        evidence keys — without touching the kind-level accounting."""
        t_r = p.t_ready if p.t_ready is not None else now
        with self._lock:
            floor = self._gap_floor
            if floor is None:
                floor = p.t_dispatch
            p.bubble_s = max(0.0, p.t_dispatch - floor)
            p.device_s = max(t_r - max(p.t_dispatch, floor), 1e-9)
            p.fold_s = max(0.0, now - t_r)
            self._gap_floor = max(floor, t_r)
            vals = {f"{p.kind}.flops": p.flops,
                    f"{p.kind}.bytes": p.bytes,
                    f"{p.kind}.device_s": p.device_s,
                    f"{p.kind}.steps": 1.0,
                    "bubble_s": p.bubble_s,
                    "busy_s": p.device_s}
            if band is not None:
                # "bd." prefix keeps band rows out of the kind rollups
                # (window_totals filters them the way it filters "ad.")
                bk = f"bd.{p.kind}|{band}"
                vals[f"{bk}.flops"] = p.flops
                vals[f"{bk}.bytes"] = p.bytes
                vals[f"{bk}.device_s"] = p.device_s
                vals[f"{bk}.steps"] = 1.0
                vals[f"{bk}.bubble_s"] = p.bubble_s
            self._ring.add(now, **vals)
        return p

    def note_adapters(self, ids: Iterable[str | None], p: StepPerf,
                      now: float) -> None:
        """Per-adapter attribution of one folded step (multi-LoRA
        multiplexing; gofr_tpu_torch.adapters). ``ids`` carries one entry per
        live lane the fold credited — ``None`` lanes are the base model,
        attributed as ``"base"`` so the per-step adapter shares are a
        COMPLETE partition: summed over adapters they equal the step's
        own flops/bytes/device_s exactly, which is what keeps
        rollups sum-of-parts per tenant (device_s per adapter is the
        per-tenant COGS number). The split is proportional by lane count
        — lanes share the batched step uniformly. Call AFTER :meth:`note`
        (residency must be filled)."""
        ids = list(ids)
        if not ids:
            return
        share = 1.0 / len(ids)
        counts: dict[str, int] = {}
        for aid in ids:
            key = str(aid) if aid is not None else "base"
            counts[key] = counts.get(key, 0) + 1
        with self._lock:
            for aid, c in counts.items():
                f = c * share
                self._ring.add(
                    now,
                    **{f"ad.{aid}.flops": p.flops * f,
                       f"ad.{aid}.bytes": p.bytes * f,
                       f"ad.{aid}.device_s": p.device_s * f,
                       f"ad.{aid}.steps": f})

    def note_external(self, kind: str, device_s: float, flops: float,
                      bytes_: float, now: float) -> None:
        """Account work measured off the device thread (the handoff
        exporter's page readbacks and wire writes). It rides a different
        timeline, so it contributes flops/bytes/device_s but never moves
        the ``_dq`` bubble floor."""
        with self._lock:
            self._ring.add(
                now,
                **{f"{kind}.flops": float(flops),
                   f"{kind}.bytes": float(bytes_),
                   f"{kind}.device_s": max(float(device_s), 1e-9),
                   f"{kind}.steps": 1.0})

    def mark_no_work(self, now: float) -> None:
        """Engine loop idle branch: nothing queued, nothing in flight —
        the gap from here to the next dispatch is idleness, not bubble."""
        with self._lock:
            if self._gap_floor is None or now > self._gap_floor:
                self._gap_floor = now

    # -- read side -----------------------------------------------------------

    def window_totals(self, now: float) -> dict[str, Any]:
        """The mergeable form: per ``kind|kv_dtype`` sums of FLOPs/bytes
        numerators and peak-capacity denominators, plus the bubble sums.
        Capacities are 0.0 when peaks are unknown — a merge then shows
        utilization only for the replicas that know their silicon."""
        peaks = device_peaks(self.device_kind)
        with self._lock:
            sums = self._ring.sums(now)
        kinds: dict[str, dict[str, float]] = {}
        adapters: dict[str, dict[str, float]] = {}
        proto = {"flops": 0.0, "bytes": 0.0, "device_s": 0.0,
                 "steps": 0.0, "flops_cap": 0.0, "bytes_cap": 0.0}
        for key, val in sums.items():
            if key in ("bubble_s", "busy_s"):
                continue
            kind, field = key.rsplit(".", 1)
            if kind.startswith("bd."):
                # band-labeled evidence rows (note(band=)) — read through
                # band_totals by the step controller, never merged here
                continue
            if kind.startswith("ad."):
                # per-adapter attribution rows (note_adapters) — their own
                # section, never mixed into the step kinds
                adapters.setdefault(kind[3:], dict(proto))[field] = val
            else:
                kinds.setdefault(f"{kind}|{self.model.kv_dtype}",
                                 dict(proto))[field] = val
        for rec in list(kinds.values()) + list(adapters.values()):
            if peaks is not None:
                rec["flops_cap"] = rec["device_s"] * peaks[0]
                rec["bytes_cap"] = rec["device_s"] * peaks[1]
        return {
            "v": 1,
            "window_s": self.window_s,
            "kinds": kinds,
            "adapters": adapters,
            "bubble": {"bubble_s": sums.get("bubble_s", 0.0),
                       "busy_s": sums.get("busy_s", 0.0)},
        }

    def band_totals(self, now: float,
                    since: float | None = None) -> dict[str, dict[str, float]]:
        """The step controller's evidence view: per
        ``kind|kv_dtype|band`` sums of FLOPs/bytes/device-seconds/steps
        plus the per-step bubble in front, with capacity denominators
        filled where peaks are known. ``since`` restricts the window to
        buckets after that instant (same clock as ``note``) so ticks read
        deltas, not the rolling window — evidence from before a knob
        move never judges the move."""
        peaks = device_peaks(self.device_kind)
        with self._lock:
            sums = self._ring.sums(now, since)
        out: dict[str, dict[str, float]] = {}
        for key, val in sums.items():
            if not key.startswith("bd."):
                continue
            row, field = key[3:].rsplit(".", 1)
            kind, band = row.split("|", 1)
            rec = out.setdefault(
                f"{kind}|{self.model.kv_dtype}|{band}",
                {"flops": 0.0, "bytes": 0.0, "device_s": 0.0, "steps": 0.0,
                 "bubble_s": 0.0, "flops_cap": 0.0, "bytes_cap": 0.0})
            rec[field] = val
        for rec in out.values():
            if peaks is not None:
                rec["flops_cap"] = rec["device_s"] * peaks[0]
                rec["bytes_cap"] = rec["device_s"] * peaks[1]
        return out

    def snapshot(self, now: float) -> dict[str, Any]:
        """JSON-safe operator view: model constants, resolved peaks, and
        per-kind windowed sums with derived MFU/MBU (None without peaks)."""
        peaks = device_peaks(self.device_kind)
        totals = self.window_totals(now)
        kinds: dict[str, Any] = {}
        for key, rec in totals["kinds"].items():
            kind = key.split("|", 1)[0]
            kinds[kind] = {
                "steps": int(rec["steps"]),
                "flops": rec["flops"],
                "bytes": rec["bytes"],
                "device_s": round(rec["device_s"], 6),
                "mfu": (round(rec["flops"] / rec["flops_cap"], 6)
                        if rec["flops_cap"] else None),
                "mbu": (round(rec["bytes"] / rec["bytes_cap"], 6)
                        if rec["bytes_cap"] else None),
            }
        adapters: dict[str, Any] = {}
        for aid, rec in totals.get("adapters", {}).items():
            adapters[aid] = {
                "steps": round(rec["steps"], 3),
                "flops": rec["flops"],
                "bytes": rec["bytes"],
                "device_s": round(rec["device_s"], 6),
                "mfu": (round(rec["flops"] / rec["flops_cap"], 6)
                        if rec["flops_cap"] else None),
                "mbu": (round(rec["bytes"] / rec["bytes_cap"], 6)
                        if rec["bytes_cap"] else None),
            }
        bub = totals["bubble"]
        denom = bub["bubble_s"] + bub["busy_s"]
        return {
            "device_kind": self.device_kind,
            "kv_dtype": self.model.kv_dtype,
            "window_s": self.window_s,
            "peaks": {
                "flops": peaks[0] if peaks else None,
                "hbm_bytes_per_s": peaks[1] if peaks else None,
                "nominal": bool(peaks) and "cpu" in self.device_kind.lower(),
            },
            "model": self.model.describe(),
            "kinds": kinds,
            "adapters": adapters,
            "bubble": {
                "bubble_s": round(bub["bubble_s"], 6),
                "busy_s": round(bub["busy_s"], 6),
                "ratio": round(bub["bubble_s"] / denom, 6) if denom else None,
            },
        }


# -- exact merges (container) ----------------------------------------


def merge_totals(parts: Iterable[dict[str, Any] | None]) -> dict[str, Any]:
    """Sum-of-parts merge of :meth:`PerfPlane.window_totals` payloads
    (engines in one container). Sums
    numerators and capacity denominators field by field; NEVER averages
    a ratio — ``merge(merge(a, b), c) == merge(a, b, c)`` exactly."""
    out: dict[str, Any] = {"v": 1, "window_s": 0.0, "kinds": {},
                           "adapters": {},
                           "bubble": {"bubble_s": 0.0, "busy_s": 0.0}}
    for part in parts:
        if not isinstance(part, dict) or "kinds" not in part:
            continue
        out["window_s"] = max(out["window_s"], float(part.get("window_s", 0.0)))
        for section in ("kinds", "adapters"):
            for key, rec in (part.get(section) or {}).items():
                dst = out[section].setdefault(key, {
                    "flops": 0.0, "bytes": 0.0, "device_s": 0.0,
                    "steps": 0.0, "flops_cap": 0.0, "bytes_cap": 0.0})
                for f in dst:
                    dst[f] += float(rec.get(f, 0.0))
        bub = part.get("bubble") or {}
        out["bubble"]["bubble_s"] += float(bub.get("bubble_s", 0.0))
        out["bubble"]["busy_s"] += float(bub.get("busy_s", 0.0))
    return out


def derive(totals: dict[str, Any]) -> dict[str, Any]:
    """Ratios off a (possibly merged) totals payload — computed ONCE,
    at the reporting edge: ``{kind|kv_dtype: mfu/mbu}`` and the bubble
    ratio (None where the denominator is unknown/zero)."""
    mfu: dict[str, float] = {}
    mbu: dict[str, float] = {}
    for key, rec in (totals.get("kinds") or {}).items():
        if rec.get("flops_cap"):
            mfu[key] = rec["flops"] / rec["flops_cap"]
        if rec.get("bytes_cap"):
            mbu[key] = rec["bytes"] / rec["bytes_cap"]
    adapters: dict[str, Any] = {}
    for aid, rec in (totals.get("adapters") or {}).items():
        adapters[aid] = {
            "device_s": float(rec.get("device_s", 0.0)),
            "mfu": (rec["flops"] / rec["flops_cap"]
                    if rec.get("flops_cap") else None),
            "mbu": (rec["bytes"] / rec["bytes_cap"]
                    if rec.get("bytes_cap") else None),
        }
    bub = totals.get("bubble") or {}
    denom = float(bub.get("bubble_s", 0.0)) + float(bub.get("busy_s", 0.0))
    return {
        "mfu": mfu,
        "mbu": mbu,
        "adapters": adapters,
        "bubble_ratio": (float(bub.get("bubble_s", 0.0)) / denom
                         if denom else None),
    }
