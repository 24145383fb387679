"""Online step-level knob controller: the perf plane closed into a loop
(the port's own copy of gofr_tpu/control/controller.py; its pin cache
reads and writes the same ``FORMAT_VERSION`` 1 JSON, so a cache written by
one package reads in the other).

``StepController`` turns the perf plane (metrics/perf.py) into actuation.
It is deliberately engine-agnostic — knobs are ``KnobSpec`` records with
injected ``read``/``apply`` callables, evidence comes from an injected
``window_fn`` (the engine passes ``PerfPlane.band_totals``), and the
clock is injectable — so the quick-tier units drive the whole state
machine with fake clocks and synthetic windows, no engine required.

The loop, once per ``CONTROL_INTERVAL_S`` tick (driven from the engine's
device loop at the loop-top safe seam):

1. **sense** — read the band-labeled perf window accumulated since the
   last consumed tick: per (step kind, kv dtype, occupancy band) FLOPs,
   bytes, device-seconds, steps, and the ``_dq`` bubble in front of each
   step. The tick is skipped (evidence carries over) below
   ``CONTROL_MIN_STEPS``.
2. **judge** — roofline attainment ``max(MFU, MBU)`` over the window and
   the bubble ratio combine into one score, ``attainment * (1 - bubble
   ratio)``: a knob move only wins by making the device do the same
   priced work in less busy time or with fewer bubbles. Hot/calm
   classification feeds the shared :class:`HysteresisGate`, so
   proposals need SUSTAINED pressure and respect per-direction
   cooldowns.
3. **act** — one bounded single-knob move at a time, as a TRIAL: apply
   the neighbor value, measure the next evidence window, then COMMIT
   (pin + persist) if the score improved by at least
   ``CONTROL_EPSILON``, else REVERT and back off that (knob, direction)
   with doubling delay. A knob whose committed values alternate is
   flagged ``oscillating`` and frozen.

Commits are pinned per (knob, kv dtype, occupancy band, device kind,
shard) and persisted autotune-style: versioned JSON, read-merge-write of
our own keys only, atomic replace — a restarted or scaled-out replica
resumes tuned instead of re-exploring (``CONTROL_CACHE``).

Stand-down: the controller disables itself where acting would be wrong
— an injected ``standdown_fn`` returning a reason (the JAX engine wires
lockstep roles here: leader-only knob moves would desync followers; the
port has no lockstep, so its engine wires none) parks the controller
with one recorded decision.
"""

from __future__ import annotations

import collections
import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable

from gofr_tpu_torch.control.hysteresis import HysteresisGate

__all__ = ["ControlPolicy", "Decision", "KnobSpec", "StepController",
           "FORMAT_VERSION", "entry_key"]

FORMAT_VERSION = 1

# the knobs this plane knows how to move, in round-robin proposal order
KNOB_NAMES = ("pipeline_depth", "prefill_chunk", "spec_tokens",
              "prefill_batch")


def entry_key(knob: str, band: str, *, kv_dtype: str, device_kind: str,
              shard: str) -> str:
    """Persisted-pin key: one decision per (knob, kv dtype, occupancy
    band, device kind, shard) — the same dimensions autotune keys its
    kernel pins by, because a knob that wins on int4/v5e/tp4 can lose on
    bf16/cpu/tp1."""
    return (f"{knob}|kv={kv_dtype}|band={band}|dev={device_kind}"
            f"|shard={shard}")


@dataclass
class KnobSpec:
    """One tunable knob: its allowed values (ascending; bounded by the
    operator's boot configuration — the controller explores WITHIN what
    was provisioned, never past it) and the engine's read/apply seams."""

    name: str
    values: tuple
    read: Callable[[], int]
    apply: Callable[[int], None]

    def neighbor(self, current, direction: int):
        """The next allowed value in ``direction`` (+1/-1), or None at
        the range edge. A current value outside ``values`` (legacy boot
        config) snaps to the nearest allowed one first."""
        if not self.values:
            return None
        vals = self.values
        if current in vals:
            i = vals.index(current)
        else:
            i = min(range(len(vals)), key=lambda j: abs(vals[j] - current))
            # snapping IS the move: propose the nearest legal value
            return vals[i]
        j = i + (1 if direction > 0 else -1)
        if 0 <= j < len(vals):
            return vals[j]
        return None


@dataclass
class ControlPolicy:
    """CONTROL_* configuration (docs/configs.md)."""

    interval_s: float = 5.0        # evidence tick
    sustain_s: float = 10.0        # pressure persistence before a trial
    idle_s: float = 60.0           # calm persistence (gate symmetry)
    cooldown_s: float = 15.0       # lockout after a committed/reverted move
    stale_s: float = 120.0         # evidence silence that freezes the gate
    epsilon: float = 0.03          # relative score gain a commit requires
    bubble_hi: float = 0.15        # bubble ratio counting as pressure
    bubble_lo: float = 0.05        # bubble ratio below which we're calm
    attain_lo: float = 0.30        # attainment below which we're hot
    attain_hi: float = 0.60        # attainment above which we're calm
    min_steps: int = 8             # evidence floor per judged window
    max_trial_ticks: int = 3       # evidence-less ticks before a trial aborts
    backoff_s: float = 60.0        # first revert backoff (doubles, capped)
    backoff_cap_s: float = 960.0
    decisions_keep: int = 128      # decision ring depth
    cache_path: str = ""           # pin persistence ("" = in-memory only)
    knobs: tuple = KNOB_NAMES      # which knobs this replica may move

    def __post_init__(self) -> None:
        if self.bubble_lo > self.bubble_hi or self.attain_hi < self.attain_lo:
            # an inverted band would make one window simultaneously hot
            # and calm — flap by construction (AutoscalePolicy's rule)
            raise ValueError(
                "CONTROL hysteresis bands inverted: *_lo must sit at or "
                "below *_hi")
        if self.interval_s <= 0:
            raise ValueError("CONTROL_INTERVAL_S must be > 0")

    @classmethod
    def from_config(cls, conf) -> "ControlPolicy":
        interval = conf.get_float("CONTROL_INTERVAL_S", 5.0)
        knobs_csv = conf.get_or_default("CONTROL_KNOBS", "") or ""
        knobs = tuple(k.strip() for k in knobs_csv.split(",")
                      if k.strip()) or KNOB_NAMES
        return cls(
            interval_s=interval,
            sustain_s=conf.get_float("CONTROL_SUSTAIN_S", 2.0 * interval),
            idle_s=conf.get_float("CONTROL_IDLE_S", 12.0 * interval),
            cooldown_s=conf.get_float("CONTROL_COOLDOWN_S", 3.0 * interval),
            stale_s=conf.get_float("CONTROL_STALE_S", 24.0 * interval),
            epsilon=conf.get_float("CONTROL_EPSILON", 0.03),
            bubble_hi=conf.get_float("CONTROL_BUBBLE_HI", 0.15),
            bubble_lo=conf.get_float("CONTROL_BUBBLE_LO", 0.05),
            attain_lo=conf.get_float("CONTROL_ATTAIN_LO", 0.30),
            attain_hi=conf.get_float("CONTROL_ATTAIN_HI", 0.60),
            min_steps=conf.get_int("CONTROL_MIN_STEPS", 8),
            max_trial_ticks=conf.get_int("CONTROL_MAX_TRIAL_TICKS", 3),
            backoff_s=conf.get_float("CONTROL_BACKOFF_S", 12.0 * interval),
            backoff_cap_s=conf.get_float("CONTROL_BACKOFF_CAP_S",
                                         192.0 * interval),
            decisions_keep=conf.get_int("CONTROL_DECISIONS_KEEP", 128),
            cache_path=conf.get_or_default("CONTROL_CACHE", "") or "",
            knobs=knobs,
        )


@dataclass
class Decision:
    """One controller decision, as recorded in the flight ring."""

    at: float
    verdict: str               # try | commit | revert | resume | standdown
    knob: str = ""
    frm: Any = None
    to: Any = None
    band: str = ""
    score: float | None = None
    baseline: float | None = None
    evidence: dict = field(default_factory=dict)
    reason: str = ""

    def to_dict(self) -> dict[str, Any]:
        out = {"at": round(self.at, 3), "verdict": self.verdict}
        if self.knob:
            out.update(knob=self.knob, **{"from": self.frm, "to": self.to},
                       band=self.band)
        if self.score is not None:
            out["score"] = round(self.score, 6)
        if self.baseline is not None:
            out["baseline"] = round(self.baseline, 6)
        if self.evidence:
            out["evidence"] = self.evidence
        if self.reason:
            out["reason"] = self.reason
        return out


def _load_cache(path: str) -> dict[str, Any]:
    """Autotune's loading discipline: a missing, corrupt, or
    version-mismatched cache is an EMPTY cache, never an error."""
    try:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        if (isinstance(data, dict)
                and data.get("version") == FORMAT_VERSION
                and isinstance(data.get("entries"), dict)):
            return dict(data["entries"])
    except (OSError, ValueError):
        pass
    return {}


class StepController:
    """Per-engine online knob controller. Single-threaded by contract:
    every method is called from the engine's device loop (or a test's
    fake loop) — applies land at the loop-top safe seam by construction,
    so no knob ever changes under an in-flight dispatch's feet."""

    def __init__(self, policy: ControlPolicy, knobs: Iterable[KnobSpec], *,
                 kv_dtype: str = "bf16", device_kind: str = "cpu",
                 shard: str = "tp1",
                 window_fn: Callable[[float, float | None], dict] | None = None,
                 standdown_fn: Callable[[], str | None] | None = None,
                 on_decision: Callable[[Decision], None] | None = None,
                 clock: Callable[[], float] = time.monotonic,
                 logger=None):
        self.policy = policy
        self.knobs = {k.name: k for k in knobs if k.name in policy.knobs}
        self.kv_dtype = str(kv_dtype)
        self.device_kind = str(device_kind)
        self.shard = str(shard)
        self._window_fn = window_fn or (lambda now, since: {})
        self._standdown_fn = standdown_fn or (lambda: None)
        self._on_decision = on_decision
        self._clock = clock
        self._log = logger
        self.gate = HysteresisGate(
            sustain_s=policy.sustain_s, idle_s=policy.idle_s,
            cooldown_hot_s=policy.cooldown_s, cooldown_calm_s=policy.cooldown_s,
            stale_s=policy.stale_s)
        now = clock()
        self._last_tick = now
        self._since: float | None = now     # evidence window start
        self._last_evidence_at = now
        self._trial: dict[str, Any] | None = None
        self._rr = 0                        # round-robin proposal cursor
        self._backoff: dict[tuple[str, int], tuple[float, float]] = {}
        self._commits: dict[str, collections.deque] = {}
        self._frozen: set[str] = set()
        self._resumed: set[tuple[str, str]] = set()
        self.oscillating = False
        self.standdown: str | None = None
        self.decisions: collections.deque[Decision] = collections.deque(
            maxlen=max(1, policy.decisions_keep))
        self._pins: dict[str, Any] = (
            _load_cache(policy.cache_path) if policy.cache_path else {})
        self._last_evidence: dict[str, Any] = {}

    # -- persistence (the autotune read-merge-write discipline) -------------

    def _key(self, knob: str, band: str) -> str:
        return entry_key(knob, band, kv_dtype=self.kv_dtype,
                         device_kind=self.device_kind, shard=self.shard)

    def _persist(self, key: str, value, score: float | None) -> None:
        self._pins[key] = {"value": value, "at": time.time(),
                           "score": round(score, 6) if score is not None
                           else None}
        path = self.policy.cache_path
        if not path:
            return
        try:
            merged = _load_cache(path)
            merged[key] = self._pins[key]
            tmp = f"{path}.tmp.{os.getpid()}"
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump({"version": FORMAT_VERSION, "entries": merged},
                          f, indent=1, sort_keys=True)
            os.replace(tmp, path)
        except OSError as e:  # cache loss must never gate serving
            if self._log is not None:
                self._log.warnf("control pin persist failed: %r", e)

    def pin_for(self, knob: str, band: str):
        ent = self._pins.get(self._key(knob, band))
        return ent.get("value") if isinstance(ent, dict) else None

    # -- evidence ------------------------------------------------------------

    @staticmethod
    def _summarize(bands: dict[str, dict[str, float]]) -> dict[str, Any]:
        """Collapse a band_totals payload into one judged window: total
        priced work vs capacity (attainment), total bubble vs busy, and
        the dominant occupancy band by device-seconds share."""
        steps = busy = bubble = flops = bytes_ = fcap = bcap = 0.0
        per_band: dict[str, float] = {}
        for key, rec in bands.items():
            band = key.rsplit("|", 1)[1]
            steps += rec.get("steps", 0.0)
            busy += rec.get("device_s", 0.0)
            bubble += rec.get("bubble_s", 0.0)
            flops += rec.get("flops", 0.0)
            bytes_ += rec.get("bytes", 0.0)
            fcap += rec.get("flops_cap", 0.0)
            bcap += rec.get("bytes_cap", 0.0)
            per_band[band] = per_band.get(band, 0.0) + rec.get("device_s", 0.0)
        attain = max(flops / fcap if fcap else 0.0,
                     bytes_ / bcap if bcap else 0.0)
        denom = bubble + busy
        bubble_ratio = bubble / denom if denom else 0.0
        band = max(per_band, key=per_band.get) if per_band else "lo"
        return {
            "steps": int(steps), "device_s": busy, "attainment": attain,
            "bubble_ratio": bubble_ratio, "band": band,
            "score": attain * (1.0 - bubble_ratio),
        }

    # -- the tick ------------------------------------------------------------

    def maybe_tick(self, now: float | None = None) -> Decision | None:
        """Cheap per-iteration entry point: no-op between ticks."""
        now = self._clock() if now is None else now
        reason = self._standdown_fn()
        if reason:
            if self.standdown != reason:
                self.standdown = reason
                return self._record(Decision(
                    at=now, verdict="standdown", reason=reason))
            return None
        self.standdown = None
        if now - self._last_tick < self.policy.interval_s:
            return None
        self._last_tick = now
        return self._tick(now)

    def _record(self, d: Decision) -> Decision:
        self.decisions.append(d)
        if self._on_decision is not None:
            try:
                self._on_decision(d)
            except Exception:  # noqa: BLE001 - observers never gate control
                pass
        return d

    def _note_commit(self, knob: str, value) -> None:
        hist = self._commits.setdefault(knob, collections.deque(maxlen=4))
        hist.append(value)
        if len(hist) >= 3 and hist[-1] == hist[-3] and hist[-1] != hist[-2]:
            # a->b->a committed: the score signal is flapping faster than
            # the workload — freeze this knob and raise the flag
            self.oscillating = True
            self._frozen.add(knob)
            if self._log is not None:
                self._log.warnf("control knob %s oscillating (%r); frozen",
                                knob, list(hist))

    def _tick(self, now: float) -> Decision | None:
        p = self.policy
        ev = self._summarize(self._window_fn(now, self._since))
        if ev["steps"] >= p.min_steps:
            self._last_evidence_at = now
            self._last_evidence = ev
        if self._trial is not None:
            return self._judge_trial(now, ev)
        if ev["steps"] < p.min_steps:
            # starved window: leave _since where it is so evidence
            # accumulates across ticks instead of being discarded
            return None
        self._since = now
        band = ev["band"]
        resumed = self._resume(now, band)
        if resumed is not None:
            return resumed
        hot = (ev["bubble_ratio"] >= p.bubble_hi
               or ev["attainment"] <= p.attain_lo)
        calm = (ev["bubble_ratio"] <= p.bubble_lo
                and ev["attainment"] >= p.attain_hi)
        verdict = self.gate.decide(hot=hot, calm=calm, now=now,
                                   age_s=now - self._last_evidence_at)
        if verdict != "hot":
            return None
        return self._propose(now, ev)

    def _resume(self, now: float, band: str) -> Decision | None:
        """A persisted pin for the dominant band overrides the boot value
        once, without a trial — the restarted-fleet-resumes-tuned path."""
        for name, spec in self.knobs.items():
            if name in self._frozen or (name, band) in self._resumed:
                continue
            pin = self.pin_for(name, band)
            if pin is None or pin not in spec.values:
                continue
            cur = spec.read()
            self._resumed.add((name, band))
            if pin == cur:
                continue
            spec.apply(pin)
            self.gate.note_action(now)
            return self._record(Decision(
                at=now, verdict="resume", knob=name, frm=cur, to=pin,
                band=band))
        return None

    def _propose(self, now: float, ev: dict[str, Any]) -> Decision | None:
        """One bounded single-knob move, round-robin over the knob set.
        Bubble pressure prefers the move that adds overlap or work per
        dispatch (+1 toward deeper/wider/bigger); attainment pressure
        with a quiet pipeline tries the same direction first but will
        take -1 when +1 is exhausted or backed off."""
        p = self.policy
        names = [n for n in self.knobs if n not in self._frozen]
        if not names:
            return None
        order = names[self._rr % len(names):] + names[:self._rr % len(names)]
        self._rr += 1
        for name in order:
            spec = self.knobs[name]
            cur = spec.read()
            for direction in (1, -1):
                until, _delay = self._backoff.get((name, direction),
                                                  (float("-inf"), p.backoff_s))
                if now < until:
                    continue
                to = spec.neighbor(cur, direction)
                if to is None or to == cur:
                    continue
                spec.apply(to)
                self._trial = {"knob": name, "frm": cur, "to": to,
                               "band": ev["band"], "baseline": ev["score"],
                               "direction": direction, "ticks": 0}
                return self._record(Decision(
                    at=now, verdict="try", knob=name, frm=cur, to=to,
                    band=ev["band"], baseline=ev["score"],
                    evidence={"steps": ev["steps"],
                              "attainment": round(ev["attainment"], 6),
                              "bubble_ratio": round(ev["bubble_ratio"], 6)}))
        return None

    def _judge_trial(self, now: float, ev: dict[str, Any]) -> Decision | None:
        p = self.policy
        t = self._trial
        if ev["steps"] < p.min_steps:
            t["ticks"] += 1
            if t["ticks"] < p.max_trial_ticks:
                return None  # keep measuring; evidence accumulates
            # the workload dried up under the trial: revert without
            # judging — an unjudged knob must not linger
            return self._finish_trial(now, ev, commit=False,
                                      reason="no-evidence")
        self._since = now
        improved = ev["score"] >= t["baseline"] * (1.0 + p.epsilon)
        return self._finish_trial(now, ev, commit=improved)

    def _finish_trial(self, now: float, ev: dict[str, Any], *, commit: bool,
                      reason: str = "") -> Decision:
        p = self.policy
        t, self._trial = self._trial, None
        name, spec = t["knob"], self.knobs[t["knob"]]
        self.gate.note_action(now)
        evidence = {"steps": ev["steps"],
                    "attainment": round(ev["attainment"], 6),
                    "bubble_ratio": round(ev["bubble_ratio"], 6)}
        if commit:
            self._backoff.pop((name, t["direction"]), None)
            self._persist(self._key(name, t["band"]), t["to"], ev["score"])
            self._note_commit(name, t["to"])
            return self._record(Decision(
                at=now, verdict="commit", knob=name, frm=t["frm"],
                to=t["to"], band=t["band"], score=ev["score"],
                baseline=t["baseline"], evidence=evidence))
        spec.apply(t["frm"])
        _until, delay = self._backoff.get((name, t["direction"]),
                                          (float("-inf"), p.backoff_s))
        self._backoff[(name, t["direction"])] = (
            now + delay, min(delay * 2.0, p.backoff_cap_s))
        return self._record(Decision(
            at=now, verdict="revert", knob=name, frm=t["to"], to=t["frm"],
            band=t["band"], score=ev["score"], baseline=t["baseline"],
            evidence=evidence, reason=reason))

    # -- operator view -------------------------------------------------------

    def report(self) -> dict[str, Any]:
        """JSON-safe /debug/control payload."""
        return {
            "enabled": True,
            "standdown": self.standdown,
            "interval_s": self.policy.interval_s,
            "oscillating": self.oscillating,
            "knobs": {
                name: {"value": spec.read(),
                       "allowed": list(spec.values),
                       "frozen": name in self._frozen}
                for name, spec in self.knobs.items()},
            "pins": {k: v for k, v in self._pins.items()
                     if k.endswith(f"|dev={self.device_kind}"
                                   f"|shard={self.shard}")
                     and f"|kv={self.kv_dtype}|" in k},
            "trial": ({k: v for k, v in self._trial.items()}
                      if self._trial else None),
            "gate": self.gate.state(),
            "evidence": self._last_evidence,
            "decisions": [d.to_dict() for d in reversed(self.decisions)],
        }
