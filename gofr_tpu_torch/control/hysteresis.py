"""The flap-damping decision core of the step controller (the port's own
copy of gofr_tpu/control/hysteresis.py ``HysteresisGate``).

A pure state machine over an explicit ``now`` — no threads, no wall
clock — so tests drive it with fake clocks. In the JAX package the
elastic fleet's ``ScaleDecider`` delegates to the same machine; the port
has no fleet yet (ROADMAP.md Queue A 9), and the step-level
``StepController`` (control/controller.py) gates its knob trials with it.

Semantics (unchanged from the autoscaler):

- **hysteresis band**: the caller classifies each reading as ``hot``,
  ``calm``, or neither. Inside the band neither streak accumulates —
  a signal oscillating around one threshold can never trigger.
- **sustain**: ``hot`` must persist ``sustain_s`` before the gate fires
  hot; ``calm`` must persist ``idle_s`` before it fires calm. A single
  contrary reading resets the opposing streak (a blip restarts the
  clock).
- **cooldown**: after the caller reports an executed action via
  :meth:`note_action`, the gate holds for ``cooldown_hot_s`` /
  ``cooldown_calm_s`` (per direction) measured from the ACTION, not
  from the decision — what actually happened anchors the lockout.
- **stale freeze**: readings older than ``stale_s`` freeze the gate AND
  forget both streaks — after a signal-plane gap the world may have
  changed, so evidence restarts from scratch.
"""

from __future__ import annotations

__all__ = ["HysteresisGate"]


class HysteresisGate:
    """Pure hysteresis + sustain + cooldown over an explicit clock.

    :meth:`decide` returns one of ``"hot" | "calm" | "hold" | "freeze"``;
    the caller maps hot/calm onto its own actions (scale out/in, try a
    knob move, ...) and reports executed actions back via
    :meth:`note_action` so cooldowns anchor on reality.
    """

    def __init__(self, *, sustain_s: float, idle_s: float,
                 cooldown_hot_s: float, cooldown_calm_s: float,
                 stale_s: float):
        self.sustain_s = float(sustain_s)
        self.idle_s = float(idle_s)
        self.cooldown_hot_s = float(cooldown_hot_s)
        self.cooldown_calm_s = float(cooldown_calm_s)
        self.stale_s = float(stale_s)
        self._pressure_since: float | None = None
        self._calm_since: float | None = None
        self.last_action_at = float("-inf")

    def note_action(self, now: float) -> None:
        """An action was EXECUTED: anchor cooldowns here and restart both
        evidence streaks (the action changed the world the streaks
        measured)."""
        self.last_action_at = now
        self._pressure_since = None
        self._calm_since = None

    def decide(self, *, hot: bool, calm: bool, now: float,
               age_s: float = 0.0) -> str:
        if age_s > self.stale_s:
            # signal plane went silent: no decision on fiction, and the
            # streaks must not survive the gap
            self._pressure_since = None
            self._calm_since = None
            return "freeze"
        if hot:
            self._calm_since = None
            if self._pressure_since is None:
                self._pressure_since = now
        elif calm:
            self._pressure_since = None
            if self._calm_since is None:
                self._calm_since = now
        else:
            # inside the hysteresis band: neither streak accumulates
            self._pressure_since = None
            self._calm_since = None
        if (hot and now - self._pressure_since >= self.sustain_s
                and now - self.last_action_at >= self.cooldown_hot_s):
            return "hot"
        if (calm and now - self._calm_since >= self.idle_s
                and now - self.last_action_at >= self.cooldown_calm_s):
            return "calm"
        return "hold"

    def state(self) -> dict:
        """JSON-safe gate internals for debug endpoints."""
        return {
            "pressure_since": self._pressure_since,
            "calm_since": self._calm_since,
            "last_action_at": (None if self.last_action_at == float("-inf")
                               else self.last_action_at),
        }
