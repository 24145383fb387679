"""Online step-level control plane (the port's own copy of gofr_tpu/control/).

The perf plane (metrics/perf.py) prices every device step and accounts
every pipeline gap; this package turns that measurement into actuation:

- :mod:`gofr_tpu_torch.control.hysteresis` — the sustain/idle/cooldown/
  stale decision core (``HysteresisGate``);
- :mod:`gofr_tpu_torch.control.controller` — the per-engine
  ``StepController`` that buckets live perf samples per (step kind, kv
  dtype, occupancy band) and proposes bounded single-knob moves for
  pipeline depth, chunked-prefill chunk size, speculative round length and
  admission batch width, judged by measured roofline attainment and the
  ``_dq`` bubble ratio, with decisions pinned and persisted so a restarted
  engine resumes tuned.

The engine builds one under ``CONTROL_ENABLE`` (``GenerateEngine.
_build_controller``); without it nothing here runs.
"""

from gofr_tpu_torch.control.controller import (
    ControlPolicy,
    Decision,
    KnobSpec,
    StepController,
)
from gofr_tpu_torch.control.hysteresis import HysteresisGate

__all__ = [
    "ControlPolicy",
    "Decision",
    "HysteresisGate",
    "KnobSpec",
    "StepController",
]
