"""Quiet points for the profiler: moments when no serving thread launches
kernels.

A ``torch.profiler`` session started or stopped on one thread while
another thread launches kernels can lose the card's kernel records: its
trace keeps the host's ``cudaLaunchKernel`` calls and no kernel, and every
later session of the process traces no kernel either. Sessions started and
stopped while no other thread launches lose nothing
(``scripts/torch_profiler_threads.py``; its readings are in ``PERF.md``).
The SLO capture trace and ``/debug/profile`` record on threads of their
own while the engines serve, so they start and stop at quiet points:

- each engine's device thread holds ``LAUNCH_GATE.launching()`` over a
  turn of its loop, and lets go of it (``paused()``) while it waits idle
  for work;
- ``quiet_profile`` starts and stops its session inside
  ``LAUNCH_GATE.quiet()``, which holds new turns back, waits for the turns
  in flight to end and for the card to run what they queued.

With no profiler running, a turn pays two uncontended lock acquisitions.
"""

from __future__ import annotations

import contextlib
import threading
from collections.abc import Iterator
from typing import Any


class LaunchGate:
    """Any number of launching threads at once, or quiet holders, never
    both. A thread may nest ``launching()``; it may not ask for
    ``quiet()`` while it holds ``launching()``, which would wait on
    itself."""

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._active = 0
        self._quiet = 0
        self._held = threading.local()

    def _depth(self) -> int:
        return getattr(self._held, "depth", 0)

    def _enter(self) -> None:
        with self._cond:
            while self._quiet:
                self._cond.wait()
            self._active += 1

    def _leave(self) -> None:
        with self._cond:
            self._active -= 1
            if not self._active:
                self._cond.notify_all()

    @contextlib.contextmanager
    def launching(self) -> Iterator[None]:
        """Launch kernels inside: waits while a quiet point is held."""
        depth = self._depth()
        if not depth:
            self._enter()
        self._held.depth = depth + 1
        try:
            yield
        finally:
            self._held.depth = depth
            if not depth:
                self._leave()

    @contextlib.contextmanager
    def paused(self) -> Iterator[None]:
        """Inside ``launching()``, a stretch that launches nothing (an idle
        wait): a quiet point may be taken meanwhile. Outside it, nothing."""
        depth = self._depth()
        if not depth:
            yield
            return
        self._held.depth = 0
        self._leave()
        try:
            yield
        finally:
            self._enter()
            self._held.depth = depth

    @contextlib.contextmanager
    def quiet(self) -> Iterator[None]:
        """No ``launching()`` section runs inside: new ones wait, and this
        waits for those running to end."""
        if self._depth():
            raise RuntimeError("a thread that launches kernels cannot wait for a quiet point")
        with self._cond:
            self._quiet += 1
            while self._active:
                self._cond.wait()
        try:
            yield
        finally:
            with self._cond:
                self._quiet -= 1
                self._cond.notify_all()

    def launchers(self) -> int:
        """Threads inside ``launching()`` now."""
        with self._cond:
            return self._active


LAUNCH_GATE = LaunchGate()


def settle() -> None:
    """Wait for every card to run what was queued on it (nothing without
    a card)."""
    import torch

    if torch.cuda.is_available():
        for d in range(torch.cuda.device_count()):
            torch.cuda.synchronize(d)


@contextlib.contextmanager
def quiet_profile(**kwargs: Any) -> Iterator[Any]:
    """``torch.profiler.profile(**kwargs)`` started and stopped at quiet
    points, each after the cards have run what was queued before it;
    yields the profiler. The session records every thread's kernels in
    between, as the profiler does."""
    from torch.profiler import profile

    prof = profile(**kwargs)
    with LAUNCH_GATE.quiet():
        settle()
        prof.__enter__()
    try:
        yield prof
    finally:
        with LAUNCH_GATE.quiet():
            settle()
            prof.__exit__(None, None, None)
