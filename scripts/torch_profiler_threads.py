#!/usr/bin/env python3
"""Does ``torch.profiler`` on one thread see the kernels another thread
launches? (one card)

    python3 scripts/torch_profiler_threads.py [--sessions N] [--seconds S] [--arms A ...]

The SLO capture trace and ``/debug/profile`` (``metrics.slo.record_trace``)
start and stop a profiler on a thread of their own while the engine's
thread launches kernels. This script repeats that: a launcher thread
queues small products back to back and syncs every 200 launches, as a
decode loop does, and ``N`` profiler sessions of ``S`` seconds each count
the kernel events of their exported trace. A session whose trace holds no
kernel event is ``empty``. Each arm runs in a process of its own (the
profiler's state outlives a session) and differs in one of:

- the thread that starts and stops each session: a new one each time
  (``new``, as the capture trace and ``/debug/profile`` used to), one
  thread that lives across sessions (``same``), or the main thread
  (``main``);
- the launcher: ``busy`` (runs through every start and stop), ``quiet``
  (paused while the profiler starts and stops), ``none`` (the session's
  own thread launches the products) or ``gated`` (the port's fix: the
  launcher holds ``LAUNCH_GATE.launching()`` over each 200 launches, as an
  engine holds it over a turn, and each session is ``quiet_profile``,
  ``gpu/launch_gate.py``);
- the environment: ``TEARDOWN_CUPTI=0`` keeps CUPTI between sessions,
  ``DISABLE_CUPTI_LAZY_REINIT=1`` sets it up again at once at the next;
- ``record_trace``: the port's own function, called as the capture calls
  it, in place of the script's session; ``mix`` alternates a session on
  the main thread with ``record_trace`` on a new thread, as
  ``chip_smoke.py`` does;
- ``late``: the environment is set after the first session, as a library
  imported after the profiler's first use would set it.

Prints one JSON line per arm and writes them to
``chiprun_out/profiler_threads.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
NO_TEARDOWN = {"TEARDOWN_CUPTI": "0"}
EAGER = {"DISABLE_CUPTI_LAZY_REINIT": "1"}
# name: (thread, launcher, environment at start, environment after the first session)
ARMS = {
    "new_busy": ("new", "busy", {}, {}),
    "new_quiet": ("new", "quiet", {}, {}),
    "new_none": ("new", "none", {}, {}),
    "same_busy": ("same", "busy", {}, {}),
    "main_busy": ("main", "busy", {}, {}),
    "new_busy_no_teardown": ("new", "busy", NO_TEARDOWN, {}),
    "new_busy_eager": ("new", "busy", EAGER, {}),
    "new_busy_no_teardown_eager": ("new", "busy", {**NO_TEARDOWN, **EAGER}, {}),
    "same_busy_no_teardown": ("same", "busy", NO_TEARDOWN, {}),
    "record_trace": ("record_trace", "busy", {}, {}),
    "mix_busy": ("mix", "busy", {}, {}),
    "mix_busy_eager": ("mix", "busy", EAGER, {}),
    "mix_busy_eager_late": ("mix", "busy", {}, EAGER),
    "mix_busy_no_teardown": ("mix", "busy", NO_TEARDOWN, {}),
    "mix_busy_no_teardown_late": ("mix", "busy", {}, NO_TEARDOWN),
    "record_trace_gated": ("record_trace", "gated", {}, {}),
    "mix_gated": ("mix", "gated", {}, {}),
}
CUPTI_ENV = ("TEARDOWN_CUPTI", "DISABLE_CUPTI_LAZY_REINIT")


def categories(path: str) -> dict[str, int]:
    """Events of a Chrome trace by category."""
    with open(path) as f:
        doc = json.load(f)
    cats: dict[str, int] = {}
    for e in doc["traceEvents"] if isinstance(doc, dict) else doc:
        c = e.get("cat", "")
        cats[c] = cats.get(c, 0) + 1
    return cats


def products(torch, a) -> None:
    y = a
    for _ in range(200):
        y = torch.mm(y, a).mul_(0.01)
    y.sum().item()


class Launcher:
    """A thread that launches small products until stopped; ``pause()``
    returns once no launch is in flight on the host."""

    def __init__(self, torch, a, gated: bool) -> None:
        from gofr_tpu_torch.gpu.launch_gate import LAUNCH_GATE

        self.torch, self.a = torch, a
        self.gate = LAUNCH_GATE if gated else None
        self.go = threading.Event()
        self.idle = threading.Event()
        self.done = False
        self.launches = 0
        self.go.set()
        self.thread = threading.Thread(target=self.run, daemon=True)
        self.thread.start()

    def run(self) -> None:
        while not self.done:
            if not self.go.is_set():
                self.idle.set()
                self.go.wait()
                self.idle.clear()
                continue
            if self.gate is None:
                products(self.torch, self.a)
            else:
                with self.gate.launching():
                    products(self.torch, self.a)
            self.launches += 400

    def pause(self) -> None:
        self.go.clear()
        self.idle.wait()

    def resume(self) -> None:
        self.go.set()

    def stop(self) -> None:
        self.done = True
        self.go.set()
        self.thread.join()


def session(torch, a, launcher: Launcher | None, mode: str, seconds: float, out: str) -> str:
    """One profiler session on the calling thread; returns its trace."""
    from torch.profiler import ProfilerActivity, profile

    from gofr_tpu_torch.gpu.launch_gate import quiet_profile

    path = os.path.join(out, "trace.json")
    os.makedirs(out, exist_ok=True)
    if mode == "gated":
        with quiet_profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(seconds)
        prof.export_chrome_trace(path)
        return path
    quiet = mode == "quiet"
    if quiet:
        launcher.pause()
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.__enter__()
    if launcher is None:
        t_end = time.monotonic() + seconds
        while time.monotonic() < t_end:
            products(torch, a)
    else:
        launcher.resume()
        time.sleep(seconds)
        if quiet:
            launcher.pause()
    torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    if launcher is not None:
        launcher.resume()
    prof.export_chrome_trace(path)
    return path


def arm(name: str, sessions: int, seconds: float) -> dict:
    import torch

    sys.path.insert(0, str(REPO))
    from gofr_tpu_torch.metrics.slo import record_trace

    thread, mode, env, late = ARMS[name]
    a = torch.randn(256, 256, device="cuda", dtype=torch.bfloat16)
    launcher = None if mode == "none" else Launcher(torch, a, mode == "gated")
    tmp = tempfile.mkdtemp(prefix="gofr-profiler-threads-")
    jobs: queue.Queue = queue.Queue()
    done: queue.Queue = queue.Queue()

    def one(i: int) -> str:
        out = os.path.join(tmp, str(i))
        if thread == "record_trace" or (thread == "mix" and i % 2):
            return record_trace(out, seconds)
        return session(torch, a, launcher, mode, seconds, out)

    def serve() -> None:
        while (i := jobs.get()) is not None:
            done.put(one(i))

    server = threading.Thread(target=serve, daemon=True)
    if thread == "same":
        server.start()
    rows = []
    try:
        for i in range(sessions):
            if i == 1:
                os.environ.update(late)
            if thread == "main" or (thread == "mix" and i % 2 == 0):
                path = one(i)
            elif thread == "same":
                jobs.put(i)
                path = done.get()
            else:
                box = []
                t = threading.Thread(target=lambda i=i: box.append(one(i)))
                t.start()
                t.join()
                path = box[0]
            rows.append(categories(path))
    finally:
        jobs.put(None)
        if launcher is not None:
            launcher.stop()
    return {"arm": name, "thread": thread, "launcher": mode, "env": env, "late_env": late,
            "empty": sum(r.get("kernel", 0) == 0 for r in rows), "sessions": len(rows),
            "kernel": [r.get("kernel", 0) for r in rows],
            "cuda_runtime": [r.get("cuda_runtime", 0) for r in rows]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sessions", type=int, default=6)
    ap.add_argument("--seconds", type=float, default=0.3)
    ap.add_argument("--arms", nargs="+", choices=sorted(ARMS), default=list(ARMS))
    ap.add_argument("--arm", choices=sorted(ARMS), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.arm:
        print(json.dumps(arm(args.arm, args.sessions, args.seconds)))
        return 0
    lines = []
    for name in args.arms:
        env = {k: v for k, v in os.environ.items() if k not in CUPTI_ENV}
        p = subprocess.run([sys.executable, __file__, "--arm", name, "--sessions",
                            str(args.sessions), "--seconds", str(args.seconds)],
                           env={**env, **ARMS[name][2]}, capture_output=True, text=True,
                           timeout=600)
        if p.returncode != 0:
            sys.stderr.write(p.stderr[-4000:])
            print(f"arm {name} exited {p.returncode}")
            return 1
        lines.append(p.stdout.strip().splitlines()[-1])
        print(lines[-1], flush=True)
    os.makedirs(REPO / "chiprun_out", exist_ok=True)
    (REPO / "chiprun_out" / "profiler_threads.json").write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
