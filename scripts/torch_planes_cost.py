#!/usr/bin/env python3
"""The host cost of the port's request planes on the engine's loop, on one card.

    python3 scripts/torch_planes_cost.py [--tree DIR] [--label NAME]
                                         [--order direct,served,full,full,served,direct]
                                         [--requests 32] [--new-tokens 64] [--out FILE]
    python3 scripts/torch_planes_cost.py --summarize FILE [FILE ...]

Imports ``gofr_tpu_torch`` from ``--tree`` (default: the checkout this
script lives in), so the same traffic can be run on an older tree unpacked
beside this one (``git archive <commit>``). Builds Llama-3-8B on the card
(random bf16 weights from seed 0, full width and depth) and serves the same
traffic in turns, one fresh engine a turn, in the order ``--order``:

- ``direct``: ``build_engine(cfg, params=model, ...)``, no container;
- ``served``: ``build_engine(ModelSpec(weights=model), Container.create(cfg))``,
  as the App builds it, with the container's default planes (on a tree that
  has them: metrics, flight recorder, perf plane, SLO);
- ``full``: ``served`` with every plane on, on a tree that has them: the
  memory tracer (``TRACE_EXPORTER=memory``), QoS bound through
  ``register_qos`` and the requests in two classes.

Both engines take the same knobs (8 slots, ``max_len`` 2048, prefill batch
4, decode chunk 8, bf16 pool, pipeline depth 2). A turn warms its engine on
one request, then submits ``--requests`` distinct prompts (64..1024
tokens, seed 6) at once, ``--new-tokens`` each, and waits for them.

One JSON line a turn: the loop's busy turns and host ms a busy turn
(``pipeline_stats``: the wall of every loop turn that dispatched or folded
work), decode tok/s (tokens after the first over the span from the first
first token to the last finish), the wall, and the planes' own time on the
loop thread. That last is timed by wrapping, on the engine and its planes,
every entry point the loop calls (``PLANE_CALLS``); only the outermost call
of a nest is timed, and only on the loop's thread. The wrapper's own cost
a call (``wrapper_us``, timed on a no-op) bounds its bias. Each line also
carries the card's name and power limit.

``--summarize`` reads such lines (from any number of calls and trees) and
prints, per (label, arm), the mean, least and largest of each figure, one
JSON line each. Needs a CUDA card for the runs, not for the summary.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

SEED = 0
DEVICE = "cuda"
PROMPT_SEED = 6
KNOBS = {"slots": 8, "max_len": 2048, "max_prefill_batch": 4, "decode_chunk": 8}
CONFIG = {"ENGINE_SLOTS": "8", "ENGINE_MAX_LEN": "2048", "ENGINE_PREFILL_BATCH": "4",
          "ENGINE_DECODE_CHUNK": "8", "ENGINE_KV_DTYPE": "bf16", "LOG_LEVEL": "ERROR"}
FULL_CONFIG = {**CONFIG, "TRACE_EXPORTER": "memory", "SLO_ENABLED": "true",
               "QOS_ENABLED": "true"}
CLASSES = ("batch", "interactive")
# (attribute path from the engine, method names) the loop reaches the
# planes through; a missing object or method is skipped (an older tree)
PLANE_CALLS = (
    ("", ("_record_step", "_mark_admitted", "_mark_first_token", "_observe_done")),
    ("metrics", ("increment_counter", "record_histogram", "set_gauge")),
    ("perf", ("step_decode", "step_spec", "step_prefill", "step_chunk", "step_swapin",
              "note", "note_adapters")),
    ("flight", ("record_request", "record_step")),
    ("slo", ("observe", "observe_outcome")),
    ("qos", ("observe_step",)),
)
SPAN_CALLS = ("begin", "end", "event", "close_all")


class PlaneTimer:
    """Seconds and calls of the outermost plane calls on one thread."""

    def __init__(self):
        self.thread: int | None = None
        self.seconds = 0.0
        self.calls = 0
        self._depth = 0

    def wrap(self, fn):
        def timed(*a, **kw):
            if threading.get_ident() != self.thread:
                return fn(*a, **kw)
            self._depth += 1
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self._depth -= 1
                if not self._depth:
                    self.seconds += time.perf_counter() - t
                    self.calls += 1
        return timed

    def install(self, eng) -> list[str]:
        """Wrap the engine's plane entry points; returns what was wrapped."""
        self.thread = eng._thread.ident
        wrapped = []
        for path, names in PLANE_CALLS:
            obj = getattr(eng, path, None) if path else eng
            if obj is None:
                continue
            for name in names:
                fn = getattr(obj, name, None)
                if fn is not None:
                    setattr(obj, name, self.wrap(fn))
                    wrapped.append(f"{path or 'engine'}.{name}")
        return wrapped


def wrapper_us() -> float:
    """The wrapper's own cost a call, on a no-op, in microseconds."""
    timer = PlaneTimer()
    timer.thread = threading.get_ident()
    noop = timer.wrap(lambda: None)
    n = 200_000
    t = time.perf_counter()
    for _ in range(n):
        noop()
    wrapped = time.perf_counter() - t
    plain = lambda: None  # noqa: E731
    t = time.perf_counter()
    for _ in range(n):
        plain()
    return (wrapped - (time.perf_counter() - t)) / n * 1e6


def smi_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def prompts(torch, vocab: int, n: int) -> list[list[int]]:
    rng = torch.Generator().manual_seed(PROMPT_SEED)
    lens = torch.randint(64, 1025, (n,), generator=rng).tolist()
    return [torch.randint(0, vocab, (k,), generator=rng).tolist() for k in lens]


def make_engine(arm: str, model):
    """(engine, container or None) for ``arm``."""
    from gofr_tpu_torch.gpu.engine import build_engine

    if arm == "direct":
        return build_engine(model.cfg, params=model, device=DEVICE, seed=SEED,
                            eos_token_id=-1, **KNOBS), None
    from gofr_tpu_torch.config import DictConfig
    from gofr_tpu_torch.container import Container
    from gofr_tpu_torch.models import ModelSpec

    config = DictConfig(FULL_CONFIG if arm == "full" else CONFIG)
    container = Container.create(config)
    eng = build_engine(ModelSpec("llama", model.cfg, weights=model, dtype=model.cfg.dtype),
                       container, device=DEVICE, seed=SEED, eos_token_id=-1)
    container.register_engine("lm", eng)
    if arm == "full":
        from gofr_tpu_torch.qos import AdmissionController, QoSPolicy

        container.register_qos(AdmissionController(QoSPolicy.from_config(config),
                                                   container.metrics, container.logger))
    return eng, container


def wait_folded(eng, timeout: float = 120.0) -> dict:
    deadline = time.monotonic() + timeout
    while True:
        st = eng.pipeline_stats()
        if st["folds"] == sum(st["dispatched"].values()):
            return st
        if time.monotonic() > deadline:
            raise RuntimeError(f"calls still in flight: {st}")
        time.sleep(0.001)


def turn(torch, model, arm: str, traffic: list, new_tokens: int) -> dict:
    if arm == "full":
        import gofr_tpu_torch.tracing as tracing
    eng, container = make_engine(arm, model)
    warm = eng.generate(list(range(1, 65)), max_new_tokens=2, timeout=600)
    if warm["finish_reason"] != "length":
        raise RuntimeError(f"{arm} warm-up: {warm}")
    before = wait_folded(eng)
    timer = PlaneTimer()
    wrapped = timer.install(eng)
    originals = {}
    if arm == "full":
        # the spans hang off RequestTrace objects made per request
        for name in SPAN_CALLS:
            originals[name] = getattr(tracing.RequestTrace, name)
            setattr(tracing.RequestTrace, name, timer.wrap(originals[name]))
        wrapped += [f"RequestTrace.{n}" for n in SPAN_CALLS]
    torch.cuda.synchronize()
    kw = [{"qos_class": CLASSES[i % 2]} if arm == "full" else {} for i in range(len(traffic))]
    t_submit = time.monotonic()
    reqs = [eng.submit(p, max_new_tokens=new_tokens, **k) for p, k in zip(traffic, kw)]
    outs = [r.result(timeout=900) for r in reqs]
    st = wait_folded(eng)
    torch.cuda.synchronize()
    t_done = time.monotonic()
    planes_s, planes_calls = timer.seconds, timer.calls
    for name, fn in originals.items():
        setattr(tracing.RequestTrace, name, fn)
    if container is not None:
        container.close()
    else:
        eng.stop()
    del eng
    torch.cuda.empty_cache()
    for i, o in enumerate(outs):
        if o["finish_reason"] != "length" or len(o["tokens"]) != new_tokens:
            raise RuntimeError(f"{arm} request {i}: {o['finish_reason']}, {len(o['tokens'])}")
    turns = st["busy_turns"] - before["busy_turns"]
    first = [t_submit + o["ttft_s"] for o in outs]
    done = [f + o["decode_s"] for f, o in zip(first, outs)]
    return {
        "arm": arm, "requests": len(outs), "new_tokens": new_tokens, "busy_turns": turns,
        "host_ms_per_turn": (st["busy_turn_s"] - before["busy_turn_s"]) / turns * 1e3,
        "planes_ms_per_turn": planes_s / turns * 1e3,
        "planes_calls_per_turn": planes_calls / turns,
        "decode_tok_s": sum(len(o["tokens"]) - 1 for o in outs) / (max(done) - min(first)),
        "wall_s": t_done - t_submit, "wrapped": wrapped,
    }


def run(args) -> None:
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from gofr_tpu_torch.models.llama import LlamaConfig, init

    cfg = LlamaConfig.llama3_8b()
    model = init(cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    traffic = prompts(torch, cfg.vocab_size, args.requests)
    head = {"label": args.label, "tree": str(Path(args.tree).resolve()),
            "nvidia_smi": smi_line(), "torch": torch.__version__, "wrapper_us": wrapper_us()}
    out = open(args.out, "a") if args.out else None
    for i, arm in enumerate(args.order.split(",")):
        line = json.dumps({**head, "turn": i, **turn(torch, model, arm, traffic,
                                                      args.new_tokens)})
        print(line, flush=True)
        if out is not None:
            out.write(line + "\n")
            out.flush()


FIGURES = ("host_ms_per_turn", "planes_ms_per_turn", "planes_calls_per_turn", "decode_tok_s",
           "busy_turns")


def summarize(files: list[str]) -> None:
    rows: dict[tuple, list] = {}
    for f in files:
        for line in open(f):
            if line.startswith("{"):
                r = json.loads(line)
                rows.setdefault((r["label"], r["arm"]), []).append(r)
    for (label, arm), rs in sorted(rows.items()):
        out = {"label": label, "arm": arm, "turns": len(rs),
               "nvidia_smi": sorted({r["nvidia_smi"] for r in rs}),
               "wrapper_us": max(r["wrapper_us"] for r in rs)}
        for k in FIGURES:
            vals = [r[k] for r in rs]
            out[k] = {"mean": statistics.fmean(vals), "min": min(vals), "max": max(vals)}
        print(json.dumps(out))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--order", default="direct,served,full,full,served,direct")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=64)
    ap.add_argument("--out", default="")
    ap.add_argument("--summarize", nargs="+", metavar="FILE")
    args = ap.parse_args()
    if args.summarize:
        summarize(args.summarize)
    else:
        run(args)


if __name__ == "__main__":
    main()
