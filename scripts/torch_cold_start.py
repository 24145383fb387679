#!/usr/bin/env python3
"""What the first request of a fresh process pays, with and without
``ENGINE_WARMUP`` (the port's ``GenerateEngine.warmup``), on one card.

    python3 scripts/torch_cold_start.py --warmup true [--layers 2] [--prompt 512]

One process serves one model through the port's App as a user runs it: a
``ModelSpec`` of Llama-3-8B's widths cut to ``--layers`` layers (random
bf16 weights from seed 0), ``ENGINE_*`` knobs of ``chip_smoke.py``'s
``bf16`` run, and ``ENGINE_WARMUP`` as given, so the App warms the engine
before its servers start. Then two requests of ``--prompt`` random tokens
(``--new`` greedy tokens each), one after the other: the first pays what
first use costs that warmup did not (cuBLAS's handles and heuristics per
shape, the caching allocator's growth, pinned staging; the kernel library
is loaded, from ``gofr_tpu_torch/build/`` where it is built), the second is
the warm reference. First-use costs are per shape, not per layer, so the
depth is cut.

Prints one JSON line: the card's name and power limit, the process's
seconds from start to the App ready, ``warmup()``'s seconds and count
(null and 0 without warmup), and each request's TTFT and wall seconds.
Run it twice, in fresh processes, to compare; ``chip_smoke.py`` phase 4
``cold_start`` does.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import subprocess
import sys
import threading
import time

START = time.perf_counter()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--warmup", choices=("true", "false"), required=True)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--prompt", type=int, default=512)
    ap.add_argument("--new", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch_cold_start: no CUDA device available")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.config import DictConfig
    from gofr_tpu_torch.container import Container
    from gofr_tpu_torch.models import ModelSpec
    from gofr_tpu_torch.models.llama import LlamaConfig

    conf = {"HTTP_PORT": "0", "METRICS_PORT": "0", "LOG_LEVEL": "ERROR",
            "ENGINE_SLOTS": "8", "ENGINE_MAX_LEN": "2048", "ENGINE_PREFILL_BATCH": "4",
            "ENGINE_DECODE_CHUNK": "8", "ENGINE_KV_DTYPE": "bf16", "ENGINE_WARMUP": args.warmup}
    app = App(config=DictConfig(conf), container=Container.create(DictConfig(conf)))
    cfg = LlamaConfig.llama3_8b(num_layers=args.layers)
    eng = app.serve_model("lm", ModelSpec("llama", cfg, dtype=cfg.dtype), device=args.device,
                          seed=0)
    timed = {"seconds": None, "count": 0}
    real = eng.warmup

    def warmup() -> int:
        t = time.perf_counter()
        timed["count"] = real()
        timed["seconds"] = time.perf_counter() - t
        return timed["count"]

    eng.warmup = warmup
    loop = asyncio.new_event_loop()
    ready, stopped = threading.Event(), threading.Event()

    def serve() -> None:
        async def run() -> None:
            started = asyncio.Event()
            task = asyncio.ensure_future(app.arun(ready=started))
            await started.wait()
            ready.set()
            await task

        try:
            loop.run_until_complete(run())
        finally:
            stopped.set()

    thread = threading.Thread(target=serve, name="cold-start-app", daemon=True)
    thread.start()
    if not ready.wait(900):
        raise SystemExit("torch_cold_start: the App did not start")
    ready_s = time.perf_counter() - START
    rng = torch.Generator().manual_seed(1)
    requests = []
    for _ in range(2):
        prompt = torch.randint(0, cfg.vocab_size, (args.prompt,), generator=rng).tolist()
        t = time.perf_counter()
        out = eng.generate(prompt, max_new_tokens=args.new, timeout=900)
        if len(out["tokens"]) != args.new:
            raise SystemExit(f"torch_cold_start: a request ended with {out}")
        requests.append({"ttft_s": out["ttft_s"], "wall_s": time.perf_counter() - t})
    loop.call_soon_threadsafe(app.stop)
    stopped.wait(120)
    smi = ""
    if args.device == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip()
    print(json.dumps({
        "engine_warmup": args.warmup == "true", "layers": args.layers, "prompt": args.prompt,
        "new_tokens": args.new, "nvidia_smi": smi, "ready_s": ready_s,
        "warmup_s": timed["seconds"], "warmup_count": timed["count"],
        "first_ttft_s": requests[0]["ttft_s"], "first_wall_s": requests[0]["wall_s"],
        "second_ttft_s": requests[1]["ttft_s"], "second_wall_s": requests[1]["wall_s"],
    }), flush=True)


if __name__ == "__main__":
    main()
