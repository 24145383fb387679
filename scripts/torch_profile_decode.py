#!/usr/bin/env python3
"""Where a decode step of the PyTorch port spends its time on one card.

    python3 scripts/torch_profile_decode.py [--layers 32] [--steps 8] [--kv-quantize int8]

Builds Llama-3-8B (random bf16 weights from seed 0, full width) on the
card, prefills 8 prompts of 100..2000 tokens into the paged pool (bf16,
or int8 / int4 with ``--kv-quantize``), then runs
``decode_chunk`` steps under ``torch.profiler``. Prints one JSON line: host
wall time per step without the profiler (and with it), device busy time
per step (the sum of CUDA kernel times; one stream, so kernels do not
overlap), the device idle share against the unprofiled wall time, and
device time by kernel name, largest first. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gofr_tpu_torch.gpu.device import device_info  # noqa: E402
from gofr_tpu_torch.gpu.engine import KV_QUANTIZE, make_pool  # noqa: E402
from gofr_tpu_torch.gpu.programs import decode_chunk  # noqa: E402
from gofr_tpu_torch.models.llama import LlamaConfig, init  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--kv-quantize", choices=KV_QUANTIZE, default="")
    args = ap.parse_args()
    info = device_info()
    cfg = LlamaConfig.llama3_8b(num_layers=args.layers)
    dev = torch.device("cuda")
    model = init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    n, page, maxp = 8, 128, 17
    rng = torch.Generator().manual_seed(0)
    lengths = torch.randint(100, 2001, (n,), generator=rng)
    cache = make_pool(model, args.kv_quantize, n * maxp, page)
    table = torch.arange(n * maxp, dtype=torch.int32).view(n, maxp).to(dev)
    for i in range(n):  # one prompt at a time keeps prefill activations small
        toks = torch.randint(0, cfg.vocab_size, (1, int(lengths[i])), generator=rng).to(dev)
        model.prefill_paged(toks, lengths[i:i + 1].to(dev), cache, table[i:i + 1])
    tokens = torch.randint(0, cfg.vocab_size, (n,), generator=rng).to(dev)
    positions, temps = lengths.to(dev), torch.zeros(n, device=dev)

    def run():
        return decode_chunk(model, cache, tokens, positions, table, temps, args.steps,
                            None, do_sample=False)

    run()  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    wall_plain = (time.perf_counter() - t0) / 3
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0  # inflated by the profiler's own cost
    kernels = {}
    for evt in prof.key_averages():
        dt = getattr(evt, "self_device_time_total", None)
        if dt is None:
            dt = evt.self_cuda_time_total
        if dt > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            name = evt.key.removeprefix("void ")[:60]
            kernels[name] = kernels.get(name, 0.0) + dt / 1e3  # us -> ms
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:15]
    print(json.dumps({
        "device": info["nvidia_smi"], "layers": cfg.num_layers, "slots": n,
        "kv_pool": args.kv_quantize or "bf16",
        "lengths": lengths.tolist(), "steps": args.steps,
        "wall_ms_per_step": wall_plain * 1e3 / args.steps,
        "wall_ms_per_step_profiled": wall * 1e3 / args.steps,
        "device_busy_ms_per_step": busy / args.steps,
        "device_idle_share": 1.0 - busy / (wall_plain * 1e3),
        "kernel_ms_per_step": {k: v / args.steps for k, v in top},
    }))


if __name__ == "__main__":
    main()
