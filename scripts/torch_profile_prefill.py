#!/usr/bin/env python3
"""Where a prefill of the PyTorch port spends its time on one card.

    python3 scripts/torch_profile_prefill.py [--layers 32] [--kv-quantize int8]

Builds Llama-3-8B (random bf16 weights from seed 0, full width) on the
card with a paged pool of page 128 in bf16 or, with ``--kv-quantize``,
int8 / int4, and profiles the two prefills the engine runs:

- ``admission``: one admission round, ``prefill_sample`` over 4 prompts of
  64..1024 tokens padded to the longest (the batched whole-prompt path);
- ``chunk``: one 512-token chunk at offset 512 of a prompt whose first 512
  tokens the pool already holds (the chunked path: the chunk attends to
  the dense view of 1024 positions that ``cache.read`` gathers).

For each it prints one JSON line: host wall ms per call without the
profiler (and with it), device busy ms (the sum of kernel, copy and memset
times on the one stream), the device idle share against the unprofiled
wall time, the count and ms of device-to-host copies (``Memcpy DtoH``: a
host sync each), the flash prefill kernel C's device ms, and device ms by
kernel name, largest first. It uses only ``Llama.prefill``,
``gpu.programs.prefill_sample`` and ``gpu.engine.make_pool``, so the same
file profiles an older tree of the port. Needs a CUDA card.
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
from gofr_tpu_torch.gpu.programs import prefill_sample  # noqa: E402
from gofr_tpu_torch.models.llama import LlamaConfig, init  # noqa: E402

PAGE, MAXP = 128, 17  # the engine's table width for max_len 2048, decode_chunk 8


def profile(fn, iters: int = 3) -> dict:
    """Host wall of ``fn`` without and with the profiler, and the device
    activity of one profiled call by name (ms) with the count of each."""
    fn()  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / iters
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_profiled = time.perf_counter() - t0
    device, counts = {}, {}
    for evt in prof.key_averages():
        dt = getattr(evt, "self_device_time_total", None)
        if dt is None:
            dt = evt.self_cuda_time_total
        if dt > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            name = evt.key.removeprefix("void ")[:60]
            device[name] = device.get(name, 0.0) + dt / 1e3  # us -> ms
            counts[name] = counts.get(name, 0) + evt.count
    busy = sum(device.values())
    dtoh = [k for k in device if k.startswith("Memcpy DtoH")]
    flash = [k for k in device if "flash_kernel" in k]
    top = sorted(device.items(), key=lambda kv: -kv[1])[:12]
    return {"wall_ms": wall * 1e3, "wall_ms_profiled": wall_profiled * 1e3,
            "device_busy_ms": busy, "device_idle_share": 1.0 - busy / (wall * 1e3),
            "memcpy_dtoh_count": sum(counts[k] for k in dtoh),
            "memcpy_dtoh_ms": sum(device[k] for k in dtoh),
            "flash_ms": sum(device[k] for k in flash), "kernel_ms": dict(top)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--kv-quantize", choices=KV_QUANTIZE, default="")
    args = ap.parse_args()
    info = device_info()
    cfg = LlamaConfig.llama3_8b(num_layers=args.layers)
    dev = torch.device("cuda")
    model = init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    n = 4
    # rows 0..3 take the admission's prompts, row 4 the chunked prompt
    cache = make_pool(model, args.kv_quantize, (n + 1) * MAXP, PAGE)
    table = torch.arange((n + 1) * MAXP, dtype=torch.int32).view(n + 1, MAXP).to(dev)
    rng = torch.Generator().manual_seed(0)
    lengths = torch.randint(64, 1025, (n,), generator=rng)
    tokens = torch.randint(0, cfg.vocab_size, (n, int(lengths.max())), generator=rng).to(dev)
    lengths_dev, temps = lengths.to(dev), torch.zeros(n, device=dev)
    chunk = torch.randint(0, cfg.vocab_size, (1, 1024), generator=rng).to(dev)
    len512, off512 = torch.tensor([512], device=dev), torch.tensor([512], device=dev)
    model.prefill(chunk[:, :512], len512, cache, table[n:])  # the chunk's first 512 tokens

    def admission():
        return prefill_sample(model, cache, tokens, lengths_dev, table[:n], temps, None,
                              do_sample=False)

    def chunked():
        return model.prefill(chunk[:, 512:], len512, cache, table[n:], off512)

    for name, fn in (("admission", admission), ("chunk", chunked)):
        print(json.dumps({"device": info["nvidia_smi"], "call": name, "layers": cfg.num_layers,
                          "kv_pool": args.kv_quantize or "bf16",
                          "shape": ({"prompts": lengths.tolist()} if name == "admission"
                                    else {"chunk": 512, "offset": 512}),
                          **profile(fn)}), flush=True)


if __name__ == "__main__":
    main()
