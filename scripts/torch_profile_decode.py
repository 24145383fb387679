#!/usr/bin/env python3
"""Where a decode step of the PyTorch port spends its time on one card.

    python3 scripts/torch_profile_decode.py [--layers 32] [--steps 8] [--kv-quantize int8]
                                            [--kv-layout slot] [--spec-tokens 4] [--adapters 3]

Builds Llama-3-8B (random bf16 weights from seed 0, full width) on the
card, prefills 8 prompts of 100..2000 tokens into the paged pool, or with
``--kv-layout slot`` into a slot cache of 2176 positions per slot (the
engine's length for ``max_len`` 2048), in bf16 or, with
``--kv-quantize``, int8 / int4 (paged only), then runs
``decode_chunk`` steps under ``torch.profiler``. Prints one JSON line: host
wall time per step without the profiler (and with it), device busy time
per step (the sum of CUDA kernel times; one stream, so kernels do not
overlap), the device idle share against the unprofiled wall time, the
time of device-to-host copies, and device time by kernel name, largest
first.

With ``--spec-tokens g`` it compares one speculative round
(``gpu.programs.spec_chunk``, prompt lookup in a random token history)
with the g + 1 plain decode steps a round that accepts
every draft replaces, in the order plain, spec, spec, plain, one JSON line
each and per call: host wall, device busy and idle share, C's device ms
(the verify forward's attention), the device ms of the dense K/V views
the verify gathers every layer (``cache.read``, labelled ``dense_view`` in
the trace), and of the verify's attention calls with the copies their
launcher makes of those views (``attention``).

With ``--adapters N`` every lane serves one of N random LoRA adapters of
rank 16 (``adapters.random_adapter`` from seeds 40.., lane i on adapter
i mod N) out of an adapter pool of N + 1 slots, in the decode steps and
the spec rounds alike. Each line then also gives the device and host ms
of the LoRA delta (``ops.lora.lora_logits_delta``, labelled
``lora_delta``) and its share of the device busy time, and one more line
profiles the delta alone at the decode shape, its device ms by kernel
name (the gathers of the factors, the two batched products, the scale).
Needs a CUDA card.
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
from gofr_tpu_torch.gpu.engine import KV_LAYOUTS, KV_QUANTIZE, make_pool  # noqa: E402
from gofr_tpu_torch.gpu.programs import decode_chunk  # noqa: E402
from gofr_tpu_torch.models.llama import LlamaConfig, init  # noqa: E402


# regions of the spec round labelled in the trace
LABELS = ("dense_view", "attention", "lora_delta")


def labelled(label: str, fn):
    """``fn`` with each call inside a profiler range named ``label``."""
    def call(*a, **kw):
        with torch.profiler.record_function(label):
            return fn(*a, **kw)
    return call


def profile(fn, iters: int = 3) -> dict:
    """Host wall of one ``fn()`` without the profiler (mean of ``iters``
    after a warm-up) and with it, and the device activity of one profiled
    call: busy ms (kernels, copies and memsets on the one stream), the idle
    share against the unprofiled wall, device-to-host copies, C's ms, the
    device ms of each labelled region (``LABELS``), and ms by kernel name."""
    fn()
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
    kernels, regions, hosts = {}, dict.fromkeys(LABELS, 0.0), dict.fromkeys(LABELS, 0.0)
    for evt in prof.key_averages():
        if evt.key in LABELS:
            # the host-side range holds the device time of the kernels it
            # launched; its device-side copy is a span, not a kernel
            if evt.device_type == torch.autograd.DeviceType.CPU:
                regions[evt.key] += getattr(evt, "device_time_total", 0.0) / 1e3
                hosts[evt.key] += evt.cpu_time_total / 1e3
            continue
        dt = getattr(evt, "self_device_time_total", None)
        if dt is None:
            dt = evt.self_cuda_time_total
        if dt > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            name = evt.key.removeprefix("void ")[:60]
            kernels[name] = kernels.get(name, 0.0) + dt / 1e3  # us -> ms
    busy = sum(kernels.values())
    return {"wall_ms": wall * 1e3, "wall_ms_profiled": wall_profiled * 1e3,
            "device_busy_ms": busy, "device_idle_share": 1.0 - busy / (wall * 1e3),
            "memcpy_dtoh_ms": sum(v for k, v in kernels.items() if k.startswith("Memcpy DtoH")),
            "flash_ms": sum(v for k, v in kernels.items() if "flash_kernel" in k),
            **{f"{k}_ms": v for k, v in regions.items()},
            "lora_delta_host_ms_profiled": hosts["lora_delta"],
            "lora_delta_share_of_busy": regions["lora_delta"] / busy if busy else 0.0,
            "kernel_ms": dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:15])}


def adapter_args(args, model, n: int) -> tuple | None:
    """``adapters`` for every step: lane i on adapter i mod N of a pool of
    N + 1 slots of rank 16 (slot 0 the base, unused here); None without
    ``--adapters``. The delta is labelled ``lora_delta`` in the trace."""
    if not args.adapters:
        return None
    from gofr_tpu_torch.adapters import AdapterPool, random_adapter
    from gofr_tpu_torch.models import llama

    cfg = model.cfg
    pool = AdapterPool(args.adapters + 1, cfg.hidden_size, cfg.vocab_size, 16,
                       device=model.device)
    for i in range(args.adapters):
        pool.acquire(random_adapter(f"ad{i}", cfg.hidden_size, cfg.vocab_size, rank=16,
                                    seed=40 + i))
    llama.lora_logits_delta = labelled("lora_delta", llama.lora_logits_delta)
    sel = torch.tensor([1 + i % args.adapters for i in range(n)], device=model.device)
    return sel, pool.a, pool.b, pool.scale


def delta_alone(info, model, ad) -> None:
    """One line: ``lora_logits_delta`` alone at the decode shape (the
    lanes' normed hidden states, bf16), device ms by kernel name."""
    from gofr_tpu_torch.ops.lora import lora_logits_delta

    x = torch.randn(ad[0].shape[0], model.cfg.hidden_size, device=model.device,
                    dtype=model.cfg.dtype)
    r = profile(lambda: lora_logits_delta(x, ad))
    print(json.dumps({"device": info["nvidia_smi"], "mode": "lora_delta_alone",
                      "lanes": x.shape[0], "adapters": int(ad[0].max()), "rank": ad[1].shape[2],
                      "host_wall_ms": r["wall_ms"], "device_busy_ms": r["device_busy_ms"],
                      "kernel_ms": r["kernel_ms"]}), flush=True)


def spec_rounds(args, info, model, cache, table, tokens, positions, temps, width: int,
                ad=None) -> None:
    """Plain, spec, spec, plain: g + 1 decode steps against one speculative
    round on the same lanes, each profiled (``profile``); ``width`` is a
    lane's positions."""
    from gofr_tpu_torch.gpu.programs import new_history, spec_chunk
    from gofr_tpu_torch.models import llama

    g, n = args.spec_tokens, tokens.shape[0]
    hist = new_history(n, width, tokens.device)
    hist[:, :width] = torch.randint(0, model.cfg.vocab_size, (n, width),
                                    generator=torch.Generator().manual_seed(1)).to(tokens.device)
    type(cache).read = labelled("dense_view", type(cache).read)
    llama.mha_attention = labelled("attention", llama.mha_attention)
    runs = {"plain": lambda: decode_chunk(model, cache, tokens, positions, table, temps, g + 1,
                                          None, do_sample=False, adapters=ad),
            "spec": lambda: spec_chunk(model, cache, hist, tokens, positions + 1, table, temps, 1,
                                       g, None, adapters=ad)}
    for order, mode in enumerate(("plain", "spec", "spec", "plain")):
        print(json.dumps({"device": info["nvidia_smi"], "layers": model.cfg.num_layers,
                          "slots": n, "kv_layout": args.kv_layout,
                          "kv_pool": args.kv_quantize or "bf16", "order": order, "mode": mode,
                          "spec_tokens": g, "adapters": args.adapters,
                          "per_call": ("one round" if mode == "spec" else f"{g + 1} decode steps"),
                          **profile(runs[mode])}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--kv-quantize", choices=KV_QUANTIZE, default="")
    ap.add_argument("--kv-layout", choices=KV_LAYOUTS, default="paged")
    ap.add_argument("--spec-tokens", type=int, default=0)
    ap.add_argument("--adapters", type=int, default=0)
    args = ap.parse_args()
    if args.kv_layout == "slot" and args.kv_quantize == "int4":
        ap.error("the slot layout has no int4 format")
    info = device_info()
    cfg = LlamaConfig.llama3_8b(num_layers=args.layers)
    dev = torch.device("cuda")
    model = init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    n, page, maxp = 8, 128, 17
    rng = torch.Generator().manual_seed(0)
    lengths = torch.randint(100, 2001, (n,), generator=rng)
    if args.kv_layout == "paged":
        cache = make_pool(model, args.kv_quantize, n * maxp, page)
        table = torch.arange(n * maxp, dtype=torch.int32).view(n, maxp).to(dev)
        rows = table[:, None]
    else:
        cache = make_pool(model, args.kv_quantize, n, maxp * page, "slot")
        table, rows = None, torch.arange(n, dtype=torch.int32, device=dev)[:, None]
    for i in range(n):  # one prompt at a time keeps prefill activations small
        toks = torch.randint(0, cfg.vocab_size, (1, int(lengths[i])), generator=rng).to(dev)
        model.prefill(toks, lengths[i:i + 1].to(dev), cache, rows[i])
    tokens = torch.randint(0, cfg.vocab_size, (n,), generator=rng).to(dev)
    positions, temps = lengths.to(dev), torch.zeros(n, device=dev)
    ad = adapter_args(args, model, n)
    if args.spec_tokens:
        spec_rounds(args, info, model, cache, table, tokens, positions, temps, maxp * page, ad)
        if ad is not None:
            delta_alone(info, model, ad)
        return

    r = profile(lambda: decode_chunk(model, cache, tokens, positions, table, temps, args.steps,
                                     None, do_sample=False, adapters=ad))
    steps = args.steps
    print(json.dumps({
        "device": info["nvidia_smi"], "layers": cfg.num_layers, "slots": n,
        "kv_layout": args.kv_layout, "kv_pool": args.kv_quantize or "bf16",
        "lengths": lengths.tolist(), "steps": steps,
        "wall_ms_per_step": r["wall_ms"] / steps,
        "wall_ms_per_step_profiled": r["wall_ms_profiled"] / steps,
        "device_busy_ms_per_step": r["device_busy_ms"] / steps,
        "device_idle_share": r["device_idle_share"],
        # a device-to-host copy stalls the host on the card: none is expected
        "memcpy_dtoh_ms_per_step": r["memcpy_dtoh_ms"] / steps,
        "adapters": args.adapters,
        "lora_delta_ms_per_step": r["lora_delta_ms"] / steps,
        "lora_delta_host_ms_per_step_profiled": r["lora_delta_host_ms_profiled"] / steps,
        "lora_delta_share_of_busy": r["lora_delta_share_of_busy"],
        "kernel_ms_per_step": {k: v / steps for k, v in r["kernel_ms"].items()},
    }), flush=True)
    if ad is not None:
        delta_alone(info, model, ad)


if __name__ == "__main__":
    main()
