#!/usr/bin/env python3
"""What one call of a kernel launcher costs the host and the card (one card).

    python3 scripts/torch_launcher_cost.py [--trees DIR ...] [--iters N]

A decode step launches the KV append once per layer, and the append's
kernel runs for about a microsecond and a half: its launcher's own host
time, not the card, paces it. Each directory of ``--trees`` is a checkout
of the repository (default: this one); each is measured in a process of
its own, in the order given, so ``--trees PARENT . . PARENT`` measures a
parent and a change in alternating pairs in one call. In each process the
launchers of that checkout (``kv_append``, ``kv_append_slot``, and
``kv_append_q``, ``kv_append_q4``, ``kv_append_slot_q`` and the decode
launchers ``paged_decode`` and ``decode_attention`` where they exist) are
called ``N`` times back to back on ``chip_smoke.py``'s phase-3 shapes (9
slots, 8 KV heads of 128, pages of 128) and timed three ways:

- ``host_us``: the host's clock over the calls, which queue without a
  sync, per call; ``host_us_min`` the least of ten blocks of N / 10 calls,
  which leaves out most of what other processes on the host take;
- ``events_ms``: CUDA events around the same loop, per call;
- ``device_ms``: the device time the calls leave in a ``torch.profiler``
  trace, per call.

Where the checkout has weight-only int8, ``w8a16`` is ``ops.quant.qdot``
on an int8 QTensor at a decode step's wq (8 rows, 4096 x 4096, split over
K) and ``w8a16_head`` at its head (128256 x 4096), the path every linear
of the int8 model takes; ``linear_bf16`` and ``linear_bf16_head`` are
``F.linear`` on the bf16 weights of the same shapes (cuBLAS), the path of
the bf16 model.

``paged_decode_pinned`` and ``decode_attention_pinned`` repeat A and F
inside a decision scope that pins ``split_plan``'s own plan at their shape
(``ops/autotune.py``, where the checkout has it): the same kernel work, and
the pin lookup a warmed engine's launch makes.

``int64`` rows repeat B, G, A and F with int64 positions, lengths and
table, as the engine hands them to ``Llama.decode_step``: a launcher that
casts them per call shows the cast's cost, one that refuses them shows
``"refused"`` (its model casts once per step instead). ``stream_of_us`` is
the host time of ``cuda.stream_of``, which every launch asks for.

Prints one JSON line per process and a table of the means per tree, and
writes both to ``chiprun_out/launcher_cost.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
N, HKV, HQ, D, PAGE, MAXP, POOL, SMAX = 9, 8, 32, 128, 128, 16, 160, 2176


def _timed(torch, fn, iters: int) -> dict:
    """host µs, events ms and device ms per call of ``fn(i)``."""
    from torch.profiler import ProfilerActivity, profile

    for i in range(5):
        fn(i)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    blocks, per = 10, iters // 10
    host = []
    start.record()
    for b in range(blocks):
        t0 = time.perf_counter()
        for i in range(b * per, (b + 1) * per):
            fn(i)
        host.append(time.perf_counter() - t0)
    end.record()
    torch.cuda.synchronize()
    events = start.elapsed_time(end) / (blocks * per)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(200):
            fn(i)
        torch.cuda.synchronize()
    device_us = sum(e.device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    return {"host_us": sum(host) / (blocks * per) * 1e6, "host_us_min": min(host) / per * 1e6,
            "events_ms": events, "device_ms": device_us / 1e3 / 200}


def child(tree: str, iters: int) -> dict:
    """Measure the launchers of the checkout at ``tree``."""
    sys.path.insert(0, tree)
    import torch

    from gofr_tpu_torch.ops import cuda
    from gofr_tpu_torch.ops.cuda import decode_attention, kv_append, paged_decode

    assert Path(cuda.__file__).resolve().is_relative_to(Path(tree).resolve()), cuda.__file__
    cuda.lib()
    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)
    lengths = torch.tensor([699, 1591, 1200, 2000, 1000, 1500, 800, 1300, 0], dtype=torch.int32,
                           device=dev)
    table = torch.randperm(POOL, device=dev, generator=g)[:N * MAXP].view(N, MAXP).to(torch.int32)
    table[-1] = POOL
    layers = 2
    k_pool, v_pool = (torch.randn(layers, POOL, HKV, PAGE, D, device=dev, generator=g).to(bf)
                      for _ in range(2))
    k_slot, v_slot = (torch.randn(layers, N, HKV, SMAX, D, device=dev, generator=g).to(bf)
                      for _ in range(2))
    k_new, v_new = (torch.randn(N, HKV, D, device=dev, generator=g).to(bf) for _ in range(2))
    q = torch.randn(N, HQ, D, device=dev, generator=g).to(bf)
    pos64, table64 = lengths.long(), table.long()
    calls = {
        "kv_append": lambda i, pos=lengths, tbl=table: kv_append.kv_append(
            k_pool[i % layers], v_pool[i % layers], tbl, pos, k_new, v_new),
        "kv_append_slot": lambda i, pos=lengths: kv_append.kv_append_slot(
            k_slot[i % layers], v_slot[i % layers], pos, k_new, v_new),
        "paged_decode": lambda i, pos=lengths, tbl=table: paged_decode.paged_decode(
            q, k_pool[i % layers], v_pool[i % layers], tbl, pos),
        "decode_attention": lambda i, pos=lengths: decode_attention.decode_attention(
            q, k_slot[i % layers], v_slot[i % layers], pos),
    }
    int64 = {
        "kv_append": lambda i: calls["kv_append"](i, pos64, table64),
        "kv_append_slot": lambda i: calls["kv_append_slot"](i, pos64),
        "paged_decode": lambda i: calls["paged_decode"](i, pos64, table64),
        "decode_attention": lambda i: calls["decode_attention"](i, pos64),
    }
    for name, values, row in (("kv_append_q", torch.int8, D), ("kv_append_q4", torch.uint8, D // 2)):
        if hasattr(kv_append, name):
            planes = (torch.zeros(layers, POOL, HKV, PAGE, row, dtype=values, device=dev),) * 2 + (
                torch.zeros(layers, POOL, HKV, PAGE, dtype=bf, device=dev),) * 2
            calls[name] = lambda i, fn=getattr(kv_append, name), p=planes: fn(
                *(t[i % layers] for t in p), table, lengths, k_new, v_new)
    if hasattr(kv_append, "kv_append_slot_q"):
        planes = (torch.zeros(layers, N, HKV, SMAX, D, dtype=torch.int8, device=dev),) * 2 + (
            torch.zeros(layers, N, HKV, SMAX, dtype=bf, device=dev),) * 2
        calls["kv_append_slot_q"] = lambda i, p=planes: kv_append.kv_append_slot_q(
            *(t[i % layers] for t in p), lengths, k_new, v_new)
    from gofr_tpu_torch.ops import quant

    x8 = torch.randn(8, 4096, device=dev, generator=g).to(bf)
    for label, n_out in (("", 4096), ("_head", 128256)):
        w = (torch.randn(n_out, 4096, device=dev, generator=g) * 4096 ** -0.5).to(bf)
        calls[f"linear_bf16{label}"] = lambda i, w=w: torch.nn.functional.linear(x8, w)
        if hasattr(quant, "qdot"):
            wq = quant.quantize(w)
            calls[f"w8a16{label}"] = lambda i, wq=wq: quant.qdot(x8, wq)
    out = {"tree": tree, "iters": iters}
    for name, fn in calls.items():
        out[name] = _timed(torch, fn, iters)
    for name, fn in int64.items():
        try:
            out[name + "_int64"] = _timed(torch, fn, iters)
        except ValueError:
            out[name + "_int64"] = "refused"
    try:
        from gofr_tpu_torch.ops import autotune
    except ImportError:  # a checkout from before the autotuner
        autotune = None
    if autotune is not None:
        # A and F under a scope pinning split_plan's own plan at their
        # shape: the same kernel work, plus the lookup a warmed engine's
        # launch makes (a shape key and a compare)
        pins = {"paged_decode": autotune.plan_name(decode_attention.split_plan(N, HKV, MAXP * PAGE)[0]),
                "decode": autotune.plan_name(decode_attention.split_plan(N, HKV, SMAX)[0])}
        shapes = {"paged_decode": autotune.shape_key(N, HQ, HKV, D, PAGE, MAXP, POOL),
                  "decode": autotune.shape_key(N, HQ, HKV, D, SMAX)}
        with autotune.decision_scope(pins, shapes):
            for name in ("paged_decode", "decode_attention"):
                out[name + "_pinned"] = _timed(torch, calls[name], iters)
    t0 = time.perf_counter()
    for _ in range(iters):
        cuda.stream_of(q)
    out["stream_of_us"] = (time.perf_counter() - t0) / iters * 1e6
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", default=[str(REPO)])
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.child, args.iters)), flush=True)
        return
    runs = []
    for tree in args.trees:
        tree = str(Path(tree).resolve())
        proc = subprocess.run([sys.executable, __file__, "--child", tree, "--iters", str(args.iters)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"launcher cost failed on {tree}:\n{proc.stdout}{proc.stderr}")
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps(run), flush=True)
        runs.append(run)
    means = {}
    for tree in dict.fromkeys(r["tree"] for r in runs):
        mine = [r for r in runs if r["tree"] == tree]
        means[tree] = {key: ({m: sum(r[key][m] for r in mine) / len(mine) for m in mine[0][key]}
                             if isinstance(mine[0][key], dict) else
                             sum(r[key] for r in mine) / len(mine)
                             if isinstance(mine[0][key], float) else mine[0][key])
                       for key in mine[0] if key not in ("tree", "iters")}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card)
    for tree, by_name in means.items():
        print(tree)
        for name, m in by_name.items():
            print(f"  {name:24s} {m if not isinstance(m, dict) else ' '.join(f'{k} {v:.5f}' for k, v in m.items())}")
    os.makedirs(REPO / "chiprun_out", exist_ok=True)
    with open(REPO / "chiprun_out" / "launcher_cost.json", "w") as f:
        json.dump({"card": card, "runs": runs, "means": means}, f, indent=1)


if __name__ == "__main__":
    main()
