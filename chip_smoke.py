#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line each on stdout, any failure exits non-zero before the
result line:

1. the card: ``device_info()`` (name, memory, nvidia-smi name and power limit);
2. the build: every ``gofr_tpu_torch/csrc/*.cu`` compiled by its own nvcc
   for sm_90a, all started together, and linked into
   ``gofr_tpu_torch/build/libgofr_kernels.so``; seconds and the compiler's
   register/spill lines;
3. the kernels at the slice's own shapes (Llama-3-8B heads: Hq 32, Hkv 8,
   D 128; page 128; 8 slots of live length 100..2000; a 4 x 512 prefill):
   each held against its plain PyTorch version on the same inputs, timed
   with CUDA events beside the plain version, a library yardstick where
   one PyTorch call computes the same function, and the least time the
   card could take (its bound);
4. the main path: a full-width, full-depth Llama-3-8B engine with random
   bf16 weights from a seed serves 8 concurrent requests (prompts of
   64..1024 tokens, 64 new greedy tokens each); every launch counter is set
   to 0 just before and read just after, and each must be > 0;
5. the model on the card: one prompt through ``prefill_paged`` and four
   ``decode_step_paged`` steps with the kernels, and again with their plain
   versions; the logits must agree within the bf16 tolerance below.

Then the ``kernels`` line, the ``nvidia-smi`` name and power limit line and,
last, ``{"ok": true, "device": {...}}``. Without a card, or run outside a
checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12    # H100 SXM dense bf16 tensor-core peak
SEED = 0
# Kernel vs plain: each kernel's limits (MAX_ABS on any element, RMS_REL on
# the RMS of the difference over the RMS of the output) are stated beside
# its launcher (ops/cuda/*.py); the KV append is held to bit equality.
# Model on the card: 32 layers of bf16 rounding at different points move
# the logits by a small fraction of their range.
LOGITS_RTOL = 5e-2


def emit(phase: str, payload) -> None:
    print(f"{phase} {json.dumps(payload, sort_keys=True)}", flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def time_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn(i)`` over ``iters`` calls (CUDA events)."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def smi_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def agreement(name: str, got, want, module) -> dict:
    """Hold a kernel's output against its plain version's under the two
    limits its launcher module states: no element off by more than
    ``MAX_ABS`` (a local fault), and the RMS of the difference under
    ``RMS_REL`` of the output's RMS (a small fault spread over many rows)."""
    got, want = got.float(), want.float()
    require(bool(got.isfinite().all()), f"{name} produced non-finite values")
    diff = got - want
    err, rms = diff.abs().max().item(), diff.pow(2).mean().sqrt().item()
    out_rms = want.pow(2).mean().sqrt().item()
    rel = rms / max(out_rms, 1e-30)
    require(err <= module.MAX_ABS and rel <= module.RMS_REL,
            f"{name} disagrees with plain: max err {err} (limit {module.MAX_ABS}), "
            f"RMS err / RMS out {rel} (limit {module.RMS_REL})")
    return {"max_abs_err": err, "rms_rel_err": rel, "out_rms": out_rms}


def check_kernels(torch, timed: bool = True) -> list[dict]:
    """Each kernel against its plain version at the slice's shapes, and (if
    ``timed``) its time beside the plain version's, the library yardstick's
    and its bound."""
    import torch.nn.functional as F

    from gofr_tpu_torch.ops.attention import mha_attention_plain, paged_decode_attention_plain
    from gofr_tpu_torch.ops.cuda import flash_attention as flash_mod
    from gofr_tpu_torch.ops.cuda import paged_decode as decode_mod
    from gofr_tpu_torch.ops.cuda.flash_attention import flash_attention
    from gofr_tpu_torch.ops.cuda.kv_append import kv_append
    from gofr_tpu_torch.ops.cuda.paged_decode import paged_decode
    from gofr_tpu_torch.ops.paged import append_tokens_paged_plain

    def timing(ms, plain_ms, library_ms=None) -> dict:
        if not timed:
            return {}
        return {"ms": ms(), "plain_ms": plain_ms(), "library_ms": library_ms and library_ms()}

    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cpu_rng = torch.Generator().manual_seed(SEED)
    hq, hkv, d, page, n, maxp, layers = 32, 8, 128, 128, 8, 16, 8
    lengths_cpu = torch.randint(100, 2001, (n,), generator=cpu_rng, dtype=torch.int32)
    pages_needed = [math.ceil(int(x) / page) for x in lengths_cpu]
    pool = sum(pages_needed)
    perm = torch.randperm(pool, generator=cpu_rng).to(torch.int32)
    table_cpu = torch.full((n, maxp), pool, dtype=torch.int32)  # OOB == pool
    used = 0
    for i, need in enumerate(pages_needed):
        table_cpu[i, :need] = perm[used:used + need]
        used += need
    table, lengths = table_cpu.to(dev), lengths_cpu.to(dev)
    # `layers` layer slices, cycled while timing so each launch finds its
    # pages cold in L2, as a decode step through 32 layers does
    k_pool = torch.randn(layers, pool, hkv, page, d, device=dev, generator=gen).to(bf)
    v_pool = torch.randn(layers, pool, hkv, page, d, device=dev, generator=gen).to(bf)
    q = torch.randn(n, hq, d, device=dev, generator=gen).to(bf)
    live = int(lengths_cpu.sum())
    results = []

    # A: paged decode
    got = paged_decode(q, k_pool[0], v_pool[0], table, lengths)
    want = paged_decode_attention_plain(q, k_pool[0], v_pool[0], table, lengths)
    agree = agreement("paged_decode", got, want, decode_mod)
    nbytes = live * hkv * d * 2 * 2 + 2 * q.numel() * 2 + table.numel() * 4 + n * 4
    b_ms, b_by = bound_ms(nbytes, 4 * live * hq * d)
    results.append({
        "name": "paged_decode", "route": "cuda", "source": "gofr_tpu_torch/csrc/paged_decode.cu",
        "replaces": "gofr_tpu/ops/pallas/paged_decode.py:94", **agree,
        "tolerance": {"max_abs": decode_mod.MAX_ABS, "rms_rel": decode_mod.RMS_REL},
        **timing(lambda: time_ms(torch, lambda i: paged_decode(
                     q, k_pool[i % layers], v_pool[i % layers], table, lengths), 50),
                 lambda: time_ms(torch, lambda i: paged_decode_attention_plain(
                     q, k_pool[i % layers], v_pool[i % layers], table, lengths), 10)),
        "bound_ms": b_ms, "bound_by": b_by,
        "shape": {"slots": n, "hq": hq, "hkv": hkv, "d": d, "page": page,
                  "lengths": lengths_cpu.tolist()},
    })

    # B: KV append at each slot's next position; bit-exact against plain
    k_new = torch.randn(n, hkv, d, device=dev, generator=gen).to(bf)
    v_new = torch.randn(n, hkv, d, device=dev, generator=gen).to(bf)
    ka, va = k_pool[0].clone(), v_pool[0].clone()
    kp, vp = k_pool[0].clone(), v_pool[0].clone()
    kv_append(ka, va, table, lengths, k_new, v_new)
    append_tokens_paged_plain(kp, vp, table, lengths, k_new, v_new)
    exact = (torch.equal(ka.view(torch.int16), kp.view(torch.int16))
             and torch.equal(va.view(torch.int16), vp.view(torch.int16)))
    require(exact, "kv_append pool differs from the plain write")
    require(not torch.equal(ka, k_pool[0]), "kv_append wrote nothing")
    del ka, va, kp, vp
    b_ms, b_by = bound_ms(2 * 2 * k_new.numel() * 2 + table.numel() * 4 + n * 4, 0)
    results.append({
        "name": "kv_append", "route": "cuda", "source": "gofr_tpu_torch/csrc/kv_append.cu",
        "replaces": "gofr_tpu/ops/pallas/kv_append.py:110", "max_abs_err": 0.0,
        "tolerance": "bit-exact",
        **timing(lambda: time_ms(torch, lambda i: kv_append(
                     k_pool[i % layers], v_pool[i % layers], table, lengths, k_new, v_new), 200),
                 lambda: time_ms(torch, lambda i: append_tokens_paged_plain(
                     k_pool[i % layers], v_pool[i % layers], table, lengths, k_new, v_new), 50)),
        "bound_ms": b_ms, "bound_by": b_by,
        "shape": {"slots": n, "hkv": hkv, "d": d, "page": page},
    })
    del k_pool, v_pool

    # C: flash prefill, a batch of 4 x 512 full prompts (causal)
    b, s = 4, 512
    qf = torch.randn(b, s, hq, d, device=dev, generator=gen).to(bf)
    kf = torch.randn(b, s, hkv, d, device=dev, generator=gen).to(bf)
    vf = torch.randn(b, s, hkv, d, device=dev, generator=gen).to(bf)
    got = flash_attention(qf, kf, vf, causal=True)
    want = mha_attention_plain(qf, kf, vf, causal=True)
    agree = agreement("flash_attention", got, want, flash_mod)
    # ragged lengths, offsets and a fully masked row: same agreement, zeros
    lens = torch.tensor([512, 300, 77, 0], device=dev, dtype=torch.int32)
    offs = torch.tensor([0, 40, 0, 0], device=dev, dtype=torch.int32)
    got_r = flash_attention(qf, kf, vf, causal=True, q_offset=offs, kv_lengths=lens)
    want_r = mha_attention_plain(qf, kf, vf, causal=True, q_offset=offs, kv_lengths=lens)
    agree_r = agreement("flash_attention (ragged)", got_r, want_r, flash_mod)
    require(torch.all(got_r[3] == 0).item(), "flash_attention: fully masked rows are not zero")
    pairs = b * s * (s + 1) // 2
    b_ms, b_by = bound_ms(2 * (2 * qf.numel() + 2 * kf.numel()), 4 * hq * d * pairs)
    qh, kh, vh = qf.transpose(1, 2), kf.transpose(1, 2), vf.transpose(1, 2)
    kh_r = kh.repeat_interleave(hq // hkv, dim=1)
    vh_r = vh.repeat_interleave(hq // hkv, dim=1)
    results.append({
        "name": "flash_attention", "route": "cuda", "source": "gofr_tpu_torch/csrc/flash_attention.cu",
        "replaces": "gofr_tpu/ops/pallas/flash_attention.py:108",
        "max_abs_err": max(agree["max_abs_err"], agree_r["max_abs_err"]),
        "rms_rel_err": max(agree["rms_rel_err"], agree_r["rms_rel_err"]),
        "checks": {"causal": agree, "ragged": agree_r},
        "tolerance": {"max_abs": flash_mod.MAX_ABS, "rms_rel": flash_mod.RMS_REL},
        **timing(lambda: time_ms(torch, lambda i: flash_attention(qf, kf, vf, causal=True), 20),
                 lambda: time_ms(torch, lambda i: mha_attention_plain(qf, kf, vf, causal=True), 5),
                 # yardstick only (never called by the port): SDPA on
                 # head-major views, KV heads repeated outside the timed call
                 lambda: time_ms(torch, lambda i: F.scaled_dot_product_attention(
                     qh, kh_r, vh_r, is_causal=True), 20)),
        "bound_ms": b_ms, "bound_by": b_by,
        "shape": {"batch": b, "seq": s, "hq": hq, "hkv": hkv, "d": d, "causal": True},
    })
    return results


def serve(torch, cuda) -> tuple[object, dict, dict]:
    from gofr_tpu_torch.gpu.engine import build_engine
    from gofr_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    eng = build_engine(cfg, device="cuda", seed=SEED, slots=8, max_len=2048,
                       max_prefill_batch=4, decode_chunk=8)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    warm = eng.generate(list(range(1, 65)), max_new_tokens=2, timeout=600)
    require(warm["finish_reason"] == "length", f"warm-up request: {warm}")

    rng = torch.Generator().manual_seed(SEED)
    lens = torch.randint(64, 1025, (8,), generator=rng).tolist()
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist() for n in lens]
    torch.cuda.synchronize()
    cuda.reset_launch_counts()
    t_submit = time.monotonic()
    reqs = [eng.submit(p, max_new_tokens=64, temperature=0.0) for p in prompts]
    outs = [r.result(timeout=900) for r in reqs]
    torch.cuda.synchronize()
    t_done = time.monotonic()
    counts = cuda.launch_counts()
    for i, o in enumerate(outs):
        require(o["finish_reason"] == "length" and len(o["tokens"]) == 64,
                f"request {i}: {o['finish_reason']}, {len(o['tokens'])} tokens")
        require(all(0 <= t < cfg.vocab_size for t in o["tokens"]), f"request {i}: token out of range")
    for name, c in counts.items():
        require(c > 0, f"kernel {name} was not launched on the main path")
    first = [t_submit + o["ttft_s"] for o in outs]
    done = [f + o["decode_s"] for f, o in zip(first, outs)]
    decoded = sum(len(o["tokens"]) - 1 for o in outs)
    ttft = sorted(o["ttft_s"] for o in outs)
    metrics = {
        "model": "llama3_8b (random bf16 weights, seed 0)", "layers": cfg.num_layers,
        "requests": len(outs), "prompt_lens": lens, "new_tokens": 64,
        "engine_build_s": build_s, "wall_s": t_done - t_submit,
        "ttft_s": [o["ttft_s"] for o in outs], "ttft_p50_s": ttft[len(ttft) // 2],
        "ttft_max_s": ttft[-1],
        "decode_tok_s": decoded / (max(done) - min(first)),
        "output_tok_s": sum(len(o["tokens"]) for o in outs) / (t_done - t_submit),
        "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "note": "smoke run, not a benchmark",
    }
    return eng, counts, metrics


def model_check(torch, model) -> dict:
    """Kernels vs plain versions, end to end through the model."""
    rng = torch.Generator().manual_seed(SEED + 1)
    prompt = torch.randint(0, model.cfg.vocab_size, (1, 256), generator=rng).cuda()
    lengths = torch.tensor([256], device="cuda")
    table = torch.arange(4, dtype=torch.int32, device="cuda")[None]
    runs = {}
    steps = None
    for kernels in (True, False):
        cache = model.make_paged_cache(4, 128)
        logits, _ = model.prefill_paged(prompt, lengths, cache, table, kernels=kernels)
        seq = [logits]
        tokens = logits.argmax(-1).to(torch.int32) if steps is None else steps[0]
        chosen = [tokens]
        for step in range(4):
            pos = torch.tensor([256 + step], device="cuda")
            logits, _ = model.decode_step_paged(tokens, pos, cache, table, kernels=kernels)
            seq.append(logits)
            # both runs feed the same inputs: the kernel run's greedy tokens
            tokens = logits.argmax(-1).to(torch.int32) if steps is None else steps[step + 1]
            chosen.append(tokens)
        steps = steps or chosen
        runs[kernels] = torch.stack(seq)
        del cache
    k_run, p_run = runs[True], runs[False]
    require(torch.isfinite(k_run).all().item(), "non-finite logits with the kernels")
    err = (k_run - p_run).abs().max().item()
    scale = p_run.abs().max().item()
    agree = (k_run.argmax(-1) == p_run.argmax(-1)).float().mean().item()
    require(err < LOGITS_RTOL * scale, f"kernel vs plain logits: max err {err} vs scale {scale}")
    return {"steps": 5, "max_abs_err": err, "max_abs_logit": scale,
            "rel_err": err / scale, "tol_rel": LOGITS_RTOL, "argmax_agree": agree}


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from gofr_tpu_torch.gpu.device import device_info
    from gofr_tpu_torch.ops import cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("phase1_device", device_info())

    built = cuda.build()
    notes = [ln.strip() for ln in built["ptxas"].splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    emit("phase2_build", {"seconds": built["seconds"], "ptxas": notes})

    kernels = check_kernels(torch)
    emit("phase3_kernels", kernels)

    eng, counts, metrics = serve(torch, cuda)
    emit("phase4_serve", {**metrics, "launches": counts})
    eng.stop()
    model = eng.model
    del eng
    torch.cuda.empty_cache()

    emit("phase5_model", model_check(torch, model))

    for k in kernels:
        k["launches"] = counts[k["name"]]
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"kernels": kernels, "serve": metrics}, f, indent=1)
    print(json.dumps({"kernels": [{key: k[key] for key in (
        "name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
        "bound_ms", "bound_by", "library_ms")} for k in kernels]}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
