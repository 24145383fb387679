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
   D 128; 8 slots of live length 100..2000 and one empty slot, on bf16,
   int8 and int4 pools of page 128, the quantized ones written by the
   port's own writes from random bf16 K/V, and on a bf16 slot cache of
   2176 positions per slot, with a lane past the slot; lanes on and one
   past the split boundaries of the slot and paged decodes; 4 x 512
   and 4 x 1024 prefills, full and ragged, and a chunk of 200 queries after
   cached offsets; the five appends, bf16 and quantizing, on edge lanes: a
   position of -1, past the table, through an OOB or negative entry, at and
   past Smax, an all-zero row and a row whose max is one element): each
   held against its plain PyTorch version on the same inputs (the appends
   bit for bit, values and scales), timed with CUDA events and by device
   time beside the plain version, a library yardstick where one PyTorch
   call computes the same function, and the least time the card could take
   (its bound);
4. the main path, once per cache (``RUNS``): a full-width, full-depth
   Llama-3-8B engine with random bf16 weights from a seed serves 8
   concurrent requests (prompts of 64..1024 tokens, 64 new greedy tokens
   each) on a bf16 pool, then the same model on an int8 and an int4 pool
   (``kv_quantize``) and on a bf16 and an int8 slot cache
   (``kv_layout="slot"``); every launch counter is set to 0 just before
   each run and read just after it, and each kernel of that cache's path
   (``ON_PATH``) must be > 0, the decode-step kernels equally often, and
   every other kernel 0;
5. the model on the card, on each cache: three prompts through
   ``prefill`` and four ``decode_step`` steps with the kernels, with
   their plain versions, and with the kernels in prefill only and in
   decode only; the kernel run's logits must agree with the plain run's
   within the limits below, and each step's error of every run is
   reported;
6. no host sync: two ``decode_step`` steps on each cache inside
   ``torch.cuda.set_sync_debug_mode("error")``, which raises on any call
   that makes the host wait on the card.

Then the ``wall_time`` line (seconds of each phase), the ``kernels`` line,
the ``nvidia-smi`` name and power limit line and, last, ``{"ok": true,
"device": {...}}``. Without a card, or run outside a checkout of the
repository, it exits non-zero and prints no result.
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
# the logits by a small fraction of their range. On a quantized pool such a
# rounding can also flip a stored code, which moves that K/V element by a
# whole step of max|x|/127 (int8) or max|x|/7 (int4). Phase 5 splits the
# step: with the plain prefill and the kernels in decode only, every pool
# reads like bf16 (under 2% of the logit range on the H100) and is held to
# DECODE_RTOL. The int4 pool's larger error (up to 6.3%) comes with the
# flash prefill: the K/V it stores differ from the plain run's by 13% RMS,
# against 1.9% on int8, as flipped 4-bit codes feed the next layer. So its
# served-path limit is twice the others'; a masked causal diagonal in the
# flash kernel reads 60% there (PERF.md, scripts/torch_kernel_mutants.py).
LOGITS_RTOL = {"": 5e-2, "int8": 5e-2, "int4": 1e-1}
DECODE_RTOL = 5e-2
PHASE5_PROMPTS = 3


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


def device_ms(torch, fn, iters: int) -> float:
    """Device time of one ``fn(i)``: the time of the GPU activity (kernels,
    memsets, copies) that ``iters`` calls leave in a ``torch.profiler``
    trace, over ``iters``. Unlike ``time_ms`` it leaves out the host's time
    between launches, which a short kernel behind a Python wrapper can wait
    on."""
    from torch.profiler import ProfilerActivity, profile

    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
    total_us = sum(e.device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    return total_us / 1e3 / iters


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
    numbers = {"max_abs_err": err, "rms_rel_err": rel, "out_rms": out_rms}
    if not (err <= module.MAX_ABS and rel <= module.RMS_REL):
        failure = SystemExit(f"chip_smoke FAILED: {name} disagrees with plain: max err {err} "
                             f"(limit {module.MAX_ABS}), RMS err / RMS out {rel} "
                             f"(limit {module.RMS_REL})")
        failure.numbers = numbers
        raise failure
    return numbers


def _decode_case(torch) -> dict:
    """The decode kernels' inputs at the slice's shapes: 8 slots of live
    length 100..2000 on pages of 128 in a random order (OOB entries == P),
    a ninth slot that is empty (length 0, its table row all OOB), and
    ``layers`` layer slices of each pool, cycled while timing so each
    launch finds its pages cold in L2, as a decode step through 32 layers
    does. The int8 and int4 pools are written by the port's own
    ``write_prompts_paged_q``/``_q4`` from random bf16 K/V, so their scales
    are those of real rows."""
    from gofr_tpu_torch.ops.paged import (
        Q4PagedKVCache,
        QPagedKVCache,
        write_prompts_paged_q,
        write_prompts_paged_q4,
    )

    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cpu_rng = torch.Generator().manual_seed(SEED)
    hq, hkv, d, page, n, maxp, layers = 32, 8, 128, 128, 9, 16, 8
    lengths_cpu = torch.randint(100, 2001, (n,), generator=cpu_rng, dtype=torch.int32)
    lengths_cpu[-1] = 0
    pages_needed = [math.ceil(int(x) / page) for x in lengths_cpu]
    pool = sum(pages_needed)
    perm = torch.randperm(pool, generator=cpu_rng).to(torch.int32)
    table_cpu = torch.full((n, maxp), pool, dtype=torch.int32)  # OOB == pool
    used = 0
    for i, need in enumerate(pages_needed):
        table_cpu[i, :need] = perm[used:used + need]
        used += need
    table = table_cpu.to(dev)
    k_pool = torch.randn(layers, pool, hkv, page, d, device=dev, generator=gen).to(bf)
    v_pool = torch.randn(layers, pool, hkv, page, d, device=dev, generator=gen).to(bf)
    pools = {8: QPagedKVCache.create(layers, pool, page, hkv, d, device=dev),
             4: Q4PagedKVCache.create(layers, pool, page, hkv, d, device=dev)}
    for layer in range(layers):
        for plane in ("k", "v"):
            rows = torch.randn(n, maxp * page, hkv, d, device=dev, generator=gen).to(bf)
            for bits, write in ((8, write_prompts_paged_q), (4, write_prompts_paged_q4)):
                cache = pools[bits]
                write(getattr(cache, plane)[layer], getattr(cache, plane + "s")[layer], table, rows)
    return {"hq": hq, "hkv": hkv, "d": d, "page": page, "n": n, "layers": layers,
            "lengths_cpu": lengths_cpu, "lengths": lengths_cpu.to(dev), "table": table,
            "k_pool": k_pool, "v_pool": v_pool, "pools": pools,
            "q": torch.randn(n, hq, d, device=dev, generator=gen).to(bf),
            "live": int(lengths_cpu.sum()), "gen": gen}


def _slot_case(torch, c: dict) -> dict:
    """The slot kernels' inputs at the slice's shapes: ``_decode_case``'s
    q and lengths (8 live slots and an empty one) over slot-cache layer
    slices [9, Hkv, Smax, D] of Smax 2176, the cache length the engine
    gives ``max_len`` 2048 and ``decode_chunk`` 8 (not a multiple of the
    kernel's 64-row tile), ``layers`` slices cycled while timing. Every row
    is random, so a lane read past its length reads data."""
    smax, shape = 2176, (c["layers"], c["n"], c["hkv"], 2176, c["d"])
    k = torch.randn(shape, device="cuda", generator=c["gen"]).to(torch.bfloat16)
    v = torch.randn(shape, device="cuda", generator=c["gen"]).to(torch.bfloat16)
    return {"smax": smax, "k": k, "v": v}


def check_kernels(torch, timed: bool = True, keep_going: bool = False) -> list[dict]:
    """Each kernel against its plain version at the slice's shapes, and (if
    ``timed``) its time beside the plain version's, the library yardstick's
    and its bound. A kernel that fails its check ends the run, or, with
    ``keep_going``, is recorded (``passed`` False, its failure and numbers)
    and the next kernel is checked."""
    import torch.nn.functional as F

    from gofr_tpu_torch.ops.attention import (
        decode_attention_plain,
        decode_attention_split_plain,
        mha_attention_plain,
        paged_decode_attention_plain,
        paged_decode_attention_q4_plain,
        paged_decode_attention_q_plain,
        paged_decode_attention_q_split_plain,
        paged_decode_attention_split_plain,
    )
    from gofr_tpu_torch.ops.cuda import decode_attention as slot_decode_mod
    from gofr_tpu_torch.ops.cuda import flash_attention as flash_mod
    from gofr_tpu_torch.ops.cuda import paged_decode as decode_mod
    from gofr_tpu_torch.ops.cuda import paged_decode_q as decode_q_mod
    from gofr_tpu_torch.ops.cuda import paged_decode_q4 as decode_q4_mod
    from gofr_tpu_torch.ops.cuda.flash_attention import flash_attention
    from gofr_tpu_torch.ops.cuda.kv_append import (
        kv_append,
        kv_append_q,
        kv_append_q4,
        kv_append_slot,
        kv_append_slot_q,
    )
    from gofr_tpu_torch.ops.cuda.paged_decode import paged_decode
    from gofr_tpu_torch.ops.kvcache import QSlotKVCache, append_tokens_plain, append_tokens_q
    from gofr_tpu_torch.ops.paged import (
        append_tokens_paged_plain,
        append_tokens_paged_q,
        append_tokens_paged_q4,
        gather_kv,
    )
    from gofr_tpu_torch.ops.quant import unpack_int4

    def timing(kernel, plain, library=None, iters: int = 50, plain_iters: int = 10) -> dict:
        """Each of ``fn(i)`` kernel, plain version and library yardstick
        timed with CUDA events over back-to-back calls (``ms``), and the
        kernel and yardstick also by their device time (``device_ms``)."""
        if not timed:
            return {}
        return {"ms": time_ms(torch, kernel, iters), "device_ms": device_ms(torch, kernel, iters),
                "plain_ms": time_ms(torch, plain, plain_iters),
                "library_ms": library and time_ms(torch, library, iters),
                "library_device_ms": library and device_ms(torch, library, iters)}

    c = _decode_case(torch)
    hq, hkv, d, page, n, layers = (c[k] for k in ("hq", "hkv", "d", "page", "n", "layers"))
    q, table, lengths, k_pool, v_pool, gen = (c[k] for k in ("q", "table", "lengths", "k_pool",
                                                             "v_pool", "gen"))
    dev, bf = q.device, q.dtype
    decode_shape = {"slots": n, "hq": hq, "hkv": hkv, "d": d, "page": page,
                    "lengths": c["lengths_cpu"].tolist()}
    # bytes every decode kernel moves besides K/V: q and out, table, lengths
    decode_io = 2 * q.numel() * 2 + table.numel() * 4 + n * 4

    def edge_case(pool: int, maxp: int) -> tuple:
        """(split_rows, splits, lengths, table) of a paged decode's split
        edges: lanes on and one past the first three split boundaries, the
        whole table row, the empty slot and past the table, through a table
        of pages drawn in scrambled order with repeats and OOB entries
        inside two live lanes. Lanes this short are held against the split's
        plain version, which keeps the scores in f32 and splits as the
        kernels do."""
        r, splits = slot_decode_mod.split_plan(n, hkv, maxp * page)
        edges = torch.tensor([r, r + 1, 2 * r, 2 * r + 1, maxp * page, 0, maxp * page + 5, 3 * r,
                              3 * r + 1], device=dev, dtype=torch.int32)
        edge_table = torch.randint(0, pool, (n, maxp), generator=torch.Generator().manual_seed(SEED + 2),
                                   dtype=torch.int32)
        edge_table[1, 1] = edge_table[4, maxp - 1] = pool
        edge_table[5] = pool
        return r, splits, edges, edge_table.to(dev)

    def check_paged_decode() -> dict:  # A
        got = paged_decode(q, k_pool[0], v_pool[0], table, lengths)
        want = paged_decode_attention_plain(q, k_pool[0], v_pool[0], table, lengths)
        agree = agreement("paged_decode", got, want, decode_mod)
        require(torch.all(got[c["lengths_cpu"] == 0] == 0).item(), "paged_decode: empty slots not zero")
        r, splits, edges, edge_table = edge_case(k_pool.shape[1], table.shape[1])
        got_e = paged_decode(q, k_pool[0], v_pool[0], edge_table, edges)
        agree_e = agreement("paged_decode (split boundaries)", got_e,
                            paged_decode_attention_split_plain(q, k_pool[0], v_pool[0], edge_table,
                                                               edges, r), decode_mod)
        require(torch.all(got_e[5] == 0).item(), "paged_decode: the empty slot is not zero")
        b_ms, b_by = bound_ms(c["live"] * hkv * d * 2 * 2 + decode_io, 4 * c["live"] * hq * d)
        # yardstick only (never called by the port): SDPA with a length mask
        # and enable_gqa on each layer's logical view, gathered through the
        # table outside the timed call; it returns NaN for the empty slot
        views = [gather_kv(k_pool[layer], v_pool[layer], table) for layer in range(layers)] if timed else []
        mask = (torch.arange(table.shape[1] * page, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
        q1 = q[:, :, None]
        return {
            "name": "paged_decode", "route": "cuda", "source": "gofr_tpu_torch/csrc/paged_decode_q.cu",
            "replaces": "gofr_tpu/ops/pallas/paged_decode.py:94",
            "max_abs_err": max(a["max_abs_err"] for a in (agree, agree_e)),
            "rms_rel_err": max(a["rms_rel_err"] for a in (agree, agree_e)),
            "checks": {"ragged": agree, "split_boundaries": agree_e},
            "split": {"split_rows": r, "splits": splits},
            "tolerance": {"max_abs": decode_mod.MAX_ABS, "rms_rel": decode_mod.RMS_REL},
            **timing(lambda i: paged_decode(q, k_pool[i % layers], v_pool[i % layers], table,
                                            lengths),
                     lambda i: paged_decode_attention_plain(q, k_pool[i % layers], v_pool[i % layers],
                                                            table, lengths),
                     lambda i: F.scaled_dot_product_attention(q1, *views[i % layers], attn_mask=mask,
                                                              enable_gqa=True)),
            "bound_ms": b_ms, "bound_by": b_by, "shape": decode_shape,
        }

    def flash_case(s: int) -> tuple:
        """q, k, v of a batch of 4 x ``s`` prompts and the bound of a full
        causal call over them."""
        qf = torch.randn(4, s, hq, d, device=dev, generator=gen).to(bf)
        kf = torch.randn(4, s, hkv, d, device=dev, generator=gen).to(bf)
        vf = torch.randn(4, s, hkv, d, device=dev, generator=gen).to(bf)
        pairs = 4 * s * (s + 1) // 2
        return qf, kf, vf, bound_ms(2 * (2 * qf.numel() + 2 * kf.numel()), 4 * hq * d * pairs)

    def sdpa(qf, kf, vf):
        """Yardstick only (never called by the port): SDPA on head-major
        views, KV heads repeated outside the timed call."""
        qh = qf.transpose(1, 2)
        kh, vh = (t.transpose(1, 2).repeat_interleave(hq // hkv, dim=1) for t in (kf, vf))
        return lambda i: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)

    def flash_agree(label: str, qf, kf, vf, **kw) -> tuple:
        """(agreement with the plain version, the kernel's output)."""
        got = flash_attention(qf, kf, vf, causal=True, **kw)
        return agreement(f"flash_attention ({label})", got,
                         mha_attention_plain(qf, kf, vf, causal=True, **kw), flash_mod), got

    def check_flash() -> dict:  # C: batches of 4 x 512 and 4 x 1024 full prompts (causal)
        qf, kf, vf, (b_ms, b_by) = flash_case(512)
        checks = {"causal": flash_agree("causal", qf, kf, vf)[0]}
        # ragged lengths, offsets and a fully masked row: same agreement, zeros
        lens = torch.tensor([512, 300, 77, 0], device=dev, dtype=torch.int32)
        offs = torch.tensor([0, 40, 0, 0], device=dev, dtype=torch.int32)
        checks["ragged"], got_r = flash_agree("ragged", qf, kf, vf, q_offset=offs, kv_lengths=lens)
        require(torch.all(got_r[3] == 0).item(), "flash_attention: fully masked rows are not zero")
        # the longest prefill phase 4 pads to, where the bound is operations
        q2, k2, v2, (b_ms_l, b_by_l) = flash_case(1024)
        checks["causal_1024"] = flash_agree("causal 4 x 1024", q2, k2, v2)[0]
        lens = torch.tensor([1024, 700, 129, 0], device=dev, dtype=torch.int32)
        offs = torch.tensor([0, 40, 0, 0], device=dev, dtype=torch.int32)
        checks["ragged_1024"] = flash_agree("ragged 4 x 1024", q2, k2, v2, q_offset=offs,
                                            kv_lengths=lens)[0]
        # chunked prefill (models/llama.py, prefill with offsets): a chunk of
        # 200 queries (not a multiple of the 64-row tile) after offsets of up
        # to 824 cached positions, keys up to offset + chunk length
        offs = torch.tensor([512, 300, 0, 824], device=dev, dtype=torch.int32)
        lens = offs + torch.tensor([200, 131, 77, 200], device=dev, dtype=torch.int32)
        checks["chunked"] = flash_agree("chunked", q2[:, :200].contiguous(), k2, v2, q_offset=offs,
                                        kv_lengths=lens)[0]
        long = {"shape": {"batch": 4, "seq": 1024, "causal": True}, "bound_ms": b_ms_l,
                "bound_by": b_by_l,
                **timing(lambda i: flash_attention(q2, k2, v2, causal=True),
                         lambda i: mha_attention_plain(q2, k2, v2, causal=True), sdpa(q2, k2, v2),
                         iters=20, plain_iters=3)}
        return {
            "name": "flash_attention", "route": "cuda",
            "source": "gofr_tpu_torch/csrc/flash_attention.cu",
            "replaces": "gofr_tpu/ops/pallas/flash_attention.py:108",
            "max_abs_err": max(c["max_abs_err"] for c in checks.values()),
            "rms_rel_err": max(c["rms_rel_err"] for c in checks.values()),
            "checks": checks,
            "tolerance": {"max_abs": flash_mod.MAX_ABS, "rms_rel": flash_mod.RMS_REL},
            **timing(lambda i: flash_attention(qf, kf, vf, causal=True),
                     lambda i: mha_attention_plain(qf, kf, vf, causal=True), sdpa(qf, kf, vf),
                     iters=20, plain_iters=5),
            "bound_ms": b_ms, "bound_by": b_by, "seq_1024": long,
            "shape": {"batch": 4, "seq": 512, "hq": hq, "hkv": hkv, "d": d, "causal": True},
        }

    def check_decode_q(bits: int) -> dict:  # D (int8) and E (int4)
        name, mod, launch, plain, replaces = (
            ("paged_decode_q", decode_q_mod, decode_q_mod.paged_decode_q,
             paged_decode_attention_q_plain, "gofr_tpu/ops/pallas/paged_decode.py:195")
            if bits == 8 else
            ("paged_decode_q4", decode_q4_mod, decode_q4_mod.paged_decode_q4,
             paged_decode_attention_q4_plain, "gofr_tpu/ops/pallas/paged_decode.py:314"))
        cache = c["pools"][bits]

        def args(layer: int) -> tuple:
            return (q, cache.k[layer], cache.v[layer], cache.ks[layer], cache.vs[layer], table,
                    lengths)

        got, want = launch(*args(0)), plain(*args(0))
        agree = agreement(name, got, want, mod)
        require(torch.all(got[c["lengths_cpu"] == 0] == 0).item(), f"{name}: empty slots not zero")
        # the split's edges (edge_case); the split's plain version keeps p * vs
        # in f32 as the kernel does
        r, splits, edges, edge_table = edge_case(cache.k.shape[1], table.shape[1])
        edge_args = (*args(0)[:5], edge_table, edges)
        got_e = launch(*edge_args)
        agree_e = agreement(f"{name} (split boundaries)", got_e,
                            paged_decode_attention_q_split_plain(*edge_args, r, bits=bits), mod)
        require(torch.all(got_e[5] == 0).item(), f"{name}: the empty slot is not zero")
        # K and V rows of D (int8) or D/2 (packed) bytes plus two bf16 scales
        row_bytes = 2 * cache.k.shape[-1] + 2 * 2
        b_ms, b_by = bound_ms(c["live"] * hkv * row_bytes + decode_io, 4 * c["live"] * hq * d)
        return {
            "name": name, "route": "cuda", "source": "gofr_tpu_torch/csrc/paged_decode_q.cu",
            "replaces": replaces,
            "max_abs_err": max(a["max_abs_err"] for a in (agree, agree_e)),
            "rms_rel_err": max(a["rms_rel_err"] for a in (agree, agree_e)),
            "checks": {"ragged": agree, "split_boundaries": agree_e},
            "split": {"split_rows": r, "splits": splits},
            "tolerance": {"max_abs": mod.MAX_ABS, "rms_rel": mod.RMS_REL},
            # no one PyTorch call computes attention over quantized rows
            **timing(lambda i: launch(*args(i % layers)), lambda i: plain(*args(i % layers))),
            "bound_ms": b_ms, "bound_by": b_by, "shape": {**decode_shape, "kv_bits": bits},
        }

    sc = _slot_case(torch, c)
    smax, sk, sv = sc["smax"], sc["k"], sc["v"]
    slot_shape = {**{k: v for k, v in decode_shape.items() if k != "page"}, "smax": smax}

    def check_slot_decode() -> dict:  # F: the slot cache's decode attention
        slot_decode = slot_decode_mod.decode_attention
        got = slot_decode(q, sk[0], sv[0], lengths)
        agree = agreement("decode_attention", got, decode_attention_plain(q, sk[0], sv[0], lengths),
                          slot_decode_mod)
        require(torch.all(got[c["lengths_cpu"] == 0] == 0).item(), "decode_attention: empty slots not zero")
        # lane 0 past the slot, as an idle engine lane asks for cache_len + 1 + k:
        # the kernel clamps it to the slot, the plain version attends the whole slot
        over = lengths.clone()
        over[0] = smax + 5
        got_o = slot_decode(q, sk[0], sv[0], over)
        want_o = decode_attention_plain(q, sk[0], sv[0], over)
        agree_o = agreement("decode_attention (length past the slot)", got_o[:1], want_o[:1],
                            slot_decode_mod)
        # the split's edges: on and one past the first three split
        # boundaries, the whole slot, the empty slot, past the slot. Lanes
        # this short have outputs up to ~0.9, where the plain version's bf16
        # scores alone move an output by up to two bf16 ulps (7.8e-3 between
        # the two plain versions, past MAX_ABS); so they are held against the
        # split's plain version, which takes the scores in f32 and splits as
        # the kernel does
        rows_per_split, splits = slot_decode_mod.split_plan(n, hkv, smax)
        r = rows_per_split
        edges = torch.tensor([r, r + 1, 2 * r, 2 * r + 1, smax, 0, smax + 5, 3 * r, 3 * r + 1],
                             device=dev, dtype=torch.int32)
        got_e = slot_decode(q, sk[0], sv[0], edges)
        agree_e = agreement("decode_attention (split boundaries)", got_e,
                            decode_attention_split_plain(q, sk[0], sv[0], edges, r), slot_decode_mod)
        require(torch.all(got_e[5] == 0).item(), "decode_attention: the empty slot is not zero")
        b_ms, b_by = bound_ms(c["live"] * hkv * d * 2 * 2 + 2 * q.numel() * 2 + n * 4,
                              4 * c["live"] * hq * d)
        # yardstick only (never called by the port): SDPA with a length mask
        # built outside the timed call; it returns NaN for the empty slot
        mask = (torch.arange(smax, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
        q1 = q[:, :, None]
        return {
            "name": "decode_attention", "route": "cuda", "source": "gofr_tpu_torch/csrc/paged_decode.cu",
            "replaces": "gofr_tpu/ops/pallas/decode_attention.py:85",
            "max_abs_err": max(a["max_abs_err"] for a in (agree, agree_o, agree_e)),
            "rms_rel_err": max(a["rms_rel_err"] for a in (agree, agree_o, agree_e)),
            "checks": {"ragged": agree, "past_the_slot": agree_o, "split_boundaries": agree_e},
            "split": {"split_rows": rows_per_split, "splits": splits},
            "tolerance": {"max_abs": slot_decode_mod.MAX_ABS, "rms_rel": slot_decode_mod.RMS_REL},
            **timing(lambda i: slot_decode(q, sk[i % layers], sv[i % layers], lengths),
                     lambda i: decode_attention_plain(q, sk[i % layers], sv[i % layers], lengths),
                     lambda i: F.scaled_dot_product_attention(q1, sk[i % layers], sv[i % layers],
                                                              attn_mask=mask, enable_gqa=True)),
            "bound_ms": b_ms, "bound_by": b_by, "shape": slot_shape,
        }

    # -- the appends: B, G and the quantizing B-q, B-q4, G-q, bit-exact ----------------
    rows_gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    pool_pages = k_pool.shape[1]
    table_cpu = table.cpu()

    def append_rows() -> tuple:
        """k_new, v_new [N, Hkv, D] bf16, rows of max |x| 0.01..30; lane 4 all
        zero (codes 0, scale bf16(1e-8 / qmax)) and lane 5 a row whose max |x|
        is one element (its code reaches +-qmax), in the row's first half on
        K and its second half on V, the sign alternating by head."""
        mag = torch.rand(2, n, hkv, 1, device=dev, generator=rows_gen) * 30 + 0.01
        k_new, v_new = (torch.randn(2, n, hkv, d, device=dev, generator=rows_gen) * mag).to(bf)
        for new, half in ((k_new, 0), (v_new, d // 2)):
            new[4] = 0
            new[5] *= 1e-3
            for h in range(hkv):
                new[5, h, half + (h * 37) % (d // 2)] = (1 + h) * (-1) ** h
        return k_new, v_new

    def pool_edges(pool: int) -> tuple:
        """(positions, table) on the card and on the CPU for the pool appends'
        edge lanes: 0, 3, 4, 5 live at their length; 1 at -1; 2 at MaxP x page,
        past the table (lane 3's first entry, which a fault that forgets the
        drop would read, is a live page); 6 through an OOB entry (== P); 7
        through a negative entry; 8, the empty slot, at 0 through its all-OOB
        row."""
        pos = c["lengths_cpu"].clone()
        pos[1], pos[2] = -1, table.shape[1] * page
        etable = table_cpu.clone()
        etable[6, int(pos[6]) // page], etable[7, int(pos[7]) // page] = pool, -1
        return pos.to(dev), etable.to(dev), pos, etable

    def kept_pool(pos, tbl, pool: int) -> int:
        """Lanes the pool appends write (the drop rule, on the CPU)."""
        logical = pos.long() // page
        entry = tbl.long().gather(1, logical.clamp(0, tbl.shape[1] - 1)[:, None])[:, 0]
        return int(((pos >= 0) & (logical < tbl.shape[1]) & (entry >= 0) & (entry < pool)).sum())

    def same_bits(got, want) -> bool:
        return all(torch.equal(*(t.view(torch.int16) if t.dtype == bf else t for t in pair))
                   for pair in zip(got, want))

    def check_edge_rows(name: str, values, scales, qmax: int, where) -> None:
        """Lane 4 (all zero) stored as codes 0 with scale bf16(1e-8 / qmax),
        lane 5 (one element holds the max) reaching +-qmax in every head, on
        both planes; ``where(lane)`` indexes the lane's stored row."""
        zero_scale = (torch.tensor(1e-8) / qmax).to(bf).view(torch.int16).item()
        for vals, sc in zip(values, scales):
            codes = {lane: vals[where(lane)] for lane in (4, 5)}
            if vals.dtype == torch.uint8:
                codes = {lane: unpack_int4(x) for lane, x in codes.items()}
            require(torch.all(codes[4] == 0).item()
                    and torch.all(sc[where(4)].view(torch.int16) == zero_scale).item(),
                    f"{name}: an all-zero row is not stored as codes 0 with scale bf16(1e-8/{qmax})")
            require(torch.all(codes[5].abs().amax(dim=-1) == qmax).item(),
                    f"{name}: a row's single largest element does not reach +-{qmax}")

    def append_entry(name: str, source: str, replaces: str, timed_fns: tuple, n_bytes: float,
                     shape: dict) -> dict:
        b_ms, b_by = bound_ms(n_bytes, 0)
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "max_abs_err": 0.0, "tolerance": "bit-exact, values and scales",
                **timing(*timed_fns, iters=200, plain_iters=50),
                "bound_ms": b_ms, "bound_by": b_by, "shape": shape}

    append_src = "gofr_tpu_torch/csrc/kv_append.cu"
    append_shape = {"slots": n, "hkv": hkv, "d": d, "page": page}
    kept_timed = kept_pool(c["lengths_cpu"], table_cpu, pool_pages)
    # the table entries the timed pool appends read: one per lane whose
    # position lies in [0, MaxP x page)
    entries_timed = int(((c["lengths_cpu"] >= 0) & (c["lengths_cpu"] < table.shape[1] * page)).sum())

    def append_bytes(entries: int, kept: int, row_out: int, scale: int) -> int:
        """What an append must move: the N positions, ``entries`` table
        entries, and for each of the ``kept`` lanes' Hkv rows of both planes
        the bf16 row read and the ``row_out``-byte row and ``scale``-byte
        scale written (a dropped lane's row need not be read)."""
        return n * 4 + entries * 4 + 2 * kept * hkv * (d * 2 + row_out + scale)

    def check_kv_append() -> dict:  # B
        k_new, v_new = append_rows()
        pos, etable, _, _ = pool_edges(pool_pages)
        got = [k_pool[0].clone(), v_pool[0].clone()]
        want = [t.clone() for t in got]
        kv_append(*got, etable, pos, k_new, v_new)
        append_tokens_paged_plain(*want, etable, pos, k_new, v_new)
        require(same_bits(got, want), "kv_append pool differs from the plain write")
        require(not torch.equal(got[0], k_pool[0]) and not torch.equal(got[1], v_pool[0]),
                "kv_append wrote nothing")
        del got, want
        return append_entry(
            "kv_append", append_src, "gofr_tpu/ops/pallas/kv_append.py:110",
            (lambda i: kv_append(k_pool[i % layers], v_pool[i % layers], table, lengths, k_new, v_new),
             lambda i: append_tokens_paged_plain(k_pool[i % layers], v_pool[i % layers], table, lengths,
                                                 k_new, v_new)),
            append_bytes(entries_timed, kept_timed, d * 2, 0), append_shape)

    def check_append_q(bits: int) -> dict:  # B-q (int8) and B-q4 (int4)
        name, launch, plain, qmax = (("kv_append_q", kv_append_q, append_tokens_paged_q, 127)
                                     if bits == 8 else
                                     ("kv_append_q4", kv_append_q4, append_tokens_paged_q4, 7))
        cache = c["pools"][bits]
        k_new, v_new = append_rows()
        pos, etable, pos_cpu, etable_cpu = pool_edges(cache.k.shape[1])
        got = [t[0].clone() for t in (cache.k, cache.v, cache.ks, cache.vs)]
        want = [t.clone() for t in got]
        launch(*got, etable, pos, k_new, v_new)
        for values, scales, new in ((want[0], want[2], k_new), (want[1], want[3], v_new)):
            plain(values, scales, etable, pos, new)
        require(same_bits(got, want), f"{name} differs from the plain append (values or scales)")
        require(not torch.equal(got[0], cache.k[0]), f"{name} wrote nothing")
        check_edge_rows(name, got[:2], got[2:], qmax,
                        lambda lane: (int(etable_cpu[lane, int(pos_cpu[lane]) // page]), slice(None),
                                      int(pos_cpu[lane]) % page))
        del got, want

        def planes(i: int) -> tuple:
            return cache.k[i % layers], cache.v[i % layers], cache.ks[i % layers], cache.vs[i % layers]

        def plain_both(i: int) -> None:
            kq, vq, ks, vs = planes(i)
            plain(kq, ks, table, lengths, k_new)
            plain(vq, vs, table, lengths, v_new)

        return append_entry(
            name, append_src, "port-only (XLA in JAX: gofr_tpu/ops/paged.py:"
                              f"{344 if bits == 8 else 438})",
            (lambda i: launch(*planes(i), table, lengths, k_new, v_new), plain_both),
            append_bytes(entries_timed, kept_timed, cache.k.shape[-1], 2),
            {**append_shape, "kv_bits": bits})

    def slot_edges() -> torch.Tensor:
        """Positions of the slot appends' edge lanes: 0 at Smax, 1 at -1, 2 at
        Smax + 7 (dropped), the others live at their length (8, the empty
        slot, at 0)."""
        pos = lengths.clone()
        pos[0], pos[1], pos[2] = smax, -1, smax + 7
        return pos

    kept_slot = int(((c["lengths_cpu"] >= 0) & (c["lengths_cpu"] < smax)).sum())
    slot_append_shape = {"slots": n, "hkv": hkv, "d": d, "smax": smax}

    def check_kv_append_slot() -> dict:  # G
        k_new, v_new = append_rows()
        pos = slot_edges()
        got = [sk[0].clone(), sv[0].clone()]
        want = [t.clone() for t in got]
        kv_append_slot(*got, pos, k_new, v_new)
        append_tokens_plain(*want, pos, k_new, v_new)
        require(same_bits(got, want), "kv_append_slot cache differs from the plain write")
        require(all(torch.equal(a[i], b[0][i]) for a, b in zip(got, (sk, sv)) for i in (0, 1, 2)),
                "kv_append_slot wrote a lane whose position lies outside the slot")
        require(not torch.equal(got[0], sk[0]), "kv_append_slot wrote nothing")
        del got, want
        return append_entry(
            "kv_append_slot", append_src, "gofr_tpu/ops/pallas/kv_append.py:61",
            (lambda i: kv_append_slot(sk[i % layers], sv[i % layers], lengths, k_new, v_new),
             lambda i: append_tokens_plain(sk[i % layers], sv[i % layers], lengths, k_new, v_new)),
            append_bytes(0, kept_slot, d * 2, 0), slot_append_shape)

    def check_append_slot_q() -> dict:  # G-q
        cache = QSlotKVCache.create(layers, n, smax, hkv, d, device=dev)
        k_new, v_new = append_rows()
        pos = slot_edges()
        pos_cpu = pos.cpu()
        got = [t[0].clone() for t in (cache.k, cache.v, cache.ks, cache.vs)]
        want = [t.clone() for t in got]
        kv_append_slot_q(*got, pos, k_new, v_new)
        for values, scales, new in ((want[0], want[2], k_new), (want[1], want[3], v_new)):
            append_tokens_q(values, scales, pos, new)
        require(same_bits(got, want), "kv_append_slot_q differs from the plain append (values or scales)")
        require(not torch.equal(got[0], cache.k[0]), "kv_append_slot_q wrote nothing")
        check_edge_rows("kv_append_slot_q", got[:2], got[2:], 127,
                        lambda lane: (lane, slice(None), int(pos_cpu[lane])))
        del got, want

        def planes(i: int) -> tuple:
            return cache.k[i % layers], cache.v[i % layers], cache.ks[i % layers], cache.vs[i % layers]

        def plain_both(i: int) -> None:
            kq, vq, ks, vs = planes(i)
            append_tokens_q(kq, ks, lengths, k_new)
            append_tokens_q(vq, vs, lengths, v_new)

        return append_entry(
            "kv_append_slot_q", append_src, "port-only (XLA in JAX: gofr_tpu/ops/kvcache.py:132)",
            (lambda i: kv_append_slot_q(*planes(i), lengths, k_new, v_new), plain_both),
            append_bytes(0, kept_slot, d, 2), {**slot_append_shape, "kv_bits": 8})

    checks = [("paged_decode", check_paged_decode), ("kv_append", check_kv_append),
              ("paged_decode_q", lambda: check_decode_q(8)),
              ("paged_decode_q4", lambda: check_decode_q(4)),
              ("flash_attention", check_flash),
              ("decode_attention", check_slot_decode), ("kv_append_slot", check_kv_append_slot),
              ("kv_append_q", lambda: check_append_q(8)), ("kv_append_q4", lambda: check_append_q(4)),
              ("kv_append_slot_q", check_append_slot_q)]
    results = []
    for name, check in checks:
        try:
            results.append({**check(), "passed": True})
        except SystemExit as failure:
            if not keep_going:
                raise
            results.append({"name": name, "passed": False, "failure": str(failure),
                            **getattr(failure, "numbers", {})})
    return results


# The serving runs of phase 4 and the checks of phase 5, one per cache:
# (kv_layout, kv_quantize).
RUNS = (("paged", ""), ("paged", "int8"), ("paged", "int4"), ("slot", ""), ("slot", "int8"))
# The kernels each run must launch; every other kernel must launch no time
# in that run. The int8 slot cache's decode attention is plain PyTorch (the
# TPU ran it as XLA). Every kernel but the flash prefill runs once per layer
# and decode step, so those of one run launch equally often.
ON_PATH = {("paged", ""): ("paged_decode", "kv_append", "flash_attention"),
           ("paged", "int8"): ("paged_decode_q", "kv_append_q", "flash_attention"),
           ("paged", "int4"): ("paged_decode_q4", "kv_append_q4", "flash_attention"),
           ("slot", ""): ("decode_attention", "kv_append_slot", "flash_attention"),
           ("slot", "int8"): ("kv_append_slot_q", "flash_attention")}
PREFILL_KERNELS = ("flash_attention",)


def run_name(kv_layout: str, kv_quantize: str) -> str:
    pool = kv_quantize or "bf16"
    return pool if kv_layout == "paged" else f"slot_{pool}"


def serve(torch, cuda, model=None, kv_quantize: str = "",
          kv_layout: str = "paged") -> tuple[object, dict, dict]:
    """Serve 8 concurrent greedy requests on a Llama-3-8B engine with the
    cache ``kv_layout`` in the format ``kv_quantize``; a new model with
    random weights from the seed, or ``model`` when given. Returns (engine,
    launches, metrics)."""
    from gofr_tpu_torch.gpu.engine import build_engine
    from gofr_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig.llama3_8b() if model is None else model.cfg
    t0 = time.perf_counter()
    eng = build_engine(cfg, params=model, device="cuda", seed=SEED, slots=8, max_len=2048,
                       max_prefill_batch=4, decode_chunk=8, kv_quantize=kv_quantize,
                       kv_layout=kv_layout)
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
    pool = f"{kv_layout} {kv_quantize or 'bf16'}"
    for i, o in enumerate(outs):
        require(o["finish_reason"] == "length" and len(o["tokens"]) == 64,
                f"{pool} request {i}: {o['finish_reason']}, {len(o['tokens'])} tokens")
        require(all(0 <= t < cfg.vocab_size for t in o["tokens"]),
                f"{pool} request {i}: token out of range")
    for name, launches in counts.items():
        if name in ON_PATH[kv_layout, kv_quantize]:
            require(launches > 0, f"kernel {name} was not launched on the {pool} cache's path")
        else:
            require(launches == 0, f"kernel {name} was launched {launches} times on the {pool} "
                                   f"cache's path")
    per_step = {counts[name] for name in ON_PATH[kv_layout, kv_quantize] if name not in PREFILL_KERNELS}
    require(len(per_step) == 1 and per_step.pop() % cfg.num_layers == 0,
            f"{pool} cache: the decode-step kernels' launches differ or are not whole steps: {counts}")
    from gofr_tpu_torch.ops.paged import kv_plane_bytes_per_position

    cache = eng.cache
    positions = cache.k.shape[1] * cache.k.shape[3]  # pages x page size, or slots x Smax
    pool_bytes = sum(t.nbytes for t in vars(cache).values())
    per = kv_plane_bytes_per_position(cfg.num_layers, cfg.num_kv_heads, cfg.head_size,
                                      kv_quantize or "bf16")
    require(pool_bytes == per * positions,
            f"{pool} cache holds {pool_bytes} B for {positions} positions, not {per} B each")
    first = [t_submit + o["ttft_s"] for o in outs]
    done = [f + o["decode_s"] for f, o in zip(first, outs)]
    decoded = sum(len(o["tokens"]) - 1 for o in outs)
    ttft = sorted(o["ttft_s"] for o in outs)
    metrics = {
        "model": "llama3_8b (random bf16 weights, seed 0)", "layers": cfg.num_layers,
        "kv_layout": kv_layout, "kv_pool": kv_quantize or "bf16",
        "pool_bytes": pool_bytes, "pool_positions": positions,
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


def model_steps(torch, model, kv_quantize: str, prompt, prefill_kernels: bool,
                decode_kernels: bool, fed=None, kv_layout: str = "paged"):
    """Logits [5, 1, V] of ``prompt`` (1 x 256) through ``prefill`` and four
    ``decode_step`` steps on a fresh cache of 512 positions (4 pages of
    128, or one slot), ``kv_layout`` in the format ``kv_quantize``, the
    kernels or their plain versions in each. Each step is fed ``fed``'s
    tokens when given, else the run's own greedy tokens. Returns (logits,
    the tokens fed, the K/V the cache holds at the end as its read path
    returns them, f32 [L, 2, Hkv, written positions, D])."""
    from gofr_tpu_torch.gpu.engine import make_pool

    lengths = torch.tensor([prompt.shape[1]], device="cuda")
    if kv_layout == "paged":
        rows = table = torch.arange(4, dtype=torch.int32, device="cuda")[None]
        cache = make_pool(model, kv_quantize, 4, 128)
    else:
        rows, table = torch.zeros(1, dtype=torch.int32, device="cuda"), None
        cache = make_pool(model, kv_quantize, 1, 512, "slot")
    logits, _ = model.prefill(prompt, lengths, cache, rows, kernels=prefill_kernels)
    seq, chosen = [logits], []
    for step in range(4):
        tokens = logits.argmax(-1).to(torch.int32) if fed is None else fed[step]
        chosen.append(tokens)
        pos = torch.tensor([prompt.shape[1] + step], device="cuda")
        logits, _ = model.decode_step(tokens, pos, cache, table, kernels=decode_kernels)
        seq.append(logits)
    written = prompt.shape[1] + 4
    stored = torch.stack([torch.stack(cache.read(layer, rows, torch.float32))[:, 0, :, :written]
                          for layer in range(cache.num_layers)]).float()
    return torch.stack(seq), chosen, stored


def no_sync_check(torch, cuda, model, kv_layout: str, kv_quantize: str) -> dict:
    """Two ``decode_step`` steps on a fresh cache of the layout and format,
    inside ``torch.cuda.set_sync_debug_mode("error")``: any call that makes
    the host wait on the card raises there, and nothing catches it. Eight
    lanes take int64 positions, as the engine hands them; the last lane is
    idle as the engine parks one (its table row all OOB at position 0 on the
    pool, at the slot's end on the slot cache), so its writes drop. The
    decode kernels of the cache's path must launch once per layer and step,
    and the logits must be finite."""
    from gofr_tpu_torch.gpu.engine import make_pool

    n, page, pages = 8, 128, 4
    rng = torch.Generator().manual_seed(SEED + 4)
    tokens = torch.randint(0, model.cfg.vocab_size, (n,), generator=rng).cuda()
    positions = torch.randint(0, pages * page - 2, (n,), generator=rng)
    if kv_layout == "paged":
        cache = make_pool(model, kv_quantize, n * pages, page)
        table = torch.arange(n * pages, dtype=torch.int32).view(n, pages)
        table[n - 1], positions[n - 1] = n * pages, 0
        table = table.cuda()
    else:
        cache, table = make_pool(model, kv_quantize, n, pages * page, "slot"), None
        positions[n - 1] = pages * page
    positions = positions.cuda()
    torch.cuda.synchronize()
    cuda.reset_launch_counts()
    steps = 2
    torch.cuda.set_sync_debug_mode("error")
    try:
        for step in range(steps):
            logits, _ = model.decode_step(tokens, positions + step, cache, table)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    counts = cuda.launch_counts()
    pool = f"{kv_layout} {kv_quantize or 'bf16'}"
    decode_kernels = [k for k in ON_PATH[kv_layout, kv_quantize] if k not in PREFILL_KERNELS]
    require(all(counts[k] == steps * model.cfg.num_layers for k in decode_kernels)
            and sum(counts.values()) == steps * model.cfg.num_layers * len(decode_kernels),
            f"{pool}: decode_step did not go through its kernels once per layer: {counts}")
    require(bool(logits.isfinite().all()), f"{pool}: non-finite logits under the sync check")
    return {"kv_layout": kv_layout, "kv_pool": kv_quantize or "bf16", "steps": steps,
            "sync_debug_mode": "error", "launches": {k: counts[k] for k in decode_kernels}}


# Phase 5's runs besides the plain one: (prefill kernels, decode kernels).
# "kernels" is the served path and is held to LOGITS_RTOL; the two splits
# show which half of the step an error comes from.
PHASE5_RUNS = {"kernels": (True, True), "plain_prefill": (False, True),
               "plain_decode": (True, False)}


def model_check(torch, model, kv_quantize: str = "", enforce: bool = True,
                kv_layout: str = "paged") -> dict:
    """Kernels vs plain versions, end to end through the model, on a cache
    ``kv_layout`` of the format ``kv_quantize``: each of ``PHASE5_PROMPTS``
    prompts of 256 tokens through ``prefill`` and four ``decode_step`` steps
    with the plain versions, with the kernels, and with the kernels in one
    half of the step only, every run fed the kernel run's greedy tokens.
    Reports, for each run and step, max |logits - plain logits| over max
    |plain logit|, and how the K/V stored by the kernel run differ from the
    plain run's (the share of elements that differ, and the RMS of the
    difference over the RMS of the stored values). With ``enforce``, the
    kernel run's largest error must stay under the pool's limit, and the
    decode-only run's under ``DECODE_RTOL``."""
    pool = f"{kv_layout} {kv_quantize or 'bf16'}"
    rng = torch.Generator().manual_seed(SEED + 1)
    steps = {name: [] for name in PHASE5_RUNS}
    agree, differ, stored_rel = [], [], []
    for _ in range(PHASE5_PROMPTS):
        prompt = torch.randint(0, model.cfg.vocab_size, (1, 256), generator=rng).cuda()
        k_run, fed, k_kv = model_steps(torch, model, kv_quantize, prompt, True, True,
                                       kv_layout=kv_layout)
        p_run, _, p_kv = model_steps(torch, model, kv_quantize, prompt, False, False, fed,
                                     kv_layout)
        require(torch.isfinite(k_run).all().item(), f"non-finite logits with the kernels ({pool})")
        top = p_run.abs().max().item()
        for name, (pk, dk) in PHASE5_RUNS.items():
            run = k_run if name == "kernels" else model_steps(
                torch, model, kv_quantize, prompt, pk, dk, fed, kv_layout)[0]
            steps[name].append(((run - p_run).abs().amax(dim=(1, 2)) / top).tolist())
        agree.append((k_run.argmax(-1) == p_run.argmax(-1)).float().mean().item())
        differ.append((k_kv != p_kv).float().mean().item())
        stored_rel.append(((k_kv - p_kv).pow(2).mean() / p_kv.pow(2).mean()).sqrt().item())
        del k_kv, p_kv
    rel_errs = [max(s) for s in steps["kernels"]]
    decode_errs = [max(s[1:]) for s in steps["plain_prefill"]]
    out = {"kv_layout": kv_layout, "kv_pool": kv_quantize or "bf16", "prompts": PHASE5_PROMPTS,
           "steps": 5, "rel_err": rel_errs,
           "tol_rel": LOGITS_RTOL[kv_quantize], "decode_only_rel_err": decode_errs,
           "decode_only_tol_rel": DECODE_RTOL, "argmax_agree": agree, "rel_err_by_step": steps,
           "stored_differ": differ, "stored_rms_rel": stored_rel}
    if enforce:
        require(max(rel_errs) < LOGITS_RTOL[kv_quantize],
                f"kernel vs plain logits ({pool}): max err / max |logit| {rel_errs} "
                f"(limit {LOGITS_RTOL[kv_quantize]})")
        require(max(decode_errs) < DECODE_RTOL,
                f"kernel vs plain logits, kernels in decode only ({pool}): {decode_errs} "
                f"(limit {DECODE_RTOL})")
    return out


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from gofr_tpu_torch.gpu.device import device_info
    from gofr_tpu_torch.ops import cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wall, start = {}, time.perf_counter()

    def lap(name: str) -> None:
        wall[name] = time.perf_counter() - start - sum(wall.values())

    emit("phase1_device", device_info())

    built = cuda.build()
    notes = [ln.strip() for ln in built["ptxas"].splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    emit("phase2_build", {"seconds": built["seconds"], "ptxas": notes})
    lap("phases_1_2")

    kernels = check_kernels(torch)
    emit("phase3_kernels", kernels)
    torch.cuda.empty_cache()
    lap("phase3")

    # the same 8 requests on each cache, one model
    model, served = None, {}
    for kv_layout, kv_quantize in RUNS:
        eng, counts, metrics = serve(torch, cuda, model, kv_quantize, kv_layout)
        emit(f"phase4_serve_{run_name(kv_layout, kv_quantize)}", {**metrics, "launches": counts})
        eng.stop()
        model = eng.model
        served[kv_layout, kv_quantize] = {"metrics": metrics, "launches": counts}
        del eng
        torch.cuda.empty_cache()
        lap(f"phase4_{run_name(kv_layout, kv_quantize)}")

    for kv_layout, kv_quantize in RUNS:
        emit(f"phase5_model_{run_name(kv_layout, kv_quantize)}",
             model_check(torch, model, kv_quantize, kv_layout=kv_layout))
        lap(f"phase5_{run_name(kv_layout, kv_quantize)}")

    emit("phase6_no_sync", [no_sync_check(torch, cuda, model, *run) for run in RUNS])
    lap("phase6")

    # each kernel's launches from the first serving run whose path it is on
    for k in kernels:
        run = next(r for r in RUNS if k["name"] in ON_PATH[r])
        k["launches"] = served[run]["launches"][k["name"]]
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"kernels": kernels, "wall_s": wall,
                   "serve": {run_name(*r): run for r, run in served.items()}}, f, indent=1)
    emit("wall_time", {"seconds": time.perf_counter() - start, "by_phase": wall})
    print(json.dumps({"kernels": [{key: k[key] for key in (
        "name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
        "bound_ms", "bound_by", "library_ms")} for k in kernels]}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
