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
   and 4 x 1024 prefills, full and ragged, a chunk of 200 queries after
   cached offsets and one of 512 at offset 512 (phase 4's chunk), and the
   verify forward of speculative decoding, 5 queries at each live slot's
   length against 2176 keys; the five appends, bf16 and quantizing, on
   edge lanes: a position of -1, past the table, through an OOB or
   negative entry, at and past Smax, an all-zero row and a row whose max
   is one element): each held against its plain PyTorch version on the
   same inputs (the appends bit for bit, values and scales), timed with
   CUDA events and by device time beside the plain version, a library
   yardstick where one PyTorch call computes the same function, and the
   least time the card could take (its bound);
4. the main path, once per cache (``RUNS``): a full-width, full-depth
   Llama-3-8B engine with random bf16 weights from a seed serves 8
   concurrent requests (prompts of 64..1024 tokens, 64 new greedy tokens
   each) on a bf16 pool, then the same model on an int8 and an int4 pool
   (``kv_quantize``) and on a bf16 and an int8 slot cache
   (``kv_layout="slot"``); every launch counter is set to 0 just before
   each run and read just after it, and each kernel of that cache's path
   (``ON_PATH``) must be > 0, the decode-step kernels equally often, and
   every other kernel 0. Then the speculative runs (``SPEC_RUNS``, g = 4)
   on the same prompts: ``paged_spec``, prompt lookup on the bf16 pool,
   must launch C alone (on verify rows once a layer a round), and
   ``slot_spec_draft``, a draft of Llama-3-8B's widths cut to 2 layers on
   the bf16 slot cache, C, F and G (the draft's steps); each prints its
   accept rate, tokens per lane and verify forward, and the share of
   requests whose tokens equal the plain run's on its cache with the logit
   margins at the first differences, the share not held; at each first
   difference the token the spec run chose must lie within ``SPEC_TIE_GAP``
   of the top logit of a whole-sequence forward (a bf16 near tie, not a
   wrong acceptance); one request of ``paged_spec`` is streamed, and its
   ids must equal that request's own result. Then
   ``paged_admission``: the same model on a
   bf16 pool of 40 pages (``ADMISSION``), where a warm request leaves a
   768-token system prefix in the prefix cache and a burst of 8 prompts
   that share it (896..1408 tokens, so all chunk) and 4 that do not must
   preempt; it must launch the bf16 pool's kernels, C on chunked rows among
   them, every request must end with 64 tokens, each of the 8 must be
   served 6 pages from the cache, and the pool's audit must pass. The
   share of requests whose tokens equal an unconstrained run's (no prefix
   cache, no chunking, the full pool) is printed with the margins, not held.
   Then ``paged_prefix_host``: the same traffic on an engine with a host
   tier of 512 MiB (``HOST_TIER``), then 4 prompts that need the whole
   pool, then the 8 shared prompts again; the pressure must spill pages,
   the second wave must swap pages in, serve each of its prompts the
   768-token prefix from the cache and at least those 6 pages from the host
   tier, every burst's tokens must equal the same traffic's with the tier
   off by the tie rule, and the pool and tier audit must pass after each
   burst; it prints the swap-ins' pages, bytes, ms on the card and GB/s
   beside the host link's raw rate (the data sheet's PCIe Gen5 x16 where
   nvidia-smi reports none). Then ``paged_pipeline``: pipeline depth
   1 against 2 on the bf16 pool, in turns 1, 2, 2, 1, 16 prompts in 4 waves
   of 4, each wave submitted once the previous one's first tokens are out;
   each arm must launch A, B, C and no other kernel, carry at most depth -
   1 calls across a loop turn (1 at depth 2), and give the first arm's
   tokens by the tie rule; it prints each arm's tok/s, TTFT p50 and max,
   host ms a loop turn, the folds' wait on their events, and the device's
   idle share over one more wave run under ``torch.profiler`` after the
   timed ones, holding none.
   Then ``paged_lora``: ``bf16``'s traffic on an engine with the adapter
   plane (4 pool slots of rank 16; three random adapters of ranks 8, 12
   and 16), the requests on the base model and the three adapters in turn;
   it must launch the ``bf16`` run's kernels, end every request with 64
   tokens, give every adapter request other tokens than the ``bf16`` run's
   on the same prompt, and leave 3 adapters resident and none referenced;
   the share of base requests whose tokens equal the ``bf16`` run's and
   tok/s beside it are printed. Last the adoption check: on Llama-3-8B's
   widths cut to 2 layers, ``adopt_weights`` swaps in new random weights
   while 4 requests decode; all 4 must end with 64 tokens, each preempted once,
   ``weights_epoch`` must be 1, and a request after the swap must equal,
   token for token, the same request on an engine built on the new
   weights. Then ``http_generate``: the port's App on localhost, its
   engine built from a ``ModelSpec`` and ``ENGINE_*`` config
   (``HTTP_CONFIG``; random weights from the seed, the phase's model),
   takes the 8 prompts as 8 concurrent ``POST /generate`` (each 201, 64
   tokens, compared with ``bf16``'s by the spec runs' tie rule), two
   streamed over ``POST /generate/stream`` (``token`` frames, then
   ``done``; ids held against the unary result by the same rule), a
   0.001 s timeout (408) and an unknown path (404), each with its
   envelope; alive and health answer, ``app_http_response`` counts the
   POSTs, the launch counters show ``bf16``'s kernels and no other, and
   after ``stop`` the engine's thread has ended; it prints the HTTP
   overhead per request, the SSE first event against the engine's TTFT
   and decode tok/s beside ``bf16``'s;
5. the model on the card, on each cache: three prompts through
   ``prefill`` and four ``decode_step`` steps with the kernels, with
   their plain versions, with the kernels in prefill only and in decode
   only, and with the kernels and the prompt prefilled in two chunks of
   128 (``PHASE5_RUNS``); the kernel runs' logits, the chunked one's too,
   must agree with the plain whole-prompt run's within the limits below,
   and each step's error of every run is reported; a ``verify_step`` of 5
   tokens after the prompt, with the kernels, must agree with its plain
   version within the same limits, and the plain verify with the plain
   decode steps' logits within ``DECODE_RTOL``; then on each cache one
   ``decode_step`` and one ``verify_step`` over 5 lanes on the base model
   and the adapters (``LORA_SEL``): the base lanes' logits must be
   bit-identical to the same call's without adapters, the adapter lanes'
   within ``LOGITS_RTOL`` of the plain path's with adapters;
6. no host sync: a prefill of two 128-token chunks, two ``decode_step``
   steps and one speculative round with a sampled lane on each cache, then
   an adapter upload, a ``decode_step`` and a speculative round with the
   lanes on the base model and adapters, inside
   ``torch.cuda.set_sync_debug_mode("error")``, which raises on any call
   that makes the host wait on the card; then on a stopped engine of each
   cache the engine's own dispatches under the same check: a batched
   prefill, two prefill chunks, two decode chunks (the second from the
   device carry), a swap-in on the pool (the page swapped in must equal its
   source bit for bit) and two speculative rounds, the folds outside it.

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
# A spec run and the plain run round bf16 logits through different kernels
# (C over a dense view against A/F), so a near tie can flip: at a first
# difference the spec run's token must lie within four bf16 ulps of the top
# logit (one ulp is 1/32 at |logit| in [4, 8), where these logits lie).
SPEC_TIE_GAP = 0.125
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
        # the engine's chunked prefill at phase 4's chunk: 512 queries at
        # offset 512 against the 1024 keys of the dense view
        qc = torch.randn(1, 512, hq, d, device=dev, generator=gen).to(bf)
        kc, vc = (torch.randn(1, 1024, hkv, d, device=dev, generator=gen).to(bf) for _ in range(2))
        offc = torch.tensor([512], device=dev, dtype=torch.int32)
        lenc = torch.tensor([1024], device=dev, dtype=torch.int32)
        checks["chunk_512_at_512"] = flash_agree("chunk 512 at 512", qc, kc, vc, q_offset=offc,
                                                 kv_lengths=lenc)[0]
        # speculative decoding's verify forward (Llama.verify_step, phase 4's
        # paged_spec): g + 1 = 5 queries a lane at each of the 8 live lanes'
        # lengths, against the dense view of its 17 pages (2176 keys)
        nv, gp1, view = 8, 5, 17 * page
        qv = torch.randn(nv, gp1, hq, d, device=dev, generator=gen).to(bf)
        kv, vv = (torch.randn(nv, view, hkv, d, device=dev, generator=gen).to(bf) for _ in range(2))
        offv = lengths[:nv].contiguous()
        lenv = offv + gp1
        checks["verify"] = flash_agree("verify", qv, kv, vv, q_offset=offv, kv_lengths=lenv)[0]
        # bound: the keys each lane attends read once (K and V), q and out, and
        # query i of a lane at length L attending L + i + 1 keys
        live = c["lengths_cpu"][:nv].long()
        keys, pairs = int((live + gp1).sum()), int((gp1 * live + gp1 * (gp1 + 1) // 2).sum())
        b_ms_v, b_by_v = bound_ms(2 * 2 * qv.numel() + 2 * keys * hkv * d * 2 + 2 * nv * 4,
                                  4 * hq * d * pairs)
        # yardstick only: SDPA with the rows' causal mask as a bool mask and
        # enable_gqa, on head-major views made outside the timed call
        verify_mask = (torch.arange(view, device=dev)[None, None, :]
                       <= (offv[:, None] + torch.arange(gp1, device=dev)[None, :])[:, :, None])
        qvh, kvh, vvh = (t.transpose(1, 2) for t in (qv, kv, vv))
        verify = {"shape": {"batch": nv, "queries": gp1, "offsets": offv.tolist(), "keys": view},
                  "bound_ms": b_ms_v, "bound_by": b_by_v,
                  **timing(lambda i: flash_attention(qv, kv, vv, causal=True, q_offset=offv,
                                                     kv_lengths=lenv),
                           lambda i: mha_attention_plain(qv, kv, vv, causal=True, q_offset=offv,
                                                         kv_lengths=lenv),
                           lambda i: F.scaled_dot_product_attention(
                               qvh, kvh, vvh, attn_mask=verify_mask[:, None], enable_gqa=True),
                           iters=50, plain_iters=5)}
        # query i at position 512 + i attends keys 0 .. 512 + i
        b_ms_c, b_by_c = bound_ms(2 * (2 * qc.numel() + 2 * kc.numel()),
                                  4 * hq * d * (512 * 513 + 512 * 511 // 2))
        # yardstick only: SDPA with the chunk's causal mask as a bool mask
        # and KV heads repeated, built outside the timed call
        chunk_mask = (torch.arange(1024, device=dev)[None, :]
                      <= 512 + torch.arange(512, device=dev)[:, None])
        qch = qc.transpose(1, 2)
        kch, vch = (t.transpose(1, 2).repeat_interleave(hq // hkv, dim=1) for t in (kc, vc))
        chunk = {"shape": {"batch": 1, "queries": 512, "offset": 512, "keys": 1024},
                 "bound_ms": b_ms_c, "bound_by": b_by_c,
                 **timing(lambda i: flash_attention(qc, kc, vc, causal=True, q_offset=offc,
                                                    kv_lengths=lenc),
                          lambda i: mha_attention_plain(qc, kc, vc, causal=True, q_offset=offc,
                                                        kv_lengths=lenc),
                          lambda i: F.scaled_dot_product_attention(qch, kch, vch,
                                                                   attn_mask=chunk_mask),
                          iters=50, plain_iters=5)}
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
            "bound_ms": b_ms, "bound_by": b_by, "seq_1024": long, "chunk_512_at_512": chunk,
            "verify_5_at_live": verify,
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
# Phase 4's speculative runs (spec_tokens g = 4), each on the model of the
# runs above and the prompts of the plain run on its cache: prompt lookup
# on the bf16 pool, and a draft model on the bf16 slot cache, Llama-3-8B's
# widths cut to ``DRAFT_LAYERS`` layers with random weights from seed 1.
# The target's decode step gives way to one verify forward a round, C over
# g + 1 queries a lane: the pool's A and B never launch; the draft's decode
# steps launch F and G.
SPEC_G = 4
DRAFT_LAYERS = 2
SPEC_RUNS = {"paged_spec": ("paged", ""), "slot_spec_draft": ("slot", "")}
ON_PATH_SPEC = {"paged_spec": ("flash_attention",),
                "slot_spec_draft": ("flash_attention", "decode_attention", "kv_append_slot")}
# The adapter plane: phase 4's ``paged_lora`` run is ``bf16`` with a pool of
# 4 adapter slots of rank 16 and three random adapters of ranks 8, 12 and 16
# (``random_adapter`` from seeds 40, 41, 42), the 8 requests on the base
# model, ad0, ad1 and ad2 in turn; it must launch the ``bf16`` run's
# kernels. Phases 5 and 6 use the same adapters over lanes ``LORA_SEL``.
LORA_SLOTS = 4
LORA_RANK = 16
LORA_RANKS = (8, 12, 16)
LORA_SEED = 40
LORA_LANES = (None, "ad0", "ad1", "ad2")
LORA_SEL = (0, 1, 2, 3, 0)
# Phase 4's adoption check: Llama-3-8B's widths cut to ``ADOPT_LAYERS``
# layers, old and new random weights from seeds 20 and 21.
ADOPT_LAYERS = 2


def run_name(kv_layout: str, kv_quantize: str) -> str:
    pool = kv_quantize or "bf16"
    return pool if kv_layout == "paged" else f"slot_{pool}"


def phase4_prompts(torch, vocab: int) -> list[list[int]]:
    """The 8 prompts of phase 4's runs, 64..1024 tokens, from the seed."""
    rng = torch.Generator().manual_seed(SEED)
    lens = torch.randint(64, 1025, (8,), generator=rng).tolist()
    return [torch.randint(0, vocab, (n,), generator=rng).tolist() for n in lens]


def token_agreement(torch, model, prompts, outs, want) -> dict:
    """How a run's greedy tokens compare with another run's on the same
    prompts: the share of requests whose tokens are equal, the index of each
    request's first difference (None: equal), and there the top-2 margin of
    the logits of one whole-sequence forward over the prompt and the other
    run's tokens before it (bf16 runs that round differently flip a near
    tie), with the gap between the two tokens the runs chose and how far
    this run's token lies below the top logit."""
    first = [next((j for j, (a, b) in enumerate(zip(o["tokens"], w["tokens"])) if a != b), None)
             for o, w in zip(outs, want)]
    margins = []
    for p, o, w, j in zip(prompts, outs, want, first):
        if j is None:
            margins.append(None)
            continue
        seq = torch.tensor([p + w["tokens"][:j]], device="cuda")
        logits = model.forward(seq)[0, -1]
        top = logits.topk(2).values
        margins.append({"top2_margin": (top[0] - top[1]).item(),
                        "chosen_gap": (logits[w["tokens"][j]] - logits[o["tokens"][j]]).item(),
                        "chosen_below_top1": (top[0] - logits[o["tokens"][j]]).item(),
                        "top1": top[0].item()})
        del logits
    return {"tokens_equal": sum(j is None for j in first) / len(first), "first_difference": first,
            "margin_at_first_difference": margins}


def lora_specs(cfg) -> list:
    """The smoke run's adapters at the model's widths (``LORA_RANKS``)."""
    from gofr_tpu_torch.adapters import random_adapter

    return [random_adapter(f"ad{i}", cfg.hidden_size, cfg.vocab_size, rank=r, seed=LORA_SEED + i)
            for i, r in enumerate(LORA_RANKS)]


def serve(torch, cuda, model=None, kv_quantize: str = "", kv_layout: str = "paged",
          spec: str | None = None, draft=None, lora: bool = False
          ) -> tuple[object, dict, dict, list]:
    """Serve 8 concurrent greedy requests on a Llama-3-8B engine with the
    cache ``kv_layout`` in the format ``kv_quantize``; a new model with
    random weights from the seed, or ``model`` when given. ``spec`` names a
    run of ``SPEC_RUNS``: speculative decoding, with ``draft`` as its draft
    model if given. With ``lora`` the engine has the adapter plane and the
    requests name ``LORA_LANES`` in turn. Returns (engine, launches,
    metrics, the results)."""
    from gofr_tpu_torch.gpu.engine import build_engine
    from gofr_tpu_torch.models.llama import LlamaConfig
    from gofr_tpu_torch.ops.cuda.flash_attention import flash_attention

    cfg = LlamaConfig.llama3_8b() if model is None else model.cfg
    spec_kw = {} if spec is None else {"spec_tokens": SPEC_G}
    if draft is not None:
        spec_kw["spec_draft"] = (draft.cfg, draft)
    if lora:
        spec_kw.update(adapter_slots=LORA_SLOTS, adapter_rank=LORA_RANK)
    t0 = time.perf_counter()
    eng = build_engine(cfg, params=model, device="cuda", seed=SEED, slots=8, max_len=2048,
                       max_prefill_batch=4, decode_chunk=8, kv_quantize=kv_quantize,
                       kv_layout=kv_layout, **spec_kw)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    warm = eng.generate(list(range(1, 65)), max_new_tokens=2, timeout=600)
    require(warm["finish_reason"] == "length", f"warm-up request: {warm}")
    lanes = [None] * 8
    if lora:
        for spec_ in lora_specs(cfg):
            eng.register_adapter(spec_)
        lanes = [LORA_LANES[i % len(LORA_LANES)] for i in range(8)]

    prompts = phase4_prompts(torch, cfg.vocab_size)
    lens = [len(p) for p in prompts]
    torch.cuda.synchronize()
    before = dict(eng.counters)
    cuda.reset_launch_counts()
    t_submit = time.monotonic()
    reqs = [eng.submit(p, max_new_tokens=64, temperature=0.0, adapter_id=a)
            for p, a in zip(prompts, lanes)]
    outs = [r.result(timeout=900) for r in reqs]
    wait_idle(eng)
    torch.cuda.synchronize()
    t_done = time.monotonic()
    counts, offset_launches = cuda.launch_counts(), flash_attention.offset_launches
    did = {k: v - before[k] for k, v in eng.counters.items()}
    pool = (f"{kv_layout} {kv_quantize or 'bf16'}" + (f" ({spec})" if spec else "")
            + (" (lora)" if lora else ""))
    for i, o in enumerate(outs):
        require(o["finish_reason"] == "length" and len(o["tokens"]) == 64,
                f"{pool} request {i}: {o['finish_reason']}, {len(o['tokens'])} tokens")
        require(all(0 <= t < cfg.vocab_size for t in o["tokens"]),
                f"{pool} request {i}: token out of range")
    on_path = ON_PATH[kv_layout, kv_quantize] if spec is None else ON_PATH_SPEC[spec]
    for name, launches in counts.items():
        if name in on_path:
            require(launches > 0, f"kernel {name} was not launched on the {pool} cache's path")
        else:
            require(launches == 0, f"kernel {name} was launched {launches} times on the {pool} "
                                   f"cache's path")
    per_step = {counts[name] for name in on_path if name not in PREFILL_KERNELS}
    if spec is None:
        require(len(per_step) == 1 and per_step.pop() % cfg.num_layers == 0,
                f"{pool} cache: the decode-step kernels' launches differ or are not whole steps: "
                f"{counts}")
    else:
        # C on verify rows once a layer a round (no prompt here chunks), and
        # the draft's F and G once a layer for each of its g + 1 steps a round
        rounds = did["spec_rounds"]
        require(did["prefill_chunks"] == 0 and rounds > 0 and
                offset_launches == rounds * cfg.num_layers,
                f"{pool}: C launched {offset_launches} times on verify rows for {rounds} rounds")
        if draft is not None:
            require(per_step == {rounds * (SPEC_G + 1) * draft.cfg.num_layers},
                    f"{pool}: the draft's kernels launched {counts} for {rounds} rounds")
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
    if lora:
        stats = eng.adapter_stats()
        require(stats["pool"]["resident"] == len(LORA_RANKS) and stats["pool"]["referenced"] == 0
                and not stats["registry"]["inflight"],
                f"{pool}: the adapter plane after the run: {stats}")
        metrics.update({"adapter_lanes": lanes, "adapter_ranks": list(LORA_RANKS),
                        "adapter_pool": stats["pool"]})
    if spec is not None:
        # one lane-round proposes g tokens and emits acc + 1
        lane_rounds = did["spec_proposed"] / SPEC_G
        metrics.update({
            "spec_tokens": SPEC_G, "draft_layers": draft.cfg.num_layers if draft else None,
            "spec": {k: v for k, v in did.items() if k.startswith("spec_")},
            "verify_launches_of_c": offset_launches,
            "accept_rate": did["spec_accepted"] / did["spec_proposed"],
            "tokens_per_lane_verify": (did["spec_accepted"] + lane_rounds) / lane_rounds,
        })
    return eng, counts, metrics, outs


# Phase 4's admission run: a pool too small for the burst unshared, so the
# prefix cache, chunked prefill and preemption all run. The tails span
# 128..640 and lean to 507..512, the longest that prefill in one chunk, so
# the 8 shared prompts decode at once and outgrow the pool together.
ADMISSION = {"page_size": 128, "total_pages": 40, "prefill_buckets": [128, 256, 512],
             "prefix": 768, "warm_tail": 16, "tails": [128, 640, 512, 511, 510, 509, 508, 507],
             "others": [64, 170, 277, 384]}


def admission_traffic(torch, vocab: int) -> tuple[list, list]:
    """(warm request, burst) of the admission run from the seed: the warm
    prompt is the 768-token system prefix and a tail of 16; the burst is 8
    prompts of that prefix and a distinct tail, then 4 unshared prompts."""
    rng = torch.Generator().manual_seed(SEED + 5)

    def draw(n: int) -> list:
        return torch.randint(0, vocab, (n,), generator=rng).tolist()

    prefix = draw(ADMISSION["prefix"])
    warm = prefix + draw(ADMISSION["warm_tail"])
    burst = [prefix + draw(n) for n in ADMISSION["tails"]] + [draw(n) for n in ADMISSION["others"]]
    return warm, burst


def admission_run(torch, model, warm, **kw) -> object:
    """A new admission engine on ``model`` that has served the warm
    request alone; ``kw`` sizes its pool, buckets and cache."""
    from gofr_tpu_torch.gpu.engine import build_engine

    eng = build_engine(model.cfg, params=model, device="cuda", seed=SEED, slots=8, max_len=2048,
                       max_prefill_batch=4, decode_chunk=8, page_size=ADMISSION["page_size"], **kw)
    out = eng.generate(warm, max_new_tokens=64, timeout=600)
    require(out["finish_reason"] == "length", f"admission warm request: {out['finish_reason']}")
    return eng


def serve_admission(torch, cuda, model) -> dict:
    """Phase 4 ``paged_admission``: the burst on a 40-page bf16 pool through
    the admission the JAX engine runs (EDF planner, chunked prefill, pages on
    demand, preemption by recompute, the prefix cache), the launch counters
    set to 0 just before the burst and read just after; then the same
    traffic unconstrained, for the token-equality share."""
    from gofr_tpu_torch.ops.cuda.flash_attention import flash_attention

    cfg = model.cfg
    warm, burst = admission_traffic(torch, cfg.vocab_size)
    n_shared = len(ADMISSION["tails"])
    eng = admission_run(torch, model, warm, total_pages=ADMISSION["total_pages"],
                        prefill_buckets=ADMISSION["prefill_buckets"])
    before = dict(eng.counters)
    torch.cuda.synchronize()
    cuda.reset_launch_counts()
    t_submit = time.monotonic()
    outs = [r.result(timeout=900) for r in [eng.submit(p, max_new_tokens=64) for p in burst]]
    wait_idle(eng)
    torch.cuda.synchronize()
    t_done = time.monotonic()
    counts, offset_launches = cuda.launch_counts(), flash_attention.offset_launches
    did = {k: v - before[k] for k, v in eng.counters.items()}
    for i, o in enumerate(outs):
        require(o["finish_reason"] == "length" and len(o["tokens"]) == 64,
                f"admission request {i}: {o['finish_reason']}, {len(o['tokens'])} tokens")
        require(all(0 <= t < cfg.vocab_size for t in o["tokens"]),
                f"admission request {i}: token out of range")
        if i < n_shared:
            require(o["prefix_hit_tokens"] >= ADMISSION["prefix"],
                    f"admission request {i}: {o['prefix_hit_tokens']} tokens from the prefix cache")
    require(did["preemptions"] >= 1, f"the admission burst preempted nothing: {did}")
    for name, launches in counts.items():
        if name in ON_PATH["paged", ""]:
            require(launches > 0, f"kernel {name} was not launched on the admission run")
        else:
            require(launches == 0, f"kernel {name} was launched {launches} times on the "
                                   f"admission run")
    require(did["prefill_chunks_at_offset"] >= 1 and
            offset_launches == did["prefill_chunks"] * cfg.num_layers,
            f"flash_attention launched {offset_launches} times on chunked rows for "
            f"{did['prefill_chunks']} chunks ({did['prefill_chunks_at_offset']} at an offset)")
    eng.check_page_refs()
    pool = eng.page_pool_stats()
    require(pool["slot_pages"] == 0 and
            pool["free_pages"] + pool["prefix_pages"] == ADMISSION["total_pages"],
            f"admission pool after the drain: {pool}")
    eng.stop()
    del eng
    torch.cuda.empty_cache()

    # the unconstrained run: no prefix cache, no chunking, the full pool
    free_eng = admission_run(torch, model, warm, prefix_cache=False, prefill_buckets=[2048])
    free_outs = [r.result(timeout=900) for r in [free_eng.submit(p, max_new_tokens=64)
                                                 for p in burst]]
    require(free_eng.counters["preemptions"] == 0 and free_eng.counters["prefill_chunks"] == 0,
            f"the unconstrained run preempted or chunked: {free_eng.counters}")
    free_eng.stop()
    del free_eng
    torch.cuda.empty_cache()

    first = [t_submit + o["ttft_s"] for o in outs]
    done = [f + o["decode_s"] for f, o in zip(first, outs)]
    ttft = sorted(o["ttft_s"] for o in outs)
    return {
        "model": "llama3_8b (random bf16 weights, seed 0)", "layers": cfg.num_layers,
        "kv_layout": "paged", "kv_pool": "bf16", **ADMISSION, "requests": len(outs),
        "prompt_lens": [len(p) for p in burst], "new_tokens": 64,
        "wall_s": t_done - t_submit, "ttft_s": [o["ttft_s"] for o in outs],
        "ttft_p50_s": ttft[len(ttft) // 2], "ttft_max_s": ttft[-1],
        "decode_tok_s": sum(len(o["tokens"]) - 1 for o in outs) / (max(done) - min(first)),
        "preemptions": did["preemptions"],
        "preemptions_by_request": [o["preemptions"] for o in outs],
        "prefix_hit_tokens": did["prefix_hit_tokens"],
        "prefix_hit_tokens_by_request": [o["prefix_hit_tokens"] for o in outs],
        "prefix_evicted_pages": did["prefix_evicted_pages"],
        "prefill_chunks": did["prefill_chunks"],
        "chunk_launches_at_offset": did["prefill_chunks_at_offset"] * cfg.num_layers,
        "flash_offset_launches": offset_launches, "launches": counts, "pool_after": pool,
        # against the unconstrained run: the equal share, per request the
        # index of the first token that differs (None: equal) and the margin
        **{f"{k}_unconstrained" if k == "tokens_equal" else k: v
           for k, v in token_agreement(torch, model, burst, outs, free_outs).items()},
        "note": "smoke run, not a benchmark",
    }


def serve_spec(torch, cuda, model, results: dict) -> dict:
    """Phase 4's speculative runs (``SPEC_RUNS``), each held to its
    ``ON_PATH_SPEC`` and compared with the plain run on its cache: the
    equal share and the margins at the first differences are printed, the
    share not held (C over a dense view rounds otherwise than the decode
    kernels); at each first difference the spec run's token must lie within
    ``SPEC_TIE_GAP`` of the top logit. On the first, one request is also
    streamed: its ids, joined, must equal that request's own result."""
    from gofr_tpu_torch.models.llama import LlamaConfig, init

    prompts = phase4_prompts(torch, model.cfg.vocab_size)
    out = {}
    for name, (kv_layout, kv_quantize) in SPEC_RUNS.items():
        draft = None
        if name == "slot_spec_draft":
            draft = init(LlamaConfig.llama3_8b(num_layers=DRAFT_LAYERS),
                         torch.Generator(device="cuda").manual_seed(SEED + 1), "cuda")
        eng, counts, metrics, outs = serve(torch, cuda, model, kv_quantize, kv_layout, spec=name,
                                           draft=draft)
        if name == "paged_spec":
            prompt = prompts[0][:128]
            it = eng.generate(prompt, max_new_tokens=32, timeout=600, stream=True)
            streamed = list(it)
            whole = it.result()["tokens"]
            require(streamed == whole and len(whole) == 32,
                    f"{name}: the streamed ids {streamed} differ from the result {whole}")
            metrics["stream"] = {"prompt_len": len(prompt), "tokens": len(whole),
                                 "equal_to_result": True}
        eng.stop()
        del eng, draft
        torch.cuda.empty_cache()
        metrics.update(token_agreement(torch, model, prompts, outs, results[kv_layout, kv_quantize]))
        metrics["compared_with"] = run_name(kv_layout, kv_quantize)
        emit(f"phase4_serve_{name}", {**metrics, "launches": counts})
        gaps = [m["chosen_below_top1"] for m in metrics["margin_at_first_difference"] if m]
        require(all(gap <= SPEC_TIE_GAP for gap in gaps),
                f"{name}: at a first difference from the plain run the spec run chose a token "
                f"{gaps} below the top logit (limit {SPEC_TIE_GAP})")
        out[name] = {"metrics": metrics, "launches": counts}
    return out


def serve_lora(torch, cuda, model, base: dict, base_outs: list) -> dict:
    """Phase 4 ``paged_lora``: ``bf16``'s traffic with the requests on
    ``LORA_LANES`` in turn, held as ``serve`` holds a run (the ``bf16`` run's
    kernels, 64 tokens a request), to its adapter pool at the end (3
    resident, none referenced), and to every adapter request's tokens
    differing from the ``bf16`` run's on the same prompt (the adapters move
    the logits far past bf16 ties, so a lane routed to the wrong slot shows).
    Printed beside the ``bf16`` run of the same call: the share of base
    requests whose tokens equal it, and tok/s."""
    eng, counts, metrics, outs = serve(torch, cuda, model, lora=True)
    eng.stop()
    del eng
    torch.cuda.empty_cache()
    lanes = metrics["adapter_lanes"]
    same = [o["tokens"] == w["tokens"] for o, w in zip(outs, base_outs)]
    on_base = [eq for eq, a in zip(same, lanes) if a is None]
    on_adapters = [eq for eq, a in zip(same, lanes) if a is not None]
    metrics.update({
        "base_tokens_equal_bf16": sum(on_base) / len(on_base),
        "adapter_tokens_differ_from_bf16": sum(not eq for eq in on_adapters) / len(on_adapters),
        "bf16_decode_tok_s": base["decode_tok_s"], "bf16_output_tok_s": base["output_tok_s"],
    })
    require(metrics["adapter_tokens_differ_from_bf16"] == 1.0,
            f"paged_lora: only {metrics['adapter_tokens_differ_from_bf16']} of the adapter "
            f"requests differ from the bf16 run's tokens on the same prompt, so some lane "
            f"was not routed to its adapter")
    return {"metrics": metrics, "launches": counts}


def adopt_check(torch, cuda) -> dict:
    """Phase 4's adoption check: a bf16-pool engine on Llama-3-8B's widths
    cut to ``ADOPT_LAYERS`` layers, random weights from seed 20, takes new
    random weights (seed 21) by ``adopt_weights`` while 4 requests decode.
    Held: all 4 end with 64 tokens, each preempted once and recomputed,
    ``weights_epoch`` is 1, and a request after the swap equals, token for
    token, the same request on an engine built on the new weights."""
    from gofr_tpu_torch.gpu.engine import build_engine
    from gofr_tpu_torch.models.llama import LlamaConfig, init

    cfg = LlamaConfig.llama3_8b(num_layers=ADOPT_LAYERS)
    old, new = (init(cfg, torch.Generator(device="cuda").manual_seed(SEED + s), "cuda")
                for s in (20, 21))
    knobs = dict(device="cuda", seed=SEED, slots=8, max_len=2048, max_prefill_batch=4,
                 decode_chunk=8)
    prompts = phase4_prompts(torch, cfg.vocab_size)
    eng = build_engine(cfg, params=old, **knobs)
    reqs = [eng.submit(p, max_new_tokens=64) for p in prompts[:4]]
    deadline = time.monotonic() + 300
    while sum(s is not None and bool(s.generated) for s in eng.slots) < 4:
        require(time.monotonic() < deadline, "adoption: the 4 requests never all decoded")
        time.sleep(0.001)
    t0 = time.perf_counter()
    epoch = eng.adopt_weights(new, timeout_s=300)
    swap_s = time.perf_counter() - t0
    outs = [r.result(timeout=600) for r in reqs]
    require(all(o["finish_reason"] == "length" and len(o["tokens"]) == 64 for o in outs),
            f"adoption: a request in flight did not complete: {[o['finish_reason'] for o in outs]}")
    require(epoch == eng.weights_epoch == 1, f"adoption: weights epoch {eng.weights_epoch}")
    require([o["preemptions"] for o in outs] == [1] * 4,
            f"adoption: preemptions {[o['preemptions'] for o in outs]}")
    after = eng.generate(prompts[4], max_new_tokens=32, timeout=600)["tokens"]
    eng.check_page_refs()
    eng.stop()
    fresh = build_engine(cfg, params=new, **knobs)
    want = fresh.generate(prompts[4], max_new_tokens=32, timeout=600)["tokens"]
    fresh.stop()
    del eng, fresh, old, new
    torch.cuda.empty_cache()
    require(after == want, f"adoption: tokens after the swap {after} differ from an engine built "
                           f"on the new weights {want}")
    return {"layers": ADOPT_LAYERS, "requests_in_flight": 4, "weights_epoch": epoch,
            "adopt_s": swap_s, "preemptions": [o["preemptions"] for o in outs],
            "after_swap_equals_new_engine": True, "tokens_compared": len(want)}


# Phase 4's ``paged_pipeline``: ``pipeline_depth`` 1 against 2 (the default)
# on the bf16 pool, one engine per arm on the phase's model, in turns
# ``DEPTHS``. 16 prompts of 64..1024 tokens from the seed, 64 greedy tokens
# each, go in 4 waves of 4, each wave submitted once the previous wave's
# first tokens are out, so its prefill lands while those lanes decode (the
# requests stream, and the wait blocks on each one's first token: a loop
# polling for it would take the interpreter lock from the engine's thread
# every time it wakes). After the timed waves each arm
# repeats a wave pair under ``torch.profiler``: the device's busy time over
# the second wave, from its submit to its first tokens (the profiler's
# stop and event processing hold the interpreter lock for seconds, so they
# come after the timed part).
PIPELINE = {"requests": 16, "waves": 4, "new_tokens": 64}
DEPTHS = (1, 2, 2, 1)


def wait_idle(eng, timeout: float = 120.0) -> dict:
    """Wait until the engine has folded every call it dispatched (a
    speculative round can go out for a lane that an older round's fold then
    ends, and its launches are counted); returns ``pipeline_stats()``."""
    deadline = time.monotonic() + timeout
    while True:
        st = eng.pipeline_stats()
        if st["folds"] == sum(st["dispatched"].values()):
            return st
        require(time.monotonic() < deadline, f"calls still in flight after the requests: {st}")
        time.sleep(0.001)


def pipeline_prompts(torch, vocab: int) -> list[list[int]]:
    """The timed waves' prompts, then two more waves' for the profiled
    pair (new prompts: the timed ones sit in the prefix cache)."""
    n = PIPELINE["requests"] + 2 * PIPELINE["requests"] // PIPELINE["waves"]
    rng = torch.Generator().manual_seed(SEED + 6)
    lens = torch.randint(64, 1025, (n,), generator=rng).tolist()
    return [torch.randint(0, vocab, (k,), generator=rng).tolist() for k in lens]


def submit_wave(eng, prompts: list) -> list:
    """Submit a wave of streamed requests and block until each has its
    first token (its first streamed id)."""
    wave = [eng.submit(p, max_new_tokens=PIPELINE["new_tokens"], stream=True) for p in prompts]
    for r in wave:
        require(r.stream_q.get(timeout=600) is not None, "a wave's request ended before a token")
    return wave


def profiled_wave(torch, eng, prompts: list) -> dict:
    """Two waves after the timed ones, the second under torch.profiler:
    the device's busy ms (kernels and copies) over the second wave's
    window, its submit to its first tokens, and the idle share."""
    from torch.profiler import ProfilerActivity, profile

    per = PIPELINE["requests"] // PIPELINE["waves"]
    first = submit_wave(eng, prompts[:per])
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        second = submit_wave(eng, prompts[per:2 * per])
        # the trace closes once the card has run what was launched in the
        # window, so the window ends there too
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    for r in first + second:
        r.result(timeout=900)
    busy_ms = sum(e.device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    # the profiler does not always see the kernels the engine's thread
    # launches (one arm in a few traced nothing); such a trace measures
    # nothing
    seen = busy_ms >= 0.01 * window_s * 1e3
    return {"profiled_wave_s": window_s, "profiled_wave_device_busy_ms": busy_ms,
            "profiled_wave_device_idle_share": 1.0 - busy_ms / (window_s * 1e3) if seen else None}


def pipeline_arm(torch, cuda, model, depth: int, prompts: list) -> tuple[list, dict, dict]:
    """One arm of ``paged_pipeline``: (results, metrics, launches)."""
    from gofr_tpu_torch.gpu.engine import build_engine

    eng = build_engine(model.cfg, params=model, device="cuda", seed=SEED, slots=8, max_len=2048,
                       max_prefill_batch=4, decode_chunk=8, pipeline_depth=depth)
    warm = eng.generate(list(range(1, 65)), max_new_tokens=2, timeout=600)
    require(warm["finish_reason"] == "length", f"pipeline depth {depth} warm-up: {warm}")
    before = wait_idle(eng)
    torch.cuda.synchronize()
    cuda.reset_launch_counts()
    per = PIPELINE["requests"] // PIPELINE["waves"]
    reqs = []
    t_submit = time.monotonic()
    for w in range(PIPELINE["waves"]):
        reqs += submit_wave(eng, prompts[w * per:(w + 1) * per])
    outs = [r.result(timeout=900) for r in reqs]
    st = wait_idle(eng)
    torch.cuda.synchronize()
    t_done = time.monotonic()
    counts = cuda.launch_counts()
    profiled = profiled_wave(torch, eng, prompts[PIPELINE["requests"]:])
    eng.stop()
    del eng
    torch.cuda.empty_cache()
    for i, o in enumerate(outs):
        require(o["finish_reason"] == "length" and len(o["tokens"]) == PIPELINE["new_tokens"],
                f"pipeline depth {depth} request {i}: {o['finish_reason']}, "
                f"{len(o['tokens'])} tokens")
    for name, launches in counts.items():
        if name in ON_PATH["paged", ""]:
            require(launches > 0, f"kernel {name} was not launched at pipeline depth {depth}")
        else:
            require(launches == 0, f"kernel {name} was launched {launches} times at pipeline "
                                   f"depth {depth}")
    # a turn leaves at most depth - 1 calls in flight while the host plans
    # the next; within a turn the queue also takes that turn's dispatches
    require(st["dq_carried_max"] == depth - 1 and (depth == 1 or st["dq_max"] >= depth),
            f"pipeline depth {depth}: the queue carried {st['dq_carried_max']} calls across a "
            f"turn at most, held {st['dq_max']} at most")
    turns = st["busy_turns"] - before["busy_turns"]
    folds = st["folds"] - before["folds"]
    first = [t_submit + o["ttft_s"] for o in outs]
    done = [f + o["decode_s"] for f, o in zip(first, outs)]
    ttft = sorted(o["ttft_s"] for o in outs)
    return outs, {
        "pipeline_depth": depth, "requests": len(outs), "waves": PIPELINE["waves"],
        "new_tokens": PIPELINE["new_tokens"], "wall_s": t_done - t_submit,
        "output_tok_s": sum(len(o["tokens"]) for o in outs) / (t_done - t_submit),
        "decode_tok_s": sum(len(o["tokens"]) - 1 for o in outs) / (max(done) - min(first)),
        "ttft_p50_s": ttft[len(ttft) // 2], "ttft_max_s": ttft[-1],
        "host_ms_per_turn": (st["busy_turn_s"] - before["busy_turn_s"]) / turns * 1e3,
        "turns": turns, "folds": folds,
        "fold_wait_ms": (st["fold_wait_s"] - before["fold_wait_s"]) * 1e3,
        "fold_wait_ms_per_fold": (st["fold_wait_s"] - before["fold_wait_s"]) / folds * 1e3,
        "dq_max": st["dq_max"], "dq_carried_max": st["dq_carried_max"],
        "dispatched": {k: v - before["dispatched"].get(k, 0) for k, v in st["dispatched"].items()},
        **profiled,
    }, counts


def serve_pipeline(torch, cuda, model) -> dict:
    """Phase 4 ``paged_pipeline``: the arms in turns ``DEPTHS``; every arm's
    tokens against the first depth-1 arm's by the tie rule. Nothing about
    speed is held."""
    prompts = pipeline_prompts(torch, model.cfg.vocab_size)
    timed = prompts[:PIPELINE["requests"]]
    arms, base = [], None
    for depth in DEPTHS:
        outs, metrics, counts = pipeline_arm(torch, cuda, model, depth, prompts)
        if base is None:
            base = outs
        else:
            agree = token_agreement(torch, model, timed, outs, base)
            gaps = [m["chosen_below_top1"] for m in agree["margin_at_first_difference"] if m]
            require(all(gap <= SPEC_TIE_GAP for gap in gaps),
                    f"paged_pipeline depth {depth}: at a first difference from depth 1 the run "
                    f"chose a token {gaps} below the top logit (limit {SPEC_TIE_GAP})")
            metrics.update(agree)
        arms.append({**metrics, "launches": counts})
    return {"model": "llama3_8b (random bf16 weights, seed 0)", "layers": model.cfg.num_layers,
            "kv_layout": "paged", "kv_pool": "bf16", "prompt_lens": [len(p) for p in timed],
            "order": list(DEPTHS), "arms": arms, "nvidia_smi": smi_line(),
            "note": "an A/B in one call, not a benchmark; nothing about speed is held"}


# Phase 4's ``paged_prefix_host``: ``paged_admission``'s warm request and burst
# on its 40-page pool with a host tier of ``prefix_host_mb`` (the
# ENGINE_PREFIX_HOST_MB knob; 512 MiB holds 32 of Llama-3-8B's 16 MiB bf16
# pages, the shared prefix's 6 five times over), then a pressure burst that
# needs the whole pool (4 prompts of 1025 tokens, 8 full pages, 200 new
# tokens: 10 pages a request), which spills every page the cache holds,
# and leaves 2 pages a request free when it ends; then the 8 shared prompts
# again. The same traffic with the host tier off is the comparison.
HOST_TIER = {"prefix_host_mb": 512, "pressure_prompt": 1025, "pressure_requests": 4,
             "pressure_new": 200}
# The card's host link, where nvidia-smi reports none: PCIe Gen5 x16 (H100
# SXM data sheet), 32 GT/s a lane, 128b/130b, one direction.
PCIE5_X16_BYTES_PER_S = 32e9 * 16 * 128 / 130 / 8


def host_link_gb_s() -> tuple[float, str]:
    """The host link's raw rate in GB/s, one direction, at the generation
    and width nvidia-smi reports (``pcie.link.gen.max``,
    ``pcie.link.width.max``), and where it came from; the data sheet's
    Gen5 x16 where nvidia-smi answers N/A."""
    line = subprocess.run(["nvidia-smi", "--query-gpu=pcie.link.gen.max,pcie.link.width.max",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    try:
        gen, width = (int(x) for x in line.split(","))
    except ValueError:
        return PCIE5_X16_BYTES_PER_S / 1e9, f"nvidia-smi: {line}; H100 SXM data sheet: Gen5 x16"
    gt_s = {1: 2.5, 2: 5.0, 3: 8.0, 4: 16.0, 5: 32.0}[gen]
    return gt_s * width * (0.8 if gen < 3 else 128 / 130) / 8, f"nvidia-smi: {line}"


def prefix_host_run(torch, model, host_mb: float) -> dict:
    """The three bursts on one admission engine with a host tier of
    ``host_mb`` MiB (0: off); the pool audit after each."""
    cfg = model.cfg
    warm, burst = admission_traffic(torch, cfg.vocab_size)
    rng = torch.Generator().manual_seed(SEED + 7)
    pressure = [torch.randint(0, cfg.vocab_size, (HOST_TIER["pressure_prompt"],),
                              generator=rng).tolist()
                for _ in range(HOST_TIER["pressure_requests"])]
    second = burst[:len(ADMISSION["tails"])]
    eng = admission_run(torch, model, warm, total_pages=ADMISSION["total_pages"],
                        prefill_buckets=ADMISSION["prefill_buckets"], prefix_host_mb=host_mb)
    outs, counters, pools = {}, {}, {}
    for name, prompts, n_new in (("burst", burst, 64),
                                 ("pressure", pressure, HOST_TIER["pressure_new"]),
                                 ("second", second, 64)):
        before = dict(eng.counters)
        t0 = time.monotonic()
        outs[name] = [r.result(timeout=900)
                      for r in [eng.submit(p, max_new_tokens=n_new) for p in prompts]]
        wait_idle(eng)
        torch.cuda.synchronize()
        counters[name] = {k: v - before[k] for k, v in eng.counters.items()}
        counters[name]["wall_s"] = time.monotonic() - t0
        eng.check_page_refs()
        pools[name] = eng.page_pool_stats()
        for i, o in enumerate(outs[name]):
            require(o["finish_reason"] == "length" and len(o["tokens"]) == n_new,
                    f"prefix_host ({host_mb} MiB) {name} request {i}: {o['finish_reason']}")
    stats = eng.pipeline_stats()
    eng.stop()
    del eng
    torch.cuda.empty_cache()
    return {"outs": outs, "counters": counters, "pools": pools, "stats": stats,
            "prompts": {"burst": burst, "pressure": pressure, "second": second}}


def serve_prefix_host(torch, cuda, model) -> dict:
    """Phase 4 ``paged_prefix_host``: the traffic with the host tier on,
    then off, the launch counters over both. Held: the pressure spilled
    pages; the second wave swapped pages in, served the shared 768-token
    prefix to each of its prompts from the cache and at least those 6 pages
    from the host tier (its first prompt swaps them in; the others share
    the swapped pages); every run's tokens against the host-tier-off run's
    by the tie rule; the pool and tier audit after each burst; the bf16
    pool's kernels and no other. Printed: the swap-ins' pages, bytes, time
    on the card and GB/s beside the host link's raw rate."""
    cuda.reset_launch_counts()
    on = prefix_host_run(torch, model, HOST_TIER["prefix_host_mb"])
    off = prefix_host_run(torch, model, 0.0)
    counts = cuda.launch_counts()
    prefix = ADMISSION["prefix"]
    spilled = on["counters"]["pressure"]["prefix_spilled_pages"]
    wave = on["counters"]["second"]
    require(spilled > 0, f"paged_prefix_host: the pressure spilled nothing: {on['counters']}")
    require(wave["prefix_swapin_pages"] > 0 and wave["prefix_host_hit_tokens"] >= prefix
            and all(o["prefix_hit_tokens"] >= prefix for o in on["outs"]["second"]),
            f"paged_prefix_host: the second wave's hits {[o['prefix_hit_tokens'] for o in on['outs']['second']]}, "
            f"host {[o['prefix_host_tokens'] for o in on['outs']['second']]}: {wave}")
    for name, launches in counts.items():
        if name in ON_PATH["paged", ""]:
            require(launches > 0, f"kernel {name} was not launched on the prefix_host runs")
        else:
            require(launches == 0, f"kernel {name} was launched {launches} times on the "
                                   f"prefix_host runs")
    agree = {}
    for name in ("burst", "pressure", "second"):
        agree[name] = token_agreement(torch, model, on["prompts"][name], on["outs"][name],
                                      off["outs"][name])
        gaps = [m["chosen_below_top1"] for m in agree[name]["margin_at_first_difference"] if m]
        require(all(gap <= SPEC_TIE_GAP for gap in gaps),
                f"paged_prefix_host {name}: at a first difference from the host-tier-off run "
                f"the run chose a token {gaps} below the top logit (limit {SPEC_TIE_GAP})")
    swap_s = on["stats"]["swapin_s"]
    nbytes = sum(c["prefix_swapin_bytes"] for c in on["counters"].values())
    link, link_line = host_link_gb_s()
    second_ttft = {arm: sorted(o["ttft_s"] for o in run["outs"]["second"])
                   for arm, run in (("host_tier", on), ("off", off))}
    return {
        "model": "llama3_8b (random bf16 weights, seed 0)", "layers": model.cfg.num_layers,
        "kv_pool": "bf16", **HOST_TIER, "total_pages": ADMISSION["total_pages"],
        "counters": on["counters"], "counters_host_tier_off": off["counters"],
        "pool_after": on["pools"], "host_pages_after": on["pools"]["second"]["prefix_host_pages"],
        "second_wave_hit_tokens": [o["prefix_hit_tokens"] for o in on["outs"]["second"]],
        "second_wave_host_tokens": [o["prefix_host_tokens"] for o in on["outs"]["second"]],
        "second_wave_ttft_p50_s": {k: v[len(v) // 2] for k, v in second_ttft.items()},
        "second_wave_ttft_max_s": {k: v[-1] for k, v in second_ttft.items()},
        "swapin_pages": sum(c["prefix_swapin_pages"] for c in on["counters"].values()),
        "swapin_bytes": nbytes, "swapin_ms": swap_s * 1e3,
        "swapin_gb_s": nbytes / swap_s / 1e9 if swap_s else None,
        "swapin_share_of_host_link": nbytes / swap_s / 1e9 / link if swap_s else None,
        "host_link_gb_s": link, "host_link_source": link_line,
        "tokens_equal_host_tier_off": {k: v["tokens_equal"] for k, v in agree.items()},
        "first_difference": {k: v["first_difference"] for k, v in agree.items()},
        "launches": counts, "nvidia_smi": smi_line(),
        "note": "smoke run, not a benchmark",
    }


# Phase 4's ``http_generate``: the bf16 run's traffic over localhost through
# the port's App, the engine built from a ModelSpec and this config, as an
# operator builds it (random weights from the seed: the phase's model).
HTTP_CONFIG = {"HTTP_PORT": "0", "METRICS_PORT": "0", "ENGINE_SLOTS": "8",
               "ENGINE_MAX_LEN": "2048", "ENGINE_PREFILL_BATCH": "4",
               "ENGINE_DECODE_CHUNK": "8", "ENGINE_KV_DTYPE": "bf16", "LOG_LEVEL": "ERROR"}
HTTP_STREAMS = 2


def http_call(port: int, method: str, path: str, body: dict | None = None
              ) -> tuple[int, dict, float, float]:
    """One request on its own connection: (status, JSON body, client
    seconds, the monotonic time it started)."""
    import http.client

    t0 = time.monotonic()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=900)
    try:
        conn.request(method, path, body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = json.loads(resp.read())
        return resp.status, data, time.monotonic() - t0, t0
    finally:
        conn.close()


def http_stream(port: int, body: dict) -> dict:
    """One ``POST /generate/stream``: the frames as (event, data), the
    seconds to the first data frame and to the end, at the client."""
    import http.client

    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=900)
    try:
        conn.request("POST", "/generate/stream", body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        require(resp.status == 200 and resp.getheader("Content-Length") is None
                and resp.getheader("Content-Type") == "text/event-stream",
                f"http_generate stream: {resp.status} {resp.getheaders()}")
        frames, event, first = [], None, None
        while line := resp.readline():
            line = line.decode().rstrip("\n")
            if line.startswith("event: "):
                event = line[len("event: "):]
            elif line.startswith("data: "):
                if first is None:
                    first = time.perf_counter() - t0
                frames.append((event, json.loads(line[len("data: "):])))
        return {"frames": frames, "first_event_s": first, "wall_s": time.perf_counter() - t0}
    finally:
        conn.close()


def http_generate(torch, cuda, model, base: dict, base_outs: list) -> dict:
    """Phase 4 ``http_generate``: the port's App on localhost, its engine
    built by ``serve_model("lm", ModelSpec(llama3_8b, bf16), seed=0)`` from
    ``HTTP_CONFIG``. Held: alive and health (``model:lm`` UP); the 8 prompts
    as 8 concurrent ``POST /generate``, each 201 with 64 tokens ended by
    length, compared with the ``bf16`` run by ``token_agreement`` (at a
    first difference the token within ``SPEC_TIE_GAP`` of the top logit:
    HTTP arrival can batch otherwise); two prompts streamed, ``token``
    frames then ``done``, their ids held against the same prompt's unary
    result by the same rule; a 0.001 s timeout is a 408 and an unknown path
    a 404, each with the error envelope; ``app_http_response`` counts >= 10
    for ``POST /generate``; the launch counters, zeroed after the warm-up,
    show the ``bf16`` run's kernels and no other; after ``stop`` the
    engine's thread has ended. Printed, not held: per request the client
    wall time, the engine's ttft and decode seconds and the HTTP overhead
    (wall less both), the part before the submit split at the server's
    times (accepted, read, handler entered, body bound) and as a share of
    the TTFT the client sees, the SSE first event against the engine's
    ttft, and decode tok/s beside ``bf16``'s."""
    import asyncio
    import threading

    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.config import DictConfig
    from gofr_tpu_torch.models import ModelSpec
    from gofr_tpu_torch.models.llama import LlamaConfig

    app = App(config=DictConfig(HTTP_CONFIG))
    t0 = time.perf_counter()
    engine = app.serve_model("lm", ModelSpec("llama", LlamaConfig.llama3_8b(), dtype=torch.bfloat16),
                             seed=SEED, eos_token_id=-1)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    submitted, submit = [], engine.submit

    def record(*a, **kw):
        submitted.append(submit(*a, **kw))
        return submitted[-1]

    engine.submit = record
    server_stamps: dict[tuple, tuple] = {}

    async def generate(ctx):
        t_handler = time.monotonic()
        body = ctx.bind(dict)
        stamps = ctx.request.context()
        server_stamps[tuple(body["prompt"])] = (stamps["accepted_at"], stamps["read_at"], t_handler,
                                                time.monotonic())
        return await ctx.agenerate("lm", body["prompt"], max_new_tokens=int(body["max_new_tokens"]),
                                   timeout=body.get("timeout", 900))

    def generate_stream(ctx):
        from gofr_tpu_torch.http.streaming import StreamingResponse

        body = ctx.bind(dict)
        return StreamingResponse(ctx.generate("lm", body["prompt"],
                                              max_new_tokens=int(body["max_new_tokens"]),
                                              timeout=900, stream=True), event="token")

    app.post("/generate", generate)
    app.post("/generate/stream", generate_stream)
    loop, ready, failed = asyncio.new_event_loop(), threading.Event(), []

    def run() -> None:
        async def main() -> None:
            started = asyncio.Event()
            task = asyncio.ensure_future(app.arun(ready=started))
            await started.wait()
            ready.set()
            await task

        try:
            loop.run_until_complete(main())
        except BaseException as e:  # noqa: BLE001 - reported by the caller
            failed.append(e)
            ready.set()
        finally:
            loop.close()

    server = threading.Thread(target=run, name="http-generate", daemon=True)
    server.start()
    require(ready.wait(120) and not failed, f"http_generate: the App did not start: {failed}")
    port = app.http_port
    try:
        status, alive, *_ = http_call(port, "GET", "/.well-known/alive")
        require(status == 200 and alive == {"data": {"status": "UP"}}, f"alive: {status} {alive}")
        status, health, *_ = http_call(port, "GET", "/.well-known/health")
        require(status == 200 and health["data"]["services"]["model:lm"]["status"] == "UP",
                f"health: {status} {health}")
        status, warm, *_ = http_call(port, "POST", "/generate",
                                    {"prompt": list(range(1, 65)), "max_new_tokens": 2})
        require(status == 201 and warm["data"]["finish_reason"] == "length",
                f"http warm-up: {status} {warm}")
        prompts = phase4_prompts(torch, model.cfg.vocab_size)
        torch.cuda.synchronize()
        cuda.reset_launch_counts()
        del submitted[:]
        replies = [None] * len(prompts)

        def one(i: int) -> None:
            replies[i] = http_call(port, "POST", "/generate",
                                   {"prompt": prompts[i], "max_new_tokens": 64})

        t_submit = time.monotonic()
        threads = [threading.Thread(target=one, args=(i,)) for i in range(len(prompts))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(900)
        t_done = time.monotonic()
        reqs = list(submitted)
        stamps = [server_stamps[tuple(p)] for p in prompts]
        for i, r in enumerate(replies):
            require(r is not None and r[0] == 201, f"http request {i}: {r and r[:2]}")
            o = r[1]["data"]
            require(o["finish_reason"] == "length" and len(o["tokens"]) == 64,
                    f"http request {i}: {o['finish_reason']}, {len(o['tokens'])} tokens")
        outs = [r[1]["data"] for r in replies]
        streams = [http_stream(port, {"prompt": prompts[i], "max_new_tokens": 64})
                   for i in range(HTTP_STREAMS)]
        stream_reqs = submitted[len(reqs):]
        status, late, *_ = http_call(port, "POST", "/generate",
                                    {"prompt": prompts[0], "max_new_tokens": 64, "timeout": 0.001})
        require(status == 408 and late == {"error": {"message": "request timed out"}},
                f"a 0.001 s timeout: {status} {late}")
        status, lost, *_ = http_call(port, "GET", "/no/such/route")
        require(status == 404 and lost == {"error": {"message": "route not registered"}},
                f"an unknown path: {status} {lost}")
        torch.cuda.synchronize()
        counts = cuda.launch_counts()
        import urllib.request

        with urllib.request.urlopen(f"http://127.0.0.1:{app.metrics_port}/metrics",
                                    timeout=60) as r:
            exposition = r.read().decode()
        posts = sum(float(line.rsplit(" ", 1)[1]) for line in exposition.splitlines()
                    if line.startswith("app_http_response_count{")
                    and 'method="POST"' in line and 'path="/generate"' in line)
        require(posts >= 10, f"app_http_response counts {posts} POST /generate")
    finally:
        loop.call_soon_threadsafe(app.stop)
        server.join(120)
    require(not server.is_alive() and not engine._thread.is_alive(),
            "http_generate: the server or the engine's thread outlived stop()")
    require(not failed, f"http_generate: the App failed: {failed}")
    for name, launches in counts.items():
        if name in ON_PATH["paged", ""]:
            require(launches > 0, f"kernel {name} was not launched on the http_generate run")
        else:
            require(launches == 0, f"kernel {name} was launched {launches} times on the "
                                   f"http_generate run")
    agreement_ = token_agreement(torch, model, prompts, outs, base_outs)
    gaps = [m["chosen_below_top1"] for m in agreement_["margin_at_first_difference"] if m]
    require(all(gap <= SPEC_TIE_GAP for gap in gaps),
            f"http_generate: at a first difference from the bf16 run the token lies {gaps} below "
            f"the top logit (limit {SPEC_TIE_GAP})")
    stream_outs, first_event = [], []
    for s, req in zip(streams, stream_reqs):
        frames = s["frames"]
        require(len(frames) == 65 and frames[-1] == ("done", {})
                and all(e == "token" and isinstance(d, int) for e, d in frames[:-1]),
                f"http stream: {len(frames)} frames, last {frames[-1:]}")
        result = req.outcome()[0]
        stream_outs.append({"tokens": [d for _, d in frames[:-1]]})
        first_event.append({"client_first_event_s": s["first_event_s"], "engine_ttft_s":
                            result["ttft_s"], "gap_s": s["first_event_s"] - result["ttft_s"],
                            "client_wall_s": s["wall_s"]})
    stream_agreement = token_agreement(torch, model, prompts[:HTTP_STREAMS], stream_outs,
                                       outs[:HTTP_STREAMS])
    gaps = [m["chosen_below_top1"] for m in stream_agreement["margin_at_first_difference"] if m]
    require(all(gap <= SPEC_TIE_GAP for gap in gaps),
            f"http_generate: a streamed request's first difference from its unary result lies "
            f"{gaps} below the top logit (limit {SPEC_TIE_GAP})")
    walls = [r[2] for r in replies]
    overhead = sorted(w - (o["ttft_s"] + o["decode_s"]) for w, o in zip(walls, outs))
    # the overhead's two halves: client start to the engine's submit, and
    # the engine's finish to the client's last byte
    reqs = [next(q for q in reqs if q.inputs == p) for p in prompts]
    to_submit = [q.enqueued_at - r[3] for q, r in zip(reqs, replies)]
    # the part before the submit, broken down at the server's own times:
    # the client's start, the connection accepted, the request read, the
    # handler entered, the body bound, the engine's submit
    marks = [(r[3], *s, q.enqueued_at) for r, s, q in zip(replies, stamps, reqs)]
    spans = {name: [m[i + 1] - m[i] for m in marks] for i, name in enumerate(
        ("client_to_accept_s", "accept_to_read_s", "read_to_handler_s", "handler_to_bind_s",
         "bind_to_submit_s"))}
    # each client thread's start after the first's: a span that falls as
    # this rises ends at one moment for all
    client_start = [r[3] - min(q[3] for q in replies) for r in replies]
    # the user's TTFT is the client's start to the first token
    pre_submit_share = [t / (t + o["ttft_s"]) for t, o in zip(to_submit, outs)]
    after_finish = [r[3] + r[2] - (q.enqueued_at + o["ttft_s"] + o["decode_s"])
                    for q, r, o in zip(reqs, replies, outs)]
    first = [req.enqueued_at + o["ttft_s"] for req, o in zip(reqs, outs)]
    done = [f + o["decode_s"] for f, o in zip(first, outs)]
    decode_tok_s = sum(len(o["tokens"]) - 1 for o in outs) / (max(done) - min(first))
    del engine, app
    torch.cuda.empty_cache()
    return {
        "model": "llama3_8b (random bf16 weights, seed 0)", "config": HTTP_CONFIG,
        "engine_build_s": build_s, "requests": len(outs), "new_tokens": 64,
        "client_wall_s": walls, "ttft_s": [o["ttft_s"] for o in outs],
        "decode_s": [o["decode_s"] for o in outs],
        "http_overhead_p50_s": overhead[len(overhead) // 2], "http_overhead_max_s": overhead[-1],
        "client_to_submit_s": to_submit, "client_start_s": client_start,
        "pre_submit_spans": spans,
        "pre_submit_share_of_ttft": pre_submit_share, "finish_to_client_s": after_finish,
        "sse_first_event": first_event, "wall_s": t_done - t_submit,
        "decode_tok_s": decode_tok_s, "bf16_decode_tok_s": base["decode_tok_s"],
        "decode_tok_s_vs_bf16": decode_tok_s / base["decode_tok_s"],
        **agreement_, "compared_with": "bf16",
        "stream_tokens_equal_unary": stream_agreement["tokens_equal"],
        "metrics_post_generate": posts, "launches": counts, "nvidia_smi": smi_line(),
        "note": "smoke run, not a benchmark",
    }


def lora_check(torch, model, kv_layout: str, kv_quantize: str) -> dict:
    """Phase 5's adapter holds on one cache: 5 lanes of 128-token prompts
    prefilled together, then one ``decode_step`` and one ``verify_step`` of
    5 tokens with the lanes on ``LORA_SEL`` (base, ad0, ad1, ad2, base),
    each on its own copy of the cache: with the kernels and no adapters,
    with the kernels and the adapters, and with the plain versions and the
    adapters. The base lanes' logits must be bit-identical with and without
    the adapters, and the adapter lanes' within the cache's
    ``LOGITS_RTOL`` of the plain path's (max error over max |logit|)."""
    import copy

    from gofr_tpu_torch.adapters import AdapterPool
    from gofr_tpu_torch.gpu.engine import make_pool

    cfg, n, page, plen = model.cfg, len(LORA_SEL), 128, 128
    rng = torch.Generator().manual_seed(SEED + 6)
    prompts = torch.randint(0, cfg.vocab_size, (n, plen), generator=rng).cuda()
    tokens = torch.randint(0, cfg.vocab_size, (n,), generator=rng).cuda()
    seq = torch.randint(0, cfg.vocab_size, (n, 5), generator=rng).cuda()
    if kv_layout == "paged":
        cache = make_pool(model, kv_quantize, 2 * n, page)
        table = torch.arange(2 * n, dtype=torch.int32, device="cuda").view(n, 2)
        rows = table
    else:
        cache, table = make_pool(model, kv_quantize, n, 2 * page, "slot"), None
        rows = torch.arange(n, dtype=torch.int32, device="cuda")
    model.prefill(prompts, torch.full((n,), plen, device="cuda"), cache, rows)
    pool = AdapterPool(LORA_SLOTS, cfg.hidden_size, cfg.vocab_size, LORA_RANK, device="cuda")
    for spec in lora_specs(cfg):
        pool.acquire(spec)
    sel = torch.tensor(LORA_SEL, device="cuda")
    ad = (sel, pool.a, pool.b, pool.scale)
    base = sel == 0
    pos = torch.full((n,), plen, device="cuda")
    copies = [copy.deepcopy(cache) for _ in range(3)]
    out = {"kv_layout": kv_layout, "kv_pool": kv_quantize or "bf16", "sel": list(LORA_SEL),
           "tol_rel": LOGITS_RTOL[kv_quantize]}
    pool_name = f"{kv_layout} {kv_quantize or 'bf16'}"
    for name, call in (("decode", lambda c, **kw: model.decode_step(tokens, pos, c, table, **kw)),
                       ("verify", lambda c, **kw: model.verify_step(seq, pos + 1, c, table, **kw))):
        plain, _ = call(copies[0])
        with_ad, _ = call(copies[1], adapters=ad)
        ref, _ = call(copies[2], adapters=ad, kernels=False)
        require(bool(with_ad.isfinite().all()), f"{pool_name} {name}: non-finite logits")
        rel = ((with_ad[~base] - ref[~base]).abs().max() / ref[~base].abs().max()).item()
        moved = (with_ad[~base] - plain[~base]).abs().max().item()
        require(torch.equal(with_ad[base], plain[base]),
                f"{pool_name} {name}: base lanes' logits differ with the adapters on")
        require(rel < LOGITS_RTOL[kv_quantize] and moved > 0,
                f"{pool_name} {name}: adapter lanes vs plain {rel} (limit "
                f"{LOGITS_RTOL[kv_quantize]}), moved by the adapters {moved}")
        out[name] = {"base_bit_identical": True, "adapter_rel_err": rel,
                     "adapter_max_logit_move": moved}
    del copies, cache
    return out


def fresh_cache(torch, model, kv_quantize: str, kv_layout: str) -> tuple:
    """(cache, prefill rows, decode table) of one lane of 512 positions: 4
    pages of 128, or one slot."""
    from gofr_tpu_torch.gpu.engine import make_pool

    if kv_layout == "paged":
        rows = table = torch.arange(4, dtype=torch.int32, device="cuda")[None]
        return make_pool(model, kv_quantize, 4, 128), rows, table
    rows = torch.zeros(1, dtype=torch.int32, device="cuda")
    return make_pool(model, kv_quantize, 1, 512, "slot"), rows, None


def verify_logits(torch, model, kv_quantize: str, prompt, seq, kernels: bool,
                  kv_layout: str):
    """Logits [T, V] of one ``verify_step`` over ``seq`` (1 x T) right after
    ``prompt`` was prefilled into a fresh cache, the kernels or their plain
    versions in both."""
    cache, rows, table = fresh_cache(torch, model, kv_quantize, kv_layout)
    model.prefill(prompt, torch.tensor([prompt.shape[1]], device="cuda"), cache, rows,
                  kernels=kernels)
    logits, _ = model.verify_step(seq, torch.tensor([prompt.shape[1]], device="cuda"), cache,
                                  table, kernels=kernels)
    return logits[0]


def model_steps(torch, model, kv_quantize: str, prompt, prefill_kernels: bool,
                decode_kernels: bool, fed=None, kv_layout: str = "paged", chunks: int = 1):
    """Logits [5, 1, V] of ``prompt`` (1 x 256) through ``prefill`` (whole,
    or in ``chunks`` equal chunks at their offsets, as the engine's chunked
    prefill runs them) and four ``decode_step`` steps on a fresh cache of
    512 positions (4 pages of 128, or one slot), ``kv_layout`` in the
    format ``kv_quantize``, the kernels or their plain versions in each.
    Each step is fed ``fed``'s tokens when given, else the run's own greedy
    tokens. Returns (logits, the tokens fed, the K/V the cache holds at the
    end as its read path returns them, f32 [L, 2, Hkv, written positions,
    D])."""
    cache, rows, table = fresh_cache(torch, model, kv_quantize, kv_layout)
    if chunks == 1:
        lengths = torch.tensor([prompt.shape[1]], device="cuda")
        logits, _ = model.prefill(prompt, lengths, cache, rows, kernels=prefill_kernels)
    else:
        width = prompt.shape[1] // chunks
        lengths = torch.tensor([width], device="cuda")
        for c in range(chunks):
            logits, _ = model.prefill(prompt[:, c * width:(c + 1) * width], lengths, cache, rows,
                                      torch.tensor([c * width], device="cuda"),
                                      kernels=prefill_kernels)
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
    """A prefill of 256 tokens in two chunks of 128 at their offsets (the
    engine's chunked path), then two ``decode_step`` steps, on a fresh
    cache of the layout and format, each inside
    ``torch.cuda.set_sync_debug_mode("error")``: any call that makes the
    host wait on the card raises there, and nothing catches it. The chunks
    go to lane 0's table row (or slot). Eight lanes decode with int64
    positions, as the engine hands them; the last lane is idle as the engine
    parks one (its table row all OOB at position 0 on the pool, at the
    slot's end on the slot cache), so its writes drop. Then one
    speculative round (``spec_chunk``, g = 4, prompt lookup in a random
    history) over those lanes, lane 0 sampled with top-k and top-p. The
    chunks must launch C once per layer each, the decode steps the decode
    kernels of the cache's path once per layer and step, the round C on
    verify rows once per layer and nothing else; the logits must be finite
    and the round's tokens and accept counts in range."""
    from gofr_tpu_torch.gpu.engine import make_pool
    from gofr_tpu_torch.gpu.programs import new_history, spec_chunk
    from gofr_tpu_torch.ops.cuda.flash_attention import flash_attention

    n, page, pages = 8, 128, 4
    rng = torch.Generator().manual_seed(SEED + 4)
    tokens = torch.randint(0, model.cfg.vocab_size, (n,), generator=rng).cuda()
    positions = torch.randint(0, pages * page - 2 - 2 * SPEC_G, (n,), generator=rng)
    prompt = torch.randint(0, model.cfg.vocab_size, (1, 256), generator=rng).cuda()
    if kv_layout == "paged":
        cache = make_pool(model, kv_quantize, n * pages, page)
        table = torch.arange(n * pages, dtype=torch.int32).view(n, pages)
        table[n - 1], positions[n - 1] = n * pages, 0
        table = table.cuda()
        rows = table[:1]
    else:
        cache, table = make_pool(model, kv_quantize, n, pages * page, "slot"), None
        positions[n - 1] = pages * page
        rows = torch.zeros(1, dtype=torch.int32, device="cuda")
    positions = positions.cuda()
    chunk_len = torch.tensor([128], device="cuda")
    offsets = [torch.tensor([c * 128], device="cuda") for c in range(2)]
    pool = f"{kv_layout} {kv_quantize or 'bf16'}"
    layers = model.cfg.num_layers

    def unsynced(fn) -> dict:
        torch.cuda.synchronize()
        cuda.reset_launch_counts()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        require(bool(out.isfinite().all()), f"{pool}: non-finite logits under the sync check")
        return cuda.launch_counts()

    def chunked():
        for c in range(2):
            logits, _ = model.prefill(prompt[:, c * 128:(c + 1) * 128], chunk_len, cache, rows,
                                      offsets[c])
        return logits

    counts = unsynced(chunked)
    require(counts["flash_attention"] == flash_attention.offset_launches == 2 * layers
            and sum(counts.values()) == 2 * layers,
            f"{pool}: the chunked prefill did not launch C once per layer and chunk: {counts}")
    chunk_launches = counts["flash_attention"]

    steps = 2

    def decode():
        for step in range(steps):
            logits, _ = model.decode_step(tokens, positions + step, cache, table)
        return logits

    counts = counts_decode = unsynced(decode)
    decode_kernels = [k for k in ON_PATH[kv_layout, kv_quantize] if k not in PREFILL_KERNELS]
    require(all(counts[k] == steps * layers for k in decode_kernels)
            and sum(counts.values()) == steps * layers * len(decode_kernels),
            f"{pool}: decode_step did not go through its kernels once per layer: {counts}")

    # one speculative round (prompt lookup in a random history) over the same
    # lanes, the idle lane's history length past the history, lane 0
    # sampled with top-k and top-p, the others greedy
    width = pages * page
    hist = new_history(n, width, "cuda")
    hist[:, :width] = torch.randint(0, model.cfg.vocab_size, (n, width), generator=rng).cuda()
    hlen = positions + 1
    hlen[n - 1] = width + 1
    temps = torch.zeros(n, device="cuda")
    temps[0] = 0.8
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    emitted = []

    def spec_round():
        toks, accs, _ = spec_chunk(model, cache, hist, tokens, hlen, table, temps, 1, SPEC_G,
                                   gen, top_k=50, top_p=0.95)
        emitted.append((toks, accs))
        return toks.float()

    counts = unsynced(spec_round)
    require(counts["flash_attention"] == flash_attention.offset_launches == layers
            and sum(counts.values()) == layers,
            f"{pool}: a spec round did not launch C on verify rows once per layer alone: {counts}")
    toks, accs = (t.cpu() for t in emitted[0])
    require(bool(((toks >= 0) & (toks < model.cfg.vocab_size)).all())
            and bool(((accs >= 0) & (accs <= SPEC_G)).all()),
            f"{pool}: a spec round emitted {toks.tolist()}, accepted {accs.tolist()}")
    spec_launches = counts["flash_attention"]

    # the adapter plane: one upload (the third adapter into a pool holding
    # two), then a decode step and a spec round with the lanes on base and
    # adapters in turn
    from gofr_tpu_torch.adapters import AdapterPool

    specs = lora_specs(model.cfg)
    lora_pool = AdapterPool(LORA_SLOTS, model.cfg.hidden_size, model.cfg.vocab_size, LORA_RANK,
                            device="cuda")
    for spec in specs[:-1]:
        lora_pool.acquire(spec)
    sel = torch.tensor([i % LORA_SLOTS for i in range(n)], device="cuda")
    ad = (sel, lora_pool.a, lora_pool.b, lora_pool.scale)
    torch.cuda.synchronize()

    def lora_round():
        lora_pool.acquire(specs[-1])
        logits, _ = model.decode_step(tokens, positions + steps, cache, table, adapters=ad)
        toks, _, _ = spec_chunk(model, cache, hist, tokens, hlen + steps, table, temps, 1,
                                SPEC_G, gen, top_k=50, top_p=0.95, adapters=ad)
        return torch.cat([logits.flatten(), toks.float().flatten()])

    counts = unsynced(lora_round)
    require(all(counts[k] == layers for k in decode_kernels)
            and counts["flash_attention"] == flash_attention.offset_launches == layers
            and sum(counts.values()) == layers * (len(decode_kernels) + 1)
            and lora_pool.uploads == len(specs),
            f"{pool}: a decode step and a spec round with adapters launched {counts}")
    return {"kv_layout": kv_layout, "kv_pool": kv_quantize or "bf16", "chunks": 2,
            "steps": steps, "spec_rounds": 1, "spec_sampled_lanes": 1, "sync_debug_mode": "error",
            "adapters": {"uploads_in_check": 1, "decode_steps": 1, "spec_rounds": 1,
                         "sel": sel.tolist()},
            "launches": {"flash_attention (chunks)": chunk_launches,
                         **{k: counts_decode[k] for k in decode_kernels},
                         "flash_attention (verify)": spec_launches,
                         "with adapters": counts}}


def dispatch_sync_check(torch, model, kv_layout: str, kv_quantize: str) -> dict:
    """The engine's dispatches on one cache, each inside
    ``torch.cuda.set_sync_debug_mode("error")``: a batched prefill (one lane
    sampled with top-k and top-p) with a long prompt's claim
    (``dispatch_prefill``), that prompt's two chunks (``dispatch_chunk``),
    two decode chunks, the second from the device carry
    (``dispatch_decode``), and on the pool a swap-in of one page into a free
    page (``dispatch_swapins``), then two speculative rounds on an engine
    with ``spec_tokens`` (``dispatch_spec`` / ``dispatch_spec_paged``). Each
    runs on a stopped engine of 2 slots, from this thread; the folds, whose
    waits on their events are the intended ones, run outside the check. The
    page swapped in must equal the page it was copied from, bit for bit."""
    from gofr_tpu_torch.gpu import decode, executor
    from gofr_tpu_torch.gpu.engine import GenerateEngine, Request
    from gofr_tpu_torch.ops.paged import gather_page, page_planes

    pool = f"{kv_layout} {kv_quantize or 'bf16'}"
    rng = torch.Generator().manual_seed(SEED + 8)
    short, long = (torch.randint(0, model.cfg.vocab_size, (n,), generator=rng).tolist()
                   for n in (100, 300))
    checked = []

    def engine(**kw):
        eng = GenerateEngine(model, device="cuda", slots=2, max_len=1024, max_prefill_batch=2,
                             decode_chunk=2, prefill_buckets=[128, 256], top_k=50, top_p=0.95,
                             kv_layout=kv_layout, kv_quantize=kv_quantize, **kw)
        eng.stop()  # its loop ends: the dispatches below run from this thread
        return eng

    def submit(eng, prompt, temperature=0.0):
        eng._accept(Request(prompt, {"max_new_tokens": 16, "temperature": temperature}, None))

    def unsynced(name, fn) -> None:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            did = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        require(did is None or did, f"{pool}: {name} dispatched nothing")
        checked.append(name)

    def fold(eng) -> None:
        while eng._dq:
            decode.process_decode(eng)

    eng = engine()
    submit(eng, short, temperature=0.8)
    submit(eng, long)
    unsynced("dispatch_prefill", eng._admit_prefill)
    unsynced("dispatch_chunk", eng._advance_chunked)
    unsynced("dispatch_chunk", eng._advance_chunked)
    fold(eng)
    unsynced("dispatch_decode", lambda: decode.dispatch_decode(eng))
    unsynced("dispatch_decode (carry)", lambda: decode.dispatch_decode(eng))
    fold(eng)
    if kv_layout == "paged":
        src, dst = eng._slot_pages[0][0], eng._free_pages[-1]
        host = executor.Readback(eng.device, *gather_page(eng.cache, src)).wait()
        eng._pending_swapins = [(0, eng.slots[0], [], [dst], [tuple(host)])]
        unsynced("dispatch_swapins", lambda: executor.dispatch_swapins(eng))
        fold(eng)
        require(all(bool((plane[:, dst] == plane[:, src]).all()) for plane in page_planes(eng.cache)),
                f"{pool}: the page swapped in differs from the page it was copied from")
    eng = engine(spec_tokens=SPEC_G)
    submit(eng, short, temperature=0.8)
    submit(eng, long[:200])
    eng._admit_prefill()
    fold(eng)
    name = "dispatch_spec_paged" if kv_layout == "paged" else "dispatch_spec"
    unsynced(name, lambda: getattr(decode, name)(eng))
    unsynced(f"{name} (carry)", lambda: getattr(decode, name)(eng))
    fold(eng)
    require(eng.counters["spec_rounds"] == 2 * eng.decode_chunk,
            f"{pool}: {eng.counters['spec_rounds']} spec rounds folded")
    return {"kv_layout": kv_layout, "kv_pool": kv_quantize or "bf16",
            "sync_debug_mode": "error", "dispatches": checked}


# Phase 5's runs besides the plain one: (prefill kernels, decode kernels,
# prefill chunks). "kernels" is the served path and "chunked" the engine's
# chunked prefill through the kernels; both are held to LOGITS_RTOL. The
# two splits show which half of the step an error comes from.
PHASE5_RUNS = {"kernels": (True, True, 1), "plain_prefill": (False, True, 1),
               "plain_decode": (True, False, 1), "chunked": (True, True, 2)}


def model_check(torch, model, kv_quantize: str = "", enforce: bool = True,
                kv_layout: str = "paged") -> dict:
    """Kernels vs plain versions, end to end through the model, on a cache
    ``kv_layout`` of the format ``kv_quantize``: each of ``PHASE5_PROMPTS``
    prompts of 256 tokens through ``prefill`` and four ``decode_step`` steps
    with the plain versions, with the kernels, and with the kernels in one
    half of the step only, every run fed the kernel run's greedy tokens;
    and through ``prefill`` and one ``verify_step`` over five of those
    tokens, with the kernels and with the plain versions.
    Reports, for each run and step, max |logits - plain logits| over max
    |plain logit|, and how the K/V stored by the kernel run differ from the
    plain run's (the share of elements that differ, and the RMS of the
    difference over the RMS of the stored values). With ``enforce``, the
    kernel run's and the kernel verify's largest errors must stay under the
    pool's limit, and the decode-only run's and the plain verify's against
    the plain decode steps under ``DECODE_RTOL``."""
    pool = f"{kv_layout} {kv_quantize or 'bf16'}"
    rng = torch.Generator().manual_seed(SEED + 1)
    steps = {name: [] for name in PHASE5_RUNS}
    agree, differ, stored_rel, verify_errs, verify_vs_decode = [], [], [], [], []
    for _ in range(PHASE5_PROMPTS):
        prompt = torch.randint(0, model.cfg.vocab_size, (1, 256), generator=rng).cuda()
        k_run, fed, k_kv = model_steps(torch, model, kv_quantize, prompt, True, True,
                                       kv_layout=kv_layout)
        p_run, _, p_kv = model_steps(torch, model, kv_quantize, prompt, False, False, fed,
                                     kv_layout)
        require(torch.isfinite(k_run).all().item(), f"non-finite logits with the kernels ({pool})")
        top = p_run.abs().max().item()
        for name, (pk, dk, chunks) in PHASE5_RUNS.items():
            run = k_run if name == "kernels" else model_steps(
                torch, model, kv_quantize, prompt, pk, dk, fed, kv_layout, chunks)[0]
            steps[name].append(((run - p_run).abs().amax(dim=(1, 2)) / top).tolist())
        # speculative decoding's verify forward over the 5 tokens the kernel
        # run chose (g + 1 = 5): the kernels against the plain versions, and
        # the plain verify against the plain decode steps' logits
        seq = torch.stack(fed + [k_run[4].argmax(-1).to(torch.int32)], dim=1)
        k_ver, p_ver = (verify_logits(torch, model, kv_quantize, prompt, seq, kernels, kv_layout)
                        for kernels in (True, False))
        verify_errs.append(((k_ver - p_ver).abs().amax(dim=-1) / top).tolist())
        verify_vs_decode.append(((p_ver[:4] - p_run[1:, 0]).abs().amax(dim=-1) / top).tolist())
        agree.append((k_run.argmax(-1) == p_run.argmax(-1)).float().mean().item())
        differ.append((k_kv != p_kv).float().mean().item())
        stored_rel.append(((k_kv - p_kv).pow(2).mean() / p_kv.pow(2).mean()).sqrt().item())
        del k_kv, p_kv
    rel_errs = [max(s) for s in steps["kernels"]]
    chunked_errs = [max(s) for s in steps["chunked"]]
    decode_errs = [max(s[1:]) for s in steps["plain_prefill"]]
    out = {"kv_layout": kv_layout, "kv_pool": kv_quantize or "bf16", "prompts": PHASE5_PROMPTS,
           "steps": 5, "rel_err": rel_errs, "chunked_rel_err": chunked_errs,
           "tol_rel": LOGITS_RTOL[kv_quantize], "decode_only_rel_err": decode_errs,
           "decode_only_tol_rel": DECODE_RTOL, "argmax_agree": agree, "rel_err_by_step": steps,
           "stored_differ": differ, "stored_rms_rel": stored_rel,
           "verify_rel_err": [max(e) for e in verify_errs], "verify_rel_err_by_row": verify_errs,
           "plain_verify_vs_plain_decode_rel_err": [max(e) for e in verify_vs_decode]}
    if enforce:
        require(max(rel_errs) < LOGITS_RTOL[kv_quantize],
                f"kernel vs plain logits ({pool}): max err / max |logit| {rel_errs} "
                f"(limit {LOGITS_RTOL[kv_quantize]})")
        require(max(chunked_errs) < LOGITS_RTOL[kv_quantize],
                f"chunked prefill through the kernels vs plain logits ({pool}): {chunked_errs} "
                f"(limit {LOGITS_RTOL[kv_quantize]})")
        require(max(decode_errs) < DECODE_RTOL,
                f"kernel vs plain logits, kernels in decode only ({pool}): {decode_errs} "
                f"(limit {DECODE_RTOL})")
        require(max(out["verify_rel_err"]) < LOGITS_RTOL[kv_quantize],
                f"verify_step with the kernels vs plain ({pool}): {out['verify_rel_err']} "
                f"(limit {LOGITS_RTOL[kv_quantize]})")
        ver_dec = out["plain_verify_vs_plain_decode_rel_err"]
        require(max(ver_dec) < DECODE_RTOL,
                f"plain verify_step vs plain decode steps ({pool}): {ver_dec} "
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
    model, served, results = None, {}, {}
    for kv_layout, kv_quantize in RUNS:
        eng, counts, metrics, outs = serve(torch, cuda, model, kv_quantize, kv_layout)
        emit(f"phase4_serve_{run_name(kv_layout, kv_quantize)}", {**metrics, "launches": counts})
        eng.stop()
        model = eng.model
        served[kv_layout, kv_quantize] = {"metrics": metrics, "launches": counts}
        results[kv_layout, kv_quantize] = outs
        del eng
        torch.cuda.empty_cache()
        lap(f"phase4_{run_name(kv_layout, kv_quantize)}")

    served.update(serve_spec(torch, cuda, model, results))
    lap("phase4_spec")

    admission = serve_admission(torch, cuda, model)
    emit("phase4_serve_paged_admission", admission)
    served["paged_admission"] = admission
    lap("phase4_paged_admission")

    served["paged_prefix_host"] = serve_prefix_host(torch, cuda, model)
    emit("phase4_serve_paged_prefix_host", {k: v for k, v in served["paged_prefix_host"].items()
                                            if k not in ("counters_host_tier_off", "pool_after")})
    lap("phase4_paged_prefix_host")

    served["paged_pipeline"] = serve_pipeline(torch, cuda, model)
    emit("phase4_serve_paged_pipeline", {**served["paged_pipeline"], "arms": [
        {k: v for k, v in arm.items() if k != "margin_at_first_difference"}
        for arm in served["paged_pipeline"]["arms"]]})
    lap("phase4_paged_pipeline")

    served["paged_lora"] = serve_lora(torch, cuda, model, served["paged", ""]["metrics"],
                                      results["paged", ""])
    emit("phase4_serve_paged_lora", {**served["paged_lora"]["metrics"],
                                     "launches": served["paged_lora"]["launches"]})
    lap("phase4_paged_lora")

    adoption = adopt_check(torch, cuda)
    emit("phase4_adopt_weights", adoption)
    served["adopt_weights"] = adoption
    lap("phase4_adopt_weights")

    served["http_generate"] = http_generate(torch, cuda, model, served["paged", ""]["metrics"],
                                            results["paged", ""])
    emit("phase4_http_generate", served["http_generate"])
    lap("phase4_http_generate")

    for kv_layout, kv_quantize in RUNS:
        emit(f"phase5_model_{run_name(kv_layout, kv_quantize)}",
             model_check(torch, model, kv_quantize, kv_layout=kv_layout))
        lap(f"phase5_{run_name(kv_layout, kv_quantize)}")
    emit("phase5_lora", [lora_check(torch, model, *run) for run in RUNS])
    lap("phase5_lora")

    emit("phase6_no_sync", [no_sync_check(torch, cuda, model, *run) for run in RUNS])
    emit("phase6_dispatch_no_sync", [dispatch_sync_check(torch, model, *run) for run in RUNS])
    lap("phase6")

    # each kernel's launches from the first serving run whose path it is on
    for k in kernels:
        run = next(r for r in RUNS if k["name"] in ON_PATH[r])
        k["launches"] = served[run]["launches"][k["name"]]
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"kernels": kernels, "wall_s": wall,
                   "serve": {r if isinstance(r, str) else run_name(*r): run
                             for r, run in served.items()}}, f, indent=1)
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
