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
   length against 2176 keys, and the quality plane's teacher-forced
   forward, one sequence of 1088 keys in a bucket of 2048; the five appends, bf16 and quantizing, on
   edge lanes: a position of -1, past the table, through an OOB or
   negative entry, at and past Smax, an all-zero row and a row whose max
   is one element; the W8A16 linear at Llama-3-8B's five (N, K) for M =
   8, 40 and 2048 rows, ``W8_SHAPES`` x ``W8_ROWS``): each held against its
   plain PyTorch version on the same inputs (the appends bit for bit,
   values and scales), timed with
   CUDA events and by device time beside the plain version, a library
   yardstick where one PyTorch call computes the same function, and the
   least time the card could take (its bound); and the split decode
   kernels A, D, E and F at every plan the warmup autotuner races
   (``split_candidates``), each pinned by a decision scope, held against
   their split plain versions at that plan and timed (``plans``);
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
   and decode tok/s beside ``bf16``'s. Then ``paged_w8``: the engine
   built from a ``ModelSpec`` of the phase's bf16 model and a container
   whose config is ``W8_CONFIG`` (``bf16``'s knobs, ``ENGINE_QUANTIZE=
   int8``) serves ``bf16``'s traffic; the int8 model must hold
   ``W8_BYTES``, the bf16 model stay as it was, every request end with 64
   tokens, A, B and C launch and the W8A16 kernel 7 x 32 + 1 times a model
   forward (it launches in no other run); it prints the share of requests
   whose tokens equal ``bf16``'s (not held: int8 weights move the logits)
   and tok/s and TTFT beside ``bf16``'s. Then ``paged_warmup``: on
   ``bf16``'s knobs and model, ``warmup()`` after a request left pages in
   the prefix cache must run JAX's count of calls, launch A, B and C, and
   leave the pool's bytes and books and the prefix cache as they were;
   ``bf16``'s prompts after it end with ``bf16``'s tokens by the tie rule.
   Then ``paged_restart``:
   ``bf16``'s knobs and model with a host-side fault planted in the decode
   dispatch once the 8 requests are in slots; they must fail with it,
   health read DEGRADED inside the backoff, the 8 prompts submitted after
   the fault end with 64 tokens, equal to ``bf16``'s by the tie rule,
   ``app_tpu_engine_restarts`` read 1, the pool's audit pass and A, B, C
   launch; it prints the seconds from the fault to the next token. Then
   ``paged_quality`` and ``int8_quality``: the engine from a ``ModelSpec``
   and ``QUALITY_CONFIG`` (every finished request shadow-scored) on the
   bf16 and the int8 pool serves the 8 prompts and drains its plane: 8
   samples, no error, the tokens of the run without the plane by the tie
   rule, each arm launching C once a layer, on the bf16 pool the arms
   equal (KL 0), at every top-1 disagreement the emitted token within
   ``SPEC_TIE_GAP`` of the serving arm's top logit; on the bf16 pool the App
   serves the engine under ``CAPTURE_CONFIG``, and the capture bundle a 1
   ms interactive TTFT objective writes, and a ``/debug/profile`` taken
   during a second wave, must each hold a trace with C's and A's kernel
   events; it prints each sample's bucket, each arm's device ms and C's
   share. Last ``cold_start``: ``scripts/torch_cold_start.py`` in two fresh
   processes, ``ENGINE_WARMUP`` false and true, prints warmup's seconds and
   count and the first and a second request's TTFT. Before it
   ``paged_control`` (``serve_control``): ``bf16``'s pool from a
   ``ModelSpec`` with the step controller on (``CONTROL_CONFIG``), under
   ``paged_pipeline``'s waves for 15 s, then a wave of ``bf16``'s prompts
   with pipeline depth 1, chunk 128 and batch 1 queued mid-wave, the boot
   values queued in the next, and a spec engine (g 4) moved to g 2
   mid-wave: at least one trial and one commit or revert, every knob of
   every decision and flight step within its boot envelope, the waves'
   tokens ``bf16``'s by the tie rule, the decisions counter equal to the
   ring; and ``paged_handoff`` (``serve_handoff``): a prefill worker and a
   decode worker of ``bf16``'s knobs in one process, streamed, blob, an
   int8 pair and 2 prompts of 1536 tokens in 3 chunks each: each prompt of
   a page or more ends on the prefill worker with ``finish_reason=
   "handoff"`` and one token, the decode worker's tokens are its cache's
   run's by the tie rule, pages exported = imported = Σ⌊len/128⌋ (pinned
   on the import), bytes = pages × page bytes, host-tier tokens 128 ×
   Σ⌊(len−1)/128⌋, both pools audit clean; it prints each arm's readback
   and wire GB/s, overlap ratio and the decode worker's TTFT p50. After
   ``cold_start``, ``paged_autotune`` (``serve_autotune``): the split-plan
   autotuner at warmup on four engines of Llama-3-8B's widths cut to 2
   layers (bf16, int8 and int4 pools, bf16 slot cache); each pins one of
   its candidates from its own timings with none disqualified (another
   plan than the rule's only past the timer's spread), a second
   engine of the same shapes pins from the cache file without timing, and
   under ``GOFR_AUTOTUNE=0`` there is no report; it prints each
   candidate's ms and spread and the winner beside ``split_plan``'s. Last
   ``app_transports``: the App's other entry points on the phase's model
   behind Basic auth (``TRANSPORTS_CONFIG``, warmed, so A runs on the plan
   pinned at 32 layers): 8 concurrent ``/ws/generate`` clients and a ninth
   that leaves mid-stream (cancelled, its slot freed), 4 unary gRPC calls
   and a stream, 4 prompts through pub/sub (generate, publish, collect), a
   cron job, 401 / 201 / 101 and a static file and the OpenAPI spec; every
   path's tokens are ``bf16``'s by the tie rule, a stream is one frame per
   token then ``{"done": true}``, ``app_pubsub_*`` read 8 each, the pool
   audits clean, A, B and C launch and A only on the pinned plan, and after
   ``stop`` no thread the App started is left; it prints the websocket
   first frame against the engine's TTFT, the frame gap against its TPOT,
   the gRPC overhead and pub/sub publish to completion;
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
   within ``LOGITS_RTOL`` of the plain path's with adapters; then
   ``phase5_model_w8``, the runs above on the int8-weight model on the bf16
   pool, W8A16 against ``qdot_plain`` end to end, within the same limits;
6. no host sync: a prefill of two 128-token chunks, two ``decode_step``
   steps and one speculative round with a sampled lane on each cache, then
   an adapter upload, a ``decode_step`` and a speculative round with the
   lanes on the base model and adapters, inside
   ``torch.cuda.set_sync_debug_mode("error")``, which raises on any call
   that makes the host wait on the card; then on a stopped engine of each
   cache the engine's own dispatches under the same check: a batched
   prefill, two prefill chunks, two decode chunks (the second from the
   device carry), a swap-in on the pool (the page swapped in must equal its
   source bit for bit), on the pool a prefill worker's handoff export (the
   page copies staged at a chunk fold and at activation, each equal to its
   pool page bit for bit) and two speculative rounds, the folds outside it;
   both checks also on the int8-weight model on the bf16 pool.

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
    """The least time the card could take: bytes over the H100 SXM's HBM
    rate or operations over its dense bf16 peak, whichever is longer (the
    data-sheet pair the perf plane's ``device_peaks`` prices it by)."""
    from gofr_tpu_torch.metrics.perf import H100_SXM_BF16_FLOPS, H100_SXM_HBM_BYTES_PER_S

    t_bytes, t_ops = nbytes / H100_SXM_HBM_BYTES_PER_S, flops / H100_SXM_BF16_FLOPS
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
    from gofr_tpu_torch.ops import autotune
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

    def plan_holds(op: str, mod, launch, split_plain, span: int, dims: tuple) -> dict:
        """Split decode kernel ``op`` (A, D, E or F) at every plan the warmup
        autotuner races (``split_candidates``), each pinned by a decision
        scope at the launch's own shape key: the plan must be the one the
        launcher takes, its output is held against the split's plain
        version at that plan within the launcher's limits, and (if
        ``timed``) it is timed with CUDA events over the layers."""
        key, out = autotune.shape_key(*dims), {}
        for rows in slot_decode_mod.split_candidates(n, hkv, span):
            name = autotune.plan_name(rows)
            with autotune.decision_scope({op: name}, {op: key}):
                require(slot_decode_mod.split_scratch(q, hkv, span, op, dims)[0] == rows,
                        f"{op}: the pinned plan {name} is not the one its launcher takes")
                agree = agreement(f"{op} (plan {name})", launch(0), split_plain(rows), mod)
                ms = time_ms(torch, launch, 50) if timed else None
            out[name] = {**agree, "ms": ms}
        return out

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
            "plans": plan_holds(
                "paged_decode", decode_mod,
                lambda i: paged_decode(q, k_pool[i % layers], v_pool[i % layers], table, lengths),
                lambda rows: paged_decode_attention_split_plain(q, k_pool[0], v_pool[0], table,
                                                                lengths, rows),
                table.shape[1] * page, (n, hq, hkv, d, page, table.shape[1], k_pool.shape[1])),
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
        # the quality plane's teacher-forced forward (metrics/quality.py,
        # phase 4's quality runs): batch 1, a bucket of 2048 padded
        # positions, keys masked by the sequence's length (phase 4's
        # longest, 1024 + 64); every query row attends min(i + 1, length)
        # keys, the padded rows included
        tf = 1024 + 64
        qt = torch.randn(1, 2048, hq, d, device=dev, generator=gen).to(bf)
        kt, vt = (torch.randn(1, 2048, hkv, d, device=dev, generator=gen).to(bf) for _ in range(2))
        lent = torch.tensor([tf], device=dev, dtype=torch.int32)
        checks["teacher_forced_2048"] = flash_agree("teacher-forced 2048", qt, kt, vt,
                                                    kv_lengths=lent)[0]
        b_ms_t, b_by_t = bound_ms(2 * 2 * qt.numel() + 2 * tf * hkv * d * 2 + 4,
                                  4 * hq * d * (tf * (tf + 1) // 2 + (2048 - tf) * tf))
        # yardstick only: SDPA with the causal and length mask as a bool mask
        # and enable_gqa, on head-major views made outside the timed call
        pos = torch.arange(2048, device=dev)
        tf_mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] < tf)
        qth, kth, vth = (t.transpose(1, 2) for t in (qt, kt, vt))
        teacher = {"shape": {"batch": 1, "bucket": 2048, "kv_length": tf, "causal": True},
                   "bound_ms": b_ms_t, "bound_by": b_by_t,
                   **timing(lambda i: flash_attention(qt, kt, vt, causal=True, kv_lengths=lent),
                            lambda i: mha_attention_plain(qt, kt, vt, causal=True,
                                                          kv_lengths=lent),
                            lambda i: F.scaled_dot_product_attention(
                                qth, kth, vth, attn_mask=tf_mask, enable_gqa=True),
                            iters=20, plain_iters=3)}
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
            "verify_5_at_live": verify, "teacher_forced_2048": teacher,
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
            "plans": plan_holds(
                name, mod, lambda i: launch(*args(i % layers)),
                lambda rows: paged_decode_attention_q_split_plain(*args(0), rows, bits=bits),
                table.shape[1] * page, (n, hq, hkv, d, page, table.shape[1], cache.k.shape[1])),
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
            "plans": plan_holds(
                "decode", slot_decode_mod,
                lambda i: slot_decode(q, sk[i % layers], sv[i % layers], lengths),
                lambda rows: decode_attention_split_plain(q, sk[0], sv[0], lengths, rows),
                smax, (n, hq, hkv, d, smax)),
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
              ("kv_append_slot_q", check_append_slot_q),
              ("w8a16", lambda: check_w8a16(torch, timing if timed else None))]
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


def w8_agreement(label: str, got, want) -> dict:
    """Hold the W8A16 kernel against ``qdot_plain`` under its launcher's
    limits, relative to the output's scale: max |err| over max |y|, the
    RMS of the difference over the output's RMS, and the share of
    outputs not bit-equal to the plain version's."""
    from gofr_tpu_torch.ops.cuda import w8a16 as w8_mod

    got, want = got.float(), want.float()
    require(bool(got.isfinite().all()), f"{label} produced non-finite values")
    diff = (got - want).abs()
    top = want.abs().max().item()
    err = diff.max().item()
    numbers = {"max_abs_err": err, "max_rel_err": err / top,
               "rms_rel_err": (diff.pow(2).mean().sqrt() / want.pow(2).mean().sqrt()).item(),
               "mismatch_share": (diff > 0).float().mean().item(), "out_max": top}
    if not (numbers["max_rel_err"] <= w8_mod.MAX_REL and numbers["rms_rel_err"] <= w8_mod.RMS_REL
            and numbers["mismatch_share"] <= w8_mod.MISMATCH_SHARE):
        failure = SystemExit(f"chip_smoke FAILED: {label} disagrees with qdot_plain: {numbers} "
                             f"(limits {w8_mod.MAX_REL}, {w8_mod.RMS_REL}, "
                             f"{w8_mod.MISMATCH_SHARE})")
        failure.numbers = numbers
        raise failure
    return numbers


def int8pack(torch, x, qs, copies: int, iters: int) -> dict:
    """Yardstick only (never called by the port): PyTorch's own
    weight-only int8 product, ``torch._weight_int8pack_mm``, where this
    torch has a CUDA implementation of it, timed over ``iters`` calls."""
    scales = [w.s.to(torch.bfloat16) for w in qs]
    try:
        torch._weight_int8pack_mm(x, qs[0].q, scales[0])
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        return {"ms": None, "device_ms": None, "unavailable": str(e).splitlines()[0][:160]}
    fn = lambda i: torch._weight_int8pack_mm(x, qs[i % copies].q, scales[i % copies])  # noqa: E731
    return {"ms": time_ms(torch, fn, iters, warmup=1), "device_ms": device_ms(torch, fn, iters)}


def check_w8a16(torch, timing=None) -> dict:  # port: the weight-only int8 linear
    """At Llama-3-8B's five (N, K) and the rows of a decode step, a
    verify forward and a prefill (``W8_ROWS``): bf16 weights from the
    seed with std K^-1/2 quantized by the port's ``quantize`` and bf16
    rows of RMS 1, against ``qdot_plain`` on the same inputs (cuBLAS
    reducing in f32). Timed on ``W8_COLD_BYTES`` of weight copies
    cycled, so each launch finds its weight cold in L2 as a step
    through 32 layers does; the yardsticks are cuBLAS on the bf16
    weight (``F.linear``, the product without int8) and
    ``torch._weight_int8pack_mm``. The row's ``ms``, ``device_ms``,
    ``plain_ms``, ``library_ms`` and ``bound_ms`` are one decode step's
    225 products at M = 8 (``W8_PER_STEP``), summed over the shapes.
    ``timing`` is ``check_kernels``' timer; None leaves the check untimed."""
    import torch.nn.functional as F

    from gofr_tpu_torch.ops.cuda import w8a16 as w8_mod
    from gofr_tpu_torch.ops.cuda.w8a16 import w8a16
    from gofr_tpu_torch.ops.quant import qdot_plain, quantize

    dev, bf, timed = torch.device("cuda"), torch.bfloat16, timing is not None
    wgen = torch.Generator(device=dev).manual_seed(SEED + 9)
    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    shapes = {}
    try:
        for name, (n_out, k_in) in W8_SHAPES.items():
            copies = max(1, math.ceil(W8_COLD_BYTES / (n_out * k_in))) if timed else 1
            ws = [(torch.randn(n_out, k_in, device=dev, generator=wgen) * k_in ** -0.5).to(bf)
                  for _ in range(copies)]
            qs = [quantize(w) for w in ws]
            for m in W8_ROWS:
                x = torch.randn(m, k_in, device=dev, generator=wgen).to(bf)
                label = f"w8a16 {name} M={m}"
                entry = {**w8_agreement(label, w8a16(x, qs[0].q, qs[0].s), qdot_plain(x, qs[0])),
                         "n": n_out, "k": k_in, "m": m, "plan": w8_mod.plan(m, n_out, k_in)}
                entry["bound_ms"], entry["bound_by"] = bound_ms(
                    n_out * k_in + 4 * n_out + 2 * m * k_in + 2 * m * n_out, 2 * m * n_out * k_in)
                if timed:
                    entry.update(timing(
                        lambda i: w8a16(x, qs[i % copies].q, qs[i % copies].s),
                        lambda i: qdot_plain(x, qs[i % copies]),
                        lambda i: F.linear(x, ws[i % copies]), iters=20, plain_iters=5))
                    # seconds a call at prefill rows: two calls there
                    entry["int8pack_mm"] = int8pack(torch, x, qs, copies, 20 if m <= 64 else 2)
                shapes[f"{name}_m{m}"] = entry
            del ws, qs
            torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = reduced
    row = {"name": "w8a16", "route": "cuda", "source": "gofr_tpu_torch/csrc/w8a16.cu",
           "replaces": "port-only (XLA in JAX: gofr_tpu/ops/quant.py:52 qdot)",
           **{key: max(e[key] for e in shapes.values())
              for key in ("max_abs_err", "max_rel_err", "rms_rel_err", "mismatch_share")},
           "tolerance": {"max_rel": w8_mod.MAX_REL, "rms_rel": w8_mod.RMS_REL,
                         "mismatch_share": w8_mod.MISMATCH_SHARE},
           "shapes": shapes, "bound_by": "bytes",
           "per_call": "one decode step: the 225 products at M = 8, summed over the shapes"}
    for key in ("bound_ms", *(("ms", "device_ms", "plain_ms", "library_ms", "library_device_ms")
                              if timed else ())):
        row[key] = sum(W8_PER_STEP[name] * shapes[f"{name}_m8"][key] for name in W8_SHAPES)
    return row


# Phase 3's W8A16 shapes: Llama-3-8B's linears as (N, K), the launches of
# each in one decode step (7 x 32 + the head), the rows of a decode step (8
# slots), a verify forward (8 lanes x 5) and a prefill (4 x 512), and the
# bytes of int8 weight copies cycled while timing (past the 50 MB L2).
W8_SHAPES = {"wq_wo": (4096, 4096), "wk_wv": (1024, 4096), "gate_up": (14336, 4096),
             "down": (4096, 14336), "head": (128256, 4096)}
W8_PER_STEP = {"wq_wo": 64, "wk_wv": 64, "gate_up": 64, "down": 32, "head": 1}
W8_ROWS = (8, 40, 2048)
W8_COLD_BYTES = 150e6
# Phase 4's ``paged_w8``: ``bf16``'s engine knobs as a user sets them, and
# weight-only int8; the int8 Llama-3-8B holds this many bytes.
W8_CONFIG = {"ENGINE_SLOTS": "8", "ENGINE_MAX_LEN": "2048", "ENGINE_PREFILL_BATCH": "4",
             "ENGINE_DECODE_CHUNK": "8", "ENGINE_KV_DTYPE": "bf16", "ENGINE_QUANTIZE": "int8"}
W8_BYTES = 8_561_882_112

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
           ("slot", "int8"): ("kv_append_slot_q", "flash_attention"),
           # the int8-weight model on the bf16 pool: every product through W8A16
           "paged_w8": ("paged_decode", "kv_append", "flash_attention", "w8a16"),
           # the step controller on the bf16 pool, and on a spec engine (C alone)
           "paged_control": ("paged_decode", "kv_append", "flash_attention"),
           "paged_control_spec": ("flash_attention",),
           # a prefill worker (C; its pool's decode kernels only for a prompt
           # under a page, served colocated) and a decode worker, bf16 pool
           "paged_handoff_prefill": ("flash_attention",),
           "paged_handoff_decode": ("paged_decode", "kv_append", "flash_attention"),
           # each autotuned engine's warmup (the tuner's candidates, then the
           # warmup body), on its cache's kernels; the App's other entry
           # points on the bf16 pool
           "paged_autotune_bf16": ("paged_decode", "kv_append", "flash_attention"),
           "paged_autotune_int8": ("paged_decode_q", "kv_append_q", "flash_attention"),
           "paged_autotune_int4": ("paged_decode_q4", "kv_append_q4", "flash_attention"),
           "paged_autotune_slot_bf16": ("decode_attention", "kv_append_slot", "flash_attention"),
           "app_transports": ("paged_decode", "kv_append", "flash_attention")}
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
          spec: str | None = None, draft=None, lora: bool = False, w8: bool = False
          ) -> tuple[object, dict, dict, list]:
    """Serve 8 concurrent greedy requests on a Llama-3-8B engine with the
    cache ``kv_layout`` in the format ``kv_quantize``; a new model with
    random weights from the seed, or ``model`` when given. ``spec`` names a
    run of ``SPEC_RUNS``: speculative decoding, with ``draft`` as its draft
    model if given. With ``lora`` the engine has the adapter plane and the
    requests name ``LORA_LANES`` in turn. With ``w8`` (the run
    ``paged_w8``) the engine is built as a user builds it, from a
    ``ModelSpec`` of ``model`` and a container whose config is
    ``W8_CONFIG``: ``bf16``'s knobs with ``ENGINE_QUANTIZE=int8``; every
    product must then go through the W8A16 kernel, 7 x 32 + 1 launches a
    model forward. Returns (engine, launches, metrics, the results)."""
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
    if w8:
        from gofr_tpu_torch.config import DictConfig
        from gofr_tpu_torch.container import Container
        from gofr_tpu_torch.models import ModelSpec

        eng = build_engine(ModelSpec("llama", cfg, weights=model, dtype=cfg.dtype),
                           Container(DictConfig(W8_CONFIG)), device="cuda", seed=SEED)
    else:
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
            + (" (lora)" if lora else "") + (" (int8 weights)" if w8 else ""))
    for i, o in enumerate(outs):
        require(o["finish_reason"] == "length" and len(o["tokens"]) == 64,
                f"{pool} request {i}: {o['finish_reason']}, {len(o['tokens'])} tokens")
        require(all(0 <= t < cfg.vocab_size for t in o["tokens"]),
                f"{pool} request {i}: token out of range")
    on_path = (ON_PATH["paged_w8"] if w8 else ON_PATH[kv_layout, kv_quantize] if spec is None
               else ON_PATH_SPEC[spec])
    for name, launches in counts.items():
        if name in on_path:
            require(launches > 0, f"kernel {name} was not launched on the {pool} cache's path")
        else:
            require(launches == 0, f"kernel {name} was launched {launches} times on the {pool} "
                                   f"cache's path")
    per_step = {counts[name] for name in on_path if name not in (*PREFILL_KERNELS, "w8a16")}
    if w8:
        # a forward is a prefill or chunk call (C once a layer) or a decode
        # step (A once a layer); each makes 7 products a layer and the head's
        forwards = (counts["paged_decode"] + counts["flash_attention"]) // cfg.num_layers
        require(counts["w8a16"] == forwards * (7 * cfg.num_layers + 1),
                f"{pool}: W8A16 launched {counts['w8a16']} times for {forwards} model forwards, "
                f"not {7 * cfg.num_layers + 1} each")
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
        "model": ("llama3_8b (random bf16 weights, seed 0" + (", served in int8)" if w8 else ")")),
        "layers": cfg.num_layers,
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
    if w8:
        from gofr_tpu_torch.ops.quant import quantized_bytes

        held = quantized_bytes(eng.model)
        require(held == W8_BYTES, f"{pool}: the int8 model holds {held} B, not {W8_BYTES}")
        require(model is None or type(model.blocks[0].wq).__name__ == "Linear",
                f"{pool}: quantizing changed the bf16 model it was given")
        metrics.update({"weights": "int8", "quantized_bytes": held,
                        "w8a16_launches_per_forward": 7 * cfg.num_layers + 1,
                        "model_forwards": forwards})
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


def serve_w8(torch, cuda, model, base: dict, base_outs: list) -> tuple[dict, object]:
    """Phase 4 ``paged_w8``: ``bf16``'s traffic on the engine built from a
    ``ModelSpec`` of phase 4's bf16 model with ``ENGINE_QUANTIZE=int8``
    (``serve`` with ``w8``), held as ``serve`` holds it (A, B, C and W8A16,
    W8A16 7 x 32 + 1 times a model forward, 64 tokens a request, the int8
    model's ``W8_BYTES``), the bf16 model left as it was. Printed beside the
    ``bf16`` run of the same call, not held (int8 weights move the logits):
    the share of requests whose tokens equal it, and tok/s and TTFT.
    Returns (the run's record, the int8 model, its pool freed)."""
    eng, counts, metrics, outs = serve(torch, cuda, model, w8=True)
    eng.stop()
    w8_model = eng.model
    del eng
    torch.cuda.empty_cache()
    agree = token_agreement(torch, model, phase4_prompts(torch, model.cfg.vocab_size), outs,
                            base_outs)
    metrics.update({"tokens_equal_bf16": agree["tokens_equal"],
                    "first_difference_vs_bf16": agree["first_difference"],
                    "margin_at_first_difference_bf16_model": agree["margin_at_first_difference"],
                    "bf16_decode_tok_s": base["decode_tok_s"],
                    "bf16_output_tok_s": base["output_tok_s"],
                    "bf16_ttft_p50_s": base["ttft_p50_s"], "bf16_ttft_max_s": base["ttft_max_s"]})
    return {"metrics": metrics, "launches": counts}, w8_model


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


def wait_idle(eng, timeout: float = 120.0, allow_dropped: bool = False) -> dict:
    """Wait until the engine has folded every call it dispatched (a
    speculative round can go out for a lane that an older round's fold then
    ends, and its launches are counted); returns ``pipeline_stats()``. A
    call settled without a fold fails the hold, unless ``allow_dropped``
    says that a crash in this run dropped the calls in flight."""
    deadline = time.monotonic() + timeout
    while True:
        st = eng.pipeline_stats()
        dropped = st["dropped"] if allow_dropped else 0
        require(allow_dropped or st["dropped"] == 0, f"calls dropped without a crash: {st}")
        if st["folds"] + dropped == sum(st["dispatched"].values()):
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


def profiled_wave(torch, eng, prompts: list, marks: list | None = None) -> dict:
    """Two waves after the timed ones, the second under torch.profiler:
    the device's busy ms (kernels and copies) over the second wave's
    window, its submit to its first tokens, and the idle share. ``marks``
    gets the window's start and end on the monotonic clock."""
    from torch.profiler import ProfilerActivity, profile

    per = PIPELINE["requests"] // PIPELINE["waves"]
    first = submit_wave(eng, prompts[:per])
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        if marks is not None:
            marks.append(time.monotonic())
        second = submit_wave(eng, prompts[per:2 * per])
        # the trace closes once the card has run what was launched in the
        # window, so the window ends there too
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
        if marks is not None:
            marks.append(time.monotonic())
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


def http_call(port: int, method: str, path: str, body: dict | None = None,
              headers: dict | None = None) -> tuple[int, dict, float, float, dict]:
    """One request on its own connection: (status, JSON body, client
    seconds, the monotonic time it started, the response's headers)."""
    import http.client

    t0 = time.monotonic()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=900)
    try:
        conn.request(method, path, body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        data = json.loads(resp.read())
        return resp.status, data, time.monotonic() - t0, t0, dict(resp.getheaders())
    finally:
        conn.close()


class AppThread:
    """An App's servers on an event loop of their own thread, as
    ``app.run()`` serves them; leaving the block stops the App (its servers,
    then the container: the engines and the tracer) and joins the thread."""

    def __init__(self, app, name: str):
        import asyncio
        import threading

        self.app, self.failed, self.ready = app, [], threading.Event()
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self._run, name=name, daemon=True)

    def _run(self) -> None:
        import asyncio

        async def main() -> None:
            started = asyncio.Event()
            task = asyncio.ensure_future(self.app.arun(ready=started))
            await started.wait()
            self.ready.set()
            await task

        try:
            self.loop.run_until_complete(main())
        except BaseException as e:  # noqa: BLE001 - reported by the caller
            self.failed.append(e)
            self.ready.set()
        finally:
            self.loop.close()

    def __enter__(self) -> "AppThread":
        self.thread.start()
        require(self.ready.wait(120) and not self.failed,
                f"{self.thread.name}: the App did not start: {self.failed}")
        return self

    def __exit__(self, *exc) -> None:
        self.loop.call_soon_threadsafe(self.app.stop)
        self.thread.join(120)
        require(not self.thread.is_alive() and not self.failed,
                f"{self.thread.name}: the App did not stop cleanly: {self.failed}")


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
    with AppThread(app, "http-generate"):
        port = app.http_port
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
    require(not engine._thread.is_alive(), "http_generate: the engine's thread outlived stop()")
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


# Phase 4's ``http_planes``: ``http_generate``'s App with the request planes
# on (``PLANES_CONFIG``: spans in memory, QoS with a tenant limit, the SLO
# engine and the debug routes) against ``HTTP_CONFIG`` alone (the planes a
# container always has: metrics, flight recorder, perf plane, SLO), in turns
# off, on, on, off. The engine serves the phase's bf16 model
# (``ModelSpec(weights=model)``, no second draw). Each arm sends
# ``phase4_prompts`` as batch work and, without waiting, the first 8 of
# ``pipeline_prompts`` as interactive work, 64 new tokens each.
PLANES_CONFIG = {**HTTP_CONFIG, "APP_ENV": "DEBUG", "TRACE_EXPORTER": "memory",
                 "SLO_ENABLED": "true", "QOS_ENABLED": "true", "QOS_TENANT_RPS": "1"}
PLANES_ARMS = ("off", "on", "on", "off")
PLANES_NEW = 64
# the tenant whose second request in a second is past QOS_TENANT_RPS
PLANES_TENANT = "burst"
SPAN_ORDER = ["engine.queue_wait", "engine.prefill", "engine.decode", "engine.finish"]
# the perf plane's MFU / MBU must read at most this (1 + a rounding margin)
PLANES_MAX_RATIO = 1.05


def scrape(port: int) -> dict[str, float]:
    """The metrics server's exposition: {series with its labels: value}."""
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=60) as r:
        text = r.read().decode()
    return {line.rpartition(" ")[0]: float(line.rpartition(" ")[2])
            for line in text.splitlines() if line and not line.startswith("#")}


def series_sum(metrics: dict, name: str, **labels: str) -> float:
    """The sum of ``name``'s series that carry ``labels``."""
    want = [f'{k}="{v}"' for k, v in labels.items()]
    return sum(v for k, v in metrics.items()
               if (k == name or k.startswith(name + "{")) and all(w in k for w in want))


def planes_arm(torch, cuda, model, arm: str, base_outs: list) -> dict:
    """One arm of ``http_planes``; the holds are ``http_planes``'."""
    import threading

    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.config import DictConfig
    from gofr_tpu_torch.models import ModelSpec

    on = arm == "on"
    vocab = model.cfg.vocab_size
    batch, others = phase4_prompts(torch, vocab), pipeline_prompts(torch, vocab)
    interactive, profiled = others[:8], others[PIPELINE["requests"]:]
    app = App(config=DictConfig(PLANES_CONFIG if on else HTTP_CONFIG))
    engine = app.serve_model("lm", ModelSpec("llama", model.cfg, weights=model,
                                             dtype=model.cfg.dtype), seed=SEED, eos_token_id=-1)
    require(engine.perf is not None and engine.flight is not None,
            f"http_planes {arm}: the engine has no perf plane or flight recorder")
    submitted, submit = [], engine.submit

    def record(*a, **kw):
        submitted.append(submit(*a, **kw))
        return submitted[-1]

    engine.submit = record

    async def generate(ctx):
        body = ctx.bind(dict)
        return await ctx.agenerate("lm", body["prompt"], max_new_tokens=int(body["max_new_tokens"]),
                                   timeout=body.get("timeout", 900))

    app.post("/generate", generate)
    out: dict = {"arm": arm}
    with AppThread(app, f"http-planes-{arm}"):
        port = app.http_port
        status, warm, *_ = http_call(port, "POST", "/generate",
                                     {"prompt": list(range(1, 65)), "max_new_tokens": 2})
        require(status == 201, f"http_planes {arm} warm-up: {status} {warm}")
        wait_idle(engine)
        if on:
            burst = [http_call(port, "GET", "/no/such/route", headers={"X-Tenant-ID": PLANES_TENANT})
                     for _ in range(2)]
            require(burst[0][0] == 404 and burst[1][0] == 429 and burst[1][1] == {
                "error": {"message": "rate limit exceeded; retry later"}}
                and burst[1][4].get("Retry-After") == "1",
                    f"http_planes: a tenant burst past QOS_TENANT_RPS: {[b[:2] for b in burst]} "
                    f"{burst[1][4]}")
        torch.cuda.synchronize()
        before, st0 = scrape(app.metrics_port), engine.pipeline_stats()
        cuda.reset_launch_counts()
        del submitted[:]
        replies: dict = {}

        def one(key, prompt, cls):
            replies[key] = http_call(port, "POST", "/generate",
                                     {"prompt": prompt, "max_new_tokens": PLANES_NEW},
                                     headers={"X-QoS-Class": cls})

        jobs = [(("batch", i), p, "batch") for i, p in enumerate(batch)] + [
            (("interactive", i), p, "interactive") for i, p in enumerate(interactive)]
        threads = [threading.Thread(target=one, args=job) for job in jobs]
        t_submit = time.monotonic()
        for th in threads:
            th.start()
        if on:
            # while the 16 queue, a request whose deadline is below the
            # predicted wait: the JAX verdict, 504 before it takes a slot
            # (qos/__init__.py: admit_engine)
            deadline, wait = time.monotonic() + 60, 0.0
            while wait <= 0 and time.monotonic() < deadline:
                wait = app.container.qos.predicted_wait(engine)
                time.sleep(0.001)
            require(wait > 0, "http_planes: the predicted wait stayed 0 while 16 requests queued")
            probe = http_call(port, "POST", "/generate", {
                "prompt": interactive[0][:100], "max_new_tokens": PLANES_NEW, "timeout": wait / 4},
                headers={"X-QoS-Class": "interactive"})
            require(probe[0] == 504 and probe[1]["error"]["message"].startswith(
                "predicted queue wait") and "Retry-After" not in probe[4],
                    f"http_planes: the request past its deadline: {probe[:2]} {probe[4]}")
            out["deadline_probe"] = {"predicted_wait_s": wait, "timeout_s": wait / 4,
                                     "status": probe[0], "message": probe[1]["error"]["message"]}
        for th in threads:
            th.join(900)
        st1 = wait_idle(engine)
        torch.cuda.synchronize()
        t_done = time.monotonic()
        counts = cuda.launch_counts()
        after = scrape(app.metrics_port)
        reqs = list(submitted)
        require(len(reqs) == len(jobs), f"http_planes {arm}: {len(reqs)} engine requests for "
                                        f"{len(jobs)} POSTs (the probe took a slot?)")
        for key, *_ in jobs:
            r = replies.get(key)
            require(r is not None and r[0] == 201 and len(r[1]["data"]["tokens"]) == PLANES_NEW
                    and r[1]["data"]["finish_reason"] == "length",
                    f"http_planes {arm} request {key}: {r and (r[0], r[1].get('error'))}")
        outs = {key: replies[key][1]["data"] for key, *_ in jobs}
        for name in ("app_tpu_ttft_seconds_count", "app_tpu_queue_wait_seconds_count"):
            n = series_sum(after, name) - series_sum(before, name)
            require(n == len(jobs), f"http_planes {arm}: {name} counted {n} samples")
        tokens = series_sum(after, "app_tpu_tokens_total") - series_sum(before, "app_tpu_tokens_total")
        want_tokens = sum(len(p) for _, p, _ in jobs) + len(jobs) * PLANES_NEW
        require(tokens == want_tokens, f"http_planes {arm}: app_tpu_tokens_total rose {tokens}, "
                                       f"prompts + folded tokens are {want_tokens}")
        for name, launches in counts.items():
            if name in ON_PATH["paged", ""]:
                require(launches > 0, f"kernel {name} was not launched on http_planes {arm}")
            else:
                require(launches == 0, f"kernel {name} was launched {launches} times on "
                                       f"http_planes {arm}")
        if on:
            out.update(planes_holds(app, jobs, replies, outs, after))
        turns = st1["busy_turns"] - st0["busy_turns"]
        req_of = {tuple(q.inputs): q for q in reqs}
        first = {key: req_of[tuple(p)].enqueued_at + outs[key]["ttft_s"] for key, p, _ in jobs}
        done = [first[k] + outs[k]["decode_s"] for k in first]
        out.update({
            "wall_s": t_done - t_submit, "requests": len(jobs),
            "ttft_p50_s": {c: sorted(o["ttft_s"] for k, o in outs.items() if k[0] == c)[4]
                           for c in ("batch", "interactive")},
            "decode_tok_s": sum(len(o["tokens"]) - 1 for o in outs.values())
            / (max(done) - min(first.values())),
            "host_ms_per_busy_turn": (st1["busy_turn_s"] - st0["busy_turn_s"]) / turns * 1e3,
            "busy_turns": turns, "launches": counts,
            **{f"batch_{k}": v for k, v in token_agreement(
                torch, model, batch, [outs["batch", i] for i in range(len(batch))],
                base_outs).items()},
        })
        gaps = [m["chosen_below_top1"] for m in out["batch_margin_at_first_difference"] if m]
        require(all(gap <= SPEC_TIE_GAP for gap in gaps),
                f"http_planes {arm}: at a first difference from the bf16 run the token lies "
                f"{gaps} below the top logit (limit {SPEC_TIE_GAP})")
        out.update(plane_vs_profiler(torch, engine, profiled))
    tracer_worker = app.container.tracer._worker
    require(not engine._thread.is_alive() and (tracer_worker is None or not tracer_worker.is_alive()),
            f"http_planes {arm}: the engine's or the tracer's thread outlived stop()")
    del engine, app
    torch.cuda.empty_cache()
    return out


def planes_holds(app, jobs, replies, outs, metrics) -> dict:
    """The on arm's holds on the planes themselves: each request's trace,
    its flight entry, the steps, the perf plane's ratios, the QoS and SLO
    series, and health."""
    spans = list(app.container.tracer._exporter.spans)
    port = app.http_port
    for key, *_ in jobs:
        tid = replies[key][4].get("X-Trace-Id")
        servers = [s for s in spans if s.trace_id == tid and s.kind == "SERVER"]
        require(len(servers) == 1, f"http_planes {key}: {len(servers)} server spans for X-Trace-Id "
                                   f"{tid}")
        children = sorted((s for s in spans if s.parent_id == servers[0].span_id),
                          key=lambda s: s.start)
        require([s.name for s in children] == SPAN_ORDER and all(
            s.trace_id == tid for s in children),
                f"http_planes {key}: engine spans {[s.name for s in children]}")
    _, flight, *_ = http_call(port, "GET", "/debug/requests?n=256")
    by_trace = {e["trace_id"]: e for e in flight["data"]["requests"]}
    ttft_gap = []
    for key, *_ in jobs:
        entry = by_trace.get(replies[key][4]["X-Trace-Id"])
        require(entry is not None, f"http_planes {key}: no /debug/requests entry")
        ttft_gap.append(abs(entry["ttft_s"] - outs[key]["ttft_s"]))
    require(max(ttft_gap) <= 1e-3, f"http_planes: flight ttft_s vs the result's, gaps {ttft_gap}")
    _, steps, *_ = http_call(port, "GET", "/debug/engine?n=512")
    kinds = {s["kind"] for s in steps["data"]["steps"]}
    require({"prefill", "decode"} <= kinds, f"http_planes: /debug/engine step kinds {kinds}")
    _, perf, *_ = http_call(port, "GET", "/debug/perf")
    plane = perf["data"]["engines"]["lm"]
    mbu = plane["kinds"]["decode"]["mbu"]
    mfu = plane["kinds"]["prefill"]["mfu"]
    require(plane["peaks"]["flops"] == 989e12 and plane["peaks"]["hbm_bytes_per_s"] == 3.35e12,
            f"http_planes: /debug/perf peaks {plane['peaks']} (device {plane['device_kind']})")
    require(mbu is not None and 0 < mbu <= PLANES_MAX_RATIO and mfu is not None
            and 0 < mfu <= PLANES_MAX_RATIO, f"http_planes: decode MBU {mbu}, prefill MFU {mfu}")
    admitted = series_sum(metrics, "app_qos_admitted_total")
    require(admitted >= len(jobs), f"http_planes: app_qos_admitted_total {admitted}")
    for cls in ("batch", "interactive"):
        require(any(k.startswith("app_slo_attainment{") and f'class="{cls}"' in k
                    for k in metrics), f"http_planes: no app_slo_attainment series for {cls}")
    _, health, *_ = http_call(port, "GET", "/.well-known/health")
    require({"qos", "slo", "model:lm"} <= set(health["data"]["services"]),
            f"http_planes: health lists {sorted(health['data']['services'])}")
    return {"plane_decode_mbu": mbu, "plane_prefill_mfu": mfu,
            "plane_bubble_ratio": plane["bubble"]["ratio"],
            "flight_ttft_gap_max_s": max(ttft_gap), "qos_admitted": admitted,
            "health": health["data"]["status"], "step_kinds": sorted(kinds)}


def plane_vs_profiler(torch, engine, prompts: list) -> dict:
    """Over ``profiled_wave``'s window: the perf plane's device seconds per
    step (residency, dispatch to readback, clipped) and the MBU it gives,
    beside torch.profiler's device busy per step and the MBU that gives,
    the same steps' bytes over the H100's 3.35 TB/s."""
    from gofr_tpu_torch.metrics.perf import H100_SXM_HBM_BYTES_PER_S

    noted, note, marks = [], engine.perf.note, []

    def recording(p, now, band=None):
        out = note(p, now, band)
        noted.append((now, p.kind, p.device_s, p.bytes))
        return out

    engine.perf.note = recording
    try:
        wave = profiled_wave(torch, engine, prompts, marks)
    finally:
        engine.perf.note = note
    steps = [n for n in noted if marks[0] <= n[0] <= marks[1]]
    decode = [n for n in steps if n[1] == "decode"]
    plane_s = sum(n[2] for n in steps)
    busy_s = wave["profiled_wave_device_busy_ms"] / 1e3
    nbytes = sum(n[3] for n in steps)
    return {**wave, "window_steps": len(steps), "window_decode_steps": len(decode),
            "plane_device_ms_per_step": plane_s / len(steps) * 1e3 if steps else None,
            "plane_decode_device_ms_per_step": (sum(n[2] for n in decode) / len(decode) * 1e3
                                                if decode else None),
            "profiler_busy_ms_per_step": busy_s / len(steps) * 1e3 if steps else None,
            "plane_mbu": nbytes / plane_s / H100_SXM_HBM_BYTES_PER_S if plane_s else None,
            "profiler_mbu": (nbytes / busy_s / H100_SXM_HBM_BYTES_PER_S
                             if busy_s and wave["profiled_wave_device_idle_share"] is not None
                             else None)}


def http_planes(torch, cuda, model, base_outs: list) -> dict:
    """Phase 4 ``http_planes``: the arms in turns ``PLANES_ARMS``. Held in
    every arm: each of the 16 POSTs answers 201 with 64 tokens; the 8 batch
    requests' tokens agree with the ``bf16`` run's by the tie rule;
    ``app_tpu_ttft_seconds`` and ``app_tpu_queue_wait_seconds`` take 16
    samples; ``app_tpu_tokens_total`` rises by the prompts' tokens plus the
    64 each request's folds emitted; the launch counters show ``bf16``'s
    kernels and no other; after ``stop`` the engine's and the tracer's
    threads have ended. Held in the on arm: a tenant's second request in a
    second answers 429 with ``Retry-After`` and the envelope; a request
    sent while the 16 queue, its deadline a quarter of the predicted wait,
    answers 504 (the JAX verdict) and takes no slot; each request's trace
    (``X-Trace-Id``) has the server span with ``engine.queue_wait``,
    ``engine.prefill``, ``engine.decode`` and ``engine.finish`` under it in
    that order; each has a ``/debug/requests`` entry whose ``ttft_s`` is
    its result's within 1 ms; ``/debug/engine`` has prefill and decode
    steps; ``/debug/perf`` prices against the H100 row, decode MBU and
    prefill MFU in (0, 1.05]; ``app_qos_admitted_total`` >= 16;
    ``app_slo_attainment`` has both classes; health lists ``qos`` and
    ``slo``. Printed: TTFT p50 by class, decode tok/s, host ms per busy loop
    turn, and over one profiled wave the plane's device ms per step and MBU
    beside the profiler's."""
    arms = [planes_arm(torch, cuda, model, arm, base_outs) for arm in PLANES_ARMS]
    return {"model": "llama3_8b (random bf16 weights, seed 0)", "order": list(PLANES_ARMS),
            "config_on": PLANES_CONFIG, "arms": arms, "nvidia_smi": smi_line(),
            "note": "an A/B in one call, not a benchmark; nothing about speed is held"}


# Phase 4's life cycle and quality runs. ``paged_restart``: ``bf16``'s
# knobs and model with one host-side fault planted in the decode dispatch
# once the 8 requests are all in slots; the loop fails them, backs off,
# restarts and serves the same 8 prompts submitted after the fault.
# ``paged_quality`` / ``int8_quality``: ``bf16``'s and ``int8``'s pools
# with ``QUALITY_CONFIG`` (every finished request shadow-scored, up to 64
# emitted tokens), and on the bf16 pool an SLO capture with a trace and a
# ``/debug/profile`` through the App. ``cold_start``: two fresh processes of
# ``scripts/torch_cold_start.py``.
RESTART_FAULT = "planted host-side fault in the decode dispatch"
QUALITY_CONFIG = {**HTTP_CONFIG, "QUALITY_SHADOW_RATE": "1", "QUALITY_MAX_TOKENS": "64"}
# the capture run: an interactive TTFT objective of 1 ms that no request
# meets, judged from the first sample on (the other latency objectives
# off, so no other sample breaches first); the wave's second half is sent
# once the capture's trace runs, so the trace takes its prefill and decode
CAPTURE_CONFIG = {"APP_ENV": "DEBUG", "SLO_CAPTURE": "true", "SLO_CAPTURE_TRACE_S": "3",
                  "SLO_INTERACTIVE_TTFT_MS": "1", "SLO_MIN_SAMPLES": "1",
                  "SLO_CHECK_INTERVAL_S": "0",
                  **{f"SLO_{cls}_{obj}_MS": "0" for cls, obj in (
                      ("DEFAULT", "TTFT"), ("DEFAULT", "TPOT"), ("DEFAULT", "E2E"),
                      ("INTERACTIVE", "TPOT"), ("INTERACTIVE", "E2E"))}}
PROFILE_S = 2
# the kernels' names in a trace: C and, on the bf16 pool, A
TRACE_KERNELS = {"flash_attention": "flash_kernel", "paged_decode": "paged_decode_kernel"}
COLD_START = {"layers": 2, "prompt": 512, "new": 16}


def serve_warmup(torch, cuda, model, base_outs: list) -> dict:
    """Phase 4 ``paged_warmup``: ``bf16``'s knobs and model; a 300-token
    request leaves two pages in the prefix cache, then ``warmup()``. Held:
    it runs JAX's count for the knobs (every length bucket x batch bucket,
    every chunk, one decode chunk), launches A, B and C and no other
    kernel, and leaves the pool's bytes, refcounts, free list, table and
    prefix cache as they were and the pool's audit clean; then ``bf16``'s 8
    prompts end with 64 tokens, equal to ``bf16``'s (a cold engine's) by
    the tie rule. Printed: warmup's seconds and count."""
    from gofr_tpu_torch.gpu.engine import build_engine
    from gofr_tpu_torch.gpu.planner import pow2_buckets

    eng = build_engine(model.cfg, params=model, device="cuda", seed=SEED, slots=8, max_len=2048,
                       max_prefill_batch=4, decode_chunk=8)
    prompts = phase4_prompts(torch, model.cfg.vocab_size)
    try:
        first = eng.generate(list(range(1, 301)), max_new_tokens=2, timeout=600)
        require(first["finish_reason"] == "length", f"paged_warmup first request: {first}")
        wait_idle(eng)
        torch.cuda.synchronize()
        pool = [t.clone() for t in vars(eng.cache).values()]
        books = (eng._page_refs.copy(), eng._table.copy(), sorted(eng._free_pages),
                 sorted(eng._prefix._nodes))
        require(books[3], "paged_warmup: the prefix cache holds nothing to keep")
        cuda.reset_launch_counts()
        t0 = time.perf_counter()
        count = eng.warmup()
        warm_s = time.perf_counter() - t0
        counts = cuda.launch_counts()
        same_pool = all(torch.equal(a, b) for a, b in zip(pool, vars(eng.cache).values()))
        del pool
        after = (eng._page_refs, eng._table, sorted(eng._free_pages), sorted(eng._prefix._nodes))
        same_books = (all((a == b).all() for a, b in zip(books[:2], after[:2]))
                      and books[2:] == after[2:])
        eng.check_page_refs()
        reqs = [eng.submit(p, max_new_tokens=64) for p in prompts]
        outs = [r.result(timeout=900) for r in reqs]
        wait_idle(eng)
    finally:
        eng.stop()
    del eng
    torch.cuda.empty_cache()
    want = len(pow2_buckets(16, 2048)) * (len(pow2_buckets(1, 4)) + 1) + 1
    require(count == want, f"paged_warmup: warmup ran {count} calls, JAX's count is {want}")
    require(same_pool and same_books,
            f"paged_warmup: warmup changed the pool's bytes ({not same_pool}) or its books "
            f"({not same_books})")
    for name, launches in counts.items():
        require((launches > 0) == (name in ON_PATH["paged", ""]),
                f"paged_warmup: warmup launched kernel {name} {launches} times")
    for i, o in enumerate(outs):
        require(o["finish_reason"] == "length" and len(o["tokens"]) == 64,
                f"paged_warmup request {i}: {o['finish_reason']}, {len(o['tokens'])} tokens")
    agree = token_agreement(torch, model, prompts, outs, base_outs)
    gaps = [m["chosen_below_top1"] for m in agree["margin_at_first_difference"] if m]
    require(all(gap <= SPEC_TIE_GAP for gap in gaps),
            f"paged_warmup: at a first difference from bf16 the run chose a token {gaps} below "
            f"the top logit (limit {SPEC_TIE_GAP})")
    return {"model": "llama3_8b (random bf16 weights, seed 0)", "kv_pool": "bf16",
            "warmup_s": warm_s, "warmup_count": count, "warmup_launches": counts,
            "pool_unchanged": same_pool, "books_unchanged": same_books, **agree,
            "nvidia_smi": smi_line()}


def serve_restart(torch, cuda, model, base_outs: list) -> dict:
    """Phase 4 ``paged_restart``. Held: the 8 slot-resident requests fail
    with the planted error; health reads DEGRADED with ``restarting`` inside
    the backoff (read from the restart hook); the 8 prompts submitted after
    the fault all end with 64 tokens, equal to the ``bf16`` run's by the tie
    rule; ``app_tpu_engine_restarts`` is 1, health UP with ``restarts`` 1,
    the pool's audit passes; A, B and C launch and no other kernel. Printed:
    the seconds from the fault to the first token served after it."""
    from gofr_tpu_torch.config import DictConfig
    from gofr_tpu_torch.container import Container
    from gofr_tpu_torch.gpu import decode
    from gofr_tpu_torch.gpu.engine import GenerateEngine

    c = Container.create(DictConfig({"LOG_LEVEL": "ERROR"}))
    eng = GenerateEngine(model, device="cuda", seed=SEED, slots=8, max_len=2048,
                         max_prefill_batch=4, decode_chunk=8, container=c)
    prompts = phase4_prompts(torch, model.cfg.vocab_size)
    real, fault, seen = decode.dispatch_decode, {}, []

    def planted(e):
        if not fault and len(e._active()) == len(prompts):
            fault["t"] = time.monotonic()
            raise RuntimeError(RESTART_FAULT)
        return real(e)

    eng._restart_hook = lambda attempt: seen.append(eng.health_check())
    try:
        warm = eng.generate(list(range(1, 65)), max_new_tokens=2, timeout=600)
        require(warm["finish_reason"] == "length", f"paged_restart warm-up: {warm}")
        wait_idle(eng)
        torch.cuda.synchronize()
        cuda.reset_launch_counts()
        decode.dispatch_decode = planted
        try:
            first, errors = [eng.submit(p, max_new_tokens=64) for p in prompts], []
            for r in first:
                try:
                    r.result(timeout=900)
                    errors.append(None)
                except RuntimeError as e:
                    errors.append(str(e))
            t_resubmit = time.monotonic()
            second = [eng.submit(p, max_new_tokens=64) for p in prompts]
            outs = [r.result(timeout=900) for r in second]
        finally:
            decode.dispatch_decode = real
        wait_idle(eng, allow_dropped=True)
        torch.cuda.synchronize()
        counts = cuda.launch_counts()
        health = eng.health_check()
        st = eng.pipeline_stats()
        eng.check_page_refs()
        restarts = c.metrics.get("app_tpu_engine_restarts").value()
    finally:
        eng.stop()
    del eng
    torch.cuda.empty_cache()
    require(errors == [RESTART_FAULT] * len(prompts),
            f"paged_restart: the slot-resident requests ended {errors}")
    require(seen[:1] == [{"status": "DEGRADED", "details": {"restarting": True, "restarts": 1}}],
            f"paged_restart: health inside the backoff read {seen}")
    require(restarts == 1 and health == {"status": "UP",
                                         "details": {"queue_depth": 0, "restarts": 1}},
            f"paged_restart: {restarts} restarts, health {health}")
    for i, o in enumerate(outs):
        require(o["finish_reason"] == "length" and len(o["tokens"]) == 64,
                f"paged_restart request {i} after the fault: {o['finish_reason']}, "
                f"{len(o['tokens'])} tokens")
    for name, launches in counts.items():
        on = name in ON_PATH["paged", ""]
        require((launches > 0) == on, f"paged_restart: kernel {name} launched {launches} times")
    agree = token_agreement(torch, model, prompts, outs, base_outs)
    gaps = [m["chosen_below_top1"] for m in agree["margin_at_first_difference"] if m]
    require(all(gap <= SPEC_TIE_GAP for gap in gaps),
            f"paged_restart: at a first difference from bf16 the run chose a token {gaps} below "
            f"the top logit (limit {SPEC_TIE_GAP})")
    first_token = min(r.enqueued_at + o["ttft_s"] for r, o in zip(second, outs))
    return {"model": "llama3_8b (random bf16 weights, seed 0)", "kv_pool": "bf16",
            "fault": RESTART_FAULT, "failed_in_slots": len(errors),
            "health_in_backoff": seen[0], "health_after": health, "restarts": restarts,
            "resubmitted_after_fault_s": t_resubmit - fault["t"],
            "fault_to_first_token_s": first_token - fault["t"],
            "ttft_after_fault_s": sorted(o["ttft_s"] for o in outs),
            "host_ms_per_busy_turn": st["busy_turn_s"] / st["busy_turns"] * 1e3,
            "busy_turns": st["busy_turns"], "calls_dropped": st["dropped"],
            "launches": counts, **agree, "nvidia_smi": smi_line()}


# Phase 4's ``paged_control``: ``bf16``'s pool from a ``ModelSpec`` with the
# step controller on (``CONTROL_CONFIG``: a tick every 0.5 s on at least 4
# steps; sustain, cooldown and backoff keep their interval-scaled defaults),
# served by the App under ``APP_ENV=DEBUG`` for ``/debug/control``.
CONTROL_CONFIG = {**HTTP_CONFIG, "APP_ENV": "DEBUG", "CONTROL_ENABLE": "1",
                  "CONTROL_INTERVAL_S": "0.5", "CONTROL_MIN_STEPS": "4"}
CONTROL_TRAFFIC_S = 15.0
# the drill's knob moves, restored to the boot values in the next wave
CONTROL_DRILL = {"pipeline_depth": 1, "prefill_chunk": 128, "prefill_batch": 1}
CONTROL_SPEC_G = (SPEC_G, 2)


def knob_envelope(eng) -> dict:
    """Each knob's allowed values: 1 up to the boot value, a bucket for
    ``prefill_chunk``."""
    env = {"pipeline_depth": set(range(1, eng._boot_pipeline_depth + 1)),
           "prefill_chunk": set(eng.prefill_buckets),
           "prefill_batch": set(range(1, eng._boot_prefill_batch + 1))}
    if eng._boot_spec_tokens:
        env["spec_tokens"] = set(range(1, eng._boot_spec_tokens + 1))
    return env


def hold_knobs(label: str, eng, flight) -> dict:
    """Every decision's and every flight step's knob values within the
    engine's boot envelope; returns the knob values the steps ran under."""
    env = knob_envelope(eng)
    for d in flight.controls():
        if d.get("knob"):
            require(d["from"] in env[d["knob"]] and d["to"] in env[d["knob"]],
                    f"{label}: decision {d} moves {d['knob']} outside {sorted(env[d['knob']])}")
    seen: dict = {k: set() for k in env}
    for st in flight.steps():
        knobs = st.get("knobs")
        require(knobs is not None and set(knobs) == set(env),
                f"{label}: a flight step without the knob vector: {st}")
        for k, v in knobs.items():
            require(v in env[k], f"{label}: a step ran at {k}={v}, outside {sorted(env[k])}")
            seen[k].add(v)
    return {k: sorted(v) for k, v in seen.items()}


def timed_ticks(ctl) -> list:
    """Wrap the controller's evaluating tick (``maybe_tick`` between ticks
    returns at once) so each one's host seconds are kept."""
    spent, tick = [], ctl._tick

    def timed(now):
        t0 = time.perf_counter()
        try:
            return tick(now)
        finally:
            spent.append(time.perf_counter() - t0)

    ctl._tick = timed
    return spent


def drill_wave(eng, prompts: list, knobs: dict) -> list:
    """Submit ``prompts``, queue ``knobs`` once half of them are in, and
    return the results."""
    reqs = []
    for i, p in enumerate(prompts):
        reqs.append(eng.submit(p, max_new_tokens=64))
        if i == len(prompts) // 2 - 1:
            eng.request_knobs(**knobs)
    return [r.result(timeout=900) for r in reqs]


def hold_tie(label: str, torch, model, prompts, outs, want) -> dict:
    """Every request 64 tokens; tokens against ``want`` by the tie rule."""
    for i, o in enumerate(outs):
        require(o["finish_reason"] == "length" and len(o["tokens"]) == 64,
                f"{label} request {i}: {o['finish_reason']}, {len(o['tokens'])} tokens")
    agree = token_agreement(torch, model, prompts, outs, want)
    gaps = [m["chosen_below_top1"] for m in agree["margin_at_first_difference"] if m]
    require(all(gap <= SPEC_TIE_GAP for gap in gaps),
            f"{label}: at a first difference the run chose a token {gaps} below the top logit "
            f"(limit {SPEC_TIE_GAP})")
    return agree


def serve_control(torch, cuda, model, base_outs: list) -> dict:
    """Phase 4 ``paged_control``. ``paged_pipeline``'s 16 prompts in waves of
    4 for ``CONTROL_TRAFFIC_S`` with the controller on, then the drill: a
    wave of ``bf16``'s 8 prompts with ``CONTROL_DRILL`` queued after the
    fourth, and the next wave of the same prompts with the boot values
    queued there; then, on a second engine of the same config with
    ``ENGINE_SPEC_TOKENS=4``, ``bf16``'s 8 prompts with ``spec_tokens`` moved
    to 2 after the fourth. Held: at least one ``try`` and one ``commit`` or
    ``revert``; every knob value in every decision and flight step within
    the boot envelope (1..boot, a bucket for the chunk size); each drill
    wave's and the spec wave's tokens equal to ``bf16``'s by the tie rule;
    the spec engine's steps ran at g 2 after the move; no call dropped and
    both pools' audits clean; ``app_tpu_control_decisions_total`` equal to
    the flight ring's count; A, B and C launch on the first engine and no
    other kernel, C alone on the spec engine. Printed: the decisions, the
    host ms of a controller tick, ``/debug/control``'s payload size."""
    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.config import DictConfig
    from gofr_tpu_torch.container import Container
    from gofr_tpu_torch.gpu.engine import build_engine
    from gofr_tpu_torch.models import ModelSpec

    vocab = model.cfg.vocab_size
    traffic, drill = pipeline_prompts(torch, vocab)[:PIPELINE["requests"]], phase4_prompts(
        torch, vocab)
    spec = ModelSpec("llama", model.cfg, weights=model, dtype=model.cfg.dtype)
    app = App(config=DictConfig(CONTROL_CONFIG))
    eng = app.serve_model("lm", spec, seed=SEED, eos_token_id=-1)
    require(eng._control is not None, "paged_control: CONTROL_ENABLE=1 built no controller")
    ticks = timed_ticks(eng._control)
    boot = dict(eng.knob_vector())
    out: dict = {"model": "llama3_8b (random bf16 weights, seed 0)", "kv_pool": "bf16",
                 "config": {k: v for k, v in CONTROL_CONFIG.items() if k.startswith("CONTROL")},
                 "boot_knobs": boot}
    with AppThread(app, "paged-control"):
        warm = eng.generate(list(range(1, 65)), max_new_tokens=2, timeout=600)
        require(warm["finish_reason"] == "length", f"paged_control warm-up: {warm}")
        wait_idle(eng)
        torch.cuda.synchronize()
        cuda.reset_launch_counts()
        per, t0, waves, reqs = PIPELINE["requests"] // PIPELINE["waves"], time.monotonic(), 0, []
        while time.monotonic() - t0 < CONTROL_TRAFFIC_S:
            w = waves % PIPELINE["waves"]
            reqs += submit_wave(eng, traffic[w * per:(w + 1) * per])
            waves += 1
        traffic_outs = [r.result(timeout=900) for r in reqs]
        traffic_s = time.monotonic() - t0
        drilled = drill_wave(eng, drill, CONTROL_DRILL)
        restored = drill_wave(eng, drill, boot)
        st = wait_idle(eng)
        torch.cuda.synchronize()
        counts = cuda.launch_counts()
        eng.check_page_refs()
        status, payload, *_ = http_call(app.http_port, "GET", "/debug/control")
        require(status == 200, f"paged_control: /debug/control answered {status}")
    # the engine stopped with the App: the ring and the counter hold still
    decisions = app.container.flight.controls()
    counted = sum(app.container.metrics.get("app_tpu_control_decisions_total")._values.values())
    seen = hold_knobs("paged_control", eng, app.container.flight)
    final = eng.knob_vector()
    del eng, app
    torch.cuda.empty_cache()
    verdicts = [d["verdict"] for d in decisions]
    require("try" in verdicts and ("commit" in verdicts or "revert" in verdicts),
            f"paged_control: the decisions were {verdicts}")
    require(counted == len(decisions),
            f"paged_control: app_tpu_control_decisions_total counted {counted}, the ring holds "
            f"{len(decisions)}")
    # newest first: decisions made after the GET lead the ring
    shown = payload["data"]["decisions"]
    require(payload["data"]["engines"]["lm"]["enabled"] is True and shown
            and shown == decisions[len(decisions) - len(shown):],
            "paged_control: /debug/control's decisions differ from the flight ring")
    require(st["dropped"] == 0, f"paged_control: calls dropped {st}")
    for i, o in enumerate(traffic_outs):
        require(o["finish_reason"] == "length" and len(o["tokens"]) == PIPELINE["new_tokens"],
                f"paged_control traffic request {i}: {o['finish_reason']}")
    for name, launches in counts.items():
        require((launches > 0) == (name in ON_PATH["paged_control"]),
                f"paged_control: kernel {name} launched {launches} times")
    out.update({
        "traffic_s": traffic_s, "traffic_waves": waves, "traffic_requests": len(traffic_outs),
        "decisions": decisions, "verdicts": {v: verdicts.count(v) for v in sorted(set(verdicts))},
        "decisions_counted": counted, "ticks": len(ticks),
        "tick_host_ms": {"mean": sum(ticks) / len(ticks) * 1e3, "max": max(ticks) * 1e3}
        if ticks else None,
        "debug_control_bytes": len(json.dumps(payload).encode()),
        "knob_values_stepped": seen, "final_knobs": final,
        "drill": {k: v for k, v in hold_tie("paged_control drill", torch, model, drill, drilled,
                                            base_outs).items()
                  if k != "margin_at_first_difference"},
        "restored": {k: v for k, v in hold_tie("paged_control restore", torch, model, drill,
                                               restored, base_outs).items()
                     if k != "margin_at_first_difference"},
        "launches": counts})
    # the spec engine: g moved from 4 to 2 in the middle of a wave
    c = Container(DictConfig({**CONTROL_CONFIG, "ENGINE_SPEC_TOKENS": str(CONTROL_SPEC_G[0]),
                              "LOG_LEVEL": "ERROR"}))
    eng = build_engine(spec, c, device="cuda", seed=SEED, eos_token_id=-1)
    try:
        warm = eng.generate(list(range(1, 65)), max_new_tokens=2, timeout=600)
        require(warm["finish_reason"] == "length", f"paged_control spec warm-up: {warm}")
        wait_idle(eng)
        torch.cuda.synchronize()
        cuda.reset_launch_counts()
        spec_outs = drill_wave(eng, drill, {"spec_tokens": CONTROL_SPEC_G[1]})
        st = wait_idle(eng)
        torch.cuda.synchronize()
        spec_counts = cuda.launch_counts()
        eng.check_page_refs()
        spec_seen = hold_knobs("paged_control spec", eng, c.flight)
        spec_decisions = c.flight.controls()
    finally:
        eng.stop()
    del eng
    torch.cuda.empty_cache()
    require(st["dropped"] == 0, f"paged_control spec: calls dropped {st}")
    require(CONTROL_SPEC_G[1] in spec_seen["spec_tokens"],
            f"paged_control spec: no step ran at g {CONTROL_SPEC_G[1]}: {spec_seen}")
    for name, launches in spec_counts.items():
        require((launches > 0) == (name in ON_PATH["paged_control_spec"]),
                f"paged_control spec: kernel {name} launched {launches} times")
    out["spec"] = {"boot_g": CONTROL_SPEC_G[0], "moved_to": CONTROL_SPEC_G[1],
                   "knob_values_stepped": spec_seen, "decisions": spec_decisions,
                   **{k: v for k, v in hold_tie("paged_control spec", torch, model, drill,
                                                spec_outs, base_outs).items()
                      if k != "margin_at_first_difference"},
                   "launches": spec_counts}
    out["nvidia_smi"] = smi_line()
    return out


# Phase 4's ``paged_handoff``: a prefill worker and a decode worker of
# ``bf16``'s knobs in one process on one card, both on the phase's model,
# built from a ``ModelSpec`` and their ``ENGINE_ROLE`` / ``HANDOFF_*``
# config. The decode worker's host tier is ``HANDOFF_DECODE_HOST_MB``: the
# default 256 MiB holds 16 of Llama-3-8B's 16 MiB bf16 pages, and the 8
# prompts ship 32. Each arm: its prompts at once to the prefill worker,
# then the same prompts at once to the decode worker.
HANDOFF_BASE = {"LOG_LEVEL": "ERROR", "ENGINE_SLOTS": "8", "ENGINE_MAX_LEN": "2048",
                "ENGINE_PREFILL_BATCH": "4", "ENGINE_DECODE_CHUNK": "8"}
HANDOFF_DECODE_HOST_MB = 1024
HANDOFF_LONG = {"prompts": 2, "tokens": 1536, "buckets": [128, 256, 512]}
HANDOFF_ARMS = {
    "stream": {"HANDOFF_STREAMS": "2", "HANDOFF_CHUNK_PAGES": "4"},
    "blob": {"HANDOFF_STREAMS": "0"},
    "int8_stream": {"HANDOFF_STREAMS": "2", "HANDOFF_CHUNK_PAGES": "4", "ENGINE_KV_DTYPE": "int8"},
    "long_stream": {"HANDOFF_STREAMS": "2", "HANDOFF_CHUNK_PAGES": "4"},
}


def long_prompts(torch, vocab: int) -> list[list[int]]:
    rng = torch.Generator().manual_seed(SEED + 9)
    return [torch.randint(0, vocab, (HANDOFF_LONG["tokens"],), generator=rng).tolist()
            for _ in range(HANDOFF_LONG["prompts"])]


def handoff_arm(torch, cuda, model, arm: str, prompts: list, want: list) -> dict:
    """One arm of ``paged_handoff``; returns its numbers, holds inside."""
    from gofr_tpu_torch.config import DictConfig
    from gofr_tpu_torch.container import Container
    from gofr_tpu_torch.gpu.engine import build_engine
    from gofr_tpu_torch.models import ModelSpec

    spec = ModelSpec("llama", model.cfg, weights=model, dtype=model.cfg.dtype)
    kw = {"prefill_buckets": HANDOFF_LONG["buckets"]} if arm == "long_stream" else {}
    conf = {**HANDOFF_BASE, **HANDOFF_ARMS[arm]}
    page = 128
    n_pages = [len(p) // page for p in prompts]
    dec = build_engine(spec, Container(DictConfig({**conf, "ENGINE_ROLE": "decode",
                                                   "ENGINE_PREFIX_HOST_MB": str(
                                                       HANDOFF_DECODE_HOST_MB)})),
                       device="cuda", seed=SEED, eos_token_id=-1, **kw)
    pre = None
    try:
        pre = build_engine(spec, Container(DictConfig({**conf, "ENGINE_ROLE": "prefill",
                                                       "HANDOFF_TARGET": dec.handoff_addr})),
                           device="cuda", seed=SEED, eos_token_id=-1, **kw)
        require(pre.role == "prefill" and dec.role == "decode" and pre._handoff_exporter,
                f"paged_handoff {arm}: the workers' roles {pre.role}/{dec.role}")
        for e in (pre, dec):
            warm = e.generate(list(range(1, 65)), max_new_tokens=2, timeout=600)
            require(warm["finish_reason"] == "length", f"paged_handoff {arm} warm-up: {warm}")
            wait_idle(e)
        kicks, kick = [], pre._handoff_exporter.kick
        pre._handoff_exporter.kick = lambda t: (kicks.append(t.staged_pages), kick(t))
        torch.cuda.synchronize()
        cuda.reset_launch_counts()
        t0 = time.monotonic()
        first = [r.result(timeout=900) for r in [pre.submit(p, max_new_tokens=64)
                                                 for p in prompts]]
        pre_s = time.monotonic() - t0
        wait_idle(pre)
        torch.cuda.synchronize()
        pre_counts = cuda.launch_counts()
        exported = pre._handoff_exporter.stats()
        imported = dec._handoff_server.stats()
        pinned = all(t.is_pinned() for node in dec._prefix._nodes.values() if node.page_id < 0
                     for t in node.host)
        host_pages = dec._prefix.host_pages
        perf = pre.perf.window_totals(time.monotonic())["kinds"]
        seconds = pre.metrics.get("app_tpu_kv_handoff_seconds")
        cuda.reset_launch_counts()
        t0 = time.monotonic()
        outs = [r.result(timeout=900) for r in [dec.submit(p, max_new_tokens=64)
                                                for p in prompts]]
        dec_s = time.monotonic() - t0
        wait_idle(dec)
        torch.cuda.synchronize()
        dec_counts = cuda.launch_counts()
        pre.check_page_refs()
        dec.check_page_refs()
        page_bytes = dec._page_bytes
    finally:
        if pre is not None:
            pre.stop()
        dec.stop()
    del pre, dec
    torch.cuda.empty_cache()
    label = f"paged_handoff {arm}"
    for i, (o, n) in enumerate(zip(first, n_pages)):
        if n:
            require(o["finish_reason"] == "handoff" and len(o["tokens"]) == 1,
                    f"{label} prefill request {i} ({len(prompts[i])} tokens): "
                    f"{o['finish_reason']}, {len(o['tokens'])} tokens")
        else:
            require(o["finish_reason"] == "length" and len(o["tokens"]) == 64,
                    f"{label} prefill request {i} (under a page): served {o['finish_reason']}")
    firsts = token_agreement(torch, model, prompts, first, want)
    gaps = [m["chosen_below_top1"] for m in firsts["margin_at_first_difference"] if m]
    require(all(gap <= SPEC_TIE_GAP for gap in gaps),
            f"{label}: a prefill worker's first token lies {gaps} below the top logit")
    agree = hold_tie(f"{label} decode", torch, model, prompts, outs, want)
    pages = sum(n_pages)
    require(exported["exported"] == sum(1 for n in n_pages if n) and exported["failed"] == 0
            and exported["pages"] == pages,
            f"{label}: exported {exported}, want {pages} pages")
    require(imported["imported"] == exported["exported"] and imported["pages"] == pages
            and imported["bytes"] == pages * page_bytes and host_pages == pages,
            f"{label}: imported {imported} ({host_pages} host pages), want {pages} pages of "
            f"{page_bytes} B")
    require(pinned, f"{label}: the imported pages are not in pinned host memory")
    hit = sum(o["prefix_host_tokens"] for o in outs)
    want_hit = page * sum((len(p) - 1) // page for p in prompts)
    require(hit == want_hit, f"{label}: the decode worker served {hit} host-tier tokens, want "
                             f"{want_hit}")
    pool = "int8" if "int8" in arm else ""
    # C on every prompt; the pool's decode kernels only for a prompt under a
    # page, which the prefill worker serves colocated
    on_pre = set(ON_PATH["paged_handoff_prefill"]) | (
        set(ON_PATH["paged", pool]) if 0 in n_pages else set())
    for name, launches in pre_counts.items():
        require((launches > 0) == (name in on_pre),
                f"{label}: the prefill worker launched {name} {launches} times")
    for name, launches in dec_counts.items():
        require((launches > 0) == (name in ON_PATH["paged", pool]),
                f"{label}: the decode worker launched {name} {launches} times")
    if HANDOFF_ARMS[arm].get("HANDOFF_STREAMS") != "0":
        require(exported["mode"] == "stream" and exported["streams"] == 2,
                f"{label}: the exporter runs {exported['mode']} over {exported['streams']}")
    if arm == "long_stream":
        # each prompt's pages staged at its two non-final chunk folds, 4 at
        # each (the staged count after the first and the second)
        require(sorted(kicks) == sorted([4, 8] * len(prompts)),
                f"{label}: pages staged at the chunk folds: {kicks}")
    rb = perf.get(f"handoff_export|{pool or 'bf16'}", {})
    wire = perf.get(f"handoff_stream|{pool or 'bf16'}", {})
    ttft = sorted(o["ttft_s"] for o in outs)
    return {"arm": arm, "config": HANDOFF_ARMS[arm], "prompt_lens": [len(p) for p in prompts],
            "pages": pages, "page_bytes": page_bytes, "pinned_import": pinned,
            "export": exported, "import": imported, "kicks": kicks,
            "readback_ms": rb.get("device_s", 0.0) * 1e3,
            "readback_gb_s": rb["bytes"] / rb["device_s"] / 1e9 if rb.get("device_s") else None,
            "wire_s": wire.get("device_s"),
            "wire_gb_s": wire["bytes"] / wire["device_s"] / 1e9 if wire.get("device_s") else None,
            "handoff_s_sum": seconds.sum(), "handoff_count": seconds.count(),
            "prefill_wall_s": pre_s, "decode_wall_s": dec_s,
            "decode_ttft_p50_s": ttft[len(ttft) // 2], "decode_ttft_s": ttft,
            "host_hit_tokens": hit, "first_tokens": {k: v for k, v in firsts.items()
                                                     if k != "margin_at_first_difference"},
            **{k: v for k, v in agree.items() if k != "margin_at_first_difference"},
            "launches_prefill": pre_counts, "launches_decode": dec_counts}


def serve_handoff(torch, cuda, model, results: dict, served: dict) -> dict:
    """Phase 4 ``paged_handoff``: the arms of ``HANDOFF_ARMS``, streamed
    (2 streams, 4 pages a chunk), blob, an int8 pair, and 2 prompts of 1536
    tokens on ``paged_admission``'s buckets (each prefilled in 3 chunks,
    its pages staged at the chunk folds). Held in each arm: every prompt of
    a full page or more ends on the prefill worker with ``finish_reason=
    "handoff"`` and one token, ``bf16``'s first (``int8``'s on the int8
    pair; the long arm's against an unsplit engine's) by the tie rule, and
    a shorter one is served there colocated; the decode worker's tokens
    equal the same by the tie rule; pages exported = pages imported =
    Σ⌊len/128⌋, the import's bytes = pages × the pool's page bytes, the
    imported planes in pinned memory; the decode worker's host-tier tokens
    = 128 × Σ⌊(len−1)/128⌋ (a prompt of whole pages re-prefills its last
    page, so its last token's logits are computed); both pools' audits
    clean, no call dropped; the prefill worker launches C (and the decode
    kernels only for a prompt it serves colocated), the decode worker its
    pool's decode kernels and C. Printed per arm: the export's readback ms
    and GB/s on the card's events, wire seconds and GB/s over loopback,
    the overlap ratio, the decode worker's TTFT p50 beside ``bf16``'s."""
    from gofr_tpu_torch.gpu.engine import build_engine

    vocab = model.cfg.vocab_size
    prompts = phase4_prompts(torch, vocab)
    longs = long_prompts(torch, vocab)
    eng = build_engine(model.cfg, params=model, device="cuda", seed=SEED, slots=8, max_len=2048,
                       max_prefill_batch=4, decode_chunk=8)
    try:
        long_want = [r.result(timeout=900) for r in [eng.submit(p, max_new_tokens=64)
                                                     for p in longs]]
    finally:
        eng.stop()
    del eng
    torch.cuda.empty_cache()
    arms = []
    for arm in HANDOFF_ARMS:
        if arm == "long_stream":
            arms.append(handoff_arm(torch, cuda, model, arm, longs, long_want))
        else:
            pool = "int8" if "int8" in arm else ""
            arms.append(handoff_arm(torch, cuda, model, arm, prompts, results["paged", pool]))
    launches = {"prefill": {}, "decode": {}}
    for a in arms:
        for side in launches:
            for k, v in a[f"launches_{side}"].items():
                launches[side][k] = launches[side].get(k, 0) + v
    return {"model": "llama3_8b (random bf16 weights, seed 0)", "layers": model.cfg.num_layers,
            "decode_host_mb": HANDOFF_DECODE_HOST_MB, "arms": arms,
            "colocated_ttft_p50_s": {"bf16": served["paged", ""]["metrics"]["ttft_p50_s"],
                                     "int8": served["paged", "int8"]["metrics"]["ttft_p50_s"]},
            "launches": launches, "nvidia_smi": smi_line(),
            "note": "one call, not a benchmark; nothing about speed is held"}


def trace_kernels(path: str) -> dict[str, int]:
    """Kernel events of a Chrome trace by name prefix (up to the template
    arguments)."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    names: dict[str, int] = {}
    for e in events:
        if e.get("cat") == "kernel":
            name = e.get("name", "")
            names[name[:60]] = names.get(name[:60], 0) + 1
    return names


def hold_trace(label: str, path: str) -> dict:
    """Hold that the trace at ``path`` has C's and A's kernel events;
    returns their counts and the trace's kernel events."""
    names = trace_kernels(path)
    found = {k: sum(v for n, v in names.items() if pat in n) for k, pat in TRACE_KERNELS.items()}
    require(all(found.values()), f"{label}: the trace at {path} lacks kernel events of "
                                 f"{[k for k, v in found.items() if not v]}: {names}")
    return {"kernel_events": sum(names.values()), "events_of": found,
            "trace_mb": os.path.getsize(path) / 1e6}


def arm_device_ms(torch, model, sample: dict, kv_quantize: str) -> dict:
    """One shadow sample's two arms again, each under ``torch.profiler``:
    the bucket, each arm's device ms and C's share of it; and each arm's
    rows, for the tie rule."""
    from torch.profiler import ProfilerActivity, profile

    from gofr_tpu_torch.metrics.quality import (
        _pow2_bucket,
        make_serving_attn_fn,
        teacher_forced_rows,
    )

    out = {"bucket": _pow2_bucket(len(sample["prompt"]) + len(sample["emitted"]),
                                  model.cfg.max_seq_len)}
    rows = {}
    for arm, attn_fn in (("serving", make_serving_attn_fn(kv_quantize)), ("reference", None)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            rows[arm] = teacher_forced_rows(model, sample["prompt"], sample["emitted"],
                                            attn_fn=attn_fn)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        total = sum(e.device_time_total for e in events) / 1e3
        flash = sum(e.device_time_total for e in events if "flash_kernel" in e.key) / 1e3
        out[f"{arm}_device_ms"] = total
        out[f"{arm}_c_share"] = flash / total if total else None
    return out, rows


def quality_run(torch, cuda, model, kv_quantize: str, base_outs: list, capture: bool) -> dict:
    """Phase 4 ``paged_quality`` (``capture``) or ``int8_quality``: the
    engine built from a ``ModelSpec`` of the phase's model and
    ``QUALITY_CONFIG`` on the pool ``kv_quantize``, ``bf16``'s 8 prompts,
    then ``drain()``. Held: 8 samples scored, ``errors`` 0; tokens equal to
    the run of the same pool without the plane by the tie rule; each arm
    launched C once a layer; on the bf16 pool the arms equal (KL and log-prob
    delta 0, one computation); at every ``top1`` disagreement the emitted
    token's reference logit within ``SPEC_TIE_GAP`` of the top. With
    ``capture`` the engine is served by the App under ``CAPTURE_CONFIG``:
    the 8 requests, interactive, breach the 1 ms TTFT objective; exactly one
    bundle is written, with the quality snapshot and a trace whose kernel
    events hold C and A; then ``GET /debug/profile?seconds=2`` while a
    second wave of 8 is prefilled and decoded, its trace held the same.
    Printed: each sample's bucket, each arm's device ms and C's share, its
    KL mean and top-1 agreement."""
    import shutil
    import tempfile
    import threading

    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.config import DictConfig
    from gofr_tpu_torch.container import Container
    from gofr_tpu_torch.models import ModelSpec
    from gofr_tpu_torch.ops.cuda.flash_attention import flash_attention

    pool = kv_quantize or "bf16"
    tmp = tempfile.mkdtemp(prefix="gofr-smoke-quality-")
    conf = {**QUALITY_CONFIG, "ENGINE_KV_DTYPE": pool, "PROFILER_DIR": tmp,
            "SLO_CAPTURE_DIR": os.path.join(tmp, "capture"),
            **(CAPTURE_CONFIG if capture else {})}
    c = Container.create(DictConfig(conf))
    app = App(config=DictConfig(conf), container=c)
    eng = app.serve_model("lm", ModelSpec("llama", model.cfg, weights=model, dtype=model.cfg.dtype),
                          device="cuda", seed=SEED)
    plane = eng._quality
    real_score, arms = plane._score, []

    def scored(s, *, serving):
        before = flash_attention.launches
        rows = real_score(s, serving=serving)
        arms.append({"serving": serving, "request_id": s["request_id"],
                     "c_launches": flash_attention.launches - before})
        return rows

    plane._score = scored
    prompts = phase4_prompts(torch, model.cfg.vocab_size)
    out: dict = {"model": "llama3_8b (random bf16 weights, seed 0)", "kv_pool": pool,
                 "config": {k: v for k, v in conf.items() if k.startswith(("QUALITY", "SLO"))}}
    try:
        with AppThread(app, f"{pool}_quality"):
            warm = eng.generate(list(range(1, 65)), max_new_tokens=2, timeout=600)
            require(warm["finish_reason"] == "length", f"{pool}_quality warm-up: {warm}")
            require(plane.drain(300), f"{pool}_quality: the warm request was not scored")
            wait_idle(eng)
            torch.cuda.synchronize()
            cuda.reset_launch_counts()
            arms.clear()
            base = plane.samples
            t0 = time.monotonic()
            if capture:
                # the first half's first token breaches the objective; the
                # second half goes out once the capture's trace runs
                half = len(prompts) // 2
                reqs = [eng.submit(p, max_new_tokens=64, qos_class="interactive")
                        for p in prompts[:half]]
                out["capture_trace_started_after_s"] = wait_for_profiler(torch, 120)
                reqs += [eng.submit(p, max_new_tokens=64, qos_class="interactive")
                         for p in prompts[half:]]
            else:
                reqs = [eng.submit(p, max_new_tokens=64, qos_class="interactive")
                        for p in prompts]
            outs = [r.result(timeout=900) for r in reqs]
            t_done = time.monotonic()
            require(plane.drain(600), f"{pool}_quality: the plane did not drain")
            scored_s = time.monotonic() - t_done
            # wave 1's (the profiled wave is scored too)
            scorer, scored = list(arms), plane.samples - base
            wait_idle(eng)
            torch.cuda.synchronize()
            counts = cuda.launch_counts()
            snap, st = eng.quality_snapshot(), eng.pipeline_stats()
            if capture:
                watcher = c.slo_capture
                if watcher._trace_thread is not None:
                    watcher._trace_thread.join(120)
                bundles = sorted(os.listdir(conf["SLO_CAPTURE_DIR"]))
                require(len(bundles) == 1, f"paged_quality: {len(bundles)} capture bundles")
                bdir = os.path.join(conf["SLO_CAPTURE_DIR"], bundles[0])
                with open(os.path.join(bdir, "bundle.json")) as f:
                    bundle = json.load(f)
                require([(r["class"], r["objective"]) for r in bundle["reason"]]
                        == [("interactive", "ttft")] and bundle["quality"]["lm"]["rate"] == 1.0,
                        f"paged_quality: the bundle's reason {bundle['reason']} or quality "
                        f"{bundle.get('quality')}")
                out["capture"] = {"bundle_keys": sorted(bundle), "reason": bundle["reason"],
                                  "files": sorted(os.listdir(bdir)),
                                  **hold_trace("the capture trace",
                                               os.path.join(bdir, "trace", "trace.json"))}
                out["debug_profile"] = profile_during_wave(torch, app, eng, prompts)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    samples = snap["recent"][-len(prompts):]
    require(snap["errors"] == 0 and scored == len(prompts),
            f"{pool}_quality: {scored} samples scored, {snap['errors']} errors")
    for i, o in enumerate(outs):
        require(o["finish_reason"] == "length" and len(o["tokens"]) == 64,
                f"{pool}_quality request {i}: {o['finish_reason']}, {len(o['tokens'])} tokens")
    require(len(scorer) == 2 * len(prompts)
            and all(a["c_launches"] == model.cfg.num_layers for a in scorer),
            f"{pool}_quality: the scorer's arms launched C {[a['c_launches'] for a in scorer]}")
    on_path = ON_PATH["paged", kv_quantize]
    for name, launches in counts.items():
        require((launches > 0) == (name in on_path),
                f"{pool}_quality: kernel {name} launched {launches} times")
    agree = token_agreement(torch, model, prompts, outs, base_outs)
    gaps = [m["chosen_below_top1"] for m in agree["margin_at_first_difference"] if m]
    require(all(gap <= SPEC_TIE_GAP for gap in gaps),
            f"{pool}_quality: at a first difference from the run without the plane the run "
            f"chose a token {gaps} below the top logit (limit {SPEC_TIE_GAP})")
    per_sample = []
    for s in samples:
        rep = s["report"]
        if not kv_quantize:
            require(rep["kl_max"] == 0.0 and rep["logprob_delta_max_abs"] == 0.0,
                    f"bf16_quality: the arms differ on the bf16 pool: {rep}")
        timing, rows = arm_device_ms(torch, model, s, kv_quantize)
        # where the reference's argmax is not the emitted token, how far the
        # emitted token lies below the top logit in each arm; the tie rule
        # holds the serving arm, the one that computes what served the
        # request (on the bf16 pool it is the reference)
        below = {arm: [float(r[j].max() - r[j][tok]) for j, (tok, ok) in
                       enumerate(zip(s["emitted"], rep["agree"])) if not ok]
                 for arm, r in rows.items()}
        require(all(b <= SPEC_TIE_GAP for b in below["serving"]),
                f"{pool}_quality: at a top-1 disagreement the emitted token lies "
                f"{below['serving']} below the serving arm's top logit (limit {SPEC_TIE_GAP})")
        per_sample.append({**timing, "prompt_len": len(s["prompt"]), "tokens": rep["tokens"],
                           "kl_mean": rep["kl_mean"], "top1_agree": rep["top1_agree"],
                           "first_divergence": rep["first_divergence"],
                           "disagreement_below_top1": below})
    out.update({"samples": len(samples), "errors": snap["errors"],
                "good": sum(bool(s["ok"]) for s in samples),
                "backend": snap["backend"],
                "scorer_c_launches": sum(a["c_launches"] for a in scorer),
                "scoring_wall_s": scored_s, "serve_wall_s": t_done - t0,
                "host_ms_per_busy_turn": st["busy_turn_s"] / st["busy_turns"] * 1e3,
                "per_sample": per_sample, "launches": counts, **agree,
                "nvidia_smi": smi_line()})
    return out


def wait_for_profiler(torch, timeout: float) -> float:
    """Wait until a ``torch.profiler`` session another thread started runs,
    then a margin; returns the seconds waited. The profiler's start flag is
    a module global (its own enabled check answers for the starting thread
    only) and flips just before the profiler starts."""
    import torch.autograd.profiler as autograd_profiler

    t0 = time.monotonic()
    if not hasattr(autograd_profiler, "_is_profiler_enabled"):
        time.sleep(1.0)
        return time.monotonic() - t0
    while not autograd_profiler._is_profiler_enabled:
        require(time.monotonic() - t0 < timeout, "no profiler started")
        time.sleep(0.002)
    time.sleep(0.3)
    return time.monotonic() - t0


def profile_during_wave(torch, app, eng, prompts: list) -> dict:
    """``GET /debug/profile?seconds=PROFILE_S`` through the App, with a wave
    of 8 new prompts submitted once the profiler runs; the trace it wrote
    must hold C's and A's kernel events."""
    import threading

    reply = {}

    def get() -> None:
        reply["r"] = http_call(app.http_port, "GET", f"/debug/profile?seconds={PROFILE_S}")

    t = threading.Thread(target=get, name="debug-profile")
    t.start()
    started_s = wait_for_profiler(torch, 30)
    wave = pipeline_prompts(torch, eng.cfg.vocab_size)[:len(prompts)]
    reqs = [eng.submit(p, max_new_tokens=64) for p in wave]
    t.join(120)
    for r in reqs:
        r.result(timeout=900)
    status, body = reply["r"][:2]
    require(status == 200, f"/debug/profile answered {status}: {body}")
    return {"seconds": body["data"]["seconds"], "wave_sent_after_s": started_s,
            **hold_trace("/debug/profile", os.path.join(body["data"]["trace_dir"], "trace.json"))}


def cold_start(torch) -> dict:
    """Phase 4 ``cold_start``: ``scripts/torch_cold_start.py`` in two fresh
    processes, ``ENGINE_WARMUP`` false then true (``COLD_START``: Llama-3-8B's
    widths cut to 2 layers, one request of 512 tokens, then a second as the
    warm reference). Held: each ends with its requests' tokens and warmup
    runs its calls; printed: warmup's seconds and count and both TTFTs."""
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                          "torch_cold_start.py")
    runs = {}
    for warm in ("false", "true"):
        done = subprocess.run([sys.executable, script, "--warmup", warm,
                               "--layers", str(COLD_START["layers"]),
                               "--prompt", str(COLD_START["prompt"]),
                               "--new", str(COLD_START["new"])],
                              capture_output=True, text=True, timeout=600)
        require(done.returncode == 0, f"cold_start --warmup {warm}: exit {done.returncode}\n"
                                      f"{done.stdout[-2000:]}{done.stderr[-4000:]}")
        runs[warm] = json.loads(done.stdout.strip().splitlines()[-1])
    require(runs["true"]["warmup_count"] > 0 and runs["false"]["warmup_count"] == 0,
            f"cold_start: warmup counts {runs}")
    return {"warmup_false": runs["false"], "warmup_true": runs["true"],
            "first_ttft_cold_over_warmed": runs["false"]["first_ttft_s"]
            / runs["true"]["first_ttft_s"]}


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
    verify rows once per layer and nothing else, and on a model of int8
    weights each forward (a chunk, a step, a round's verify) the W8A16
    kernel 7 x 32 + 1 times besides; the logits must be finite and the
    round's tokens and accept counts in range."""
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
    int8 = type(model.blocks[0].wq).__name__ == "QLinear"
    pool = f"{kv_layout} {kv_quantize or 'bf16'}" + (" (int8 weights)" if int8 else "")
    layers = model.cfg.num_layers
    # W8A16 launches of one model forward (0 on bf16 weights)
    lin = (7 * layers + 1) if int8 else 0

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
            and counts["w8a16"] == 2 * lin and sum(counts.values()) == 2 * (layers + lin),
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
            and counts["w8a16"] == steps * lin
            and sum(counts.values()) == steps * (layers * len(decode_kernels) + lin),
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
            and counts["w8a16"] == lin and sum(counts.values()) == layers + lin,
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
            and counts["w8a16"] == 2 * lin
            and sum(counts.values()) == layers * (len(decode_kernels) + 1) + 2 * lin
            and lora_pool.uploads == len(specs),
            f"{pool}: a decode step and a spec round with adapters launched {counts}")
    return {"kv_layout": kv_layout, "kv_pool": kv_quantize or "bf16",
            "weights": "int8" if int8 else "bf16", "chunks": 2, "steps": steps, "spec_rounds": 1,
            "spec_sampled_lanes": 1, "sync_debug_mode": "error",
            "adapters": {"uploads_in_check": 1, "decode_steps": 1, "spec_rounds": 1,
                         "sel": sel.tolist()},
            "launches": {"flash_attention (chunks)": chunk_launches,
                         **{k: counts_decode[k] for k in (*decode_kernels, "w8a16")},
                         "flash_attention (verify)": spec_launches,
                         "with adapters": counts}}


class StagingExporter:
    """A handoff exporter that keeps what a prefill worker stages (its page
    readbacks) and ships nothing: phase 6's stand-in for the wire."""

    def __init__(self):
        self.finished = []

    def known_blob(self) -> bool:
        return False

    def begin_stream(self, request, prompt_tokens, nbytes_page, t0):
        from gofr_tpu_torch.gpu.handoff import StreamTransfer

        return StreamTransfer(request, prompt_tokens, nbytes_page, t0, "phase6")

    def kick(self, transfer) -> None:
        pass

    def finish(self, transfer, first_token, now) -> None:
        self.finished.append(transfer)

    def abort(self, transfer) -> None:
        pass

    def close(self) -> None:
        pass


def export_sync_check(torch, engine, submit, unsynced, fold, pool: str) -> None:
    """A prefill worker's export calls under ``dispatch_sync_check``'s
    check: a 400-token prompt prefilled in chunks of 256, the copies of the
    pages its first chunk made whole staged as its fold would
    (``_stream_handoff_chunk``), then at its activation the tail's and the
    slot freed (``_export_handoff``), each under the state lock, with the
    folds outside the check; every staged page must equal its pool page bit
    for bit."""
    from gofr_tpu_torch.ops.paged import page_planes

    eng = engine(role="prefill")
    exp = eng._handoff_exporter = StagingExporter()
    rng = torch.Generator().manual_seed(SEED + 10)
    submit(eng, torch.randint(0, eng.cfg.vocab_size, (400,), generator=rng).tolist())
    eng._admit_prefill()
    idx, s = 0, eng.slots[0]

    def chunk_then_fold() -> None:
        # the fold without its role's staging, which runs checked below
        eng.role = "both"
        try:
            eng._advance_chunked()
            fold(eng)
        finally:
            eng.role = "prefill"

    def locked(fn):
        def call():
            with eng._state_lock:
                return fn()
        return call

    chunk_then_fold()
    unsynced("stream_handoff_chunk", locked(lambda: eng._stream_handoff_chunk(idx, s)))
    require(s.handoff is not None and s.handoff.staged_pages == 2,
            f"{pool}: the first chunk's fold staged no whole page")
    chunk_then_fold()
    pages = list(eng._slot_pages[idx][:3])
    unsynced("export_handoff", locked(lambda: eng._export_handoff(idx, s, s.last_token)))
    t = exp.finished[0]
    require(t.staged_pages == 3 and eng.slots[idx] is None,
            f"{pool}: the export staged {t.staged_pages} pages, want 3, and kept its slot")
    for p, rb in zip(pages, t.staged):
        host = rb.wait()
        require(all(torch.equal(h, plane[:, p].cpu()) for h, plane in
                    zip(host, page_planes(eng.cache))),
                f"{pool}: a staged handoff page differs from pool page {p}")
    eng.check_page_refs()


def dispatch_sync_check(torch, model, kv_layout: str, kv_quantize: str,
                        planes: bool = False) -> dict:
    """The engine's dispatches on one cache, each inside
    ``torch.cuda.set_sync_debug_mode("error")``: a batched prefill (one lane
    sampled with top-k and top-p) with a long prompt's claim
    (``dispatch_prefill``), that prompt's two chunks (``dispatch_chunk``),
    two decode chunks, the second from the device carry
    (``dispatch_decode``), and on the pool a swap-in of one page into a free
    page (``dispatch_swapins``) and a prefill worker's handoff export
    (``export_sync_check``), then two speculative rounds on an engine
    with ``spec_tokens`` (``dispatch_spec`` / ``dispatch_spec_paged``). Each
    runs on a stopped engine of 2 slots, from this thread; the folds, whose
    waits on their events are the intended ones, run outside the check. The
    page swapped in must equal the page it was copied from, bit for bit.
    With ``planes`` each engine has every request plane on: a container
    with spans kept in memory, the flight recorder, the SLO engine and the
    perf plane, and a QoS controller bound; each request opens its span
    timeline as ``submit`` would."""
    from gofr_tpu_torch.config import DictConfig
    from gofr_tpu_torch.container import Container
    from gofr_tpu_torch.gpu import decode, executor
    from gofr_tpu_torch.gpu.engine import GenerateEngine, Request
    from gofr_tpu_torch.ops.paged import gather_page, page_planes
    from gofr_tpu_torch.qos import AdmissionController, QoSPolicy

    pool = f"{kv_layout} {kv_quantize or 'bf16'}"
    rng = torch.Generator().manual_seed(SEED + 8)
    short, long = (torch.randint(0, model.cfg.vocab_size, (n,), generator=rng).tolist()
                   for n in (100, 300))
    checked = []

    def engine(**kw):
        container = None
        if planes:
            container = Container.create(DictConfig({"TRACE_EXPORTER": "memory",
                                                     "SLO_ENABLED": "true", "LOG_LEVEL": "ERROR"}))
        eng = GenerateEngine(model, device="cuda", slots=2, max_len=1024, max_prefill_batch=2,
                             decode_chunk=2, prefill_buckets=[128, 256], top_k=50, top_p=0.95,
                             kv_layout=kv_layout, kv_quantize=kv_quantize, container=container,
                             **kw)
        eng.stop()  # its loop ends: the dispatches below run from this thread
        if planes:
            container.register_engine("lm", eng)
            container.register_qos(AdmissionController(QoSPolicy(), container.metrics))
            require(eng.perf is not None and eng.qos is not None and eng.tracer.enabled,
                    f"{pool}: a plane is off on the planes check")
        return eng

    def submit(eng, prompt, temperature=0.0):
        req = Request(prompt, {"max_new_tokens": 16, "temperature": temperature}, None)
        if planes:
            eng._observe_submit(req, None)
        eng._accept(req)

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
        export_sync_check(torch, engine, submit, unsynced, fold, pool)
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
            "weights": "int8" if type(model.blocks[0].wq).__name__ == "QLinear" else "bf16",
            "planes": planes, "sync_debug_mode": "error", "dispatches": checked}


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


# Phase 4's ``paged_autotune``: the warmup autotuner (ops/autotune.py) on
# four engines of Llama-3-8B's widths cut to ``COLD_START``'s 2 layers (what
# it measures is one layer's decode attention, at the engine's real slots,
# heads and positions), ``bf16``'s other knobs, one per cache with a split
# kernel: the op it tunes and the kernel that op launches.
AUTOTUNE_RUNS = {("paged", ""): "paged_decode", ("paged", "int8"): "paged_decode_q",
                 ("paged", "int4"): "paged_decode_q4", ("slot", ""): "decode"}


def serve_autotune(torch, cuda) -> dict:
    """Phase 4 ``paged_autotune``: each engine of ``AUTOTUNE_RUNS`` runs
    ``warmup()`` (one length and one batch bucket: the tuner runs first in
    any warmup) with ``GOFR_AUTOTUNE_CACHE`` in a temporary directory, then
    a second engine of the same shapes. Held: the first pins one of its
    candidates (``split_candidates``, ``split_plan``'s first) from its own
    timings, with none disqualified, and another plan than the rule's
    only when it beats the rule by more than the larger spread; the
    second reports ``source:
    "cache"`` and times nothing (its timer raises); each warmup launches
    only kernels of its cache's path, the tuned op's among them; and under
    ``GOFR_AUTOTUNE=0`` the report is None. Printed: every candidate's ms
    (best of 3 bursts on CUDA events) and spread, and the winner beside
    ``split_plan``'s."""
    import tempfile

    from gofr_tpu_torch.gpu.engine import build_engine
    from gofr_tpu_torch.models.llama import LlamaConfig, init
    from gofr_tpu_torch.ops import autotune
    from gofr_tpu_torch.ops.cuda.decode_attention import split_candidates

    cfg = LlamaConfig.llama3_8b(num_layers=COLD_START["layers"])
    model = init(cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    knobs = dict(params=model, device="cuda", seed=SEED, slots=8, max_len=2048,
                 max_prefill_batch=4, decode_chunk=8)

    def refuse(fn):
        raise AssertionError("paged_autotune: a cached engine timed a candidate")

    saved = {k: os.environ.get(k) for k in ("GOFR_AUTOTUNE", "GOFR_AUTOTUNE_CACHE")}
    out = {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            os.environ.pop("GOFR_AUTOTUNE", None)
            os.environ["GOFR_AUTOTUNE_CACHE"] = os.path.join(tmp, "autotune.json")
            for (layout, quant), op in AUTOTUNE_RUNS.items():
                name = run_name(layout, quant)
                reports, counts = [], None
                for arm in ("measured", "cache"):
                    eng = build_engine(cfg, kv_layout=layout, kv_quantize=quant, **knobs)
                    if arm == "cache":
                        eng._autotune_timer = refuse
                    try:
                        torch.cuda.synchronize()
                        cuda.reset_launch_counts()
                        t0 = time.perf_counter()
                        eng.warmup(len_buckets=[128], batch_buckets=[1])
                        torch.cuda.synchronize()
                        warm_s = time.perf_counter() - t0
                        if arm == "measured":
                            counts = cuda.launch_counts()
                        reports.append((eng.autotune_report(), warm_s))
                        span = (eng.pages_per_slot * eng.page_size if layout == "paged"
                                else eng.cache_len)
                    finally:
                        eng.stop()
                    del eng
                plans = [autotune.plan_name(r) for r in split_candidates(8, cfg.num_kv_heads, span)]
                (rep, warm_s), (rep2, warm2_s) = reports
                rec, rec2 = rep["decisions"][op], rep2["decisions"][op]
                require(rec["source"] == "measured" and rec["backend"] in plans
                        and list(rec["timings_ms"]) == plans and rep["rule"] == plans[0],
                        f"paged_autotune {name}: {rep}")
                require(not rec.get("errors"), f"paged_autotune {name}: candidates disqualified: "
                                               f"{rec.get('errors')}")
                # a pin other than the rule's beats it by more than the spread
                t, spread = rec["timings_ms"], rec.get("spread_ms", {})
                require(rec["backend"] == plans[0] or t[rec["backend"]] + max(
                    spread.get(rec["backend"], 0.0), spread.get(plans[0], 0.0)) < t[plans[0]],
                        f"paged_autotune {name}: pinned {rec['backend']} inside the spread: {rec}")
                require(rec2["source"] == "cache" and rec2["backend"] == rec["backend"],
                        f"paged_autotune {name}: the second engine's report {rep2}")
                kernel = {"decode": "decode_attention"}.get(op, op)
                require(counts[kernel] > 0, f"paged_autotune {name}: {kernel} never launched")
                for k, launches in counts.items():
                    require(launches == 0 or k in ON_PATH[f"paged_autotune_{name}"],
                            f"paged_autotune {name}: warmup launched kernel {k} {launches} times")
                out[name] = {"op": op, "span": span, "rule": plans[0], "pinned": rec["backend"],
                             "timings_ms": rec["timings_ms"], "spread_ms": rec.get("spread_ms"),
                             "pinned_over_rule": (rec["timings_ms"][rec["backend"]]
                                                  / rec["timings_ms"][plans[0]]),
                             "warmup_s": warm_s, "cached_warmup_s": warm2_s,
                             "tune_s": rep["elapsed_s"], "cached_tune_s": rep2["elapsed_s"],
                             "launches": counts}
            os.environ["GOFR_AUTOTUNE"] = "0"
            eng = build_engine(cfg, **knobs)
            try:
                eng.warmup(len_buckets=[128], batch_buckets=[1])
                off = eng.autotune_report()
            finally:
                eng.stop()
            require(off is None, f"paged_autotune: GOFR_AUTOTUNE=0 still reported {off}")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    del model
    torch.cuda.empty_cache()
    return {"model": f"llama3_8b widths, {COLD_START['layers']} layers (random bf16, seed 0)",
            "runs": out, "gofr_autotune_0_report": None, "nvidia_smi": smi_line()}


# Phase 4's ``app_transports``: the App's other entry points on the phase's
# Llama-3-8B (32 layers, ``ModelSpec(weights=model)``), all in one App.
TRANSPORTS_CONFIG = {**HTTP_CONFIG, "APP_ENV": "DEBUG", "ENGINE_WARMUP": "true",
                     "PUBSUB_BACKEND": "inmemory", "GRPC_PORT": "0", "SUBSCRIBER_WORKERS": "4"}
TRANSPORTS_USER = ("smoke", "s3cret")
# a schedule the cron thread's own ticks never meet; the phase fires it by
# ``app.cron.tick`` at the minute it names
TRANSPORTS_CRON = ("0 0 1 1 *", (2027, 1, 1, 0, 0, 30, 0, 0, -1))


class WSClient:
    """A websocket client on a stdlib socket: the RFC 6455 upgrade, masked
    text frames out, the server's unmasked frames in."""

    def __init__(self, port: int, path: str, headers: dict | None = None):
        import base64
        import socket

        self.sock = socket.create_connection(("127.0.0.1", port), timeout=900)
        key = base64.b64encode(os.urandom(16)).decode()
        extra = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items())
        self.sock.sendall((f"GET {path} HTTP/1.1\r\nHost: 127.0.0.1\r\nUpgrade: websocket\r\n"
                           f"Connection: Upgrade\r\nSec-WebSocket-Key: {key}\r\n"
                           f"Sec-WebSocket-Version: 13\r\n{extra}\r\n").encode())
        head = b""
        while b"\r\n\r\n" not in head:
            chunk = self.sock.recv(1)
            if not chunk:
                break
            head += chunk
        self.status = int(head.split(b" ", 2)[1]) if head else 0

    def send_text(self, text: str) -> None:
        import struct

        payload, mask = text.encode(), os.urandom(4)
        n = len(payload)
        if n < 126:
            head = bytes([0x81, 0x80 | n])
        elif n < 1 << 16:
            head = bytes([0x81, 0x80 | 126]) + struct.pack("!H", n)
        else:
            head = bytes([0x81, 0x80 | 127]) + struct.pack("!Q", n)
        key = (mask * (n // 4 + 1))[:n]
        body = (int.from_bytes(payload, "big") ^ int.from_bytes(key, "big")).to_bytes(n, "big")
        self.sock.sendall(head + mask + body)

    def _exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("the server closed the connection")
            buf += chunk
        return buf

    def recv_text(self) -> str:
        import struct

        b0, b1 = self._exact(2)
        n = b1 & 0x7F
        if n == 126:
            n = struct.unpack("!H", self._exact(2))[0]
        elif n == 127:
            n = struct.unpack("!Q", self._exact(8))[0]
        payload = self._exact(n)
        require(b0 & 0x0F == 0x1 and not b1 & 0x80, f"websocket: frame opcode {b0 & 0x0F}")
        return payload.decode()

    def close(self) -> None:
        self.sock.close()


def _basic(user: tuple) -> dict:
    import base64

    return {"Authorization": "Basic " + base64.b64encode(":".join(user).encode()).decode()}


def _grpc_service(grpc, current):
    """A JSON-over-gRPC ``gen.Gen`` service (as examples/grpc-server
    registers its own): unary ``Generate`` and server-streaming
    ``GenerateStream``, each through ``current_grpc_context().generate``."""
    def generate(request, context):
        o = current().generate("lm", request["prompt"], max_new_tokens=request["n"], timeout=900)
        return {"tokens": o["tokens"], "ttft_s": o["ttft_s"], "decode_s": o["decode_s"]}

    def generate_stream(request, context):
        for tok in current().generate("lm", request["prompt"], max_new_tokens=request["n"],
                                      timeout=900, stream=True):
            yield {"token": tok}

    def add(server):
        codec = dict(request_deserializer=lambda b: json.loads(b.decode()),
                     response_serializer=lambda o: json.dumps(o).encode())
        server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler("gen.Gen", {
            "Generate": grpc.unary_unary_rpc_method_handler(generate, **codec),
            "GenerateStream": grpc.unary_stream_rpc_method_handler(generate_stream, **codec),
        }),))

    return add


def p50(xs: list) -> float:
    xs = sorted(xs)
    return xs[len(xs) // 2]


def app_transports(torch, cuda, model, base_outs: list) -> dict:
    """Phase 4 ``app_transports``: the port's App on localhost serving the
    phase's Llama-3-8B (``TRANSPORTS_CONFIG``: ``HTTP_CONFIG``,
    ``APP_ENV=DEBUG``, ``ENGINE_WARMUP=true`` so the autotuner pins A's
    plan at 32 layers, in-memory pub/sub with 4 consumers a topic, gRPC on
    a free port) behind Basic auth, its entry points in turn: ``bf16``'s 8
    prompts as 8 concurrent ``/ws/generate`` clients (stdlib sockets,
    masked frames), 64 new tokens each, then a ninth that closes after two
    frames; 4 unary gRPC ``Generate`` calls at once and one
    ``GenerateStream``; prompts 4..7 published to ``prompts``, whose
    subscriber generates and publishes to ``completions``, whose subscriber
    collects them; a cron job fired by ``app.cron.tick``; and auth, a
    static file and the OpenAPI spec. Held: every websocket, gRPC, pub/sub
    and cron request's tokens equal ``bf16``'s by the tie rule; a stream is
    one frame per token then ``{"done": true}``; the ninth request ends
    cancelled and the slots empty; the pool audit clean and nothing
    dropped; the four ``app_pubsub_*`` counters 8 each; the engine launched
    A, B and C and nothing else, A only on the plan it pinned at warmup;
    401 without credentials (``/generate`` and the upgrade), 201 / 101 with
    them, health open, the static file served, the spec listing the
    routes; and after ``stop`` every thread the App started has ended.
    Printed: the websocket first frame's p50 less the engine's TTFT p50,
    the frame gap's p50 beside the engine's TPOT p50, the gRPC overhead
    p50 (client wall less ``ttft_s`` and ``decode_s``), pub/sub publish to
    completion p50, and A's pinned plan."""
    import tempfile
    import threading
    import urllib.request

    import grpc

    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.config import DictConfig
    from gofr_tpu_torch.gpu.engine import RequestCancelled
    from gofr_tpu_torch.grpc.server import current_grpc_context
    from gofr_tpu_torch.http.streaming import StreamingResponse
    from gofr_tpu_torch.models import ModelSpec
    from gofr_tpu_torch.ops import autotune
    from gofr_tpu_torch.ops.cuda import paged_decode as paged_decode_mod

    threads_before = set(threading.enumerate())
    prompts = phase4_prompts(torch, model.cfg.vocab_size)
    app = App(config=DictConfig(TRANSPORTS_CONFIG))
    engine = app.serve_model("lm", ModelSpec("llama", model.cfg, weights=model,
                                             dtype=model.cfg.dtype), seed=SEED, eos_token_id=-1)
    submitted, submit = [], engine.submit

    def record(*a, **kw):
        submitted.append(submit(*a, **kw))
        return submitted[-1]

    engine.submit = record
    app.enable_basic_auth(dict([TRANSPORTS_USER]))

    async def generate(ctx):
        body = ctx.bind(dict)
        return await ctx.agenerate("lm", body["prompt"], max_new_tokens=int(body["max_new_tokens"]),
                                   timeout=900)

    def ws_generate(ctx):
        body = ctx.bind(dict)
        return StreamingResponse(ctx.generate("lm", body["prompt"],
                                              max_new_tokens=int(body["max_new_tokens"]),
                                              timeout=900, stream=True))

    completions, lock = {}, threading.Lock()

    def on_prompt(ctx):
        body = ctx.bind(dict)
        o = ctx.generate("lm", body["prompt"], max_new_tokens=64, timeout=900)
        ctx.publish("completions", {"i": body["i"], "sent": body["sent"], "tokens": o["tokens"]})

    def on_completion(ctx):
        body = ctx.bind(dict)
        with lock:
            completions[body["i"]] = {**body, "arrived": time.monotonic()}

    cron_out = []
    static_dir = tempfile.TemporaryDirectory(prefix="gofr-smoke-static-")
    static = static_dir.name
    with open(os.path.join(static, "index.html"), "w") as f:
        f.write("<h1>gofr_tpu_torch</h1>")
    app.post("/generate", generate)
    app.websocket("/ws/generate", ws_generate)
    app.subscribe("prompts", on_prompt)
    app.subscribe("completions", on_completion)
    app.add_cron_job(TRANSPORTS_CRON[0], "smoke", lambda ctx: cron_out.append(
        ctx.generate("lm", prompts[0], max_new_tokens=64, timeout=900)))
    app.add_static_files("/static", static)
    app.register_grpc_service(_grpc_service(grpc, current_grpc_context))
    auth = _basic(TRANSPORTS_USER)
    pinned_rows, real_scratch = [], paged_decode_mod.split_scratch

    def watch_scratch(q, hkv, smax, op=None, dims=()):
        rows, splits, scratch = real_scratch(q, hkv, smax, op, dims)
        pinned_rows.append(rows)
        return rows, splits, scratch

    with static_dir, AppThread(app, "app-transports"):
        port = app.http_port
        report = engine.autotune_report()
        require(report is not None and "paged_decode" in report["decisions"],
                f"app_transports: warmup pinned nothing: {report}")
        pin = report["decisions"]["paged_decode"]
        _, dbg, *_ = http_call(port, "GET", "/debug/engine", headers=auth)
        require(dbg["data"]["engines"]["lm"]["autotune"]["decisions"]["paged_decode"]["backend"]
                == pin["backend"], "app_transports: /debug/engine lacks the pin")
        # auth, health, the spec and a static file
        status_plain = http_call(port, "POST", "/generate",
                                 {"prompt": prompts[1], "max_new_tokens": 2})[0]
        status_auth = http_call(port, "POST", "/generate",
                                {"prompt": prompts[1], "max_new_tokens": 2}, auth)[0]
        ws_plain, ws_auth = WSClient(port, "/ws/generate"), WSClient(port, "/ws/generate", auth)
        statuses = {"generate": (status_plain, status_auth), "upgrade": (ws_plain.status,
                                                                         ws_auth.status)}
        ws_plain.close()
        ws_auth.close()
        status, health, *_ = http_call(port, "GET", "/.well-known/health")
        statuses["health"] = status
        status, spec, *_ = http_call(port, "GET", "/.well-known/openapi.json")
        statuses["openapi"] = status
        with urllib.request.urlopen(urllib.request.Request(
                f"http://127.0.0.1:{port}/static/index.html", headers=auth), timeout=60) as r:
            statuses["static"], static_body = r.status, r.read().decode()
        require(statuses == {"generate": (401, 201), "upgrade": (401, 101), "health": 200,
                             "openapi": 200, "static": 200}, f"app_transports: {statuses}")
        require("/generate" in spec["paths"] and static_body == "<h1>gofr_tpu_torch</h1>",
                f"app_transports: spec {spec} static {static_body!r}")

        torch.cuda.synchronize()
        cuda.reset_launch_counts()
        paged_decode_mod.split_scratch = watch_scratch
        del submitted[:]
        try:
            # 8 websocket clients at once
            streams = [None] * len(prompts)

            def ws_one(i: int) -> None:
                c = WSClient(port, "/ws/generate", auth)
                t0 = time.perf_counter()
                c.send_text(json.dumps({"prompt": prompts[i], "max_new_tokens": 64}))
                frames, stamps = [], []
                while True:
                    frames.append(json.loads(c.recv_text()))
                    stamps.append(time.perf_counter() - t0)
                    if isinstance(frames[-1], dict):
                        break
                c.close()
                streams[i] = (frames, stamps)

            threads = [threading.Thread(target=ws_one, args=(i,)) for i in range(len(prompts))]
            for th in threads:
                th.start()
            for th in threads:
                th.join(900)
            ws_reqs = [next(q for q in submitted if q.inputs == p) for p in prompts]
            wait_idle(engine)
            # the ninth: two frames, then gone
            ninth = WSClient(port, "/ws/generate", auth)
            ninth.send_text(json.dumps({"prompt": pipeline_prompts(torch, model.cfg.vocab_size)[0],
                                        "max_new_tokens": 512}))
            ninth_frames = [json.loads(ninth.recv_text()) for _ in range(2)]
            ninth.close()
            ninth_req = submitted[-1]
            try:
                ninth_req.result(timeout=300)
                ninth_error = None
            except RequestCancelled as e:
                ninth_error = e
            wait_idle(engine)
            slots_free = all(s is None for s in engine.slots)

            # gRPC: 4 unary calls at once, then one stream
            grpc_replies = [None] * 4
            with grpc.insecure_channel(f"127.0.0.1:{app.grpc_port}") as ch:
                codec = dict(request_serializer=lambda o: json.dumps(o).encode(),
                             response_deserializer=lambda b: json.loads(b.decode()))
                unary = ch.unary_unary("/gen.Gen/Generate", **codec)
                stream = ch.unary_stream("/gen.Gen/GenerateStream", **codec)

                def grpc_one(i: int) -> None:
                    t0 = time.perf_counter()
                    reply = unary({"prompt": prompts[i], "n": 64}, timeout=900)
                    grpc_replies[i] = (reply, time.perf_counter() - t0)

                threads = [threading.Thread(target=grpc_one, args=(i,)) for i in range(4)]
                for th in threads:
                    th.start()
                for th in threads:
                    th.join(900)
                grpc_stream = [m["token"] for m in stream({"prompt": prompts[4], "n": 64},
                                                          timeout=900)]

            # pub/sub: prompts 4..7 through both topics
            for i in range(4, 8):
                app.container.publish("prompts", {"i": i, "prompt": prompts[i],
                                                  "sent": time.monotonic()})
            deadline = time.monotonic() + 900
            while len(completions) < 4 and time.monotonic() < deadline:
                time.sleep(0.01)
            # cron: the job at the minute its schedule names
            fired = app.cron.tick(time.mktime(TRANSPORTS_CRON[1]))
            while not cron_out and time.monotonic() < deadline:
                time.sleep(0.01)
            wait_idle(engine)
            torch.cuda.synchronize()
            counts = cuda.launch_counts()
        finally:
            paged_decode_mod.split_scratch = real_scratch
        engine.check_page_refs()
        dropped = engine.pipeline_stats()["dropped"]
        m = app.container.metrics
        pubsub_counts = {name: sum(m.get(name).value(topic=t) for t in ("prompts", "completions"))
                         for name in ("app_pubsub_publish_total_count",
                                      "app_pubsub_publish_success_count",
                                      "app_pubsub_subscribe_total_count",
                                      "app_pubsub_subscribe_success_count")}
    # every thread the App started has ended (the handler pool's idle
    # threads leave as its shutdown reaches them)
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        left = [t.name for t in set(threading.enumerate()) - threads_before if t.is_alive()]
        if not left:
            break
        time.sleep(0.1)
    require(not left, f"app_transports: threads outlived stop(): {left}")
    require(not engine._thread.is_alive(), "app_transports: the engine's thread outlived stop()")

    # the holds on what came back
    ws_outs, ws_first, ws_gaps = [], [], []
    for i, (frames, stamps) in enumerate(streams):
        require(len(frames) == 65 and frames[-1] == {"done": True}
                and all(isinstance(t, int) for t in frames[:-1]),
                f"app_transports websocket {i}: {len(frames)} frames, last {frames[-1:]}")
        ws_outs.append({"tokens": frames[:-1]})
        ws_first.append(stamps[0])
        ws_gaps += [b - a for a, b in zip(stamps[:-2], stamps[1:-1])]
    ws_results = [q.outcome()[0] for q in ws_reqs]
    require(all(isinstance(f, int) for f in ninth_frames) and ninth_error is not None
            and ninth_req.cancelled and slots_free,
            f"app_transports: the ninth client's request ended {ninth_error!r}, cancelled "
            f"{ninth_req.cancelled}, slots free {slots_free}")
    require(all(r is not None for r in grpc_replies), "app_transports: a gRPC call failed")
    grpc_outs = [r[0] for r in grpc_replies]
    require(len(grpc_stream) == 64 and all(len(o["tokens"]) == 64 for o in grpc_outs),
            f"app_transports gRPC: {[len(o['tokens']) for o in grpc_outs]}, stream "
            f"{len(grpc_stream)}")
    require(sorted(completions) == [4, 5, 6, 7]
            and all(len(c["tokens"]) == 64 for c in completions.values()),
            f"app_transports pub/sub: {sorted(completions)}")
    require(fired == ["smoke"] and len(cron_out) == 1 and len(cron_out[0]["tokens"]) == 64,
            f"app_transports cron: fired {fired}, {len(cron_out)} results")
    require(all(v == 8 for v in pubsub_counts.values()), f"app_transports: {pubsub_counts}")
    require(dropped == 0, f"app_transports: {dropped} calls dropped")
    for name, launches in counts.items():
        require((launches > 0) == (name in ON_PATH["app_transports"]),
                f"app_transports: kernel {name} launched {launches} times")
    pinned = autotune.plan_rows(pin["backend"])
    require(pinned_rows and set(pinned_rows) == {pinned},
            f"app_transports: A ran on plans {sorted(set(pinned_rows))}, pinned {pinned}")
    by_path = {
        "websocket": token_agreement(torch, model, prompts, ws_outs, base_outs),
        "grpc": token_agreement(torch, model, prompts[:4], grpc_outs, base_outs[:4]),
        "grpc_stream": token_agreement(torch, model, prompts[4:5], [{"tokens": grpc_stream}],
                                       base_outs[4:5]),
        "pubsub": token_agreement(torch, model, prompts[4:8],
                                  [completions[i] for i in range(4, 8)], base_outs[4:8]),
        "cron": token_agreement(torch, model, prompts[:1], cron_out, base_outs[:1]),
    }
    for path, agree in by_path.items():
        gaps = [mm["chosen_below_top1"] for mm in agree["margin_at_first_difference"] if mm]
        require(all(gap <= SPEC_TIE_GAP for gap in gaps),
                f"app_transports {path}: at a first difference from bf16 the token lies {gaps} "
                f"below the top logit (limit {SPEC_TIE_GAP})")
    ttft = [r["ttft_s"] for r in ws_results]
    tpot = [r["decode_s"] / (len(r["tokens"]) - 1) for r in ws_results]
    grpc_overhead = [wall - (o["ttft_s"] + o["decode_s"]) for o, wall in
                     ((r[0], r[1]) for r in grpc_replies)]
    pub_to_done = [c["arrived"] - c["sent"] for c in completions.values()]
    del engine, app
    torch.cuda.empty_cache()
    return {
        "model": "llama3_8b (random bf16 weights, seed 0)", "config": TRANSPORTS_CONFIG,
        "autotune": report, "pinned_plan": pin["backend"], "rule_plan": report["rule"],
        "statuses": statuses,
        "ws_first_frame_p50_s": p50(ws_first), "engine_ttft_p50_s": p50(ttft),
        "ws_first_frame_minus_ttft_p50_s": p50(ws_first) - p50(ttft),
        "ws_frame_gap_p50_s": p50(ws_gaps), "engine_tpot_p50_s": p50(tpot),
        "ws_frame_gap_max_s": max(ws_gaps),
        "grpc_overhead_p50_s": p50(grpc_overhead), "grpc_overhead_s": grpc_overhead,
        "pubsub_publish_to_completion_p50_s": p50(pub_to_done),
        "pubsub_counts": pubsub_counts, "cron_fired": fired,
        "ninth_client": {"frames_read": len(ninth_frames), "ended": repr(ninth_error)},
        "tokens_equal_bf16": {k: v["tokens_equal"] for k, v in by_path.items()},
        "first_difference": {k: v["first_difference"] for k, v in by_path.items()},
        "a_launches_by_plan": {autotune.plan_name(r): pinned_rows.count(r)
                               for r in sorted(set(pinned_rows))},
        "launches": counts, "nvidia_smi": smi_line(), "note": "smoke run, not a benchmark",
    }


def launches_by_run(served: dict) -> dict[str, dict[str, int]]:
    """Each phase-4 run's launch counts by kernel: the runs that record one
    set, the spec engine of ``paged_control`` and the two sides of
    ``paged_handoff`` (summed over its arms)."""
    out = {}
    for r, v in served.items():
        counts = v.get("launches") if isinstance(v, dict) else None
        if isinstance(counts, dict) and counts and all(isinstance(n, int)
                                                       for n in counts.values()):
            out[r if isinstance(r, str) else run_name(*r)] = counts
    if "paged_control" in served:
        out["paged_control_spec"] = served["paged_control"]["spec"]["launches"]
    for side, counts in served.get("paged_handoff", {}).get("launches", {}).items():
        out[f"paged_handoff_{side}"] = counts
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

    served["http_planes"] = http_planes(torch, cuda, model, results["paged", ""])
    emit("phase4_http_planes", {**served["http_planes"], "arms": [
        {k: v for k, v in arm.items() if k != "batch_margin_at_first_difference"}
        for arm in served["http_planes"]["arms"]]})
    lap("phase4_http_planes")

    served["paged_w8"], w8_model = serve_w8(torch, cuda, model, served["paged", ""]["metrics"],
                                            results["paged", ""])
    emit("phase4_serve_paged_w8", {**served["paged_w8"]["metrics"],
                                   "launches": served["paged_w8"]["launches"]})
    lap("phase4_paged_w8")

    served["paged_warmup"] = serve_warmup(torch, cuda, model, results["paged", ""])
    emit("phase4_serve_paged_warmup", {k: v for k, v in served["paged_warmup"].items()
                                       if k != "margin_at_first_difference"})
    lap("phase4_paged_warmup")

    served["paged_restart"] = serve_restart(torch, cuda, model, results["paged", ""])
    emit("phase4_serve_paged_restart", {k: v for k, v in served["paged_restart"].items()
                                        if k != "margin_at_first_difference"})
    lap("phase4_paged_restart")

    for kv_quantize, capture in (("", True), ("int8", False)):
        name = f"{kv_quantize or 'paged'}_quality"
        served[name] = quality_run(torch, cuda, model, kv_quantize, results["paged", kv_quantize],
                                   capture)
        emit(f"phase4_serve_{name}", {k: v for k, v in served[name].items()
                                      if k != "margin_at_first_difference"})
        lap(f"phase4_{name}")

    served["paged_control"] = serve_control(torch, cuda, model, results["paged", ""])
    emit("phase4_serve_paged_control", served["paged_control"])
    lap("phase4_paged_control")

    served["paged_handoff"] = serve_handoff(torch, cuda, model, results, served)
    emit("phase4_serve_paged_handoff", served["paged_handoff"])
    lap("phase4_paged_handoff")

    served["cold_start"] = cold_start(torch)
    emit("phase4_cold_start", served["cold_start"])
    lap("phase4_cold_start")

    autotuned = serve_autotune(torch, cuda)
    emit("phase4_serve_paged_autotune", autotuned)
    for name, run in autotuned["runs"].items():
        served[f"paged_autotune_{name}"] = run
    lap("phase4_paged_autotune")

    served["app_transports"] = app_transports(torch, cuda, model, results["paged", ""])
    emit("phase4_app_transports", served["app_transports"])
    lap("phase4_app_transports")

    for kv_layout, kv_quantize in RUNS:
        emit(f"phase5_model_{run_name(kv_layout, kv_quantize)}",
             model_check(torch, model, kv_quantize, kv_layout=kv_layout))
        lap(f"phase5_{run_name(kv_layout, kv_quantize)}")
    emit("phase5_lora", [lora_check(torch, model, *run) for run in RUNS])
    lap("phase5_lora")
    # the int8-weight model on the bf16 pool: W8A16 against qdot_plain end to end
    emit("phase5_model_w8", {"weights": "int8", **model_check(torch, w8_model, "")})
    lap("phase5_w8")

    emit("phase6_no_sync", [no_sync_check(torch, cuda, m, *run)
                            for m, run in [(model, r) for r in RUNS] + [(w8_model, ("paged", ""))]])
    emit("phase6_dispatch_no_sync", [dispatch_sync_check(torch, m, *run) for m, run in
                                     [(model, r) for r in RUNS] + [(w8_model, ("paged", ""))]]
         + [dispatch_sync_check(torch, model, "paged", "", planes=True)])
    lap("phase6")

    # each kernel's launches from the first serving run whose path it is on,
    # and from every run that launched it
    by_run = launches_by_run(served)
    for k in kernels:
        run = next(r for r in (*RUNS, "paged_w8") if k["name"] in ON_PATH[r])
        k["launches"] = served[run]["launches"][k["name"]]
        k["launches_by_run"] = {r: lc[k["name"]] for r, lc in by_run.items() if lc.get(k["name"])}
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"kernels": kernels, "wall_s": wall,
                   "serve": {r if isinstance(r, str) else run_name(*r): run
                             for r, run in served.items()}}, f, indent=1)
    emit("wall_time", {"seconds": time.perf_counter() - start, "by_phase": wall})
    print(json.dumps({"kernels": [{key: k[key] for key in (
        "name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
        "bound_ms", "bound_by", "library_ms", "launches_by_run")} for k in kernels]}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
