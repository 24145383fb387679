#!/usr/bin/env python3
"""Does ``chip_smoke.py``'s kernel check catch a wrong kernel? (one card)

    python3 scripts/torch_kernel_mutants.py [NAME_PART ...]

With NAME_PART arguments, only the mutants whose names hold one of them
are planted (``flash_attention w8a16``: C's and W8A16's); the unmodified
build is always checked in full.

Each mutant is a copy of ``gofr_tpu_torch/csrc`` with one planted fault (a
length mask off by one, a live tile skipped, a key left out of P.V, ...),
made and built under ``gofr_tpu_torch/build/mutants/`` at run time; the
sources in the checkout are never changed. Every mutant library is loaded
in turn and put through ``chip_smoke.check_kernels`` (the same inputs and
per-kernel limits, untimed), every kernel checked even after one fails, so
a fault in code that two kernels share shows in both. The unmodified
sources go first and must pass. Then the builds named in ``PHASE5`` are
read through ``chip_smoke.model_check`` (a full-width Llama-3-8B with
random weights from the seed, end to end, kernels against plain) on the
caches named there; these readings are reported, not judged. Kernels A,
D and E (the page pool's decodes) are one template in
``paged_decode_q.cu``, so a fault in its shared body lands in all three;
the merge of a split decode (``split_merge.cuh``) is one kernel for F, A,
D and E; the five appends (B, G, B-q, B-q4, G-q) are one template in
``kv_append.cu``, held bit for bit. The W8A16 linear's weight stream,
its split's second pass, the bf16 wgmma tiles and the f32 build's
mma.sync tiles are one source, ``w8a16.cu``: a fault in the wgmma tiles
must fail ``w8a16`` alone, one in the mma.sync tiles ``w8a16_f32`` alone
(``ONLY``). Kernels C, A, F,
B and G are each one template at head dims 128 and 64, so a fault in
their bodies lands in both builds; the mutants in ``ONLY`` plant a fault
in the 64 builds alone (C's masks; A's, F's, B's and G's half row and a
128-wide row stride), which must fail their checks while the 128 builds
pass. Phase 3 holds each 64 build on layer 0 of a stack of layers, so a
row read or written at twice its stride stays inside the stack. Since D,
E, B-q, B-q4 and G-q are built at 64 too, their 64 builds have faults of
their own in ``ONLY``; those that read or write past a buffer
(``ISOLATED``) have their faulting kernels checked in a child process.
Every kernel also has f32 builds: F and G's are their templates' f32
instantiations, A's f32 build is F's f32 body with the pool's address
policy and B's G's f32 rows with the pool's address, D's and E's f32-q
builds are their template with a three-piece q, B-q's, B-q4's and G-q's
f32-row builds theirs with F32Rows as the input, and W8A16's f32 build its
two tilings with a three-piece x, so a fault in those bodies lands in the
f32 builds too; C's f32 build is a kernel of its own in a source of its
own (``flash_attention_f32.cu``: tf32 wgmma fed by TMA), so C's masks and
tile walk have a mutant in each source, and the f32 body's mechanism has
its own: a phase parity flipped (a ring that never fills, trapped), Vt's
keys in their natural order, a product of P.V dropped, and the maps'
positions running past S into the next batch row (a 2-D map's reading).
The f32-only mutants in ``ONLY`` (C's lo products dropped, F's and A's P
rounded to bf16, G's and B's half row, A reading the next page's table
entry for the last tile of each page, the three-piece split that D, E and
W8A16 share rounded to bf16 once, then E's q and W8A16's x each alone,
B-q's and G-q's f32 rows read as bf16 halves, B-q4's alone, and G-q's f32
entry point built on bf16 rows) must fail the f32 checks while the bf16
checks pass.

Prints one JSON line per build, then a summary, and writes them all to
``chiprun_out/kernel_mutants.json``. Exits non-zero if the unmodified build
fails or a mutant marked ``must_catch`` passes. A mutant not so marked
records what the check cannot resolve.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from gofr_tpu_torch.models.llama import LlamaConfig, init  # noqa: E402
from gofr_tpu_torch.ops import cuda  # noqa: E402

# (name, file, text to replace, replacement, must_catch)
MUTANTS = [
    # kernels A, D and E are one template in paged_decode_q.cu
    ("paged_decode/_q/_q4: one key past the length", "paged_decode_q.cu",
     "min(max(lengths[n], 0), maxp * page)", "min(max(lengths[n] + 1, 0), maxp * page)", True),
    ("paged_decode/_q/_q4: last live key dropped", "paged_decode_q.cu",
     "min(max(lengths[n], 0), maxp * page)", "min(max(lengths[n] - 1, 0), maxp * page)", True),
    # the scores of the sequence's first 64 rows masked: as if never loaded
    ("paged_decode/_q/_q4: first live tile skipped", "paged_decode_q.cu",
     "p_s[quad][t] = (t0 + t < t_end)", "p_s[quad][t] = (t0 >= kTile && t0 + t < t_end)", True),
    # position 16k + 15 of every tile out of the tensor-core P.V (still in l)
    ("paged_decode: last key of every 16 left out of P.V", "paged_decode_q.cu",
     "a[2] = bf16_pair(hi.x, hi.y);", "a[2] = bf16_pair(hi.x, c == 3 ? 0.f : hi.y);", True),
    ("decode_attention: first live tile skipped", "paged_decode.cu",
     "p_s[g][t] = (t0 + t < t_end)", "p_s[g][t] = (t0 >= kTile && t0 + t < t_end)", True),
    ("decode_attention: last key of each tile left out of P.V", "paged_decode.cu",
     "for (int t = 0; t < kTile; ++t) {", "for (int t = 0; t < kTile - 1; ++t) {", True),
    ("decode_attention: one key past the length", "paged_decode.cu",
     "min(max(lengths[n], 0), smax)", "min(max(lengths[n] + 1, 0), smax)", True),
    ("decode_attention: last live key dropped", "paged_decode.cu",
     "min(max(lengths[n], 0), smax)", "min(max(lengths[n] - 1, 0), smax)", True),
    # the lane past the slot reads five rows of the next head
    ("decode_attention: length not clamped to Smax", "paged_decode.cu",
     "min(max(lengths[n], 0), smax)", "max(lengths[n], 0)", True),
    # the five appends are one template in kv_append.cu: B, B-q, B-q4 share
    # PoolAddr, G and G-q SlotAddr, B-q, B-q4 and G-q the quantizer
    ("kv_append/_q/_q4: row one past the position", "kv_append.cu",
     "const int off = pos % page;", "const int off = (pos + 1) % page;", True),
    ("kv_append/_q/_q4: no drop at pos // page == MaxP", "kv_append.cu",
     "if (logical >= maxp) return -1;", "if (logical > maxp) return -1;", True),
    ("kv_append_slot/_slot_q: row one past the position", "kv_append.cu",
     "* smax + pos;", "* smax + pos + 1;", True),
    ("kv_append_slot/_slot_q: no drop at pos == Smax", "kv_append.cu",
     "pos >= smax", "pos > smax", True),
    ("kv_append_q/_q4/_slot_q: round toward zero", "kv_append.cu",
     "__float2int_rn(x[i] / s)", "__float2int_rz(x[i] / s)", True),
    ("kv_append_q/_q4/_slot_q: the scale from one lane's max, not the warp's", "kv_append.cu",
     "for (int o = 16; o > 0; o >>= 1)", "for (int o = 16; o > 16; o >>= 1)", True),
    ("kv_append_q/_q4/_slot_q: K and V scales written to each other's plane", "kv_append.cu",
     "bf16* scales = is_v ? p.vs : p.ks;", "bf16* scales = is_v ? p.ks : p.vs;", True),
    ("kv_append_q4: nibble halves swapped", "kv_append.cu",
     "static_cast<uint32_t>(lo + kBias) | (static_cast<uint32_t>(hi + kBias) << 4)",
     "static_cast<uint32_t>(hi + kBias) | (static_cast<uint32_t>(lo + kBias) << 4)", True),
    ("kv_append_q4: bias of 7 instead of 8", "kv_append.cu",
     "constexpr int kBias = 8;", "constexpr int kBias = 7;", True),
    ("flash_attention: causal diagonal masked", "flash_attention.cu",
     "(!causal || pos >= kv)", "(!causal || pos > kv)", True),
    ("flash_attention: one key past kv_length", "flash_attention.cu",
     "!(kv < kl &&", "!(kv <= kl &&", True),
    ("flash_attention: last key tile skipped", "flash_attention.cu",
     "n_tiles = (kv_end + kBK - 1) / kBK;", "n_tiles = (kv_end - 1) / kBK;", True),
    ("flash_attention: online rescale of O skipped", "flash_attention.cu",
     "o[j][0] *= alpha[0], o[j][1] *= alpha[0], o[j][2] *= alpha[1], o[j][3] *= alpha[1];",
     "(void)alpha;", True),
    # C's f32 body (flash_attention_f32.cu, a source of its own): the masks
    # and the tile walk as in the bf16 body, then faults of its mechanism
    ("flash_attention_f32: causal diagonal masked", "flash_attention_f32.cu",
     "(!causal || pos >= kv)", "(!causal || pos > kv)", True),
    ("flash_attention_f32: one key past kv_length", "flash_attention_f32.cu",
     "!(kv < kl &&", "!(kv <= kl &&", True),
    ("flash_attention_f32: last key tile skipped", "flash_attention_f32.cu",
     "n_tiles = (kv_end + kBK - 1) / kBK;", "n_tiles = (kv_end - 1) / kBK;", True),
    ("flash_attention_f32: online rescale of O skipped", "flash_attention_f32.cu",
     "o[4 * j] *= alpha[0], o[4 * j + 1] *= alpha[0], o[4 * j + 2] *= alpha[1], o[4 * j + 3] *= alpha[1];",
     "(void)alpha;", True),
    ("flash_attention_d64_f32: one key past kv_length", "flash_attention_f32.cu",
     "!(kv < kl &&", "!(kv < kl + (kD == 64) &&", True),
    ("flash_attention_d64_f32: causal diagonal masked", "flash_attention_f32.cu",
     "(!causal || pos >= kv)", "(!causal || pos >= kv + (kD == 64))", True),
    # the consumers wait for K's lo plane of tile i with the parity of the
    # phase after: late for a tile, they wait for the next tile's plane,
    # which the producer writes only after this tile's S (a ring that never
    # fills, trapped by mbar_wait's limit; checked in a child, ``ISOLATED``)
    ("flash_attention_f32: the lo plane's phase parity flipped", "flash_attention_f32.cu",
     "gofr::mbar_wait(klo_ready, i & 1);", "gofr::mbar_wait(klo_ready, (i & 1) ^ 1);", True),
    ("flash_attention_f32: Vt's keys in their natural order", "flash_attention_f32.cu",
     "8 * (g >> 1) + (g & 1) + 2 * j", "4 * g + j", True),
    ("flash_attention_f32: P.hi Vt.lo dropped from P.V", "flash_attention_f32.cu",
     "gofr::WgmmaTf32<kD>::rs(o, p_hi[j], step_desc(vtlo_at, j, L::kVtChunk), 1);",
     "(void)vtlo_at;", True),
    # the maps' positions running on past S into the next batch row, as a
    # 2-D map over B.S rows reads them (past the last row: past the tensor,
    # so checked in a child, ``ISOLATED``); phase 3 puts NaN in V there (K
    # and Q past S are harmless: their keys are masked, their rows never
    # stored)
    ("flash_attention_f32: the last partial tile read past its row (a 2-D map over B.S rows)",
     "flash_attention_f32.cu",
     "static_cast<cuuint64_t>(seq), static_cast<cuuint64_t>(batch)};",
     "static_cast<cuuint64_t>(seq) * batch, static_cast<cuuint64_t>(batch)};", True),
    # faults in the head-dim-64 build alone (BERT, ViT, GPT-2): the 128 build
    # must still pass (``ONLY``)
    ("flash_attention_d64: one key past kv_length", "flash_attention.cu",
     "!(kv < kl &&", "!(kv < kl + (kD == 64) &&", True),
    ("flash_attention_d64: causal diagonal masked", "flash_attention.cu",
     "(!causal || pos >= kv)", "(!causal || pos >= kv + (kD == 64))", True),
    # A, F, B and G's 64 builds alone (``ONLY``): half of each row, and a
    # row stride of 128 elements (the 128 build's) in the 64 build
    ("paged_decode_d64: half of each output row never summed", "paged_decode_q.cu",
     "gofr::mma_bf16(pv[2 * pair + 1], a, vf[2], vf[3]);",
     "if (kD == 128) gofr::mma_bf16(pv[2 * pair + 1], a, vf[2], vf[3]);", True),
    ("paged_decode_d64: a 128-wide row stride", "paged_decode_q.cu",
     "const size_t base = (ok ? at(t) * Rows::kBytes : 0) + col;",
     "const size_t base = (ok ? at(t) * Rows::kBytes * (kD == 64 ? 2 : 1) : 0) + col;", True),
    ("decode_attention_d64: half of each output row never summed", "paged_decode.cu",
     "if (g < group) acc[g] = fmaf(p_s[g][t], vt, acc[g]);",
     "if (g < group && (kD == 128 || tid < kD / 2)) acc[g] = fmaf(p_s[g][t], vt, acc[g]);", True),
    ("decode_attention_d64: a 128-wide row stride", "paged_decode.cu",
     "return (((size_t)n * hkv + h) * smax + t) * kD;",
     "return (((size_t)n * hkv + h) * smax + t) * (kD == 64 ? 128 : kD);", True),
    ("kv_append_d64/_slot_d64: half of each row left unwritten", "kv_append.cu",
     "else reinterpret_cast<uint32_t*>(dst)[lane] = raw.x;",
     "else if (lane < 16) reinterpret_cast<uint32_t*>(dst)[lane] = raw.x;", True),
    ("kv_append_d64/_slot_d64: a 128-wide row stride", "kv_append.cu",
     "Rows::store(values + row * Rows::kRowBytes, scales + row, raw, lane);",
     "Rows::store(values + row * Rows::kRowBytes * (Rows::kD == 64 ? 2 : 1), scales + row, raw, lane);",
     True),
    # D, E, B-q, B-q4 and G-q's 64 builds alone (``ONLY``): the final sum of
    # D and E writing a column a thread for all 128 threads (at 64, threads
    # 64..127 write the next query row's columns and read past the warps'
    # sums); D64 walking a 64-byte row as the 128 build walks its 128 bytes
    # (32 a quad thread: the other half of its K fragments from the next
    # row, of its Q fragments past the head); E64's high nibbles taken as
    # columns 64 up, the 128 build's half, for q; the quantizer's max over
    # one of a lane's two elements (half the row: the odd columns of an
    # int8 row, the second half of an int4 one)
    ("paged_decode_q_d64/_q4_d64: the final sum unguarded past head dim 64",
     "paged_decode_q.cu", "if (tid < kD) {", "if (true) {", True),
    ("paged_decode_q_d64: the 128 build's fragment walk (32 B a quad thread)",
     "paged_decode_q.cu",
     "static constexpr int kFragBytes = kBytes / 4;  // bytes of a row one thread of a quad reads",
     "static constexpr int kFragBytes = 32;", True),
    ("paged_decode_q4_d64: the halves split at 64 bytes, not 32 (the scores)", "paged_decode_q.cu",
     "return (s >= kSteps / 2 ? kBytes : 0) + c * kFragBytes + (s % (kSteps / 2)) * 4;",
     "return (s >= kSteps / 2 ? 64 : 0) + c * kFragBytes + (s % (kSteps / 2)) * 4;", True),
    ("kv_append_q_d64/_q4_d64/_slot_q_d64: the max over half the row", "kv_append.cu",
     "for (int i = 0; i < N; ++i) a = fmaxf(a, fabsf(x[i]));",
     "for (int i = 0; i < (N == 2 ? 1 : N); ++i) a = fmaxf(a, fabsf(x[i]));", True),
    # keys 8..15 of every 16-key step left out of P.V (for half the columns)
    ("flash_attention: second k16-half of a fragment dropped from P.V", "flash_attention.cu",
     "mma_bf16(o[2 * dp], pf[kk], vf[j][0], vf[j][1]);", "mma_bf16(o[2 * dp], pf[kk], vf[j][0], 0u);", True),
    # the merge is one kernel for F, A, D and E
    ("decode_attention/paged_decode/_q/_q4: last live split left out of the merge", "split_merge.cuh",
     "for (int s = 0; s < live; ++s) {", "for (int s = 0; s < live - 1; ++s) {", True),
    ("decode_attention/paged_decode/_q/_q4: a split's max ignored in the merge (no rescale)",
     "split_merge.cuh",
     "const float w = expf(st[s * kState + kD] - safe);", "const float w = 1.f;", True),
    ("decode_attention: split boundaries overlapping by one row", "paged_decode.cu",
     "min(len, t_begin + split_rows);", "min(len, t_begin + split_rows + 1);", True),
    ("paged_decode_q/_q4: ks fold dropped", "paged_decode_q.cu",
     "x *= __bfloat162float(ks_tile[t]);", "x *= 1.f;", True),
    # each score scaled by the next row's K scale (the last row's by the first's)
    ("paged_decode_q/_q4: K scales one row off", "paged_decode_q.cu",
     "ks_tile[t]", "ks_tile[(t + 1) % kTile]", True),
    ("paged_decode_q/_q4: vs fold dropped", "online_softmax.cuh",
     "row[lane] = p.x * vs[lane];\n  row[lane + 32] = p.y * vs[lane + 32];",
     "row[lane] = p.x;\n  row[lane + 32] = p.y;", True),
    ("paged_decode/_q/_q4: split boundaries overlapping by one row", "paged_decode_q.cu",
     "min(len, t_begin + split_rows);", "min(len, t_begin + split_rows + 1);", True),
    # rows addressed through the entries staged for the tile before (the
    # right page only where both tiles lie in one page)
    ("paged_decode/_q/_q4: a tile read through the previous tile's table entries",
     "paged_decode_q.cu", "const int* entry = entries_s[i % kEntryBufs];",
     "const int* entry = entries_s[(i + kEntryBufs - 1) % kEntryBufs];", True),
    ("paged_decode_q4: nibble halves swapped", "paged_decode_q.cu",
     "kLoShift = 0, kHiShift = 4", "kLoShift = 4, kHiShift = 0", True),
    ("paged_decode_q4: bias of 7 instead of 8", "paged_decode_q.cu",
     "kBias = 8", "kBias = 7", True),
    # the W8A16 linear: the stream (M <= 64, split over K or not), the
    # split's second pass and the tiles (M > 64) are one source
    ("w8a16: the next channel's scale after a split", "w8a16.cu",
     "scaled<TX>(acc, s[i % n])", "scaled<TX>(acc, s[(i + 1) % n])", True),
    ("w8a16: the last chunk of K dropped (stream)", "w8a16.cu",
     "const int c_end = min(chunks, c_begin + per_split);",
     "const int c_end = min(chunks - 1, c_begin + per_split);", True),
    # the mma.sync tiles are the f32 build's alone (``ONLY``)
    ("w8a16_f32: the last k tile dropped (mma.sync tiles)", "w8a16.cu",
     "const int tiles = (k + kBK - 1) / kBK;", "const int tiles = (k - 1) / kBK;", True),
    ("w8a16: the first split's partial summed twice", "w8a16.cu",
     "float acc = 0.f;", "float acc = partial[i];", True),
    # y = bf16(acc * bf16(s)): one rounding instead of two, an ulp off where
    # bf16(acc) rounds away
    ("w8a16: the sum's rounding to bf16 skipped", "w8a16.cu",
     "return __float2bfloat16(__bfloat162float(__float2bfloat16(acc)) *",
     "return __float2bfloat16(acc *", True),
    ("w8a16: every fourth weight one code off (the int8 bias)", "w8a16.cu",
     "__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.f",
     "__byte_perm(u, 0x4B000000u, 0x7650)) - 8388735.f", True),
    ("w8a16: the X pairs of a step swapped (stream)", "w8a16.cu",
     "mma_bf16(sum, frag[t], xw[p][2 * t], xw[p][2 * t + 1]);",
     "mma_bf16(sum, frag[t], xw[p][2 * t + 1], xw[p][2 * t]);", True),
    ("w8a16_f32: a B fragment's upper k pair read from the lower (mma.sync tiles)", "w8a16.cu",
     "*reinterpret_cast<const uint16_t*>(qr + 8)", "*reinterpret_cast<const uint16_t*>(qr)", True),
    # the bf16 wgmma tiles alone (``ONLY``): the last 64-k stage never
    # loaded nor summed; the producer refilling a stage its consumers still
    # read (the empty barrier's phase off by one after the first pass: an
    # early refill, or a ring that never fills, which the wait's limit
    # turns into a trap; checked in a child, ``ISOLATED``); X's boxes loaded
    # unswizzled under the descriptor's 128-byte swizzle; Q's fragments read
    # as if unswizzled; the grid one channel tile short where N is ragged
    # (the edge holds, ``W8_EDGES``); the epilogue's sum not rounded to bf16
    ("w8a16: the last k stage dropped (wgmma tiles)", "w8a16.cu",
     "const int k_steps = (k + kGK - 1) / kGK;", "const int k_steps = (k - 1) / kGK;", True),
    ("w8a16: a stage refilled before its consumers released it (wgmma tiles)", "w8a16.cu",
     "gofr::mbar_wait(&empty[st], ((kt / T::kStages) & 1) ^ 1);",
     "gofr::mbar_wait(&empty[st], ((kt / T::kStages + (kt >= T::kStages)) & 1) ^ 1);", True),
    ("w8a16: X's boxes unswizzled (wgmma tiles)", "w8a16.cu",
     "CU_TENSOR_MAP_SWIZZLE_128B", "CU_TENSOR_MAP_SWIZZLE_NONE", True),
    ("w8a16: Q's fragments read without the 64-byte swizzle (wgmma tiles)", "w8a16.cu",
     "const int at = ((t ^ sw) << 4) | ((c >> 1) << 2);", "const int at = (t << 4) | ((c >> 1) << 2);",
     True),
    ("w8a16: the last ragged channel tile skipped (wgmma tiles)", "w8a16.cu",
     "(n + kGChannels - 1) / kGChannels", "n / kGChannels", True),
    ("w8a16: the sum's rounding to bf16 skipped (wgmma tiles)", "w8a16.cu",
     "const auto y = [](float v, float sc) { return scaled<bf16>(v, sc); };",
     "const auto y = [](float v, float sc) {\n"
     "      return __float2bfloat16(v * __bfloat162float(__float2bfloat16(sc)));\n    };", True),
    # faults in the f32 builds alone (``ONLY``): C's products in one pass of
    # TF32 (the lo terms dropped), F's P rounded to bf16 before P.V (as the
    # bf16 build does), G's f32 rows half written
    ("flash_attention_f32: the lo terms dropped (plain TF32)", "flash_attention_f32.cu",
     "float tf32_lo(float x) { return x - tf32_hi(x); }",
     "float tf32_lo(float x) { return 0.f * x; }", True),
    ("decode_attention_f32/paged_decode_f32: P rounded to bf16", "online_softmax.cuh",
     "row[lane] = pa;", "row[lane] = round_bf16(pa);", True),
    ("kv_append_slot_f32/kv_append_f32: half of each row left unwritten", "kv_append.cu",
     "reinterpret_cast<Raw*>(dst)[lane] = raw;",
     "if (lane < 16) reinterpret_cast<Raw*>(dst)[lane] = raw;", True),
    # A's f32 build (the pool's address policy): the last 32-row tile of
    # each page read through the next page's table entry
    ("paged_decode_f32: the next table entry at a page edge", "paged_decode.cu",
     "const int logical = t / page;", "const int logical = (t + 32) / page;", True),
    # the three-piece split (mma.cuh split_pair) that D's and E's f32-q
    # builds and W8A16's f32 build share: the f32 operand rounded to bf16
    # once (the m and l pieces dropped)
    ("paged_decode_q_f32/_q4_f32/w8a16_f32: the f32 operand rounded to bf16 once", "mma.cuh",
     "  m = *reinterpret_cast<const uint32_t*>(&m2);\n  l = *reinterpret_cast<const uint32_t*>(&l2);\n",
     "  m = l = 0u;\n", True),
    # E's f32-q build alone: q rounded to bf16 once (only the h piece's
    # product; Int4Rows is the one row policy of eight P.V columns a word)
    ("paged_decode_q4_f32: q rounded to bf16 once", "paged_decode_q.cu",
     "for (int p = kQPieces - 1; p >= 0; --p) {",
     "for (int p = Rows::kCols == 8 ? 0 : kQPieces - 1; p >= 0; --p) {", True),
    # W8A16's f32 build alone, both tilings: x rounded to bf16 once
    ("w8a16_f32: x rounded to bf16 once", "w8a16.cu",
     "for (int p = kPieces - 1; p >= 0; --p)  // the smallest piece first",
     "for (int p = 0; p >= 0; --p)  // the smallest piece first", True),
    # B-q's and G-q's f32-row builds (Int8Rows with F32Rows input): the f32
    # rows read as bf16 halves
    ("kv_append_q_f32/_slot_q_f32: f32 rows read as bf16 halves", "kv_append.cu",
     "    In::unpack(raw, x);\n    const float s = quantize<127>(x, q);\n",
     "    Bf16Rows<D>::unpack(make_uint2(raw.x, raw.y), x);\n    const float s = quantize<127>(x, q);\n",
     True),
    # B-q4's f32-row build alone: the same in the int4 rows' store
    ("kv_append_q4_f32: f32 rows read as bf16 halves", "kv_append.cu",
     "    In::unpack(raw, x);\n    const float s = quantize<7>(x, q);\n",
     "    Bf16Rows<D>::unpack(make_uint2(raw.x, raw.y), x);\n    const float s = quantize<7>(x, q);\n",
     True),
    # G-q's f32-row entry point alone (128): built on bf16 rows, so it reads
    # each f32 row as bf16 elements at a bf16 row's stride
    ("kv_append_slot_q_f32: the f32 rows read as bf16 rows", "kv_append.cu",
     "  return launch<Int8Rows<128, F32Rows<128>>>(\n      planes(k_layer,",
     "  return launch<Int8Rows<128>>(\n      planes(k_layer,", True),
    # p kept in f32 instead of rounded to bf16 before P.V (A packs it for
    # the tensor cores by truncation, F multiplies it in f32): a relative
    # change of at most 2^-8 on each probability, averaged over hundreds of
    # keys, is below a bf16 ulp of the outputs, so no output check can see it
    ("online_softmax: p not rounded to bf16", "online_softmax.cuh",
     "row[lane] = round_bf16(pa);\n  row[lane + 32] = round_bf16(pb);",
     "row[lane] = pa;\n  row[lane + 32] = pb;", False),
]

# Mutants whose fault lies in the head-dim-64 instantiations: (the kernels
# that must fail, the kernels built from the same source that must pass)
_C64 = (("flash_attention_d64",), ("flash_attention", "flash_attention_f32", "flash_attention_d64_f32"))
_C64_32 = (("flash_attention_d64_f32",), ("flash_attention_f32", "flash_attention", "flash_attention_d64"))
_DECODE128 = ("paged_decode", "paged_decode_q", "paged_decode_q4")
_APPEND128 = ("kv_append", "kv_append_slot", "kv_append_q", "kv_append_q4", "kv_append_slot_q")
_QAPPEND64 = ("kv_append_q_d64", "kv_append_q4_d64", "kv_append_slot_q_d64")
_F64 = (("decode_attention_d64",), ("decode_attention",))
_C32 = ("flash_attention_f32", "flash_attention_d64_f32")
_F_BF16 = ("decode_attention", "decode_attention_d64")
_F32 = ("decode_attention_f32", "decode_attention_d64_f32")
_A32 = ("paged_decode_f32", "paged_decode_d64_f32")
_D32 = ("paged_decode_q_f32", "paged_decode_q_d64_f32")
_E32 = ("paged_decode_q4_f32", "paged_decode_q4_d64_f32")
_BQ32 = ("kv_append_q_f32", "kv_append_q_d64_f32")
_BQ432 = ("kv_append_q4_f32", "kv_append_q4_d64_f32")
_GQ32 = ("kv_append_slot_q_f32", "kv_append_slot_q_d64_f32")
ONLY = {"flash_attention_d64: one key past kv_length": _C64,
        "flash_attention_d64: causal diagonal masked": _C64,
        "paged_decode_d64: half of each output row never summed":
            (("paged_decode_d64",), (*_DECODE128, "paged_decode_q_d64", "paged_decode_q4_d64")),
        "paged_decode_d64: a 128-wide row stride":
            (("paged_decode_d64", "paged_decode_q_d64", "paged_decode_q4_d64"), _DECODE128),
        "decode_attention_d64: half of each output row never summed": _F64,
        "decode_attention_d64: a 128-wide row stride": _F64,
        "kv_append_d64/_slot_d64: half of each row left unwritten":
            (("kv_append_d64", "kv_append_slot_d64"), (*_APPEND128, *_QAPPEND64)),
        "kv_append_d64/_slot_d64: a 128-wide row stride":
            (("kv_append_d64", "kv_append_slot_d64", *_QAPPEND64), _APPEND128),
        "paged_decode_q_d64/_q4_d64: the final sum unguarded past head dim 64":
            (("paged_decode_q_d64", "paged_decode_q4_d64", "paged_decode_q_d64_f32",
              "paged_decode_q4_d64_f32"),
             (*_DECODE128, "paged_decode_d64")),
        "paged_decode_q_d64: the 128 build's fragment walk (32 B a quad thread)":
            (("paged_decode_q_d64", "paged_decode_q_d64_f32"), (*_DECODE128, "paged_decode_q4_d64")),
        "paged_decode_q4_d64: the halves split at 64 bytes, not 32 (the scores)":
            (("paged_decode_q4_d64", "paged_decode_q4_d64_f32"),
             (*_DECODE128, "paged_decode_q_d64")),
        "kv_append_q_d64/_q4_d64/_slot_q_d64: the max over half the row":
            (_QAPPEND64, (*_APPEND128, "kv_append_d64", "kv_append_slot_d64")),
        **{name: (_C32, ("flash_attention", "flash_attention_d64")) for name in (
            "flash_attention_f32: the lo terms dropped (plain TF32)",
            "flash_attention_f32: causal diagonal masked",
            "flash_attention_f32: one key past kv_length",
            "flash_attention_f32: last key tile skipped",
            "flash_attention_f32: online rescale of O skipped",
            "flash_attention_f32: the lo plane's phase parity flipped",
            "flash_attention_f32: Vt's keys in their natural order",
            "flash_attention_f32: P.hi Vt.lo dropped from P.V",
            "flash_attention_f32: the last partial tile read past its row (a 2-D map over B.S rows)")},
        "flash_attention_d64_f32: one key past kv_length": _C64_32,
        "flash_attention_d64_f32: causal diagonal masked": _C64_32,
        "decode_attention_f32/paged_decode_f32: P rounded to bf16":
            ((*_F32, *_A32), (*_F_BF16, *_DECODE128)),
        "kv_append_slot_f32/kv_append_f32: half of each row left unwritten":
            (("kv_append_slot_f32", "kv_append_slot_d64_f32", "kv_append_f32", "kv_append_d64_f32"),
             (*_APPEND128, "kv_append_d64", "kv_append_slot_d64", *_QAPPEND64)),
        "paged_decode_f32: the next table entry at a page edge":
            (_A32, (*_F_BF16, *_F32, *_DECODE128)),
        "paged_decode_q_f32/_q4_f32/w8a16_f32: the f32 operand rounded to bf16 once":
            ((*_D32, *_E32, "w8a16_f32"),
             (*_DECODE128, "paged_decode_q_d64", "paged_decode_q4_d64", "w8a16")),
        "paged_decode_q4_f32: q rounded to bf16 once":
            (_E32, (*_DECODE128, "paged_decode_q_d64", "paged_decode_q4_d64", *_D32)),
        "w8a16_f32: x rounded to bf16 once": (("w8a16_f32",), ("w8a16",)),
        **{name: (("w8a16_f32",), ("w8a16",)) for name in (
            "w8a16_f32: the last k tile dropped (mma.sync tiles)",
            "w8a16_f32: a B fragment's upper k pair read from the lower (mma.sync tiles)")},
        **{name: (("w8a16",), ("w8a16_f32",)) for name in (
            "w8a16: the last k stage dropped (wgmma tiles)",
            "w8a16: a stage refilled before its consumers released it (wgmma tiles)",
            "w8a16: X's boxes unswizzled (wgmma tiles)",
            "w8a16: Q's fragments read without the 64-byte swizzle (wgmma tiles)",
            "w8a16: the last ragged channel tile skipped (wgmma tiles)",
            "w8a16: the sum's rounding to bf16 skipped (wgmma tiles)")},
        "kv_append_q_f32/_slot_q_f32: f32 rows read as bf16 halves":
            ((*_BQ32, *_GQ32), (*_APPEND128, *_QAPPEND64, *_BQ432)),
        "kv_append_q4_f32: f32 rows read as bf16 halves":
            (_BQ432, (*_APPEND128, *_QAPPEND64, *_BQ32, *_GQ32)),
        "w8a16: the last chunk of K dropped (stream)":
            (("w8a16", "w8a16_f32"), (*_DECODE128, *_APPEND128)),
        "kv_append_slot_q_f32: the f32 rows read as bf16 rows":
            (("kv_append_slot_q_f32",),
             (*_APPEND128, *_QAPPEND64, *_BQ32, *_BQ432, "kv_append_slot_q_d64_f32"))}
# Mutants whose text occurs more than once in its source, planted at
# every occurrence: how many times it occurs
OCCURS = {name: 2 for name in (
    # the W8A16 stream's and tiles' piece loops
    "w8a16_f32: x rounded to bf16 once",
)}
# Mutants whose 64 build reads or writes past a buffer (global memory past
# q or the output, shared memory past the ring): the kernels ``ONLY`` says
# must fail are checked in a child process, so a launch that faults the
# CUDA context fails there, as a caught mutant, and the other kernels are
# checked here as usual.
# The W8A16 stream built with its last chunk dropped faults the card in
# some of its builds (bf16 at five token tiles, f32 at one, and bf16 at one
# with the chunk loop's break written as a skip), at every plan: the PTX is
# right, but ptxas (nvcc 12.9.86) folds the staging loop's trip count into
# a three-input VIMNMX3 and drops the neg.s32 that ~(chunks - 1) = -chunks
# needs, so the loop runs past its stage and its copies land past the
# shared allocation (PERF.md §7). The unmodified source takes ~chunks by a
# NOT, which ptxas keeps, and runs clean over scripts/torch_w8a16_probe.py's
# sweep of shapes and plans.
ISOLATED = {"paged_decode_q_d64/_q4_d64: the final sum unguarded past head dim 64",
            "paged_decode_q_d64: the 128 build's fragment walk (32 B a quad thread)",
            "paged_decode_q4_d64: the halves split at 64 bytes, not 32 (the scores)",
            "w8a16: the last chunk of K dropped (stream)",
            "w8a16: a stage refilled before its consumers released it (wgmma tiles)",
            "flash_attention_f32: the lo plane's phase parity flipped",
            "flash_attention_f32: the last partial tile read past its row (a 2-D map over B.S rows)"}

# Builds also read through chip_smoke's phase 5 (the model end to end), on
# the caches named, (kv_layout, kv_quantize): the unmodified build, the
# nearest fault of each decode kernel and a fault of the prefill kernel, to
# see which faults phase 5 resolves beside a clean reading.
PHASE5 = {"unmodified": chip_smoke.RUNS,
          "paged_decode/_q/_q4: one key past the length": (("paged", ""), ("paged", "int8"),
                                                           ("paged", "int4")),
          "flash_attention: causal diagonal masked": (("paged", "int4"),),
          "decode_attention: one key past the length": (("slot", ""),)}


def make(index: int, mutant) -> dict:
    name, fname, old, new, _ = mutant
    root = cuda.BUILD / "mutants" / f"m{index}"
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(cuda.CSRC, root / "csrc")
    path = root / "csrc" / fname
    text = path.read_text()
    if text.count(old) != OCCURS.get(name, 1):
        raise SystemExit(f"mutant {name!r}: the text to replace occurs {text.count(old)} times in {fname}")
    path.write_text(text.replace(old, new))
    return cuda.build(root / "csrc", root / "build")


def kernel_verdicts(torch, library: Path, only: set | None = None,
                    skip: set = frozenset()) -> dict:
    """Each kernel's check on one library (``chip_smoke.check_kernels``'s
    ``only`` and ``skip``): its verdict, error numbers and failure."""
    cuda.load(library)
    kernels = chip_smoke.check_kernels(torch, timed=False, keep_going=True, only=only, skip=skip)
    return {k["name"]: {m: k[m] for m in ("passed", "max_abs_err", "rms_rel_err", "failure")
                        if m in k} for k in kernels}


def isolated_verdicts(library: Path, names: tuple) -> dict:
    """``kernel_verdicts`` of ``names`` in a child process; a child that
    dies (a launch that faulted the CUDA context) fails each of them."""
    child = subprocess.run([sys.executable, __file__, "--verdicts", str(library), ",".join(names)],
                           capture_output=True, text=True, timeout=600)
    if child.returncode == 0:
        return json.loads(child.stdout.strip().splitlines()[-1])
    died = (child.stderr.strip().splitlines() or ["no output"])[-1]
    return {k: {"passed": False, "failure": f"the checking process died: {died}"} for k in names}


def verdict(torch, name: str, library: Path) -> dict:
    """Every kernel's check on one library, the faulting ones of an
    ``ISOLATED`` mutant in a child: passed only if all pass."""
    if name in ISOLATED:
        apart = ONLY[name][0]
        kernels = {**kernel_verdicts(torch, library, skip=set(apart)),
                   **isolated_verdicts(library, apart)}
    else:
        kernels = kernel_verdicts(torch, library)
    return {"passed": all(k["passed"] for k in kernels.values()), "kernels": kernels}


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_mutants: no CUDA device available")
    os.chdir(REPO)
    if sys.argv[1:2] == ["--verdicts"]:
        print(json.dumps(kernel_verdicts(torch, Path(sys.argv[2]), set(sys.argv[3].split(",")))))
        return
    parts = sys.argv[1:]
    chosen = [(i, m) for i, m in enumerate(MUTANTS) if not parts or any(s in m[0] for s in parts)]
    plan = [("unmodified", None, None, None, False), *(m for _, m in chosen)]
    with ThreadPoolExecutor(max_workers=4) as pool:
        clean = pool.submit(cuda.build)
        builds = [clean, *(pool.submit(make, i, m) for i, m in chosen)]
        libraries = [b.result()["library"] for b in builds]
    results, bad = [], []
    for (name, fname, _, _, must_catch), library in zip(plan, libraries):
        row = {"mutant": name, "file": fname, "must_catch": must_catch,
               **verdict(torch, name, library)}
        print(json.dumps(row), flush=True)
        results.append(row)
        if (fname is None and not row["passed"]) or (must_catch and row["passed"]):
            bad.append(name)
        if name in ONLY:
            failing, passing = ONLY[name]
            if (any(row["kernels"][k]["passed"] for k in failing)
                    or not all(row["kernels"][k]["passed"] for k in passing)):
                bad.append(name)
    torch.cuda.empty_cache()
    model = init(LlamaConfig.llama3_8b(), torch.Generator(device="cuda").manual_seed(chip_smoke.SEED),
                 "cuda")
    for row, library in zip(results, libraries):
        if row["mutant"] in PHASE5:
            cuda.load(library)
            row["phase5"] = {chip_smoke.run_name(*run): chip_smoke.model_check(
                torch, model, run[1], enforce=False, kv_layout=run[0]) for run in PHASE5[row["mutant"]]}
            print(json.dumps({"mutant": row["mutant"], "phase5": row["phase5"]}), flush=True)
    summary = {"caught": sum(not r["passed"] for r in results[1:]), "mutants": len(chosen),
               "unexpected": bad, "nvidia_smi": chip_smoke.smi_line()}
    print(json.dumps(summary))
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "kernel_mutants.json"), "w") as f:
        json.dump({"results": results, "summary": summary}, f, indent=1)
    if bad:
        raise SystemExit(f"unexpected verdicts: {bad}")


if __name__ == "__main__":
    main()
