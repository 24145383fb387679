#!/usr/bin/env python3
"""What does each piece of a kernel's design buy? (one card)

    python3 scripts/torch_kernel_variants.py

Each variant is a copy of ``gofr_tpu_torch/csrc`` with one design choice
undone (a text replacement, made and built under
``gofr_tpu_torch/build/variants/`` at run time; the sources in the checkout
are never changed). The unmodified build is held against the plain
versions (``chip_smoke.check_kernels``), each variant against the
unmodified build's outputs, and every build is timed twice, in the order
A B ... then ... B A, on
``chip_smoke.py``'s phase-3 shapes: the flash prefill (C) at 4 x 512 and
4 x 1024 causal, the slot decode (F), the paged decode (A) and the
quantized-pool decodes (D, E) at 8 live slots of 699..1591 and an empty
one, and the five appends (B, G, B-q, B-q4, G-q) at those slots' next
positions. Times are device times
(``chip_smoke.device_ms``), so a wrapper's host time does not hide a
kernel's.

Prints one JSON line per build and round, then the mean of each, and writes
them to ``chiprun_out/kernel_variants.json``. Exits non-zero if the
unmodified build fails ``chip_smoke.check_kernels`` or a variant's outputs
move by more than ``MAX_DIFF`` from the unmodified build's.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from gofr_tpu_torch.ops import cuda  # noqa: E402

# A variant only reorders or regroups the same arithmetic: its outputs may
# differ from the unmodified build's by rounding (a bf16 ulp of the largest
# flash outputs is 0.0156), never by more than this.
MAX_DIFF = 0.1
# the template's tensor-core score block (kernels A, D and E), which one
# variant replaces for D and E
SCORE_BLOCK = (
    "#pragma unroll\n"
    "    for (int nt = 0; nt < kWarpRows / 8; ++nt) {\n"
    "      const int t_base = warp * kWarpRows + nt * 8;\n"
    "      uint32_t b[kSteps][2];\n"
    "      Rows::k_frags(k_tile, t_base + quad, c, b);\n"
    "      float sc[4] = {0.f, 0.f, 0.f, 0.f};\n"
    "#pragma unroll\n"
    "      for (int s = 0; s < kSteps; ++s) {\n"
    "        const uint32_t a[4] = {qa[s][0], 0u, qa[s][1], 0u};\n"
    "        gofr::mma_bf16(sc, a, b[s][0], b[s][1]);\n"
    "      }\n"
    "      if (quad < group) {\n"
    "#pragma unroll\n"
    "        for (int e = 0; e < 2; ++e) {\n"
    "          const int t = t_base + 2 * c + e;\n"
    "          float x = sc[e] * scale;\n"
    "          if constexpr (Rows::kScaled) x *= __bfloat162float(ks_tile[t]);\n"
    "          p_s[quad][t] = (t0 + t < t_end) ? x : gofr::kNegInf;\n"
    "        }\n"
    "      }\n"
    "    }\n"
)
# the scores kernels D and E took before the tensor cores, one (query row,
# position) pair per thread and step in f32, each K element converted again
# for every query row (q staged in shared memory as f32; rows read 16 bytes
# at a time)
SCALAR_SCORES = (
    "      __shared__ float q_f[kMaxGroup][kD];\n"
    "      if (i == 0)\n"
    "        for (int j = tid; j < group * kD; j += kThreads)\n"
    "          q_f[j / kD][j % kD] =\n"
    "              __bfloat162float(q[((size_t)n * hq + h * group + j / kD) * kD + j % kD]);\n"
    "      __syncthreads();\n"
    "      for (int j = tid; j < group * kTile; j += kThreads) {\n"
    "        const int g = j / kTile, t = j % kTile;\n"
    "        const uint4* row = reinterpret_cast<const uint4*>(k_tile + Rows::offset(t, 0));\n"
    "        float s = 0.f;\n"
    "        for (int w4 = 0; w4 < Rows::kBytes / 16; ++w4) {\n"
    "          const uint4 x = row[w4];\n"
    "          const uint32_t words[4] = {x.x, x.y, x.z, x.w};\n"
    "#pragma unroll\n"
    "          for (int w = 0; w < 4; ++w) {\n"
    "            float v[Rows::kCols];\n"
    "            Rows::values(words[w], v);\n"
    "#pragma unroll\n"
    "            for (int e = 0; e < Rows::kCols; ++e)\n"
    "              s = fmaf(q_f[g][Rows::col(16 * w4 + 4 * w, e)], v[e], s);\n"
    "          }\n"
    "        }\n"
    "        p_s[g][t] = (t0 + t < t_end) ? s * scale * __bfloat162float(ks_tile[t]) : gofr::kNegInf;\n"
    "      }\n"
)
# kernels B and G as first ported: one block of 256 threads per slot,
# threads over Hkv x D with a div/mod per 2-byte element, each row loaded
# only after its position and table entry (and one launch for both planes)
OLD_APPENDS = """
constexpr int kOldThreads = 256;

__global__ void __launch_bounds__(kOldThreads) kv_append_kernel(
    uint16_t* __restrict__ k_pool, uint16_t* __restrict__ v_pool,
    const uint16_t* __restrict__ k_new, const uint16_t* __restrict__ v_new,
    const int* __restrict__ table, const int* __restrict__ positions,
    int maxp, int pool, int hkv, int page, int d) {
  const int n = blockIdx.x;
  const int pos = positions[n];
  if (pos < 0) return;
  const int logical = pos / page;
  if (logical >= maxp) return;
  const int entry = table[(size_t)n * maxp + logical];
  if (entry < 0 || entry >= pool) return;
  const int off = pos % page;
  const int row = hkv * d;
  for (int i = threadIdx.x; i < row; i += kOldThreads) {
    const int h = i / d, j = i % d;
    const size_t dst = (((size_t)entry * hkv + h) * page + off) * d + j;
    k_pool[dst] = k_new[(size_t)n * row + i];
    v_pool[dst] = v_new[(size_t)n * row + i];
  }
}

__global__ void __launch_bounds__(kOldThreads) kv_append_slot_kernel(
    uint16_t* __restrict__ k_layer, uint16_t* __restrict__ v_layer,
    const uint16_t* __restrict__ k_new, const uint16_t* __restrict__ v_new,
    const int* __restrict__ positions, int hkv, int smax, int d) {
  const int n = blockIdx.x;
  const int pos = positions[n];
  if (pos < 0 || pos >= smax) return;
  const int row = hkv * d;
  for (int i = threadIdx.x; i < row; i += kOldThreads) {
    const int h = i / d, j = i % d;
    const size_t dst = (((size_t)n * hkv + h) * smax + pos) * d + j;
    k_layer[dst] = k_new[(size_t)n * row + i];
    v_layer[dst] = v_new[(size_t)n * row + i];
  }
}

}  // namespace
"""
# (name, [(file, text to replace, replacement), ...])
VARIANTS = [
    # C: each K and V fragment loaded right before its mma.sync
    ("flash_attention: fragment loads not batched", [
        ("flash_attention.cu",
         "        ldmatrix_x4(kf[np], ks + (np * 16 + mrow + (mat >> 1) * 8) * kStride + kk * 16 + "
         "(mat & 1) * 8);\n#pragma unroll\n      for (int np = 0; np < kBK / 16; ++np) {\n",
         "      {\n        ldmatrix_x4(kf[np], ks + (np * 16 + mrow + (mat >> 1) * 8) * kStride + "
         "kk * 16 + (mat & 1) * 8);\n"),
        ("flash_attention.cu",
         "        for (int j = 0; j < kD / 32; ++j)\n          ldmatrix_x4_trans(",
         "        for (int j = 0; j < kD / 32; ++j) {\n          ldmatrix_x4_trans("),
        ("flash_attention.cu",
         "(half * 4 + j) * 16 + (mat >> 1) * 8);\n#pragma unroll\n        for (int j = 0; j < kD / 32; ++j) {\n",
         "(half * 4 + j) * 16 + (mat >> 1) * 8);\n"),
    ]),
    # C: three blocks per SM (Q staged in stage 1's K tile, 168 registers)
    ("flash_attention: three blocks per SM", [
        ("flash_attention.cu",
         "constexpr int kSmemBytes = (kBQ * kStride + 2 * kStages * kTileElems) * 2;",
         "constexpr int kSmemBytes = 2 * kStages * kTileElems * 2;"),
        ("flash_attention.cu", "__launch_bounds__(kThreads) flash_kernel(",
         "__launch_bounds__(kThreads, 3) flash_kernel("),
        ("flash_attention.cu",
         "  bf16* q_s = reinterpret_cast<bf16*>(smem);  // [kBQ][kStride], then the output tile\n"
         "  bf16* k_s = q_s + kBQ * kStride;            // [kStages][kBK][kStride]\n",
         "  bf16* k_s = reinterpret_cast<bf16*>(smem);\n  bf16* q_s = k_s + kTileElems;\n"),
        ("flash_attention.cu", "    const int k0 = i * kBK;\n    if (i + 1 < n_tiles) {",
         "    const int k0 = i * kBK;\n    if (i == 0) {\n      gofr::cp_async_wait<0>();\n"
         "      __syncthreads();\n#pragma unroll\n      for (int kk = 0; kk < kD / 16; ++kk)\n"
         "        ldmatrix_x4(qf[kk], q_s + (warp * 16 + (lane & 15)) * kStride + kk * 16 + "
         "(lane >> 4) * 8);\n      __syncthreads();\n    }\n    if (i + 1 < n_tiles) {"),
        ("flash_attention.cu",
         "    gofr::cp_async_wait<1>();\n    __syncthreads();\n    if (i == 0) {\n#pragma unroll\n"
         "      for (int kk = 0; kk < kD / 16; ++kk)\n        ldmatrix_x4(qf[kk], q_s + (warp * 16 + "
         "(lane & 15)) * kStride + kk * 16 + (lane >> 4) * 8);\n    }\n",
         "    if (i > 0) {\n      gofr::cp_async_wait<1>();\n      __syncthreads();\n    }\n"),
        ("flash_attention.cu", "bf16* o_s = q_s + warp * 16 * kStride;",
         "bf16* o_s = k_s + warp * 16 * kStride;"),
    ]),
    # C, A, D, E, F: exp2f for expf in the probabilities (changes the numerics slightly)
    ("online_softmax: exp2f probabilities", [
        ("online_softmax.cuh", "return expf(score - m_safe);",
         "return exp2f((score - m_safe) * 1.4426950408889634f);"),
    ]),
    # F: K/V staged with synchronous 16-byte loads (the ring's stages stay,
    # but each thread waits for its own loads)
    ("decode_attention: synchronous K/V loads", [
        ("paged_decode.cu",
         "      gofr::cp_async16(k_s + r * kStride + col, k + base, ok);\n"
         "      gofr::cp_async16(v_s + r * kStride + col, v + base, ok);\n",
         "      *reinterpret_cast<uint4*>(k_s + r * kStride + col) =\n"
         "          ok ? *reinterpret_cast<const uint4*>(k + base) : make_uint4(0, 0, 0, 0);\n"
         "      *reinterpret_cast<uint4*>(v_s + r * kStride + col) =\n"
         "          ok ? *reinterpret_cast<const uint4*>(v + base) : make_uint4(0, 0, 0, 0);\n"),
    ]),
    # F: one split per (slot, head), finished in place
    ("decode_attention: one split", [
        ("paged_decode.cu",
         "  return launch(q, k_cache, v_cache, rows, lengths, out, scratch, n, hkv, group, split_rows,\n"
         "                splits, scale, stream);",
         "  return launch(q, k_cache, v_cache, rows, lengths, out, scratch, n, hkv, group, smax, 1,\n"
         "                scale, stream);"),
    ]),
    # A, D and E: one split per (slot, head), finished in place
    ("paged_decode/_q/_q4: one split", [
        ("paged_decode_q.cu", "  const PoolLength pool_len{maxp, page};\n",
         "  const PoolLength pool_len{maxp, page};\n  split_rows = maxp * page;\n  splits = 1;\n"),
    ]),
    # A, D and E: each 16-byte chunk's row address through a table read of
    # its own (the entries are still staged, and not used)
    ("paged_decode/_q/_q4: per-chunk table reads", [
        ("paged_decode_q.cu", "const int e = min(max(entry[t / page - first], 0), pool - 1);",
         "const int e = min(max(row_table[t / page], 0), pool - 1);"),
    ]),
    # A, D and E: rows (and scales) staged with synchronous 16-byte loads
    # (the ring's stages and the table entries' copies stay)
    ("paged_decode/_q/_q4: synchronous row and scale loads", [
        ("paged_decode_q.cu",
         "      gofr::cp_async16(&ring[st][0][Rows::offset(r, col)], k_pool + base, ok);\n"
         "      gofr::cp_async16(&ring[st][1][Rows::offset(r, col)], v_pool + base, ok);\n",
         "      *reinterpret_cast<uint4*>(&ring[st][0][Rows::offset(r, col)]) =\n"
         "          ok ? *reinterpret_cast<const uint4*>(k_pool + base) : make_uint4(0, 0, 0, 0);\n"
         "      *reinterpret_cast<uint4*>(&ring[st][1][Rows::offset(r, col)]) =\n"
         "          ok ? *reinterpret_cast<const uint4*>(v_pool + base) : make_uint4(0, 0, 0, 0);\n"),
        ("paged_decode_q.cu",
         "          gofr::cp_async16(&scales_s[st][tid / 8][r], (tid < 8 ? k_scale : v_scale) + "
         "(ok ? at(t) : 0),\n                           ok);\n",
         "          *reinterpret_cast<uint4*>(&scales_s[st][tid / 8][r]) =\n"
         "              ok ? *reinterpret_cast<const uint4*>((tid < 8 ? k_scale : v_scale) + at(t))\n"
         "                 : make_uint4(0, 0, 0, 0);\n"),
    ]),
    # A: P.V in f32 FMAs on p rounded to bf16 (option a: D and E's loop with
    # 8-byte words, four columns a lane), not on the tensor cores
    ("paged_decode: P.V in f32 FMAs", [
        ("paged_decode_q.cu", "static constexpr bool kMmaPV = true;",
         "static constexpr bool kMmaPV = false;"),
    ]),
    # D and E: the scalar scores above (A keeps the tensor cores)
    ("paged_decode_q/_q4: K dequantized per query row", [
        ("paged_decode_q.cu", SCORE_BLOCK,
         "    if constexpr (Rows::kScaled) {\n" + SCALAR_SCORES + "    } else {\n" + SCORE_BLOCK
         + "    }\n"),
    ]),
    # B and G: the first design (OLD_APPENDS) behind the same entry points
    ("kv_append/_slot: one block per slot, 2-byte copies, loads after the table", [
        ("kv_append.cu", "}  // namespace\n", OLD_APPENDS),
        ("kv_append.cu",
         "  return launch<Bf16Rows>(planes(k_pool, v_pool, nullptr, nullptr, k_new, v_new), positions,\n"
         "                          pool_addr(table, maxp, pool, page), n, hkv, d, stream);\n",
         "  kv_append_kernel<<<n, kOldThreads, 0, static_cast<cudaStream_t>(stream)>>>(\n"
         "      static_cast<uint16_t*>(k_pool), static_cast<uint16_t*>(v_pool),\n"
         "      static_cast<const uint16_t*>(k_new), static_cast<const uint16_t*>(v_new),\n"
         "      static_cast<const int*>(table), static_cast<const int*>(positions), maxp, pool, hkv,\n"
         "      page, d);\n"
         "  return static_cast<int>(cudaGetLastError());\n"),
        ("kv_append.cu",
         "  return launch<Bf16Rows>(planes(k_layer, v_layer, nullptr, nullptr, k_new, v_new), positions,\n"
         "                          SlotAddr{smax}, n, hkv, d, stream);\n",
         "  kv_append_slot_kernel<<<n, kOldThreads, 0, static_cast<cudaStream_t>(stream)>>>(\n"
         "      static_cast<uint16_t*>(k_layer), static_cast<uint16_t*>(v_layer),\n"
         "      static_cast<const uint16_t*>(k_new), static_cast<const uint16_t*>(v_new),\n"
         "      static_cast<const int*>(positions), hkv, smax, d);\n"
         "  return static_cast<int>(cudaGetLastError());\n"),
    ]),
    # all five appends: one launch per plane instead of one for both
    ("kv_append (all five): separate K and V launches", [
        ("kv_append.cu",
         "  const dim3 grid((n * hkv + kWarps - 1) / kWarps, 2);\n"
         "  append_kernel<Rows, Addr><<<grid, kThreads, 0, s>>>(planes, static_cast<const int*>(positions), addr,\n"
         "                                                      n, hkv);\n",
         "  const dim3 grid((n * hkv + kWarps - 1) / kWarps, 1);\n"
         "  Planes v_planes = planes;\n"
         "  v_planes.k = planes.v;\n"
         "  v_planes.ks = planes.vs;\n"
         "  v_planes.k_new = planes.v_new;\n"
         "  append_kernel<Rows, Addr><<<grid, kThreads, 0, s>>>(planes, static_cast<const int*>(positions), addr,\n"
         "                                                      n, hkv);\n"
         "  append_kernel<Rows, Addr><<<grid, kThreads, 0, s>>>(v_planes, static_cast<const int*>(positions),\n"
         "                                                      addr, n, hkv);\n"),
    ]),
]


def make(index: int, variant) -> dict:
    name, edits = variant
    root = cuda.BUILD / "variants" / f"v{index}"
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(cuda.CSRC, root / "csrc")
    for fname, old, new in edits:
        path = root / "csrc" / fname
        text = path.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"variant {name!r}: the text to replace occurs {text.count(old)} times "
                             f"in {fname}")
        path.write_text(text.replace(old, new))
    return cuda.build(root / "csrc", root / "build")


def cases(torch) -> dict:
    """The timed calls, fn(i), at chip_smoke's phase-3 shapes."""
    from gofr_tpu_torch.ops.cuda.decode_attention import decode_attention
    from gofr_tpu_torch.ops.cuda.flash_attention import flash_attention
    from gofr_tpu_torch.ops.cuda.kv_append import (
        kv_append,
        kv_append_q,
        kv_append_q4,
        kv_append_slot,
        kv_append_slot_q,
    )
    from gofr_tpu_torch.ops.cuda.paged_decode import paged_decode
    from gofr_tpu_torch.ops.cuda.paged_decode_q import paged_decode_q
    from gofr_tpu_torch.ops.cuda.paged_decode_q4 import paged_decode_q4
    from gofr_tpu_torch.ops.kvcache import QSlotKVCache

    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    out = {}
    for s in (512, 1024):
        q, k, v = (torch.randn(4, s, h, 128, device=dev, generator=gen).to(bf) for h in (32, 8, 8))
        out[f"flash_4x{s}"] = lambda i, q=q, k=k, v=v: flash_attention(q, k, v, causal=True)
    c = chip_smoke._decode_case(torch)
    sc = chip_smoke._slot_case(torch, c)
    q, lengths, table, layers = c["q"], c["lengths"], c["table"], c["layers"]
    out["slot_decode"] = lambda i: decode_attention(q, sc["k"][i % layers], sc["v"][i % layers], lengths)
    out["paged_decode"] = lambda i: paged_decode(q, c["k_pool"][i % layers], c["v_pool"][i % layers],
                                                 table, lengths)
    for name, launch, bits in (("paged_decode_q", paged_decode_q, 8),
                               ("paged_decode_q4", paged_decode_q4, 4)):
        pool = c["pools"][bits]
        out[name] = lambda i, pool=pool, launch=launch: launch(
            q, pool.k[i % layers], pool.v[i % layers], pool.ks[i % layers], pool.vs[i % layers], table,
            lengths)
    # the appends at each slot's next position (rows past the decodes' lengths)
    k_new, v_new = (torch.randn(c["n"], c["hkv"], c["d"], device=dev, generator=gen).to(bf)
                    for _ in range(2))
    qslot = QSlotKVCache.create(layers, c["n"], sc["smax"], c["hkv"], c["d"], device=dev)
    out["kv_append"] = lambda i: kv_append(c["k_pool"][i % layers], c["v_pool"][i % layers], table,
                                           lengths, k_new, v_new)
    out["kv_append_slot"] = lambda i: kv_append_slot(sc["k"][i % layers], sc["v"][i % layers], lengths,
                                                     k_new, v_new)
    for name, launch, bits in (("kv_append_q", kv_append_q, 8), ("kv_append_q4", kv_append_q4, 4)):
        pool = c["pools"][bits]
        out[name] = lambda i, pool=pool, launch=launch: launch(
            pool.k[i % layers], pool.v[i % layers], pool.ks[i % layers], pool.vs[i % layers], table,
            lengths, k_new, v_new)
    out["kv_append_slot_q"] = lambda i: kv_append_slot_q(
        qslot.k[i % layers], qslot.v[i % layers], qslot.ks[i % layers], qslot.vs[i % layers], lengths,
        k_new, v_new)
    return out


def flat(result) -> "torch.Tensor":
    """A call's output as one f32 vector (an append returns the planes it
    wrote)."""
    import torch

    parts = result if isinstance(result, tuple) else (result,)
    return torch.cat([t.float().flatten() for t in parts])


def diff_from(calls: dict, wants: dict) -> dict:
    """Max |output - the unmodified build's output| per call."""
    return {name: (flat(fn(0)) - wants[name]).abs().max().item() for name, fn in calls.items()}


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_variants: no CUDA device available")
    os.chdir(REPO)
    with ThreadPoolExecutor(max_workers=4) as pool:
        clean = pool.submit(cuda.build)
        builds = [clean, *(pool.submit(make, i, v) for i, v in enumerate(VARIANTS))]
        libraries = [b.result()["library"] for b in builds]
    names = ["unmodified", *(v[0] for v in VARIANTS)]
    cuda.load(libraries[0])
    for kernel in chip_smoke.check_kernels(torch, timed=False):
        if not kernel["passed"]:
            raise SystemExit(f"the unmodified build fails {kernel['name']}")
    calls = cases(torch)
    wants = {name: flat(fn(0)) for name, fn in calls.items()}
    rows = []
    # A B C ... then ... C B A, the unmodified build first and last
    for order in (range(len(names)), reversed(range(len(names)))):
        for i in order:
            cuda.load(libraries[i])
            row = {"build": names[i], "diff_from_unmodified": diff_from(calls, wants),
                   "device_ms": {name: chip_smoke.device_ms(torch, fn, 20) for name, fn in calls.items()}}
            print(json.dumps(row), flush=True)
            rows.append(row)
    mean = {name: {call: sum(r["device_ms"][call] for r in rows if r["build"] == name) / 2
                   for call in calls} for name in names}
    bad = [r["build"] for r in rows if max(r["diff_from_unmodified"].values()) > MAX_DIFF]
    summary = {"mean_device_ms": mean, "nvidia_smi": chip_smoke.smi_line()}
    print(json.dumps(summary))
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "kernel_variants.json"), "w") as f:
        json.dump({"rows": rows, "summary": summary}, f, indent=1)
    if bad:
        raise SystemExit(f"variants that change the output: {bad}")


if __name__ == "__main__":
    main()
