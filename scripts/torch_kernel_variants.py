#!/usr/bin/env python3
"""What does each piece of a kernel's design buy? (one card)

    python3 scripts/torch_kernel_variants.py [NAME_PART ...]

Each variant is a copy of ``gofr_tpu_torch/csrc`` with one design choice
undone (a text replacement, made and built under
``gofr_tpu_torch/build/variants/`` at run time; the sources in the checkout
are never changed). The unmodified build is held against the plain
versions (``chip_smoke.check_kernels``), each variant against the
unmodified build's outputs, and every build is timed twice, in the order
A B ... then ... B A (the unmodified build on every call, a variant on the
calls of the kernels its edited files hold, ``CASES_OF``), on
``chip_smoke.py``'s phase-3 shapes: the flash prefill (C) at 4 x 512 and
4 x 1024 causal, its f32 build at the phase's six f32 shapes beside SDPA in
f32 on the same inputs (``sdpa_f32_*``, timed with every build that edits
its source), the slot decode (F), the paged decode (A) and the
quantized-pool decodes (D, E) at 8 live slots of 699..1591 and an empty
one (and D and E's head-dim-64 builds at Llama one_b's step), the five
appends (B, G, B-q, B-q4, G-q) at those slots' next
positions, and the W8A16 linear at Llama-3-8B's five shapes for 8 rows
(decode), 40 (verify) and 2048 (prefill), with the bf16 wgmma tiles and
the weight stream each forced at ``FORCED_ROWS`` (the ``w8a16_tiles_*``
and ``w8a16_stream_*`` calls; on the mma.sync variants the tiles are
those), also on a GPT-2-width head. Times are device times
(``chip_smoke.device_ms``), so a wrapper's host time does not hide a
kernel's.

With NAME_PART arguments, only the variants whose names hold one of them
are built (the unmodified build is timed on every call all the same).

Prints one JSON line per build and round, then the mean of each and the
W8A16 sums over a Llama-3-8B forward's products (``forwards``), and writes
them to ``chiprun_out/kernel_variants.json``.

    python3 scripts/torch_kernel_variants.py --serve-w8 "VARIANT NAME"

instead serves ``chip_smoke.py``'s ``paged_w8`` run (Llama-3-8B with int8
weights) on the unmodified build and on the named variant, A B B A, and
prints each run's TTFT and decode tok/s. Exits non-zero if the
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

# W8A16's rows at which the bf16 tiles (token width 64) and the weight
# stream are each forced, beside each other, and a GPT-2-width head (N, K)
# of 393 channel tiles, timed at those rows too
FORCED_ROWS = (8, 16, 24, 40, 64)
GPT2_HEAD = (50257, 768)
# A variant only reorders or regroups the same arithmetic: its outputs may
# differ from the unmodified build's by rounding (a bf16 ulp of the largest
# flash outputs is 0.0156), never by more than this.
MAX_DIFF = 0.1
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
# W8A16's mma.sync tiles on bf16 X, which the source keeps for f32 X
# alone: ldmatrix A fragments of staged bf16 rows (144 bytes), pair stores
# of bf16 outputs, and the bf16 build routed to them
MMA_SYNC_BF16 = [
    ("w8a16.cu", "template <class TX>\nstruct TileX;\n",
     "template <class TX>\nstruct TileX {\n"
     "  static constexpr int kPieces = 1;\n"
     "  __device__ static void frags(const bf16* xt, int row, int kk, int lane,\n"
     "                               uint32_t (&a)[kPieces][4]) {\n"
     "    gofr::ldmatrix_x4(a[0], xt + (row + lane % 16) * kXRow + kk * 16 + (lane / 16) * 8);\n"
     "  }\n"
     "};\n"),
    ("w8a16.cu", "__device__ __forceinline__ void store_pair(float* o, float y0, float y1) {",
     "__device__ __forceinline__ void store_pair(bf16* o, bf16 y0, bf16 y1) {\n"
     "  *reinterpret_cast<__nv_bfloat162*>(o) = __halves2bfloat162(y0, y1);\n"
     "}\n"
     "__device__ __forceinline__ void store_pair(float* o, float y0, float y1) {"),
    ("w8a16.cu", "if constexpr (std::is_same_v<TX, bf16>) {", "if constexpr (false) {"),
]
# the rule of W8A16's wgmma tiles for the k16 steps of a group by token width
GROUP_STEPS = "return BN >= 256 ? 1 : kGK / 16;"
# kernel C's first f32 body (PR 22), which the wgmma body replaced, put
# behind the same entry points
PR22_F32 = r"""
// The first f32 body (PR 22): four warps of 16 query rows, K and V through a
// two-stage cp.async ring in rows padded by 16 bytes, each product as three
// mma.sync.m16n8k8 tf32 on fragments loaded as 32-bit shared words and split
// into hi and lo by every warp.
namespace pr22 {

constexpr int kBQ = 64, kBK = 64, kWarps = 4, kThreads = 32 * kWarps, kStages = 2;

template <int kD>
struct Dims {
  static constexpr int kPerChunk = 4;
  static constexpr int kStride = kD + kPerChunk;
  static constexpr int kChunks = kD / kPerChunk;
  static constexpr int kTileElems = kBK * kStride;
  static constexpr int kSmemBytes = (kBQ * kStride + 2 * kStages * kTileElems) * 4;
};

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct Tf32Pair {
  uint32_t hi, lo;
};

__device__ __forceinline__ uint32_t rna_bits(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ Tf32Pair split_tf32(float x) {
  const uint32_t hi = rna_bits(x);
  return {hi, rna_bits(x - __uint_as_float(hi))};
}

__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4], Tf32Pair b0, Tf32Pair b1) {
  mma_tf32(d, a_lo, b0.hi, b1.hi);
  mma_tf32(d, a_hi, b0.lo, b1.lo);
  mma_tf32(d, a_hi, b0.hi, b1.hi);
}

template <int kD>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int row0, int valid,
                                           size_t pitch) {
  constexpr int kChunks = Dims<kD>::kChunks, kStride = Dims<kD>::kStride;
  for (int c = threadIdx.x; c < kBK * kChunks; c += kThreads) {
    const int r = c / kChunks, col = (c % kChunks) * Dims<kD>::kPerChunk;
    const bool ok = row0 + r < valid;
    gofr::cp_async16(dst + r * kStride + col, src + (ok ? (size_t)(row0 + r) * pitch : 0) + col, ok);
  }
}

template <int kD>
__global__ void __launch_bounds__(kThreads) flash_kernel_f32(
    const float* __restrict__ q,          // [B, Sq, Hq, D]
    const float* __restrict__ k,          // [B, Skv, Hkv, D]
    const float* __restrict__ v,          // [B, Skv, Hkv, D]
    const int* __restrict__ q_offset,     // [B]
    const int* __restrict__ kv_lengths,   // [B]
    float* __restrict__ out,              // [B, Sq, Hq, D]
    int sq, int skv, int hq, int hkv, int group, int causal, float scale) {
  using Dm = Dims<kD>;
  constexpr int kStride = Dm::kStride, kChunks = Dm::kChunks, kTileElems = Dm::kTileElems;
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);  // [kBQ][kStride], then the output tile
  float* k_s = q_s + kBQ * kStride;             // [kStages][kBK][kStride]
  float* v_s = k_s + kStages * kTileElems;      // [kStages][kBK][kStride]

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;  // longest causal tiles first
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;  // mma fragment row group, thread in group
  const int qo = q_offset[b];
  const int kl = min(max(kv_lengths[b], 0), skv);
  const size_t q_pitch = (size_t)hq * kD, kv_pitch = (size_t)hkv * kD;
  const float* qb = q + ((size_t)b * sq * hq + h) * kD;
  const float* kb = k + ((size_t)b * skv * hkv + h / group) * kD;
  const float* vb = v + ((size_t)b * skv * hkv + h / group) * kD;
  const int kv_end = max(causal ? min(kl, qo + q0 + kBQ) : kl, 0);
  const int n_tiles = (kv_end + kBK - 1) / kBK;
  const int pos_lo = qo + q0 + warp * 16 + gid, pos_hi = pos_lo + 8;

  stage_rows<kD>(q_s, qb, q0, sq, q_pitch);
  if (n_tiles > 0) {
    stage_rows<kD>(k_s, kb, 0, skv, kv_pitch);
    stage_rows<kD>(v_s, vb, 0, skv, kv_pitch);
  }
  gofr::cp_async_commit();

  // this thread's Q elements: rows gid and gid + 8 of the warp's 16, at
  // column tig of each 8-wide step of d (and tig + 4)
  const float* q_lo = q_s + (warp * 16 + gid) * kStride + tig;
  const float* q_hi = q_lo + 8 * kStride;
  float o[kD / 8][4];  // O accumulators, one per 8-wide tile of d
#pragma unroll
  for (int j = 0; j < kD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  gofr::RowState st[2] = {gofr::row_init(), gofr::row_init()};

  for (int i = 0; i < n_tiles; ++i) {
    const int k0 = i * kBK;
    if (i + 1 < n_tiles) {
      const int next = (i + 1) % kStages;
      stage_rows<kD>(k_s + next * kTileElems, kb, k0 + kBK, skv, kv_pitch);
      stage_rows<kD>(v_s + next * kTileElems, vb, k0 + kBK, skv, kv_pitch);
    }
    gofr::cp_async_commit();
    gofr::cp_async_wait<1>();
    __syncthreads();
    const float* ks = k_s + (i % kStages) * kTileElems;
    const float* vs = v_s + (i % kStages) * kTileElems;

    // S = Q K^T: 16 rows x 64 keys per warp, 8 n-tiles of 8 keys, kD / 8
    // k-steps; each fragment split into tf32 hi and lo as it is loaded
    float s[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < kD / 8; ++kk) {
      const int c = kk * 8;
      const Tf32Pair a0 = split_tf32(q_lo[c]), a1 = split_tf32(q_hi[c]);
      const Tf32Pair a2 = split_tf32(q_lo[c + 4]), a3 = split_tf32(q_hi[c + 4]);
      const uint32_t a_hi[4] = {a0.hi, a1.hi, a2.hi, a3.hi};
      const uint32_t a_lo[4] = {a0.lo, a1.lo, a2.lo, a3.lo};
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        // B[c'][key] = K[key][c']: key j * 8 + gid, columns tig and tig + 4
        const float* kr = ks + (j * 8 + gid) * kStride + c + tig;
        mma_3xtf32(s[j], a_hi, a_lo, split_tf32(kr[0]), split_tf32(kr[4]));
      }
    }

    // scale, and mask only a tile that crosses the diagonal or holds kv_length
    const bool edge = k0 + kBK > kl || (causal && k0 + kBK - 1 > qo + q0);
    float tile_max[2] = {gofr::kNegInf, gofr::kNegInf};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kv = k0 + j * 8 + 2 * tig + (e & 1);
        const int pos = e < 2 ? pos_lo : pos_hi;
        float x = s[j][e] * scale;
        if (edge && !(kv < kl && (!causal || pos >= kv))) x = gofr::kNegInf;
        s[j][e] = x;
        tile_max[e >> 1] = fmaxf(tile_max[e >> 1], x);
      }
    }
    float alpha[2], safe[2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      alpha[r] = gofr::row_rescale(st[r], gofr::quad_max(tile_max[r]), &safe[r]);

    // P in place of S, f32 and unrounded; l sums it
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      s[j][0] = gofr::row_prob(s[j][0], safe[0]), s[j][1] = gofr::row_prob(s[j][1], safe[0]);
      s[j][2] = gofr::row_prob(s[j][2], safe[1]), s[j][3] = gofr::row_prob(s[j][3], safe[1]);
      st[0].l += s[j][0] + s[j][1];
      st[1].l += s[j][2] + s[j][3];
    }

    // O = O * alpha + P V: 16 rows x kD columns per warp
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      o[j][0] *= alpha[0], o[j][1] *= alpha[0], o[j][2] *= alpha[1], o[j][3] *= alpha[1];
    }
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      // k-step j: keys j * 8 .. + 7, k index tig for key 2 tig and tig + 4
      // for key 2 tig + 1, the two keys S's accumulator gives this thread
      const Tf32Pair p0 = split_tf32(s[j][0]), p1 = split_tf32(s[j][2]);
      const Tf32Pair p2 = split_tf32(s[j][1]), p3 = split_tf32(s[j][3]);
      const uint32_t p_hi[4] = {p0.hi, p1.hi, p2.hi, p3.hi};
      const uint32_t p_lo[4] = {p0.lo, p1.lo, p2.lo, p3.lo};
      const float* vr = vs + (j * 8 + 2 * tig) * kStride + gid;  // V[key 2 tig][gid]
#pragma unroll
      for (int n = 0; n < kD / 8; ++n)
        mma_3xtf32(o[n], p_hi, p_lo, split_tf32(vr[n * 8]), split_tf32(vr[kStride + n * 8]));
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // Q's copies may still be in flight when no tile was loaded
  gofr::cp_async_wait<0>();
  __syncthreads();
  const float l_lo = gofr::quad_sum(st[0].l), l_hi = gofr::quad_sum(st[1].l);
  float* o_s = q_s + warp * 16 * kStride;  // this warp's 16 rows of the Q tile
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    const int col = j * 8 + 2 * tig;
    *reinterpret_cast<float2*>(o_s + gid * kStride + col) =
        make_float2(gofr::row_finish(o[j][0], l_lo), gofr::row_finish(o[j][1], l_lo));
    *reinterpret_cast<float2*>(o_s + (gid + 8) * kStride + col) =
        make_float2(gofr::row_finish(o[j][2], l_hi), gofr::row_finish(o[j][3], l_hi));
  }
  __syncwarp();
  for (int c = lane; c < 16 * kChunks; c += 32) {
    const int r = c / kChunks, col = (c % kChunks) * 4, row = q0 + warp * 16 + r;
    if (row < sq)
      *reinterpret_cast<float4*>(out + (((size_t)b * sq + row) * hq + h) * kD + col) =
          *reinterpret_cast<const float4*>(o_s + r * kStride + col);
  }
}


template <int kD>
int launch(const void* q, const void* k, const void* v, const void* q_offset,
           const void* kv_lengths, void* out, int b, int sq, int skv, int hq, int hkv, int causal,
           float scale, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel_f32<kD>, cudaFuncAttributeMaxDynamicSharedMemorySize, Dims<kD>::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid(hq, b, (sq + kBQ - 1) / kBQ);
  flash_kernel_f32<kD><<<grid, kThreads, Dims<kD>::kSmemBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(q_offset), static_cast<const int*>(kv_lengths),
      static_cast<float*>(out), sq, skv, hq, hkv, hq / hkv, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pr22

"""
# C's f32 body with the split rule it did not take: hi = rna(x) (cvt.rna),
# exact in tf32 whatever the tensor cores do with a raw word, written over
# K's stage by the producer and over Q's words and P by the consumers, where
# the body reads the raw words as hi (their truncation, as the tensor cores
# read them)
RNA_HI = [
    ("flash_attention_f32.cu", "  return __uint_as_float(__float_as_uint(x) & 0xffffe000u);",
     "  uint32_t r;\n  asm(\"cvt.rna.tf32.f32 %0, %1;\\n\" : \"=r\"(r) : \"f\"(x));\n"
     "  return __uint_as_float(r);"),
    ("flash_attention_f32.cu", "  const float4* src = reinterpret_cast<const float4*>(stage);",
     "  float4* src = reinterpret_cast<float4*>(stage);"),
    ("flash_attention_f32.cu",
     "    dst[i] = make_float4(tf32_lo(x.x), tf32_lo(x.y), tf32_lo(x.z), tf32_lo(x.w));\n",
     "    dst[i] = make_float4(tf32_lo(x.x), tf32_lo(x.y), tf32_lo(x.z), tf32_lo(x.w));\n"
     "    src[i] = make_float4(tf32_hi(x.x), tf32_hi(x.y), tf32_hi(x.z), tf32_hi(x.w));\n"),
    ("flash_attention_f32.cu", "      qhi[t][r] = __float_as_uint(x);",
     "      qhi[t][r] = __float_as_uint(tf32_hi(x));"),
    ("flash_attention_f32.cu", "        p_hi[j][r] = __float_as_uint(pr);",
     "        p_hi[j][r] = __float_as_uint(tf32_hi(pr));"),
]
PR22_ENTRIES = [
    ("flash_attention_f32.cu", "// One entry point a head dim (d must be 128",
     PR22_F32 + "// One entry point a head dim (d must be 128"),
    ("flash_attention_f32.cu", "  return launch<128>(q, k, v,", "  return pr22::launch<128>(q, k, v,"),
    ("flash_attention_f32.cu", "  return launch<64>(q, k, v,", "  return pr22::launch<64>(q, k, v,"),
]
# the timed calls (by the start of their names) of the kernels each source
# file holds: a variant is timed on those of the files it edits
CASES_OF = {"flash_attention.cu": ("flash_4x",),
            "flash_attention_f32.cu": ("flash_f32_", "sdpa_f32_"),
            "hopper.cuh": ("flash_f32_", "sdpa_f32_", "w8a16_"),
            "online_softmax.cuh": ("flash_", "slot_decode", "paged_decode"),
            "paged_decode.cu": ("slot_decode", "paged_decode"),
            "paged_decode_q.cu": ("paged_decode",),
            "kv_append.cu": ("kv_append",),
            "w8a16.cu": ("w8a16_",)}
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
         "        for (int j = 0; j < 4; ++j)\n          ldmatrix_x4_trans(",
         "        for (int j = 0; j < 4; ++j) {\n          ldmatrix_x4_trans("),
        ("flash_attention.cu",
         "(half * 4 + j) * 16 + (mat >> 1) * 8);\n#pragma unroll\n        for (int j = 0; j < 4; ++j) {\n",
         "(half * 4 + j) * 16 + (mat >> 1) * 8);\n"),
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
         "  return launch<128, bf16>(q, k_cache, v_cache, SlotRows<128>{smax}, lengths, out, scratch, n,\n"
         "                           hkv, group, split_rows, splits, scale, stream);",
         "  return launch<128, bf16>(q, k_cache, v_cache, SlotRows<128>{smax}, lengths, out, scratch, n,\n"
         "                           hkv, group, smax, 1, scale, stream);"),
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
    # B and G: the first design (OLD_APPENDS) behind the same entry points
    ("kv_append/_slot: one block per slot, 2-byte copies, loads after the table", [
        ("kv_append.cu", "}  // namespace\n", OLD_APPENDS),
        ("kv_append.cu",
         "  return launch<Bf16Rows<128>>(planes(k_pool, v_pool, nullptr, nullptr, k_new, v_new), positions,\n"
         "                               pool_addr(table, maxp, pool, page), n, hkv, d, stream);\n",
         "  kv_append_kernel<<<n, kOldThreads, 0, static_cast<cudaStream_t>(stream)>>>(\n"
         "      static_cast<uint16_t*>(k_pool), static_cast<uint16_t*>(v_pool),\n"
         "      static_cast<const uint16_t*>(k_new), static_cast<const uint16_t*>(v_new),\n"
         "      static_cast<const int*>(table), static_cast<const int*>(positions), maxp, pool, hkv,\n"
         "      page, d);\n"
         "  return static_cast<int>(cudaGetLastError());\n"),
        ("kv_append.cu",
         "  return launch<Bf16Rows<128>>(planes(k_layer, v_layer, nullptr, nullptr, k_new, v_new), positions,\n"
         "                               SlotAddr{smax}, n, hkv, d, stream);\n",
         "  kv_append_slot_kernel<<<n, kOldThreads, 0, static_cast<cudaStream_t>(stream)>>>(\n"
         "      static_cast<uint16_t*>(k_layer), static_cast<uint16_t*>(v_layer),\n"
         "      static_cast<const uint16_t*>(k_new), static_cast<const uint16_t*>(v_new),\n"
         "      static_cast<const int*>(positions), hkv, smax, d);\n"
         "  return static_cast<int>(cudaGetLastError());\n"),
    ]),
    # D64: int8 rows of 64 B padded to 80 B, as the 128 build pads its rows
    # (a quarter-warp's two rows then meet at byte 128 of the banks)
    ("paged_decode_q_d64: rows padded by 16 B", [
        ("paged_decode_q.cu",
         "static constexpr int kStride = kD == 128 ? kBytes + 16 : kBytes;  // shared row, bytes",
         "static constexpr int kStride = kBytes + 16;  // shared row, bytes"),
    ]),
    # E64: packed rows of 32 B padded to 48 B (at 128 they stay unpadded)
    ("paged_decode_q4_d64: rows padded by 16 B", [
        ("paged_decode_q.cu",
         "  static constexpr int kStride = kBytes;\n  static constexpr int kFragBytes = kBytes / 4;"
         "  // 16 B (128) or 8 B (64) a quad thread",
         "  static constexpr int kStride = kD == 64 ? kBytes + 16 : kBytes;\n"
         "  static constexpr int kFragBytes = kBytes / 4;"),
    ]),
    # W8A16's bf16 tiles before the wgmma redesign: the mma.sync tiles (a
    # three-stage cp.async ring, 8 warps of 128 rows x 16 channels, ldmatrix
    # A fragments of X), which the f32 build keeps
    ("w8a16 tiles: the mma.sync tiles (cp.async ring)", MMA_SYNC_BF16),
    # ... and those tiles as first written: 32 k a tile, warps of 64 rows x
    # 32 channels (each Q fragment converted by both row halves of the block)
    ("w8a16 tiles: the first mma.sync tiling (32 k a tile, warps of 64 x 32)", [
        *MMA_SYNC_BF16,
        ("w8a16.cu", "kBK = 64, kStages", "kBK = 32, kStages"),
        ("w8a16.cu", "constexpr int kWM = 128, kWN = 16;", "constexpr int kWM = 64, kWN = 32;"),
    ]),
    # C's f32 build: the first body (PR 22), and the split rule not taken
    # (rna(x) written over Q's tile and K's stage as hi, instead of the raw
    # words read as their truncation)
    ("flash_attention_f32: the PR 22 body (mma.sync m16n8k8, cp.async ring)", PR22_ENTRIES),
    ("flash_attention_f32: hi written as rna(x) over Q's tile and K's stage", RNA_HI),
    # the wgmma tiles with a ring of four stages at every token width
    ("w8a16 wgmma tiles: four stages", [
        ("w8a16.cu", "constexpr int kGMaxStages = 16;", "constexpr int kGMaxStages = 4;"),
    ]),
    # ... with a stage's four k16 steps a group at every width (at BN = 256
    # their fragments spill and ptxas serialises the products), two steps a
    # group at BN = 256, or one step a group at every width
    ("w8a16 wgmma tiles: four k16 steps a group at BN = 256", [
        ("w8a16.cu", GROUP_STEPS, "return kGK / 16;"),
    ]),
    ("w8a16 wgmma tiles: two k16 steps a group at BN = 256", [
        ("w8a16.cu", GROUP_STEPS, "return BN >= 256 ? 2 : kGK / 16;"),
    ]),
    ("w8a16 wgmma tiles: one k16 step a group at every width", [
        ("w8a16.cu", GROUP_STEPS, "return 1;"),
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
    out.update(f32_flash_cases(torch, gen))
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
    # D and E's 64 builds at Llama one_b's step (chip_smoke._d64_case)
    dc = chip_smoke._d64_case(torch, c)
    q1b = dc["q_one_b"]
    for name, launch, bits in (("paged_decode_q_d64", paged_decode_q, 8),
                               ("paged_decode_q4_d64", paged_decode_q4, 4)):
        pool = dc["pools_one_b"][bits]
        out[name] = lambda i, pool=pool, launch=launch: launch(
            q1b, pool.k[i % layers], pool.v[i % layers], pool.ks[i % layers], pool.vs[i % layers],
            table, lengths)
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
    # the W8A16 linear at Llama-3-8B's five shapes (chip_smoke's phase-3
    # shapes) and the rows of a decode step, a verify forward and a prefill,
    # on chip_smoke.W8_COLD_BYTES of weight copies cycled (each launch finds
    # its weight cold in L2); and at FORCED_ROWS the bf16 wgmma tiles forced
    # (token width 64) and the weight stream forced, whatever the plan takes
    # there (the readings behind w8a16.STREAM_ROWS and TILE_FILL_BLOCKS),
    # those two also on GPT2_HEAD
    from gofr_tpu_torch.ops.cuda import w8a16 as w8_mod
    from gofr_tpu_torch.ops.quant import quantize

    for label, (n_out, k_in) in {**chip_smoke.W8_SHAPES, "gpt2_head": GPT2_HEAD}.items():
        copies = max(1, -(-int(chip_smoke.W8_COLD_BYTES) // (n_out * k_in)))
        ws = [quantize((torch.randn(n_out, k_in, device=dev, generator=gen) * k_in ** -0.5).to(bf))
              for _ in range(copies)]
        planned_rows = chip_smoke.W8_ROWS if label in chip_smoke.W8_SHAPES else ()
        for m in sorted({*planned_rows, *FORCED_ROWS}):
            x = torch.randn(m, k_in, device=dev, generator=gen).to(bf)
            if m in planned_rows:
                out[f"w8a16_{label}_m{m}"] = lambda i, x=x, ws=ws: w8_mod.w8a16(
                    x, ws[i % len(ws)].q, ws[i % len(ws)].s)
            if m in FORCED_ROWS:
                out[f"w8a16_tiles_{label}_m{m}"] = lambda i, x=x, ws=ws: planned(
                    x, ws[i % len(ws)], (0, 64, 0))
                out[f"w8a16_stream_{label}_m{m}"] = lambda i, x=x, ws=ws: planned(
                    x, ws[i % len(ws)], w8_mod.stream_plan(x.shape[0], *ws[0].q.shape))
    return out


def f32_flash_cases(torch, gen) -> dict:
    """C's f32 build at chip_smoke.py's phase-3 f32 shapes (Llama-3-8B's
    heads at 4 x 512 and 4 x 1024 causal and a chunk of 512 at 512; BERT's
    step, ViT's batch and GPT-2's chunk at head dim 64), each beside SDPA
    in f32 on the same inputs (``sdpa_f32_*``, the yardstick the port never
    calls: head-major views, KV heads repeated and masks built outside the
    timed call)."""
    import torch.nn.functional as F

    from gofr_tpu_torch.ops.cuda.flash_attention import flash_attention

    dev, d64 = torch.device("cuda"), chip_smoke.D64_SHAPES

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gen, dtype=torch.float32)

    def heads(t, g=1):
        return t.transpose(1, 2).repeat_interleave(g, dim=1)

    out = {}
    for s in (512, 1024):
        q, k, v = randn(4, s, 32, 128), randn(4, s, 8, 128), randn(4, s, 8, 128)
        qh, kh, vh = heads(q), heads(k, 4), heads(v, 4)
        out[f"flash_f32_4x{s}"] = lambda i, q=q, k=k, v=v: flash_attention(q, k, v, causal=True)
        out[f"sdpa_f32_4x{s}"] = lambda i, qh=qh, kh=kh, vh=vh: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True)
    ch = d64["gpt2_chunk"]
    chunks = {"chunk_512_at_512": (32, 8, 128, 512, 512),
              "d64_gpt2_chunk": (ch["heads"], ch["heads"], 64, ch["queries"], ch["offset"])}
    for label, (hq, hkv, d, sq, off) in chunks.items():
        q, k, v = randn(1, sq, hq, d), randn(1, off + sq, hkv, d), randn(1, off + sq, hkv, d)
        offs = torch.tensor([off], device=dev, dtype=torch.int32)
        lens = torch.tensor([off + sq], device=dev, dtype=torch.int32)
        mask = torch.arange(off + sq, device=dev)[None, :] <= off + torch.arange(sq, device=dev)[:, None]
        qh, kh, vh = heads(q), heads(k, hq // hkv), heads(v, hq // hkv)
        out[f"flash_f32_{label}"] = lambda i, q=q, k=k, v=v, offs=offs, lens=lens: flash_attention(
            q, k, v, causal=True, q_offset=offs, kv_lengths=lens)
        out[f"sdpa_f32_{label}"] = lambda i, qh=qh, kh=kh, vh=vh, mask=mask: (
            F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask))
    b, s, h = d64["bert"]["batch"], d64["bert"]["seq"], d64["bert"]["heads"]
    lens_cpu = torch.randint(8, s + 1, (b,), generator=torch.Generator().manual_seed(chip_smoke.SEED + 22),
                             dtype=torch.int32)
    lens_cpu[-d64["bert"]["padded_rows"]:] = 1
    lens = lens_cpu.to(dev)
    q, k, v = randn(b, s, h, 64), randn(b, s, h, 64), randn(b, s, h, 64)
    mask = (torch.arange(s, device=dev)[None, :] < lens[:, None])[:, None, None, :]
    out["flash_f32_d64_bert"] = lambda i: flash_attention(q, k, v, causal=False, kv_lengths=lens)
    bert = heads(q), heads(k), heads(v)
    out["sdpa_f32_d64_bert"] = lambda i: F.scaled_dot_product_attention(*bert, attn_mask=mask)
    b, s, h = d64["vit"]["batch"], d64["vit"]["seq"], d64["vit"]["heads"]
    qv, kv, vv = randn(b, s, h, 64), randn(b, s, h, 64), randn(b, s, h, 64)
    out["flash_f32_d64_vit"] = lambda i: flash_attention(qv, kv, vv, causal=False)
    vit = heads(qv), heads(kv), heads(vv)
    out["sdpa_f32_d64_vit"] = lambda i: F.scaled_dot_product_attention(*vit)
    return out


def planned(x, w, plan: tuple[int, int, int]):
    """The W8A16 entry point under ``plan`` (splits, per split or token
    width, stage), whatever ``w8a16.plan`` takes at x's rows: the
    launcher's call with the plan replaced."""
    import torch

    from gofr_tpu_torch.ops import cuda
    from gofr_tpu_torch.ops.cuda import w8a16 as w8_mod

    (m, k), n = x.shape, w.q.shape[0]
    out = torch.empty(m, n, dtype=x.dtype, device=x.device)
    partial = (torch.empty(plan[0], m, n, dtype=torch.float32, device=x.device)
               if plan[0] > 1 else None)
    fn = cuda.bind(w8_mod.ENTRY[x.dtype], w8_mod._ARGTYPES)
    cuda.check(fn(x.data_ptr(), w.q.data_ptr(), w.s.data_ptr(), out.data_ptr(),
                  None if partial is None else partial.data_ptr(), m, n, k, *plan,
                  cuda.stream_of(x)), "w8a16")
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


def serve_w8(torch, name: str) -> None:
    """``chip_smoke.py``'s ``paged_w8`` serving run (Llama-3-8B with int8
    weights, 8 requests of 64 tokens, its holds) on the unmodified build
    and on variant ``name``, in the order A B B A in one process: TTFT and
    decode tok/s of each, into ``chiprun_out/kernel_variants_serve_w8.json``."""
    from gofr_tpu_torch.models.llama import LlamaConfig, init

    index = next(i for i, v in enumerate(VARIANTS) if v[0] == name)
    with ThreadPoolExecutor(max_workers=2) as pool:
        libraries = [b.result()["library"] for b in (pool.submit(cuda.build),
                                                      pool.submit(make, index, VARIANTS[index]))]
    model = init(LlamaConfig.llama3_8b(), torch.Generator(device="cuda").manual_seed(chip_smoke.SEED),
                 "cuda")
    rows = []
    for build in (0, 1, 1, 0):
        cuda.load(libraries[build])
        eng, counts, metrics, _ = chip_smoke.serve(torch, cuda, model, w8=True)
        eng.stop()
        del eng
        torch.cuda.empty_cache()
        row = {"build": ("unmodified", name)[build], "w8a16_launches": counts["w8a16"],
               **{k: metrics[k] for k in ("ttft_p50_s", "ttft_max_s", "decode_tok_s", "wall_s")}}
        print(json.dumps(row), flush=True)
        rows.append(row)
    summary = {"nvidia_smi": chip_smoke.smi_line()}
    print(json.dumps(summary))
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "kernel_variants_serve_w8.json"), "w") as f:
        json.dump({"rows": rows, "summary": summary}, f, indent=1)


def forwards(mean: dict) -> dict:
    """A Llama-3-8B forward's products (``chip_smoke.W8_PER_STEP`` of each
    shape) from one build's mean device ms: as planned at each of
    ``chip_smoke.W8_ROWS``, and with the tiles or the stream forced at each
    of ``FORCED_ROWS``."""
    out = {}
    for kind, rows in (("", chip_smoke.W8_ROWS), ("tiles_", FORCED_ROWS), ("stream_", FORCED_ROWS)):
        for m in rows:
            out[f"{kind}m{m}"] = sum(count * mean[f"w8a16_{kind}{label}_m{m}"]
                                     for label, count in chip_smoke.W8_PER_STEP.items())
    return out


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_variants: no CUDA device available")
    os.chdir(REPO)
    if sys.argv[1:2] == ["--serve-w8"]:
        serve_w8(torch, sys.argv[2])
        return
    parts = sys.argv[1:]
    chosen = [(i, v) for i, v in enumerate(VARIANTS) if not parts or any(s in v[0] for s in parts)]
    with ThreadPoolExecutor(max_workers=4) as pool:
        clean = pool.submit(cuda.build)
        builds = [clean, *(pool.submit(make, i, v) for i, v in chosen)]
        libraries = [b.result()["library"] for b in builds]
    names = ["unmodified", *(v[0] for _, v in chosen)]
    # the calls each build is timed on: every call for the unmodified
    # build, the calls of the kernels a variant's files hold for a variant
    timed = [None, *({case for fname, _, _ in v[1] for case in CASES_OF[fname]} for _, v in chosen)]
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
                   "device_ms": {name: chip_smoke.device_ms(torch, fn, 20) for name, fn in calls.items()
                                 if timed[i] is None or name.startswith(tuple(timed[i]))}}
            print(json.dumps(row), flush=True)
            rows.append(row)
    mean = {name: {call: sum(r["device_ms"][call] for r in rows if r["build"] == name) / 2
                   for call in rows[i]["device_ms"]} for i, name in enumerate(names)}
    bad = [r["build"] for r in rows if max(r["diff_from_unmodified"].values()) > MAX_DIFF]
    summary = {"mean_device_ms": mean,
               "w8a16_forward_ms": {name: forwards(mean[name]) for i, name in enumerate(names)
                                    if timed[i] is None or "w8a16_" in timed[i]},
               "nvidia_smi": chip_smoke.smi_line()}
    print(json.dumps(summary))
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "kernel_variants.json"), "w") as f:
        json.dump({"rows": rows, "summary": summary}, f, indent=1)
    if bad:
        raise SystemExit(f"variants that change the output: {bad}")


if __name__ == "__main__":
    main()
