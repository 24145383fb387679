// Paged decode attention over the quantized pools: one new token per slot
// against int8 rows (kernel D) or packed int4 rows (kernel E), each row with
// one bf16 scale per (page, head, position) for K and for V.
//
// Replaces gofr_tpu/ops/pallas/paged_decode.py paged_decode_attention_q
// (:195, pallas_call :232, body _paged_decode_q_kernel :148) and
// paged_decode_attention_q4 (:314, pallas_call :355, body
// _paged_decode_q4_kernel :260).
//
// What bounds it on the card: device-memory bytes. Each slot's live rows are
// read once per layer, len x Hkv x (2 x row bytes + 2 x 2 B of scales): a
// quarter (int4) or a half (int8) of the bf16 kernel's K/V bytes, for the
// same ~1 multiply-add per element, far below the ~295 operations per byte
// where an H100 turns compute-bound.
//
// Design: that of paged_decode.cu, templated on the row format.
//   - One thread block per (slot, KV head); the G query rows of the head
//     share every staged 64-row tile. The block reads its own table row and
//     length, walks only the live positions, and clamps a table entry past
//     the pool to page P-1 (read, then masked by length).
//   - Rows are staged in shared memory with 16-byte loads: an int8 row is
//     128 B (8 chunks), a packed int4 row 64 B (4 chunks). Shared rows are
//     padded by 16 B (144 B and 80 B strides), so the eight rows a
//     quarter-warp reads in the score loop fall on distinct banks. The
//     tile's 64 K scales and 64 V scales are staged beside them as f32.
//   - Packed int4 is split-half: output column c < D/2 is the low nibble of
//     byte c, column c >= D/2 the high nibble of byte c - D/2, both biased
//     by +8. A zero byte decodes to -8, so rows past the length are masked
//     by their score, never trusted to carry a zero scale.
//   - The arithmetic is the Pallas bodies', not the XLA path's: scores
//     s = (q.k) * scale * ks[t] with the values converted exactly to f32 and
//     the products summed in f32; t >= len masked to kNegInf; the online
//     softmax with the v_scale fold (online_softmax.cuh: p stays f32 and
//     unrounded and is multiplied by vs[t] before P.V, the normaliser sums
//     the unscaled p); out = acc / max(l, 1e-20); len == 0 gives zeros.
// Like the bf16 kernel it runs one block per (slot, head) with no split over
// the sequence; wgmma, TMA and a sequence split are later work.
#include <cstdint>

#include "online_softmax.cuh"

namespace {

constexpr int kD = 128;        // head_dim (the wrapper checks)
constexpr int kTile = 64;      // KV positions per staged tile
constexpr int kThreads = 128;  // == kD: one output column per thread
constexpr int kMaxGroup = 8;   // query heads per KV head

// int8 rows: element c is byte c.
struct Int8Rows {
  static constexpr int kBytes = kD;

  // q . k for one staged row; q is f32 in shared memory
  __device__ static float dot(const uint8_t* row, const float* q) {
    const uint4* r = reinterpret_cast<const uint4*>(row);
    float s = 0.f;
#pragma unroll 2
    for (int j = 0; j < kBytes / 16; ++j) {
      const uint4 w = r[j];
      const int8_t* e = reinterpret_cast<const int8_t*>(&w);
#pragma unroll
      for (int i = 0; i < 16; ++i) s = fmaf(q[16 * j + i], static_cast<float>(e[i]), s);
    }
    return s;
  }

  __device__ static float value(const uint8_t* row, int col) {
    return static_cast<float>(reinterpret_cast<const int8_t*>(row)[col]);
  }
};

// packed int4 rows, split-half (ops/quant.py pack_int4): byte j holds
// element j in its low nibble and element j + D/2 in its high nibble
struct Int4Rows {
  static constexpr int kBytes = kD / 2;
  static constexpr int kBias = 8;
  static constexpr int kLoShift = 0, kHiShift = 4;

  __device__ static float nibble(uint32_t byte, int shift) {
    return static_cast<float>(static_cast<int>((byte >> shift) & 0xFu) - kBias);
  }

  __device__ static float dot(const uint8_t* row, const float* q) {
    const uint4* r = reinterpret_cast<const uint4*>(row);
    float s = 0.f;
#pragma unroll 2
    for (int j = 0; j < kBytes / 16; ++j) {
      const uint4 w = r[j];
      const uint8_t* e = reinterpret_cast<const uint8_t*>(&w);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        s = fmaf(q[16 * j + i], nibble(e[i], kLoShift), s);
        s = fmaf(q[kBytes + 16 * j + i], nibble(e[i], kHiShift), s);
      }
    }
    return s;
  }

  __device__ static float value(const uint8_t* row, int col) {
    return col < kBytes ? nibble(row[col], kLoShift) : nibble(row[col - kBytes], kHiShift);
  }
};

template <class Rows>
__global__ void __launch_bounds__(kThreads) paged_decode_q_kernel(
    const __nv_bfloat16* __restrict__ q,        // [N, Hq, D]
    const uint8_t* __restrict__ k_pool,         // [P, Hkv, page, Rows::kBytes]
    const uint8_t* __restrict__ v_pool,         // [P, Hkv, page, Rows::kBytes]
    const __nv_bfloat16* __restrict__ k_scale,  // [P, Hkv, page]
    const __nv_bfloat16* __restrict__ v_scale,  // [P, Hkv, page]
    const int* __restrict__ table,              // [N, MaxP]
    const int* __restrict__ lengths,            // [N]
    __nv_bfloat16* __restrict__ out,            // [N, Hq, D]
    int hkv, int group, int pool, int page, int maxp, float scale) {
  constexpr int kChunks = Rows::kBytes / 16;  // 16-byte chunks per row
  constexpr int kStride = Rows::kBytes + 16;  // padded shared row, bytes
  __shared__ __align__(16) uint8_t k_s[kTile * kStride];
  __shared__ __align__(16) uint8_t v_s[kTile * kStride];
  __shared__ float q_s[kMaxGroup][kD];
  __shared__ float p_s[kMaxGroup][kTile];
  __shared__ float ks_s[kTile], vs_s[kTile];
  __shared__ float m_s[kMaxGroup], l_s[kMaxGroup], alpha_s[kMaxGroup];

  const int n = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5;
  const int hq = hkv * group;
  const int len = min(max(lengths[n], 0), maxp * page);
  const int* row_table = table + (size_t)n * maxp;

  for (int i = tid; i < group * kD; i += kThreads) {
    const int g = i / kD, j = i % kD;
    q_s[g][j] = __bfloat162float(q[((size_t)n * hq + h * group + g) * kD + j]);
  }
  if (tid < group) {
    m_s[tid] = gofr::kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kMaxGroup];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) acc[g] = 0.f;
  __syncthreads();

  for (int t0 = 0; t0 < len; t0 += kTile) {
    // stage rows t0 .. t0+63 of this (slot, head); rows past len are 0
    for (int c = tid; c < kTile * kChunks; c += kThreads) {
      const int r = c / kChunks, col = (c % kChunks) * 16;
      const int t = t0 + r;
      uint4 kk = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (t < len) {
        const int entry = min(max(row_table[t / page], 0), pool - 1);
        const size_t base = (((size_t)entry * hkv + h) * page + t % page) * Rows::kBytes + col;
        kk = *reinterpret_cast<const uint4*>(k_pool + base);
        vv = *reinterpret_cast<const uint4*>(v_pool + base);
      }
      *reinterpret_cast<uint4*>(&k_s[r * kStride + col]) = kk;
      *reinterpret_cast<uint4*>(&v_s[r * kStride + col]) = vv;
    }
    {  // threads 0..63 stage the K scales, 64..127 the V scales
      const int r = tid % kTile, t = t0 + r;
      float sc = 0.f;
      if (t < len) {
        const int entry = min(max(row_table[t / page], 0), pool - 1);
        const size_t at = ((size_t)entry * hkv + h) * page + t % page;
        sc = __bfloat162float(tid < kTile ? k_scale[at] : v_scale[at]);
      }
      (tid < kTile ? ks_s : vs_s)[r] = sc;
    }
    __syncthreads();

    // scores: one (query row, position) pair per thread and step
    for (int i = tid; i < group * kTile; i += kThreads) {
      const int g = i / kTile, t = i % kTile;
      const float s = Rows::dot(&k_s[t * kStride], q_s[g]);
      p_s[g][t] = (t0 + t < len) ? s * scale * ks_s[t] : gofr::kNegInf;
    }
    __syncthreads();

    for (int g = warp; g < group; g += kThreads / 32)
      gofr::fold_row64_vscale(p_s[g], vs_s, &m_s[g], &l_s[g], &alpha_s[g]);
    __syncthreads();

    // P.V: this thread owns output column `tid` of every query row
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g)
      if (g < group) acc[g] *= alpha_s[g];
    for (int t = 0; t < kTile; ++t) {
      const float v = Rows::value(&v_s[t * kStride], tid);
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g)
        if (g < group) acc[g] = fmaf(p_s[g][t], v, acc[g]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g)
    if (g < group)
      out[((size_t)n * hq + h * group + g) * kD + tid] =
          __float2bfloat16(gofr::row_finish(acc[g], l_s[g]));
}

template <class Rows>
int launch(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
           const void* v_scale, const void* table, const void* lengths, void* out, int n,
           int hkv, int group, int pool, int page, int maxp, float scale, void* stream) {
  paged_decode_q_kernel<Rows><<<dim3(n, hkv), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const uint8_t*>(k_pool),
      static_cast<const uint8_t*>(v_pool), static_cast<const __nv_bfloat16*>(k_scale),
      static_cast<const __nv_bfloat16*>(v_scale), static_cast<const int*>(table),
      static_cast<const int*>(lengths), static_cast<__nv_bfloat16*>(out),
      hkv, group, pool, page, maxp, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int gofr_paged_decode_q(const void* q, const void* k_pool, const void* v_pool,
                                   const void* k_scale, const void* v_scale, const void* table,
                                   const void* lengths, void* out, int n, int hkv, int group,
                                   int pool, int page, int maxp, float scale, void* stream) {
  return launch<Int8Rows>(q, k_pool, v_pool, k_scale, v_scale, table, lengths, out, n, hkv,
                          group, pool, page, maxp, scale, stream);
}

extern "C" int gofr_paged_decode_q4(const void* q, const void* k_pool, const void* v_pool,
                                    const void* k_scale, const void* v_scale, const void* table,
                                    const void* lengths, void* out, int n, int hkv, int group,
                                    int pool, int page, int maxp, float scale, void* stream) {
  return launch<Int4Rows>(q, k_pool, v_pool, k_scale, v_scale, table, lengths, out, n, hkv,
                          group, pool, page, maxp, scale, stream);
}
