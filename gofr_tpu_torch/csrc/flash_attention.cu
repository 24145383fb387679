// Flash (blocked online-softmax) prefill attention with GQA.
//
// Replaces gofr_tpu/ops/pallas/flash_attention.py flash_attention (:108,
// pallas_call :159, body _flash_kernel :45), reached from the JAX package
// through ops/attention._flash_mha (:126).
//
// What bounds it on the card: operations, 4 x B x Hq x D x (the causal
// (query, key) pairs this call's lengths leave visible). Its data is small
// beside that (q, k, v and out once each), so the score matrix must never
// reach device memory: it lives in shared memory one 64 x 64 tile at a time.
//
// Design (right and simple first; the products run on CUDA cores in f32
// FMA, not on the tensor cores, which is the lever for later work):
//   - One thread block per (batch row, query head, 64-row query tile); GQA
//     reads KV head h / G, so K/V are never repeated in memory.
//   - The block loops over 64-row K/V tiles staged in shared memory with
//     16-byte coalesced loads, up to the causal limit q_offset + q_end and
//     the row's kv_length: tiles that are fully masked are never loaded (the
//     TPU kernel's block skip, flash_attention.py:71-73).
//   - Each thread computes a 4 x 8 block of scores, then one warp per row
//     folds the tile into the running (m, l) state (online_softmax.cuh), and
//     each thread accumulates a 4 x 16 block of the output in registers.
//   - Masked scores are -1e30, so a fully masked row gives zeros, not NaN.
#include <cstdint>

#include "online_softmax.cuh"

namespace {

constexpr int kD = 128;            // head_dim (the wrapper checks)
constexpr int kBQ = 64;            // query rows per block
constexpr int kBK = 64;            // KV rows per tile
constexpr int kThreads = 128;      // 16 x 8 threads
constexpr int kStride = kD + 8;    // padded bf16 row in shared memory (272 B)
constexpr int kSStride = kBK + 1;  // padded f32 score row
constexpr int kChunks = kD / 8;    // 16-byte chunks per row
constexpr int kSmemBytes =
    3 * kBQ * kStride * 2 + kBQ * kSStride * 4 + 3 * kBQ * 4;  // 69,632 B

// Copy rows row0 .. row0+63 of a [rows, pitch] bf16 matrix into shared
// memory; rows at or past `valid` become zeros.
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           int row0, int valid, size_t pitch) {
  for (int c = threadIdx.x; c < kBK * kChunks; c += kThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    uint4 w = make_uint4(0, 0, 0, 0);
    if (row0 + r < valid) w = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * pitch + col);
    *reinterpret_cast<uint4*>(dst + r * kStride + col) = w;
  }
}

__global__ void __launch_bounds__(kThreads) flash_kernel(
    const __nv_bfloat16* __restrict__ q,  // [B, Sq, Hq, D]
    const __nv_bfloat16* __restrict__ k,  // [B, Skv, Hkv, D]
    const __nv_bfloat16* __restrict__ v,  // [B, Skv, Hkv, D]
    const int* __restrict__ q_offset,     // [B]
    const int* __restrict__ kv_lengths,   // [B]
    __nv_bfloat16* __restrict__ out,      // [B, Sq, Hq, D]
    int sq, int skv, int hq, int hkv, int group, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* k_s = q_s + kBQ * kStride;
  __nv_bfloat16* v_s = k_s + kBK * kStride;
  float* s_s = reinterpret_cast<float*>(v_s + kBK * kStride);
  float* m_s = s_s + kBQ * kSStride;
  float* l_s = m_s + kBQ;
  float* a_s = l_s + kBQ;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x, warp = tid >> 5, ty = tid >> 3, tx = tid & 7;
  const int qo = q_offset[b];
  const int kl = min(max(kv_lengths[b], 0), skv);
  const size_t q_pitch = (size_t)hq * kD, kv_pitch = (size_t)hkv * kD;
  const __nv_bfloat16* kb = k + ((size_t)b * skv * hkv + h / group) * kD;
  const __nv_bfloat16* vb = v + ((size_t)b * skv * hkv + h / group) * kD;

  stage_rows(q_s, q + ((size_t)b * sq * hq + h) * kD, q0, sq, q_pitch);
  if (tid < kBQ) {
    m_s[tid] = gofr::kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[4][16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 16; ++c) acc[i][c] = 0.f;
  const int kv_end = causal ? min(kl, qo + q0 + kBQ) : kl;
  __syncthreads();

  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    stage_rows(k_s, kb, k0, skv, kv_pitch);
    stage_rows(v_s, vb, k0, skv, kv_pitch);
    __syncthreads();

    // S = Q K^T for rows 4ty..4ty+3 and columns tx + 8c
    float sacc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) sacc[i][c] = 0.f;
    for (int j = 0; j < kChunks; ++j) {
      uint4 qw[4], kw[8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qw[i] = *reinterpret_cast<const uint4*>(q_s + (4 * ty + i) * kStride + 8 * j);
#pragma unroll
      for (int c = 0; c < 8; ++c)
        kw[c] = *reinterpret_cast<const uint4*>(k_s + (tx + 8 * c) * kStride + 8 * j);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float2 qf[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          qf[i] = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(&qw[i])[e]);
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float2 kf = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(&kw[c])[e]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            sacc[i][c] = fmaf(qf[i].x, kf.x, sacc[i][c]);
            sacc[i][c] = fmaf(qf[i].y, kf.y, sacc[i][c]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = tx + 8 * c, kv = k0 + col;
        const bool ok = kv < kl && (!causal || qo + q0 + r >= kv);
        s_s[r * kSStride + col] = ok ? sacc[i][c] * scale : gofr::kNegInf;
      }
    }
    __syncthreads();

    for (int r = warp; r < kBQ; r += kThreads / 32)
      gofr::fold_row64(s_s + r * kSStride, &m_s[r], &l_s[r], &a_s[r]);
    __syncthreads();

    // O = O * alpha + P V for rows 4ty..4ty+3 and columns 2tx + 16jj (+1)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[4 * ty + i];
#pragma unroll
      for (int c = 0; c < 16; ++c) acc[i][c] *= alpha;
    }
    for (int t = 0; t < kBK; ++t) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = s_s[(4 * ty + i) * kSStride + t];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float2 vf = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(v_s + t * kStride + 2 * tx + 16 * jj));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][2 * jj] = fmaf(p[i], vf.x, acc[i][2 * jj]);
          acc[i][2 * jj + 1] = fmaf(p[i], vf.y, acc[i][2 * jj + 1]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i, s = q0 + r;
    if (s >= sq) continue;
    const float l = l_s[r];
    __nv_bfloat16* o = out + (((size_t)b * sq + s) * hq + h) * kD;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
      *reinterpret_cast<__nv_bfloat162*>(o + 2 * tx + 16 * jj) = __floats2bfloat162_rn(
          gofr::row_finish(acc[i][2 * jj], l), gofr::row_finish(acc[i][2 * jj + 1], l));
  }
}

}  // namespace

extern "C" int gofr_flash_attention(const void* q, const void* k, const void* v,
                                    const void* q_offset, const void* kv_lengths, void* out,
                                    int b, int sq, int skv, int hq, int hkv, int causal,
                                    float scale, void* stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
  flash_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(q_offset),
      static_cast<const int*>(kv_lengths), static_cast<__nv_bfloat16*>(out),
      sq, skv, hq, hkv, hq / hkv, causal, scale);
  return static_cast<int>(cudaGetLastError());
}
