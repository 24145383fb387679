// Shared online-softmax recurrence for the attention kernels.
//
// Replaces gofr_tpu/ops/pallas/common.py (init_softmax_scratch :23,
// softmax_block_update :33, softmax_finish :69). On the TPU the running
// (m, l, acc) state lived in VMEM scratch carried across sequential grid
// steps; on the card a block walks its KV tiles in a loop and keeps the
// state in shared memory (the decode kernels' warp-per-row fold) or in
// registers (the flash kernel, one quad of threads per row). The numerics
// stay those of the
// TPU kernels, so a fully masked row gives zeros, not NaN:
//   - masked scores are kNegInf (-1e30), never -inf;
//   - a row whose running max is still kNegInf takes its probabilities
//     against 0, so exp(kNegInf - 0) underflows to 0 instead of exp(0) == 1;
//   - the final divide clamps the normaliser at 1e-20.
// The bf16 kernels round probabilities to bf16 before the P.V product
// (common.py:57); the quantized-pool kernels instead fold the per-position
// value scale into them, in f32 and unrounded (common.py:56-60). Either
// way the normaliser sums the plain probabilities, unrounded, in f32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace gofr {

constexpr float kNegInf = -1e30f;

struct RowState {
  float m;  // running max of the row's scores
  float l;  // running normaliser (sum of probabilities)
};

__device__ __forceinline__ RowState row_init() { return {kNegInf, 0.f}; }

// Fold one tile's row max into the running state. Returns alpha, the factor
// that rescales what was accumulated before this tile, and writes the max
// that this tile's probabilities are taken against.
__device__ __forceinline__ float row_rescale(RowState& st, float tile_max, float* m_safe) {
  const float m_next = fmaxf(st.m, tile_max);
  const float safe = m_next > kNegInf * 0.5f ? m_next : 0.f;
  const float alpha = expf(st.m - safe);
  st.m = m_next;
  st.l *= alpha;
  *m_safe = safe;
  return alpha;
}

__device__ __forceinline__ float row_prob(float score, float m_safe) {
  return expf(score - m_safe);
}

__device__ __forceinline__ float row_finish(float acc, float l) {
  return acc / fmaxf(l, 1e-20f);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The same reductions over the 4 threads of an mma quad (lanes 4i..4i+3),
// which together hold one row of an m16n8 accumulator tile.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// One warp takes the probabilities of one 64-wide tile row held in shared
// memory (`row`, f32, masked entries == kNegInf) against the running state
// kept in shared memory (m, l), and updates that state: lane 0 stores the
// new max, the normaliser and alpha for the P.V step. Returns this lane's
// probabilities of positions lane and lane + 32. Every lane of the warp
// must call this.
__device__ __forceinline__ float2 row_probs64(const float* row, float* m, float* l, float* alpha) {
  const int lane = threadIdx.x & 31;
  const float a = row[lane], b = row[lane + 32];
  RowState st{*m, *l};
  float safe;
  const float scale = row_rescale(st, warp_max(fmaxf(a, b)), &safe);
  const float pa = row_prob(a, safe), pb = row_prob(b, safe);
  const float sum = warp_sum(pa + pb);
  __syncwarp();
  if (lane == 0) {
    *m = st.m;
    *l = st.l + sum;
    *alpha = scale;
  }
  return make_float2(pa, pb);
}

// Fold one tile row into the running state and overwrite it with its
// bf16-rounded probabilities, the P.V weights of the bf16 kernels.
__device__ __forceinline__ void fold_row64(float* row, float* m, float* l, float* alpha) {
  const int lane = threadIdx.x & 31;
  const float2 p = row_probs64(row, m, l, alpha);
  const float pa = p.x, pb = p.y;
  row[lane] = round_bf16(pa);
  row[lane + 32] = round_bf16(pb);
  __syncwarp();
}

// The v_scale fold (common.py:56-60): fold one tile row into the running
// state and overwrite it with p * vs[t], the P.V weights of the
// quantized-pool kernels: f32, with no bf16 rounding. `vs` holds the
// tile's 64 value scales.
__device__ __forceinline__ void fold_row64_vscale(float* row, const float* vs, float* m, float* l,
                                                  float* alpha) {
  const int lane = threadIdx.x & 31;
  const float2 p = row_probs64(row, m, l, alpha);
  row[lane] = p.x * vs[lane];
  row[lane + 32] = p.y * vs[lane + 32];
  __syncwarp();
}

}  // namespace gofr
