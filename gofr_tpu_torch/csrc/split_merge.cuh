// The merge of a decode kernel split over the sequence, shared by the slot
// decode (kernel F, paged_decode.cu) and the page-pool decodes (kernels A, D
// and E, paged_decode_q.cu).
//
// A decode block that covers run s of a slot writes, for each of its query
// rows, the f32 state of that run: the unnormalised acc[D], then the running
// max m and sum l (D + 2 floats), into scratch [N, Hq, splits, D + 2]. The
// merge, one block of D threads per (slot, query head), reads only the live
// runs, those that start before the slot's length as the decode kernel
// clamps it (`Rows::length`), rescales run s by exp(m_s - M) with M safe as
// in online_softmax.cuh, sums, and divides with the 1e-20 clamp. It never
// reads a run that was not written, so the scratch needs no clearing; a slot
// of length 0 has no live run and gets zeros. The output is written in the
// decode's input type: bf16, or f32 for kernel F's f32 build (the TPU
// kernel writes its output in q.dtype).
#pragma once

#include "online_softmax.cuh"

namespace gofr {

__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }

// Thread j merges output column j over the slot's live runs.
template <int kD, class Rows, class Out>
__global__ void __launch_bounds__(kD) merge_splits(
    const float* __restrict__ part, const Rows rows, const int* __restrict__ lengths,
    Out* __restrict__ out, int split_rows, int splits) {
  constexpr int kState = kD + 2;
  const int n = blockIdx.x, hq = gridDim.y, head = blockIdx.y, tid = threadIdx.x;
  const int live = (rows.length(lengths, n) + split_rows - 1) / split_rows;
  const float* st = part + ((size_t)n * hq + head) * splits * kState;
  float m = kNegInf;
  for (int s = 0; s < live; ++s) m = fmaxf(m, st[s * kState + kD]);
  const float safe = m > kNegInf * 0.5f ? m : 0.f;
  float l = 0.f, acc = 0.f;
  for (int s = 0; s < live; ++s) {
    const float w = expf(st[s * kState + kD] - safe);
    l = fmaf(w, st[s * kState + kD + 1], l);
    acc = fmaf(w, st[s * kState + tid], acc);
  }
  store_out(out + ((size_t)n * hq + head) * kD + tid, row_finish(acc, l));
}

}  // namespace gofr
