// Decode attention over the bf16 slot cache: one new token per slot (kernel
// F). The page pool's decode attention (kernels A, D and E) lives in
// paged_decode_q.cu.
//
// Replaces gofr_tpu/ops/pallas/decode_attention.py decode_attention (:85,
// pallas_call :111, body _decode_kernel :46).
//
// What bounds it on the card: device-memory bytes. Each slot's live K and V
// rows (len x Hkv x D x 2 planes x 2 B per layer) are read once and used for
// G = Hq/Hkv query rows only, about one multiply-add per byte, far below the
// ~295 operations per byte where an H100 turns compute-bound. At the slot
// cache's engine shapes (8 slots, Hkv 8, lengths in the hundreds to
// thousands) that is 37 MB, 11 us at 3.35 TB/s; reaching it takes tens of KB
// in flight on every one of the 132 SMs.
//
// Design:
//   - One thread block per (slot, KV head, split of the sequence). The G
//     query rows of the head share every K/V tile the block stages, so K/V
//     are read once per head, not once per query head (the TPU kernel's [G,
//     d] tile). Row t of (slot n, KV head h) lies at a fixed step from the
//     slot's base (SlotRows).
//   - The split: the launcher cuts each slot into `splits` runs of
//     `split_rows` positions (a multiple of the 64-row tile), a number the
//     host takes from the shapes alone, never from the lengths (reading them
//     would stall the host on the card every layer). A block whose run starts
//     at or past its length exits at once; the others each walk only their
//     own live rows, so the work spreads over hundreds of blocks instead of
//     one per (slot, head). Each writes the f32 state of its G rows
//     (unnormalised acc[D], running max m, sum l) to scratch, and the merge
//     of split_merge.cuh (shared with kernels A, D and E), launched from the
//     same entry point, combines the live runs of each (slot, query head).
//     With one split the block finishes in place and there is no merge.
//   - The block reads its own length; there is no scalar prefetch on the
//     card. The TPU kernel streams all Smax positions and masks them; this
//     one stops at the length.
//   - Tiles flow through a two-stage ring of cp.async copies
//     (async_copy.cuh): the next tile loads while the current one is
//     scored and folded. Rows are padded by 16 B so the score loop reads
//     them without bank conflicts.
//   - The online-softmax state is f32 (online_softmax.cuh); probabilities are
//     rounded to bf16 before the P.V product, as the TPU kernel does.
//   - A length is clamped to Smax: an idle slot-layout lane asks for Smax + 1
//     + k, and an unclamped length would read the next head's rows. Smax need
//     not be a multiple of 64: rows past the length are never loaded.
#include <cstdint>

#include "async_copy.cuh"
#include "online_softmax.cuh"
#include "split_merge.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kD = 128;          // head_dim (the wrapper checks)
constexpr int kTile = 64;        // KV positions per staged tile
constexpr int kThreads = 128;    // == kD: one output column per thread
constexpr int kMaxGroup = 8;     // query heads per KV head
constexpr int kStride = kD + 8;  // padded smem row, in bf16 elements
constexpr int kChunks = kD / 8;  // 16-byte chunks per row
constexpr int kTileElems = kTile * kStride;
constexpr int kStages = 2;       // K/V ring depth
constexpr int kRingBytes = kStages * 2 * kTileElems * 2;  // K and V: 69,632 B
constexpr int kState = kD + 2;   // one split's scratch per query row: acc[D], m, l

// The slot cache's layer slice [N, Hkv, Smax, D]: lane n is slot n.
struct SlotRows {
  int smax;

  __device__ int length(const int* lengths, int n) const {
    return min(max(lengths[n], 0), smax);
  }

  __device__ size_t row(int n, int h, int hkv, int t) const {
    return (((size_t)n * hkv + h) * smax + t) * kD;
  }
};

__global__ void __launch_bounds__(kThreads) decode_kernel(
    const bf16* __restrict__ q,      // [N, Hq, D]
    const bf16* __restrict__ k,      // [N, Hkv, Smax, D]
    const bf16* __restrict__ v,      // [N, Hkv, Smax, D]
    const SlotRows rows,
    const int* __restrict__ lengths,  // [N]
    bf16* __restrict__ out,           // [N, Hq, D], written here when there is one split
    float* __restrict__ part,         // [N, Hq, splits, kState], written when there are more
    int hkv, int group, int split_rows, float scale) {
  extern __shared__ __align__(16) unsigned char ring[];  // [kStages][K, V][kTile][kStride]
  __shared__ float q_s[kMaxGroup][kD];
  __shared__ float p_s[kMaxGroup][kTile];
  __shared__ float m_s[kMaxGroup], l_s[kMaxGroup], alpha_s[kMaxGroup];

  const int n = blockIdx.x, h = blockIdx.y, split = blockIdx.z, tid = threadIdx.x;
  const int warp = tid >> 5;
  const int hq = hkv * group;
  const int len = rows.length(lengths, n);
  const int t_begin = split * split_rows;
  const int t_end = min(len, t_begin + split_rows);
  if (gridDim.z > 1 && t_begin >= len) return;  // no live row: the merge never reads this split
  const int n_tiles = (max(t_end - t_begin, 0) + kTile - 1) / kTile;
  bf16* const ring_s = reinterpret_cast<bf16*>(ring);

  // copy rows t_begin + 64 i .. of this (slot, head) into stage i % 2; rows
  // at or past t_end are zero-filled
  auto stage = [&](int i) {
    bf16* k_s = ring_s + (i % kStages) * 2 * kTileElems;
    bf16* v_s = k_s + kTileElems;
    const int t0 = t_begin + i * kTile;
    for (int c = tid; c < kTile * kChunks; c += kThreads) {
      const int r = c / kChunks, col = (c % kChunks) * 8, t = t0 + r;
      const bool ok = t < t_end;
      const size_t base = (ok ? rows.row(n, h, hkv, t) : 0) + col;
      gofr::cp_async16(k_s + r * kStride + col, k + base, ok);
      gofr::cp_async16(v_s + r * kStride + col, v + base, ok);
    }
  };
  if (n_tiles > 0) stage(0);
  gofr::cp_async_commit();

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

  for (int i = 0; i < n_tiles; ++i) {
    const int t0 = t_begin + i * kTile;
    if (i + 1 < n_tiles) stage(i + 1);
    gofr::cp_async_commit();  // possibly empty, so one wait depth serves every step
    gofr::cp_async_wait<1>();
    __syncthreads();
    const bf16* k_s = ring_s + (i % kStages) * 2 * kTileElems;
    const bf16* v_s = k_s + kTileElems;

    // scores: one (query row, position) pair per thread and step
    for (int j = tid; j < group * kTile; j += kThreads) {
      const int g = j / kTile, t = j % kTile;
      // 16-byte reads: the 272-byte row stride puts the 8 rows a
      // quarter-warp reads on distinct banks
      const uint4* kr = reinterpret_cast<const uint4*>(&k_s[t * kStride]);
      const float* qr = q_s[g];
      float s = 0.f;
#pragma unroll 4
      for (int c = 0; c < kChunks; ++c) {
        const uint4 w = kr[c];
        const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 kf = __bfloat1622float2(k2[e]);
          s = fmaf(qr[8 * c + 2 * e], kf.x, s);
          s = fmaf(qr[8 * c + 2 * e + 1], kf.y, s);
        }
      }
      p_s[g][t] = (t0 + t < t_end) ? s * scale : gofr::kNegInf;
    }
    __syncthreads();

    for (int g = warp; g < group; g += kThreads / 32)
      gofr::fold_row64(p_s[g], &m_s[g], &l_s[g], &alpha_s[g]);
    __syncthreads();

    // P.V: this thread owns output column `tid` of every query row
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g)
      if (g < group) acc[g] *= alpha_s[g];
    for (int t = 0; t < kTile; ++t) {
      const float vt = __bfloat162float(v_s[t * kStride + tid]);
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g)
        if (g < group) acc[g] = fmaf(p_s[g][t], vt, acc[g]);
    }
    __syncthreads();  // every thread is done with this stage before it is refilled
  }
  gofr::cp_async_wait<0>();
  __syncthreads();  // m_s / l_s are final (a block with no tile has only its init)

  if (gridDim.z == 1) {
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g)
      if (g < group)
        out[((size_t)n * hq + h * group + g) * kD + tid] =
            __float2bfloat16(gofr::row_finish(acc[g], l_s[g]));
    return;
  }
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    if (g < group) {
      float* st = part + (((size_t)n * hq + h * group + g) * gridDim.z + split) * kState;
      st[tid] = acc[g];
      if (tid == 0) st[kD] = m_s[g], st[kD + 1] = l_s[g];
    }
  }
}

int launch(const void* q, const void* k, const void* v, const SlotRows& rows, const void* lengths,
           void* out, void* scratch, int n, int hkv, int group, int split_rows, int splits,
           float scale, void* stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kRingBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  decode_kernel<<<dim3(n, hkv, splits), kThreads, kRingBytes, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), rows,
      static_cast<const int*>(lengths), static_cast<bf16*>(out), static_cast<float*>(scratch),
      hkv, group, split_rows, scale);
  if (splits > 1) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    gofr::merge_splits<kD><<<dim3(n, hkv * group), kD, 0, s>>>(
        static_cast<const float*>(scratch), rows, static_cast<const int*>(lengths),
        static_cast<bf16*>(out), split_rows, splits);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `splits` runs of `split_rows` positions (splits x split_rows >=
// smax), then the merge; `scratch` holds n x Hq x splits x (D + 2) floats.
extern "C" int gofr_decode_attention(const void* q, const void* k_cache, const void* v_cache,
                                     const void* lengths, void* out, void* scratch, int n, int hkv,
                                     int group, int smax, int split_rows, int splits, float scale,
                                     void* stream) {
  const SlotRows rows{smax};
  return launch(q, k_cache, v_cache, rows, lengths, out, scratch, n, hkv, group, split_rows,
                splits, scale, stream);
}
