// Decode attention: one new token per slot against the bf16 KV cache, on
// either layout.
//
// Replaces gofr_tpu/ops/pallas/paged_decode.py paged_decode_attention
// (:94, pallas_call :122, body _paged_decode_kernel :54) over the page pool,
// and gofr_tpu/ops/pallas/decode_attention.py decode_attention (:85,
// pallas_call :111, body _decode_kernel :46) over the slot cache. The two
// differ only in where row t of (slot n, KV head h) lives, so one kernel
// template serves both through a row-addressing policy: PagedRows reads the
// slot's block-table entry, SlotRows steps from the slot's base.
//
// What bounds it on the card: device-memory bytes. Each slot's live K and V
// rows (len x Hkv x D x 2 planes x 2 B per layer) are read once and used for
// G = Hq/Hkv query rows only, about one multiply-add per byte, far below the
// ~295 operations per byte where an H100 turns compute-bound.
//
// Design:
//   - One thread block per (slot, KV head). The G query rows of the head
//     share every K/V tile the block stages, so K/V are read once per head,
//     not once per query head (the TPU kernels' [G, d] tile).
//   - The block reads its own length (and block-table row); there is no
//     scalar prefetch on the card. It walks only the live positions
//     (ceil(len/64) tiles of 64 rows), never the whole table or slot: the
//     TPU slot kernel streams all Smax positions and masks them.
//   - Tiles are staged in shared memory with 16-byte coalesced loads; rows
//     are padded by 16 B so the score loop reads them without bank conflicts.
//   - The online-softmax state is f32 (online_softmax.cuh); probabilities are
//     rounded to bf16 before the P.V product, as the TPU kernels do.
//   - A length is clamped to what the layout holds (MaxP x page, or Smax): an
//     idle slot-layout lane asks for Smax + 1 + k, and an unclamped length
//     would read the next head's rows. A table entry past the pool clamps to
//     page P-1 (read, then masked by length like the TPU kernel). Smax need
//     not be a multiple of 64: rows past the length are never loaded.
//     len == 0 writes zeros.
// This first version keeps one block per (slot, head) with no split over the
// sequence, so at small batch most SMs idle; that is the lever for later work.
#include <cstdint>

#include "online_softmax.cuh"

namespace {

constexpr int kD = 128;          // head_dim (the wrapper checks)
constexpr int kTile = 64;        // KV positions per staged tile
constexpr int kThreads = 128;    // == kD: one output column per thread
constexpr int kMaxGroup = 8;     // query heads per KV head
constexpr int kStride = kD + 8;  // padded smem row, in bf16 elements

// The page pool [P, Hkv, page, D] through the block table [N, MaxP].
struct PagedRows {
  const int* table;
  int pool, page, maxp;

  __device__ int length(const int* lengths, int n) const {
    return min(max(lengths[n], 0), maxp * page);
  }

  // element offset of row t of (slot n, KV head h)
  __device__ size_t row(int n, int h, int hkv, int t) const {
    const int entry = min(max(table[(size_t)n * maxp + t / page], 0), pool - 1);
    return (((size_t)entry * hkv + h) * page + t % page) * kD;
  }
};

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

template <class Rows>
__global__ void __launch_bounds__(kThreads) decode_kernel(
    const __nv_bfloat16* __restrict__ q,      // [N, Hq, D]
    const __nv_bfloat16* __restrict__ k,      // the layout's K rows
    const __nv_bfloat16* __restrict__ v,      // the layout's V rows
    const Rows rows,
    const int* __restrict__ lengths,          // [N]
    __nv_bfloat16* __restrict__ out,          // [N, Hq, D]
    int hkv, int group, float scale) {
  __shared__ __align__(16) __nv_bfloat16 k_s[kTile * kStride];
  __shared__ __align__(16) __nv_bfloat16 v_s[kTile * kStride];
  __shared__ float q_s[kMaxGroup][kD];
  __shared__ float p_s[kMaxGroup][kTile];
  __shared__ float m_s[kMaxGroup], l_s[kMaxGroup], alpha_s[kMaxGroup];

  const int n = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5;
  const int hq = hkv * group;
  const int len = rows.length(lengths, n);

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

  constexpr int kChunks = kD / 8;  // 16-byte chunks per row
  for (int t0 = 0; t0 < len; t0 += kTile) {
    // stage K/V rows t0 .. t0+63 of this (slot, head); rows past len are 0
    for (int c = tid; c < kTile * kChunks; c += kThreads) {
      const int r = c / kChunks, col = (c % kChunks) * 8;
      const int t = t0 + r;
      uint4 kk = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (t < len) {
        const size_t base = rows.row(n, h, hkv, t) + col;
        kk = *reinterpret_cast<const uint4*>(k + base);
        vv = *reinterpret_cast<const uint4*>(v + base);
      }
      *reinterpret_cast<uint4*>(&k_s[r * kStride + col]) = kk;
      *reinterpret_cast<uint4*>(&v_s[r * kStride + col]) = vv;
    }
    __syncthreads();

    // scores: one (query row, position) pair per thread and step
    for (int i = tid; i < group * kTile; i += kThreads) {
      const int g = i / kTile, t = i % kTile;
      // 16-byte reads: the 272-byte row stride puts the 8 rows a
      // quarter-warp reads on distinct banks
      const uint4* kr = reinterpret_cast<const uint4*>(&k_s[t * kStride]);
      const float* qr = q_s[g];
      float s = 0.f;
#pragma unroll 4
      for (int j = 0; j < kChunks; ++j) {
        const uint4 w = kr[j];
        const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 kf = __bfloat1622float2(k2[e]);
          s = fmaf(qr[8 * j + 2 * e], kf.x, s);
          s = fmaf(qr[8 * j + 2 * e + 1], kf.y, s);
        }
      }
      p_s[g][t] = (t0 + t < len) ? s * scale : gofr::kNegInf;
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
    __syncthreads();
  }

#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g)
    if (g < group)
      out[((size_t)n * hq + h * group + g) * kD + tid] =
          __float2bfloat16(gofr::row_finish(acc[g], l_s[g]));
}

template <class Rows>
int launch(const void* q, const void* k, const void* v, const Rows& rows, const void* lengths,
           void* out, int n, int hkv, int group, float scale, void* stream) {
  decode_kernel<Rows><<<dim3(n, hkv), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), rows, static_cast<const int*>(lengths),
      static_cast<__nv_bfloat16*>(out), hkv, group, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int gofr_paged_decode(const void* q, const void* k_pool, const void* v_pool,
                                 const void* table, const void* lengths, void* out,
                                 int n, int hkv, int group, int pool, int page, int maxp,
                                 float scale, void* stream) {
  const PagedRows rows{static_cast<const int*>(table), pool, page, maxp};
  return launch(q, k_pool, v_pool, rows, lengths, out, n, hkv, group, scale, stream);
}

extern "C" int gofr_decode_attention(const void* q, const void* k_cache, const void* v_cache,
                                     const void* lengths, void* out, int n, int hkv, int group,
                                     int smax, float scale, void* stream) {
  const SlotRows rows{smax};
  return launch(q, k_cache, v_cache, rows, lengths, out, n, hkv, group, scale, stream);
}
