// Decode attention over the slot cache, bf16 or f32: one new token per slot
// (kernel F); and over the f32 page pool (kernel A's f32 build), whose rows
// this body reaches through the block table. The page pool's other decode
// builds (kernel A on bf16 pages, D and E) live in paged_decode_q.cu.
//
// Replaces gofr_tpu/ops/pallas/decode_attention.py decode_attention (:85,
// pallas_call :111, body _decode_kernel :46), and for f32 pages
// gofr_tpu/ops/pallas/paged_decode.py paged_decode_attention (:94,
// pallas_call :122, body _paged_decode_kernel :54).
//
// What bounds it on the card: device-memory bytes. Each slot's live K and V
// rows (len x Hkv x D x 2 planes x 2 B per layer; 4 B at f32) are read once
// and used for G = Hq/Hkv query rows only, about one multiply-add per byte,
// far below the ~295 operations per byte where an H100 turns compute-bound.
// At the slot cache's engine shapes (8 slots, Hkv 8, lengths in the hundreds
// to thousands) that is 37 MB, 11 us at 3.35 TB/s; reaching it takes tens
// of KB in flight on every one of the 132 SMs.
//
// Design:
//   - One thread block per (slot, KV head, split of the sequence). The G
//     query rows of the head share every K/V tile the block stages, so K/V
//     are read once per head, not once per query head (the TPU kernel's [G,
//     d] tile). Where a tile's rows lie is the address policy's: on the
//     slot cache (SlotRows) row t of (slot n, KV head h) lies at a fixed
//     step from the slot's base; on the f32 pool (PoolRows) a tile's rows
//     lie in one page, found through one block-table entry a tile.
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
//   - The online-softmax state is f32 (online_softmax.cuh). The bf16 build
//     rounds probabilities to bf16 before the P.V product, as the TPU kernel
//     does (common.py:57 casts P to v.dtype); the f32 build keeps them
//     unrounded, as the same cast does at f32.
//   - A length is clamped to what the lane holds: Smax on the slot cache
//     (an idle slot-layout lane asks for Smax + 1 + k, and an unclamped
//     length would read the next head's rows), MaxP x page on the pool.
//     Smax need not be a multiple of 64: rows past the length are never
//     loaded.
//   - The head dim kD is a template parameter, built at 128 (Llama) and 64
//     (GPT-2, Llama one_b): a block has kD threads, one output column each,
//     so a 64 build runs two warps; its padded shared row is 144 B, whose
//     36-word step puts the eight rows a quarter-warp's 16-byte score reads
//     touch on distinct banks, as the 272-byte row does at 128. GPT-2's
//     group of 1 leaves seven of q_s's eight rows unused: correct, not fast.
//   - The element type T is the second template parameter, bf16 or float
//     (the f32 models: GPT-2 small in its own dtype, Llama at 128 and 64). A
//     tile keeps its bytes, not its rows: 64 rows of bf16, 32 of f32, so the
//     f32 ring is 67,584 B at 128 and three blocks still fit on an SM; a
//     split run stays a whole number of 64 rows, two f32 tiles. K and V come
//     in by 16-byte cp.async of 8 bf16 or 4 floats. The f32 row is padded by
//     16 B as well: its 132- or 68-word step is 4 words mod 32, so the eight
//     rows a quarter-warp's 16-byte score reads touch fall on distinct banks
//     again. An f32 tile row is folded by fold_row32 (one position a lane).
//   - The f32 pool (PoolRows, f32 only): a 32-row f32 tile starts at a
//     multiple of 32, so when page % 32 == 0 (the launcher's condition) it
//     never straddles a page, and each thread of the block reads the tile's
//     one table entry once, not once per 16-byte chunk. An entry outside the
//     pool (the OOB id P, or negative) clamps to a pool page (read, then
//     masked by the length), as kernel A's bf16 build does. P stays
//     unrounded, the merge runs in f32, the output is f32.
#include <cstdint>

#include "async_copy.cuh"
#include "online_softmax.cuh"
#include "split_merge.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxGroup = 8;     // query heads per KV head
constexpr int kStages = 2;       // K/V ring depth

// What follows the head dim kD and the element type T (the wrapper checks
// 128 or 64, bf16 or f32).
template <int kD, class T>
struct Dims {
  static_assert(kD == 128 || kD == 64, "built at head dims 128 and 64");
  static constexpr int kTile = 128 / sizeof(T);    // KV positions per tile: 64 bf16, 32 f32
  static constexpr int kThreads = kD;              // one output column per thread
  static constexpr int kPerChunk = 16 / sizeof(T); // elements per 16-byte chunk
  static constexpr int kStride = kD + kPerChunk;   // padded smem row (16 B of padding)
  static constexpr int kChunks = kD / kPerChunk;   // 16-byte chunks per row
  static constexpr int kTileElems = kTile * kStride;
  // K and V: 69,632 / 36,864 B (bf16 at 128 / 64), 67,584 / 34,816 B (f32)
  static constexpr int kRingBytes = kStages * 2 * kTileElems * sizeof(T);
  static constexpr int kState = kD + 2;            // one split's scratch per query row: acc[D], m, l
};

__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(float x) { return x; }

// s + q . (the elements of one 16-byte chunk w of a K row), qr[0] first
__device__ __forceinline__ float dot_chunk(const float* qr, uint4 w, float s, const bf16*) {
  const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 kf = __bfloat1622float2(k2[e]);
    s = fmaf(qr[2 * e], kf.x, s);
    s = fmaf(qr[2 * e + 1], kf.y, s);
  }
  return s;
}

__device__ __forceinline__ float dot_chunk(const float* qr, uint4 w, float s, const float*) {
  s = fmaf(qr[0], __uint_as_float(w.x), s);
  s = fmaf(qr[1], __uint_as_float(w.y), s);
  s = fmaf(qr[2], __uint_as_float(w.z), s);
  return fmaf(qr[3], __uint_as_float(w.w), s);
}

// Fold one tile row of scores into the running state and leave the P.V
// weights in it: bf16-rounded for the bf16 build, f32 for the f32 build.
__device__ __forceinline__ void fold_tile_row(float* row, float* m, float* l, float* alpha,
                                              const bf16*) {
  gofr::fold_row64(row, m, l, alpha);
}

__device__ __forceinline__ void fold_tile_row(float* row, float* m, float* l, float* alpha,
                                              const float*) {
  gofr::fold_row32(row, m, l, alpha);
}

// The address policies, for the decode kernel and the merge alike:
// `length(lengths, n)`, lane n's length clamped to what it holds, and
// `tile(n, h, hkv, t0)`, the element offset of row t0 of (lane n, KV head h)
// in its layer slice, the start of a tile whose live rows follow at a step
// of kD elements.
//
// The slot cache's layer slice [N, Hkv, Smax, kD]: lane n is slot n.
template <int kD>
struct SlotRows {
  int smax;

  __device__ int length(const int* lengths, int n) const {
    return min(max(lengths[n], 0), smax);
  }

  __device__ size_t tile(int n, int h, int hkv, int t) const {
    return (((size_t)n * hkv + h) * smax + t) * kD;
  }
};

// The f32 pool's layer slice [P, Hkv, page, kD] through the block table
// [N, MaxP]; a tile (32 f32 rows from a multiple of 32) lies in one page
// when page % 32 == 0.
template <int kD>
struct PoolRows {
  const int* table;
  int maxp, page, pool;

  __device__ int length(const int* lengths, int n) const {
    return min(max(lengths[n], 0), maxp * page);
  }

  __device__ size_t tile(int n, int h, int hkv, int t) const {
    const int logical = t / page;
    const int entry = min(max(__ldg(table + (size_t)n * maxp + logical), 0), pool - 1);
    return (((size_t)entry * hkv + h) * page + t % page) * kD;
  }
};

template <int kD, class T, class Rows>
__global__ void __launch_bounds__(kD) decode_kernel(
    const T* __restrict__ q,         // [N, Hq, D]
    const T* __restrict__ k,         // the layer slice Rows addresses
    const T* __restrict__ v,
    const Rows rows,
    const int* __restrict__ lengths,  // [N]
    T* __restrict__ out,              // [N, Hq, D], written here when there is one split
    float* __restrict__ part,         // [N, Hq, splits, kState], written when there are more
    int hkv, int group, int split_rows, float scale) {
  using Dm = Dims<kD, T>;
  constexpr int kTile = Dm::kTile, kThreads = Dm::kThreads, kStride = Dm::kStride;
  constexpr int kChunks = Dm::kChunks, kPerChunk = Dm::kPerChunk, kTileElems = Dm::kTileElems;
  constexpr int kState = Dm::kState;
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
  T* const ring_s = reinterpret_cast<T*>(ring);

  // copy rows t_begin + kTile i .. of this (slot, head) into stage i % 2;
  // rows at or past t_end are zero-filled
  auto stage = [&](int i) {
    T* k_s = ring_s + (i % kStages) * 2 * kTileElems;
    T* v_s = k_s + kTileElems;
    const int t0 = t_begin + i * kTile;
    const size_t first = rows.tile(n, h, hkv, t0);  // t0 < t_end: a live row
    for (int c = tid; c < kTile * kChunks; c += kThreads) {
      const int r = c / kChunks, col = (c % kChunks) * kPerChunk, t = t0 + r;
      const bool ok = t < t_end;
      const size_t base = (ok ? first + (size_t)r * kD : 0) + col;
      gofr::cp_async16(k_s + r * kStride + col, k + base, ok);
      gofr::cp_async16(v_s + r * kStride + col, v + base, ok);
    }
  };
  if (n_tiles > 0) stage(0);
  gofr::cp_async_commit();

  for (int i = tid; i < group * kD; i += kThreads) {
    const int g = i / kD, j = i % kD;
    q_s[g][j] = to_float(q[((size_t)n * hq + h * group + g) * kD + j]);
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
    const T* k_s = ring_s + (i % kStages) * 2 * kTileElems;
    const T* v_s = k_s + kTileElems;

    // scores: one (query row, position) pair per thread and step
    for (int j = tid; j < group * kTile; j += kThreads) {
      const int g = j / kTile, t = j % kTile;
      // 16-byte reads: the padded row stride (4 words mod 32) puts the 8
      // rows a quarter-warp reads on distinct banks
      const uint4* kr = reinterpret_cast<const uint4*>(&k_s[t * kStride]);
      const float* qr = q_s[g];
      float s = 0.f;
#pragma unroll 4
      for (int c = 0; c < kChunks; ++c) s = dot_chunk(qr + kPerChunk * c, kr[c], s, k_s);
      p_s[g][t] = (t0 + t < t_end) ? s * scale : gofr::kNegInf;
    }
    __syncthreads();

    for (int g = warp; g < group; g += kThreads / 32)
      fold_tile_row(p_s[g], &m_s[g], &l_s[g], &alpha_s[g], k_s);
    __syncthreads();

    // P.V: this thread owns output column `tid` of every query row
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g)
      if (g < group) acc[g] *= alpha_s[g];
    for (int t = 0; t < kTile; ++t) {
      const float vt = to_float(v_s[t * kStride + tid]);
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
        gofr::store_out(out + ((size_t)n * hq + h * group + g) * kD + tid,
                        gofr::row_finish(acc[g], l_s[g]));
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

template <int kD, class T, class Rows>
int launch(const void* q, const void* k, const void* v, const Rows rows, const void* lengths,
           void* out, void* scratch, int n, int hkv, int group, int split_rows, int splits,
           float scale, void* stream) {
  constexpr int kRingBytes = Dims<kD, T>::kRingBytes;
  static bool configured = false;  // one flag per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<kD, T, Rows>, cudaFuncAttributeMaxDynamicSharedMemorySize, kRingBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  decode_kernel<kD, T, Rows><<<dim3(n, hkv, splits), Dims<kD, T>::kThreads, kRingBytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), rows,
      static_cast<const int*>(lengths), static_cast<T*>(out), static_cast<float*>(scratch), hkv,
      group, split_rows, scale);
  if (splits > 1) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    gofr::merge_splits<kD><<<dim3(n, hkv * group), kD, 0, s>>>(
        static_cast<const float*>(scratch), rows, static_cast<const int*>(lengths),
        static_cast<T*>(out), split_rows, splits);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int kD>
int launch_pool_f32(const void* q, const void* k_pool, const void* v_pool, const void* table,
                    const void* lengths, void* out, void* scratch, int n, int hkv, int group,
                    int pool, int page, int maxp, int split_rows, int splits, float scale,
                    void* stream) {
  // a 32-row f32 tile must not straddle a page (the launcher checks too)
  if (page % Dims<kD, float>::kTile != 0 || pool <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const PoolRows<kD> rows{static_cast<const int*>(table), maxp, page, pool};
  return launch<kD, float>(q, k_pool, v_pool, rows, lengths, out, scratch, n, hkv, group,
                           split_rows, splits, scale, stream);
}

}  // namespace

// `splits` runs of `split_rows` positions (splits x split_rows >=
// smax), then the merge; `scratch` holds n x Hq x splits x (D + 2) floats.
// One entry point a build: head dim 128 (Llama) and 64 (GPT-2), each on
// bf16 and on f32 planes.
extern "C" int gofr_decode_attention(const void* q, const void* k_cache, const void* v_cache,
                                     const void* lengths, void* out, void* scratch, int n, int hkv,
                                     int group, int smax, int split_rows, int splits, float scale,
                                     void* stream) {
  return launch<128, bf16>(q, k_cache, v_cache, SlotRows<128>{smax}, lengths, out, scratch, n,
                           hkv, group, split_rows, splits, scale, stream);
}

extern "C" int gofr_decode_attention_d64(const void* q, const void* k_cache, const void* v_cache,
                                         const void* lengths, void* out, void* scratch, int n,
                                         int hkv, int group, int smax, int split_rows, int splits,
                                         float scale, void* stream) {
  return launch<64, bf16>(q, k_cache, v_cache, SlotRows<64>{smax}, lengths, out, scratch, n, hkv,
                          group, split_rows, splits, scale, stream);
}

extern "C" int gofr_decode_attention_f32(const void* q, const void* k_cache, const void* v_cache,
                                         const void* lengths, void* out, void* scratch, int n,
                                         int hkv, int group, int smax, int split_rows, int splits,
                                         float scale, void* stream) {
  return launch<128, float>(q, k_cache, v_cache, SlotRows<128>{smax}, lengths, out, scratch, n,
                            hkv, group, split_rows, splits, scale, stream);
}

extern "C" int gofr_decode_attention_d64_f32(const void* q, const void* k_cache,
                                             const void* v_cache, const void* lengths, void* out,
                                             void* scratch, int n, int hkv, int group, int smax,
                                             int split_rows, int splits, float scale,
                                             void* stream) {
  return launch<64, float>(q, k_cache, v_cache, SlotRows<64>{smax}, lengths, out, scratch, n, hkv,
                           group, split_rows, splits, scale, stream);
}

// Kernel A on the f32 pool, head dims 128 (Llama-3-8B's widths) and 64
// (Llama one_b): the arguments of paged_decode_q.cu's gofr_paged_decode
// (`splits` runs of `split_rows` positions over the MaxP x page a table row
// holds); page % 32 == 0.
extern "C" int gofr_paged_decode_f32(const void* q, const void* k_pool, const void* v_pool,
                                     const void* table, const void* lengths, void* out,
                                     void* scratch, int n, int hkv, int group, int pool, int page,
                                     int maxp, int split_rows, int splits, float scale,
                                     void* stream) {
  return launch_pool_f32<128>(q, k_pool, v_pool, table, lengths, out, scratch, n, hkv, group, pool,
                              page, maxp, split_rows, splits, scale, stream);
}

extern "C" int gofr_paged_decode_d64_f32(const void* q, const void* k_pool, const void* v_pool,
                                         const void* table, const void* lengths, void* out,
                                         void* scratch, int n, int hkv, int group, int pool,
                                         int page, int maxp, int split_rows, int splits,
                                         float scale, void* stream) {
  return launch_pool_f32<64>(q, k_pool, v_pool, table, lengths, out, scratch, n, hkv, group, pool,
                             page, maxp, split_rows, splits, scale, stream);
}
