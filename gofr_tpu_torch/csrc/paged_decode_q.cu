// Paged decode attention: one new token per slot against the page pool, in
// any of its three row formats: bf16 rows (kernel A), int8 rows (kernel D)
// or packed int4 rows (kernel E), the quantized ones with one bf16 scale per
// (page, head, position) for K and for V.
//
// Replaces gofr_tpu/ops/pallas/paged_decode.py paged_decode_attention (:94,
// pallas_call :122, body _paged_decode_kernel :54), paged_decode_attention_q
// (:195, pallas_call :232, body _paged_decode_q_kernel :148) and
// paged_decode_attention_q4 (:314, pallas_call :355, body
// _paged_decode_q4_kernel :260).
//
// What bounds it on the card: device-memory bytes. Each slot's live rows are
// read once per layer, len x Hkv x 2 planes x row bytes (256 B bf16, 128 B
// int8, 64 B packed int4), plus 2 x 2 B of scales on the quantized pools,
// for about one multiply-add per element, far below the ~295 operations per
// byte where an H100 turns compute-bound. At 8 slots of about a thousand
// rows that is 37 MB (bf16), 19 MB (int8) or 10 MB (int4), 11, 5.7 or 2.9 us
// at 3.35 TB/s: the card needs tens of KB in flight on every SM, and little
// arithmetic per byte, to come near it.
//
// Design, one template over a row-format policy (Bf16Rows, Int8Rows,
// Int4Rows):
//   - One thread block per (slot, KV head, split of the sequence), the split
//     from ops/cuda/decode_attention.split_plan on the shapes alone, as in
//     kernel F (paged_decode.cu): a block whose run starts at or past the
//     slot's length exits at once; the others write the f32 state of their G
//     query rows to scratch, and the merge of split_merge.cuh, launched from
//     the same entry point, combines the live runs. With one split the block
//     finishes in place.
//   - Tiles of 64 rows flow through a two-stage ring of cp.async copies
//     (async_copy.cuh) in dynamic shared memory (64 KB for bf16 rows, over
//     the 48 KB a static array may take): the K and V rows and, on the
//     quantized pools, the tile's 64 K and 64 V scales, eight 16-byte copies
//     a plane when page % 8 == 0 (eight rows of a tile then never straddle a
//     page; other page sizes, or scales off 16-byte alignment, take plain
//     loads). A format without scales stages none: the policy's kScaled
//     removes that code at compile time. The next tile loads while the
//     current one is scored and folded.
//   - The block-table entries of a tile, one per page it touches (one when
//     page % 64 == 0), are staged in shared memory by 4-byte cp.async copies
//     two tiles ahead of the rows, so no row address waits on a table load and
//     each entry is read once per tile, not once per 16-byte chunk. An entry
//     past the pool clamps to page P-1 (read, then masked by length), a
//     length to MaxP x page.
//   - q.k runs on the tensor cores, mma.sync m16n8k16 bf16 -> f32: the G
//     query rows (padded to 16) are A fragments held in registers, each warp
//     takes 16 positions of the tile as B fragments. bf16 K rows go into the
//     B fragments as they are; int8 values and int4 nibbles are exact in
//     bf16, so theirs is the TPU kernel's k.astype(q.dtype) product with f32
//     accumulation, and each staged K element is converted once per block (a
//     byte to bf16 through the f32 2^23 trick, a nibble through 0x4300 | n ==
//     128 + n: no conversion unit), not once per query row. The head
//     dimension is permuted between the fragments, Q's and K's alike, so a
//     thread reads its 64 (bf16), 32 (int8) or 16 (int4) bytes of a row with
//     16-byte loads that fall on distinct banks: int8 rows are padded to
//     144 B, int4 rows kept at 64 B, and bf16 rows kept at 256 B with their
//     16-byte chunks swizzled (Bf16Rows::offset), which also serves the P.V
//     reads below.
//   - P.V on the bf16 pool (kMmaPV): the TPU kernel's product, p rounded to
//     bf16 (fold_row64, common.py:57) times bf16 V with f32 accumulation, on
//     mma.sync: each warp owns 32 output columns over the whole tile, p as A
//     fragments from shared memory, V as B fragments by ldmatrix.trans (V
//     keeps its [t, d] layout), so no partial sums cross warps.
//   - P.V on the quantized pools stays in f32 on the unrounded p * vs
//     (online_softmax.cuh's v_scale fold): each thread owns 4 (int8) or 8
//     (int4) output columns of a quarter of the tile's positions, converts
//     each V element exactly to f32 once, and the warps' partial sums are
//     added once, at the end.
//   - Packed int4 is split-half: output column c < D/2 is the low nibble of
//     byte c, column c >= D/2 the high nibble of byte c - D/2, both biased
//     by +8. A zero byte decodes to -8, so rows past the length are masked
//     by their score, never trusted to carry a zero scale.
//   - The arithmetic is the Pallas bodies', not the XLA path's: scores
//     s = (q.k) * scale (* ks[t] on the quantized pools) summed in f32;
//     t >= len masked to kNegInf; the online softmax in f32, its normaliser
//     summing the unrounded p, and p rounded to bf16 before P.V (bf16) or
//     kept f32 and multiplied by vs[t] (the v_scale fold); out = acc /
//     max(l, 1e-20); len == 0 gives zeros.
//   - The head dim is the row policy's kD. Bf16Rows is a template built at
//     128 (Llama-3-8B) and 64 (Llama one_b): a 64-wide row is 128 B, eight
//     16-byte chunks under the same three-bit swizzle (the two rows a
//     quarter-warp's score loads read still cover all 32 banks, and eight
//     consecutive rows still differ in bits 0..2 for ldmatrix), kD / 16 mma
//     steps over the head dimension, and kD / 4 output columns a warp in
//     the P.V. Int8Rows and Int4Rows are templates at 128 and 64 too: a
//     64-wide int8 row is 64 B (one 16-byte fragment load a quad thread,
//     unpadded), a packed int4 row 32 B (one 8-byte load, the high nibbles
//     32 columns up); their f32 P.V runs 16 (int8) or 8 (int4) lanes a row,
//     2 or 4 rows a step, and the final sum writes one column a thread, so
//     threads kD..127 write nothing.
//   - The query's type TQ is the kernel's second template parameter: bf16,
//     or f32 for kernels D and E under an f32 model (Int8Rows and Int4Rows
//     at 128 and 64; A's f32 build is paged_decode.cu's). The TPU kernels
//     take k.astype(q.dtype) against the f32 q with f32 accumulation
//     (paged_decode.py:148, :260; the int4 K converts to q.dtype at :291).
//     Here an f32 q is split as it is loaded into three bf16 pieces, h =
//     bf16(q), m = bf16(q - h), l = bf16(q - h - m) (mma.cuh split_pair),
//     which together hold all 24 of its significand bits, and the scores run
//     three mma.sync per step (l.k, m.k, then h.k) against the same K
//     fragments: an int8 value or a nibble is exact in bf16 and each bf16 x
//     code product is exact in f32, so K needs no split (Int4Rows::k_frags
//     already yields bf16 pairs) and the scores are the f32 product up to
//     the order of the f32 sums. The pieces are three sets of A fragments
//     in registers (kQPieces). P.V is unchanged (already f32 on the
//     unrounded p * vs); the output and the merge's are written in f32
//     through store_out's f32 overload.
#include <cstdint>
#include <type_traits>

#include "async_copy.cuh"
#include "mma.cuh"
#include "online_softmax.cuh"
#include "split_merge.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;                     // KV positions per staged tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kWarpRows = kTile / kWarps;     // positions per warp: two m16n8 score tiles
constexpr int kMaxGroup = 8;                  // query heads per KV head (mma rows 0..7)
constexpr int kStages = 2;                    // K/V ring depth
// Table entries are copied two tiles ahead of their rows, so the buffer a
// step refills was last read before the previous step's __syncthreads.
constexpr int kEntryBufs = 4;
// p_s row stride in floats: the query rows' same positions eight banks apart
constexpr int kPRow = kTile + 8;
constexpr float kTwo23 = 8388608.f;           // f32 bits 0x4B000000 | u read as 2^23 + u

// Two f32 that are exact in bf16 (at most 8 significant bits) as one bf16
// pair, `lo` in the low half: the top half of each f32 is its bf16, exactly.
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// Byte i of `u` as the f32 2^23 + byte.
__device__ __forceinline__ float two23_plus(uint32_t u, int i) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + i));
}

// bf16 rows (kernel A) of head dim D (128 or 64): element c is bf16 c. A
// row's D / 8 16-byte chunks are stored unpadded, chunk j of tile row r at
// chunk j ^ swizzle(r): rows 2m and 2m + 1 differ in bit 2 of the swizzle,
// so the two rows a quarter-warp's score loads read cover all 32 banks, and
// eight consecutive rows differ in bits 0..2, so each matrix of an ldmatrix
// does too.
template <int D>
struct Bf16Rows {
  static_assert(D == 128 || D == 64, "built at head dims 128 and 64");
  static constexpr int kD = D;
  static constexpr int kSteps = kD / 16;         // m16n8k16 steps over the head dimension
  static constexpr bool kScaled = false;
  static constexpr bool kMmaPV = true;
  static constexpr int kBytes = kD * 2;
  static constexpr int kStride = kBytes;
  using Word = uint2;                            // f32 P.V: four columns a lane
  static constexpr int kCols = 4;

  __device__ static int offset(int r, int byte) {
    const int swizzle = ((r & 1) << 2) | ((r >> 1) & 3);
    return r * kStride + (byte ^ (swizzle << 4));
  }

  // Quad thread c reads chunks c, 4 + c, ... of a row: step s takes columns
  // col, col + 1 (a[0]/b0) and col + 2, col + 3 (a[2]/b1) of chunk
  // 4 (s / 2) + c.
  __device__ static int frag_col(int c, int s) { return (s >> 1) * 32 + c * 8 + (s & 1) * 4; }

  __device__ static void k_frags(const uint8_t* tile, int r, int c, uint32_t (&b)[kSteps][2]) {
#pragma unroll
    for (int k = 0; k < kSteps / 2; ++k) {
      const uint4 w = *reinterpret_cast<const uint4*>(tile + offset(r, (4 * k + c) * 16));
      b[2 * k][0] = w.x;
      b[2 * k][1] = w.y;
      b[2 * k + 1][0] = w.z;
      b[2 * k + 1][1] = w.w;
    }
  }

  __device__ static void values(uint2 w, float (&v)[kCols]) {
    v[0] = __uint_as_float(w.x << 16);
    v[1] = __uint_as_float(w.x & 0xFFFF0000u);
    v[2] = __uint_as_float(w.y << 16);
    v[3] = __uint_as_float(w.y & 0xFFFF0000u);
  }

  // head_dim column of value i of the word at byte j
  __device__ static int col(int j, int i) { return j / 2 + i; }
};

// int8 rows (kernel D) of head dim D (128 or 64): element c is byte c. At
// 128 a row is padded to 144 B: a quarter-warp's score loads then read two
// rows 144 B apart, on distinct banks. At 64 the row stays at 64 B: the two
// rows are 128 contiguous bytes, and a 16-byte pad would collide at byte 128.
template <int D>
struct Int8Rows {
  static_assert(D == 128 || D == 64, "built at head dims 128 and 64");
  static constexpr int kD = D;
  static constexpr int kSteps = kD / 16;
  static constexpr bool kScaled = true;
  static constexpr bool kMmaPV = false;
  static constexpr int kBytes = kD;
  static constexpr int kStride = kD == 128 ? kBytes + 16 : kBytes;  // shared row, bytes
  static constexpr int kFragBytes = kBytes / 4;  // bytes of a row one thread of a quad reads
  using Word = uint32_t;
  static constexpr int kCols = 4;                // P.V columns in a 4-byte word

  __device__ static int offset(int r, int byte) { return r * kStride + byte; }

  // First head_dim column of step s's elements for quad thread c: a[0]/b0
  // hold columns col, col + 1, a[2]/b1 col + 2, col + 3.
  __device__ static int frag_col(int c, int s) { return c * kFragBytes + s * 4; }

  // The four int8 values of a word, exactly, as f32: each byte biased to
  // unsigned and read as 2^23 + byte.
  __device__ static void values(uint32_t w, float (&v)[kCols]) {
    const uint32_t u = w ^ 0x80808080u;
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = two23_plus(u, i) - (kTwo23 + 128.f);
  }

  // B fragments of every step from this thread's kFragBytes of staged row
  // r: one 16-byte load per four steps (two at 128, one at 64).
  __device__ static void k_frags(const uint8_t* tile, int r, int c, uint32_t (&b)[kSteps][2]) {
    const uint4* p = reinterpret_cast<const uint4*>(tile + offset(r, c * kFragBytes));
#pragma unroll
    for (int k = 0; k < kSteps / 4; ++k) {
      const uint4 w4 = p[k];
      const uint32_t w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        float v[kCols];
        values(w[s], v);
        b[4 * k + s][0] = bf16_pair(v[0], v[1]);
        b[4 * k + s][1] = bf16_pair(v[2], v[3]);
      }
    }
  }

  __device__ static int col(int j, int i) { return j + i; }
};

// packed int4 rows (kernel E) of head dim D (128 or 64), split-half
// (ops/quant.py pack_int4): byte j holds element j in its low nibble and
// element j + D/2 in its high nibble. A row is 64 B at 128 and 32 B at 64,
// unpadded: a quarter-warp's 16-byte loads (128) read two rows, a
// half-warp's 8-byte loads (64) four, 128 contiguous bytes either way.
template <int D>
struct Int4Rows {
  static_assert(D == 128 || D == 64, "built at head dims 128 and 64");
  static constexpr int kD = D;
  static constexpr int kSteps = kD / 16;
  static constexpr bool kScaled = true;
  static constexpr bool kMmaPV = false;
  static constexpr int kBytes = kD / 2;
  static constexpr int kStride = kBytes;
  static constexpr int kFragBytes = kBytes / 4;  // 16 B (128) or 8 B (64) a quad thread
  using Word = uint32_t;
  static constexpr int kCols = 8;
  static constexpr int kBias = 8;
  static constexpr int kLoShift = 0, kHiShift = 4;
  using Frag = typename std::conditional<kFragBytes == 16, uint4, uint2>::type;

  __device__ static int offset(int r, int byte) { return r * kStride + byte; }

  // steps below kSteps / 2 take low nibbles, the others the high nibbles of
  // the same bytes
  __device__ static int frag_col(int c, int s) {
    return (s >= kSteps / 2 ? kBytes : 0) + c * kFragBytes + (s % (kSteps / 2)) * 4;
  }

  __device__ static void values(uint32_t w, float (&v)[kCols]) {
    const uint32_t lo = (w >> kLoShift) & 0x0F0F0F0Fu, hi = (w >> kHiShift) & 0x0F0F0F0Fu;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[i] = two23_plus(lo, i) - (kTwo23 + kBias);
      v[4 + i] = two23_plus(hi, i) - (kTwo23 + kBias);
    }
  }

  // The nibbles at `shift` of the bytes of `spread` ([b0, 0, b1, 0]) as a
  // bf16 pair: 0x4300 | n is 128 + n, exactly; less 128 + kBias.
  __device__ static uint32_t nibble_pair(uint32_t spread, int shift) {
    const uint32_t bits = ((spread >> shift) & 0x000F000Fu) | 0x43004300u;
    const __nv_bfloat162 v = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&bits),
                                     __float2bfloat162_rn(128.f + kBias));
    return *reinterpret_cast<const uint32_t*>(&v);
  }

  __device__ static void k_frags(const uint8_t* tile, int r, int c, uint32_t (&b)[kSteps][2]) {
    const Frag w = *reinterpret_cast<const Frag*>(tile + offset(r, c * kFragBytes));
    const uint32_t* words = reinterpret_cast<const uint32_t*>(&w);
#pragma unroll
    for (int s = 0; s < kSteps / 2; ++s) {
      const uint32_t b01 = __byte_perm(words[s], 0, 0x4140), b23 = __byte_perm(words[s], 0, 0x4342);
      b[s][0] = nibble_pair(b01, kLoShift);
      b[s][1] = nibble_pair(b23, kLoShift);
      b[kSteps / 2 + s][0] = nibble_pair(b01, kHiShift);
      b[kSteps / 2 + s][1] = nibble_pair(b23, kHiShift);
    }
  }

  __device__ static int col(int j, int i) { return (i >= 4 ? kBytes : 0) + j + i % 4; }
};

// A slot's length clamped to what its table row holds: for the decode
// kernel and the merge alike.
struct PoolLength {
  int maxp, page;

  __device__ int length(const int* lengths, int n) const {
    return min(max(lengths[n], 0), maxp * page);
  }
};

// The query's A fragments: step s's two registers of quad thread c (columns
// col, col + 1 and col + 2, col + 3 of its row), as bf16 pairs read from a
// bf16 q, or (kQPieces 3) the pieces h, m, l of an f32 q.
template <class TQ>
struct QFrags {
  static constexpr int kQPieces = 1;
  __device__ static void load(const bf16* qr, int col, uint32_t (&a)[kQPieces][2]) {
    a[0][0] = *reinterpret_cast<const uint32_t*>(qr + col);
    a[0][1] = *reinterpret_cast<const uint32_t*>(qr + col + 2);
  }
};

template <>
struct QFrags<float> {
  static constexpr int kQPieces = 3;
  __device__ static void load(const float* qr, int col, uint32_t (&a)[kQPieces][2]) {
    gofr::split_pair(*reinterpret_cast<const float2*>(qr + col), a[0][0], a[1][0], a[2][0]);
    gofr::split_pair(*reinterpret_cast<const float2*>(qr + col + 2), a[0][1], a[1][1], a[2][1]);
  }
};

template <class Rows, class TQ>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const TQ* __restrict__ q,            // [N, Hq, D]
    const uint8_t* __restrict__ k_pool,  // [P, Hkv, page, Rows::kBytes]
    const uint8_t* __restrict__ v_pool,  // [P, Hkv, page, Rows::kBytes]
    const bf16* __restrict__ k_scale,    // [P, Hkv, page] (read only if Rows::kScaled)
    const bf16* __restrict__ v_scale,    // [P, Hkv, page] (read only if Rows::kScaled)
    const int* __restrict__ table,       // [N, MaxP]
    const int* __restrict__ lengths,     // [N]
    const PoolLength pool_len,
    TQ* __restrict__ out,                // [N, Hq, D], written here when there is one split
    float* __restrict__ part,            // [N, Hq, splits, kState], written when there are more
    int hkv, int group, int pool, int page, int split_rows, int vector_scales, float scale) {
  constexpr int kD = Rows::kD;
  constexpr int kSteps = Rows::kSteps;
  constexpr int kWarpCols = kD / kWarps;                 // output columns per warp of the mma P.V
  constexpr int kState = kD + 2;                         // one split's scratch per query row: acc[D], m, l
  using Word = typename Rows::Word;
  constexpr int kChunks = Rows::kBytes / 16;             // 16-byte chunks per row
  constexpr int kTileBytes = kTile * Rows::kStride;
  constexpr int kLanesPerRow = Rows::kBytes / sizeof(Word);  // f32 P.V: one word per lane
  constexpr int kRowsPerStep = 32 / kLanesPerRow;
  constexpr int kScaleSlots = Rows::kScaled ? kTile : 1;
  constexpr int kQPieces = QFrags<TQ>::kQPieces;         // 1 (bf16 q) or 3 (f32 q: h, m, l)
  static_assert(kStages * 2 * kTileBytes >= kWarps * kMaxGroup * kD * 4,
                "the warps' partial sums reuse the ring");
  extern __shared__ __align__(16) uint8_t ring_smem[];
  auto ring = reinterpret_cast<uint8_t (*)[2][kTileBytes]>(ring_smem);  // [stage][K, V] rows
  __shared__ __align__(16) bf16 scales_s[kStages][2][kScaleSlots];     // K, V scales
  __shared__ int entries_s[kEntryBufs][kTile];                         // a tile's table entries
  __shared__ __align__(16) float p_s[kMaxGroup][kPRow];
  __shared__ float vs_s[kScaleSlots];
  __shared__ float m_s[kMaxGroup], l_s[kMaxGroup], alpha_s[kMaxGroup];

  const int n = blockIdx.x, h = blockIdx.y, split = blockIdx.z, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, quad = lane >> 2, c = lane & 3;
  const int mat = lane >> 3, mrow = lane & 7;  // ldmatrix: which 8x8 matrix, which row
  const int hq = hkv * group;
  const int len = pool_len.length(lengths, n);
  const int t_begin = split * split_rows;
  const int t_end = min(len, t_begin + split_rows);
  if (gridDim.z > 1 && t_begin >= len) return;  // no live row: the merge never reads this split
  const int n_tiles = (max(t_end - t_begin, 0) + kTile - 1) / kTile;
  const int* row_table = table + (size_t)n * pool_len.maxp;

  // copy the table entries of tile i, one per page it touches, into
  // entries_s[i % kEntryBufs]
  auto stage_entries = [&](int i) {
    const int t0 = t_begin + i * kTile;
    if (t0 >= t_end) return;
    const int first = t0 / page;
    if (tid <= (min(t0 + kTile, t_end) - 1) / page - first)
      gofr::cp_async4(&entries_s[i % kEntryBufs][tid], row_table + first + tid);
  };
  // copy the rows (and scales) of tile i into stage i % kStages through its
  // staged entries; rows at or past t_end are zero-filled
  auto stage = [&](int i) {
    const int t0 = t_begin + i * kTile, first = t0 / page, st = i % kStages;
    const int* entry = entries_s[i % kEntryBufs];
    auto at = [&](int t) {  // (page, head, position) index of row t < t_end
      const int e = min(max(entry[t / page - first], 0), pool - 1);
      return ((size_t)e * hkv + h) * page + t % page;
    };
    for (int j = tid; j < kTile * kChunks; j += kThreads) {
      const int r = j / kChunks, col = (j % kChunks) * 16, t = t0 + r;
      const bool ok = t < t_end;
      const size_t base = (ok ? at(t) * Rows::kBytes : 0) + col;
      gofr::cp_async16(&ring[st][0][Rows::offset(r, col)], k_pool + base, ok);
      gofr::cp_async16(&ring[st][1][Rows::offset(r, col)], v_pool + base, ok);
    }
    if constexpr (Rows::kScaled) {
      if (vector_scales) {  // eight scales per copy: threads 0-7 K, 8-15 V
        if (tid < 2 * kTile / 8) {
          const int r = (tid % 8) * 8, t = t0 + r;
          const bool ok = t < t_end;
          gofr::cp_async16(&scales_s[st][tid / 8][r], (tid < 8 ? k_scale : v_scale) + (ok ? at(t) : 0),
                           ok);
        }
      } else {  // one scale per thread: threads 0-63 K, 64-127 V
        const int r = tid % kTile, t = t0 + r;
        scales_s[st][tid / kTile][r] =
            t < t_end ? (tid < kTile ? k_scale : v_scale)[at(t)] : __float2bfloat16(0.f);
      }
    }
  };

  stage_entries(0);
  stage_entries(1);
  gofr::cp_async_commit();

  // Q as the A fragments of every step (of every piece of an f32 q), rows
  // >= group zero (read while the first entries arrive)
  uint32_t qa[kSteps][kQPieces][2];
  {
    const TQ* qr = q + ((size_t)n * hq + h * group + min(quad, group - 1)) * kD;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      QFrags<TQ>::load(qr, Rows::frag_col(c, s), qa[s]);
#pragma unroll
      for (int p = 0; p < kQPieces; ++p)
        if (quad >= group) qa[s][p][0] = qa[s][p][1] = 0u;
    }
  }
  if (tid < group) {
    m_s[tid] = gofr::kNegInf;
    l_s[tid] = 0.f;
  }
  // mma P.V: query row `quad`, columns warp * kWarpCols + 8 j + 2c, + 1 in
  // pv[j][0], pv[j][1] (pv[j][2..3] are the zero rows 8..15)
  float pv[kWarpCols / 8][4];
  // f32 P.V: this thread's columns of its positions, every query row
  float acc[kMaxGroup][Rows::kCols];
#pragma unroll
  for (int j = 0; j < kWarpCols / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) pv[j][e] = 0.f;
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g)
#pragma unroll
    for (int i = 0; i < Rows::kCols; ++i) acc[g][i] = 0.f;

  gofr::cp_async_wait<0>();
  __syncthreads();
  if (n_tiles > 0) stage(0);
  stage_entries(2);
  gofr::cp_async_commit();

  // f32 P.V: this lane's word of row vr of each step of kRowsPerStep rows
  const int vj = (lane % kLanesPerRow) * sizeof(Word), vr = lane / kLanesPerRow;
  for (int i = 0; i < n_tiles; ++i) {
    const int t0 = t_begin + i * kTile, st = i % kStages;
    if (i + 1 < n_tiles) stage(i + 1);  // its entries arrived with tile i - 1's rows
    stage_entries(i + 3);
    gofr::cp_async_commit();            // possibly empty, so one wait depth serves every step
    gofr::cp_async_wait<1>();
    __syncthreads();
    const uint8_t* k_tile = ring[st][0];
    const uint8_t* v_tile = ring[st][1];
    const bf16* ks_tile = scales_s[st][0];

    // scores: warp w takes positions 16w .. 16w+15, two m16n8 tiles; the C
    // fragment gives this thread query row `quad` at positions 2c, 2c + 1
#pragma unroll
    for (int nt = 0; nt < kWarpRows / 8; ++nt) {
      const int t_base = warp * kWarpRows + nt * 8;
      uint32_t b[kSteps][2];
      Rows::k_frags(k_tile, t_base + quad, c, b);
      float sc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        // the smallest piece first
#pragma unroll
        for (int p = kQPieces - 1; p >= 0; --p) {
          const uint32_t a[4] = {qa[s][p][0], 0u, qa[s][p][1], 0u};
          gofr::mma_bf16(sc, a, b[s][0], b[s][1]);
        }
      }
      if (quad < group) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int t = t_base + 2 * c + e;
          float x = sc[e] * scale;
          if constexpr (Rows::kScaled) x *= __bfloat162float(ks_tile[t]);
          p_s[quad][t] = (t0 + t < t_end) ? x : gofr::kNegInf;
        }
      }
    }
    if constexpr (Rows::kScaled) {
      if (tid < kTile) vs_s[tid] = t0 + tid < t_end ? __bfloat162float(scales_s[st][1][tid]) : 0.f;
    }
    __syncthreads();

    for (int g = warp; g < group; g += kWarps) {
      if constexpr (Rows::kScaled)
        gofr::fold_row64_vscale(p_s[g], vs_s, &m_s[g], &l_s[g], &alpha_s[g]);
      else
        gofr::fold_row64(p_s[g], &m_s[g], &l_s[g], &alpha_s[g]);
    }
    __syncthreads();

    if constexpr (Rows::kMmaPV) {
      // P.V on the tensor cores: this warp's kWarpCols columns over the
      // whole tile; p (bf16 values after fold_row64) as A fragments, V's
      // [t, d] rows as B fragments by ldmatrix.trans, 16 positions a step
      if (quad < group) {
        const float alpha = alpha_s[quad];
#pragma unroll
        for (int j = 0; j < kWarpCols / 8; ++j) pv[j][0] *= alpha, pv[j][1] *= alpha;
      }
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        uint32_t a[4] = {0u, 0u, 0u, 0u};
        if (quad < group) {
          const float2 lo = *reinterpret_cast<const float2*>(&p_s[quad][kk * 16 + 2 * c]);
          const float2 hi = *reinterpret_cast<const float2*>(&p_s[quad][kk * 16 + 2 * c + 8]);
          a[0] = bf16_pair(lo.x, lo.y);
          a[2] = bf16_pair(hi.x, hi.y);
        }
        // matrices: positions +0..7 / +8..15 (mat & 1) by columns +0..7 /
        // +8..15 (mat >> 1) of each 16-column pair
#pragma unroll
        for (int pair = 0; pair < kWarpCols / 16; ++pair) {
          uint32_t vf[4];
          gofr::ldmatrix_x4_trans(
              vf, v_tile + Rows::offset(kk * 16 + (mat & 1) * 8 + mrow,
                                        (warp * kWarpCols + pair * 16 + (mat >> 1) * 8) * 2));
          gofr::mma_bf16(pv[2 * pair], a, vf[0], vf[1]);
          gofr::mma_bf16(pv[2 * pair + 1], a, vf[2], vf[3]);
        }
      }
    } else {
      // P.V in f32: this thread's columns of its positions, every query row
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g)
        if (g < group)
#pragma unroll
          for (int j = 0; j < Rows::kCols; ++j) acc[g][j] *= alpha_s[g];
#pragma unroll 4
      for (int r = 0; r < kWarpRows / kRowsPerStep; ++r) {
        const int t = warp * kWarpRows + r * kRowsPerStep + vr;
        float v[Rows::kCols];
        Rows::values(*reinterpret_cast<const Word*>(v_tile + Rows::offset(t, vj)), v);
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g) {
          if (g < group) {
            const float p = p_s[g][t];
#pragma unroll
            for (int j = 0; j < Rows::kCols; ++j) acc[g][j] = fmaf(p, v[j], acc[g][j]);
          }
        }
      }
    }
    __syncthreads();  // every thread is done with this stage before it is refilled
  }
  gofr::cp_async_wait<0>();
  __syncthreads();  // the ring is free; m_s / l_s are final

  if constexpr (Rows::kMmaPV) {
    if (quad < group) {
      const size_t row = (size_t)n * hq + h * group + quad;
#pragma unroll
      for (int j = 0; j < kWarpCols / 8; ++j) {
        const int col = warp * kWarpCols + j * 8 + 2 * c;
        if (gridDim.z == 1) {
          *reinterpret_cast<__nv_bfloat162*>(out + row * kD + col) = __floats2bfloat162_rn(
              gofr::row_finish(pv[j][0], l_s[quad]), gofr::row_finish(pv[j][1], l_s[quad]));
        } else {
          float* st = part + (row * gridDim.z + split) * kState;
          *reinterpret_cast<float2*>(st + col) = make_float2(pv[j][0], pv[j][1]);
          if (warp == 0 && c == 0 && j == 0) st[kD] = m_s[quad], st[kD + 1] = l_s[quad];
        }
      }
    }
  } else {
    // add the partial sums of the half-warps (int4) and of the warps
    float* sums = reinterpret_cast<float*>(ring_smem);  // [kWarps][kMaxGroup][kD]
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      if (g < group) {
#pragma unroll
        for (int j = 0; j < Rows::kCols; ++j) {
          float a = acc[g][j];
          // int4: lanes 16 apart hold the same columns of neighbouring rows
          for (int o = 16; o >= kLanesPerRow; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
          if (vr == 0) sums[(warp * kMaxGroup + g) * kD + Rows::col(vj, j)] = a;
        }
      }
    }
    __syncthreads();
    // one output column a thread: at head dim 64 threads 64..127 have none
    // (their column would be the next query row's)
    if (tid < kD) {
      for (int g = 0; g < group; ++g) {
        float o = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) o += sums[(w * kMaxGroup + g) * kD + tid];
        if (gridDim.z == 1) {
          gofr::store_out(out + ((size_t)n * hq + h * group + g) * kD + tid,
                          gofr::row_finish(o, l_s[g]));
        } else {
          float* st = part + (((size_t)n * hq + h * group + g) * gridDim.z + split) * kState;
          st[tid] = o;
          if (tid == 0) st[kD] = m_s[g], st[kD + 1] = l_s[g];
        }
      }
    }
  }
}

template <class Rows, class TQ = bf16>
int launch(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
           const void* v_scale, const void* table, const void* lengths, void* out, void* scratch,
           int n, int hkv, int group, int pool, int page, int maxp, int split_rows, int splits,
           float scale, void* stream) {
  // K and V rows: 65,536 (bf16, D 128), 32,768 (bf16, D 64), 36,864 (int8,
  // D 128), 16,384 (int8, D 64; int4, D 128), 8,192 B (int4, D 64)
  constexpr int kRingBytes = kStages * 2 * kTile * Rows::kStride;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<Rows, TQ>, cudaFuncAttributeMaxDynamicSharedMemorySize, kRingBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const PoolLength pool_len{maxp, page};
  const bool aligned = (reinterpret_cast<uintptr_t>(k_scale) | reinterpret_cast<uintptr_t>(v_scale)) % 16 == 0;
  paged_decode_kernel<Rows, TQ><<<dim3(n, hkv, splits), kThreads, kRingBytes, s>>>(
      static_cast<const TQ*>(q), static_cast<const uint8_t*>(k_pool),
      static_cast<const uint8_t*>(v_pool), static_cast<const bf16*>(k_scale),
      static_cast<const bf16*>(v_scale), static_cast<const int*>(table),
      static_cast<const int*>(lengths), pool_len, static_cast<TQ*>(out),
      static_cast<float*>(scratch), hkv, group, pool, page, split_rows,
      page % 8 == 0 && aligned, scale);
  if (splits > 1) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    gofr::merge_splits<Rows::kD><<<dim3(n, hkv * group), Rows::kD, 0, s>>>(
        static_cast<const float*>(scratch), pool_len, static_cast<const int*>(lengths),
        static_cast<TQ*>(out), split_rows, splits);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each entry point runs `splits` runs of `split_rows` positions (splits x
// split_rows >= maxp x page), then the merge when splits > 1; `scratch`
// holds n x Hq x splits x (D + 2) floats.

// Kernel A: the bf16 pool has no scale planes. One entry point a head dim:
// 128 (Llama-3-8B) and 64 (Llama one_b). (A's f32 build is paged_decode.cu's.)
extern "C" int gofr_paged_decode(const void* q, const void* k_pool, const void* v_pool,
                                 const void* table, const void* lengths, void* out, void* scratch,
                                 int n, int hkv, int group, int pool, int page, int maxp,
                                 int split_rows, int splits, float scale, void* stream) {
  return launch<Bf16Rows<128>>(q, k_pool, v_pool, nullptr, nullptr, table, lengths, out, scratch,
                               n, hkv, group, pool, page, maxp, split_rows, splits, scale, stream);
}

extern "C" int gofr_paged_decode_d64(const void* q, const void* k_pool, const void* v_pool,
                                     const void* table, const void* lengths, void* out,
                                     void* scratch, int n, int hkv, int group, int pool, int page,
                                     int maxp, int split_rows, int splits, float scale,
                                     void* stream) {
  return launch<Bf16Rows<64>>(q, k_pool, v_pool, nullptr, nullptr, table, lengths, out, scratch,
                              n, hkv, group, pool, page, maxp, split_rows, splits, scale, stream);
}

// Kernels D (int8) and E (int4), one entry point a head dim: 128
// (Llama-3-8B) and 64 (Llama one_b).
extern "C" int gofr_paged_decode_q(const void* q, const void* k_pool, const void* v_pool,
                                   const void* k_scale, const void* v_scale, const void* table,
                                   const void* lengths, void* out, void* scratch, int n, int hkv,
                                   int group, int pool, int page, int maxp, int split_rows,
                                   int splits, float scale, void* stream) {
  return launch<Int8Rows<128>>(q, k_pool, v_pool, k_scale, v_scale, table, lengths, out, scratch, n,
                               hkv, group, pool, page, maxp, split_rows, splits, scale, stream);
}

extern "C" int gofr_paged_decode_q_d64(const void* q, const void* k_pool, const void* v_pool,
                                       const void* k_scale, const void* v_scale, const void* table,
                                       const void* lengths, void* out, void* scratch, int n,
                                       int hkv, int group, int pool, int page, int maxp,
                                       int split_rows, int splits, float scale, void* stream) {
  return launch<Int8Rows<64>>(q, k_pool, v_pool, k_scale, v_scale, table, lengths, out, scratch, n,
                              hkv, group, pool, page, maxp, split_rows, splits, scale, stream);
}

// Kernel D under an f32 model: an f32 q (split into three bf16 pieces)
// against the int8 pool, f32 out; head dims 128 and 64.
extern "C" int gofr_paged_decode_q_f32(const void* q, const void* k_pool, const void* v_pool,
                                       const void* k_scale, const void* v_scale, const void* table,
                                       const void* lengths, void* out, void* scratch, int n,
                                       int hkv, int group, int pool, int page, int maxp,
                                       int split_rows, int splits, float scale, void* stream) {
  return launch<Int8Rows<128>, float>(q, k_pool, v_pool, k_scale, v_scale, table, lengths, out,
                                      scratch, n, hkv, group, pool, page, maxp, split_rows, splits,
                                      scale, stream);
}

extern "C" int gofr_paged_decode_q_d64_f32(const void* q, const void* k_pool, const void* v_pool,
                                           const void* k_scale, const void* v_scale,
                                           const void* table, const void* lengths, void* out,
                                           void* scratch, int n, int hkv, int group, int pool,
                                           int page, int maxp, int split_rows, int splits,
                                           float scale, void* stream) {
  return launch<Int8Rows<64>, float>(q, k_pool, v_pool, k_scale, v_scale, table, lengths, out,
                                     scratch, n, hkv, group, pool, page, maxp, split_rows, splits,
                                     scale, stream);
}

// Kernel E under an f32 model: an f32 q (split into three bf16 pieces)
// against the packed int4 pool, f32 out; head dims 128 and 64.
extern "C" int gofr_paged_decode_q4_f32(const void* q, const void* k_pool, const void* v_pool,
                                        const void* k_scale, const void* v_scale,
                                        const void* table, const void* lengths, void* out,
                                        void* scratch, int n, int hkv, int group, int pool,
                                        int page, int maxp, int split_rows, int splits,
                                        float scale, void* stream) {
  return launch<Int4Rows<128>, float>(q, k_pool, v_pool, k_scale, v_scale, table, lengths, out,
                                      scratch, n, hkv, group, pool, page, maxp, split_rows, splits,
                                      scale, stream);
}

extern "C" int gofr_paged_decode_q4_d64_f32(const void* q, const void* k_pool, const void* v_pool,
                                            const void* k_scale, const void* v_scale,
                                            const void* table, const void* lengths, void* out,
                                            void* scratch, int n, int hkv, int group, int pool,
                                            int page, int maxp, int split_rows, int splits,
                                            float scale, void* stream) {
  return launch<Int4Rows<64>, float>(q, k_pool, v_pool, k_scale, v_scale, table, lengths, out,
                                     scratch, n, hkv, group, pool, page, maxp, split_rows, splits,
                                     scale, stream);
}

extern "C" int gofr_paged_decode_q4(const void* q, const void* k_pool, const void* v_pool,
                                    const void* k_scale, const void* v_scale, const void* table,
                                    const void* lengths, void* out, void* scratch, int n, int hkv,
                                    int group, int pool, int page, int maxp, int split_rows,
                                    int splits, float scale, void* stream) {
  return launch<Int4Rows<128>>(q, k_pool, v_pool, k_scale, v_scale, table, lengths, out, scratch, n,
                               hkv, group, pool, page, maxp, split_rows, splits, scale, stream);
}

extern "C" int gofr_paged_decode_q4_d64(const void* q, const void* k_pool, const void* v_pool,
                                        const void* k_scale, const void* v_scale,
                                        const void* table, const void* lengths, void* out,
                                        void* scratch, int n, int hkv, int group, int pool,
                                        int page, int maxp, int split_rows, int splits,
                                        float scale, void* stream) {
  return launch<Int4Rows<64>>(q, k_pool, v_pool, k_scale, v_scale, table, lengths, out, scratch, n,
                              hkv, group, pool, page, maxp, split_rows, splits, scale, stream);
}
