// The W8A16 linear: y = bf16(bf16(x @ q^T) * bf16(s)), x bf16 [M, K], q int8
// [N, K] (K contiguous per output channel), s f32 [N], y bf16 [M, N]; and its
// f32-activation build (an f32 model with int8 weights): y = (x @ q^T) * s,
// x and y f32, one f32 sum and one f32 multiply, no bf16 rounding.
//
// Port-only: the JAX package computes ops/quant.py qdot (:61) on a QTensor as
// XLA, which fuses the int8 -> x.dtype convert into the operand read. Its
// bf16 value is two roundings, as the plain version (ops.quant.qdot_plain)
// takes them: the f32 sum rounded to bf16, then multiplied by the bf16 scale
// and rounded again; in f32 neither rounds. The int8 converts to bf16
// exactly (|q| <= 127), in registers; no bf16 copy of a weight ever reaches
// device memory.
//
// What bounds it on an H100: at decode (M = 8 slots) and verify (M = 40) the
// weight's bytes. A Llama-3-8B decode step reads 7.50 GB of int8 weights over
// its 225 products, 2.24 ms at 3.35 TB/s, against 2 * 8 operations a weight
// byte, far below the ~295 where the tensor cores become the limit. At
// prefill (M = 2048 .. 4096 rows) the operations: 2 M N K at 989 TFLOP/s
// (the f32 build does three bf16 products for each: 3 x 2 M N K).
//
// Design, two tilings of one source (the launcher, ops/cuda/w8a16.py plan,
// picks by M):
//   - The weight stream (M <= 64), a template over the activation type TX
//     (bf16, or f32). A block of 4 warps owns a band of 64
//     output channels, each warp 16 of them, over one split of K. The
//     product is swapped so that the weight is the mma A operand (16 channel
//     rows) and X the B operand (8 token columns; M is padded to a multiple
//     of 8, not 16). Each thread loads 16 contiguous int8 of each of its two
//     channel rows per 64-k chunk (16-byte loads; a row's 64 bytes come from
//     4 neighbouring threads), and the k order inside a chunk is permuted so
//     that exactly those bytes form its A fragments of the chunk's four
//     m16n8k16 steps: thread c's bytes 4t..4t+3 are logical columns 2c, 2c+1,
//     2c+8, 2c+9 of step t. X is staged in shared memory in its own type
//     (rows padded by 16 bytes) and read in the same permuted order, 16
//     consecutive elements a thread, so the sum is the same sum. Stages of X
//     cover at most 48 KB, so a block loops over stages when its split is
//     longer (an f32 stage holds half the chunks of a bf16 one; the
//     launcher's plan sizes it by the element). A thread issues the loads of
//     4 chunks together (8 16-byte loads in flight).
//     Too few bands fill the card at small N, so K is split: each split
//     writes its f32 sums to a scratch the launcher allocates, and a second
//     kernel from the same entry point adds the splits in order and takes the
//     two roundings (f32: the one multiply). Without a split the stream
//     finishes itself; the scale and the roundings come only after the whole
//     K sum either way.
//     Blocks at the decode shapes (plan(8, N, K)): wq and wo (4096, 4096): 64
//     bands x 5 splits = 320; wk and wv (1024, 4096): 16 x 16 = 256; gate
//     and up (14336, 4096): 224 x 2 = 448; down (4096, 14336): 64 x 5 = 320;
//     the head (128256, 4096): 2004 x 1.
//   - The bf16 tiles (M > 64, and 17..64 rows of a weight whose channel
//     tiles alone fill the card): wgmma fed by TMA (hopper.cuh). The
//     mma.sync tiles that came first (below, now the f32 build's) reached a
//     third of cuBLAS's rate on the bf16 weight at prefill (117.8 ms of
//     device time for a Llama-3-8B forward's 225 products at M = 2048,
//     against 38.36): mma.sync cannot reach the tensor cores' Hopper rate,
//     each of their 8 warps re-read the block's whole X tile by ldmatrix for
//     its 16 channels (about 2 bytes of shared memory a multiply-add, so
//     shared-memory bandwidth set the pace), and every thread issued
//     cp.async loads, none left to run ahead. Now a block of 384 threads
//     owns 128 output channels x BN tokens (BN = 256, 128 or 64 from the
//     plan, which fills the card's 132 SMs from (m, n, k) alone): its third
//     warpgroup is a producer whose one thread keeps TMA loads of 64 k of
//     X (BN rows of bf16, 128-byte swizzle) and of Q (128 rows of int8,
//     64-byte swizzle) in flight through a ring of 5 to 16 stages on
//     mbarriers, and its two
//     consumer warpgroups each own 64 channels. The product keeps the
//     stream's swap: the weight is wgmma's A operand from registers, each
//     thread loading its two channel rows' k pairs of a k16 step from the Q
//     stage by four 4-byte shared loads (the 64-byte swizzle puts the eight
//     rows a load instruction meets on distinct banks, where unswizzled 64-
//     byte rows met four to a bank) and converting them with int8x4_to_bf16
//     once for all BN tokens; X is the B operand straight from the TMA
//     stage, K-major, the tokens being wgmma's N. So X crosses shared memory
//     once a warpgroup, at the tensor cores' own operand rate, and each
//     weight byte is converted once a block. A warpgroup issues its k16
//     steps in groups of products and converts the next group's fragments
//     while a group runs: a stage's four steps a group at BN = 64 and 128,
//     where one step at a time left the tensor cores waiting on the
//     conversion (wk and wv, BN = 128, took 1.08x as long at M = 2048, a
//     verify forward's products forced onto BN = 64 1.27x; PERF.md), and
//     one step a group at BN = 256 (group_steps), where the accumulators
//     take 128 registers and four steps' fragments twice over spilled, which
//     made ptxas serialise the products (a forward's products 1.40x as
//     long). ptxas allots 168 registers a thread under the launch bound of
//     384 threads, whatever setmaxnreg moves at run time (232 a consumer
//     thread, 40 the producer's). The other form, X as A from shared memory
//     and Q converted into a bf16 shared tile as B, would write and fence a
//     converted copy of every Q stage; the swapped form converts in
//     registers. The epilogue takes the two roundings (scaled), stages the
//     bf16 outputs through the drained ring as rows of 128 channels (rows
//     padded to 272 bytes, conflict-free), and writes each row of y with
//     16-byte stores. Blocks walk M fastest, so the blocks of one channel
//     tile run together and each weight tile is read from device memory
//     once. What bounds the tiles now: at M = 2048 the operations, at
//     1.1-1.6x cuBLAS's time on the bf16 weight (PERF.md; wk and wv, 64
//     blocks on 132 SMs, the furthest); each block fills
//     its ring anew and drains it into its epilogue, where a persistent
//     block would overlap both. At 17..64 rows the weight's bytes: there the
//     tiles read a weight of at least 99 channel tiles faster than the
//     stream, whose M / 8 token tiles a warp grow with the rows.
//   - f32 X (TX float) keeps the first design of both tilings: the stream
//     above and the mma.sync tiles (a block of 8 warps computes 128 rows x
//     128 channels from tiles of 64 k of X and Q through a three-stage
//     cp.async ring; each warp owns all 128 rows and 16 channels, B fragments
//     of Q as two 16-bit shared loads converted to bf16 pairs, A fragments
//     of X as staged rows of 64 + 8 floats). It takes X's full precision to
//     the bf16 tensor cores as kernels D and E take an f32 q: each pair of
//     X elements is split as it is read from shared memory into three bf16
//     pieces h, m and l (mma.cuh split_pair), which hold all 24 of its
//     significand bits, and each step runs three mma.sync (l, m, then h)
//     against the same converted weight fragments. A weight code is exact in
//     bf16, so each piece's product is exact in f32 and the sum is the f32
//     product up to the order of the f32 sums; the split-K partials and
//     their sum stay f32, and the f32 sum is multiplied by the f32 scale
//     once (JAX's out * s.astype(x.dtype) in f32). The three products of a
//     k16 step go into a fresh fragment, which is added to the running sum
//     by f32 adds: the tensor cores' own accumulation rounds less exactly
//     than an f32 add, and summed there across all of K = 14336 it read
//     3.6e-5 of the output's RMS off cuBLAS's f32 product at M = 2048 (the
//     down projection in chip_smoke.py's phase 3, H100 80GB HBM3, 700 W),
//     past the 2e-5 the f32 builds are held to. The stream reads 16 f32
//     a thread (four 16-byte loads) and splits them into the three pieces'
//     B fragments. The tiles stage f32 rows of 64 + 8 floats (288 bytes: a
//     quarter-warp's 8-byte A-fragment loads fall on distinct banks) and
//     load each A fragment as four float2 instead of one ldmatrix; the ring
//     keeps its three stages (141 KB of dynamic shared memory). Within
//     1.05x of cuBLAS in f32 at M = 2048, it stays as it is.
//     scripts/torch_kernel_variants.py adds back their bf16 form (ldmatrix
//     A fragments, rows of 144 bytes) to time those tiles beside the wgmma
//     tiles.
// Rows past M or N and k past K are zero-filled on load and never stored;
// K must be a multiple of 16 and x and q 16-byte aligned (the launcher
// checks both: TMA and the 16-byte copies need them). The next steps: a
// persistent walk over the tiles, and a persistent stream that hides each
// band's first loads.
#include <cstdint>
#include <type_traits>

#include <cuda.h>
#include <cuda_bf16.h>

#include "async_copy.cuh"
#include "hopper.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using gofr::cp_async16;
using gofr::cp_async_commit;
using gofr::cp_async_wait;
using gofr::mma_bf16;
using gofr::split_pair;

constexpr int kChunk = 64;          // k a stream warp takes per step
constexpr int kBand = 64;           // output channels per stream block
constexpr int kStreamThreads = 128;
constexpr int kAhead = 4;           // chunks whose loads a stream warp issues together
constexpr int kPadBytes = 16;       // padding per staged X row of the stream

// the mma.sync tiles (the f32 build's)
constexpr int kBM = 128, kBN = 128, kBK = 64, kStages = 3, kTileThreads = 256;
constexpr int kWM = 128, kWN = 16;  // a warp's rows and channels of the block tile
constexpr int kMT = kWM / 16, kNT = kWN / 8;
constexpr int kXRow = kBK + 8;      // elements per staged X row of a tile (288 bytes)
constexpr int kQRow = kBK + 16;     // bytes per staged Q row of a tile (80 bytes)
constexpr int kXStage = kBM * kXRow;
constexpr int kQStage = kBN * kQRow;

template <class TX>
constexpr int tile_smem() {
  return kStages * (kXStage * static_cast<int>(sizeof(TX)) + kQStage);
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Four int8 (byte i of w is element i) as two bf16 pairs: lo = (e0, e1), hi
// = (e2, e3). Each byte, biased to q + 128, becomes the low mantissa byte of
// 2^23 in f32, so one subtraction gives q exactly, and bf16 holds it exactly.
__device__ __forceinline__ void int8x4_to_bf16(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.f;
  lo = bf16_pair(f0, f1);
  hi = bf16_pair(f2, f3);
}

// The plain version's two roundings: bf16(bf16(acc) * bf16(s)); in f32 the
// one multiply acc * s.
__device__ __forceinline__ bf16 scaled(float acc, float s, bf16*) {
  return __float2bfloat16(__bfloat162float(__float2bfloat16(acc)) *
                          __bfloat162float(__float2bfloat16(s)));
}
__device__ __forceinline__ float scaled(float acc, float s, float*) { return acc * s; }

template <class TX>
__device__ __forceinline__ TX scaled(float acc, float s) {
  return scaled(acc, s, static_cast<TX*>(nullptr));
}

// acc += part in f32 adds: an f32 x's three pieces are summed on the tensor
// cores into a fresh fragment a k16 step (`part`), then added here, so no
// tensor-core sum runs longer than three products.
__device__ __forceinline__ void add_to(float (&acc)[4], const float (&part)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += part[e];
}

// X's B fragments for the stream: the 16 consecutive elements of a staged
// row a thread reads for one chunk, as bf16 pairs, xw[p][2t], xw[p][2t + 1]
// of piece p for step t: bf16 X as it is (one piece), f32 X as its pieces
// h, m, l (split_pair).
template <class TX>
struct StreamX {
  static constexpr int kPieces = 1;
  __device__ static void load(const bf16* xr, uint32_t (&xw)[kPieces][8]) {
    const uint4 xa = *reinterpret_cast<const uint4*>(xr);
    const uint4 xb = *reinterpret_cast<const uint4*>(xr + 8);
    const uint32_t w[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) xw[0][j] = w[j];
  }
};

template <>
struct StreamX<float> {
  static constexpr int kPieces = 3;
  __device__ static void load(const float* xr, uint32_t (&xw)[kPieces][8]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 v = reinterpret_cast<const float4*>(xr)[j];
      split_pair(make_float2(v.x, v.y), xw[0][2 * j], xw[1][2 * j], xw[2][2 * j]);
      split_pair(make_float2(v.z, v.w), xw[0][2 * j + 1], xw[1][2 * j + 1], xw[2][2 * j + 1]);
    }
  }
};

// X's A fragments of one m16 row tile of the mma.sync tiles (rows `row` ..
// row + 15, k step kk of the staged tile): f32 X as four float2 per thread
// split into its pieces h, m, l.
template <class TX>
struct TileX;

template <>
struct TileX<float> {
  static constexpr int kPieces = 3;
  __device__ static void frags(const float* xt, int row, int kk, int lane, uint32_t (&a)[kPieces][4]) {
    // a[0]: (quad, 2c..), a[1]: (quad + 8, 2c..), a[2]: (quad, 2c + 8..), a[3]: (quad + 8, 2c + 8..)
    const float* r = xt + (row + lane / 4) * kXRow + kk * 16 + 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = *reinterpret_cast<const float2*>(r + (i & 1) * 8 * kXRow + (i >> 1) * 8);
      split_pair(v, a[0][i], a[1][i], a[2][i]);
    }
  }
};

// The weight stream: MT token tiles of 8 rows (M <= 8 MT). Grid (bands,
// splits); split z sums chunks [z * per_split, (z + 1) * per_split).
template <int MT, class TX>
__global__ void __launch_bounds__(kStreamThreads)
    stream_kernel(const TX* __restrict__ x, const int8_t* __restrict__ q,
                  const float* __restrict__ s, TX* __restrict__ out,
                  float* __restrict__ partial, int m, int n, int k, int per_split,
                  int stage_chunks) {
  constexpr int kPiece = 16 / sizeof(TX);            // elements a 16-byte copy moves
  constexpr int kPieces = StreamX<TX>::kPieces;
  extern __shared__ __align__(16) unsigned char smem[];
  TX* xs = reinterpret_cast<TX*>(smem);
  const int row_len = stage_chunks * kChunk + kPadBytes / static_cast<int>(sizeof(TX));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int quad = lane / 4, c = lane % 4;
  const int chunks = (k + kChunk - 1) / kChunk;
  const int c_begin = blockIdx.y * per_split;
  const int c_end = min(chunks, c_begin + per_split);
  // the thread's two channel rows (fragment rows quad and quad + 8)
  const int r0 = blockIdx.x * kBand + warp * 16 + quad, r1 = r0 + 8;
  const bool v0 = r0 < n, v1 = r1 < n;
  const int8_t* q0 = q + static_cast<size_t>(v0 ? r0 : 0) * k;
  const int8_t* q1 = q + static_cast<size_t>(v1 ? r1 : 0) * k;

  float acc[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0.f;

  for (int s0 = c_begin; s0 < c_end; s0 += stage_chunks) {
    const int s_end = min(c_end, s0 + stage_chunks);
    const int pieces = (s_end - s0) * kChunk / kPiece;  // 16-byte pieces of a staged row
    __syncthreads();  // every warp is done with the previous stage
    for (int i = threadIdx.x; i < 8 * MT * pieces; i += kStreamThreads) {
      const int row = i / pieces, p = i % pieces;
      const int kk = s0 * kChunk + p * kPiece;
      const bool valid = row < m && kk < k;
      cp_async16(xs + row * row_len + p * kPiece, valid ? x + static_cast<size_t>(row) * k + kk : x,
                 valid);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    for (int g = s0; g < s_end; g += kAhead) {
      uint4 w0[kAhead], w1[kAhead];
#pragma unroll
      for (int a = 0; a < kAhead; ++a) {
        const int kb = (g + a) * kChunk + c * 16;
        // a dead lane's address stays at its row's start, so no load the
        // compiler might issue early can leave the weight
        const int at = g + a < s_end && kb < k ? kb : -1;
        w0[a] = at >= 0 && v0 ? __ldg(reinterpret_cast<const uint4*>(q0 + max(at, 0)))
                              : make_uint4(0, 0, 0, 0);
        w1[a] = at >= 0 && v1 ? __ldg(reinterpret_cast<const uint4*>(q1 + max(at, 0)))
                              : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int a = 0; a < kAhead; ++a) {
        if (g + a >= s_end) break;
        // A fragments of the chunk's four steps: step t takes byte word t
        uint32_t frag[4][4];
        const uint32_t words0[4] = {w0[a].x, w0[a].y, w0[a].z, w0[a].w};
        const uint32_t words1[4] = {w1[a].x, w1[a].y, w1[a].z, w1[a].w};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          int8x4_to_bf16(words0[t], frag[t][0], frag[t][2]);
          int8x4_to_bf16(words1[t], frag[t][1], frag[t][3]);
        }
        const int xo = (g + a - s0) * kChunk + c * 16;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t xw[kPieces][8];
          StreamX<TX>::load(xs + (mt * 8 + quad) * row_len + xo, xw);
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            float part[4] = {0.f, 0.f, 0.f, 0.f};
            float (&sum)[4] = kPieces == 1 ? acc[mt] : part;
#pragma unroll
            for (int p = kPieces - 1; p >= 0; --p)  // the smallest piece first
              mma_bf16(sum, frag[t], xw[p][2 * t], xw[p][2 * t + 1]);
            if constexpr (kPieces > 1) add_to(acc[mt], part);
          }
        }
      }
    }
  }

  // acc[mt]: (channel r0, tokens 2c, 2c + 1), then (channel r1, the same)
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = i < 2 ? r0 : r1;
      const int tok = mt * 8 + 2 * c + (i & 1);
      if (r >= n || tok >= m) continue;
      if (partial != nullptr) {
        partial[(static_cast<size_t>(blockIdx.y) * m + tok) * n + r] = acc[mt][i];
      } else {
        out[static_cast<size_t>(tok) * n + r] = scaled<TX>(acc[mt][i], s[r]);
      }
    }
  }
}

// The splits' f32 sums added in split order, then the two roundings (f32:
// the multiply).
template <class TX>
__global__ void finish_kernel(const float* __restrict__ partial, const float* __restrict__ s,
                              TX* __restrict__ out, int m, int n, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m * n) return;
  float acc = 0.f;
  for (int z = 0; z < splits; ++z) acc += partial[static_cast<size_t>(z) * m * n + i];
  out[i] = scaled<TX>(acc, s[i % n]);
}

// Two neighbouring outputs of a row, as one pair store where the row's
// length is even.
__device__ __forceinline__ void store_pair(float* o, float y0, float y1) {
  *reinterpret_cast<float2*>(o) = make_float2(y0, y1);
}

// The mma.sync tiles (f32 x): grid (N / 128, M / 128), 8 warps of kWM rows x kWN
// channels.
template <class TX>
__global__ void __launch_bounds__(kTileThreads)
    tile_kernel(const TX* __restrict__ x, const int8_t* __restrict__ q,
                const float* __restrict__ s, TX* __restrict__ out, int m, int n, int k) {
  constexpr int kPiece = 16 / sizeof(TX);  // elements a 16-byte copy moves
  constexpr int kPieces = TileX<TX>::kPieces;
  extern __shared__ __align__(16) unsigned char smem[];
  TX* xs = reinterpret_cast<TX*>(smem);
  int8_t* qs = reinterpret_cast<int8_t*>(smem + kStages * kXStage * sizeof(TX));
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int quad = lane / 4, c = lane % 4;
  const int wm = warp % (kBM / kWM), wn = warp / (kBM / kWM);
  const int tiles = (k + kBK - 1) / kBK;

  auto load = [&](int tile, int stage) {
    const int k0 = tile * kBK;
    for (int i = threadIdx.x; i < kBM * (kBK / kPiece); i += kTileThreads) {
      const int row = i / (kBK / kPiece), p = i % (kBK / kPiece);
      const int gm = m0 + row, gk = k0 + p * kPiece;
      const bool ok = gm < m && gk < k;
      cp_async16(xs + stage * kXStage + row * kXRow + p * kPiece,
                 ok ? x + static_cast<size_t>(gm) * k + gk : x, ok);
    }
    for (int i = threadIdx.x; i < kBN * (kBK / 16); i += kTileThreads) {
      const int row = i / (kBK / 16), p = i % (kBK / 16);
      const int gn = n0 + row, gk = k0 + p * 16;
      const bool ok = gn < n && gk < k;
      cp_async16(qs + stage * kQStage + row * kQRow + p * 16,
                 ok ? q + static_cast<size_t>(gn) * k + gk : q, ok);
    }
  };

  float acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < tiles) load(st, st);
    cp_async_commit();
  }
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile t landed; every warp is done with tile t - 1's stage
    if (t + kStages - 1 < tiles) load(t + kStages - 1, (t + kStages - 1) % kStages);
    cp_async_commit();
    const TX* xt = xs + (t % kStages) * kXStage;
    const int8_t* qt = qs + (t % kStages) * kQStage;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t b[kNT][2];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int8_t* qr = qt + (wn * kWN + nt * 8 + quad) * kQRow + kk * 16 + 2 * c;
        const uint32_t lo = *reinterpret_cast<const uint16_t*>(qr);
        const uint32_t hi = *reinterpret_cast<const uint16_t*>(qr + 8);
        int8x4_to_bf16(lo | (hi << 16), b[nt][0], b[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        uint32_t a[kPieces][4];
        TileX<TX>::frags(xt, wm * kWM + mt * 16, kk, lane, a);
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          float part[4] = {0.f, 0.f, 0.f, 0.f};
          float (&sum)[4] = kPieces == 1 ? acc[mt][nt] : part;
#pragma unroll
          for (int p = kPieces - 1; p >= 0; --p)  // the smallest piece first
            mma_bf16(sum, a[p], b[nt][0], b[nt][1]);
          if constexpr (kPieces > 1) add_to(acc[mt][nt], part);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int gn = n0 + wn * kWN + nt * 8 + 2 * c;
      if (gn >= n) continue;
      const float s0 = s[gn], s1 = gn + 1 < n ? s[gn + 1] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gm = m0 + wm * kWM + mt * 16 + quad + 8 * h;
        if (gm >= m) continue;
        TX* o = out + static_cast<size_t>(gm) * n + gn;
        const TX y0 = scaled<TX>(acc[mt][nt][2 * h], s0);
        if (gn + 1 < n && n % 2 == 0) {
          store_pair(o, y0, scaled<TX>(acc[mt][nt][2 * h + 1], s1));
        } else {
          o[0] = y0;
          if (gn + 1 < n) o[1] = scaled<TX>(acc[mt][nt][2 * h + 1], s1);
        }
      }
    }
  }
}

// The bf16 tiles on wgmma: a block of two consumer warpgroups (64 channels
// each) and a producer warpgroup, 128 channels x BN tokens, 64 k a stage.
constexpr int kGK = 64;                  // k of a stage: 128 bytes of an X row, 64 of a Q row
constexpr int kGChannels = 128;          // output channels a block
constexpr int kGConsumers = 256;         // the two consumer warpgroups' threads
constexpr int kGThreads = kGConsumers + 128;  // and the producer's warpgroup
constexpr int kGRingBytes = 200 * 1024;  // the ring's budget of shared memory
constexpr int kGMaxStages = 16;
constexpr int kGOutRow = kGChannels * 2 + 16;  // bytes of a staged output row

template <int BN>
struct GTile {
  static constexpr int kXBytes = BN * kGK * 2;
  static constexpr int kQBytes = kGChannels * kGK;
  static constexpr int kStageBytes = kXBytes + kQBytes;
  static constexpr int kStages =
      kGRingBytes / kStageBytes < kGMaxStages ? kGRingBytes / kStageBytes : kGMaxStages;
  // 1024 bytes to align the ring (the 128-byte swizzle's period), then the
  // stages, then a full and an empty barrier a stage
  static constexpr int kSmem = 1024 + kStages * kStageBytes + 2 * kStages * 8;
  static_assert(kStages >= 4, "a ring of at least four stages");
  static_assert(kSmem <= 232448, "the ring fits in the 227 KB a block can use");
  static_assert(kXBytes % 1024 == 0 && kStageBytes % 1024 == 0,
                "swizzled boxes start 1024-aligned");
  static_assert(BN * kGOutRow <= kStages * kStageBytes, "the output rows fit in the drained ring");
};

// The A fragments of G consecutive k16 steps t0 .. t0 + G - 1 of a Q stage
// (128 rows of 64 bytes in TMA's 64-byte swizzle: 16-byte chunk j of row r
// at chunk j ^ ((r >> 1) & 3)): the thread's rows r and r + 8 (`row`
// points at row r; both rows share its swizzle `sw`), k 2c, 2c + 1, 2c + 8,
// 2c + 9 of each step. A 4-byte load brings the quad neighbour's pair too;
// a byte permute keeps the thread's own.
template <int G>
__device__ __forceinline__ void q_frags(const unsigned char* row, int sw, int c, int t0,
                                        uint32_t (&a)[G][4]) {
  const uint32_t sel = (c & 1) ? 0x7632u : 0x5410u;
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const int t = t0 + j;
    const int at = ((t ^ sw) << 4) | ((c >> 1) << 2);
    const uint32_t w0 = *reinterpret_cast<const uint32_t*>(row + at);
    const uint32_t w1 = *reinterpret_cast<const uint32_t*>(row + at + 8);
    const uint32_t w2 = *reinterpret_cast<const uint32_t*>(row + 8 * kGK + at);
    const uint32_t w3 = *reinterpret_cast<const uint32_t*>(row + 8 * kGK + at + 8);
    int8x4_to_bf16(__byte_perm(w0, w1, sel), a[j][0], a[j][2]);
    int8x4_to_bf16(__byte_perm(w2, w3, sel), a[j][1], a[j][3]);
  }
}

// k16 steps a consumer issues as one wgmma group, by token width. At BN =
// 256 the accumulators take 128 of the 168 registers ptxas gives a thread
// under the launch bound; two sets of four steps' fragments (32 more)
// spilled there, and ptxas then waited for each product before the next
// (WARPGROUP.DEPBAR 0 after every HGMMA in the SASS). One step a group
// fits and keeps one group in flight while the next is converted.
template <int BN>
__host__ __device__ constexpr int group_steps() {
  return BN >= 256 ? 1 : kGK / 16;
}

// One stage kt of a consumer warpgroup: its kGK / 16 k16 steps in groups
// of G, each group issued as one wgmma group on the half F + p of `f`
// (every offset known at compile time). Once the group before is done
// (the other half free; the previous stage released to the producer when
// the stage's first group runs), the next group's fragments, of this
// stage or the next one's first, are converted into the other half while
// this group runs.
template <int BN, int G, int F>
__device__ __forceinline__ void consume_stage(float (&acc)[BN / 2], uint32_t (&f)[2][G][4],
                                              unsigned char* ring, uint64_t* full, uint64_t* empty,
                                              int kt, int k_steps, int q_off, int sw, int c) {
  using T = GTile<BN>;
  constexpr int kPer = kGK / 16 / G;  // groups a stage
  unsigned char* stage = ring + kt % T::kStages * T::kStageBytes;
  const uint32_t x_at = gofr::smem_addr(stage);
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    gofr::wgmma_fence();
#pragma unroll
    for (int j = 0; j < G; ++j) {
      gofr::Wgmma<BN>::mma(acc, f[(F + p) & 1][j], gofr::sw128_desc(x_at + 32 * (p * G + j)));
    }
    gofr::wgmma_commit();
    gofr::wgmma_wait<1>();
    if (p == 0 && kt > 0) gofr::mbar_arrive(&empty[(kt - 1) % T::kStages]);
    if (p + 1 < kPer) {
      q_frags<G>(stage + T::kXBytes + q_off, sw, c, (p + 1) * G, f[(F + p + 1) & 1]);
    } else if (kt + 1 < k_steps) {
      const int nst = (kt + 1) % T::kStages;
      gofr::mbar_wait(&full[nst], ((kt + 1) / T::kStages) & 1);
      q_frags<G>(ring + nst * T::kStageBytes + T::kXBytes + q_off, sw, c, 0, f[(F + p + 1) & 1]);
    }
  }
}

// Grid (M / BN, N / 128): blocks walk M fastest.
template <int BN>
__global__ void __launch_bounds__(kGThreads, 1)
    wgmma_tile_kernel(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap qmap, const float* __restrict__ s,
                      bf16* __restrict__ out, int m, int n, int k) {
  using T = GTile<BN>;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem + ((1024 - (gofr::smem_addr(smem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + T::kStages * T::kStageBytes);
  uint64_t* empty = full + T::kStages;
  const int m0 = blockIdx.x * BN, n0 = blockIdx.y * kGChannels;
  const int k_steps = (k + kGK - 1) / kGK;  // stages the ring passes
  if (threadIdx.x == 0) {
    for (int i = 0; i < T::kStages; ++i) {
      gofr::mbar_init(&full[i], 1);
      gofr::mbar_init(&empty[i], kGConsumers);
    }
    gofr::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kGConsumers) {  // the producer warpgroup: one thread loads
    gofr::setmaxnreg_dec<40>();
    if (threadIdx.x == kGConsumers) {
      for (int kt = 0; kt < k_steps; ++kt) {
        const int st = kt % T::kStages;
        gofr::mbar_wait(&empty[st], ((kt / T::kStages) & 1) ^ 1);
        unsigned char* stage = ring + st * T::kStageBytes;
        gofr::mbar_arrive_expect_tx(&full[st], T::kStageBytes);
        gofr::tma_load_2d(stage, &xmap, kt * kGK, m0, &full[st]);
        gofr::tma_load_2d(stage + T::kXBytes, &qmap, kt * kGK, n0, &full[st]);
      }
    }
  } else {  // two consumer warpgroups of 64 channels
    gofr::setmaxnreg_inc<232>();
    const int lane = threadIdx.x % 32, c = lane % 4;
    // the thread's channel rows of the block tile: row and row + 8
    const int row = (threadIdx.x / 32) * 16 + lane / 4;
    const int sw = (row >> 1) & 3;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    // the fragments of two groups of steps: one in the products, the other
    // being converted; two stages a pass, so that where a stage holds an odd
    // number of groups the next one starts on the other half
    constexpr int G = group_steps<BN>();
    constexpr int kOdd = kGK / 16 / G % 2;
    uint32_t f[2][G][4];
    const int q_off = row * kGK;  // the thread's row within a Q stage
    gofr::mbar_wait(&full[0], 0);
    q_frags<G>(ring + T::kXBytes + q_off, sw, c, 0, f[0]);
    for (int kt = 0; kt < k_steps; kt += 2) {
      consume_stage<BN, G, 0>(acc, f, ring, full, empty, kt, k_steps, q_off, sw, c);
      if (kt + 1 < k_steps) {
        consume_stage<BN, G, kOdd>(acc, f, ring, full, empty, kt + 1, k_steps, q_off, sw, c);
      }
    }
    gofr::wgmma_wait<0>();
    gofr::fence_regs(acc);

    // the epilogue: y = bf16(bf16(acc) * bf16(s)) staged as rows of 128
    // channels in the drained ring, then written 16 bytes a thread
    gofr::fence_proxy_async();
    gofr::named_barrier(1, kGConsumers);  // both warpgroups are done with the ring
    const auto y = [](float v, float sc) { return scaled<bf16>(v, sc); };
    const float s0 = n0 + row < n ? s[n0 + row] : 0.f;
    const float s1 = n0 + row + 8 < n ? s[n0 + row + 8] : 0.f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      bf16* r0 = reinterpret_cast<bf16*>(ring + (8 * j + 2 * c) * kGOutRow) + row;
      bf16* r1 = reinterpret_cast<bf16*>(ring + (8 * j + 2 * c + 1) * kGOutRow) + row;
      r0[0] = y(acc[4 * j], s0);
      r1[0] = y(acc[4 * j + 1], s0);
      r0[8] = y(acc[4 * j + 2], s1);
      r1[8] = y(acc[4 * j + 3], s1);
    }
    gofr::named_barrier(1, kGConsumers);
    constexpr int kParts = kGChannels * 2 / 16;  // 16-byte pieces of a row
    const bool pieces = n % 8 == 0;             // y's rows 16-byte aligned
    for (int i = threadIdx.x; i < BN * kParts; i += kGConsumers) {
      const int tok = i / kParts, part = i % kParts;
      const int gm = m0 + tok, gn = n0 + part * 8;
      if (gm >= m || gn >= n) continue;
      const unsigned char* src = ring + tok * kGOutRow + part * 16;
      bf16* dst = out + static_cast<size_t>(gm) * n + gn;
      if (pieces && gn + 8 <= n) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int e = 0; e < 8 && gn + e < n; ++e) dst[e] = reinterpret_cast<const bf16*>(src)[e];
      }
    }
  }
}

using gofr::EncodeTiled;

// A 2-D map of a row-major [rows, cols] matrix of `elem`-byte elements,
// boxes of box_rows x kGK; parts of a box past the matrix load as zeros.
bool tile_map(EncodeTiled encode, CUtensorMap* map, const void* base, CUtensorMapDataType type,
              int elem, int cols, int rows, int box_rows, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem};
  const cuuint32_t box[2] = {kGK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN>
cudaError_t launch_wgmma_tiles(const CUtensorMap& xmap, const CUtensorMap& qmap, const float* s,
                               bf16* out, int m, int n, int k, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        wgmma_tile_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, GTile<BN>::kSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((m + BN - 1) / BN, (n + kGChannels - 1) / kGChannels);
  wgmma_tile_kernel<BN><<<grid, kGThreads, GTile<BN>::kSmem, stream>>>(xmap, qmap, s, out, m, n, k);
  return cudaGetLastError();
}

// The bf16 tiles at token width `width` (64, 128 or 256): both tensor maps
// encoded on every launch (x's address changes with every call).
cudaError_t wgmma_tiles(const void* x, const void* q, const void* s, void* out, int m, int n, int k,
                        int width, cudaStream_t stream) {
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(q)) % 16 != 0) {
    return cudaErrorMisalignedAddress;
  }
  if (k % 16 != 0) return cudaErrorInvalidValue;
  EncodeTiled encode;
  const cudaError_t err = gofr::tensor_map_encoder(&encode);
  if (err != cudaSuccess) return err;
  CUtensorMap xmap, qmap;
  if (!tile_map(encode, &xmap, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, k, m, width,
                CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tile_map(encode, &qmap, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, k, n, kGChannels,
                CU_TENSOR_MAP_SWIZZLE_64B)) {
    return cudaErrorInvalidValue;
  }
  const auto sp = static_cast<const float*>(s);
  const auto yp = static_cast<bf16*>(out);
  switch (width) {
    case 64: return launch_wgmma_tiles<64>(xmap, qmap, sp, yp, m, n, k, stream);
    case 128: return launch_wgmma_tiles<128>(xmap, qmap, sp, yp, m, n, k, stream);
    case 256: return launch_wgmma_tiles<256>(xmap, qmap, sp, yp, m, n, k, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int MT, class TX>
cudaError_t launch_stream(const void* x, const void* q, const void* s, void* out, void* partial,
                          int m, int n, int k, int splits, int per_split, int stage_chunks,
                          cudaStream_t stream) {
  const dim3 grid((n + kBand - 1) / kBand, splits);
  const size_t smem = static_cast<size_t>(8 * MT) * (stage_chunks * kChunk * sizeof(TX) + kPadBytes);
  stream_kernel<MT, TX><<<grid, kStreamThreads, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const int8_t*>(q), static_cast<const float*>(s),
      static_cast<TX*>(out), splits > 1 ? static_cast<float*>(partial) : nullptr, m, n, k,
      per_split, stage_chunks);
  return cudaGetLastError();
}

// splits 0: the tiles (bf16 x: the wgmma tiles at token width
// `per_split`; f32 x: the mma.sync tiles); else the weight stream over
// `splits` splits of `per_split` chunks, staging at most `stage_chunks`
// chunks of X at once (partial: f32 [splits, M, N] when splits > 1).
// Returns cudaGetLastError().
template <class TX>
int run(const void* x, const void* q, const void* s, void* out, void* partial, int m, int n,
        int k, int splits, int per_split, int stage_chunks, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (splits == 0) {
    if constexpr (std::is_same_v<TX, bf16>) {
      return static_cast<int>(wgmma_tiles(x, q, s, out, m, n, k, per_split, st));
    } else {
      static bool configured = false;
      if (!configured) {
        const cudaError_t err = cudaFuncSetAttribute(
            tile_kernel<TX>, cudaFuncAttributeMaxDynamicSharedMemorySize, tile_smem<TX>());
        if (err != cudaSuccess) return static_cast<int>(err);
        configured = true;
      }
      const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
      tile_kernel<TX><<<grid, kTileThreads, tile_smem<TX>(), st>>>(
          static_cast<const TX*>(x), static_cast<const int8_t*>(q), static_cast<const float*>(s),
          static_cast<TX*>(out), m, n, k);
      return static_cast<int>(cudaGetLastError());
    }
  }
  if (m < 1 || m > 64 || (splits > 1 && partial == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
  switch ((m + 7) / 8) {
    case 1: err = launch_stream<1, TX>(x, q, s, out, partial, m, n, k, splits, per_split, stage_chunks, st); break;
    case 2: err = launch_stream<2, TX>(x, q, s, out, partial, m, n, k, splits, per_split, stage_chunks, st); break;
    case 3: err = launch_stream<3, TX>(x, q, s, out, partial, m, n, k, splits, per_split, stage_chunks, st); break;
    case 4: err = launch_stream<4, TX>(x, q, s, out, partial, m, n, k, splits, per_split, stage_chunks, st); break;
    case 5: err = launch_stream<5, TX>(x, q, s, out, partial, m, n, k, splits, per_split, stage_chunks, st); break;
    case 6: err = launch_stream<6, TX>(x, q, s, out, partial, m, n, k, splits, per_split, stage_chunks, st); break;
    case 7: err = launch_stream<7, TX>(x, q, s, out, partial, m, n, k, splits, per_split, stage_chunks, st); break;
    default: err = launch_stream<8, TX>(x, q, s, out, partial, m, n, k, splits, per_split, stage_chunks, st); break;
  }
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  finish_kernel<TX><<<(m * n + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(partial), static_cast<const float*>(s), static_cast<TX*>(out), m,
      n, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 x and y (the bf16 models)
extern "C" int gofr_w8a16(const void* x, const void* q, const void* s, void* out, void* partial,
                          int m, int n, int k, int splits, int per_split, int stage_chunks,
                          void* stream) {
  return run<bf16>(x, q, s, out, partial, m, n, k, splits, per_split, stage_chunks, stream);
}

// f32 x and y (an f32 model with int8 weights); `stage_chunks` from the
// launcher's plan at 4-byte elements
extern "C" int gofr_w8a16_f32(const void* x, const void* q, const void* s, void* out,
                              void* partial, int m, int n, int k, int splits, int per_split,
                              int stage_chunks, void* stream) {
  return run<float>(x, q, s, out, partial, m, n, k, splits, per_split, stage_chunks, stream);
}
