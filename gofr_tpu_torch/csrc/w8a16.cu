// The W8A16 linear: y = bf16(bf16(x @ q^T) * bf16(s)), x bf16 [M, K], q int8
// [N, K] (K contiguous per output channel), s f32 [N], y bf16 [M, N].
//
// Port-only: the JAX package computes ops/quant.py qdot (:52) on a QTensor as
// XLA, which fuses the int8 -> bf16 convert into the operand read. Its value
// is two roundings, as the plain version (ops.quant.qdot_plain) takes them:
// the f32 sum rounded to bf16, then multiplied by the bf16 scale and rounded
// again. The int8 converts to bf16 exactly (|q| <= 127), in registers; no
// bf16 copy of a weight ever reaches device memory.
//
// What bounds it on an H100: at decode (M = 8 slots) and verify (M = 40) the
// weight's bytes. A Llama-3-8B decode step reads 7.50 GB of int8 weights over
// its 225 products, 2.24 ms at 3.35 TB/s, against 2 * 8 operations a weight
// byte, far below the ~295 where the tensor cores become the limit. At
// prefill (M = 2048 .. 4096 rows) the operations: 2 M N K at 989 TFLOP/s.
//
// Design, two tilings of one source (the launcher, ops/cuda/w8a16.py plan,
// picks by M):
//   - The weight stream (M <= 64). A block of 4 warps owns a band of 64
//     output channels, each warp 16 of them, over one split of K. The
//     product is swapped so that the weight is the mma A operand (16 channel
//     rows) and X the B operand (8 token columns; M is padded to a multiple
//     of 8, not 16). Each thread loads 16 contiguous int8 of each of its two
//     channel rows per 64-k chunk (16-byte loads; a row's 64 bytes come from
//     4 neighbouring threads), and the k order inside a chunk is permuted so
//     that exactly those bytes form its A fragments of the chunk's four
//     m16n8k16 steps: thread c's bytes 4t..4t+3 are logical columns 2c, 2c+1,
//     2c+8, 2c+9 of step t. X is staged in shared memory (rows padded by 16
//     bytes) and read in the same permuted order, 16 consecutive bf16 a
//     thread, so the sum is the same sum. Stages of X cover at most 48 KB, so
//     a block loops over stages when its split is longer. A thread issues
//     the loads of 4 chunks together (8 16-byte loads in flight).
//     Too few bands fill the card at small N, so K is split: each split
//     writes its f32 sums to a scratch the launcher allocates, and a second
//     kernel from the same entry point adds the splits in order and takes the
//     two roundings. Without a split the stream takes them itself; the scale
//     and the roundings come only after the whole K sum either way.
//     Blocks at the decode shapes (plan(8, N, K)): wq and wo (4096, 4096): 64
//     bands x 5 splits = 320; wk and wv (1024, 4096): 16 x 16 = 256; gate
//     and up (14336, 4096): 224 x 2 = 448; down (4096, 14336): 64 x 5 = 320;
//     the head (128256, 4096): 2004 x 1.
//   - The tiles (M > 64). A block of 8 warps computes 128 rows x 128
//     channels; tiles of 64 k of X (bf16) and Q (int8) flow through a
//     three-stage cp.async ring (async_copy.cuh). Each warp owns all 128
//     rows and 16 channels, so it converts each of its Q fragments once for
//     8 m16 row tiles: B fragments of Q come as two 16-bit shared loads,
//     converted to bf16 pairs in registers, A fragments of X by ldmatrix
//     (rows padded to 144 bytes, Q rows to 80: conflict-free); mma.sync
//     m16n8k16 bf16 -> f32 (mma.cuh). The first tiling (32 k a tile, warps
//     of 64 rows x 32 channels) is a variant in
//     scripts/torch_kernel_variants.py.
// Rows past M or N and k past K are zero-filled on load and never stored;
// K must be a multiple of 16 (the launcher checks). The next steps, when
// this loses to cuBLAS on bf16 weights: wgmma fed by TMA for the tiles, and
// a persistent stream that hides each band's first loads.
#include <cstdint>

#include <cuda_bf16.h>

#include "async_copy.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using gofr::cp_async16;
using gofr::cp_async_commit;
using gofr::cp_async_wait;
using gofr::ldmatrix_x4;
using gofr::mma_bf16;

constexpr int kChunk = 64;          // k a stream warp takes per step
constexpr int kBand = 64;           // output channels per stream block
constexpr int kStreamThreads = 128;
constexpr int kAhead = 4;           // chunks whose loads a stream warp issues together
constexpr int kXPad = 8;            // bf16 of padding per staged X row (16 bytes)

constexpr int kBM = 128, kBN = 128, kBK = 64, kStages = 3, kTileThreads = 256;
constexpr int kWM = 128, kWN = 16;  // a warp's rows and channels of the block tile
constexpr int kMT = kWM / 16, kNT = kWN / 8;
constexpr int kXRow = kBK + 8;      // bf16 per staged X row of a tile (144 bytes)
constexpr int kQRow = kBK + 16;     // bytes per staged Q row of a tile (80 bytes)
constexpr int kXStage = kBM * kXRow;
constexpr int kQStage = kBN * kQRow;
constexpr int kTileSmem = kStages * (kXStage * 2 + kQStage);

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

// The plain version's two roundings: bf16(bf16(acc) * bf16(s)).
__device__ __forceinline__ bf16 scaled(float acc, float s) {
  return __float2bfloat16(__bfloat162float(__float2bfloat16(acc)) *
                          __bfloat162float(__float2bfloat16(s)));
}

// The weight stream: MT token tiles of 8 rows (M <= 8 MT). Grid (bands,
// splits); split z sums chunks [z * per_split, (z + 1) * per_split).
template <int MT>
__global__ void __launch_bounds__(kStreamThreads)
    stream_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ q,
                  const float* __restrict__ s, bf16* __restrict__ out,
                  float* __restrict__ partial, int m, int n, int k, int per_split,
                  int stage_chunks) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  const int row_len = stage_chunks * kChunk + kXPad;
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
    const int pieces = (s_end - s0) * kChunk / 8;  // 16-byte pieces of a staged row
    __syncthreads();  // every warp is done with the previous stage
    for (int i = threadIdx.x; i < 8 * MT * pieces; i += kStreamThreads) {
      const int row = i / pieces, p = i % pieces;
      const int kk = s0 * kChunk + p * 8;
      const bool valid = row < m && kk < k;
      cp_async16(xs + row * row_len + p * 8, valid ? x + static_cast<size_t>(row) * k + kk : x,
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
          const bf16* xr = xs + (mt * 8 + quad) * row_len + xo;
          const uint4 xa = *reinterpret_cast<const uint4*>(xr);
          const uint4 xb = *reinterpret_cast<const uint4*>(xr + 8);
          const uint32_t xw[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
          for (int t = 0; t < 4; ++t) mma_bf16(acc[mt], frag[t], xw[2 * t], xw[2 * t + 1]);
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
        out[static_cast<size_t>(tok) * n + r] = scaled(acc[mt][i], s[r]);
      }
    }
  }
}

// The splits' f32 sums added in split order, then the two roundings.
__global__ void finish_kernel(const float* __restrict__ partial, const float* __restrict__ s,
                              bf16* __restrict__ out, int m, int n, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m * n) return;
  float acc = 0.f;
  for (int z = 0; z < splits; ++z) acc += partial[static_cast<size_t>(z) * m * n + i];
  out[i] = scaled(acc, s[i % n]);
}

// The tiles: grid (N / 128, M / 128), 8 warps of kWM rows x kWN channels.
__global__ void __launch_bounds__(kTileThreads)
    tile_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ q,
                const float* __restrict__ s, bf16* __restrict__ out, int m, int n, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  int8_t* qs = reinterpret_cast<int8_t*>(smem + kStages * kXStage * sizeof(bf16));
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int quad = lane / 4, c = lane % 4;
  const int wm = warp % (kBM / kWM), wn = warp / (kBM / kWM);
  const int tiles = (k + kBK - 1) / kBK;

  auto load = [&](int tile, int stage) {
    const int k0 = tile * kBK;
    for (int i = threadIdx.x; i < kBM * (kBK / 8); i += kTileThreads) {
      const int row = i / (kBK / 8), p = i % (kBK / 8);
      const int gm = m0 + row, gk = k0 + p * 8;
      const bool ok = gm < m && gk < k;
      cp_async16(xs + stage * kXStage + row * kXRow + p * 8,
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
    const bf16* xt = xs + (t % kStages) * kXStage;
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
        uint32_t a[4];
        ldmatrix_x4(a, xt + (wm * kWM + mt * 16 + lane % 16) * kXRow + kk * 16 + (lane / 16) * 8);
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) mma_bf16(acc[mt][nt], a, b[nt][0], b[nt][1]);
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
        bf16* o = out + static_cast<size_t>(gm) * n + gn;
        const bf16 y0 = scaled(acc[mt][nt][2 * h], s0);
        if (gn + 1 < n && n % 2 == 0) {
          *reinterpret_cast<__nv_bfloat162*>(o) = __halves2bfloat162(y0, scaled(acc[mt][nt][2 * h + 1], s1));
        } else {
          o[0] = y0;
          if (gn + 1 < n) o[1] = scaled(acc[mt][nt][2 * h + 1], s1);
        }
      }
    }
  }
}

template <int MT>
cudaError_t launch_stream(const void* x, const void* q, const void* s, void* out, void* partial,
                          int m, int n, int k, int splits, int per_split, int stage_chunks,
                          cudaStream_t stream) {
  const dim3 grid((n + kBand - 1) / kBand, splits);
  const size_t smem = static_cast<size_t>(8 * MT) * (stage_chunks * kChunk + kXPad) * sizeof(bf16);
  stream_kernel<MT><<<grid, kStreamThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const int8_t*>(q), static_cast<const float*>(s),
      static_cast<bf16*>(out), splits > 1 ? static_cast<float*>(partial) : nullptr, m, n, k,
      per_split, stage_chunks);
  return cudaGetLastError();
}

}  // namespace

// splits 0: the tiles; else the weight stream over `splits` splits of
// `per_split` chunks, staging at most `stage_chunks` chunks of X at once
// (partial: f32 [splits, M, N] when splits > 1). Returns cudaGetLastError().
extern "C" int gofr_w8a16(const void* x, const void* q, const void* s, void* out, void* partial,
                          int m, int n, int k, int splits, int per_split, int stage_chunks,
                          void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (splits == 0) {
    static bool configured = false;
    if (!configured) {
      const cudaError_t err = cudaFuncSetAttribute(
          tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTileSmem);
      if (err != cudaSuccess) return static_cast<int>(err);
      configured = true;
    }
    const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
    tile_kernel<<<grid, kTileThreads, kTileSmem, st>>>(
        static_cast<const bf16*>(x), static_cast<const int8_t*>(q), static_cast<const float*>(s),
        static_cast<bf16*>(out), m, n, k);
    return static_cast<int>(cudaGetLastError());
  }
  if (m < 1 || m > 64 || (splits > 1 && partial == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
  switch ((m + 7) / 8) {
    case 1: err = launch_stream<1>(x, q, s, out, partial, m, n, k, splits, per_split, stage_chunks, st); break;
    case 2: err = launch_stream<2>(x, q, s, out, partial, m, n, k, splits, per_split, stage_chunks, st); break;
    case 3: err = launch_stream<3>(x, q, s, out, partial, m, n, k, splits, per_split, stage_chunks, st); break;
    case 4: err = launch_stream<4>(x, q, s, out, partial, m, n, k, splits, per_split, stage_chunks, st); break;
    case 5: err = launch_stream<5>(x, q, s, out, partial, m, n, k, splits, per_split, stage_chunks, st); break;
    case 6: err = launch_stream<6>(x, q, s, out, partial, m, n, k, splits, per_split, stage_chunks, st); break;
    case 7: err = launch_stream<7>(x, q, s, out, partial, m, n, k, splits, per_split, stage_chunks, st); break;
    default: err = launch_stream<8>(x, q, s, out, partial, m, n, k, splits, per_split, stage_chunks, st); break;
  }
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  finish_kernel<<<(m * n + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(partial), static_cast<const float*>(s), static_cast<bf16*>(out), m,
      n, splits);
  return static_cast<int>(cudaGetLastError());
}
