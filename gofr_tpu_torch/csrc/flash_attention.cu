// Flash (blocked online-softmax) prefill attention with GQA, on the tensor
// cores, at head dim 128 (Llama) and 64 (BERT-base, ViT-L/16, GPT-2).
//
// Replaces gofr_tpu/ops/pallas/flash_attention.py flash_attention (:108,
// pallas_call :159, body _flash_kernel :45), reached from the JAX package
// through ops/attention._flash_mha (:126).
//
// What bounds it on an H100: q and out ([B, S, Hq, 128] bf16) dominate the
// bytes, and the causal (query, key) pairs the operations. At 4 x 512 (Hq 32,
// Hkv 8) the call moves 42 MB (12.5 us at 3.35 TB/s) for 8.6 GFLOP (8.7 us at
// 989 TFLOP/s): bytes. At 4 x 1024 the pairs grow with the square of the
// prompt: 34 GFLOP (34.8 us) against 84 MB (25 us): operations. Either way
// the score matrix must never reach device memory, and the products must
// run on the tensor cores, the only units near that operation rate.
//
// Design (the FlashAttention-2 shape, for mma.sync on sm_90a):
//   - One block of 4 warps per (query head, batch row, 64-row query tile);
//     each warp owns 16 query rows. The tile index is reversed, so the
//     causal triangle's longest tiles start first and do not form the last
//     wave. GQA reads KV head h / G: K/V are never repeated in memory.
//   - Q is copied into shared memory once and loaded into registers as
//     mma A fragments with ldmatrix. K/V tiles of 64 rows flow through a
//     two-stage ring of cp.async copies (async_copy.cuh): the next tile
//     loads while the current one is computed; rows at or past Skv are
//     zero-filled. Rows are padded by 16 B (272 B), so the 8 rows each
//     ldmatrix phase reads fall on distinct banks.
//   - S = Q K^T and O += P V are mma.sync.m16n8k16 bf16 -> f32, with K
//     fragments from ldmatrix and V fragments from ldmatrix.trans (V keeps
//     its [t, d] layout). P goes from the S accumulators straight into the
//     A fragments of P V, rounded to bf16; no score tile passes through
//     shared memory.
//   - The online softmax runs in registers: the 4 threads of an mma quad
//     hold one row and reduce its max and sum with shuffles; the recurrence
//     and its masking rules are online_softmax.cuh's, so a fully masked row
//     gives zeros, not NaN. Each thread keeps a partial normaliser of its own
//     unrounded probabilities; the quad sums them once, at the end.
//   - Tiles past the causal limit q_offset + q_end or the row's kv_length
//     are never loaded (the TPU kernel's block skip, flash_attention.py:
//     71-73); only a tile that crosses the diagonal or holds kv_length is
//     masked.
//   - The output tile goes back through the (then free) Q tile in shared
//     memory, so it is written to device memory in 16-byte rows.
//   - The head dim is a template parameter, instantiated at 128 and 64;
//     the entry point picks the instantiation by its ``d`` argument. Only
//     the row (its padded stride and 16-byte chunks) and the register
//     fragments of Q and O follow it: qf[kD/16], o[kD/8], and the P V
//     product in kD/64 passes of four ldmatrix.trans fragments. The tiles
//     stay 64 x 64, so the 64 build's shared memory is 46,080 B.
//     Non-causal calls with kv_lengths are BERT's (keys padded to the length
//     bucket) and ViT's (197 positions: the last query and key tiles hold 5
//     rows; rows past Sq and Skv are zero-filled on load and never stored).
//
// The f32 build is a kernel of its own, for Hopper's tf32 wgmma fed by TMA:
// flash_attention_f32.cu.
#include <cstdint>

#include "async_copy.cuh"
#include "mma.cuh"
#include "online_softmax.cuh"

namespace {

using bf16 = __nv_bfloat16;
using gofr::ldmatrix_x4;
using gofr::ldmatrix_x4_trans;
using gofr::mma_bf16;

constexpr int kBQ = 64;            // query rows per block
constexpr int kBK = 64;            // KV rows per tile
constexpr int kWarps = kBQ / 16;   // one warp per 16 query rows
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;         // K/V ring depth

static_assert(kBQ == kBK, "stage_rows copies 64-row tiles of Q, K and V alike");

// What follows the head dim kD (the wrapper checks it is 64 or 128).
template <int kD>
struct Dims {
  static_assert(kD % 64 == 0, "P V runs in passes of 64 columns");
  static constexpr int kPerChunk = 8;  // bf16 per 16-byte chunk
  // padded row in shared memory: 272 or 144 B
  static constexpr int kStride = kD + kPerChunk;
  static constexpr int kChunks = kD / kPerChunk;  // 16-byte chunks per row
  static constexpr int kTileElems = kBK * kStride;
  // 87,040 B at 128, 46,080 B at 64
  static constexpr int kSmemBytes = (kBQ * kStride + 2 * kStages * kTileElems) * 2;
};

// Two f32 values as one register of bf16 pair, `lo` in the low half (the
// lower column of an mma fragment).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Issue the copies of rows row0 .. row0+63 of a [rows, pitch] bf16 matrix
// into a padded shared tile; rows at or past `valid` are zero-filled.
template <int kD>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, int row0, int valid,
                                           size_t pitch) {
  constexpr int kChunks = Dims<kD>::kChunks, kStride = Dims<kD>::kStride;
  for (int c = threadIdx.x; c < kBK * kChunks; c += kThreads) {
    const int r = c / kChunks, col = (c % kChunks) * Dims<kD>::kPerChunk;
    const bool ok = row0 + r < valid;
    gofr::cp_async16(dst + r * kStride + col, src + (ok ? (size_t)(row0 + r) * pitch : 0) + col, ok);
  }
}

template <int kD>
__global__ void __launch_bounds__(kThreads) flash_kernel(
    const bf16* __restrict__ q,           // [B, Sq, Hq, D]
    const bf16* __restrict__ k,           // [B, Skv, Hkv, D]
    const bf16* __restrict__ v,           // [B, Skv, Hkv, D]
    const int* __restrict__ q_offset,     // [B]
    const int* __restrict__ kv_lengths,   // [B]
    bf16* __restrict__ out,               // [B, Sq, Hq, D]
    int sq, int skv, int hq, int hkv, int group, int causal, float scale) {
  constexpr int kStride = Dims<kD>::kStride, kChunks = Dims<kD>::kChunks;
  constexpr int kTileElems = Dims<kD>::kTileElems;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);  // [kBQ][kStride], then the output tile
  bf16* k_s = q_s + kBQ * kStride;            // [kStages][kBK][kStride]
  bf16* v_s = k_s + kStages * kTileElems;     // [kStages][kBK][kStride]

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;  // longest causal tiles first
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;  // mma fragment row group, thread in group
  const int mat = lane >> 3, mrow = lane & 7;  // ldmatrix: which 8x8 matrix, which row
  const int qo = q_offset[b];
  const int kl = min(max(kv_lengths[b], 0), skv);
  const size_t q_pitch = (size_t)hq * kD, kv_pitch = (size_t)hkv * kD;
  const bf16* qb = q + ((size_t)b * sq * hq + h) * kD;
  const bf16* kb = k + ((size_t)b * skv * hkv + h / group) * kD;
  const bf16* vb = v + ((size_t)b * skv * hkv + h / group) * kD;
  const int kv_end = max(causal ? min(kl, qo + q0 + kBQ) : kl, 0);
  const int n_tiles = (kv_end + kBK - 1) / kBK;
  // query positions of this thread's two rows (gid and gid + 8 of the warp's 16)
  const int pos_lo = qo + q0 + warp * 16 + gid, pos_hi = pos_lo + 8;

  stage_rows<kD>(q_s, qb, q0, sq, q_pitch);
  if (n_tiles > 0) {
    stage_rows<kD>(k_s, kb, 0, skv, kv_pitch);
    stage_rows<kD>(v_s, vb, 0, skv, kv_pitch);
  }
  gofr::cp_async_commit();

  uint32_t qf[kD / 16][4];  // Q as A fragments, one per 16-wide step of d
  float o[kD / 8][4];       // O accumulators, one per 8-wide tile of d
#pragma unroll
  for (int j = 0; j < kD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  // rows gid and gid + 8: running max (quad-wide) and this thread's share of l
  gofr::RowState st[2] = {gofr::row_init(), gofr::row_init()};

  for (int i = 0; i < n_tiles; ++i) {
    const int k0 = i * kBK;
    if (i + 1 < n_tiles) {
      const int next = (i + 1) % kStages;
      stage_rows<kD>(k_s + next * kTileElems, kb, k0 + kBK, skv, kv_pitch);
      stage_rows<kD>(v_s + next * kTileElems, vb, k0 + kBK, skv, kv_pitch);
    }
    gofr::cp_async_commit();  // possibly empty, so one wait depth serves every step
    gofr::cp_async_wait<1>();
    __syncthreads();
    if (i == 0) {
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        ldmatrix_x4(qf[kk], q_s + (warp * 16 + (lane & 15)) * kStride + kk * 16 + (lane >> 4) * 8);
    }
    const bf16* ks = k_s + (i % kStages) * kTileElems;
    const bf16* vs = v_s + (i % kStages) * kTileElems;

    // S = Q K^T: 16 rows x 64 keys per warp, 8 n-tiles of 8 keys
    float s[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      // all four fragments of this d-step first, so their loads overlap
      // matrices: keys +0..7 / +8..15 (mat >> 1) by d +0..7 / +8..15 (mat & 1)
      uint32_t kf[kBK / 16][4];
#pragma unroll
      for (int np = 0; np < kBK / 16; ++np)
        ldmatrix_x4(kf[np], ks + (np * 16 + mrow + (mat >> 1) * 8) * kStride + kk * 16 + (mat & 1) * 8);
#pragma unroll
      for (int np = 0; np < kBK / 16; ++np) {
        mma_bf16(s[2 * np], qf[kk], kf[np][0], kf[np][1]);
        mma_bf16(s[2 * np + 1], qf[kk], kf[np][2], kf[np][3]);
      }
    }

    // scale, and mask only a tile that crosses the diagonal or holds kv_length
    const bool edge = k0 + kBK > kl || (causal && k0 + kBK - 1 > qo + q0);
    float tile_max[2] = {gofr::kNegInf, gofr::kNegInf};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kv = k0 + j * 8 + 2 * tig + (e & 1);
        const int pos = e < 2 ? pos_lo : pos_hi;
        float x = s[j][e] * scale;
        if (edge && !(kv < kl && (!causal || pos >= kv))) x = gofr::kNegInf;
        s[j][e] = x;
        tile_max[e >> 1] = fmaxf(tile_max[e >> 1], x);
      }
    }
    float alpha[2], safe[2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      alpha[r] = gofr::row_rescale(st[r], gofr::quad_max(tile_max[r]), &safe[r]);

    // P as the A fragments of P V: k-step j/2 takes n-tile j as its low
    // (even j) or high (odd j) 8 keys; l sums the unrounded probabilities
    uint32_t pf[kBK / 16][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      const float p0 = gofr::row_prob(s[j][0], safe[0]), p1 = gofr::row_prob(s[j][1], safe[0]);
      const float p2 = gofr::row_prob(s[j][2], safe[1]), p3 = gofr::row_prob(s[j][3], safe[1]);
      st[0].l += p0 + p1;
      st[1].l += p2 + p3;
      pf[j >> 1][(j & 1) * 2] = pack_bf16(p0, p1);      // row gid
      pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);  // row gid + 8
    }

    // O = O * alpha + P V: 16 rows x kD columns per warp
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      o[j][0] *= alpha[0], o[j][1] *= alpha[0], o[j][2] *= alpha[1], o[j][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
      for (int half = 0; half < kD / 64; ++half) {
        // four fragments (64 columns of d) first, so their loads overlap
        // transposed matrices: keys +0..7 / +8..15 (mat & 1) by d +0..7 / +8..15 (mat >> 1)
        uint32_t vf[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          ldmatrix_x4_trans(vf[j], vs + (kk * 16 + mrow + (mat & 1) * 8) * kStride +
                                       (half * 4 + j) * 16 + (mat >> 1) * 8);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int dp = half * 4 + j;
          mma_bf16(o[2 * dp], pf[kk], vf[j][0], vf[j][1]);
          mma_bf16(o[2 * dp + 1], pf[kk], vf[j][2], vf[j][3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // Q's copies may still be in flight when no tile was loaded
  gofr::cp_async_wait<0>();
  __syncthreads();
  const float l_lo = gofr::quad_sum(st[0].l), l_hi = gofr::quad_sum(st[1].l);
  bf16* o_s = q_s + warp * 16 * kStride;  // this warp's 16 rows of the Q tile
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    const int col = j * 8 + 2 * tig;
    *reinterpret_cast<__nv_bfloat162*>(o_s + gid * kStride + col) = __floats2bfloat162_rn(
        gofr::row_finish(o[j][0], l_lo), gofr::row_finish(o[j][1], l_lo));
    *reinterpret_cast<__nv_bfloat162*>(o_s + (gid + 8) * kStride + col) = __floats2bfloat162_rn(
        gofr::row_finish(o[j][2], l_hi), gofr::row_finish(o[j][3], l_hi));
  }
  __syncwarp();
  for (int c = lane; c < 16 * kChunks; c += 32) {
    const int r = c / kChunks, col = (c % kChunks) * 8, row = q0 + warp * 16 + r;
    if (row < sq)
      *reinterpret_cast<uint4*>(out + (((size_t)b * sq + row) * hq + h) * kD + col) =
          *reinterpret_cast<const uint4*>(o_s + r * kStride + col);
  }
}

template <int kD>
int launch(const void* q, const void* k, const void* v, const void* q_offset,
           const void* kv_lengths, void* out, int b, int sq, int skv, int hq, int hkv, int causal,
           float scale, cudaStream_t stream) {
  constexpr int kSmemBytes = Dims<kD>::kSmemBytes;
  static bool configured = false;  // one flag per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<kD>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid(hq, b, (sq + kBQ - 1) / kBQ);
  flash_kernel<kD><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(q_offset), static_cast<const int*>(kv_lengths),
      static_cast<bf16*>(out), sq, skv, hq, hkv, hq / hkv, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// d is the head dim: 128 or 64 (the wrapper checks; any other is refused
// here too, as cudaErrorInvalidValue).
extern "C" int gofr_flash_attention(const void* q, const void* k, const void* v,
                                    const void* q_offset, const void* kv_lengths, void* out,
                                    int b, int sq, int skv, int hq, int hkv, int d, int causal,
                                    float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 128)
    return launch<128>(q, k, v, q_offset, kv_lengths, out, b, sq, skv, hq, hkv, causal, scale, s);
  if (d == 64)
    return launch<64>(q, k, v, q_offset, kv_lengths, out, b, sq, skv, hq, hkv, causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
