// Kernel C's f32 build: flash (blocked online-softmax) prefill attention on
// f32 q/k/v with GQA, on tf32 wgmma fed by TMA, at head dim 128 (Llama in
// f32) and 64 (GPT-2 small, BERT-base and ViT-L/16 in their own f32).
//
// Replaces gofr_tpu/ops/pallas/flash_attention.py flash_attention (:108,
// pallas_call :159, body _flash_kernel :45) on f32 inputs; flash_attention.cu
// holds the bf16 build. The function is the TPU kernel's: GQA by h / group,
// causal masking with a per-batch q_offset, keys masked by kv_lengths, a
// fully masked row gives zeros (online_softmax.cuh), rows past Sq are never
// stored, tiles past the causal limit are never computed, and the longest
// causal tiles start first (the tile index is reversed).
//
// What bounds it on an H100: the TPU kernel's f32 dot is an f32 product, and
// one pass of TF32 keeps about three decimal digits, so every product runs
// as three tf32 products (3xTF32: hi.hi + hi.lo + lo.hi; only lo.lo, under
// 2^-20 of a product, is left out). 2 x D multiply-adds a (query, key) pair,
// three times over at 495 TFLOP/s: at 4 x 1024 causal (Hq 32, Hkv 8, D 128)
// 34.4 GFLOP, 0.208 ms, against 84 MB of q, k, v and out (0.025 ms); at 4 x
// 512 0.052 ms against 0.013: operations. BERT's step (256 x 64, D 64) and
// ViT's (32 x 197) move more than they multiply: bytes.
//
// Design: one block per (query head, batch row, 64-row query tile), of two
// warpgroups:
//   - The producer warpgroup. Its first thread issues the TMA loads: Q's
//     tile once, K's tiles of 64 keys into a ring of two stages (the next
//     tile's load in flight while one is read) and V's into one stage, each
//     stage's bytes counted into its mbarrier (hopper.cuh). The maps are
//     4-D, (d, head, position, batch), so positions past S arrive as zeros,
//     never as the next batch row's (ViT's 197 positions, an Sq or Skv that
//     is not a multiple of 64); a box is 32 f32 of a row (the 128-byte
//     swizzle's span), so a tile is D / 32 boxes. All 128 threads then turn
//     each tile into the planes the tensor cores read: K's lo plane, and V
//     transposed into Vt's hi and lo planes (PTX has no transposed tf32
//     operand, so both of a product's operands are K-major, and P.V's B
//     operand is Vt [d][key]), in blocks of 4 keys x 4 d, 16-byte loads and
//     stores on distinct bank groups (transpose_v). They fence the generic
//     proxy's writes to the async proxy's (fence_proxy_async) and arrive on
//     the plane's barrier.
//   - The consumer warpgroup, 16 query rows a warp. S = Q K^T is wgmma
//     m64n64k8 (A = Q, B = K, both K-major as stored): Q.hi from registers
//     (Q's raw words, D / 2 a thread) against K's lo plane and K's stage,
//     and Q.lo, written once over Q's tile, from shared memory against K's
//     stage, the small terms first. The online softmax runs in S's
//     accumulators (a quad of threads holds a row; online_softmax.cuh's
//     recurrence, masks and safe max, in base 2: scores scaled by log2(e)
//     once, ex2.approx), and P goes from them straight into the A fragments
//     of O += P.V, wgmma m64nDk8 from registers (P.lo against Vt.hi, P.hi
//     against Vt.lo, P.hi against Vt.hi). P is not rounded (common.py:57
//     casts it to v.dtype, f32 here). Only a tile that crosses the causal
//     diagonal or holds kv_length is masked.
//   - Barriers: a stage's TMA bytes (k_full, v_full, q_full); the planes of
//     tile i written (klo_ready, vt_ready); S of tile i done, so K's stage
//     and lo plane may be refilled (s_done); P.V of tile i done, so Vt's
//     planes may be rewritten (pv_done). The producer splits K of tile i + 1
//     while the consumers run the softmax and P.V of tile i, and transposes
//     V of tile i + 1 while they run S of tile i + 1. A wait that outlasts
//     mbar_wait's limit traps instead of holding the card.
//   - The key order (the PR 22 body's rule, now folded into the
//     transpose): S's accumulator gives a thread keys 2c and 2c + 1 of each
//     group of 8, where tf32's A fragment wants k indices c and c + 4
//     (hopper.cuh), so k index c stands for key 2c and c + 4 for key 2c + 1,
//     and Vt stores each group's keys in the order 0, 2, 4, 6, 1, 3, 5, 7
//     (transpose_v's keys). A sum over keys does not depend on their order.
//   - The split rule: the tensor cores read an f32 word as tf32 by dropping
//     its low 13 bits (tf32_hi; scripts/torch_flash_f32_probe.py reads it on
//     the card), so the raw Q words and K stage serve as hi as TMA lands
//     them, and lo = x - trunc(x), exact in f32, whose own low bits the
//     tensor cores drop in turn (2^-20 of x at most): computed once a tile a
//     block for K and V (not once a fragment a warp), once a block for Q.
//     V's hi plane is written anyway (the transpose), as trunc(x).
//   - Shared memory: Q (its lo terms), two K stages, a V stage, K's lo plane
//     and Vt's two planes, seven 64-row planes of D f32: 224 KB at D 128
//     (one block an SM, 227 KB the limit), 112 KB at 64; Q.hi would be an
//     eighth and does not fit, so it lives in the consumers' registers.
//     Registers: a consumer thread holds O (D / 2), S and P (32), P.lo (32)
//     and Q.hi (D / 2): 192 at D 128, under setmaxnreg's 240 (ptxas gives
//     the kernel 240, no spill); the producer threads give theirs back to 96.
//   - Output: O / l from the accumulators, straight to device memory as
//     8-byte pairs (a quad writes 32 contiguous bytes of a row), rows past
//     Sq never stored.
// What holds it now (scripts/torch_flash_f32_trace.py, clock64 around each
// wait): the consumer's chain a tile, S, then the softmax, then P.V, with
// the tensor cores idle through the softmax; overlapping the next tile's S
// with the softmax needs a second S (32 registers) with P.lo out of
// registers, and a second K lo plane or P's in shared memory, past both
// budgets at D 128 (PERF.md).
// The first f32 body (PR 22: 3xTF32 on mma.sync m16n8k8, fragments by
// 32-bit shared loads and split by every warp, a two-stage cp.async ring,
// four warps a block) lives on only in scripts/torch_kernel_variants.py.
#include <cstdint>

#include <cuda.h>

#include "hopper.cuh"
#include "online_softmax.cuh"

namespace {

constexpr int kBQ = 64;                   // query rows a block: wgmma's M
constexpr int kBK = 64;                   // keys a tile: S's N
constexpr int kBox = 32;                  // f32 of a box row: the 128-byte swizzle's span
constexpr int kConsumers = 128;           // the consumer warpgroup (and the producer's size)
constexpr int kThreads = 2 * kConsumers;  // consumers, then the producer warpgroup
constexpr int kProducerRegs = 96, kConsumerRegs = 240;

// The block's shared memory, in bytes from its 1024-aligned base: seven
// planes of 64 rows x D f32, each in TMA's 128-byte-swizzled boxes.
template <int kD>
struct Layout {
  static constexpr int kPlane = kBK * kD * 4;
  static constexpr int kBoxBytes = kBK * kBox * 4;  // 64 rows x 128 bytes
  static constexpr int kVtChunk = kD * kBox * 4;    // Vt: 32 keys of each of D rows
  static constexpr int kQ = 0, kK = kPlane, kV = 3 * kPlane, kKlo = 4 * kPlane;
  static constexpr int kVtHi = 5 * kPlane, kVtLo = 6 * kPlane, kBars = 7 * kPlane;
  static constexpr int kBarCount = 8;
  static constexpr int kSmem = 1024 + kBars + kBarCount * 8;
  static_assert(kSmem <= 232448, "the planes fit in the 227 KB a block can use");
  static_assert(kBQ == kBK, "Q's tile is a plane");
};

// hi: what the tensor cores read of x, its raw word with the low 13 bits
// dropped (so the raw tiles TMA lands serve as hi); lo = x - hi, exact in
// f32, whose own low 13 bits the tensor cores drop in turn (2^-20 of x at
// most).
__device__ __forceinline__ float tf32_hi(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}
__device__ __forceinline__ float tf32_lo(float x) { return x - tf32_hi(x); }

// 2^x on the special function unit (ex2.approx, a denormal result 0): the
// softmax runs in base 2, its scores scaled by log2(e) once.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
constexpr float kLog2e = 1.4426950408889634f;

// Byte offset of element (row, col) of a tile of 64-row boxes of 32 columns.
__device__ __forceinline__ int box_offset(int row, int col) {
  constexpr int kBoxBytes = kBK * kBox * 4;
  return (col / kBox) * kBoxBytes + row * 128 + ((((col % kBox) >> 2) ^ (row & 7)) << 4) +
         (col & 3) * 4;
}

// Descriptor of k8 step t of a K-major plane of 128-byte rows at `at`, whose
// 32-column chunks lie `chunk` bytes apart.
__device__ __forceinline__ uint64_t step_desc(uint32_t at, int t, int chunk) {
  return gofr::sw128_desc(at + (t / 4) * chunk + (t % 4) * 32);
}

// TMA: the 64 positions from `pos` of one head of batch row b, as D / 32
// boxes, counted into `bar`.
template <int kD>
__device__ __forceinline__ void load_tile(unsigned char* dst, const CUtensorMap* map, int head,
                                          int pos, int b, uint64_t* bar) {
  gofr::mbar_arrive_expect_tx(bar, Layout<kD>::kPlane);
#pragma unroll
  for (int x = 0; x < kD / kBox; ++x)
    gofr::tma_load_4d(dst + x * Layout<kD>::kBoxBytes, map, x * kBox, head, pos, b, bar);
}

// The producer warpgroup's share of tile i's K: the lo plane, element by
// element (the stage, which serves as hi, has the same layout).
template <int kD>
__device__ __forceinline__ void split_k(unsigned char* stage, unsigned char* lo, int p) {
  const float4* src = reinterpret_cast<const float4*>(stage);
  float4* dst = reinterpret_cast<float4*>(lo);
#pragma unroll 8
  for (int i = p; i < Layout<kD>::kPlane / 16; i += kConsumers) {
    const float4 x = src[i];
    dst[i] = make_float4(tf32_lo(x.x), tf32_lo(x.y), tf32_lo(x.z), tf32_lo(x.w));
  }
}

// ... and of tile i's V: Vt's hi and lo planes, D rows of 64 keys (two
// chunks of 32), 128-byte swizzled, each group of 8 keys in the order 0, 2,
// 4, 6, 1, 3, 5, 7. A thread takes 4 keys x 4 d at a time: keys 8 (g / 2) +
// g % 2 + 2j (j < 4), Vt's columns 4g .. 4g + 3, by four 16-byte loads of V's rows,
// and writes each of the 4 d rows of Vt as one 16-byte store a plane. The 8
// lanes of a quarter-warp (which the 16-byte accesses go in) take the 8
// column chunks d4 of one box and the key groups g = (lane / 2) ^ s, so that
// both their loads and their stores meet 8 distinct 16-byte bank groups;
// s (0..7), the 32-key chunk and the box make the 64 patterns a tile needs.
template <int kD>
__device__ __forceinline__ void transpose_v(const unsigned char* stage, unsigned char* hi,
                                            unsigned char* lo, int p) {
  using L = Layout<kD>;
  const int l8 = p & 7;
#pragma unroll 2
  for (int c = p >> 3; c < 16 * kD / kBox; c += kConsumers / 8) {
    const int s = c & 7, half = (c >> 3) & 1, box = c >> 4;
    const int g = half * 8 + ((l8 >> 1) ^ s);  // 4 keys: columns 4g .. 4g + 3 of Vt
    const int d4 = box * 8 + l8;                // 4 d: rows 4 d4 .. 4 d4 + 3 of Vt
    float4 x[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      x[j] = *reinterpret_cast<const float4*>(stage + box_offset(8 * (g >> 1) + (g & 1) + 2 * j, 4 * d4));
    const float rows[4][4] = {{x[0].x, x[1].x, x[2].x, x[3].x}, {x[0].y, x[1].y, x[2].y, x[3].y},
                              {x[0].z, x[1].z, x[2].z, x[3].z}, {x[0].w, x[1].w, x[2].w, x[3].w}};
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int n = 4 * d4 + m;
      const int off = half * L::kVtChunk + n * 128 + (((g & 7) ^ (n & 7)) << 4);
      const float* r = rows[m];
      *reinterpret_cast<float4*>(hi + off) =
          make_float4(tf32_hi(r[0]), tf32_hi(r[1]), tf32_hi(r[2]), tf32_hi(r[3]));
      *reinterpret_cast<float4*>(lo + off) =
          make_float4(tf32_lo(r[0]), tf32_lo(r[1]), tf32_lo(r[2]), tf32_lo(r[3]));
    }
  }
}

template <int kD>
__global__ void __launch_bounds__(kThreads, 1) flash_kernel_f32(
    const __grid_constant__ CUtensorMap qmap,  // [B, Sq, Hq, D] as (d, head, position, batch)
    const __grid_constant__ CUtensorMap kmap,  // [B, Skv, Hkv, D]
    const __grid_constant__ CUtensorMap vmap,  // [B, Skv, Hkv, D]
    const int* __restrict__ q_offset,          // [B]
    const int* __restrict__ kv_lengths,        // [B]
    float* __restrict__ out,                   // [B, Sq, Hq, D]
    int sq, int skv, int hq, int group, int causal, float scale) {
  using L = Layout<kD>;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* base = smem + ((1024 - (gofr::smem_addr(smem) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L::kBars);
  uint64_t *q_full = bars, *k_full = bars + 1, *v_full = bars + 3;  // k_full: one a stage
  uint64_t *klo_ready = bars + 4, *vt_ready = bars + 5, *s_done = bars + 6, *pv_done = bars + 7;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;  // longest causal tiles first
  const int tid = threadIdx.x;
  const int qo = q_offset[b];
  const int kl = min(max(kv_lengths[b], 0), skv);
  const int kv_end = max(causal ? min(kl, qo + q0 + kBQ) : kl, 0);
  const int n_tiles = (kv_end + kBK - 1) / kBK;

  if (n_tiles == 0) {  // every key masked: the rows are zeros
    for (int i = tid; i < kBQ * kD / 4; i += kThreads) {
      const int row = q0 + i / (kD / 4);
      if (row < sq)
        reinterpret_cast<float4*>(out + (((size_t)b * sq + row) * hq + h) * kD)[i % (kD / 4)] =
            make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }
  if (tid == 0) {
    gofr::mbar_init(q_full, 1);
    gofr::mbar_init(&k_full[0], 1);
    gofr::mbar_init(&k_full[1], 1);
    gofr::mbar_init(v_full, 1);
    gofr::mbar_init(klo_ready, kConsumers);
    gofr::mbar_init(vt_ready, kConsumers);
    gofr::mbar_init(s_done, kConsumers);
    gofr::mbar_init(pv_done, kConsumers);
    gofr::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warpgroup
    gofr::setmaxnreg_dec<kProducerRegs>();
    const int p = tid - kConsumers, hk = h / group;
    if (p == 0) {
      load_tile<kD>(base + L::kQ, &qmap, h, q0, b, q_full);
      load_tile<kD>(base + L::kK, &kmap, hk, 0, b, &k_full[0]);
      if (n_tiles > 1) load_tile<kD>(base + L::kK + L::kPlane, &kmap, hk, kBK, b, &k_full[1]);
      load_tile<kD>(base + L::kV, &vmap, hk, 0, b, v_full);
    }
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i & 1;
      if (i > 0) {
        // S of tile i - 1 is done: its stage takes tile i + 1, the lo plane tile i
        gofr::mbar_wait(s_done, (i - 1) & 1);
        if (p == 0 && i + 1 < n_tiles)
          load_tile<kD>(base + L::kK + (st ^ 1) * L::kPlane, &kmap, hk, (i + 1) * kBK, b,
                        &k_full[st ^ 1]);
      }
      gofr::mbar_wait(&k_full[st], (i >> 1) & 1);
      split_k<kD>(base + L::kK + st * L::kPlane, base + L::kKlo, p);
      gofr::fence_proxy_async();
      gofr::mbar_arrive(klo_ready);
      if (i > 0) gofr::mbar_wait(pv_done, (i - 1) & 1);  // Vt's planes are free
      gofr::mbar_wait(v_full, i & 1);
      transpose_v<kD>(base + L::kV, base + L::kVtHi, base + L::kVtLo, p);
      gofr::fence_proxy_async();
      gofr::mbar_arrive(vt_ready);
      if (i + 1 < n_tiles) {
        gofr::named_barrier(1, kConsumers);  // every producer thread is done with V's stage
        if (p == 0) load_tile<kD>(base + L::kV, &vmap, hk, (i + 1) * kBK, b, v_full);
      }
    }
    return;
  }

  // the consumer warpgroup
  gofr::setmaxnreg_inc<kConsumerRegs>();
  const int warp = tid >> 5, lane = tid & 31, gid = lane >> 2, c = lane & 3;
  const int row_lo = warp * 16 + gid;  // this thread's rows of the tile: row_lo and row_lo + 8
  const int pos_lo = qo + q0 + row_lo, pos_hi = pos_lo + 8;
  const float scale2 = scale * kLog2e;
  const uint32_t qlo_at = gofr::smem_addr(base + L::kQ), klo_at = gofr::smem_addr(base + L::kKlo);
  const uint32_t vthi_at = gofr::smem_addr(base + L::kVtHi);
  const uint32_t vtlo_at = gofr::smem_addr(base + L::kVtLo);

  // Q's hi terms as A fragments (rows row_lo, + 8 for a[1], a[3]; k
  // indices c, + 4 for a[2], a[3], of each k8 step), and its lo terms over
  // the tile in shared memory, where each element is one thread's
  gofr::mbar_wait(q_full, 0);
  uint32_t qhi[kD / 8][4];
#pragma unroll
  for (int t = 0; t < kD / 8; ++t) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float* at = reinterpret_cast<float*>(base + L::kQ +
                                           box_offset(row_lo + 8 * (r & 1), 8 * t + c + 4 * (r >> 1)));
      const float x = *at;
      qhi[t][r] = __float_as_uint(x);
      *at = tf32_lo(x);
    }
  }
  gofr::fence_proxy_async();
  gofr::named_barrier(2, kConsumers);

  float o[kD / 2];   // O: d[4j + e] is O[row_lo + 8 (e / 2)][8j + 2c + e % 2]
  float s[kBK / 2];  // S, then P, in the same layout over 64 keys
#pragma unroll
  for (int j = 0; j < kD / 2; ++j) o[j] = 0.f;
#pragma unroll
  for (int j = 0; j < kBK / 2; ++j) s[j] = 0.f;
  gofr::RowState st[2] = {gofr::row_init(), gofr::row_init()};

  for (int i = 0; i < n_tiles; ++i) {
    const int k0 = i * kBK;
    const uint32_t k_at = gofr::smem_addr(base + L::kK + (i & 1) * L::kPlane);
    gofr::mbar_wait(&k_full[i & 1], (i >> 1) & 1);
    gofr::mbar_wait(klo_ready, i & 1);

    // S = Q K^T in 3xTF32, the small terms first
    gofr::wgmma_fence();
#pragma unroll
    for (int t = 0; t < kD / 8; ++t)
      gofr::WgmmaTf32<kBK>::rs(s, qhi[t], step_desc(klo_at, t, L::kBoxBytes), t > 0);
#pragma unroll
    for (int t = 0; t < kD / 8; ++t)
      gofr::WgmmaTf32<kBK>::ss(s, step_desc(qlo_at, t, L::kBoxBytes), step_desc(k_at, t, L::kBoxBytes), 1);
#pragma unroll
    for (int t = 0; t < kD / 8; ++t)
      gofr::WgmmaTf32<kBK>::rs(s, qhi[t], step_desc(k_at, t, L::kBoxBytes), 1);
    gofr::wgmma_commit();
    gofr::wgmma_wait<0>();
    gofr::fence_regs(s);
    gofr::mbar_arrive(s_done);

    // scale (into base 2), and mask only a tile that crosses the diagonal or
    // holds kv_length
    const bool edge = k0 + kBK > kl || (causal && k0 + kBK - 1 > qo + q0);
    float tile_max[2] = {gofr::kNegInf, gofr::kNegInf};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kv = k0 + j * 8 + 2 * c + (e & 1);
        const int pos = e < 2 ? pos_lo : pos_hi;
        float x = s[4 * j + e] * scale2;
        if (edge && !(kv < kl && (!causal || pos >= kv))) x = gofr::kNegInf;
        s[4 * j + e] = x;
        tile_max[e >> 1] = fmaxf(tile_max[e >> 1], x);
      }
    }
    // online_softmax.cuh's recurrence in base 2: the safe max, alpha
    float alpha[2], safe[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_next = fmaxf(st[r].m, gofr::quad_max(tile_max[r]));
      safe[r] = m_next > gofr::kNegInf * 0.5f ? m_next : 0.f;
      alpha[r] = exp2_approx(st[r].m - safe[r]);
      st[r].m = m_next;
      st[r].l *= alpha[r];
    }

    // P, unrounded, and its A fragments: k index c is key 2c of the group
    // (accumulator element 0 or 2), c + 4 key 2c + 1 (element 1 or 3)
    uint32_t p_hi[kBK / 8][4], p_lo[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pr = exp2_approx(s[4 * j + e] - safe[e >> 1]);
        st[e >> 1].l += pr;
        const int r = (e >> 1) | ((e & 1) << 1);  // the fragment register of element e
        p_hi[j][r] = __float_as_uint(pr);
        p_lo[j][r] = __float_as_uint(tf32_lo(pr));
      }
    }

    // O = O * alpha + P V in 3xTF32
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      o[4 * j] *= alpha[0], o[4 * j + 1] *= alpha[0], o[4 * j + 2] *= alpha[1], o[4 * j + 3] *= alpha[1];
    }
    gofr::mbar_wait(vt_ready, i & 1);
    gofr::wgmma_fence();
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
      gofr::WgmmaTf32<kD>::rs(o, p_lo[j], step_desc(vthi_at, j, L::kVtChunk), 1);
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
      gofr::WgmmaTf32<kD>::rs(o, p_hi[j], step_desc(vtlo_at, j, L::kVtChunk), 1);
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
      gofr::WgmmaTf32<kD>::rs(o, p_hi[j], step_desc(vthi_at, j, L::kVtChunk), 1);
    gofr::wgmma_commit();
    gofr::wgmma_wait<0>();
    gofr::fence_regs(o);
    gofr::mbar_arrive(pv_done);
  }

  const float l_lo = gofr::quad_sum(st[0].l), l_hi = gofr::quad_sum(st[1].l);
  const int row = q0 + row_lo;
  float* out_lo = out + (((size_t)b * sq + row) * hq + h) * kD + 2 * c;
  float* out_hi = out_lo + (size_t)8 * hq * kD;
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    if (row < sq)
      *reinterpret_cast<float2*>(out_lo + 8 * j) =
          make_float2(gofr::row_finish(o[4 * j], l_lo), gofr::row_finish(o[4 * j + 1], l_lo));
    if (row + 8 < sq)
      *reinterpret_cast<float2*>(out_hi + 8 * j) =
          make_float2(gofr::row_finish(o[4 * j + 2], l_hi), gofr::row_finish(o[4 * j + 3], l_hi));
  }
}

// A 4-D map of a contiguous [batch, seq, heads, d] f32 tensor as (d, head,
// position, batch), boxes of 32 d x 1 head x 64 positions x 1 batch row in
// the 128-byte swizzle; parts of a box past the tensor load as zeros.
bool head_map(gofr::EncodeTiled encode, CUtensorMap* map, const void* base, int d, int heads,
              int seq, int batch) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq), static_cast<cuuint64_t>(batch)};
  const cuuint64_t row = static_cast<cuuint64_t>(d) * 4;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * seq};
  const cuuint32_t box[4] = {kBox, 1, kBK, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The three maps encoded on every launch (the tensors' addresses change with
// every call), then the launch.
template <int kD>
int launch(const void* q, const void* k, const void* v, const void* q_offset,
           const void* kv_lengths, void* out, int b, int sq, int skv, int hq, int hkv, int causal,
           float scale, cudaStream_t stream) {
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  gofr::EncodeTiled encode;
  const cudaError_t found = gofr::tensor_map_encoder(&encode);
  if (found != cudaSuccess) return static_cast<int>(found);
  CUtensorMap qmap, kmap, vmap;
  if (!head_map(encode, &qmap, q, kD, hq, sq, b) || !head_map(encode, &kmap, k, kD, hkv, skv, b) ||
      !head_map(encode, &vmap, v, kD, hkv, skv, b)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static bool configured = false;  // one flag per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel_f32<kD>, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<kD>::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid(hq, b, (sq + kBQ - 1) / kBQ);
  flash_kernel_f32<kD><<<grid, kThreads, Layout<kD>::kSmem, stream>>>(
      qmap, kmap, vmap, static_cast<const int*>(q_offset), static_cast<const int*>(kv_lengths),
      static_cast<float*>(out), sq, skv, hq, hq / hkv, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One entry point a head dim (d must be 128, or 64 for the _d64 entry; any
// other is refused as cudaErrorInvalidValue). q, k and v must be 16-byte
// aligned (the launcher copies one that is not).
extern "C" int gofr_flash_attention_f32(const void* q, const void* k, const void* v,
                                        const void* q_offset, const void* kv_lengths, void* out,
                                        int b, int sq, int skv, int hq, int hkv, int d, int causal,
                                        float scale, void* stream) {
  if (d != 128) return static_cast<int>(cudaErrorInvalidValue);
  return launch<128>(q, k, v, q_offset, kv_lengths, out, b, sq, skv, hq, hkv, causal, scale,
                     static_cast<cudaStream_t>(stream));
}

extern "C" int gofr_flash_attention_d64_f32(const void* q, const void* k, const void* v,
                                            const void* q_offset, const void* kv_lengths,
                                            void* out, int b, int sq, int skv, int hq, int hkv,
                                            int d, int causal, float scale, void* stream) {
  if (d != 64) return static_cast<int>(cudaErrorInvalidValue);
  return launch<64>(q, k, v, q_offset, kv_lengths, out, b, sq, skv, hq, hkv, causal, scale,
                    static_cast<cudaStream_t>(stream));
}

// The dynamic shared memory a block of the build at head dim d takes (0 for
// another d): chip_smoke.py reports it beside ptxas's registers.
extern "C" int gofr_flash_attention_f32_shared_bytes(int d) {
  return d == 128 ? Layout<128>::kSmem : d == 64 ? Layout<64>::kSmem : 0;
}
