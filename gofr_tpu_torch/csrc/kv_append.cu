// Per-step KV append, in place: one new K row and one new V row per (slot,
// KV head) written into the layer's cache at the slot's position, in any of
// the five cache formats, by one template over a row policy and an address
// policy:
//
//   kernel   entry point             rows       cache
//   B        gofr_kv_append          Bf16Rows   PoolAddr  bf16 paged pool
//   G        gofr_kv_append_slot     Bf16Rows   SlotAddr  bf16 slot cache
//   B-q      gofr_kv_append_q        Int8Rows   PoolAddr  int8 paged pool
//   B-q4     gofr_kv_append_q4       Int4Rows   PoolAddr  packed int4 paged pool
//   G-q      gofr_kv_append_slot_q   Int8Rows   SlotAddr  int8 slot cache
//
// Replaces gofr_tpu/ops/pallas/kv_append.py append_tokens_paged_inplace
// (:110, pallas_call :160) and append_tokens_inplace (:61, pallas_call :80,
// body _append_kernel :45). B-q, B-q4 and G-q are the port's own: the JAX
// package runs the quantized appends as XLA (gofr_tpu/ops/paged.py:344
// append_tokens_paged_q, :438 append_tokens_paged_q4, gofr_tpu/ops/
// kvcache.py:132 append_tokens_q), and their plain PyTorch versions index
// by a boolean mask, a host sync per plane. The row policies carry the
// names of csrc/paged_decode_q.cu's, so a pool's append pairs with its
// decode.
//
// What bounds it on the card: the launch. A decode step writes, per layer,
// N x Hkv rows of K and of V: 9 x 8 x 256 B x 2 = 36 KiB of bf16 rows at
// phase 3's shapes, half or a quarter of that quantized, and reads as much.
// That is about 0.02 us at 3.35 TB/s, against a few microseconds for any
// launch: no layout of the work comes near the byte bound. What a design can
// do is keep the launch short (enough warps in flight, no serial latency
// beyond what the addressing needs) and keep its host side short, since the
// host, not the card, paces a decode step (PERF.md section 5).
//
// Design:
//   - One launch per layer writes both planes, and on the quantized caches
//     both scale planes: grid (N x Hkv / 4, 2), the y index the plane, one
//     warp per (slot, KV head, plane): 144 warps at phase 3's shapes where
//     the first design ran one block per slot (9 blocks on 132 SMs).
//   - A warp holds one 128-wide row: each lane two 4-byte words of the bf16
//     input, one 8-byte load (Bf16Rows, Int8Rows: elements 4l .. 4l + 3) or
//     two 4-byte loads (Int4Rows: elements 2l, 2l + 1 and 64 + 2l, 65 + 2l,
//     the pair one packed byte holds). Stores are 8, 4 or 2 bytes a lane:
//     the warp writes its 256-, 128- or 64-byte row in one coalesced store.
//     No shared memory.
//   - The row's load is issued before the address chain (positions[n], then
//     the table entry, then the store) resolves: the row does not depend on
//     where it lands, so the two latencies overlap instead of adding up.
//   - Quantization in registers, bit for bit that of ops.kvcache.
//     quantize_row and ops.quant.quantize_row_int4 (gofr_tpu/ops/
//     kvcache.py:103, gofr_tpu/ops/quant.py:118): the row's max |x| over
//     the warp by __shfl_xor_sync, s = max(amax, 1e-8) / 127 (or / 7) in
//     IEEE division, q = x / s rounded half to even (__float2int_rn, as
//     torch.round and jnp.round) and clamped to +-127 (+-7), the scale
//     stored as bf16 rounded to nearest even by lane 0. The build has no
//     --use_fast_math, which would make both divisions approximate.
//   - Packed int4 is split-half: byte j holds element j in its low nibble
//     and element j + D/2 in its high nibble, each biased by +8
//     (ops/quant.py pack_int4), which is why an Int4Rows lane loads both.
//   - Drop rule, unchanged: on the pool a row is dropped when pos < 0, when
//     pos // page >= MaxP or when the table entry is not a pool page (< 0 or
//     >= P, the OOB id P); on a slot cache when pos is outside [0, Smax).
//     Every other byte of the cache is left untouched. (The JAX XLA append
//     clamps a position past the table onto the slot's last page instead;
//     ROADMAP Queue C.)
//
// The TPU kernel needed a reserved sink page 0: Mosaic's pipeline copied a
// whole page tile through VMEM and back, so an OOB row's tile had to land on
// a page no real row wrote in the same call (kv_append.py:120-130). This
// kernel stores only the new row, so it needs no sink page and every pool
// page is allocatable.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kD = 128;                   // head_dim (the launchers check)
constexpr int kWarps = 4;                 // (slot, head) rows per block and plane
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFullMask = 0xFFFFFFFFu;
constexpr int kBias = 8;                  // int4 nibble bias

// The two bf16 elements of a 32-bit word as f32, low half first.
__device__ __forceinline__ float lo_bf16(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }

__device__ __forceinline__ float warp_amax(float a) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) a = fmaxf(a, __shfl_xor_sync(kFullMask, a, o));
  return a;
}

// Symmetric per-row quantization to +-kMax of the lane's four elements x:
// the codes q and (from every lane) the row's f32 scale.
template <int kMax>
__device__ __forceinline__ float quantize(const float (&x)[4], int (&q)[4]) {
  const float a = fmaxf(fmaxf(fabsf(x[0]), fabsf(x[1])), fmaxf(fabsf(x[2]), fabsf(x[3])));
  const float s = fmaxf(warp_amax(a), 1e-8f) / static_cast<float>(kMax);
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = min(max(__float2int_rn(x[i] / s), -kMax), kMax);
  return s;
}

__device__ __forceinline__ void unpack(uint2 raw, float (&x)[4]) {
  x[0] = lo_bf16(raw.x);
  x[1] = hi_bf16(raw.x);
  x[2] = lo_bf16(raw.y);
  x[3] = hi_bf16(raw.y);
}

__device__ __forceinline__ uint32_t nibbles(int lo, int hi) {
  return static_cast<uint32_t>(lo + kBias) | (static_cast<uint32_t>(hi + kBias) << 4);
}

// bf16 rows (kernels B, G): the 16-bit patterns copied as they are, lane l
// elements 4l .. 4l + 3.
struct Bf16Rows {
  static constexpr int kRowBytes = kD * 2;

  __device__ static uint2 load(const uint32_t* row, int lane) {
    return __ldg(reinterpret_cast<const uint2*>(row) + lane);
  }

  __device__ static void store(uint8_t* dst, bf16*, uint2 raw, int lane) {
    reinterpret_cast<uint2*>(dst)[lane] = raw;
  }
};

// int8 rows with one bf16 scale (kernels B-q, G-q): lane l quantizes
// elements 4l .. 4l + 3 into bytes 4l .. 4l + 3.
struct Int8Rows {
  static constexpr int kRowBytes = kD;

  __device__ static uint2 load(const uint32_t* row, int lane) { return Bf16Rows::load(row, lane); }

  __device__ static void store(uint8_t* dst, bf16* scale, uint2 raw, int lane) {
    float x[4];
    int q[4];
    unpack(raw, x);
    const float s = quantize<127>(x, q);
    reinterpret_cast<uint32_t*>(dst)[lane] =
        static_cast<uint32_t>(q[0] & 0xFF) | (static_cast<uint32_t>(q[1] & 0xFF) << 8) |
        (static_cast<uint32_t>(q[2] & 0xFF) << 16) | (static_cast<uint32_t>(q[3] & 0xFF) << 24);
    if (lane == 0) *scale = __float2bfloat16_rn(s);
  }
};

// packed int4 rows with one bf16 scale (kernel B-q4): lane l holds
// elements 2l, 2l + 1 (word l) and 64 + 2l, 65 + 2l (word 32 + l) and
// writes packed bytes 2l and 2l + 1.
struct Int4Rows {
  static constexpr int kRowBytes = kD / 2;

  __device__ static uint2 load(const uint32_t* row, int lane) {
    return make_uint2(__ldg(row + lane), __ldg(row + kD / 4 + lane));
  }

  __device__ static void store(uint8_t* dst, bf16* scale, uint2 raw, int lane) {
    float x[4];
    int q[4];
    unpack(raw, x);
    const float s = quantize<7>(x, q);
    reinterpret_cast<uint16_t*>(dst)[lane] =
        static_cast<uint16_t>(nibbles(q[0], q[2]) | (nibbles(q[1], q[3]) << 8));
    if (lane == 0) *scale = __float2bfloat16_rn(s);
  }
};

// Where slot n's row for KV head h lands at position pos, in rows of the
// layer slice (values at row x kRowBytes, the scale at row), or -1 to drop.
struct PoolAddr {  // [P, Hkv, page, ...] through the block table [N, MaxP]
  const int* table;
  int maxp, pool, page;

  __device__ long long row(int n, int h, int hkv, int pos) const {
    if (pos < 0) return -1;
    const int logical = pos / page;
    if (logical >= maxp) return -1;
    const int entry = __ldg(table + static_cast<size_t>(n) * maxp + logical);
    if (entry < 0 || entry >= pool) return -1;
    const int off = pos % page;
    return (static_cast<long long>(entry) * hkv + h) * page + off;
  }
};

struct SlotAddr {  // [N, Hkv, Smax, ...]: lane n is slot n
  int smax;

  __device__ long long row(int n, int h, int hkv, int pos) const {
    if (pos < 0 || pos >= smax) return -1;
    return (static_cast<long long>(n) * hkv + h) * smax + pos;
  }
};

struct Planes {
  uint8_t* k;              // the K and V layer slices' values
  uint8_t* v;
  bf16* ks;                // their scales (null for bf16 rows)
  bf16* vs;
  const uint32_t* k_new;   // [N, Hkv, D] bf16, as 32-bit words
  const uint32_t* v_new;
};

template <class Rows, class Addr>
__global__ void __launch_bounds__(kThreads) append_kernel(Planes p, const int* __restrict__ positions,
                                                         Addr addr, int n, int hkv) {
  const int lane = threadIdx.x & 31;
  const int nh = blockIdx.x * kWarps + (threadIdx.x >> 5);  // slot * hkv + head
  if (nh >= n * hkv) return;                                // whole warps only
  const bool is_v = blockIdx.y != 0;
  const int slot = nh / hkv, h = nh - slot * hkv;
  const int pos = __ldg(positions + slot);
  // the row goes out before the table entry comes back
  const uint2 raw = Rows::load((is_v ? p.v_new : p.k_new) + static_cast<size_t>(nh) * (kD / 2), lane);
  const long long row = addr.row(slot, h, hkv, pos);
  if (row < 0) return;                                      // the same for the whole warp
  uint8_t* values = is_v ? p.v : p.k;
  bf16* scales = is_v ? p.vs : p.ks;
  Rows::store(values + row * Rows::kRowBytes, scales + row, raw, lane);
}

template <class Rows, class Addr>
int launch(Planes planes, const void* positions, Addr addr, int n, int hkv, int d, void* stream) {
  if (d != kD || n <= 0 || hkv <= 0) return static_cast<int>(cudaErrorInvalidValue);
  // the rows' 8-byte loads and stores; refused here, before the launch, so
  // the launchers need not ask each tensor for its address
  if ((reinterpret_cast<uintptr_t>(planes.k) | reinterpret_cast<uintptr_t>(planes.v) |
       reinterpret_cast<uintptr_t>(planes.k_new) | reinterpret_cast<uintptr_t>(planes.v_new)) & 7)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n * hkv + kWarps - 1) / kWarps, 2);
  append_kernel<Rows, Addr><<<grid, kThreads, 0, s>>>(planes, static_cast<const int*>(positions), addr,
                                                      n, hkv);
  return static_cast<int>(cudaGetLastError());
}

Planes planes(void* k, void* v, void* ks, void* vs, const void* k_new, const void* v_new) {
  return {static_cast<uint8_t*>(k), static_cast<uint8_t*>(v), static_cast<bf16*>(ks),
          static_cast<bf16*>(vs), static_cast<const uint32_t*>(k_new),
          static_cast<const uint32_t*>(v_new)};
}

PoolAddr pool_addr(const void* table, int maxp, int pool, int page) {
  return {static_cast<const int*>(table), maxp, pool, page};
}

}  // namespace

extern "C" int gofr_kv_append(void* k_pool, void* v_pool, const void* k_new, const void* v_new,
                              const void* table, const void* positions, int n, int maxp,
                              int pool, int hkv, int page, int d, void* stream) {
  return launch<Bf16Rows>(planes(k_pool, v_pool, nullptr, nullptr, k_new, v_new), positions,
                          pool_addr(table, maxp, pool, page), n, hkv, d, stream);
}

extern "C" int gofr_kv_append_slot(void* k_layer, void* v_layer, const void* k_new,
                                   const void* v_new, const void* positions, int n, int hkv,
                                   int smax, int d, void* stream) {
  return launch<Bf16Rows>(planes(k_layer, v_layer, nullptr, nullptr, k_new, v_new), positions,
                          SlotAddr{smax}, n, hkv, d, stream);
}

extern "C" int gofr_kv_append_q(void* k_pool, void* v_pool, void* k_scale, void* v_scale,
                                const void* k_new, const void* v_new, const void* table,
                                const void* positions, int n, int maxp, int pool, int hkv,
                                int page, int d, void* stream) {
  return launch<Int8Rows>(planes(k_pool, v_pool, k_scale, v_scale, k_new, v_new), positions,
                          pool_addr(table, maxp, pool, page), n, hkv, d, stream);
}

extern "C" int gofr_kv_append_q4(void* k_pool, void* v_pool, void* k_scale, void* v_scale,
                                 const void* k_new, const void* v_new, const void* table,
                                 const void* positions, int n, int maxp, int pool, int hkv,
                                 int page, int d, void* stream) {
  return launch<Int4Rows>(planes(k_pool, v_pool, k_scale, v_scale, k_new, v_new), positions,
                          pool_addr(table, maxp, pool, page), n, hkv, d, stream);
}

extern "C" int gofr_kv_append_slot_q(void* k_layer, void* v_layer, void* k_scale, void* v_scale,
                                     const void* k_new, const void* v_new, const void* positions,
                                     int n, int hkv, int smax, int d, void* stream) {
  return launch<Int8Rows>(planes(k_layer, v_layer, k_scale, v_scale, k_new, v_new), positions,
                          SlotAddr{smax}, n, hkv, d, stream);
}
