// Per-step KV append, in place: one new K row and one new V row per (slot,
// KV head) written into the layer's cache at the slot's position, in any of
// the five cache formats, by one template over a row policy and an address
// policy:
//
//   kernel   entry point                 rows           cache
//   B        gofr_kv_append              Bf16Rows<128>  PoolAddr  bf16 paged pool
//   G        gofr_kv_append_slot         Bf16Rows<128>  SlotAddr  bf16 slot cache
//   B (64)   gofr_kv_append_d64          Bf16Rows<64>   PoolAddr  bf16 pool, head dim 64
//   G (64)   gofr_kv_append_slot_d64     Bf16Rows<64>   SlotAddr  bf16 slot cache, head dim 64
//   B-q      gofr_kv_append_q            Int8Rows<128>  PoolAddr  int8 paged pool
//   B-q4     gofr_kv_append_q4           Int4Rows<128>  PoolAddr  packed int4 paged pool
//   G-q      gofr_kv_append_slot_q       Int8Rows<128>  SlotAddr  int8 slot cache
//   B-q (64) gofr_kv_append_q_d64        Int8Rows<64>   PoolAddr  int8 pool, head dim 64
//   B-q4(64) gofr_kv_append_q4_d64       Int4Rows<64>   PoolAddr  int4 pool, head dim 64
//   G-q (64) gofr_kv_append_slot_q_d64   Int8Rows<64>   SlotAddr  int8 slot cache, head dim 64
//   G (f32)  gofr_kv_append_slot_f32     F32Rows<128>   SlotAddr  f32 slot cache
//   G (f32, 64) gofr_kv_append_slot_d64_f32 F32Rows<64> SlotAddr  f32 slot cache, head dim 64
//   B (f32)  gofr_kv_append_f32          F32Rows<128>   PoolAddr  f32 paged pool
//   B (f32, 64) gofr_kv_append_d64_f32   F32Rows<64>    PoolAddr  f32 pool, head dim 64
//   B-q (f32)   gofr_kv_append_q_f32     Int8Rows<128, F32Rows<128>>  PoolAddr  int8 pool, f32 rows
//   B-q (f32, 64) gofr_kv_append_q_d64_f32 Int8Rows<64, F32Rows<64>>  PoolAddr  the same at 64
//   B-q4 (f32)  gofr_kv_append_q4_f32    Int4Rows<128, F32Rows<128>>  PoolAddr  int4 pool, f32 rows
//   B-q4 (f32, 64) gofr_kv_append_q4_d64_f32 Int4Rows<64, F32Rows<64>> PoolAddr the same at 64
//   G-q (f32)   gofr_kv_append_slot_q_f32 Int8Rows<128, F32Rows<128>> SlotAddr  int8 slot cache, f32 rows
//   G-q (f32, 64) gofr_kv_append_slot_q_d64_f32 Int8Rows<64, F32Rows<64>> SlotAddr the same at 64
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
//     No shared memory. A 64-wide bf16 row (GPT-2, Llama one_b) is 128 B:
//     one 4-byte word a lane, loaded and stored as it is (Bf16Rows<64>). An
//     f32 row (F32Rows: the f32 models, GPT-2 small in its own dtype) is
//     512 B at 128, one 16-byte load and store a lane, and 256 B at 64, one
//     8-byte load and store a lane; its bits are copied as they are, into
//     the f32 slot cache (G) or the f32 pool (B). The
//     quantizing rows at 64 keep all 32 lanes on the row: an int8 lane
//     quantizes elements 2l, 2l + 1 (one 4-byte load) into a 2-byte store,
//     an int4 lane elements l and 32 + l (two 2-byte loads, the pair one
//     packed byte holds) into a 1-byte store, so the warp's max covers the
//     whole row and every lane writes its part of the 64- or 32-byte row.
//   - The quantizing rows take their input through a row policy of their
//     own (Int8Rows' and Int4Rows' second parameter): bf16 rows (Bf16Rows,
//     the bf16 models), or f32 rows (F32Rows, an f32 model on the int8
//     pool, the int4 pool or the int8 slot cache: B-q, B-q4 and G-q on f32
//     rows), the same elements a lane, so the quantization, already f32
//     math, sees the row's own f32 values. An int8 lane loads f32 rows as
//     G's f32 rows are loaded; an int4 lane loads the two halves its packed
//     bytes pair (In::halves): at 128 elements 2l, 2l + 1 and 64 + 2l,
//     65 + 2l, two 8-byte loads of f32 (two 4-byte loads of bf16), at 64
//     elements l and 32 + l, two 4-byte loads (two 2-byte loads). The
//     scales stay bf16, as on the JAX package's quantized caches.
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
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

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

// Symmetric per-row quantization to +-kMax of the lane's N elements x (4 at
// head dim 128, 2 at 64; every lane of the warp holds part of the row): the
// codes q and (from every lane) the row's f32 scale.
template <int kMax, int N>
__device__ __forceinline__ float quantize(const float (&x)[N], int (&q)[N]) {
  float a = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) a = fmaxf(a, fabsf(x[i]));
  const float s = fmaxf(warp_amax(a), 1e-8f) / static_cast<float>(kMax);
#pragma unroll
  for (int i = 0; i < N; ++i) q[i] = min(max(__float2int_rn(x[i] / s), -kMax), kMax);
  return s;
}

__device__ __forceinline__ uint32_t nibbles(int lo, int hi) {
  return static_cast<uint32_t>(lo + kBias) | (static_cast<uint32_t>(hi + kBias) << 4);
}

// What every row policy names besides load and store: the head dim kD, the
// stored row's bytes kRowBytes, the new row's 32-bit words kInWords, the
// alignment kAlign its loads and stores need (the launcher's check) and the
// register type Raw that a lane carries from the load to the store.
//
// bf16 rows (kernels B, G) of head dim D: the 16-bit patterns copied as
// they are, lane l elements 4l .. 4l + 3 at D 128 (one 8-byte word), 2l,
// 2l + 1 at D 64 (one 4-byte word, in raw.x).
template <int D>
struct Bf16Rows {
  static_assert(D == 128 || D == 64, "built at head dims 128 and 64");
  using Raw = uint2;
  static constexpr int kD = D;
  static constexpr int kRowBytes = kD * 2;
  static constexpr int kInWords = kD / 2;
  static constexpr int kAlign = 8;

  __device__ static uint2 load(const uint32_t* row, int lane) {
    if constexpr (kD == 128) return __ldg(reinterpret_cast<const uint2*>(row) + lane);
    else return make_uint2(__ldg(row + lane), 0u);
  }

  __device__ static void store(uint8_t* dst, bf16*, uint2 raw, int lane) {
    if constexpr (kD == 128) reinterpret_cast<uint2*>(dst)[lane] = raw;
    else reinterpret_cast<uint32_t*>(dst)[lane] = raw.x;
  }

  // the lane's elements (4 at 128, 2 at 64, raw.x's low half first) as f32
  template <int N>
  __device__ static void unpack(uint2 raw, float (&x)[N]) {
    x[0] = lo_bf16(raw.x);
    x[1] = hi_bf16(raw.x);
    if constexpr (N == 4) {
      x[2] = lo_bf16(raw.y);
      x[3] = hi_bf16(raw.y);
    }
  }

  // An int4 lane's elements, in unpack's order: 2l, 2l + 1 (word l) and
  // 64 + 2l, 65 + 2l (word 32 + l) at 128; l and 32 + l at 64 (raw.x).
  __device__ static uint2 halves(const uint32_t* row, int lane) {
    if constexpr (kD == 128) {
      return make_uint2(__ldg(row + lane), __ldg(row + kD / 4 + lane));
    } else {
      const unsigned short* half = reinterpret_cast<const unsigned short*>(row);
      return make_uint2(static_cast<uint32_t>(__ldg(half + lane)) |
                            (static_cast<uint32_t>(__ldg(half + kD / 2 + lane)) << 16),
                        0u);
    }
  }
};

// f32 rows (kernel G on an f32 slot cache, B on an f32 pool) of head dim
// D: the 32-bit patterns copied as they are, lane l elements 4l .. 4l + 3
// at D 128 (one 16-byte word), 2l, 2l + 1 at D 64 (one 8-byte word).
template <int D>
struct F32Rows {
  static_assert(D == 128 || D == 64, "built at head dims 128 and 64");
  using Raw = std::conditional_t<D == 128, uint4, uint2>;
  static constexpr int kD = D;
  static constexpr int kRowBytes = kD * 4;
  static constexpr int kInWords = kD;
  static constexpr int kAlign = sizeof(Raw);

  __device__ static Raw load(const uint32_t* row, int lane) {
    return __ldg(reinterpret_cast<const Raw*>(row) + lane);
  }

  __device__ static void store(uint8_t* dst, bf16*, Raw raw, int lane) {
    reinterpret_cast<Raw*>(dst)[lane] = raw;
  }

  // the lane's elements as f32, as they are (N: 4 at 128, 2 at 64)
  template <int N>
  __device__ static void unpack(Raw raw, float (&x)[N]) {
    x[0] = __uint_as_float(raw.x);
    x[1] = __uint_as_float(raw.y);
    if constexpr (N == 4) {
      x[2] = __uint_as_float(raw.z);
      x[3] = __uint_as_float(raw.w);
    }
  }

  // An int4 lane's elements, in unpack's order: 2l, 2l + 1 and 64 + 2l,
  // 65 + 2l at 128 (two 8-byte loads); l and 32 + l at 64 (two 4-byte loads,
  // in raw.x and raw.y).
  __device__ static Raw halves(const uint32_t* row, int lane) {
    if constexpr (kD == 128) {
      const uint2* pairs = reinterpret_cast<const uint2*>(row);
      const uint2 lo = __ldg(pairs + lane), hi = __ldg(pairs + kD / 4 + lane);
      return make_uint4(lo.x, lo.y, hi.x, hi.y);
    } else {
      return make_uint2(__ldg(row + lane), __ldg(row + kD / 2 + lane));
    }
  }
};

// int8 rows with one bf16 scale (kernels B-q, G-q) of head dim D: lane l
// quantizes its input rows' elements (In: Bf16Rows<D> or F32Rows<D>; 4l ..
// 4l + 3 at 128, 2l, 2l + 1 at 64) into the bytes of the same index, a 4-
// or 2-byte store.
template <int D, class In = Bf16Rows<D>>
struct Int8Rows {
  using Raw = typename In::Raw;
  static constexpr int kD = D;
  static constexpr int kRowBytes = kD;
  static constexpr int kInWords = In::kInWords;
  static constexpr int kAlign = In::kAlign;
  static constexpr int kPerLane = kD / 32;

  __device__ static Raw load(const uint32_t* row, int lane) { return In::load(row, lane); }

  __device__ static void store(uint8_t* dst, bf16* scale, Raw raw, int lane) {
    float x[kPerLane];
    int q[kPerLane];
    In::unpack(raw, x);
    const float s = quantize<127>(x, q);
    uint32_t bytes = 0;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) bytes |= static_cast<uint32_t>(q[i] & 0xFF) << (8 * i);
    if constexpr (kPerLane == 4) reinterpret_cast<uint32_t*>(dst)[lane] = bytes;
    else reinterpret_cast<uint16_t*>(dst)[lane] = static_cast<uint16_t>(bytes);
    if (lane == 0) *scale = __float2bfloat16_rn(s);
  }
};

// packed int4 rows with one bf16 scale (kernel B-q4) of head dim D,
// split-half (byte j holds elements j and j + D/2). At 128 lane l holds
// elements 2l, 2l + 1 and 64 + 2l, 65 + 2l of its input rows (In: Bf16Rows<D>
// or F32Rows<D>, loaded by In::halves) and writes packed bytes 2l and
// 2l + 1; at 64 it holds elements l and 32 + l and writes packed byte l.
// kAlign is 8 for either input: the f32 rows' 8-byte loads at 128 (the
// other loads take 4 bytes or fewer).
template <int D, class In = Bf16Rows<D>>
struct Int4Rows {
  static_assert(D == 128 || D == 64, "built at head dims 128 and 64");
  using Raw = typename In::Raw;
  static constexpr int kD = D;
  static constexpr int kRowBytes = kD / 2;
  static constexpr int kInWords = In::kInWords;
  static constexpr int kAlign = 8;
  static constexpr int kPerLane = kD / 32;

  __device__ static Raw load(const uint32_t* row, int lane) { return In::halves(row, lane); }

  __device__ static void store(uint8_t* dst, bf16* scale, Raw raw, int lane) {
    float x[kPerLane];
    int q[kPerLane];
    In::unpack(raw, x);
    const float s = quantize<7>(x, q);
    if constexpr (kPerLane == 4)
      reinterpret_cast<uint16_t*>(dst)[lane] =
          static_cast<uint16_t>(nibbles(q[0], q[2]) | (nibbles(q[1], q[3]) << 8));
    else
      dst[lane] = static_cast<uint8_t>(nibbles(q[0], q[1]));
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
  const uint32_t* k_new;   // [N, Hkv, D] bf16 (f32 for F32Rows and the quantizing rows' F32Rows input), as 32-bit words
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
  const typename Rows::Raw raw =
      Rows::load((is_v ? p.v_new : p.k_new) + static_cast<size_t>(nh) * Rows::kInWords, lane);
  const long long row = addr.row(slot, h, hkv, pos);
  if (row < 0) return;                                      // the same for the whole warp
  uint8_t* values = is_v ? p.v : p.k;
  bf16* scales = is_v ? p.vs : p.ks;
  Rows::store(values + row * Rows::kRowBytes, scales + row, raw, lane);
}

template <class Rows, class Addr>
int launch(Planes planes, const void* positions, Addr addr, int n, int hkv, int d, void* stream) {
  if (d != Rows::kD || n <= 0 || hkv <= 0) return static_cast<int>(cudaErrorInvalidValue);
  // the rows' 8- or 16-byte loads and stores; refused here, before the
  // launch, so the launchers need not ask each tensor for its address
  if ((reinterpret_cast<uintptr_t>(planes.k) | reinterpret_cast<uintptr_t>(planes.v) |
       reinterpret_cast<uintptr_t>(planes.k_new) | reinterpret_cast<uintptr_t>(planes.v_new)) &
      (Rows::kAlign - 1))
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
  return launch<Bf16Rows<128>>(planes(k_pool, v_pool, nullptr, nullptr, k_new, v_new), positions,
                               pool_addr(table, maxp, pool, page), n, hkv, d, stream);
}

extern "C" int gofr_kv_append_slot(void* k_layer, void* v_layer, const void* k_new,
                                   const void* v_new, const void* positions, int n, int hkv,
                                   int smax, int d, void* stream) {
  return launch<Bf16Rows<128>>(planes(k_layer, v_layer, nullptr, nullptr, k_new, v_new), positions,
                               SlotAddr{smax}, n, hkv, d, stream);
}

// B and G at head dim 64 (GPT-2's slot cache, Llama one_b's pool)
extern "C" int gofr_kv_append_d64(void* k_pool, void* v_pool, const void* k_new,
                                  const void* v_new, const void* table, const void* positions,
                                  int n, int maxp, int pool, int hkv, int page, int d,
                                  void* stream) {
  return launch<Bf16Rows<64>>(planes(k_pool, v_pool, nullptr, nullptr, k_new, v_new), positions,
                              pool_addr(table, maxp, pool, page), n, hkv, d, stream);
}

extern "C" int gofr_kv_append_slot_d64(void* k_layer, void* v_layer, const void* k_new,
                                       const void* v_new, const void* positions, int n, int hkv,
                                       int smax, int d, void* stream) {
  return launch<Bf16Rows<64>>(planes(k_layer, v_layer, nullptr, nullptr, k_new, v_new), positions,
                              SlotAddr{smax}, n, hkv, d, stream);
}

// G on the f32 slot cache (the f32 models: GPT-2 small in its own dtype,
// Llama at 128)
extern "C" int gofr_kv_append_slot_f32(void* k_layer, void* v_layer, const void* k_new,
                                       const void* v_new, const void* positions, int n, int hkv,
                                       int smax, int d, void* stream) {
  return launch<F32Rows<128>>(planes(k_layer, v_layer, nullptr, nullptr, k_new, v_new), positions,
                              SlotAddr{smax}, n, hkv, d, stream);
}

extern "C" int gofr_kv_append_slot_d64_f32(void* k_layer, void* v_layer, const void* k_new,
                                           const void* v_new, const void* positions, int n,
                                           int hkv, int smax, int d, void* stream) {
  return launch<F32Rows<64>>(planes(k_layer, v_layer, nullptr, nullptr, k_new, v_new), positions,
                             SlotAddr{smax}, n, hkv, d, stream);
}

// B on the f32 pool (an f32 Llama on kv_layout="paged")
extern "C" int gofr_kv_append_f32(void* k_pool, void* v_pool, const void* k_new, const void* v_new,
                                  const void* table, const void* positions, int n, int maxp,
                                  int pool, int hkv, int page, int d, void* stream) {
  return launch<F32Rows<128>>(planes(k_pool, v_pool, nullptr, nullptr, k_new, v_new), positions,
                              pool_addr(table, maxp, pool, page), n, hkv, d, stream);
}

extern "C" int gofr_kv_append_d64_f32(void* k_pool, void* v_pool, const void* k_new,
                                      const void* v_new, const void* table, const void* positions,
                                      int n, int maxp, int pool, int hkv, int page, int d,
                                      void* stream) {
  return launch<F32Rows<64>>(planes(k_pool, v_pool, nullptr, nullptr, k_new, v_new), positions,
                             pool_addr(table, maxp, pool, page), n, hkv, d, stream);
}

extern "C" int gofr_kv_append_q(void* k_pool, void* v_pool, void* k_scale, void* v_scale,
                                const void* k_new, const void* v_new, const void* table,
                                const void* positions, int n, int maxp, int pool, int hkv,
                                int page, int d, void* stream) {
  return launch<Int8Rows<128>>(planes(k_pool, v_pool, k_scale, v_scale, k_new, v_new), positions,
                               pool_addr(table, maxp, pool, page), n, hkv, d, stream);
}

extern "C" int gofr_kv_append_q4(void* k_pool, void* v_pool, void* k_scale, void* v_scale,
                                 const void* k_new, const void* v_new, const void* table,
                                 const void* positions, int n, int maxp, int pool, int hkv,
                                 int page, int d, void* stream) {
  return launch<Int4Rows<128>>(planes(k_pool, v_pool, k_scale, v_scale, k_new, v_new), positions,
                               pool_addr(table, maxp, pool, page), n, hkv, d, stream);
}

extern "C" int gofr_kv_append_slot_q(void* k_layer, void* v_layer, void* k_scale, void* v_scale,
                                     const void* k_new, const void* v_new, const void* positions,
                                     int n, int hkv, int smax, int d, void* stream) {
  return launch<Int8Rows<128>>(planes(k_layer, v_layer, k_scale, v_scale, k_new, v_new), positions,
                               SlotAddr{smax}, n, hkv, d, stream);
}

// B-q, B-q4 and G-q at head dim 64 (Llama one_b's int8 and int4 pools and
// int8 slot cache)
extern "C" int gofr_kv_append_q_d64(void* k_pool, void* v_pool, void* k_scale, void* v_scale,
                                    const void* k_new, const void* v_new, const void* table,
                                    const void* positions, int n, int maxp, int pool, int hkv,
                                    int page, int d, void* stream) {
  return launch<Int8Rows<64>>(planes(k_pool, v_pool, k_scale, v_scale, k_new, v_new), positions,
                              pool_addr(table, maxp, pool, page), n, hkv, d, stream);
}

extern "C" int gofr_kv_append_q4_d64(void* k_pool, void* v_pool, void* k_scale, void* v_scale,
                                     const void* k_new, const void* v_new, const void* table,
                                     const void* positions, int n, int maxp, int pool, int hkv,
                                     int page, int d, void* stream) {
  return launch<Int4Rows<64>>(planes(k_pool, v_pool, k_scale, v_scale, k_new, v_new), positions,
                              pool_addr(table, maxp, pool, page), n, hkv, d, stream);
}

extern "C" int gofr_kv_append_slot_q_d64(void* k_layer, void* v_layer, void* k_scale,
                                         void* v_scale, const void* k_new, const void* v_new,
                                         const void* positions, int n, int hkv, int smax, int d,
                                         void* stream) {
  return launch<Int8Rows<64>>(planes(k_layer, v_layer, k_scale, v_scale, k_new, v_new), positions,
                              SlotAddr{smax}, n, hkv, d, stream);
}

// B-q on f32 rows (an f32 Llama on the int8 pool), head dims 128 and 64
extern "C" int gofr_kv_append_q_f32(void* k_pool, void* v_pool, void* k_scale, void* v_scale,
                                    const void* k_new, const void* v_new, const void* table,
                                    const void* positions, int n, int maxp, int pool, int hkv,
                                    int page, int d, void* stream) {
  return launch<Int8Rows<128, F32Rows<128>>>(planes(k_pool, v_pool, k_scale, v_scale, k_new, v_new),
                                             positions, pool_addr(table, maxp, pool, page), n, hkv,
                                             d, stream);
}

extern "C" int gofr_kv_append_q_d64_f32(void* k_pool, void* v_pool, void* k_scale, void* v_scale,
                                        const void* k_new, const void* v_new, const void* table,
                                        const void* positions, int n, int maxp, int pool, int hkv,
                                        int page, int d, void* stream) {
  return launch<Int8Rows<64, F32Rows<64>>>(planes(k_pool, v_pool, k_scale, v_scale, k_new, v_new),
                                           positions, pool_addr(table, maxp, pool, page), n, hkv,
                                           d, stream);
}

// B-q4 on f32 rows (an f32 Llama on the int4 pool), head dims 128 and 64
extern "C" int gofr_kv_append_q4_f32(void* k_pool, void* v_pool, void* k_scale, void* v_scale,
                                     const void* k_new, const void* v_new, const void* table,
                                     const void* positions, int n, int maxp, int pool, int hkv,
                                     int page, int d, void* stream) {
  return launch<Int4Rows<128, F32Rows<128>>>(planes(k_pool, v_pool, k_scale, v_scale, k_new, v_new),
                                             positions, pool_addr(table, maxp, pool, page), n, hkv,
                                             d, stream);
}

extern "C" int gofr_kv_append_q4_d64_f32(void* k_pool, void* v_pool, void* k_scale, void* v_scale,
                                         const void* k_new, const void* v_new, const void* table,
                                         const void* positions, int n, int maxp, int pool, int hkv,
                                         int page, int d, void* stream) {
  return launch<Int4Rows<64, F32Rows<64>>>(planes(k_pool, v_pool, k_scale, v_scale, k_new, v_new),
                                           positions, pool_addr(table, maxp, pool, page), n, hkv,
                                           d, stream);
}

// G-q on f32 rows (an f32 Llama on the int8 slot cache), head dims 128 and 64
extern "C" int gofr_kv_append_slot_q_f32(void* k_layer, void* v_layer, void* k_scale,
                                         void* v_scale, const void* k_new, const void* v_new,
                                         const void* positions, int n, int hkv, int smax, int d,
                                         void* stream) {
  return launch<Int8Rows<128, F32Rows<128>>>(
      planes(k_layer, v_layer, k_scale, v_scale, k_new, v_new), positions, SlotAddr{smax}, n, hkv,
      d, stream);
}

extern "C" int gofr_kv_append_slot_q_d64_f32(void* k_layer, void* v_layer, void* k_scale,
                                             void* v_scale, const void* k_new, const void* v_new,
                                             const void* positions, int n, int hkv, int smax,
                                             int d, void* stream) {
  return launch<Int8Rows<64, F32Rows<64>>>(planes(k_layer, v_layer, k_scale, v_scale, k_new, v_new),
                                           positions, SlotAddr{smax}, n, hkv, d, stream);
}
