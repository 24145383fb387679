// Per-step KV append, in place: into the paged pool (kv_append_kernel) and
// into the slot cache (kv_append_slot_kernel).
//
// Replaces gofr_tpu/ops/pallas/kv_append.py append_tokens_paged_inplace
// (:110, pallas_call :160) and append_tokens_inplace (:61, pallas_call :80,
// body _append_kernel :45).
//
// What bounds it on the card: device-memory bytes, and at these sizes the
// launch itself. A step writes one [Hkv, D] row of K and of V per slot
// (8 slots x 8 heads x 128 x 2 B x 2 = 32 KiB for Llama-3-8B) and reads as
// much; no arithmetic.
//
// Design: one block per slot, threads over Hkv x D, each element copied as
// its 16-bit pattern so the pool row equals the new row bit for bit. The
// block reads its own table entry. The store is skipped when pos < 0, when
// pos // page >= MaxP, or when the entry is not a pool page (the OOB id P);
// every other byte of the pool is left untouched.
//
// The TPU kernel needed a reserved sink page 0: Mosaic's pipeline copied a
// whole page tile through VMEM and back, so an OOB row's tile had to land on
// a page no real row wrote in the same call (kv_append.py:120-130). This
// kernel copies nothing back — it stores only the new row — so it needs no
// sink page and every pool page is allocatable.
//
// The slot append has the same design: block n writes slot n's new row at
// ((n * Hkv + h) * Smax + pos) * D + j, and stores nothing when pos < 0 or
// pos >= Smax (the engine's idle lanes sit at Smax and past it). The TPU
// kernel copied the row's whole [block_s, D] tile through VMEM and back;
// this one stores the row alone.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) kv_append_kernel(
    uint16_t* __restrict__ k_pool,        // [P, Hkv, page, D] (16-bit elements)
    uint16_t* __restrict__ v_pool,
    const uint16_t* __restrict__ k_new,   // [N, Hkv, D]
    const uint16_t* __restrict__ v_new,
    const int* __restrict__ table,        // [N, MaxP]
    const int* __restrict__ positions,    // [N]
    int maxp, int pool, int hkv, int page, int d) {
  const int n = blockIdx.x;
  const int pos = positions[n];
  if (pos < 0) return;
  const int logical = pos / page;
  if (logical >= maxp) return;
  const int entry = table[(size_t)n * maxp + logical];
  if (entry < 0 || entry >= pool) return;
  const int off = pos % page;
  const int row = hkv * d;
  for (int i = threadIdx.x; i < row; i += kThreads) {
    const int h = i / d, j = i % d;
    const size_t dst = (((size_t)entry * hkv + h) * page + off) * d + j;
    k_pool[dst] = k_new[(size_t)n * row + i];
    v_pool[dst] = v_new[(size_t)n * row + i];
  }
}

__global__ void __launch_bounds__(kThreads) kv_append_slot_kernel(
    uint16_t* __restrict__ k_layer,       // [N, Hkv, Smax, D] (16-bit elements)
    uint16_t* __restrict__ v_layer,
    const uint16_t* __restrict__ k_new,   // [N, Hkv, D]
    const uint16_t* __restrict__ v_new,
    const int* __restrict__ positions,    // [N]
    int hkv, int smax, int d) {
  const int n = blockIdx.x;
  const int pos = positions[n];
  if (pos < 0 || pos >= smax) return;
  const int row = hkv * d;
  for (int i = threadIdx.x; i < row; i += kThreads) {
    const int h = i / d, j = i % d;
    const size_t dst = (((size_t)n * hkv + h) * smax + pos) * d + j;
    k_layer[dst] = k_new[(size_t)n * row + i];
    v_layer[dst] = v_new[(size_t)n * row + i];
  }
}

}  // namespace

extern "C" int gofr_kv_append(void* k_pool, void* v_pool, const void* k_new, const void* v_new,
                              const void* table, const void* positions, int n, int maxp,
                              int pool, int hkv, int page, int d, void* stream) {
  kv_append_kernel<<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint16_t*>(k_pool), static_cast<uint16_t*>(v_pool),
      static_cast<const uint16_t*>(k_new), static_cast<const uint16_t*>(v_new),
      static_cast<const int*>(table), static_cast<const int*>(positions),
      maxp, pool, hkv, page, d);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gofr_kv_append_slot(void* k_layer, void* v_layer, const void* k_new,
                                   const void* v_new, const void* positions, int n, int hkv,
                                   int smax, int d, void* stream) {
  kv_append_slot_kernel<<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint16_t*>(k_layer), static_cast<uint16_t*>(v_layer),
      static_cast<const uint16_t*>(k_new), static_cast<const uint16_t*>(v_new),
      static_cast<const int*>(positions), hkv, smax, d);
  return static_cast<int>(cudaGetLastError());
}
