// The tensor-core product the attention kernels share (mma.sync, sm_80 and
// later): one warp multiplies a 16 x 16 bf16 A tile by a 16 x 8 bf16 B tile
// into a 16 x 8 f32 accumulator. Fragment layouts, with quad = lane / 4 and
// c = lane % 4 (PTX ISA, "mma.m16n8k16"):
//   a[0]: A[quad][2c, 2c+1]    a[1]: A[quad+8][2c, 2c+1]
//   a[2]: A[quad][2c+8, 2c+9]  a[3]: A[quad+8][2c+8, 2c+9]
//   b0:   B[2c, 2c+1][quad]    b1:   B[2c+8, 2c+9][quad]
//   d[0], d[1]: D[quad][2c, 2c+1]  d[2], d[3]: D[quad+8][2c, 2c+1]
// Each register holds two bf16, the lower index in the low half.
//
// ldmatrix loads four 8 x 8 bf16 matrices from shared memory, lanes 8i..8i+7
// giving the addresses of matrix i's eight 16-byte rows; register i of every
// lane receives matrix i in the fragment layout above (.trans: transposed,
// so rows [t][d] in memory arrive as B fragments with k = t).
#pragma once

#include <cstdint>

#include "async_copy.cuh"

namespace gofr {

// d += a (16 x 16, row-major) * b (16 x 8, column-major), bf16 in, f32 out.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

}  // namespace gofr
