// Warp-level building blocks shared by the tensor-core kernels: cp.async
// staging, ldmatrix and mma.sync wrappers, and the (value, column) order of
// the tile-local top-k.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace sm90 {

// 16 bytes global -> shared, bypassing L1; src_bytes = 0 writes zeros
// (the ragged edges of a tile or of D)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

// the same, with L2 told to fetch the 256 bytes around the source
__device__ __forceinline__ void cp_async16_l2_256(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8 x 16-byte matrices; lane l supplies the row address of matrix l / 8
__device__ __forceinline__ void ldmatrix_x4(const void* smem, uint32_t (&r)[4]) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// D += A (16 x 32 s8, row) * B (32 x 8 s8, col), exact int32 sums
__device__ __forceinline__ void mma_s8_16832(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D += A (16 x 16 bf16, row) * B (16 x 8 bf16, col), f32 accumulators
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four int8 codes (v, little-endian) as two bf16 pairs, exactly, with
// integer and bf16x2 arithmetic only (the I2F / F2F conversions run at a
// quarter of that rate): x = 16 h + l, with l the low nibble and h the
// signed high nibble; bf16 bits 0x4300 | l are 128 + l, bits
// 0x4500 | (h ^ 8) are 2048 + 16 (h + 8), and (128 + l) + ((2048 +
// 16 (h + 8)) - 2304) = x, each step exact (every intermediate has at most
// 8 significant bits).  lo gets bytes 0, 1; hi bytes 2, 3.
__device__ __forceinline__ void s8x4_to_bf16x2(uint32_t v, uint32_t& lo, uint32_t& hi) {
  const __nv_bfloat162 c2304 = __halves2bfloat162(__ushort_as_bfloat16(0x4510),
                                                  __ushort_as_bfloat16(0x4510));
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const uint32_t w = __byte_perm(v, 0u, p ? 0x4342u : 0x4140u);  // [0, b_hi, 0, b_lo]
    const uint32_t l = (w & 0x000F000Fu) | 0x43004300u;
    const uint32_t h = ((w >> 4) & 0x000F000Fu) ^ 0x45084508u;
    const __nv_bfloat162 x = __hadd2(*reinterpret_cast<const __nv_bfloat162*>(&l),
                                     __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&h), c2304));
    (p ? hi : lo) = *reinterpret_cast<const uint32_t*>(&x);
  }
}

// the reference's top-k order: value descending, then lowest column first
__device__ __forceinline__ bool better(float v1, int c1, float v2, int c2) {
  return v1 > v2 || (v1 == v2 && c1 < c2);
}

// insert (v, c) into a sorted register list of KT, dropping the last;
// static indices only, so the list stays in registers
template <int KT>
__device__ __forceinline__ void list_insert(float (&lv)[KT], int (&lc)[KT], float v, int c) {
  if (!better(v, c, lv[KT - 1], lc[KT - 1])) return;
#pragma unroll
  for (int i = 0; i < KT; ++i) {
    if (better(v, c, lv[i], lc[i])) {
      const float tv = lv[i];
      const int tc = lc[i];
      lv[i] = v;
      lc[i] = c;
      v = tv;
      c = tc;
    }
  }
}

}  // namespace sm90
