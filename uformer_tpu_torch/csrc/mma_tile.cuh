// The tensor-core building block of the LeFF and stage kernels on Hopper
// (sm_90a): warp-level mma.sync.m16n8k16 products (bf16 in, fp32
// accumulators in registers) on operands in shared memory, fed by
// cp.async 16-byte copies that run while earlier products are computed.
//
//   warp_mma<MT, NT, KS[, AT, BT]>(acc, A, lda, B, ldb):
//     acc[16 MT x 8 NT] += A[16 MT x 16 KS] . B[16 KS x 8 NT]
//   A row-major (lda elements), B row-major K x N (ldb elements), both
//   bf16 in shared memory, rows 16-byte aligned. A comes in by ldmatrix,
//   B by ldmatrix.trans (the weights are stored (in, out), K x N). With
//   AT, A is stored as its transpose (K x M row-major: A^T of a product
//   over token rows) and comes in by ldmatrix.trans; with BT, B is stored
//   N x K row-major (a weight used transposed) and comes in by ldmatrix.
//   A row stride of 2 (n + 8) bytes with n a multiple of 64 puts the eight
//   rows of an ldmatrix phase on distinct banks.
//
// The accumulator of the n8 tile j of the m16 tile i: acc[i][j][0..1] at
// row lane / 4, columns 2 (lane % 4) + {0, 1}; acc[i][j][2..3] at row
// lane / 4 + 8, the same columns (the PTX ISA's m16n8 C fragment).
#pragma once

#include <cstdint>

#include "common.cuh"

namespace uf {

// a compile-time shared-memory layout's slices are 128-byte aligned
__host__ __device__ constexpr size_t align128(size_t bytes) {
  return (bytes + 127) & ~size_t(127);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without passing through registers; with
// `valid` false the 16 bytes are zero-filled and src is not read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}

// d += a . b for one m16n8k16 tile
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int MT, int NT, int KS, bool AT = false, bool BT = false>
__device__ __forceinline__ void warp_mma(float (&acc)[MT][NT][4],
                                         const bf16* A, int lda,
                                         const bf16* B, int ldb) {
  const int lane = threadIdx.x & 31;
  // ldmatrix row addresses. Row-major A (and K x N B): lanes 0-15 rows
  // 0-15, lanes 16-31 the same rows 8 columns on (A: the k hi half; B:
  // the next n8 tile). Stored transposed (A^T, or N x K B): lane l reads
  // row (l & 7) + 8 (l >> 4) at column 8 ((l >> 3) & 1), so that the four
  // 8 x 8 matrices land in the fragment order of the row-major case.
  const int tr = (lane & 7) + ((lane >> 4) << 3), tc = ((lane >> 3) & 1) * 8;
  const int rr = lane & 15, rc = (lane >> 4) * 8;
  const bf16* a = AT ? A + tr * lda + tc : A + rr * lda + rc;
  const bf16* b = BT ? B + tr * ldb + tc : B + rr * ldb + rc;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t bf[NT][2];
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      if (n + 1 < NT) {
        uint32_t r[4];
        if (BT)
          ldsm_x4(r, b + n * 8 * ldb + ks * 16);
        else
          ldsm_x4_t(r, b + ks * 16 * ldb + n * 8);
        bf[n][0] = r[0];
        bf[n][1] = r[1];
        bf[n + 1][0] = r[2];
        bf[n + 1][1] = r[3];
      } else {
        uint32_t r[2];
        if (BT)
          ldsm_x2(r, b + n * 8 * ldb + ks * 16);
        else
          ldsm_x2_t(r, b + ks * 16 * ldb + n * 8);
        bf[n][0] = r[0];
        bf[n][1] = r[1];
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      uint32_t af[4];
      if (AT)
        ldsm_x4_t(af, a + ks * 16 * lda + m * 16);
      else
        ldsm_x4(af, a + m * 16 * lda + ks * 16);
#pragma unroll
      for (int n = 0; n < NT; ++n) mma16816(acc[m][n], af, bf[n][0], bf[n][1]);
    }
  }
}

template <int MT, int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace uf
