// The fp32 building block of the stage and LeFF kernels on Hopper
// (sm_90a): warp-level products of fp32 operands in shared memory on the
// tensor cores, as three TF32 passes (mma.sync.m16n8k8.tf32, fp32
// accumulators in registers).
//
// Each operand is split once, as it is loaded into registers:
//   big = rna(a),  small = a - big, read by the mma as its top 19 bits
// (rna: cvt.rna.tf32.f32's rounding, done on the integer pipes, tf32_rna;
// small truncated: split_tf32), and a . b is accumulated as
// small_a big_b + big_a small_b + big_a big_b. a = big + small holds to
// 2^-21 |a| (the dropped small_a small_b term is 2^-22 |a b|). The tensor
// cores add a step's exact products into their accumulator rounding
// toward zero: an accumulator carried over a depth-K sum would lose up to
// 3 K / 8 ulps, all one way (an 8-block stage at C 512 drifted past the
// 1e-4 gate so). So each k8 step's three products (two steps' six where a
// warp's tile has one A fragment) are summed from zero on the tensor
// cores and added to the fp32 accumulator on the CUDA cores, rounding to
// nearest, as the FMA loop does: fp32's accuracy, for 4 adds a tile and
// sum. The products run
// at a third of the TF32 rate (495 / 3 TFLOP/s on an H100 SXM), against
// 67 TFLOP/s of fp32 on the CUDA cores; the split's ALU work beside each
// mma takes most of the block's issue slots (the rounding on the integer
// pipes rather than by cvt.rna.tf32 made the fp32 stage 17% faster on an
// H100). Every fp32 product of the stage kernel's attention half at C
// 64-512, head dim 16 or 32, and of the LeFF tile at C 16-512 (kernel 2
// and the stage's LeFF half) goes through it, whatever the caller's TF32
// flags say; they are torch's, not this kernel's.
//
//   warp_mma3<MT, NT, KS[, BT]>(acc, A, lda, B, ldb):
//     acc[16 MT x 8 NT] += A[16 MT x 8 KS] . B[8 KS x 8 NT]
//   A row-major (lda floats, a multiple of 4 with lda / 4 odd: ldmatrix
//   rows on distinct banks), read by ldmatrix (an 8 x 4 fp32 block is one
//   8 x 8 b16 matrix); B row-major K x N (ldb = 8 or 24 mod 32: the
//   fragment's k rows on distinct banks), or with BT stored N x K
//   row-major (ldb / 4 odd), read as 32-bit words.
//
// The accumulator layout is the m16n8 C fragment of mma_tile.cuh.
#pragma once

#include "mma_tile.cuh"

namespace uf {

// cvt.rna.tf32.f32 on the integer pipes: 0x1000 (half a TF32 ulp) added
// to the magnitude bits, the low 13 bits cleared. The same value as the
// conversion for every finite x (ties away from zero; the sign bit is
// apart), in two full-rate instructions.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small: big = rna(x), small = x - big (exact in fp32) passed as
// it is; the mma reads a TF32 operand's top 19 bits, so small enters the
// products truncated (2^-21 |x| at most, of either sign). Inf and NaN
// spread: the rounding may turn a NaN's big into -0 or Inf (0x7fffffff
// carries into the sign), but its small (x - big) is NaN, as is an Inf's
// (Inf - Inf), and NaN times anything is NaN.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(x);
  small = __float_as_uint(x - __uint_as_float(big));
}

// d += a . b for one m16n8k8 TF32 tile
__device__ __forceinline__ void mma1688(float (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a . b for one m16n8k8 TF32 tile, from zero
__device__ __forceinline__ void mma1688_0(float (&d)[4],
                                          const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.0f));
}

template <int MT, int NT, int KS, bool BT = false>
__device__ __forceinline__ void warp_mma3(float (&acc)[MT][NT][4],
                                          const float* A, int lda,
                                          const float* B, int ldb) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, t4 = lane & 3;
  // ldmatrix: lanes 0-7 rows 0-7 at column 0 (a0), 8-15 rows 8-15 (a1),
  // 16-23 rows 0-7 at column 4 (a2), 24-31 rows 8-15 at column 4 (a3)
  const float* a = A + ((lane & 7) + ((lane >> 3) & 1) * 8) * lda +
                   (lane >> 4) * 4;
  const float* b = BT ? B + gq * ldb + t4 : B + t4 * ldb + gq;
  // B's fragment of n8 tile n at k-step ks, split
  auto load_b = [&](int ks, int n, uint32_t (&bb)[2], uint32_t (&bs)[2]) {
    const float b0 = BT ? b[n * 8 * ldb + ks * 8] : b[(ks * 8) * ldb + n * 8];
    const float b1 = BT ? b[n * 8 * ldb + ks * 8 + 4]
                        : b[(ks * 8 + 4) * ldb + n * 8];
    split_tf32(b0, bb[0], bs[0]);
    split_tf32(b1, bb[1], bs[1]);
  };
  auto load_a = [&](int ks, int m, uint32_t (&ab)[4], uint32_t (&as)[4]) {
    uint32_t r[4];
    ldsm_x4(r, a + m * 16 * lda + ks * 8);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      split_tf32(__uint_as_float(r[e]), ab[e], as[e]);
  };
  // the three products of a k-step into t (from zero where `first`)
  auto mma3 = [](float (&t)[4], bool first, const uint32_t (&ab)[4],
                 const uint32_t (&as)[4], const uint32_t (&bb)[2],
                 const uint32_t (&bs)[2]) {
    if (first)
      mma1688_0(t, as, bb[0], bb[1]);
    else
      mma1688(t, as, bb[0], bb[1]);
    mma1688(t, ab, bs[0], bs[1]);
    mma1688(t, ab, bb[0], bb[1]);
  };
  // t's sum added to the accumulator, rounding to nearest
  auto add = [](float (&d)[4], const float (&t)[4]) {
#pragma unroll
    for (int e = 0; e < 4; ++e) d[e] += t[e];
  };
  // with one A fragment, KP k-steps a sum (2 where KS is even: half the
  // adds)
  constexpr int KP = MT == 1 && KS % 2 == 0 ? 2 : 1;
#pragma unroll
  for (int ks = 0; ks < KS; ks += KP) {
    if constexpr (MT == 1) {
      // the A fragments of KP k-steps; B's split a tile at a time
      uint32_t ab[KP][4], as[KP][4];
#pragma unroll
      for (int p = 0; p < KP; ++p) load_a(ks + p, 0, ab[p], as[p]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        float t[4];
#pragma unroll
        for (int p = 0; p < KP; ++p) {
          uint32_t bb[2], bs[2];
          load_b(ks + p, n, bb, bs);
          mma3(t, p == 0, ab[p], as[p], bb, bs);
        }
        add(acc[0][n], t);
      }
    } else {
      // every B fragment once, each A fragment over all of them
      uint32_t bb[NT][2], bs[NT][2];
#pragma unroll
      for (int n = 0; n < NT; ++n) load_b(ks, n, bb[n], bs[n]);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        uint32_t ab[4], as[4];
        load_a(ks, m, ab, as);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          float t[4];
          mma3(t, true, ab, as, bb[n], bs[n]);
          add(acc[m][n], t);
        }
      }
    }
  }
}

// The register-tiled FMA yardstick of the same warp product (fp32 on the
// CUDA cores): lane (gq, t4) keeps the C fragment's four values of each
// tile and reads A and B from shared memory at every k. The tile check
// (mma_check.cu) times it beside warp_mma3; no kernel body uses it.
template <int MT, int NT, int KS>
__device__ __forceinline__ void warp_fma(float (&acc)[MT][NT][4],
                                         const float* A, int lda,
                                         const float* B, int ldb) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, t4 = lane & 3;
#pragma unroll 4
  for (int k = 0; k < 8 * KS; ++k) {
    float bv[NT][2];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float2 v =
          *reinterpret_cast<const float2*>(B + k * ldb + n * 8 + 2 * t4);
      bv[n][0] = v.x;
      bv[n][1] = v.y;
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float a0 = A[(m * 16 + gq) * lda + k];
      const float a1 = A[(m * 16 + gq + 8) * lda + k];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[m][n][0] = fmaf(a0, bv[n][0], acc[m][n][0]);
        acc[m][n][1] = fmaf(a0, bv[n][1], acc[m][n][1]);
        acc[m][n][2] = fmaf(a1, bv[n][0], acc[m][n][2]);
        acc[m][n][3] = fmaf(a1, bv[n][1], acc[m][n][3]);
      }
    }
  }
}

// An fp32 row-major tile, rows x cols floats (cols a multiple of 4), from
// src (leading dim src_ld) in device memory to dst (leading dim dst_ld)
// in shared memory by 16-byte cp.async copies; all kThreads threads of
// the block call it.
__device__ __forceinline__ void cp_tile_f32(float* dst, int dst_ld,
                                            const float* src, int src_ld,
                                            int rows, int cols) {
  const int vpr = cols / 4;
  for (int i = threadIdx.x; i < rows * vpr; i += kThreads) {
    const int r = i / vpr, v = i % vpr;
    cp_async16(dst + r * dst_ld + v * 4, src + (size_t)r * src_ld + v * 4);
  }
}

}  // namespace uf
