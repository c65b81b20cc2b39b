// Shared device helpers for the Uformer Hopper kernels: dtype conversion,
// GELU, warp reductions, shared-memory carving and one block-wide matrix
// product used by every kernel body.
//
// The block product runs on the tensor cores through WMMA (16x16x16 bf16
// fragments, fp32 accumulation) for bf16 operands, and as plain FMA loops
// for fp32 operands. Those fp32 loops serve the generic bodies only
// (attention_window.cuh, leff_tile.cuh, the backward's): the fp32 stage at
// C 64-512, head dims 16 and 32, and fp32 LeFF at C 16-512 (the eval CLI's
// default dtype) run three-pass TF32 products on the tensor cores instead
// (mma_tf32.cuh, attention_f32.cuh, leff_f32.cuh). Operands may sit in
// shared or global memory; WMMA needs 32-byte aligned fragment pointers
// and leading dimensions that are multiples of 8 elements (16-bit) or 4
// (fp32 accumulators), which every caller keeps.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>
#include <type_traits>

namespace uf {

constexpr int kThreads = 512;               // 16 warps per block
constexpr int kWarps = kThreads / 32;
constexpr size_t kSmemLimit = 232448;       // 227 KB opt-in per block (sm_90)

using bf16 = __nv_bfloat16;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<bf16>(bf16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

// round a float to T and back: the value T would hold
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f<T>(from_f<T>(v));
}

// exact (erf) GELU, as torch nn.GELU
__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
}

// d/dv of the exact GELU: Phi(v) + v * phi(v)
__device__ __forceinline__ float gelu_grad(float v) {
  return 0.5f * (1.0f + erff(v * 0.70710678118654752f)) +
         v * 0.39894228040143268f * expf(-0.5f * v * v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Bump allocator over the dynamic shared memory, 128-byte aligned slices.
// The same code runs on the host to size the launch.
struct Carver {
  size_t off = 0;
  __host__ __device__ size_t take(size_t bytes) {
    size_t o = off;
    off += (bytes + 127) & ~size_t(127);
    return o;
  }
};

// LayerNorm of one row (biased variance, eps 1e-5, fp32 statistics) by one
// warp, rounded to T, then + mod (if given) and rounded again, in place.
// With `stats`, lane 0 stores the row's mean and 1/std there.
template <typename T>
__device__ void ln_row(T* row, int C, const float* ln_s, const float* ln_b,
                       bool has_ln, const T* mod_row,
                       float* stats = nullptr) {
  const int lane = threadIdx.x & 31;
  float mean = 0.f, rstd = 0.f;
  if (has_ln) {
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += to_f<T>(row[c]);
    mean = warp_sum(s) / C;
    float v = 0.f;
    for (int c = lane; c < C; c += 32) {
      float d = to_f<T>(row[c]) - mean;
      v += d * d;
    }
    rstd = 1.0f / sqrtf(warp_sum(v) / C + 1e-5f);
    if (stats != nullptr && lane == 0) {
      stats[0] = mean;
      stats[1] = rstd;
    }
  }
  for (int c = lane; c < C; c += 32) {
    float y = to_f<T>(row[c]);
    if (has_ln) y = rnd<T>((y - mean) * rstd * ln_s[c] + ln_b[c]);
    if (mod_row) y = y + to_f<T>(mod_row[c]);
    row[c] = from_f<T>(y);
  }
}

// Copy a rows x cols row-major block of device memory (leading dim
// src_ld) into shared memory (leading dim dst_ld) with 16-byte loads; all
// threads of the block call it. cols, src_ld and dst_ld are multiples of
// 16 bytes' worth of T, and both pointers are 16-byte aligned.
template <typename T>
__device__ void stage_tile(T* dst, int dst_ld, const T* src, int src_ld,
                           int rows, int cols) {
  constexpr int V = 16 / sizeof(T);
  const int vpr = cols / V;
  for (int i = threadIdx.x; i < rows * vpr; i += blockDim.x) {
    const int r = i / vpr, c = (i % vpr) * V;
    *reinterpret_cast<uint4*>(dst + (size_t)r * dst_ld + c) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * src_ld + c);
  }
}

// Zero the entries of a rows x cols tile (leading dim ld) in rows >= r0 or
// columns >= c0: the pad a WMMA product reads where its depth or width is
// rounded up to 16. All threads of the block call it; nothing to do where
// r0 >= rows and c0 >= cols.
template <typename T>
__device__ void zero_pad(T* t, int ld, int rows, int cols, int r0, int c0) {
  if (r0 >= rows && c0 >= cols) return;
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
    const int r = i / cols, c = i % cols;
    if (r >= r0 || c >= c0) t[(size_t)r * ld + c] = from_f<T>(0.f);
  }
}

// Cc[M x N] (fp32, row-major, ldc)  =  (ACCUM ? Cc : 0) + A @ B
//   A: M x K row-major (lda), or with AT the K x M row-major matrix whose
//   transpose is A;  B: K x N row-major (ldb), or with BT the N x K
//   row-major matrix whose transpose is B.
// All threads of the block call it; M, N, K are multiples of 16. NW is
// the block's number of warps, fixed at compile time (kWarps by default)
// or, with NW = 0, read from blockDim. The caller synchronises before
// reading Cc. Tiles go to the warps in turn from warp `first`, so
// products with few tiles issued back to back (q, k, v) can start on
// different warps.
template <typename T, bool BT, bool ACCUM, bool AT = false, int NW = kWarps>
__device__ void block_gemm(const T* A, int lda, const T* B, int ldb, float* Cc,
                           int ldc, int M, int N, int K, int first = 0) {
  if constexpr (std::is_same<T, bf16>::value) {
    using namespace nvcuda;
    using ALayout =
        typename std::conditional<AT, wmma::col_major, wmma::row_major>::type;
    using BLayout =
        typename std::conditional<BT, wmma::col_major, wmma::row_major>::type;
    const int nw = NW > 0 ? NW : (int)(blockDim.x >> 5);
    const int warp = ((threadIdx.x >> 5) + nw - first % nw) % nw;
    const int tn = N / 16;
    const int tiles = (M / 16) * tn;
    for (int tt = warp; tt < tiles; tt += nw) {
      const int m0 = (tt / tn) * 16, n0 = (tt % tn) * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      if (ACCUM) {
        __syncwarp();  // this warp's own earlier store of the tile
        wmma::load_matrix_sync(acc, Cc + m0 * ldc + n0, ldc,
                               wmma::mem_row_major);
      }
      else
        wmma::fill_fragment(acc, 0.0f);
      for (int k0 = 0; k0 < K; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, ALayout> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> b;
        if (AT)
          wmma::load_matrix_sync(a, A + (size_t)k0 * lda + m0, lda);
        else
          wmma::load_matrix_sync(a, A + m0 * lda + k0, lda);
        if (BT)
          wmma::load_matrix_sync(b, B + n0 * ldb + k0, ldb);
        else
          wmma::load_matrix_sync(b, B + (size_t)k0 * ldb + n0, ldb);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(Cc + m0 * ldc + n0, acc, ldc,
                              wmma::mem_row_major);
    }
  } else {
    for (int idx = threadIdx.x; idx < M * N; idx += blockDim.x) {
      const int m = idx / N, n = idx % N;
      float s = 0.f;
      for (int k = 0; k < K; ++k) {
        const T a = AT ? A[(size_t)k * lda + m] : A[(size_t)m * lda + k];
        s = fmaf(a, BT ? B[(size_t)n * ldb + k] : B[(size_t)k * ldb + n], s);
      }
      Cc[m * ldc + n] = ACCUM ? Cc[m * ldc + n] + s : s;
    }
  }
}

}  // namespace uf
