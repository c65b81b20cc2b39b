// Weight-gradient reductions shared by the backward kernels.
//
// The backward kernels (leff_bwd.cu, attention_bwd.cu) write, per token,
// the two operands of each weight gradient (the layer input and the
// gradient of its output) and, per tile, small partial sums. These kernels
// reduce them over every token of the batch:
//
//   wgrad:  dW (K1 x N, fp32) = A^T B over M token rows, A (M x K1) and
//           B (M x N) in the activation dtype. The rows are split into S
//           fixed ranges; each block forms one 128 x 128 tile of one
//           range's product (WMMA bf16 -> fp32, or fp32 FMA), and the S
//           partial products are summed by colsum in order.
//   colsum: out (K, fp32) = the sum of the R rows of a (R x K) matrix, in
//           S fixed row segments and then over the segments.
//
// Every sum runs in a fixed order, so a run is bitwise repeatable (no
// atomics). What bounds them on the H100: wgrad reads 2 x M x 128 values
// per 128 x 128 tile and range, so at K1, N <= 128 it is bound by device
// memory; at C = 512 it is 64 MACs per value read, tensor-core work fed
// through shared memory. colsum is one pass over its input.
#pragma once

#include "common.cuh"

namespace uf {

constexpr int kWTile = 128, kWld = kWTile + 8;  // output tile, its ld
// token rows staged per step: 64 in bf16, 32 in fp32 (36 KB either way)
template <typename T> constexpr int kWRows = 128 / sizeof(T);

// stage rows [m0, m0 + kWRows) x cols [c0, c0 + kWTile) of a row-major
// matrix, zero beyond `cols` (a multiple of 16 bytes' worth)
template <typename T>
__device__ void wgrad_stage(T* dst, const T* src, int ld, int m0, int c0,
                            int cols) {
  constexpr int V = 16 / sizeof(T);
  constexpr int vpr = kWTile / V;
  for (int i = threadIdx.x; i < kWRows<T> * vpr; i += blockDim.x) {
    const int r = i / vpr, c = (i % vpr) * V;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (c0 + c < cols)
      v = *reinterpret_cast<const uint4*>(src + (size_t)(m0 + r) * ld + c0 +
                                          c);
    *reinterpret_cast<uint4*>(dst + r * kWld + c) = v;
  }
}

// grid (ceil(N/128), ceil(K1/128), S); out is (S, K1, N) fp32. M is a
// multiple of 64 and so is `rows` (the rows of one range); K1 and N are
// multiples of 16; lda, ldb multiples of 8. In bf16 each warp keeps a
// 32 x 32 corner of the 128 x 128 tile in four accumulator fragments.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    wgrad_kernel(const T* A, int lda, const T* B, int ldb, float* out, int M,
                 int K1, int N, int rows) {
  constexpr int R = kWRows<T>;
  __shared__ __align__(128) T As[R * kWld];
  __shared__ __align__(128) T Bs[R * kWld];
  const int i0 = blockIdx.y * kWTile, j0 = blockIdx.x * kWTile;
  const int r0 = blockIdx.z * rows, r1 = min(M, r0 + rows);
  out += (size_t)blockIdx.z * K1 * N;
  if constexpr (std::is_same<T, bf16>::value) {
    using namespace nvcuda;
    const int warp = threadIdx.x >> 5, ti = (warp / 4) * 32,
              tj = (warp % 4) * 32;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b) wmma::fill_fragment(acc[a][b], 0.0f);
    for (int m0 = r0; m0 < r1; m0 += R) {
      wgrad_stage<T>(As, A, lda, m0, i0, K1);
      wgrad_stage<T>(Bs, B, ldb, m0, j0, N);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < R; kk += 16) {
        // A^T tile (i, m): As holds (m, i) row-major = (i, m) col-major
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>
            fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
            fb[2];
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          wmma::load_matrix_sync(fa[a], As + kk * kWld + ti + 16 * a, kWld);
          wmma::load_matrix_sync(fb[a], Bs + kk * kWld + tj + 16 * a, kWld);
        }
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int b = 0; b < 2; ++b)
            wmma::mma_sync(acc[a][b], fa[a], fb[b], acc[a][b]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int i = i0 + ti + 16 * a, j = j0 + tj + 16 * b;
        if (i < K1 && j < N)
          wmma::store_matrix_sync(out + (size_t)i * N + j, acc[a][b], N,
                                  wmma::mem_row_major);
      }
  } else {
    // fp32 (the exact-check path): each thread 32 outputs of one row
    const int i = threadIdx.x / 4, jb = (threadIdx.x % 4) * 32;
    float acc[32];
#pragma unroll
    for (int q = 0; q < 32; ++q) acc[q] = 0.f;
    for (int m0 = r0; m0 < r1; m0 += R) {
      wgrad_stage<T>(As, A, lda, m0, i0, K1);
      wgrad_stage<T>(Bs, B, ldb, m0, j0, N);
      __syncthreads();
      for (int r = 0; r < R; ++r) {
        const float a = to_f<T>(As[r * kWld + i]);
#pragma unroll
        for (int q = 0; q < 32; ++q)
          acc[q] = fmaf(a, to_f<T>(Bs[r * kWld + jb + q]), acc[q]);
      }
      __syncthreads();
    }
    if (i0 + i < K1)
#pragma unroll
      for (int q = 0; q < 32; ++q)
        if (j0 + jb + q < N) out[(size_t)(i0 + i) * N + j0 + jb + q] = acc[q];
  }
}

// grid (ceil(K/32), S), 256 threads: out[s][k] = sum of rows
// [s * rows, min(R, (s + 1) * rows)) of column k. Each warp reads one row
// in eight (a 128-byte line per row); the eight lane sums of a column are
// then added in a fixed order.
template <typename T>
__global__ void __launch_bounds__(256)
    colsum_kernel(const T* in, int ld, float* out, int R, int K, int rows) {
  __shared__ float lanes[8][33];
  const int c = threadIdx.x % 32, lane = threadIdx.x / 32;
  const int k = blockIdx.x * 32 + c;
  const int r0 = blockIdx.y * rows, r1 = min(R, r0 + rows);
  float s = 0.f;
  if (k < K)
    for (int r = r0 + lane; r < r1; r += 8)
      s += to_f<T>(in[(size_t)r * ld + k]);
  lanes[lane][c] = s;
  __syncthreads();
  if (lane == 0 && k < K) {
    float t = 0.f;
#pragma unroll
    for (int l = 0; l < 8; ++l) t += lanes[l][c];
    out[(size_t)blockIdx.y * K + k] = t;
  }
}

}  // namespace uf
