// Weight-gradient reductions shared by the backward kernels.
//
// The backward kernels (leff_bwd.cu, attention_bwd.cu) write, per token,
// the two operands of each weight gradient (the layer input and the
// gradient of its output) and, per tile, small partial sums. These kernels
// reduce them over every token of the batch:
//
//   wgrad:  dW (K1 x N, fp32) = A^T B over M token rows, A (M x K1) and
//           B (M x N) in the activation dtype, and with it (optionally)
//           the column sums of B (a bias gradient) from the same pass over
//           B. The rows are split into S fixed ranges; each block forms one
//           128 x 128 tile of one range's product, and the S partial
//           products are summed by colsum in order.
//           bf16: mma.sync m16n8k16 with fp32 accumulators in registers
//           (mma_tile.cuh), 16 warps of 32 x 32 outputs; 64-row slices of
//           A and B arrive through a three-slot cp.async ring while earlier
//           slices are multiplied. fp32 (the exact-check path): FMA loops.
//   colsum: out (K, fp32) = the sum of the R rows of a (R x K) matrix, in
//           S fixed row segments and then over the segments.
//
// Every sum runs in a fixed order, so a run is bitwise repeatable (no
// atomics). What bounds them on the H100: wgrad reads 2 x M x 128 values
// per 128 x 128 tile and range, so at K1, N <= 128 it is bound by device
// memory; at C = 512 it is 64 MACs per value read, tensor-core work fed
// through shared memory. colsum is one pass over its input.
#pragma once

#include "mma_tile.cuh"

namespace uf {

constexpr int kWTile = 128, kWld = kWTile + 8;  // output tile, its ld
// token rows staged per step of the fp32 kernel (34 KB)
template <typename T> constexpr int kWRows = 128 / sizeof(T);

// stage rows [m0, m0 + kWRows) x cols [c0, c0 + kWTile) of a row-major
// matrix, zero at rows from r1 and beyond `cols` (a multiple of 16 bytes'
// worth)
template <typename T>
__device__ void wgrad_stage(T* dst, const T* src, int ld, int m0, int c0,
                            int cols, int r1) {
  constexpr int V = 16 / sizeof(T);
  constexpr int vpr = kWTile / V;
  for (int i = threadIdx.x; i < kWRows<T> * vpr; i += blockDim.x) {
    const int r = i / vpr, c = (i % vpr) * V;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (c0 + c < cols && m0 + r < r1)
      v = *reinterpret_cast<const uint4*>(src + (size_t)(m0 + r) * ld + c0 +
                                          c);
    *reinterpret_cast<uint4*>(dst + r * kWld + c) = v;
  }
}

// fp32 (the exact-check path): grid (ceil(N/128), ceil(K1/128), S); out
// is (S, K1, N) fp32. `rows` (the rows of one range) is a multiple of
// 32; K1 and N are multiples of 4. Each thread keeps 32 outputs
// of one row.
__global__ void __launch_bounds__(kThreads)
    wgrad_kernel(const float* A, int lda, const float* B, int ldb,
                 float* out, int M, int K1, int N, int rows) {
  using T = float;
  constexpr int R = kWRows<T>;
  __shared__ __align__(128) T As[R * kWld];
  __shared__ __align__(128) T Bs[R * kWld];
  const int i0 = blockIdx.y * kWTile, j0 = blockIdx.x * kWTile;
  const int r0 = blockIdx.z * rows, r1 = min(M, r0 + rows);
  out += (size_t)blockIdx.z * K1 * N;
  const int i = threadIdx.x / 4, jb = (threadIdx.x % 4) * 32;
  float acc[32];
#pragma unroll
  for (int q = 0; q < 32; ++q) acc[q] = 0.f;
  for (int m0 = r0; m0 < r1; m0 += R) {
    wgrad_stage<T>(As, A, lda, m0, i0, K1, r1);
    wgrad_stage<T>(Bs, B, ldb, m0, j0, N, r1);
    __syncthreads();
    for (int r = 0; r < R; ++r) {
      const float a = As[r * kWld + i];
#pragma unroll
      for (int q = 0; q < 32; ++q) acc[q] = fmaf(a, Bs[r * kWld + jb + q],
                                                 acc[q]);
    }
    __syncthreads();
  }
  if (i0 + i < K1)
#pragma unroll
    for (int q = 0; q < 32; ++q)
      if (j0 + jb + q < N) out[(size_t)(i0 + i) * N + j0 + jb + q] = acc[q];
}

// bf16: grid (ceil(N/128), ceil(K1/128), S), kThreads threads, dynamic
// shared memory kWgSmem; out is (S, K1, N) fp32, cs (with blockIdx.y == 0
// blocks only, if given) (S, N) fp32. Rows [blockIdx.z rows, + rows) of
// M; any M, K1 and N multiples of 8, lda and ldb multiples of 8. Warp w
// keeps the 32 x 32 corner (32 (w / 4), 32 (w % 4)) of the tile in
// registers.
constexpr int kWgRows = 64, kWgStages = 3, kWgLd = kWTile + 8;
constexpr size_t kWgSlot = (size_t)2 * kWgRows * kWgLd * sizeof(bf16);
constexpr size_t kWgSmem = kWgStages * kWgSlot;

__global__ void __launch_bounds__(kThreads)
    wgrad_mma_kernel(const bf16* A, int lda, const bf16* B, int ldb,
                     float* out, float* cs, int M, int K1, int N, int rows) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int i0 = blockIdx.y * kWTile, j0 = blockIdx.x * kWTile;
  const int r0 = blockIdx.z * rows, r1 = min(M, r0 + rows);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int steps = (r1 - r0 + kWgRows - 1) / kWgRows;
  const bool sums = cs != nullptr && blockIdx.y == 0;
  // slice q: rows [r0 + 64 q, +64) of A's columns [i0, +128) and of B's
  // [j0, +128), zero past r1, K1 and N; two 16-byte copies of each a
  // thread
  auto load = [&](int q) {
    bf16* as = reinterpret_cast<bf16*>(smem + (q % kWgStages) * kWgSlot);
    bf16* bs = as + kWgRows * kWgLd;
    for (int i = tid; i < kWgRows * 16; i += kThreads) {
      const int r = i >> 4, c = (i & 15) * 8, row = r0 + q * kWgRows + r;
      const bool rok = row < r1;
      cp_async16(as + r * kWgLd + c, A + (size_t)row * lda + i0 + c,
                 rok && i0 + c < K1);
      cp_async16(bs + r * kWgLd + c, B + (size_t)row * ldb + j0 + c,
                 rok && j0 + c < N);
    }
  };
  for (int q = 0; q < kWgStages - 1; ++q) {
    if (q < steps) load(q);
    cp_async_commit();
  }
  float acc[2][4][4];
  zero_acc(acc);
  float csum = 0.f;  // column tid % 128, rows tid / 128 + 4 k of each slice
  const int wi = (warp >> 2) * 32, wj = (warp & 3) * 32;
  for (int q = 0; q < steps; ++q) {
    cp_async_wait<kWgStages - 2>();
    __syncthreads();
    // the slot of slice q - 1, which every thread has finished with
    if (q + kWgStages - 1 < steps) load(q + kWgStages - 1);
    cp_async_commit();
    const bf16* as =
        reinterpret_cast<const bf16*>(smem + (q % kWgStages) * kWgSlot);
    const bf16* bs = as + kWgRows * kWgLd;
    // A^T (i, m): the slice holds A (m, i) row-major, its transpose
    warp_mma<2, 4, kWgRows / 16, true, false>(acc, as + wi, kWgLd, bs + wj,
                                              kWgLd);
    if (sums) {
#pragma unroll
      for (int k = 0; k < kWgRows / 4; ++k)
        csum += __bfloat162float(bs[(tid / kWTile + 4 * k) * kWgLd +
                                    tid % kWTile]);
    }
  }
  cp_async_wait<0>();
  const int gq = lane >> 2, t4 = lane & 3;
  out += (size_t)blockIdx.z * K1 * N;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int i = i0 + wi + m * 16 + gq + 8 * hh;
      if (i >= K1) continue;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int j = j0 + wj + n * 8 + 2 * t4;
        if (j < N)
          *reinterpret_cast<float2*>(out + (size_t)i * N + j) =
              make_float2(acc[m][n][2 * hh], acc[m][n][2 * hh + 1]);
      }
    }
  if (!sums) return;
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);  // 4 x 128 row-group sums
  red[tid] = csum;
  __syncthreads();
  if (tid < kWTile && j0 + tid < N)
    cs[(size_t)blockIdx.z * N + j0 + tid] =
        ((red[tid] + red[kWTile + tid]) + red[2 * kWTile + tid]) +
        red[3 * kWTile + tid];
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
