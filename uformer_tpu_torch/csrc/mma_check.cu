// The building block of mma_tile.cuh alone, for its check against
// torch.matmul: C (M x N, fp32) = A (M x K) . B (K x N), bf16 row-major.
//
// A block of 4 warps computes 64 rows x 8 NT columns of C; warp w takes
// rows 16 w .. 16 w + 15 through warp_mma<1, NT, 4>. K goes in slices of
// 64 through a two-slot cp.async ring, the next slice in flight while the
// current one is multiplied, as the LeFF tiles feed their weights. Rows of
// A past M are zero-filled by the copy (the masking of the halo rows).
//
// uf_tf32_check runs the fp32 block of mma_tf32.cuh the same way, at the
// shape of the stage's output projection: a block takes 64 rows of A (M x
// C, all of K in shared memory) and every column of B (C x C), streamed
// in tiles of 4096 / C rows through a three-slot cp.async ring; warp w
// keeps 64 C / 8192 m16 tiles x 32 columns in registers. Either through
// the three-pass TF32 product (warp_mma3) or through the register-tiled
// FMA yardstick (warp_fma), so that both can be timed and held against
// an fp64 product on the card.
#include "mma_tf32.cuh"
#include "mma_tile.cuh"

namespace uf {

template <int NT>
__global__ void __launch_bounds__(128)
    mma_check_kernel(const bf16* A, const bf16* B, float* C, int M, int N,
                     int K) {
  constexpr int lda = 64 + 8, ldb = 8 * NT + 8;
  __shared__ __align__(128) bf16 as[2][64 * lda];
  __shared__ __align__(128) bf16 bs[2][64 * ldb];
  const int m0 = blockIdx.x * 64, n0 = blockIdx.y * 8 * NT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  auto load = [&](int kt, int buf) {
    for (int i = tid; i < 64 * 8; i += 128) {
      const int r = i >> 3, v = i & 7, row = m0 + r;
      cp_async16(&as[buf][r * lda + v * 8],
                 A + (size_t)(row < M ? row : 0) * K + kt * 64 + v * 8,
                 row < M);
    }
    for (int i = tid; i < 64 * NT; i += 128) {
      const int r = i / NT, v = i % NT;
      cp_async16(&bs[buf][r * ldb + v * 8],
                 B + (size_t)(kt * 64 + r) * N + n0 + v * 8);
    }
  };
  float acc[1][NT][4];
  zero_acc(acc);
  const int kts = K / 64;
  load(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < kts; ++kt) {
    if (kt + 1 < kts) load(kt + 1, (kt + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    warp_mma<1, NT, 4>(acc, &as[kt & 1][warp * 16 * lda], lda, &bs[kt & 1][0],
                       ldb);
    __syncthreads();
  }
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + warp * 16 + g + 8 * h, col = n0 + n * 8 + 2 * t;
      if (row < M) {
        C[(size_t)row * N + col] = acc[0][n][2 * h];
        C[(size_t)row * N + col + 1] = acc[0][n][2 * h + 1];
      }
    }
}

template <int C, bool FMA>
__global__ void __launch_bounds__(kThreads, 1)
    tf32_check_kernel(const float* A, const float* B, float* Cc) {
  constexpr int lda = C + 4, ldb = C + 8, KB = 4096 / C, S = 3;
  constexpr int NCG = C / 32, MT = 64 * C / 8192, T = C / KB;
  constexpr int kSlot = KB * ldb;
  extern __shared__ __align__(128) unsigned char smem[];
  float* as = reinterpret_cast<float*>(smem);
  float* ring = as + 64 * lda;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t4 = lane & 3;
  const size_t m0 = (size_t)blockIdx.x * 64;
  cp_tile_f32(as, lda, A + m0 * C, C, 64, C);
  for (int q = 0; q < S - 1; ++q) {
    cp_tile_f32(ring + q * kSlot, ldb, B + (size_t)q * KB * C, C, KB, C);
    cp_async_commit();
  }
  float acc[MT][4][4];
  zero_acc(acc);
  const int row0 = (warp / NCG) * 16 * MT, col0 = (warp % NCG) * 32;
  for (int q = 0; q < T; ++q) {
    cp_async_wait<S - 2>();
    __syncthreads();
    if (q + S - 1 < T)
      cp_tile_f32(ring + ((q + S - 1) % S) * kSlot, ldb,
                  B + (size_t)(q + S - 1) * KB * C, C, KB, C);
    cp_async_commit();
    const float* bt = ring + (q % S) * kSlot + col0;
    const float* at = as + row0 * lda + q * KB;
    if constexpr (FMA)
      warp_fma<MT, 4, KB / 8>(acc, at, lda, bt, ldb);
    else
      warp_mma3<MT, 4, KB / 8>(acc, at, lda, bt, ldb);
  }
  cp_async_wait<0>();
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const size_t row = m0 + row0 + m * 16 + gq + 8 * h;
        *reinterpret_cast<float2*>(Cc + row * C + col0 + n * 8 + 2 * t4) =
            make_float2(acc[m][n][2 * h], acc[m][n][2 * h + 1]);
      }
}

template <int C, bool FMA>
int tf32_check(const float* A, const float* B, float* Cc, int M,
               cudaStream_t s) {
  constexpr size_t smem =
      4 * (64 * (C + 4) + 3 * (4096 / C) * (C + 8));
  auto kernel = tf32_check_kernel<C, FMA>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<M / 64, kThreads, smem, s>>>(A, B, Cc);
  return (int)cudaGetLastError();
}

}  // namespace uf

extern "C" {

// C (M x c) = A (M x c) . B (c x c), fp32 row-major, through the fp32
// block: the three-pass TF32 product, or with fma the register-tiled
// FMA yardstick; c 128 or 512, M a multiple of 64. Returns a cudaError_t.
int uf_tf32_check(const float* A, const float* B, float* C, int M, int c,
                  int fma, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (M % 64 || M <= 0) return (int)cudaErrorInvalidValue;
  if (c == 128)
    return fma ? uf::tf32_check<128, true>(A, B, C, M, s)
               : uf::tf32_check<128, false>(A, B, C, M, s);
  if (c == 512)
    return fma ? uf::tf32_check<512, true>(A, B, C, M, s)
               : uf::tf32_check<512, false>(A, B, C, M, s);
  return (int)cudaErrorInvalidValue;
}

// C = A . B through the building block; K a multiple of 64, N of 8 nt,
// nt in {1, 2, 4}. Returns a cudaError_t.
int uf_mma_check(const void* A, const void* B, float* C, int M, int N, int K,
                 int nt, void* stream) {
  if (K % 64 || (nt != 1 && nt != 2 && nt != 4) || N % (8 * nt))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((M + 63) / 64, N / (8 * nt));
  auto s = static_cast<cudaStream_t>(stream);
  auto a = static_cast<const uf::bf16*>(A);
  auto b = static_cast<const uf::bf16*>(B);
  if (nt == 1)
    uf::mma_check_kernel<1><<<grid, 128, 0, s>>>(a, b, C, M, N, K);
  else if (nt == 2)
    uf::mma_check_kernel<2><<<grid, 128, 0, s>>>(a, b, C, M, N, K);
  else
    uf::mma_check_kernel<4><<<grid, 128, 0, s>>>(a, b, C, M, N, K);
  return (int)cudaGetLastError();
}

}  // extern "C"
