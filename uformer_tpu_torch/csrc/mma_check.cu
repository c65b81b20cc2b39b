// The building block of mma_tile.cuh alone, for its check against
// torch.matmul: C (M x N, fp32) = A (M x K) . B (K x N), bf16 row-major.
//
// A block of 4 warps computes 64 rows x 8 NT columns of C; warp w takes
// rows 16 w .. 16 w + 15 through warp_mma<1, NT, 4>. K goes in slices of
// 64 through a two-slot cp.async ring, the next slice in flight while the
// current one is multiplied, as the LeFF tiles feed their weights. Rows of
// A past M are zero-filled by the copy (the masking of the halo rows).
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

}  // namespace uf

extern "C" {

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
