// C entries of the weight-gradient reductions (wgrad.cuh) for Hopper
// (sm_90a). The backward wrappers (ops/kernels/leff.py, attention_image.py)
// call them after their per-tile kernels; they replace the in-kernel
// weight-gradient sums of uformer_tpu/ops/pallas/leff.py:fused_leff_bwd and
// attention_block.py:fused_attention_block_bwd, which a TPU grid carries
// from one step to the next in VMEM.
#include "wgrad.cuh"

namespace uf {

template <typename T>
static int colsum_run(const void* in, int ld, float* out, float* part, int R,
                      int K, int S, cudaStream_t stream) {
  const int rows = (R + S - 1) / S;
  const dim3 grid((K + 31) / 32, S);
  colsum_kernel<T><<<grid, 256, 0, stream>>>(static_cast<const T*>(in), ld,
                                             S == 1 ? out : part, R, K, rows);
  if (S > 1)
    colsum_kernel<float><<<dim3((K + 31) / 32, 1), 256, 0, stream>>>(
        part, K, out, S, K, S);
  return (int)cudaGetLastError();
}

template <typename T>
static int wgrad_run(const void* A, int lda, const void* B, int ldb,
                     float* out, float* part, int M, int K1, int N, int S,
                     cudaStream_t stream) {
  if (M % 64 || K1 % 16 || N % 16 || lda % 8 || ldb % 8)
    return (int)cudaErrorInvalidValue;
  // rows per range: a multiple of 64 (and so of the staged rows)
  const int steps = M / 64;
  const int rows = (steps + S - 1) / S * 64;
  S = (M + rows - 1) / rows;
  const dim3 grid((N + kWTile - 1) / kWTile, (K1 + kWTile - 1) / kWTile, S);
  wgrad_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(A), lda, static_cast<const T*>(B), ldb,
      S == 1 ? out : part, M, K1, N, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || S == 1) return (int)e;
  return colsum_run<float>(part, K1 * N, out, nullptr, S, K1 * N, 1, stream);
}

}  // namespace uf

extern "C" {

// out (K1 x N, fp32) = A^T B; A (M x K1, lda), B (M x N, ldb) in bf16 or
// fp32. S row ranges; with S > 1, `part` holds S x K1 x N floats.
int uf_wgrad(int is_bf16, const void* A, int lda, const void* B, int ldb,
             float* out, float* part, int M, int K1, int N, int S,
             void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return uf::wgrad_run<uf::bf16>(A, lda, B, ldb, out, part, M, K1, N, S, s);
  return uf::wgrad_run<float>(A, lda, B, ldb, out, part, M, K1, N, S, s);
}

// out (K, fp32) = column sums of in (R x K, ld), in S row segments; with
// S > 1, `part` holds S x K floats. in_kind: 0 fp32, 1 bf16.
int uf_colsum(int in_kind, const void* in, int ld, float* out, float* part,
              int R, int K, int S, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (in_kind == 1)
    return uf::colsum_run<uf::bf16>(in, ld, out, part, R, K, S, s);
  return uf::colsum_run<float>(in, ld, out, part, R, K, S, s);
}

}  // extern "C"
