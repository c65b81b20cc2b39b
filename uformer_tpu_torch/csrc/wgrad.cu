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

// bf16 (mma.sync, with the column sums of B into cs when given) or
// fp32 (FMA; cs by a colsum pass); S row ranges, whose partial products
// (and column sums) are then summed in order.
template <typename T>
static int wgrad_run(const void* A, int lda, const void* B, int ldb,
                     float* out, float* part, float* cs, float* cs_part,
                     int M, int K1, int N, int S, cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  if (K1 % 8 || N % 8 || lda % 8 || ldb % 8 || M <= 0)
    return (int)cudaErrorInvalidValue;
  // rows per range: a multiple of 64 (the rows of a bf16 slice, two of
  // the fp32 kernel's)
  const int slices = (M + 63) / 64;
  const int rows = (slices + S - 1) / S * 64;
  S = (M + rows - 1) / rows;
  const dim3 grid((N + kWTile - 1) / kWTile, (K1 + kWTile - 1) / kWTile, S);
  if constexpr (kBf16) {
    cudaError_t e = cudaFuncSetAttribute(
        wgrad_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kWgSmem);
    if (e != cudaSuccess) return (int)e;
    wgrad_mma_kernel<<<grid, kThreads, kWgSmem, stream>>>(
        static_cast<const bf16*>(A), lda, static_cast<const bf16*>(B), ldb,
        S == 1 ? out : part, cs == nullptr ? nullptr : S == 1 ? cs : cs_part,
        M, K1, N, rows);
  } else {
    wgrad_kernel<<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(A), lda, static_cast<const float*>(B), ldb,
        S == 1 ? out : part, M, K1, N, rows);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (S > 1) {
    const int r = colsum_run<float>(part, K1 * N, out, nullptr, S, K1 * N, 1,
                                    stream);
    if (r != 0) return r;
  }
  if (cs == nullptr) return 0;
  if (!kBf16)  // one pass over B, in S row segments
    return colsum_run<float>(B, ldb, cs, cs_part, M, N, S, stream);
  if (S > 1) return colsum_run<float>(cs_part, N, cs, nullptr, S, N, 1, stream);
  return 0;
}

}  // namespace uf

extern "C" {

// out (K1 x N, fp32) = A^T B; A (M x K1, lda), B (M x N, ldb) in bf16 or
// fp32; K1, N, lda and ldb multiples of 8. With cs, also the column sums
// of B (N, fp32). S row ranges; with S > 1, `part` holds S x K1 x N
// floats and `cs_part` S x N.
int uf_wgrad(int is_bf16, const void* A, int lda, const void* B, int ldb,
             float* out, float* part, float* cs, float* cs_part, int M,
             int K1, int N, int S, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return uf::wgrad_run<uf::bf16>(A, lda, B, ldb, out, part, cs, cs_part, M,
                                   K1, N, S, s);
  return uf::wgrad_run<float>(A, lda, B, ldb, out, part, cs, cs_part, M, K1,
                              N, S, s);
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
