// Kernel 5's bf16 body at C 16, 32 and 64, and C 8-64 at head dim 8
// (attention_narrow_mma.cuh, the body of kernel 1's narrow kernel):
// persistent blocks of WN groups of four warps, one window per group at a
// time, on identity windows
// (WindowTokens): window i of the Bw is row block i of (Bw, 64, C) and
// lies at place (w_off + i) mod nW of its image. No residual.
#include "attention_image.cuh"
#include "attention_narrow_mma.cuh"

namespace uf {

// 128 registers a thread at most, as at WN = 4 (one block per SM)
template <int C, int D, int WN>
__global__ void __launch_bounds__(128 * WN, 4 / WN)
    attention_block_narrow_kernel(AttnParams<bf16> p, int Bw) {
  extern __shared__ __align__(128) unsigned char smem[];
  const WindowTokens tok(p.H, p.W, p.shift, p.w_off);
  attn_narrow<C, D, WN>(p, tok, Bw, smem);
}

int attention_block_narrow_slots(int C, int D, int wn, int* slots) {
  return with_narrow(C, D, wn, [&](auto c, auto d, auto n) {
    constexpr int Cc = decltype(c)::value, Dd = decltype(d)::value,
                  WN = decltype(n)::value;
    using L = AttnNarrow<Cc, Dd, WN>;
    return (int)resident_slots(attention_block_narrow_kernel<Cc, Dd, WN>,
                               L::kThreadsN, L::total, slots);
  });
}

int attention_block_narrow(const AttnParams<bf16>& p, int D, int Bw, int wn,
                           int grid, cudaStream_t stream) {
  return with_narrow(p.C, D, wn, [&](auto c, auto d, auto n) {
    constexpr int Cc = decltype(c)::value, Dd = decltype(d)::value,
                  WN = decltype(n)::value;
    using L = AttnNarrow<Cc, Dd, WN>;
    auto kernel = attention_block_narrow_kernel<Cc, Dd, WN>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::total);
    if (e != cudaSuccess) return (int)e;
    kernel<<<grid, L::kThreadsN, L::total, stream>>>(p, Bw);
    return (int)cudaGetLastError();
  });
}

}  // namespace uf
