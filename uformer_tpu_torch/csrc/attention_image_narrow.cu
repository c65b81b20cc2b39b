// Kernel 1's bf16 body at C 16, 32 and 64, and at head dim 8 at C 32 and
// 64 (attention_narrow_mma.cuh):
// persistent blocks of WN groups of four warps, one window per group at a
// time, on the image's token map.
#include "attention_image.cuh"
#include "attention_narrow_mma.cuh"

namespace uf {

// 128 registers a thread at most, as at WN = 4 (one block per SM)
template <int C, int D, int WN>
__global__ void __launch_bounds__(128 * WN, 4 / WN)
    attention_narrow_kernel(AttnParams<bf16> p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const ImageTokens tok(p.H, p.W, p.shift);
  attn_narrow<C, D, WN>(p, tok, p.B * (p.H / 8) * (p.W / 8), smem);
}

int attention_image_narrow_slots(int C, int D, int wn, int* slots) {
  return with_narrow<32>(C, D, wn, [&](auto c, auto d, auto n) {
    constexpr int Cc = decltype(c)::value, Dd = decltype(d)::value,
                  WN = decltype(n)::value;
    using L = AttnNarrow<Cc, Dd, WN>;
    return (int)resident_slots(attention_narrow_kernel<Cc, Dd, WN>,
                               L::kThreadsN, L::total, slots);
  });
}

int attention_image_narrow(const AttnParams<bf16>& p, int D, int wn,
                           int grid, cudaStream_t stream) {
  return with_narrow<32>(p.C, D, wn, [&](auto c, auto d, auto n) {
    constexpr int Cc = decltype(c)::value, Dd = decltype(d)::value,
                  WN = decltype(n)::value;
    using L = AttnNarrow<Cc, Dd, WN>;
    auto kernel = attention_narrow_kernel<Cc, Dd, WN>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::total);
    if (e != cudaSuccess) return (int)e;
    kernel<<<grid, L::kThreadsN, L::total, stream>>>(p);
    return (int)cudaGetLastError();
  });
}

}  // namespace uf
