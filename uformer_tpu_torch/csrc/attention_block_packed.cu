// Kernel 5's bf16 body at C 8-64 on windows of N = win^2 < 64 tokens
// (win 1-7): the narrow body (attention_narrow_mma.cuh) on PackedTokens,
// each group of four warps taking a 64-row tile of 64 / N whole windows
// of the (Bw N, C) rows; padding rows read as zeros and are never
// written. The host hands in the modulator and the relative-position bias
// as tiles (`ops/kernels/attention_block.py:packed_operands`): row t of a
// tile is token t mod N, and the bias is -inf between two windows, so a
// window's rows weigh only its own keys. No residual.
#include "attention_image.cuh"
#include "attention_narrow_mma.cuh"

namespace uf {

template <int C, int D, int WN>
__global__ void __launch_bounds__(128 * WN, 4 / WN)
    attention_block_packed_kernel(AttnParams<bf16> p, int tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  const PackedTokens tok(p.H, p.W, p.shift, p.w_off, p.win, p.n_win);
  attn_narrow<C, D, WN>(p, tok, tiles, smem);
}

int attention_block_packed_slots(int C, int D, int wn, int* slots) {
  return with_narrow(C, D, wn, [&](auto c, auto d, auto n) {
    constexpr int Cc = decltype(c)::value, Dd = decltype(d)::value,
                  WN = decltype(n)::value;
    using L = AttnNarrow<Cc, Dd, WN>;
    return (int)resident_slots(attention_block_packed_kernel<Cc, Dd, WN>,
                               L::kThreadsN, L::total, slots);
  });
}

int attention_block_packed(const AttnParams<bf16>& p, int D, int wn,
                           int grid, cudaStream_t stream) {
  const int N = p.win * p.win, tiles = (p.n_win + 64 / N - 1) / (64 / N);
  return with_narrow(p.C, D, wn, [&](auto c, auto d, auto n) {
    constexpr int Cc = decltype(c)::value, Dd = decltype(d)::value,
                  WN = decltype(n)::value;
    using L = AttnNarrow<Cc, Dd, WN>;
    auto kernel = attention_block_packed_kernel<Cc, Dd, WN>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::total);
    if (e != cudaSuccess) return (int)e;
    kernel<<<grid, L::kThreadsN, L::total, stream>>>(p, tiles);
    return (int)cudaGetLastError();
  });
}

}  // namespace uf
