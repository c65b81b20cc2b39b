// Kernel 1's bf16 body at C 128, 256 and 512: the stage kernel's
// attention half (attention_mma.cuh: projections on mma.sync with the
// weights streamed through a cp.async ring, 1-4 windows per work item)
// as a persistent kernel of its own, residual on or off. Head dim 8 at
// C = 128 (an embed-8 model's bottleneck and dec0 in training, where the
// stage kernel does not run) on attn_wide_item's 16-wide products over
// zeroed pad columns, as the stage kernel runs it. Head dim 64 at C
// 128-512 (an --embed_dim 64 model's enc1-enc3 and dec1-dec3), one or two
// windows a work item.
#include "attention_image.cuh"
#include "attention_mma.cuh"

namespace uf {

template <int C, int D, int WN>
__global__ void __launch_bounds__(kThreads, 1)
    attention_wide_kernel(AttnParams<bf16> p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int items = (p.B * (p.H / 8) * (p.W / 8) + WN - 1) / WN;
  for (int it = blockIdx.x; it < items; it += gridDim.x)
    attn_wide_item<C, D, WN>(p, it, smem);
}

// f(IntC<C>, IntC<D>, IntC<WN>) for the wide kernel of (C, D, wn), as
// attn_wide_wn_fits takes them (head dim 8 at C = 128 only; at head dim
// 64 two windows at most)
template <typename F>
static int with_wide(int C, int D, int wn, F f) {
  auto by_c = [&](auto d) {
    constexpr int Dd = decltype(d)::value;
    if constexpr (attn_wide_wn_fits(128, Dd, 4))
      if (C == 128 && wn == 4) return f(IntC<128>{}, d, IntC<4>{});
    if (C == 128 && wn == 2) return f(IntC<128>{}, d, IntC<2>{});
    if (C == 128 && wn == 1) return f(IntC<128>{}, d, IntC<1>{});
    if constexpr (attn_wide_fits(256, Dd)) {
      if (C == 256 && wn == 2) return f(IntC<256>{}, d, IntC<2>{});
      if (C == 256 && wn == 1) return f(IntC<256>{}, d, IntC<1>{});
      if (C == 512 && wn == 1) return f(IntC<512>{}, d, IntC<1>{});
    }
    return (int)cudaErrorInvalidValue;
  };
  if (D == 8) return by_c(IntC<8>{});
  if (D == 16) return by_c(IntC<16>{});
  if (D == 32) return by_c(IntC<32>{});
  if (D == 64) return by_c(IntC<64>{});
  return (int)cudaErrorInvalidValue;
}

int attention_image_wide_slots(int C, int D, int wn, int* slots) {
  return with_wide(C, D, wn, [&](auto c, auto d, auto n) {
    constexpr int Cc = decltype(c)::value, Dd = decltype(d)::value,
                  WN = decltype(n)::value;
    return (int)resident_slots(attention_wide_kernel<Cc, Dd, WN>, kThreads,
                               AttnWide<Cc, Dd, WN>::total, slots);
  });
}

int attention_image_wide(const AttnParams<bf16>& p, int D, int wn, int grid,
                         cudaStream_t stream) {
  return with_wide(p.C, D, wn, [&](auto c, auto d, auto n) {
    constexpr int Cc = decltype(c)::value, Dd = decltype(d)::value,
                  WN = decltype(n)::value;
    constexpr size_t smem = AttnWide<Cc, Dd, WN>::total;
    auto kernel = attention_wide_kernel<Cc, Dd, WN>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<grid, kThreads, smem, stream>>>(p);
    return (int)cudaGetLastError();
  });
}

}  // namespace uf
