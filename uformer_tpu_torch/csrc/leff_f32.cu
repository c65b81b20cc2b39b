// Kernel 2 (leff.cu) in fp32 at C 16, 32, 64, 128, 256 and 512 on the
// three-pass TF32 tile of leff_f32.cuh: one TH x 8 output tile a block
// (TH leff_f32_rows(C)), partial tiles masked. Its own translation unit,
// so that nvcc builds these tiles beside the others.
#include "leff_f32.cuh"

namespace uf {

template <int C>
__global__ void __launch_bounds__(kThreads, 1)
    leff_f32_kernel(LeffParams<float> p) {
  extern __shared__ __align__(128) unsigned char smem[];
  leff_f32_tile<C, leff_f32_rows(C)>(p, blockIdx.x, smem);
}

template <int C>
static int launch(const LeffParams<float>& p, cudaStream_t stream) {
  constexpr int TH = leff_f32_rows(C);
  constexpr size_t smem = LeffF32<C, TH>::total;
  cudaError_t e = cudaFuncSetAttribute(
      leff_f32_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = p.B * ((p.H + TH - 1) / TH) * ((p.W + 7) / 8);
  leff_f32_kernel<C><<<blocks, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

int leff_f32(const LeffParams<float>& p, cudaStream_t stream) {
  if (!leff_f32_fits(p.C) || p.Ch % kLeffChunk)
    return (int)cudaErrorInvalidValue;
  switch (p.C) {
    case 16: return launch<16>(p, stream);
    case 32: return launch<32>(p, stream);
    case 64: return launch<64>(p, stream);
    case 128: return launch<128>(p, stream);
    case 256: return launch<256>(p, stream);
  }
  return launch<512>(p, stream);
}

}  // namespace uf
