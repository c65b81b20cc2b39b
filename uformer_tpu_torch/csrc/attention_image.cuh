// The persistent bf16 bodies of kernels 1 and 5, each built in its own
// translation unit so that nvcc compiles them in parallel: kernel 1's
// narrow body at C 16-64 (attention_image_narrow.cu,
// attention_narrow_mma.cuh) and its wide one at C 128-512
// (attention_image_wide.cu, the stage kernel's attn_wide_item); kernel
// 5's on the narrow body, on 8x8 windows (attention_block_narrow.cu) and
// on packed tiles of smaller ones (attention_block_packed.cu). `grid`
// blocks walk the windows in work items of `wn` windows (tiles).
#pragma once

#include "attention_window.cuh"

namespace uf {

// 0 or a cudaError_t (cudaErrorInvalidValue for (C, D, wn) without a
// kernel).
int attention_image_narrow(const AttnParams<bf16>& p, int D, int wn,
                           int grid, cudaStream_t stream);
int attention_image_wide(const AttnParams<bf16>& p, int D, int wn, int grid,
                         cudaStream_t stream);
// The blocks of that body resident on the card at once, in *slots.
int attention_image_narrow_slots(int C, int D, int wn, int* slots);
int attention_image_wide_slots(int C, int D, int wn, int* slots);
// kernel 5 on the Bw windows of p.x (AttnParams::w_off their offset)
int attention_block_narrow(const AttnParams<bf16>& p, int D, int Bw, int wn,
                           int grid, cudaStream_t stream);
int attention_block_narrow_slots(int C, int D, int wn, int* slots);
// kernel 5 on the p.n_win windows of N = p.win^2 < 64 tokens of p.x, in
// packed tiles of 64 rows (attention_block_packed.cu)
int attention_block_packed(const AttnParams<bf16>& p, int D, int wn,
                           int grid, cudaStream_t stream);
int attention_block_packed_slots(int C, int D, int wn, int* slots);

// The blocks of `kernel` (threads a block, smem bytes of dynamic shared
// memory) resident on the card at once, in *slots; sets the kernel's
// shared-memory limit.
template <typename K>
cudaError_t resident_slots(K kernel, int threads, size_t smem, int* slots) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  *slots = per_sm * sms;
  if (e == cudaSuccess && per_sm < 1) e = cudaErrorInvalidConfiguration;
  return e;
}

template <int N>
using IntC = std::integral_constant<int, N>;

// f(IntC<C>, IntC<D>, IntC<WN>) for the narrow body of (C, D, wn); head
// dim 8 from C = kMinC8 (kernel 1 takes C >= 32 only)
template <int kMinC8 = 8, typename F>
int with_narrow(int C, int D, int wn, F f) {
  auto by_wn = [&](auto c, auto d) {
    if (wn == 4) return f(c, d, IntC<4>{});
    if (wn == 2) return f(c, d, IntC<2>{});
    if (wn == 1) return f(c, d, IntC<1>{});
    return (int)cudaErrorInvalidValue;
  };
  if (C == 16 && D == 16) return by_wn(IntC<16>{}, IntC<16>{});
  if (C == 32 && D == 16) return by_wn(IntC<32>{}, IntC<16>{});
  if (C == 32 && D == 32) return by_wn(IntC<32>{}, IntC<32>{});
  if (C == 64 && D == 16) return by_wn(IntC<64>{}, IntC<16>{});
  if (C == 64 && D == 32) return by_wn(IntC<64>{}, IntC<32>{});
  if (C == 64 && D == 64) return by_wn(IntC<64>{}, IntC<64>{});
  if constexpr (kMinC8 <= 8)
    if (C == 8 && D == 8) return by_wn(IntC<8>{}, IntC<8>{});
  if constexpr (kMinC8 <= 16)
    if (C == 16 && D == 8) return by_wn(IntC<16>{}, IntC<8>{});
  if (C == 32 && D == 8) return by_wn(IntC<32>{}, IntC<8>{});
  if (C == 64 && D == 8) return by_wn(IntC<64>{}, IntC<8>{});
  return (int)cudaErrorInvalidValue;
}

}  // namespace uf
