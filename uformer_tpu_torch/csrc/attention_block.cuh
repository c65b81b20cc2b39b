// Kernel 5's one-window-per-block body (attention_window.cuh) and its
// launch, shared by attention_block.cu (head dims 8, 16, 32, 64),
// attention_block_heads.cu (24, 40, 48, 56) and
// attention_block_big_heads.cu (72-128), which nvcc compiles in parallel.
#pragma once

#include "attention_image.cuh"

namespace uf {

inline int block_threads(int C) {
  return C <= 32 ? 128 : (C <= 64 ? 256 : kThreads);
}

template <typename T, int D, bool kPacked = false>
__global__ void __launch_bounds__(kThreads)
    attention_block_kernel(AttnParams<T> p) {
  extern __shared__ __align__(128) unsigned char smem[];
  attention_window<T, D, 0, kPacked>(p, blockIdx.x, smem, blockIdx.x);
}

// Bw blocks (windows, or packed tiles)
template <typename T, int D, bool kPacked = false>
int launch_block(const AttnParams<T>& p, int Bw, cudaStream_t stream) {
  if (!attn_window_fits(sizeof(T), p.C, D)) return (int)cudaErrorInvalidValue;
  const size_t smem = attn_layout<D>(sizeof(T), p.C).total;
  cudaError_t e = cudaFuncSetAttribute(
      attention_block_kernel<T, D, kPacked>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  attention_block_kernel<T, D, kPacked>
      <<<Bw, block_threads(p.C), smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// Kernel 5 at head dim C / nH in 24, 40, 48, 56 (is_new_head_dim) on
// `blocks` windows, or packed tiles with `packed`; kernel 1 at those head
// dims too, on p.windows = 0 (the image token map), a block a window.
template <typename T>
int attention_block_heads(const AttnParams<T>& p, int blocks, bool packed,
                          cudaStream_t stream);

// Kernel 5 at head dim C / nH in 72-128, a multiple of 8
// (is_big_head_dim), on `blocks` windows, or packed tiles with `packed`;
// kernel 1 at those head dims too, on p.windows = 0, a block a window.
template <typename T>
int attention_block_big_heads(const AttnParams<T>& p, int blocks,
                              bool packed, cudaStream_t stream);

}  // namespace uf
