// The window-attention core: for one 8x8 window and one head, in shared
// memory,
//
//   O = softmax(q k^T * scale + bias_h [- 100 where region ids differ]) v
//
// with the logits and the softmax in fp32 and P rounded to T before the
// second product. It is the body of window_attention.cu (kernel 4) and
// runs inside attention_window.cuh, which attention_image.cu, stage.cu
// and attention_block.cu build on.
//
// The scale is an argument: window_attention.cu scales the fp32 logits,
// as uformer_tpu/ops/pallas/window_attention.py:55 does; the callers that
// fold the scale into q before rounding it (attention_block.py:27-29)
// pass 1.0, which leaves the logits exact.
#pragma once

#include "common.cuh"

namespace uf {

// SW-MSA region id (0..2) of a shifted coordinate along one axis: slices
// [0, size-8), [size-8, size-s), [size-s, size) of the reference mask
// (the window is 8: uformer_tpu/ops/pallas/window_attention.py:32-38).
__device__ __forceinline__ int region_id(int g, int size, int s) {
  return (g >= size - 8) + (g >= size - s);
}

// The same along one axis of a win-wide window (win 1-8, shift s < win):
// slices [0, size-win), [size-win, size-s), [size-s, size), as
// uformer_tpu/ops/pallas/window_attention.py:_region_ids builds them.
__device__ __forceinline__ int region_id_w(int g, int size, int s,
                                           int win) {
  return (g >= size - win) + (g >= size - s);
}

// Region id (0..8) of token t of window `wl` (row-major among the image's
// windows) at shift s, 0 when unshifted.
__device__ __forceinline__ int window_region(int wl, int t, int H, int W,
                                             int s) {
  if (!s) return 0;
  const int nWw = W / 8, gr = (wl / nWw) * 8 + t / 8,
            gc = (wl % nWw) * 8 + t % 8;
  return 3 * region_id(gr, H, s) + region_id(gc, W, s);
}

// The width the block products of a head take: D, or for a bf16 head of
// 8, 24, 40 or 56 the next multiple of 16 (WMMA fragments are 16 wide),
// its columns D..D+7 zero in shared memory, which leaves the products
// exact.
template <typename T, int D>
__host__ __device__ constexpr int padded_head() {
  return std::is_same<T, bf16>::value ? (D + 15) / 16 * 16 : D;
}

// q, k, v: 64 x D tiles (leading dim ldq) in shared memory, for a bf16
// head of 8 mod 16 zero in columns D..D+7; bias_h the head's (64, 64) fp32 bias
// (shared or device memory; -inf between the windows of a packed tile);
// rid the 64 region ids, or null when unshifted; P a 64 x ldp tile of T;
// acc a 64 x lda fp32 tile (lda >= 64), which holds the logits and on
// return O (64 x D). All threads of the block call it; it ends
// synchronised. NW: the block's warps, as block_gemm takes it.
template <typename T, int D, int NW>
__device__ __forceinline__ void window_core(const T* q, const T* k,
                                            const T* v, int ldq,
                                            const float* bias_h,
                                            const int* rid, float scale,
                                            T* P, int ldp, float* acc,
                                            int lda) {
  constexpr int DP = padded_head<T, D>();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = NW > 0 ? NW : (int)(blockDim.x >> 5);
  block_gemm<T, true, false, false, NW>(q, ldq, k, ldq, acc, lda, 64, 64, DP);
  __syncthreads();
  // one warp per row: lanes hold columns lane and lane + 32
  for (int t = warp; t < 64; t += nw) {
    float l0 = fmaf(acc[t * lda + lane], scale, bias_h[t * 64 + lane]);
    float l1 = fmaf(acc[t * lda + lane + 32], scale,
                    bias_h[t * 64 + lane + 32]);
    if (rid != nullptr) {
      if (rid[t] != rid[lane]) l0 -= 100.0f;
      if (rid[t] != rid[lane + 32]) l1 -= 100.0f;
    }
    const float m = warp_max(fmaxf(l0, l1));
    const float e0 = expf(l0 - m), e1 = expf(l1 - m);
    const float inv = 1.0f / warp_sum(e0 + e1);
    P[t * ldp + lane] = from_f<T>(e0 * inv);
    P[t * ldp + lane + 32] = from_f<T>(e1 * inv);
  }
  __syncthreads();
  block_gemm<T, false, false, false, NW>(P, ldp, v, ldq, acc, lda, 64, DP,
                                         64);
  __syncthreads();
}

}  // namespace uf
