// Kernel 6 (attention_bwd.cu, attention_block_bwd.cu,
// attention_block_bwd_packed.cu) at head dims 24, 40, 48 and 56: the
// blocks of an --embed_dim 24-56 model (C = D nH, 24-896, no power of
// two) in their three layouts at windows 1-8 (the image's shifted 8x8
// windows, (Bw, 64, C) windows, packed tiles of smaller ones), in fp32 and
// bf16, on the one-window-per-block body of attention_window_bwd.cuh
// (bf16: WMMA products through zero-padded staged operands, dxm in fp32).
// Its own translation unit, so that nvcc builds these bodies beside the
// others and the old head dims' instantiations keep their bits.
//
// What bounds it on the H100: as the other head dims' kernel 6, per
// window 7 products of 64 x C x C and the per-head softmax VJP; this
// body runs them block-wide with a barrier between steps and its weights
// staged through shared memory chunk by chunk, so latency, not the
// tensor cores' rate or the bytes, sets its pace (PERF.md §6).
#include "attention_window_bwd.cuh"
#include "window_core_mma.cuh"

namespace uf {

// one window (tile) a block; the token map by kMap (0 image, 1 windows,
// 2 packed tiles), as the three layouts' own kernels take it
template <typename T, int D, int kMap>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_heads_kernel(AttnBwdParams<T> p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const auto L = attn_bwd_layout<D>(sizeof(T), p.C);
  const int tid = threadIdx.x, w = blockIdx.x;
  const int H = p.H, W = p.W, s = p.shift;
  int* pix = reinterpret_cast<int*>(smem + L.pix);
  int* rid = reinterpret_cast<int*>(smem + L.rid);
  if (tid < 64) {
    if constexpr (kMap == 0) {
      const int nWw = W / 8, nW = (H / 8) * nWw;
      const int b = w / nW, wl = w % nW;
      const int gr = (wl / nWw) * 8 + tid / 8, gc = (wl % nWw) * 8 + tid % 8;
      pix[tid] = (b * H + (gr + s) % H) * W + (gc + s) % W;
      rid[tid] = window_region(wl, tid, H, W, s);
    } else if constexpr (kMap == 1) {
      pix[tid] = w * 64 + tid;
      rid[tid] = window_region(w % ((H / 8) * (W / 8)), tid, H, W, s);
    } else {
      const PackedTokens tok(H, W, s, 0, p.win, p.n_win);
      pix[tid] = tok.valid(w, tid) ? tok.pix(w, tid) : -1;
      rid[tid] = s ? tok.region(w, tid) : 0;
    }
  }
  __syncthreads();
  attention_window_bwd<T, D>(p, w, smem);
}

template <typename T, int D, int kMap>
static int launch(const AttnBwdParams<T>& p, int windows,
                  cudaStream_t stream) {
  const auto L = attn_bwd_layout<D>(sizeof(T), p.C);
  // a C of 8 mod 16 reads the xm tile's zero pad columns: shared memory
  if (sizeof(T) == 2 && p.C % 16 && !L.x_smem)
    return (int)cudaErrorInvalidValue;
  const auto kernel = attention_bwd_heads_kernel<T, D, kMap>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (e != cudaSuccess) return (int)e;
  kernel<<<windows, kThreads, L.total, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int attention_bwd_heads(const AttnBwdParams<T>& p, int windows, int map,
                        cudaStream_t stream) {
  return with_new_head_dim(p.C, p.nH, [&](auto d) {
    constexpr int D = decltype(d)::value;
    return map == 0   ? launch<T, D, 0>(p, windows, stream)
           : map == 1 ? launch<T, D, 1>(p, windows, stream)
                      : launch<T, D, 2>(p, windows, stream);
  });
}

template int attention_bwd_heads<float>(const AttnBwdParams<float>&, int,
                                        int, cudaStream_t);
template int attention_bwd_heads<bf16>(const AttnBwdParams<bf16>&, int, int,
                                       cudaStream_t);

int attention_bwd_heads_scratch(int ts, int C, int nH) {
  return with_new_head_dim(C, nH, [&](auto d) {
    const auto L = attn_bwd_layout<decltype(d)::value>(ts, C);
    return (L.x_smem ? 0 : 1) | (L.do_smem ? 0 : 2) |
           (ts == 2 && !L.dxm_smem(ts) ? 4 : 0);
  });
}

}  // namespace uf
