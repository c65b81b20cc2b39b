// Kernel 6 on windows of N = win^2 < 64 tokens (win 1-7): the backward of
// attention_block_packed.cu's function, on the forward's packed tiles.
//
// Replaces uformer_tpu/ops/pallas/attention_block.py:
// fused_attention_block_bwd at N < 64 (the JAX kernel packs gp = 128 // N
// windows into its lanes, :914; its packed variant is the TPU's pixel
// packing of the same function). Here a work item is a 64-row tile of
// G = 64 / N whole windows of the (Bw N, C) rows, as the forward takes them
// (window_core_mma.cuh:PackedTokens): row t of tile w is row w G N + t,
// rows from G N on and the windows past the last are padding (pix -1:
// x = g = 0 read, nothing written), and region ids come from each window's
// place in its image. The host hands in the modulator's and the bias's
// tiles (`ops/kernels/attention_block.py:packed_operands`; the bias -inf
// between two windows of a tile), so the per-tile body is the 8x8 window's
// (attention_bwd_mma.cuh in bf16, attention_window_bwd.cuh in fp32). Its
// dbias and dmod shares come out as (nH, 64, 64) and (64, C) tiles, which
// the host folds back to (nH, N, N) and (N, C): the diagonal N x N blocks
// of the bias tile summed, and the tile rows t = i (mod N) of its whole
// windows (every other entry is exactly 0).
//
// What bounds it on the H100: as the 8x8 window's, per tile; a tile holds
// G N of 64 real rows (64 at N = 1, 4, 16; 63, 50, 49, 36 at N = 9, 25,
// 36, 49), so the pad rows cost up to 28% more than the work needs.
#include "attention_bwd_mma.cuh"

namespace uf {

__device__ __forceinline__ void packed_token(const PackedTokens& tok, int w,
                                             int t, int* pix, int* rid) {
  *pix = tok.valid(w, t) ? tok.pix(w, t) : -1;
  *rid = tok.s ? tok.region(w, t) : 0;
}

template <int C, int D>
__global__ void __launch_bounds__(kThreads, C <= 64 ? 2 : 1)
    attention_block_bwd_packed_mma_kernel(AttnBwdParams<bf16> p, int wn,
                                          int n_tiles, int hpb, int finish) {
  extern __shared__ __align__(128) unsigned char smem[];
  const PackedTokens tok(p.H, p.W, p.shift, 0, p.win, p.n_win);
  auto map = [&](int w, int t, int* pix, int* rid) {
    packed_token(tok, w, t, pix, rid);
  };
  if (finish) {
    attention_bwd_finish<C, D, true>(p, blockIdx.x, n_tiles, p.nH / hpb,
                                     smem, map);
    return;
  }
  const int w0 = blockIdx.x * wn;
  attention_bwd_item<C, D, true>(p, blockIdx.x, w0, min(wn, n_tiles - w0),
                                 blockIdx.y * hpb, hpb, smem, map);
}

int attention_block_bwd_packed(const AttnBwdParams<bf16>& p, int tiles,
                               int wn, int hpb, cudaStream_t stream) {
  return with_bwd_tile(p.C, p.nH, [&](auto c, auto d) {
    constexpr int C = decltype(c)::value, D = decltype(d)::value;
    return launch_attn_bwd_mma<C, D>(
        attention_block_bwd_packed_mma_kernel<C, D>, p, wn, tiles, hpb,
        stream);
  });
}

int attention_block_bwd_packed(const AttnBwdParams<float>& p, int tiles,
                               cudaStream_t stream) {
  return launch_attn_bwd(p, tiles, 2, stream);
}

}  // namespace uf
