// Backward of the image-layout LeWin attention sub-block for Hopper
// (sm_90a), head dim 16, 32 or 64, and 8 (bf16: from C = 32, where the
// JAX package's image route starts); head dims 24, 40, 48 and 56 on the
// one-window body of attention_bwd_heads.cu, 72-128 on its width-80-128
// instantiations in attention_bwd_big_heads.cu.
//
// Replaces uformer_tpu/ops/pallas/attention_block.py:
// fused_attention_block_bwd (and its pixel-packed narrow-C variant) as the
// JAX package runs it under attention_image.py's custom VJP: there XLA
// re-windows x and g (shift, partition), the windowed kernel recomputes
// the forward and walks the VJP, and XLA un-windows dx. Here one thread
// block per 8x8 window gathers its 64 tokens of x and g straight from the
// NHWC image at the shifted coordinates, as attention_image.cu does, and
// scatters dx back to the same pixels: no re-windowing pass, and no write
// race (shifted windows partition the image). The per-window body is
// attention_window_bwd.cuh; the weight gradients are reduced over all
// windows afterwards (wgrad.cuh).
//
// What bounds it on the H100: per window 7 products of 64 x C x C (dO,
// q/k/v recompute, dxm) against 4 x 64 x C values of per-token traffic,
// so at C >= 128 it is tensor-core work with the weights read from L2 by
// every window; at C = 32/64 the fp32 softmax VJP and the eight 64 x 64 x
// D products per head dominate (at D = 16 one WMMA k-step each). Products
// on the tensor cores (WMMA, fp32 accumulation) in bf16, the fp32 dS as
// two bf16 halves; fp32 FMA loops in fp32 (the exact-check path).
#include "attention_bwd_mma.cuh"

namespace uf {

// bf16: work item blockIdx.x, windows wn blockIdx.x .. of n_win, heads
// hpb blockIdx.y ..; with `finish`, the end of window blockIdx.x after a
// head split
// (two blocks per SM at C <= 64, whose latency-bound windows fill each
// other's gaps between barriers; 64 registers, 24-128 B of spills)
template <int C, int D>
__global__ void __launch_bounds__(kThreads, C <= 64 ? 2 : 1)
    attention_bwd_mma_kernel(AttnBwdParams<bf16> p, int wn, int n_win,
                             int hpb, int finish) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int H = p.H, W = p.W, s = p.shift;
  const int nWw = W / 8, nW = (H / 8) * nWw;
  auto map = [&](int w, int t, int* pix, int* rid) {
    const int b = w / nW, wl = w % nW;
    const int gr = (wl / nWw) * 8 + t / 8, gc = (wl % nWw) * 8 + t % 8;
    *pix = (b * H + (gr + s) % H) * W + (gc + s) % W;
    *rid = s ? window_region(wl, t, H, W, s) : 0;
  };
  if (finish) {
    attention_bwd_finish<C, D>(p, blockIdx.x, n_win, p.nH / hpb, smem, map);
    return;
  }
  const int w0 = blockIdx.x * wn;
  attention_bwd_item<C, D>(p, blockIdx.x, w0, min(wn, n_win - w0),
                           blockIdx.y * hpb, hpb, smem, map);
}

template <typename T>
static int run(const AttnBwdParams<T>& p, int wn, int hpb,
               cudaStream_t stream) {
  const int n_win = p.B * (p.H / 8) * (p.W / 8);
  if (is_new_head_dim(p.C, p.nH))  // attention_bwd_heads.cu
    return attention_bwd_heads(p, n_win, 0, stream);
  if (is_big_head_dim(p.C, p.nH))  // attention_bwd_big_heads.cu
    return attention_bwd_big_heads(p, n_win, 0, stream);
  if constexpr (std::is_same<T, bf16>::value) {
    return with_bwd_tile<32>(p.C, p.nH, [&](auto c, auto d) {
      constexpr int C = decltype(c)::value, D = decltype(d)::value;
      return launch_attn_bwd_mma<C, D>(attention_bwd_mma_kernel<C, D>, p,
                                       wn, n_win, hpb, stream);
    });
  } else {
    return launch_attn_bwd(p, n_win, 0, stream);
  }
}

}  // namespace uf

extern "C" {

// fp32: bit 0: the window's xm tile, bit 1: its dO tile, misses shared
// memory; the caller then passes a (windows, 64, C) scratch of the input's
// dtype. bf16: bit 2: the tile is kBig (attention_bwd_mma.cuh), whose
// every window ends through part_dxm, which the caller then passes with
// or without a head split. C / nH is 8-128, a multiple of 8 (checked by
// the caller); at 24, 40, 48 and 56 the bits are attention_bwd_heads.cu's
// and at 72-128 attention_bwd_big_heads.cu's (bf16: bits 0 and 1 too, and
// bit 2 where the fp32 dxm goes to part_dxm, one window a block); any
// other head dim, which no body takes, a negated cudaErrorInvalidValue.
int uf_attention_bwd_scratch(int is_bf16, int C, int nH) {
  const int ts = is_bf16 ? 2 : 4;
  if (nH <= 0 || C % nH || (C / nH) % 8 || C / nH > 128)
    return -(int)cudaErrorInvalidValue;
  if (uf::is_new_head_dim(C, nH))
    return uf::attention_bwd_heads_scratch(ts, C, nH);
  if (uf::is_big_head_dim(C, nH))
    return uf::attention_bwd_big_heads_scratch(ts, C, nH);
  if (is_bf16)
    return uf::with_bwd_tile(C, nH, [](auto c, auto d) {
      return uf::attn_bwd_big(decltype(c)::value, decltype(d)::value) ? 4
                                                                      : 0;
    });
  return uf::with_head_dim(C, nH, [&](auto d) {
    return uf::attn_bwd_window_scratch<decltype(d)::value>(ts, C);
  });
}

// Returns a cudaError_t. is_bf16 selects bf16 (else fp32) for x, g, mod,
// the weight matrices and every per-token output; head dims 24-56 and
// 72-128 take one window a block in both dtypes (wn and hpb ignored); in
// bf16 (C
// 16-1024 in powers of 2, head dim 8 from C = 32, at most 16 heads) a
// block takes wn
// windows and the partial sums are per block (ceil(windows / wn) rows),
// or, with hpb < nH (wn 1), hpb heads of one window, whose fp32 dxm
// shares go through part_dxm (nH / hpb x windows x 64 x C floats; also
// with hpb = nH where uf_attention_bwd_scratch sets bit 2); fp32 takes
// one window a block.
// Biases, LayerNorm parameters, the bias table and the partial sums are
// fp32. mod, ln_s / ln_b (has_ln = 0), dmod_part, dln_part, the scratches
// and part_dxm may be null where not needed.
int uf_attention_bwd(int is_bf16, const void* x, const void* g,
                     const void* mod, const float* ln_s, const float* ln_b,
                     const void* wq, const float* bq, const void* wkv,
                     const float* bkv, const void* wo, const float* bias,
                     void* dx, void* xm_w, void* dqkv_w, void* o_img,
                     float* dbias_part, float* dmod_part, float* dln_part,
                     void* x_scratch, void* do_scratch, float* part_dxm,
                     int B, int H, int W, int C, int nH, int shift,
                     float scale, int has_ln, int residual, int wn, int hpb,
                     void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return uf::run(uf::attn_bwd_params<uf::bf16>(
                       x, g, mod, ln_s, ln_b, wq, bq, wkv, bkv, wo, bias, dx,
                       xm_w, dqkv_w, o_img, dbias_part, dmod_part, dln_part,
                       x_scratch, do_scratch, part_dxm, B, H, W, C, nH,
                       shift, scale, has_ln, residual),
                   wn, hpb, s);
  return uf::run(uf::attn_bwd_params<float>(
                     x, g, mod, ln_s, ln_b, wq, bq, wkv, bkv, wo, bias, dx,
                     xm_w, dqkv_w, o_img, dbias_part, dmod_part, dln_part,
                     x_scratch, do_scratch, part_dxm, B, H, W, C, nH, shift,
                     scale, has_ln, residual),
                 wn, hpb, s);
}

}  // extern "C"
