// Backward of the windowed LeWin attention block for Hopper (sm_90a), head
// dim 8, 16, 32 or 64; 24, 40, 48 and 56 on the one-window body of
// attention_bwd_heads.cu, 72-128 on attention_bwd_big_heads.cu's (both
// dtypes, every window 1-8).
//
// Replaces uformer_tpu/ops/pallas/attention_block.py:
// fused_attention_block_bwd in its own layout (its unpacked form; the
// packed variant is the TPU's 128-lane pixel packing of the same
// function): the VJP of attention_block.cu's function on (Bw, 64, C)
// windows already shifted and partitioned, [LN1] + modulator, q/kv
// projection, window core, output projection, with no residual. Window i
// lies at place i mod nW of its H x W image, which sets its region ids,
// as the forward's do (window_tokens, w_off = 0).
//
// One thread block per window runs attention_window_bwd.cuh with the
// identity token map (token t of window i is row i * 64 + t of x, g and
// dx), recomputing the forward and walking the VJP; xm, [dq | dk | dv] and
// the head outputs go to per-token buffers, and the weight gradients are
// reduced over every token afterwards (wgrad.cuh), as for the image
// layout (attention_bwd.cu).
//
// What bounds it on the H100: at Uformer_T's enc0 (C = 16, one head) the
// per-window work is the fp32 softmax VJP and six 64 x 64 x 16 products,
// one k-step each, between barriers; the bytes (x, g and dx, the
// per-token buffers, the dbias share of 16 KB) bound it, not the
// operations. bf16 runs the image layout's tile (attention_bwd_mma.cuh)
// with this token map, a block taking 1-4 windows (their dbias, dmod and
// dln shares summed before they are written); fp32 the FMA body of
// attention_window_bwd.cuh, one window per block. Windows of N = win^2 <
// 64 tokens run in packed tiles (attention_block_bwd_packed.cu).
#include "attention_bwd_mma.cuh"

namespace uf {

// (two blocks per SM at C <= 64, whose latency-bound windows fill each
// other's gaps between barriers; 64 registers, 24-128 B of spills)
template <int C, int D>
__global__ void __launch_bounds__(kThreads, C <= 64 ? 2 : 1)
    attention_block_bwd_mma_kernel(AttnBwdParams<bf16> p, int wn,
                                   int n_win, int hpb, int finish) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int nW = (p.H / 8) * (p.W / 8);
  auto map = [&](int w, int t, int* pix, int* rid) {
    *pix = w * 64 + t;
    *rid = window_region(w % nW, t, p.H, p.W, p.shift);
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
static int run(const AttnBwdParams<T>& p, int Bw, int wn, int hpb,
               cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    return with_bwd_tile(p.C, p.nH, [&](auto c, auto d) {
      constexpr int C = decltype(c)::value, D = decltype(d)::value;
      return launch_attn_bwd_mma<C, D>(attention_block_bwd_mma_kernel<C, D>,
                                       p, wn, Bw, hpb, stream);
    });
  } else {
    return launch_attn_bwd(p, Bw, 1, stream);
  }
}

}  // namespace uf

extern "C" {

// Returns a cudaError_t. x, g and dx are (Bw, N, C) windows of win x win
// tokens (win 1-8, N = win^2) of H x W images; the other arguments as
// uf_attention_bwd takes them (xm_w, dqkv_w and o_img per token in window
// order), with no residual, wn windows or hpb heads per block in bf16 as
// there. At win < 8 the work items are the ceil(Bw / (64 / N)) packed
// tiles: mod (64, C) and bias (nH, 64, 64) the host's tiles, xm_w, dqkv_w,
// the partial sums and the scratches per tile (64 rows each). The scratch
// needs are uf_attention_bwd_scratch's.
int uf_attention_block_bwd(int is_bf16, const void* x, const void* g,
                           const void* mod, const float* ln_s,
                           const float* ln_b, const void* wq,
                           const float* bq, const void* wkv,
                           const float* bkv, const void* wo,
                           const float* bias, void* dx, void* xm_w,
                           void* dqkv_w, void* o_img, float* dbias_part,
                           float* dmod_part, float* dln_part,
                           void* x_scratch, void* do_scratch,
                           float* part_dxm, int Bw, int H, int W, int C,
                           int nH, int win, int shift, float scale,
                           int has_ln, int wn, int hpb, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int tiles = win < 8 ? (Bw + 64 / (win * win) - 1) / (64 / (win * win))
                            : Bw;
  const bool big = uf::is_big_head_dim(C, nH);
  if (uf::is_new_head_dim(C, nH) || big) {  // the one-window bodies
    auto run = [&](auto p) {
      p.win = win;
      p.n_win = Bw;
      const int map = win == 8 ? 1 : 2;
      return big ? uf::attention_bwd_big_heads(p, tiles, map, s)
                 : uf::attention_bwd_heads(p, tiles, map, s);
    };
    if (is_bf16)
      return run(uf::attn_bwd_params<uf::bf16>(
          x, g, mod, ln_s, ln_b, wq, bq, wkv, bkv, wo, bias, dx, xm_w,
          dqkv_w, o_img, dbias_part, dmod_part, dln_part, x_scratch,
          do_scratch, part_dxm, 1, H, W, C, nH, shift, scale, has_ln, 0));
    return run(uf::attn_bwd_params<float>(
        x, g, mod, ln_s, ln_b, wq, bq, wkv, bkv, wo, bias, dx, xm_w, dqkv_w,
        o_img, dbias_part, dmod_part, dln_part, x_scratch, do_scratch,
        part_dxm, 1, H, W, C, nH, shift, scale, has_ln, 0));
  }
  if (is_bf16) {
    auto p = uf::attn_bwd_params<uf::bf16>(
        x, g, mod, ln_s, ln_b, wq, bq, wkv, bkv, wo, bias, dx, xm_w, dqkv_w,
        o_img, dbias_part, dmod_part, dln_part, x_scratch, do_scratch,
        part_dxm, 1, H, W, C, nH, shift, scale, has_ln, 0);
    if (win == 8) return uf::run(p, Bw, wn, hpb, s);
    p.win = win;
    p.n_win = Bw;
    return uf::attention_block_bwd_packed(p, tiles, wn, hpb, s);
  }
  auto p = uf::attn_bwd_params<float>(
      x, g, mod, ln_s, ln_b, wq, bq, wkv, bkv, wo, bias, dx, xm_w, dqkv_w,
      o_img, dbias_part, dmod_part, dln_part, x_scratch, do_scratch,
      part_dxm, 1, H, W, C, nH, shift, scale, has_ln, 0);
  if (win == 8) return uf::run(p, Bw, wn, hpb, s);
  p.win = win;
  p.n_win = Bw;
  return uf::attention_block_bwd_packed(p, tiles, s);
}

}  // extern "C"
