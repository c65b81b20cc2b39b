// Backward of the windowed LeWin attention block for Hopper (sm_90a), head
// dim 16 or 32.
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
// one WMMA k-step each, between barriers; the bytes (x, g and dx, the
// per-token buffers, the per-window dbias share of 16 KB) bound it, not
// the operations. The design keeps the image layout's body unchanged; a
// block of several windows would fill its warps (not done here).
#include "attention_window_bwd.cuh"

namespace uf {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    attention_block_bwd_kernel(AttnBwdParams<T> p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const auto L = attn_bwd_layout<D>(sizeof(T), p.C);
  const int tid = threadIdx.x, w = blockIdx.x;
  const int nW = (p.H / 8) * (p.W / 8);
  int* pix = reinterpret_cast<int*>(smem + L.pix);
  int* rid = reinterpret_cast<int*>(smem + L.rid);
  if (tid < 64) {
    pix[tid] = w * 64 + tid;
    rid[tid] = window_region(w % nW, tid, p.H, p.W, p.shift);
  }
  __syncthreads();
  attention_window_bwd<T, D>(p, w, smem);
}

template <typename T>
static int run(const AttnBwdParams<T>& p, int Bw, cudaStream_t stream) {
  return launch_attn_bwd(p, Bw, stream, [](auto d) {
    return attention_block_bwd_kernel<T, decltype(d)::value>;
  });
}

}  // namespace uf

extern "C" {

// Returns a cudaError_t. x, g and dx are (Bw, 64, C) windows of H x W
// images; the other arguments as uf_attention_bwd takes them (xm_w,
// dqkv_w and o_img per token in window order), with no residual. The
// scratch needs are uf_attention_bwd_scratch's.
int uf_attention_block_bwd(int is_bf16, const void* x, const void* g,
                           const void* mod, const float* ln_s,
                           const float* ln_b, const void* wq,
                           const float* bq, const void* wkv,
                           const float* bkv, const void* wo,
                           const float* bias, void* dx, void* xm_w,
                           void* dqkv_w, void* o_img, float* dbias_part,
                           float* dmod_part, float* dln_part,
                           void* x_scratch, void* do_scratch, int Bw, int H,
                           int W, int C, int nH, int shift, float scale,
                           int has_ln, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return uf::run(uf::attn_bwd_params<uf::bf16>(
                       x, g, mod, ln_s, ln_b, wq, bq, wkv, bkv, wo, bias, dx,
                       xm_w, dqkv_w, o_img, dbias_part, dmod_part, dln_part,
                       x_scratch, do_scratch, 1, H, W, C, nH, shift, scale,
                       has_ln, 0),
                   Bw, s);
  return uf::run(uf::attn_bwd_params<float>(
                     x, g, mod, ln_s, ln_b, wq, bq, wkv, bkv, wo, bias, dx,
                     xm_w, dqkv_w, o_img, dbias_part, dmod_part, dln_part,
                     x_scratch, do_scratch, 1, H, W, C, nH, shift, scale,
                     has_ln, 0),
                 Bw, s);
}

}  // extern "C"
