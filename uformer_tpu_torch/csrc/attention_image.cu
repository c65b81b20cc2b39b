// Image-layout LeWin attention sub-block for Hopper (sm_90a).
//
// Replaces uformer_tpu/ops/pallas/attention_image.py:fused_attention_image
// (and its pixel-packed narrow-C variant): LN1, cyclic shift, window
// partition, modulator, q/kv projection, fp32-softmax window attention
// with relative-position bias and the inline SW-MSA mask, output
// projection, reverse, unshift and residual, reading and writing the NHWC
// image once. Head dim 16 or 32.
//
// What bounds it on the H100: per window the projections are 4*64*C*C
// MACs against 2*64*C bytes of activations, so at C >= 128 it is
// tensor-core work fed from L2 (the weights are re-read by every window),
// and at C = 32/64 the fp32 softmax and the gathers dominate. Design: one
// block per window (the image token map of attention_window.cuh); the
// token tile, the per-head q/k/v, the probabilities and the concatenated
// head outputs live in shared memory; products run on the tensor cores
// (WMMA, fp32 accumulation). In bf16 at C % 128 == 0 each window copies
// its weights into shared memory chunk by chunk; wgmma and TMA are later
// work.
#include "attention_window.cuh"

namespace uf {

// Two blocks per SM: one window per block leaves the block's shared
// memory small at C <= 64, so registers set the occupancy; above 64 per
// thread (66 in bf16 at D = 32 when left free) one block fits, and the
// Uformer_B forward ran 1.4% slower.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
    attention_image_kernel(AttnParams<T> p) {
  extern __shared__ __align__(128) unsigned char smem[];
  attention_window<T, D>(p, blockIdx.x, smem, blockIdx.x);
}

template <typename T, int D>
static int launch(const AttnParams<T>& p, cudaStream_t stream) {
  const size_t smem = attn_layout<D>(sizeof(T), p.C).total;
  cudaError_t e = cudaFuncSetAttribute(
      attention_image_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = p.B * (p.H / 8) * (p.W / 8);
  attention_image_kernel<T, D><<<blocks, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
static int run(const void* x, void* y, const void* mod, const float* ln_s,
               const float* ln_b, const void* wq, const float* bq,
               const void* wkv, const float* bkv, const void* wo,
               const float* bo, const float* bias, void* scratch, int B,
               int H, int W, int C, int nH, int shift, float scale,
               int has_ln, int residual, void* stream) {
  AttnParams<T> p;
  p.x = static_cast<const T*>(x);
  p.y = static_cast<T*>(y);
  p.mod = static_cast<const T*>(mod);
  p.ln_s = ln_s;
  p.ln_b = ln_b;
  p.wq = static_cast<const T*>(wq);
  p.bq = bq;
  p.wk = static_cast<const T*>(wkv);
  p.wv = static_cast<const T*>(wkv) + C;
  p.bk = bkv;
  p.bv = bkv + C;
  p.ldkv = 2 * C;
  p.wo = static_cast<const T*>(wo);
  p.bo = bo;
  p.bias = bias;
  p.o_scratch = static_cast<T*>(scratch);
  p.B = B;
  p.H = H;
  p.W = W;
  p.C = C;
  p.nH = nH;
  p.shift = shift;
  p.scale = scale;
  p.has_ln = has_ln;
  p.residual = residual;
  p.windows = 0;
  p.w_off = 0;
  return with_head_dim(C, nH, [&](auto d) {
    return launch<T, decltype(d)::value>(p,
                                         static_cast<cudaStream_t>(stream));
  });
}

}  // namespace uf

extern "C" {

const char* uf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// 1 when the head outputs of one window (head dim D) do not fit in shared
// memory and the caller must pass a scratch tensor of the input's shape
// and dtype (attention_image, stage, attention_block).
int uf_attention_needs_scratch(int is_bf16, int C, int D) {
  const int ts = is_bf16 ? 2 : 4;
  return (D == 16 ? uf::attn_layout<16>(ts, C).o_smem
                  : uf::attn_layout<32>(ts, C).o_smem) ? 0 : 1;
}

// Returns a cudaError_t (0 on success). is_bf16 selects bf16 (else fp32)
// for x, y, mod and the weight matrices; biases, LayerNorm parameters and
// the (nH, 64, 64) bias are fp32.
int uf_attention_image(int is_bf16, const void* x, void* y, const void* mod,
                       const float* ln_s, const float* ln_b, const void* wq,
                       const float* bq, const void* wkv, const float* bkv,
                       const void* wo, const float* bo, const float* bias,
                       void* scratch, int B, int H, int W, int C, int nH,
                       int shift, float scale, int has_ln, int residual,
                       void* stream) {
  if (is_bf16)
    return uf::run<uf::bf16>(x, y, mod, ln_s, ln_b, wq, bq, wkv, bkv, wo, bo,
                             bias, scratch, B, H, W, C, nH, shift, scale,
                             has_ln, residual, stream);
  return uf::run<float>(x, y, mod, ln_s, ln_b, wq, bq, wkv, bkv, wo, bo, bias,
                        scratch, B, H, W, C, nH, shift, scale, has_ln,
                        residual, stream);
}

}  // extern "C"
