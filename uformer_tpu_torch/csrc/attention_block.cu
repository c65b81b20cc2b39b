// Windowed LeWin attention block for Hopper (sm_90a).
//
// Replaces uformer_tpu/ops/pallas/attention_block.py:fused_attention_block
// (its unpacked form; the packed variant is the TPU's 128-lane pixel
// packing of the same function): on (Bw, 64, C) windows already shifted
// and partitioned, [LN1] + modulator, q/kv projection, fp32-softmax
// window attention with relative-position bias and the inline SW-MSA
// mask, output projection. The attention branch only, no residual. Head
// dim 16 or 32. Window i lies at place (w_off + i) mod nW of its H x W
// image, which sets its region ids.
//
// What bounds it on the H100: at Uformer_T's enc0 (C = 16, one head,
// 8192 windows of a 256^2 batch-8 stage) memory: 34 MB read and written
// in bf16 (10 us at 3.35 TB/s) against 3.2 GFLOP (3 us on the tensor
// cores). Design: the body of attention_window.cuh with the identity
// token map, one block per window, its working set in shared memory; the
// block is sized to C (128 threads at C <= 32, 256 at C <= 64), since a
// 64 x 16 head tile is only 4 WMMA fragments and 16 warps would idle.
#include "attention_window.cuh"

namespace uf {

static int block_threads(int C) {
  return C <= 32 ? 128 : (C <= 64 ? 256 : kThreads);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    attention_block_kernel(AttnParams<T> p) {
  extern __shared__ __align__(128) unsigned char smem[];
  attention_window<T, D, 0>(p, blockIdx.x, smem, blockIdx.x);
}

template <typename T, int D>
static int launch(const AttnParams<T>& p, int Bw, cudaStream_t stream) {
  const size_t smem = attn_layout<D>(sizeof(T), p.C).total;
  cudaError_t e = cudaFuncSetAttribute(
      attention_block_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  attention_block_kernel<T, D>
      <<<Bw, block_threads(p.C), smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
static int run(const void* x, void* y, const void* mod, const float* ln_s,
               const float* ln_b, const void* wq, const float* bq,
               const void* wkv, const float* bkv, const void* wo,
               const float* bo, const float* bias, void* scratch, int Bw,
               int H, int W, int C, int nH, int shift, int w_off,
               float scale, int has_ln, void* stream) {
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
  p.B = 1;
  p.H = H;
  p.W = W;
  p.C = C;
  p.nH = nH;
  p.shift = shift;
  p.scale = scale;
  p.has_ln = has_ln;
  p.residual = 0;
  p.windows = 1;
  p.w_off = w_off;
  return with_head_dim(C, nH, [&](auto d) {
    return launch<T, decltype(d)::value>(p, Bw,
                                         static_cast<cudaStream_t>(stream));
  });
}

}  // namespace uf

extern "C" {

// Returns a cudaError_t. is_bf16 selects bf16 (else fp32) for x, y, mod
// and the weight matrices; biases, LayerNorm parameters and the
// (nH, 64, 64) bias are fp32. mod may be null; ln_s / ln_b are read only
// with has_ln. scratch: see uf_attention_needs_scratch.
int uf_attention_block(int is_bf16, const void* x, void* y, const void* mod,
                       const float* ln_s, const float* ln_b, const void* wq,
                       const float* bq, const void* wkv, const float* bkv,
                       const void* wo, const float* bo, const float* bias,
                       void* scratch, int Bw, int H, int W, int C, int nH,
                       int shift, int w_off, float scale, int has_ln,
                       void* stream) {
  if (is_bf16)
    return uf::run<uf::bf16>(x, y, mod, ln_s, ln_b, wq, bq, wkv, bkv, wo, bo,
                             bias, scratch, Bw, H, W, C, nH, shift, w_off,
                             scale, has_ln, stream);
  return uf::run<float>(x, y, mod, ln_s, ln_b, wq, bq, wkv, bkv, wo, bo, bias,
                        scratch, Bw, H, W, C, nH, shift, w_off, scale, has_ln,
                        stream);
}

}  // extern "C"
