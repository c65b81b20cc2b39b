// Image-layout LeWin attention sub-block for Hopper (sm_90a).
//
// Replaces uformer_tpu/ops/pallas/attention_image.py:fused_attention_image
// (and its pixel-packed narrow-C variant): LN1, cyclic shift, window
// partition, modulator, q/kv projection, fp32-softmax window attention
// with relative-position bias and the inline SW-MSA mask, output
// projection, reverse, unshift and [residual], reading and writing the
// NHWC image once. Head dim 8-128, a multiple of 8.
//
// What bounds it on the H100: per window the projections are 4*64*C*C
// MACs against 2*64*C bytes of activations; at every width the card
// could do a window's work in far less time than a block-wide sequence of
// small products and barriers takes, so latency, not bytes or tensor-core
// rate, sets the pace. bf16 runs two persistent bodies on mma.sync with
// register accumulators, chosen by C:
//   - C 16, 32, 64 (attention_image_narrow.cu, attention_narrow_mma.cuh):
//     weights resident in shared memory, four warps a window with the
//     window core in registers, the next window's gather in flight;
//   - C 128, 256, 512 (attention_image_wide.cu): the stage kernel's
//     attention half (attention_mma.cuh), 1-4 windows per work item, the
//     weights streamed through a cp.async ring.
// The host (ops/kernels/attention_image.py:attention_image_plan) picks the
// windows per work item and the grid. Head dims 24, 40, 48 and 56 (C
// 384-896 where the image route takes an --embed_dim 24-56 model's
// blocks, in training) run kernel 5's instantiation of the one-window
// body (attention_block_heads.cu) with the image token map, in both
// dtypes, and head dims 72-128 (an --embed_dim 72-128 model's blocks where
// C % 128 == 0, in training; in eval the stage takes them) its width-80-128
// instantiation (attention_block_big_heads.cu: q, k and v projected in
// turn, xm and O through the block's scratch slot where they miss shared
// memory). Head dim 8 runs the narrow body at
// C 32 and 64 and the wide one at C 128; head dim 64 (--embed_dim 64) the
// narrow body at C 64 (one head) and the wide one at C 128-512. fp32 (the
// exact-check path) and bf16 at other widths (C 1024) run one window per
// block of attention_window.cuh (WMMA products through shared memory).
#include "attention_block.cuh"
#include "attention_image.cuh"
#include "attention_mma.cuh"
#include "attention_narrow_mma.cuh"

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
  if (!attn_window_fits(sizeof(T), p.C, D)) return (int)cudaErrorInvalidValue;
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
               int has_ln, int residual, int wn, int grid, void* stream) {
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
  auto s = static_cast<cudaStream_t>(stream);
  if (is_new_head_dim(C, nH))
    return attention_block_heads(p, B * (H / 8) * (W / 8), false, s);
  if (is_big_head_dim(C, nH))
    return attention_block_big_heads(p, B * (H / 8) * (W / 8), false, s);
  if constexpr (std::is_same<T, bf16>::value) {
    const int D = nH > 0 ? C / nH : 0;
    if (nH > 0 && C % nH == 0 && attn_narrow_fits(C, D) &&
        (D != 8 || C >= 32))
      return attention_image_narrow(p, D, wn, grid, s);
    if (nH > 0 && C % nH == 0 && attn_wide_fits(C, D))
      return attention_image_wide(p, D, wn, grid, s);
  }
  return with_head_dim(C, nH, [&](auto d) {
    return launch<T, decltype(d)::value>(p, s);
  });
}

}  // namespace uf

extern "C" {

const char* uf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The 64 x C tiles of one window (head dim D) that do not fit in shared
// memory, 0, 1 or 2 (attention_window.cuh: the head outputs, then the
// LN1 output too): the caller passes a scratch tensor of that many times
// the input's shape and dtype (attention_image in fp32 or at widths
// without a bf16 body, stage, attention_block). D 8-128, a multiple of 8
// (72-128 on the body of the next multiple of 16, with_big_head_dim);
// any other D, which no body takes, a negated cudaErrorInvalidValue.
int uf_attention_needs_scratch(int is_bf16, int C, int D) {
  const int ts = is_bf16 ? 2 : 4;
  switch (D) {
    case 8: return uf::attn_layout<8>(ts, C).regions();
    case 16: return uf::attn_layout<16>(ts, C).regions();
    case 24: return uf::attn_layout<24>(ts, C).regions();
    case 32: return uf::attn_layout<32>(ts, C).regions();
    case 40: return uf::attn_layout<40>(ts, C).regions();
    case 48: return uf::attn_layout<48>(ts, C).regions();
    case 56: return uf::attn_layout<56>(ts, C).regions();
    case 64: return uf::attn_layout<64>(ts, C).regions();
    case 72: case 80: return uf::attn_layout<80>(ts, C).regions();
    case 88: case 96: return uf::attn_layout<96>(ts, C).regions();
    case 104: case 112: return uf::attn_layout<112>(ts, C).regions();
    case 120: case 128: return uf::attn_layout<128>(ts, C).regions();
  }
  return -(int)cudaErrorInvalidValue;
}

// The blocks of kernel 1's persistent bf16 body for (C, D) at wn windows
// per work item that are resident on the card at once; 0 where (dtype, C,
// D) runs one window per block; a negated cudaError_t on failure.
int uf_attention_image_slots(int is_bf16, int C, int D, int wn) {
  int slots = 0, e = 0;
  if (is_bf16 && uf::attn_narrow_fits(C, D) && (D != 8 || C >= 32))
    e = uf::attention_image_narrow_slots(C, D, wn, &slots);
  else if (is_bf16 && uf::attn_wide_fits(C, D))
    e = uf::attention_image_wide_slots(C, D, wn, &slots);
  return e ? -e : slots;
}

// Returns a cudaError_t (0 on success). is_bf16 selects bf16 (else fp32)
// for x, y, mod and the weight matrices; biases, LayerNorm parameters and
// the (nH, 64, 64) bias are fp32. wn and grid: windows per work item and
// blocks of the persistent bf16 bodies (attention_image_plan); the
// one-window-per-block body ignores them.
int uf_attention_image(int is_bf16, const void* x, void* y, const void* mod,
                       const float* ln_s, const float* ln_b, const void* wq,
                       const float* bq, const void* wkv, const float* bkv,
                       const void* wo, const float* bo, const float* bias,
                       void* scratch, int B, int H, int W, int C, int nH,
                       int shift, float scale, int has_ln, int residual,
                       int wn, int grid, void* stream) {
  if (is_bf16)
    return uf::run<uf::bf16>(x, y, mod, ln_s, ln_b, wq, bq, wkv, bkv, wo, bo,
                             bias, scratch, B, H, W, C, nH, shift, scale,
                             has_ln, residual, wn, grid, stream);
  return uf::run<float>(x, y, mod, ln_s, ln_b, wq, bq, wkv, bkv, wo, bo, bias,
                        scratch, B, H, W, C, nH, shift, scale, has_ln,
                        residual, wn, grid, stream);
}

}  // extern "C"
