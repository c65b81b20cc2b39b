// Windowed LeWin attention block for Hopper (sm_90a).
//
// Replaces uformer_tpu/ops/pallas/attention_block.py:fused_attention_block
// (its unpacked form; the packed variant is the TPU's 128-lane pixel
// packing of the same function): on (Bw, 64, C) windows already shifted
// and partitioned, [LN1] + modulator, q/kv projection, fp32-softmax
// window attention with relative-position bias and the inline SW-MSA
// mask, output projection. The attention branch only, no residual. Head
// dim 8, 16, 32 or 64, 24, 40, 48 or 56 (attention_block_heads.cu), and
// 72-128 in steps of 8 (attention_block_big_heads.cu);
// window win 1-8 (N = win^2 tokens). Window i lies at
// place (w_off + i) mod nW of its H x W image (nW = (H / win)(W / win)),
// which sets its region ids (from size - win, as the TPU kernel's
// _region_ids).
//
// What bounds it on the H100: at Uformer_T's enc0 (C = 16, one head,
// 8192 windows of a 256^2 batch-8 stage) memory: 34 MB read and written
// in bf16 (10 us at 3.35 TB/s) against 3.2 GFLOP (3 us on the tensor
// cores); a window is so little work that latency between its steps, not
// either rate, sets the pace of a body that runs one window per block.
// Design:
//   - bf16 at C 16, 32 and 64 (attention_block_narrow.cu): kernel 1's
//     narrow body (attention_narrow_mma.cuh) on identity windows:
//     persistent blocks with the weights resident, four warps a window,
//     the window core in registers (window_core_mma.cuh), the next
//     window's rows in flight. The host plans windows per work item and
//     the grid as for kernel 1 (attention_image_plan, persistent_grid);
//   - fp32 (the exact-check path) and bf16 at other widths: one window per
//     block of attention_window.cuh, sized to C (128 threads at C <= 32,
//     256 at C <= 64), WMMA products through shared memory (at C = 1024,
//     an --embed_dim 64 model's bottleneck below window 8, xm and O in the
//     block's scratch slot). Head dims 24-56 (--embed_dim 24-56: C 24-896,
//     none a power of two) run only here, in bf16 on weights staged in
//     zero-padded chunks (attention_window.cuh: attn_stage_w); C >= 128 runs here at window 8 on no model
//     path: the model's image route takes every C % 128 == 0
//     (models/layers.py:LeWinBlock.image_route). Head dims 72-128
//     (--embed_dim 72-128: C 72-2048) run here too, on bodies of width 80,
//     96, 112 or 128 that project q, k and v in turn; xm and O go to the
//     block's scratch slot where they miss shared memory (in bf16 from C
//     448-768, in fp32 from C 224-384);
//   - windows of N = win^2 < 64 tokens (a stage below the window, or
//     --win_size below 8) in packed tiles: a block (or, in bf16 at C
//     8-64, a group of four warps of attention_block_packed.cu) takes 64
//     rows holding 64 / N whole windows, with the host's tiles of the
//     modulator and of the bias, which is -inf between two windows
//     (ops/kernels/attention_block.py:packed_operands). The window core
//     and the projections then run as on an 8x8 window; the core does up
//     to 64 / N times the work a window needs, which at C 128-512 is a
//     small share of the projections. Padding rows (a tile's last 64 mod
//     N, and windows past Bw) read as zeros and are never written.
#include "attention_block.cuh"
#include "attention_narrow_mma.cuh"

namespace uf {

template <typename T>
static int run(const void* x, void* y, const void* mod, const float* ln_s,
               const float* ln_b, const void* wq, const float* bq,
               const void* wkv, const float* bkv, const void* wo,
               const float* bo, const float* bias, void* scratch, int Bw,
               int H, int W, int C, int nH, int win, int shift, int w_off,
               float scale, int has_ln, int wn, int grid, void* stream) {
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
  p.win = win;
  p.n_win = Bw;
  auto s = static_cast<cudaStream_t>(stream);
  const bool packed = win != 8;
  if (win < 1 || win > 8) return (int)cudaErrorInvalidValue;
  if constexpr (std::is_same<T, bf16>::value) {
    const int D = nH > 0 ? C / nH : 0;
    if (nH > 0 && C % nH == 0 && attn_narrow_fits(C, D))
      return packed ? attention_block_packed(p, D, wn, grid, s)
                    : attention_block_narrow(p, D, Bw, wn, grid, s);
  }
  const int G = 64 / (win * win), tiles = (Bw + G - 1) / G;
  if (is_new_head_dim(C, nH))
    return attention_block_heads<T>(p, packed ? tiles : Bw, packed, s);
  if (is_big_head_dim(C, nH))
    return attention_block_big_heads<T>(p, packed ? tiles : Bw, packed, s);
  return with_head_dim(C, nH, [&](auto d) {
    constexpr int Dd = decltype(d)::value;
    return packed ? launch_block<T, Dd, true>(p, tiles, s)
                  : launch_block<T, Dd>(p, Bw, s);
  });
}

}  // namespace uf

extern "C" {

// The blocks of kernel 5's persistent bf16 body for (C, D) at wn windows
// (packed: tiles) per work item that are resident on the card at once; 0
// where (dtype, C, D) runs one window (tile) per block; a negated
// cudaError_t on failure.
int uf_attention_block_slots(int is_bf16, int C, int D, int wn,
                             int packed) {
  int slots = 0, e = 0;
  if (is_bf16 && uf::attn_narrow_fits(C, D))
    e = packed ? uf::attention_block_packed_slots(C, D, wn, &slots)
               : uf::attention_block_narrow_slots(C, D, wn, &slots);
  return e ? -e : slots;
}

// Returns a cudaError_t. is_bf16 selects bf16 (else fp32) for x, y, mod
// and the weight matrices; biases, LayerNorm parameters and the
// (nH, 64, 64) bias are fp32. x, y: (Bw, win^2, C); at win < 8, mod
// (64, C) and bias (nH, 64, 64) are the host's tiles of them
// (packed_operands). mod may be null; ln_s / ln_b are read only with
// has_ln. scratch: see uf_attention_needs_scratch (its tiles per window,
// at win < 8 per packed tile). wn and grid: windows (tiles) per work item and blocks of the
// persistent bf16 body (attention_image_plan); the one-window-per-block
// body ignores them.
int uf_attention_block(int is_bf16, const void* x, void* y, const void* mod,
                       const float* ln_s, const float* ln_b, const void* wq,
                       const float* bq, const void* wkv, const float* bkv,
                       const void* wo, const float* bo, const float* bias,
                       void* scratch, int Bw, int H, int W, int C, int nH,
                       int win, int shift, int w_off, float scale,
                       int has_ln, int wn, int grid, void* stream) {
  if (is_bf16)
    return uf::run<uf::bf16>(x, y, mod, ln_s, ln_b, wq, bq, wkv, bkv, wo, bo,
                             bias, scratch, Bw, H, W, C, nH, win, shift,
                             w_off, scale, has_ln, wn, grid, stream);
  return uf::run<float>(x, y, mod, ln_s, ln_b, wq, bq, wkv, bkv, wo, bo, bias,
                        scratch, Bw, H, W, C, nH, win, shift, w_off, scale,
                        has_ln, wn, grid, stream);
}

}  // extern "C"
