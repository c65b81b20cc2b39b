// Whole-stage LeWin kernel for Hopper (sm_90a): every block of a stage in
// one cooperative persistent launch.
//
// Replaces uformer_tpu/ops/pallas/stage.py:fused_stage. For each block j:
// the attention sub-block over all windows, a grid barrier, the LeFF
// sub-block over all tiles, a grid barrier. Weights come from the
// depth-stacked arrays at index j; the shift is on for odd j when
// use_shift. Head dim 8 (at C = 128 in bf16's tensor-core body: an
// embed-8 model's bottleneck and dec0), 16, 32 or 64 (an --embed_dim 64
// model's stages, C 128-1024), and 24, 40, 48 or 56 (stage_heads.cu: an
// --embed_dim 24-56 model's stages at C 384-896, the generic bodies
// below). In bf16 at C 128, 256 and 512 both halves
// run on mma.sync with register accumulators and weights streamed through
// cp.async rings: the attention of attention_mma.cuh (1-4 windows per work
// item) and the wide LeFF tile of leff_mma.cuh (8 or 16 x 8 outputs), the
// host picking windows per item and tile rows from the work and the SMs.
// In bf16 at C 1024 (an --embed_dim 64 model's bottleneck and dec0, 16
// heads of 64, hidden 4096: 24 MB of weights a block) the attention half
// is attn_wide_item_l2 (one window an item, O through the block's scratch
// slot in L2) and the LeFF tile 4 x 8; every work item streams the
// block's weights through its cp.async ring, from L2 after the first
// items read them from HBM. In fp32 at C 64-512, head dim 16 or 32
// (every fp32 stage of Uformer_T, _S and _B: the eval CLI's default
// dtype), both halves run on the three-pass TF32 tiles of mma_tf32.cuh
// (stage_f32.cu): the attention of attention_f32.cuh (1 or 2 windows per
// work item, picked here as for bf16) and the LeFF tile of leff_f32.cuh
// (8 x 8, 4 x 8 at C 512). fp32 at other widths and head dims (8, 24-56, 64; C 1024),
// and bf16 at the widths without a tensor-core body, run
// attention_window.cuh and leff_tile.cuh.
//
// What bounds it on the H100: at the 16^2..64^2 stages each sub-block is
// tens of microseconds of work, so per-kernel launches, tails and weight
// ramp-up matter as much as the products. Design: one launch per stage,
// sized by occupancy to the whole card; the stage image (2-17 MB in bf16
// at batch 8 for enc2..dec1, 33.5 MB at dec2) ping-pongs between two
// buffers that largely stay in the 50 MB L2, Hopper's counterpart of the
// TPU kernel's VMEM residency. The grid barrier costs a few microseconds
// per sub-block.
#include "stage.cuh"

namespace uf {

// Windows per work item of the tensor-core attention: the most, up to
// max_wn (a power of two), that do not add a round of items over the
// `slots` resident blocks.
static int item_windows(int n_win, int slots, int max_wn) {
  int best = 1;
  long best_cost = -1;
  for (int wn = 1; wn <= max_wn; wn *= 2) {
    const int items = (n_win + wn - 1) / wn;
    const long cost = (long)((items + slots - 1) / slots) * wn;
    if (best_cost < 0 || cost <= best_cost) {
      best = wn;
      best_cost = cost;
    }
  }
  return best;
}

// The card's SMs, in *sms.
static cudaError_t card_sms(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return e;
}

template <int D, int CW, int WN>
static int launch_rows(const StageParams<bf16>& p, int th,
                       cudaStream_t stream) {
  if constexpr (CW == 1024) {
    return launch_stage<bf16, D, CW, WN, 4>(p, stream);
  } else {
    if constexpr (CW <= 256)
      if (th == 16) return launch_stage<bf16, D, CW, WN, 16>(p, stream);
    return launch_stage<bf16, D, CW, WN, 8>(p, stream);
  }
}

// The tensor-core stage at width CW: windows per attention item and rows
// per LeFF tile from the work and the SMs (one block each: 512 threads at
// up to 128 registers fill an SM's register file).
template <int D, int CW>
static int launch_wide(const StageParams<bf16>& p, cudaStream_t stream) {
  int sms = 0;
  const cudaError_t e = card_sms(&sms);
  if (e != cudaSuccess) return (int)e;
  // up to 512 / C windows an item, 2 at head dim 64 (attn_wide_wn_fits)
  const int most = D == 64 && 512 / CW > 2 ? 2 : 512 / CW;
  const int wn = item_windows(p.B * (p.H / 8) * (p.W / 8), sms, most);
  const int th = leff_wide_rows(p.B, p.H, p.W, CW, sms);
  if constexpr (attn_wide_wn_fits(CW, D, 4))
    if (wn == 4) return launch_rows<D, CW, 4>(p, th, stream);
  if constexpr (CW <= 256)
    if (wn == 2) return launch_rows<D, CW, 2>(p, th, stream);
  return launch_rows<D, CW, 1>(p, th, stream);
}

template <typename T>
static int run(const void* x, void* buf, void* out, void* scratch,
               const float* ln1_s, const float* ln1_b, const void* wq,
               const float* bq, const void* wk, const float* bk,
               const void* wv, const float* bv, const void* wo,
               const float* bo, const float* bias, const void* mod,
               const float* ln2_s, const float* ln2_b, const void* w1,
               const float* b1, const void* wd, const float* bd,
               const void* w2, const float* b2, int n, int B, int H, int W,
               int C, int nH, int Ch, int use_shift, float scale,
               void* stream) {
  StageParams<T> p;
  p.x = static_cast<const T*>(x);
  p.buf = static_cast<T*>(buf);
  p.out = static_cast<T*>(out);
  p.o_scratch = static_cast<T*>(scratch);
  p.ln1_s = ln1_s;
  p.ln1_b = ln1_b;
  p.wq = static_cast<const T*>(wq);
  p.bq = bq;
  p.wk = static_cast<const T*>(wk);
  p.bk = bk;
  p.wv = static_cast<const T*>(wv);
  p.bv = bv;
  p.wo = static_cast<const T*>(wo);
  p.bo = bo;
  p.bias = bias;
  p.mod = static_cast<const T*>(mod);
  p.ln2_s = ln2_s;
  p.ln2_b = ln2_b;
  p.w1 = static_cast<const T*>(w1);
  p.b1 = b1;
  p.wd = static_cast<const T*>(wd);
  p.bd = bd;
  p.w2 = static_cast<const T*>(w2);
  p.b2 = b2;
  p.n = n;
  p.B = B;
  p.H = H;
  p.W = W;
  p.C = C;
  p.nH = nH;
  p.Ch = Ch;
  p.use_shift = use_shift;
  p.scale = scale;
  auto s = static_cast<cudaStream_t>(stream);
  if constexpr (std::is_same<T, float>::value)
    if (nH > 0 && C % nH == 0 && stage_f32_fits(C, C / nH)) {
      // the three-pass TF32 bodies: windows per attention item as the
      // bf16 body picks them, up to attn_f32_max_windows
      int sms = 0;
      const cudaError_t e = card_sms(&sms);
      if (e != cudaSuccess) return (int)e;
      const int wn = item_windows(B * (H / 8) * (W / 8), sms,
                                  attn_f32_max_windows(C));
      return C / nH == 16 ? stage_f32<16>(p, wn, s) : stage_f32<32>(p, wn, s);
    }
  if (is_new_head_dim(C, nH)) return stage_heads<T>(p, s);
  return with_head_dim(C, nH, [&](auto d) {
    constexpr int D = decltype(d)::value;
    if constexpr (std::is_same<T, bf16>::value) {
      if (C == 128) return launch_wide<D, 128>(p, s);
      if constexpr (D != 8) {
        if (C == 256) return launch_wide<D, 256>(p, s);
        if (C == 512) return launch_wide<D, 512>(p, s);
      }
      if constexpr (attn_wide_l2_fits(1024, D))
        if (C == 1024) return launch_wide<D, 1024>(p, s);
    }
    return launch_stage<T, D, 0, 1, 0>(p, s);
  });
}

}  // namespace uf

extern "C" {

// Returns a cudaError_t (0 on success). is_bf16 selects bf16 (else fp32) for the
// activations and the weight matrices; biases, LayerNorm parameters and
// the relative-position bias are fp32. mod may be null (no modulator).
// fp32 at C 64-512, head dim 16 or 32, runs the three-pass TF32 bodies
// (stage_f32), other fp32 calls the generic ones.
int uf_stage(int is_bf16, const void* x, void* buf, void* out, void* scratch,
             const float* ln1_s, const float* ln1_b, const void* wq,
             const float* bq, const void* wk, const float* bk, const void* wv,
             const float* bv, const void* wo, const float* bo,
             const float* bias, const void* mod, const float* ln2_s,
             const float* ln2_b, const void* w1, const float* b1,
             const void* wd, const float* bd, const void* w2,
             const float* b2, int n, int B, int H, int W, int C, int nH,
             int Ch, int use_shift, float scale, void* stream) {
  if (is_bf16)
    return uf::run<uf::bf16>(x, buf, out, scratch, ln1_s, ln1_b, wq, bq, wk,
                             bk, wv, bv, wo, bo, bias, mod, ln2_s, ln2_b, w1,
                             b1, wd, bd, w2, b2, n, B, H, W, C, nH, Ch,
                             use_shift, scale, stream);
  return uf::run<float>(x, buf, out, scratch, ln1_s, ln1_b, wq, bq, wk, bk,
                        wv, bv, wo, bo, bias, mod, ln2_s, ln2_b, w1, b1, wd,
                        bd, w2, b2, n, B, H, W, C, nH, Ch, use_shift, scale,
                        stream);
}

}  // extern "C"
