// Whole-stage LeWin kernel for Hopper (sm_90a): every block of a stage in
// one cooperative persistent launch.
//
// Replaces uformer_tpu/ops/pallas/stage.py:fused_stage. For each block j:
// the attention sub-block over all windows, a grid barrier, the LeFF
// sub-block over all tiles, a grid barrier. Weights come from the
// depth-stacked arrays at index j; the shift is on for odd j when
// use_shift. Head dim 8 (at C = 128 in bf16's tensor-core body: an
// embed-8 model's bottleneck and dec0), 16, 32 or 64 (an --embed_dim 64
// model's stages, C 128-1024). In bf16 at C 128, 256 and 512 both halves
// run on mma.sync with register accumulators and weights streamed through
// cp.async rings: the attention of attention_mma.cuh (1-4 windows per work
// item) and the wide LeFF tile of leff_mma.cuh (8 or 16 x 8 outputs), the
// host picking windows per item and tile rows from the work and the SMs.
// In bf16 at C 1024 (an --embed_dim 64 model's bottleneck and dec0, 16
// heads of 64, hidden 4096: 24 MB of weights a block) the attention half
// is attn_wide_item_l2 (one window an item, O through the block's scratch
// slot in L2) and the LeFF tile 4 x 8; every work item streams the
// block's weights through its cp.async ring, from L2 after the first
// items read them from HBM. fp32 (the exact-check path) and other widths
// run attention_window.cuh and leff_tile.cuh.
//
// What bounds it on the H100: at the 16^2..64^2 stages each sub-block is
// tens of microseconds of work, so per-kernel launches, tails and weight
// ramp-up matter as much as the products. Design: one launch per stage,
// sized by occupancy to the whole card; the stage image (2-17 MB in bf16
// at batch 8 for enc2..dec1, 33.5 MB at dec2) ping-pongs between two
// buffers that largely stay in the 50 MB L2, Hopper's counterpart of the
// TPU kernel's VMEM residency. The grid barrier costs a few microseconds
// per sub-block.
#include <cooperative_groups.h>

#include <algorithm>

#include "attention_mma.cuh"
#include "leff_mma.cuh"

namespace cg = cooperative_groups;

namespace uf {

template <typename T>
struct StageParams {
  const T* x;    // (B, H, W, C) stage input, read only
  T* buf;        // (B, H, W, C) attention output of the current block
  T* out;        // (B, H, W, C) LeFF output = next block's input = result
  T* o_scratch;  // see AttnParams
  // depth-stacked weights, leading axis n
  const float *ln1_s, *ln1_b;
  const T *wq, *wk, *wv, *wo;
  const float *bq, *bk, *bv, *bo;
  const float* bias;  // (n, nH, 64, 64)
  const T* mod;       // (n, 64, C) or null
  const float *ln2_s, *ln2_b;
  const T *w1, *wd, *w2;
  const float *b1, *bd, *b2;
  int n, B, H, W, C, nH, Ch, TH, use_shift;
  float scale;
};

// Every work item of a sub-block, from blockIdx.x in steps of gridDim.x.
// Not inlined: each body then gets the whole register budget, and the
// stage loop's own state stays out of its way. A kernel calls one variant
// of each (two variants of a body in one kernel spilled where either alone
// did not).
template <int C, int D, int WN>
__device__ __noinline__ void attn_wide_all(const AttnParams<bf16>& a,
                                           int n_win, unsigned char* smem) {
  for (int it = blockIdx.x; it < (n_win + WN - 1) / WN; it += gridDim.x)
    if constexpr (attn_wide_l2_fits(C, D))
      attn_wide_item_l2<C, D>(a, it, smem);
    else
      attn_wide_item<C, D, WN>(a, it, smem);
}

// The wide attention half's shared memory at (C, D, WN).
template <int C, int D, int WN>
constexpr size_t attn_wide_smem() {
  if constexpr (attn_wide_l2_fits(C, D))
    return AttnWideL2<C, D>::total;
  else
    return AttnWide<C, D, WN>::total;
}

template <int C, int TH>
__device__ __noinline__ void leff_wide_all(const LeffParams<bf16>& l,
                                           int n_tile, unsigned char* smem) {
  for (int it = blockIdx.x; it < n_tile; it += gridDim.x)
    leff_wide_tile<C, TH>(l, it, smem);
}

// CW: the width of the tensor-core sub-blocks (bf16), with WN windows per
// attention item and TH rows per LeFF tile; or 0 for attention_window and
// leff_tile
template <typename T, int D, int CW, int WN, int TH>
__global__ void __launch_bounds__(kThreads, 1)
    stage_kernel(StageParams<T> p) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int C = p.C, Ch = p.Ch;
  const size_t CC = (size_t)C * C, CH = (size_t)C * Ch;
  const int n_win = p.B * (p.H / 8) * (p.W / 8);
  const int n_tile = p.B * ((p.H + p.TH - 1) / p.TH) * (p.W / 8);
  for (int j = 0; j < p.n; ++j) {
    AttnParams<T> a;
    a.x = j ? p.out : p.x;
    a.y = p.buf;
    a.mod = p.mod ? p.mod + (size_t)j * 64 * C : nullptr;
    a.ln_s = p.ln1_s + j * C;
    a.ln_b = p.ln1_b + j * C;
    a.wq = p.wq + j * CC;
    a.bq = p.bq + j * C;
    a.wk = p.wk + j * CC;
    a.wv = p.wv + j * CC;
    a.bk = p.bk + j * C;
    a.bv = p.bv + j * C;
    a.ldkv = C;
    a.wo = p.wo + j * CC;
    a.bo = p.bo + j * C;
    a.bias = p.bias + (size_t)j * p.nH * 4096;
    a.o_scratch = p.o_scratch;
    a.B = p.B;
    a.H = p.H;
    a.W = p.W;
    a.C = C;
    a.nH = p.nH;
    a.shift = (p.use_shift && (j & 1)) ? 4 : 0;
    a.scale = p.scale;
    a.has_ln = 1;
    a.residual = 1;
    a.windows = 0;
    a.w_off = 0;
    if constexpr (CW > 0) {
      // the callee takes its parameters by reference: from shared memory,
      // not from the stack
      __shared__ AttnParams<bf16> as;
      if (threadIdx.x == 0) as = a;
      __syncthreads();
      attn_wide_all<CW, D, WN>(as, n_win, smem);
    } else {
      for (int it = blockIdx.x; it < n_win; it += gridDim.x)
        attention_window<T, D>(a, it, smem, blockIdx.x);
    }
    grid.sync();

    LeffParams<T> l;
    l.x = p.buf;
    l.y = p.out;
    l.ln_s = p.ln2_s + j * C;
    l.ln_b = p.ln2_b + j * C;
    l.w1 = p.w1 + j * CH;
    l.b1 = p.b1 + (size_t)j * Ch;
    l.wd = p.wd + (size_t)j * 9 * Ch;
    l.bd = p.bd + (size_t)j * Ch;
    l.w2 = p.w2 + j * CH;
    l.b2 = p.b2 + j * C;
    l.B = p.B;
    l.H = p.H;
    l.W = p.W;
    l.C = C;
    l.Ch = Ch;
    l.TH = p.TH;
    l.has_ln = 1;
    l.residual = 1;
    if constexpr (CW > 0) {
      __shared__ LeffParams<bf16> ls;  // as `as` above
      if (threadIdx.x == 0) ls = l;
      __syncthreads();
      leff_wide_all<CW, TH>(ls, n_tile, smem);
    } else {
      for (int it = blockIdx.x; it < n_tile; it += gridDim.x)
        leff_tile<T>(l, it, smem);
    }
    grid.sync();
  }
}

// Windows per work item of the wide attention: the most (up to 512 / C;
// 2 at head dim 64: attn_wide_wn_fits) that do not add a round of items
// over the `slots` resident blocks.
static int wide_windows(int n_win, int slots, int C, int D) {
  int best = 1;
  long best_cost = -1;
  for (int wn = 1; wn * C <= 512 && (D < 64 || wn <= 2); wn *= 2) {
    const int items = (n_win + wn - 1) / wn;
    const long cost = (long)((items + slots - 1) / slots) * wn;
    if (best_cost < 0 || cost <= best_cost) {
      best = wn;
      best_cost = cost;
    }
  }
  return best;
}

template <typename T, int D, int CW, int WN, int TH>
static int launch(StageParams<T> p, cudaStream_t stream) {
  size_t smem;
  if constexpr (CW > 0) {
    p.TH = TH;
    smem = std::max(attn_wide_smem<CW, D, WN>(), LeffWide<CW, TH>::total);
  } else {
    p.TH = leff_tile_rows(sizeof(T), p.C);
    smem = std::max(attn_layout<D>(sizeof(T), p.C).total,
                    leff_layout(sizeof(T), p.C, p.TH).total);
  }
  auto kernel = stage_kernel<T, D, CW, WN, TH>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int n_win = p.B * (p.H / 8) * (p.W / 8);
  const int n_item = (n_win + WN - 1) / WN;
  const int n_tile = p.B * ((p.H + p.TH - 1) / p.TH) * (p.W / 8);
  const int work = n_item > n_tile ? n_item : n_tile;
  int grid = per_sm * sms;
  if (grid > work) grid = work;
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel((void*)kernel, dim3(grid), dim3(kThreads),
                                  args, smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int D, int CW, int WN>
static int launch_rows(const StageParams<bf16>& p, int th,
                       cudaStream_t stream) {
  if constexpr (CW == 1024) {
    return launch<bf16, D, CW, WN, 4>(p, stream);
  } else {
    if constexpr (CW <= 256)
      if (th == 16) return launch<bf16, D, CW, WN, 16>(p, stream);
    return launch<bf16, D, CW, WN, 8>(p, stream);
  }
}

// The tensor-core stage at width CW: windows per attention item and rows
// per LeFF tile from the work and the SMs (one block each: 512 threads at
// up to 128 registers fill an SM's register file).
template <int D, int CW>
static int launch_wide(const StageParams<bf16>& p, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int wn = wide_windows(p.B * (p.H / 8) * (p.W / 8), sms, CW, D);
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
    return launch<T, D, 0, 1, 0>(p, s);
  });
}

}  // namespace uf

extern "C" {

// Returns a cudaError_t (0 on success). is_bf16 selects bf16 (else fp32) for the
// activations and the weight matrices; biases, LayerNorm parameters and
// the relative-position bias are fp32. mod may be null (no modulator).
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
