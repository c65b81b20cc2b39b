// The whole-stage kernel's body (stage.cu) and its launch, shared by
// stage.cu (head dims 8, 16, 32, 64), stage_heads.cu (24, 40, 48, 56),
// stage_big_heads.cu (72-128) and stage_f32.cu / stage_f32_d16.cu (fp32
// at head dims 32 / 16, C 64-512), which nvcc compiles in parallel.
#pragma once

#include <cooperative_groups.h>

#include <algorithm>

#include "attention_f32.cuh"
#include "attention_mma.cuh"
#include "leff_f32.cuh"
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
  // leff_tile's halo slots in o_scratch where it misses shared memory (C
  // 1408-2048): the LeFF half runs on that many blocks; 0: every block
  int leff_slots;
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

// The fp32 halves on the three-pass TF32 tiles, as the two above.
template <int C, int D, int WN>
__device__ __noinline__ void attn_f32_all(const AttnParams<float>& a,
                                          int n_win, unsigned char* smem) {
  for (int it = blockIdx.x; it < (n_win + WN - 1) / WN; it += gridDim.x)
    attn_f32_item<C, D, WN>(a, it, smem);
}

template <int C, int TH>
__device__ __noinline__ void leff_f32_all(const LeffParams<float>& l,
                                          int n_tile, unsigned char* smem) {
  for (int it = blockIdx.x; it < n_tile; it += gridDim.x)
    leff_f32_tile<C, TH>(l, it, smem);
}

// CW: the width of the tensor-core sub-blocks (bf16 on mma.sync m16n8k16,
// fp32 on the three-pass TF32 tiles), with WN windows per attention item
// and TH rows per LeFF tile; or 0 for attention_window and leff_tile
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
      __shared__ AttnParams<T> as;
      if (threadIdx.x == 0) as = a;
      __syncthreads();
      if constexpr (std::is_same<T, bf16>::value)
        attn_wide_all<CW, D, WN>(as, n_win, smem);
      else
        attn_f32_all<CW, D, WN>(as, n_win, smem);
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
    l.scratch = p.o_scratch;
    l.has_ln = 1;
    l.residual = 1;
    if constexpr (CW > 0) {
      __shared__ LeffParams<T> ls;  // as `as` above
      if (threadIdx.x == 0) ls = l;
      __syncthreads();
      if constexpr (std::is_same<T, bf16>::value)
        leff_wide_all<CW, TH>(ls, n_tile, smem);
      else
        leff_f32_all<CW, TH>(ls, n_tile, smem);
    } else {
      // the attention half is done with the scratch (grid.sync above): its
      // slots now hold the LeFF halos, where they miss shared memory
      const int ls = p.leff_slots > 0 && p.leff_slots < (int)gridDim.x
                         ? p.leff_slots
                         : (int)gridDim.x;
      if ((int)blockIdx.x < ls)
        for (int it = blockIdx.x; it < n_tile; it += ls)
          leff_tile<T>(l, it, smem, blockIdx.x);
    }
    grid.sync();
  }
}

template <typename T, int D, int CW, int WN, int TH>
int launch_stage(StageParams<T> p, cudaStream_t stream) {
  size_t smem;
  if constexpr (CW > 0 && std::is_same<T, bf16>::value) {
    p.TH = TH;
    smem = std::max(attn_wide_smem<CW, D, WN>(), LeffWide<CW, TH>::total);
  } else if constexpr (CW > 0) {
    p.TH = TH;
    smem = std::max(AttnF32<CW, D, WN>::total, LeffF32<CW, TH>::total);
  } else {
    p.TH = leff_tile_rows(sizeof(T), p.C);
    const AttnLayout<D> La = attn_layout<D>(sizeof(T), p.C);
    const LeffLayout Lf = leff_layout(sizeof(T), p.C, p.TH);
    smem = std::max(La.total, Lf.total);
    p.leff_slots = 0;
    if (!Lf.x_smem) {
      // the LeFF halos in the attention's scratch (La.regions() tiles of
      // 64 x C a window), as many as it holds
      const size_t held = (size_t)La.regions() * p.B * p.H * p.W * p.C;
      if (p.o_scratch == nullptr || held < Lf.slot)
        return (int)cudaErrorInvalidValue;
      p.leff_slots = (int)std::min<size_t>(held / Lf.slot, 1 << 30);
    }
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

// The stage at head dim C / nH in 24, 40, 48, 56 (is_new_head_dim): the
// one-window attention body and leff_tile, in fp32 and bf16.
template <typename T>
int stage_heads(const StageParams<T>& p, cudaStream_t stream);

// The same at head dims 72-128, a multiple of 8 (is_big_head_dim), on
// the attention body of the next multiple of 16.
template <typename T>
int stage_big_heads(const StageParams<T>& p, cudaStream_t stream);

// Whether the fp32 stage has its three-pass TF32 bodies at (C, D).
__host__ __device__ constexpr bool stage_f32_fits(int C, int D) {
  return attn_f32_fits(C, D) && leff_f32_fits(C);
}

// The fp32 stage on the three-pass TF32 bodies at head dim D (16 or 32)
// and C 64-512: wn windows per attention item (1, or 2 at C <= 128) and
// leff_f32_rows(C) rows per LeFF tile; cudaErrorInvalidValue for a (C,
// wn) without an instantiation.
template <int D>
int stage_f32(const StageParams<float>& p, int wn, cudaStream_t stream) {
  if (wn == 2) {
    if (p.C == 64) return launch_stage<float, D, 64, 2, 8>(p, stream);
    if (p.C == 128) return launch_stage<float, D, 128, 2, 8>(p, stream);
  }
  if (wn == 1) {
    if (p.C == 64) return launch_stage<float, D, 64, 1, 8>(p, stream);
    if (p.C == 128) return launch_stage<float, D, 128, 1, 8>(p, stream);
    if (p.C == 256) return launch_stage<float, D, 256, 1, 8>(p, stream);
    if (p.C == 512) return launch_stage<float, D, 512, 1, 4>(p, stream);
  }
  return (int)cudaErrorInvalidValue;
}
extern template int stage_f32<16>(const StageParams<float>&, int,
                                  cudaStream_t);
extern template int stage_f32<32>(const StageParams<float>&, int,
                                  cudaStream_t);

}  // namespace uf
