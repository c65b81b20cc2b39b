// Backward of the LeFF sub-block for Hopper (sm_90a).
//
// Replaces uformer_tpu/ops/pallas/leff.py:fused_leff_bwd (whole-image and
// row-tile variants): the VJP of
//   y = [x +] W2 . GELU(dw3x3(h) + bd) + b2,   h = GELU(W1 . LN2(x) + b1)
// with the hidden recomputed from x, as the TPU kernel does, so the
// forward saves nothing but its inputs.
//
// The depthwise conv couples neighbouring pixels twice on the way back
// (pre2 needs h on a 1-pixel halo, dh needs dpre2 on a 1-pixel halo), so
// the VJP runs as two tile kernels (TH x 8 output tiles, the 4C hidden in
// 64-channel chunks, the hidden zeroed outside the image for SAME
// padding):
//   A: x (+halo) -> LN -> h -> pre2 -> g = GELU(pre2); dg = dy . W2^T;
//      dpre2 = dg * GELU'(pre2). Writes g and dpre2 per pixel, and per
//      tile the partial sums of dwd (dpre2 against the shifted h) and dbd.
//   B: x -> LN -> pre1 = W1 . LN(x) + b1; dh = dw3x3^T(dpre2 (+halo));
//      dpre1 = dh * GELU'(pre1); dLN = dpre1 . W1^T over the chunks; the
//      LayerNorm VJP gives dx [+ dy]. Writes LN(x) and dpre1 per pixel,
//      and per tile the partial sums of dln_s and db1 (db1 from the fp32
//      dpre1 before its bf16 rounding, as the TPU kernel sums it).
// dln_b, the sum of dLN over pixels, is W1 db1 (uf_leff_dln_b): the sum
// of the fp32 dpre1, not of its rounding through dLN (in bf16 the
// dpre1 roundings, summed over every pixel, were dln_b's whole error).
// dW1 = LN(x)^T dpre1, dW2 = g^T dy (with db2, the column sum of dy) are
// then reduced over all pixels in a fixed order (wgrad.cuh), and the tile
// sums by colsum.
//
// What bounds it on the H100: the products are 3 x 2*C*Ch MACs per pixel
// (GEMM1 twice, dy.W2^T, dpre1.W1^T) plus the weight-gradient products;
// the per-pixel g, dpre2 and dpre1 are 3 x Ch values written once and read
// once or twice, which at C = 32 (Ch = 128) is the larger cost. bf16 runs
// the tiles of leff_bwd_mma.cuh: mma.sync products with register
// accumulators, weight tiles through a cp.async ring, partial tiles
// masked, and the hidden chunks of a tile split over blocks where tiles
// are few (host's choice); at C that is no power of two (an --embed_dim
// 24-56 model's 24-896) the WMMA tiles of leff_bwd_heads.cu, one tile a
// block, and at C 1152-2048 (an --embed_dim 72-128 model's widest
// levels) the same tiles, C 2048 too (no leff_bwd_mma.cuh tile is that
// wide). fp32 (the exact-check path) runs the FMA loops below at every C,
// one tile per block, partial tiles masked too. Where a tile's LN(x)
// (the halo's in A, the outputs' in B) would not fit shared memory
// beside the rest (bf16 A from C 1408 and B at C 2048, fp32 A from C
// 1280), it goes to the block's slot of a scratch in device memory
// (uf_leff_bwd_scratch) and the tile takes the most rows that fit
// without it.
#include "leff_bwd_mma.cuh"

namespace uf {

// ---- fp32 (the exact-check path) -------------------------------------

struct LeffBwdLayout {
  static constexpr int ldh = kLeffChunk + 4, ldg = kLeffChunk + 8;
  int TH, Mo, nh, Mh, ldx, ldy, lda;
  size_t xn, dyt, hid, dg, hpix, red;           // kernel A
  size_t acc, dp2, dp1, stats;                  // kernel B (and xn, hid)
  size_t opix, total;
  bool xn_smem;  // the LN(x) tile in shared memory, else in xn_scratch
  __host__ __device__ int xn_rows(int which) const {
    return which == 0 ? Mh : Mo;
  }
};

// which = 0: kernel A, 1: kernel B; fp32 tiles
__host__ __device__ inline LeffBwdLayout leff_bwd_layout(int which, int C,
                                                         int TH) {
  LeffBwdLayout L;
  Carver cv;
  constexpr int ts = sizeof(float);
  L.TH = TH;
  L.Mo = TH * 8;
  L.nh = (TH + 2) * 10;
  L.Mh = (L.nh + 15) / 16 * 16;
  L.ldy = C + 8;
  L.lda = C + 4;
  constexpr int ldh = LeffBwdLayout::ldh, ldg = LeffBwdLayout::ldg;
  L.dyt = L.dg = L.red = L.acc = L.dp2 = L.dp1 = L.stats = 0;
  L.hpix = cv.take((size_t)L.Mh * sizeof(int));
  L.opix = cv.take((size_t)L.Mo * sizeof(int));
  if (which == 0) {
    L.dyt = cv.take((size_t)L.Mo * L.ldy * ts);
    L.hid = cv.take((size_t)L.Mh * ldh * sizeof(float));
    L.dg = cv.take((size_t)L.Mo * ldh * sizeof(float));
    L.red = cv.take((size_t)kRowStep * kLeffChunk * 10 * sizeof(float));
  } else {
    L.acc = cv.take((size_t)L.Mo * L.lda * sizeof(float));
    L.hid = cv.take((size_t)L.Mo * ldh * sizeof(float));
    L.dp2 = cv.take((size_t)L.Mh * ldh * sizeof(float));
    L.dp1 = cv.take((size_t)L.Mo * ldg * ts);
    L.stats = cv.take((size_t)2 * L.Mo * sizeof(float));
  }
  // the tile's LN(x), last: in shared memory where it fits
  const size_t xn = (size_t)L.xn_rows(which) * (C + 8) * ts;
  L.xn_smem = cv.off + xn <= kSmemLimit;
  L.xn = L.xn_smem ? cv.take(xn) : 0;
  L.ldx = L.xn_smem ? C + 8 : C;
  L.total = cv.off;
  return L;
}

// the most rows (8, 4, 2, 1) with LN(x) in shared memory (1 x 8: C 1024's
// and 1152's kernel A), else without it (kernel A from C 1280)
__host__ __device__ inline int leff_bwd_tile_rows_f32(int which, int C) {
  for (int in_smem = 1; in_smem >= 0; --in_smem)
    for (int th = 8; th >= 1; th >>= 1) {
      const LeffBwdLayout L = leff_bwd_layout(which, C, th);
      if (L.total <= kSmemLimit && L.xn_smem >= in_smem) return th;
    }
  return 0;
}

// the LN(x) tile of kernel `which`'s block: in shared memory, or the
// block's slot of p.xn_scratch
__device__ float* xn_tile(const LeffBwdParams<float>& p,
                          const LeffBwdLayout& L, int which,
                          unsigned char* smem) {
  return L.xn_smem ? reinterpret_cast<float*>(smem + L.xn)
                   : p.xn_scratch +
                         (size_t)blockIdx.x * L.xn_rows(which) * p.C;
}

// halo pixel indices of tile `item` (-1 outside the image or padding
// rows) and output pixel indices (-1 past the image)
__device__ void tile_geometry(const LeffBwdParams<float>& p, int item,
                              int Mh, int nh, int Mo, int* hpix, int* opix) {
  const TileGeom geo(item, p.TH, p.H, p.W);
  for (int i = threadIdx.x; i < Mh; i += blockDim.x) hpix[i] = geo.halo(i, nh);
  for (int o = threadIdx.x; o < Mo; o += blockDim.x) opix[o] = geo.out(o);
}

__global__ void __launch_bounds__(kThreads)
    leff_bwd_a_kernel(LeffBwdParams<float> p) {
  using T = float;
  extern __shared__ __align__(128) unsigned char smem[];
  const LeffBwdLayout L = leff_bwd_layout(0, p.C, p.TH);
  const int C = p.C, Ch = p.Ch;
  const int tid = threadIdx.x, warp = tid >> 5;
  T* xn = xn_tile(p, L, 0, smem);
  T* dyt = reinterpret_cast<T*>(smem + L.dyt);
  float* hid = reinterpret_cast<float*>(smem + L.hid);
  float* dg = reinterpret_cast<float*>(smem + L.dg);
  float* red = reinterpret_cast<float*>(smem + L.red);
  int* hpix = reinterpret_cast<int*>(smem + L.hpix);
  int* opix = reinterpret_cast<int*>(smem + L.opix);
  constexpr int ldh = LeffBwdLayout::ldh;
  const int ldx = L.ldx, ldy = L.ldy, Mh = L.Mh, Mo = L.Mo;
  tile_geometry(p, blockIdx.x, Mh, L.nh, Mo, hpix, opix);
  __syncthreads();
  for (int idx = tid; idx < Mh * C; idx += blockDim.x) {
    const int i = idx / C, c = idx % C;
    xn[i * ldx + c] = hpix[i] >= 0 ? p.x[(size_t)hpix[i] * C + c] : 0.f;
  }
  for (int idx = tid; idx < Mo * C; idx += blockDim.x) {
    const int o = idx / C, c = idx % C;
    dyt[o * ldy + c] = opix[o] >= 0 ? p.dy[(size_t)opix[o] * C + c] : 0.f;
  }
  __syncthreads();
  if (p.has_ln) {
    for (int i = warp; i < Mh; i += kWarps)
      if (hpix[i] >= 0)
        ln_row<T>(xn + i * ldx, C, p.ln_s, p.ln_b, true, nullptr);
    __syncthreads();
  }

  const int j = tid % kLeffChunk, grp = tid / kLeffChunk;
  for (int k0 = 0; k0 < Ch; k0 += kLeffChunk) {
    block_gemm<T, false, false>(xn, ldx, p.w1 + k0, Ch, hid, ldh, Mh,
                                kLeffChunk, C);
    __syncthreads();
    const float b1j = p.b1[k0 + j], bdj = p.bd[k0 + j];
    float wdj[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) wdj[t] = p.wd[t * Ch + k0 + j];
    for (int i = grp; i < Mh; i += kRowStep)
      hid[i * ldh + j] = hpix[i] >= 0 ? gelu(hid[i * ldh + j] + b1j) : 0.f;
    __syncthreads();
    // dg = dy . W2[k0:k0+64, :]^T
    block_gemm<T, true, false>(dyt, ldy, p.w2 + (size_t)k0 * C, C, dg, ldh,
                               Mo, kLeffChunk, C);
    __syncthreads();
    float dwd[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float dbd = 0.f;
    for (int o = grp; o < Mo; o += kRowStep) {
      if (opix[o] < 0) continue;
      const float* h0 = hid + ((o / 8) * 10 + o % 8) * ldh + j;
      float pre = 0.f;
#pragma unroll
      for (int t = 0; t < 9; ++t)
        pre = fmaf(h0[((t / 3) * 10 + t % 3) * ldh], wdj[t], pre);
      pre += bdj;
      const size_t at = (size_t)opix[o] * Ch + k0 + j;
      p.g[at] = gelu(pre);
      const float dp = dg[o * ldh + j] * gelu_grad(pre);
      p.dpre2[at] = dp;
      dbd += dp;
#pragma unroll
      for (int t = 0; t < 9; ++t)
        dwd[t] = fmaf(dp, h0[((t / 3) * 10 + t % 3) * ldh], dwd[t]);
    }
    float* mine = red + (grp * kLeffChunk + j) * 10;
#pragma unroll
    for (int t = 0; t < 9; ++t) mine[t] = dwd[t];
    mine[9] = dbd;
    __syncthreads();
    for (int q = tid; q < kLeffChunk * 10; q += blockDim.x) {
      const int jj = q / 10, t = q % 10;
      float s = 0.f;
      for (int gi = 0; gi < kRowStep; ++gi)
        s += red[(gi * kLeffChunk + jj) * 10 + t];
      p.part_a[(size_t)blockIdx.x * 10 * Ch + t * Ch + k0 + jj] = s;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
    leff_bwd_b_kernel(LeffBwdParams<float> p) {
  using T = float;
  extern __shared__ __align__(128) unsigned char smem[];
  const LeffBwdLayout L = leff_bwd_layout(1, p.C, p.TH);
  const int C = p.C, Ch = p.Ch;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  T* xn = xn_tile(p, L, 1, smem);
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  float* hid = reinterpret_cast<float*>(smem + L.hid);
  float* dp2 = reinterpret_cast<float*>(smem + L.dp2);
  T* dp1 = reinterpret_cast<T*>(smem + L.dp1);
  float* stats = reinterpret_cast<float*>(smem + L.stats);
  int* hpix = reinterpret_cast<int*>(smem + L.hpix);
  int* opix = reinterpret_cast<int*>(smem + L.opix);
  constexpr int ldh = LeffBwdLayout::ldh, ldg = LeffBwdLayout::ldg;
  const int ldx = L.ldx, lda = L.lda, Mh = L.Mh, Mo = L.Mo;
  tile_geometry(p, blockIdx.x, Mh, L.nh, Mo, hpix, opix);
  __syncthreads();
  for (int idx = tid; idx < Mo * C; idx += blockDim.x) {
    const int o = idx / C, c = idx % C;
    xn[o * ldx + c] = opix[o] >= 0 ? p.x[(size_t)opix[o] * C + c] : 0.f;
    acc[o * lda + c] = 0.f;
  }
  __syncthreads();
  for (int o = warp; o < Mo; o += kWarps) {
    if (opix[o] < 0) continue;
    if (p.has_ln)
      ln_row<T>(xn + o * ldx, C, p.ln_s, p.ln_b, true, nullptr,
                stats + 2 * o);
    for (int c = lane; c < C; c += 32)
      p.ln[(size_t)opix[o] * C + c] = xn[o * ldx + c];
  }
  __syncthreads();

  const int j = tid % kLeffChunk, grp = tid / kLeffChunk;
  for (int k0 = 0; k0 < Ch; k0 += kLeffChunk) {
    block_gemm<T, false, false>(xn, ldx, p.w1 + k0, Ch, hid, ldh, Mo,
                                kLeffChunk, C);
    for (int i = grp; i < Mh; i += kRowStep)
      dp2[i * ldh + j] =
          hpix[i] >= 0 ? p.dpre2[(size_t)hpix[i] * Ch + k0 + j] : 0.f;
    __syncthreads();
    const float b1j = p.b1[k0 + j];
    float wdj[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) wdj[t] = p.wd[t * Ch + k0 + j];
    float db1 = 0.f;  // this thread's rows of db1[k0 + j]
    for (int o = grp; o < Mo; o += kRowStep) {
      float dp = 0.f;
      if (opix[o] >= 0) {
        // dh[q] = sum over taps (dy, dx) of dpre2[q - (dy - 1, dx - 1)] wd
        const float* d0 = dp2 + ((o / 8 + 2) * 10 + o % 8 + 2) * ldh + j;
        float dh = 0.f;
#pragma unroll
        for (int t = 0; t < 9; ++t)
          dh = fmaf(d0[-((t / 3) * 10 + t % 3) * ldh], wdj[t], dh);
        dp = dh * gelu_grad(hid[o * ldh + j] + b1j);
        db1 += dp;
        p.dpre1[(size_t)opix[o] * Ch + k0 + j] = dp;
      }
      dp1[o * ldg + j] = dp;
    }
    // row grp of hid is read by this thread's group only, and only for
    // column j by this thread: it takes the partial until the next chunk
    hid[grp * ldh + j] = db1;
    __syncthreads();
    if (tid < kLeffChunk) {
      float s = 0.f;
      for (int gi = 0; gi < kRowStep; ++gi) s += hid[gi * ldh + tid];
      p.part_b[(size_t)blockIdx.x * (C + Ch) + C + k0 + tid] = s;
    }
    // dLN += dpre1 . W1[:, k0:k0+64]^T
    block_gemm<T, true, true>(dp1, ldg, p.w1 + k0, Ch, acc, lda, Mo, C,
                              kLeffChunk);
    __syncthreads();
  }

  // LayerNorm VJP, one warp per pixel; dln_s sums the fp32 dLN
  // (leff.py:683-688)
  for (int o = warp; o < Mo; o += kWarps) {
    if (opix[o] < 0) continue;
    const size_t at = (size_t)opix[o] * C;
    const float* row = acc + o * lda;
    float mean = 0.f, rstd = 1.f, s1 = 0.f, s2 = 0.f;
    if (p.has_ln) {
      mean = stats[2 * o];
      rstd = stats[2 * o + 1];
      for (int c = lane; c < C; c += 32) {
        const float xh = (p.x[at + c] - mean) * rstd;
        const float dxh = row[c] * p.ln_s[c];
        s1 += dxh;
        s2 += dxh * xh;
      }
      s1 = warp_sum(s1) / C;
      s2 = warp_sum(s2) / C;
    }
    for (int c = lane; c < C; c += 32) {
      float d = row[c];
      if (p.has_ln) {
        const float xh = (p.x[at + c] - mean) * rstd;
        d = rstd * (row[c] * p.ln_s[c] - s1 - xh * s2);
      }
      if (p.residual) d += p.dy[at + c];
      p.dx[at + c] = d;
    }
  }
  if (!p.has_ln) return;
  __syncthreads();
  for (int c = tid; c < C; c += blockDim.x) {
    float ss = 0.f;
    for (int o = 0; o < Mo; ++o) {
      if (opix[o] < 0) continue;
      const float xh =
          (p.x[(size_t)opix[o] * C + c] - stats[2 * o]) * stats[2 * o + 1];
      ss = fmaf(acc[o * lda + c], xh, ss);
    }
    p.part_b[(size_t)blockIdx.x * (C + Ch) + c] = ss;
  }
}

// ---- bf16 ------------------------------------------------------------

// (two blocks per SM at C <= 32, where both fit shared memory)
template <int C>
__global__ void __launch_bounds__(kThreads, C <= 32 ? 2 : 1)
    leff_bwd_a_mma_kernel(LeffBwdParams<bf16> p) {
  extern __shared__ __align__(128) unsigned char smem[];
  leff_bwd_a_tile<C>(p, smem);
}

template <int C>
__global__ void __launch_bounds__(kThreads, 1)
    leff_bwd_b_mma_kernel(LeffBwdParams<bf16> p) {
  extern __shared__ __align__(128) unsigned char smem[];
  leff_bwd_b_tile<C>(p, smem);
}

template <int C>
__global__ void __launch_bounds__(kThreads, 1)
    leff_bwd_finish_kernel(LeffBwdParams<bf16> p, int groups) {
  extern __shared__ __align__(128) unsigned char smem[];
  leff_bwd_finish_tile<C>(p, groups, smem);
}

template <int C>
__host__ inline int mma_rows(int which) {
  return which == 0 ? LeffBwdA<C>::TH : LeffBwdB<C>::TH;
}

// Output rows of a tile of kernel `which` (0: A, 1: B and its finish); 0
// where bf16 has no tile for C
__host__ inline int leff_bwd_tile_rows(int which, int ts, int C) {
  if (ts == 4) return leff_bwd_tile_rows_f32(which, C);
  switch (C) {
    case 8: return mma_rows<8>(which);
    case 16: return mma_rows<16>(which);
    case 32: return mma_rows<32>(which);
    case 64: return mma_rows<64>(which);
    case 128: return mma_rows<128>(which);
    case 256: return mma_rows<256>(which);
    case 512: return mma_rows<512>(which);
    case 1024: return mma_rows<1024>(which);
  }
  return leff_bwd_heads_rows(which, C);
}

template <typename K>
static int launch(K kernel, dim3 grid, size_t smem, cudaStream_t stream,
                  const LeffBwdParams<bf16>& p) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// which: 0 A, 1 B, 2 the finish of a split B over `groups` groups
template <int C>
static int run_mma(int which, LeffBwdParams<bf16>& p, int groups,
                   cudaStream_t stream) {
  p.TH = leff_bwd_tile_rows(which == 0 ? 0 : 1, 2, C);
  const int tiles = p.B * ((p.H + p.TH - 1) / p.TH) * ((p.W + 7) / 8);
  const int chunks = p.Ch / kLeffChunk;
  const dim3 grid(tiles, (chunks + p.cpg - 1) / p.cpg);
  if (which == 0)
    return launch(leff_bwd_a_mma_kernel<C>, grid, LeffBwdA<C>::total, stream,
                  p);
  if (which == 1)
    return launch(leff_bwd_b_mma_kernel<C>, grid, LeffBwdB<C>::total, stream,
                  p);
  constexpr size_t smem = LeffBwdB<C>::total;
  cudaError_t e = cudaFuncSetAttribute(
      leff_bwd_finish_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  leff_bwd_finish_kernel<C><<<tiles, kThreads, smem, stream>>>(p, groups);
  return (int)cudaGetLastError();
}

static int run_f32(int which, LeffBwdParams<float>& p, cudaStream_t stream) {
  p.TH = leff_bwd_tile_rows_f32(which, p.C);
  if (!p.TH) return (int)cudaErrorInvalidValue;
  const LeffBwdLayout L = leff_bwd_layout(which, p.C, p.TH);
  if (!L.xn_smem && p.xn_scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  auto kernel = which == 0 ? leff_bwd_a_kernel : leff_bwd_b_kernel;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (e != cudaSuccess) return (int)e;
  const int blocks = p.B * ((p.H + p.TH - 1) / p.TH) * ((p.W + 7) / 8);
  kernel<<<blocks, kThreads, L.total, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
static int run_bwd(int which, const void* x, const void* dy,
                   const float* ln_s, const float* ln_b, const void* w1,
                   const float* b1, const void* wd, const float* bd,
                   const void* w2, void* g, void* dpre2, float* part_a,
                   void* dx, void* ln, void* dpre1, float* part_b,
                   float* part_dln, void* xn_scratch, int cpg, int B, int H,
                   int W, int C, int Ch, int has_ln, int residual,
                   void* stream) {
  LeffBwdParams<T> p;
  p.x = static_cast<const T*>(x);
  p.dy = static_cast<const T*>(dy);
  p.ln_s = ln_s;
  p.ln_b = ln_b;
  p.w1 = static_cast<const T*>(w1);
  p.b1 = b1;
  p.wd = static_cast<const T*>(wd);
  p.bd = bd;
  p.w2 = static_cast<const T*>(w2);
  p.g = static_cast<T*>(g);
  p.dpre2 = static_cast<T*>(dpre2);
  p.part_a = part_a;
  p.dx = static_cast<T*>(dx);
  p.ln = static_cast<T*>(ln);
  p.dpre1 = static_cast<T*>(dpre1);
  p.part_b = part_b;
  p.part_dln = part_dln;
  p.xn_scratch = static_cast<T*>(xn_scratch);
  p.B = B;
  p.H = H;
  p.W = W;
  p.C = C;
  p.Ch = Ch;
  p.has_ln = has_ln;
  p.residual = residual;
  const int chunks = Ch / kLeffChunk;
  p.cpg = cpg > 0 && cpg < chunks ? cpg : chunks;
  auto s = static_cast<cudaStream_t>(stream);
  if constexpr (std::is_same<T, float>::value) {
    return which == 2 ? (int)cudaErrorInvalidValue : run_f32(which, p, s);
  } else {
    // the finish pass's groups: those of the split B launch
    const int groups = (chunks + p.cpg - 1) / p.cpg;
    switch (C) {
      case 8: return run_mma<8>(which, p, groups, s);
      case 16: return run_mma<16>(which, p, groups, s);
      case 32: return run_mma<32>(which, p, groups, s);
      case 64: return run_mma<64>(which, p, groups, s);
      case 128: return run_mma<128>(which, p, groups, s);
      case 256: return run_mma<256>(which, p, groups, s);
      case 512: return run_mma<512>(which, p, groups, s);
      case 1024: return run_mma<1024>(which, p, groups, s);
    }
    return leff_bwd_heads(which, p, s);  // leff_bwd_heads.cu
  }
}

// dln_b (C,) = w1 (C x Ch) db1 (Ch,): a warp a channel, lanes over the
// hidden in a fixed order, then warp_sum.
template <typename T>
__global__ void __launch_bounds__(256)
    leff_dln_b_kernel(const T* w1, const float* db1, float* out, int C,
                      int Ch) {
  const int c = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x & 31;
  if (c >= C) return;
  float s = 0.f;
  for (int j = lane; j < Ch; j += 32)
    s = fmaf(to_f<T>(w1[(size_t)c * Ch + j]), db1[j], s);
  s = warp_sum(s);
  if (lane == 0) out[c] = s;
}

}  // namespace uf

extern "C" {

// dln_b (C, fp32) = w1 (C x Ch, bf16 or fp32) db1 (Ch, fp32), after the
// colsum of part_b. Returns a cudaError_t.
int uf_leff_dln_b(int is_bf16, const void* w1, const float* db1,
                  float* dln_b, int C, int Ch, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int blocks = (C + 7) / 8;
  if (is_bf16)
    uf::leff_dln_b_kernel<uf::bf16><<<blocks, 256, 0, s>>>(
        static_cast<const uf::bf16*>(w1), db1, dln_b, C, Ch);
  else
    uf::leff_dln_b_kernel<float><<<blocks, 256, 0, s>>>(
        static_cast<const float*>(w1), db1, dln_b, C, Ch);
  return (int)cudaGetLastError();
}

// Output rows of a tile of backward kernel `which` (0: A, 1: B) for this
// dtype and width: the tiles are TH x 8 outputs over a (B, ceil(H / TH),
// ceil(W / 8)) grid, partial tiles masked. bf16 at C other than 8-1024
// in powers of 2: leff_bwd_heads.cu's tile (0 where none fits).
int uf_leff_bwd_tile_rows(int which, int is_bf16, int C) {
  return uf::leff_bwd_tile_rows(which, is_bf16 ? 2 : 4, C);
}

// Rows of kernel `which`'s LN(x) tile (the halo's in A, the outputs' in
// B) that go to device memory because they miss shared memory, 0 where
// they fit: the caller then passes xn_scratch of tiles x rows x C values
// of the input's dtype (A and B may share one, each taking its own
// tiles' slots).
int uf_leff_bwd_scratch(int which, int is_bf16, int C) {
  if (!is_bf16) {
    const int th = uf::leff_bwd_tile_rows_f32(which, C);
    if (!th) return 0;
    const auto L = uf::leff_bwd_layout(which, C, th);
    return L.xn_smem ? 0 : L.xn_rows(which);
  }
  switch (C) {
    case 8: case 16: case 32: case 64: case 128: case 256: case 512:
    case 1024:
      return 0;  // leff_bwd_mma.cuh's tiles
  }
  return uf::leff_bwd_heads_scratch(which, C);
}

// One of the backward kernels: which = 0: A, 1: B, 2: (bf16) the finish
// of a B split into groups of cpg hidden chunks (cpg >= Ch / 64: no
// split; fp32 never splits). A reads x, dy, LN, w1, b1, wd, bd, w2 and
// writes g, dpre2, part_a; B reads x, dy, LN, w1, b1, wd, dpre2 and writes
// dx, ln, dpre1, part_b, or, split, ln, dpre1, db1's part of part_b and
// part_dln (groups x tiles x TH 8 x C fp32); the finish reads part_dln, x,
// dy, LN and writes dx and the rest of part_b. xn_scratch: where
// uf_leff_bwd_scratch gives rows for A or B. Pointers a kernel does not
// use may be null. Returns a cudaError_t.
int uf_leff_bwd(int which, int is_bf16, const void* x, const void* dy,
                const float* ln_s, const float* ln_b, const void* w1,
                const float* b1, const void* wd, const float* bd,
                const void* w2, void* g, void* dpre2, float* part_a, void* dx,
                void* ln, void* dpre1, float* part_b, float* part_dln,
                void* xn_scratch, int cpg, int B, int H, int W, int C,
                int Ch, int has_ln, int residual, void* stream) {
  if (is_bf16)
    return uf::run_bwd<uf::bf16>(which, x, dy, ln_s, ln_b, w1, b1, wd, bd, w2,
                                 g, dpre2, part_a, dx, ln, dpre1, part_b,
                                 part_dln, xn_scratch, cpg, B, H, W, C, Ch,
                                 has_ln, residual, stream);
  return uf::run_bwd<float>(which, x, dy, ln_s, ln_b, w1, b1, wd, bd, w2, g,
                            dpre2, part_a, dx, ln, dpre1, part_b, part_dln,
                            xn_scratch, cpg, B, H, W, C, Ch, has_ln,
                            residual, stream);
}

}  // extern "C"
