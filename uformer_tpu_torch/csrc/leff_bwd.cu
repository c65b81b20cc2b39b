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
// the VJP runs as two tile kernels with the forward's tiling (TH x 8
// output tiles, the 4C hidden in 64-channel chunks in shared memory, the
// hidden zeroed outside the image for SAME padding):
//   A: x (+halo) -> LN -> h -> pre2 -> g = GELU(pre2); dg = dy . W2^T;
//      dpre2 = dg * GELU'(pre2). Writes g and dpre2 per pixel, and per
//      tile the partial sums of dwd (dpre2 against the shifted h) and dbd.
//   B: x -> LN -> pre1 = W1 . LN(x) + b1; dh = dw3x3^T(dpre2 (+halo));
//      dpre1 = dh * GELU'(pre1); dLN = dpre1 . W1^T over the chunks; the
//      LayerNorm VJP gives dx [+ dy]. Writes LN(x) and dpre1 per pixel,
//      and per tile the partial sums of dln_s, dln_b and db1 (db1 from the
//      fp32 dpre1 before its bf16 rounding, as the TPU kernel sums it).
// dW1 = LN(x)^T dpre1, dW2 = g^T dy and the bias and tile sums are then
// reduced over all pixels in a fixed order (wgrad.cuh).
//
// What bounds it on the H100: the products are 3 x 2*C*Ch MACs per pixel
// (GEMM1 twice, dy.W2^T, dpre1.W1^T) plus the weight-gradient products;
// the per-pixel g, dpre2 and dpre1 are 3 x Ch values written once and read
// once or twice, which at C = 32 (Ch = 128) is the larger cost. Products
// on the tensor cores (WMMA, fp32 accumulation) in bf16; fp32 FMA loops in
// fp32 (the exact-check path).
#include "leff_tile.cuh"

namespace uf {

template <typename T>
struct LeffBwdParams {
  const T* x;         // (B, H, W, C)
  const T* dy;        // (B, H, W, C)
  const float* ln_s;  // (C,)
  const float* ln_b;  // (C,)
  const T* w1;        // (C, Ch)
  const float* b1;    // (Ch,)
  const T* wd;        // (3, 3, Ch)
  const float* bd;    // (Ch,)
  const T* w2;        // (Ch, C)
  T* g;               // (B, H, W, Ch) GELU(dw3x3(h) + bd)         [A]
  T* dpre2;           // (B, H, W, Ch)                             [A -> B]
  float* part_a;      // (tiles, 10 * Ch): dwd (3, 3, Ch), then dbd [A]
  T* dx;              // (B, H, W, C)                              [B]
  T* ln;              // (B, H, W, C) LN(x)                        [B]
  T* dpre1;           // (B, H, W, Ch)                             [B]
  float* part_b;      // (tiles, 2 * C + Ch): dln_s, dln_b, then db1 [B]
  int B, H, W, C, Ch, TH;
  int has_ln, residual;
};

constexpr int kRowStep = kThreads / kLeffChunk;  // 8 row groups

struct LeffBwdLayout {
  static constexpr int ldh = kLeffChunk + 4, ldg = kLeffChunk + 8;
  int TH, Mo, nh, Mh, ldx, lda, ldw1, ldw2;
  size_t xn, dyt, hid, dg, hpix, red, w;        // kernel A
  size_t acc, dp2, dp1, stats;                  // kernel B (and xn, hid)
  size_t total;
};

// which = 0: kernel A, 1: kernel B
__host__ __device__ inline LeffBwdLayout leff_bwd_layout(int which, int ts,
                                                         int C, int TH) {
  LeffBwdLayout L;
  Carver cv;
  L.TH = TH;
  L.Mo = TH * 8;
  L.nh = (TH + 2) * 10;
  L.Mh = (L.nh + 15) / 16 * 16;
  L.ldx = C + 8;
  L.lda = C + 4;
  L.ldw1 = kLeffChunk + 8;
  L.ldw2 = C + 8;
  constexpr int ldh = LeffBwdLayout::ldh, ldg = LeffBwdLayout::ldg;
  L.dyt = L.dg = L.red = L.acc = L.dp2 = L.dp1 = L.stats = 0;
  L.hpix = cv.take((size_t)L.Mh * sizeof(int));
  if (which == 0) {
    L.xn = cv.take((size_t)L.Mh * L.ldx * ts);
    L.dyt = cv.take((size_t)L.Mo * L.ldx * ts);
    L.hid = cv.take((size_t)L.Mh * ldh * sizeof(float));
    L.dg = cv.take((size_t)L.Mo * ldh * sizeof(float));
    L.red = cv.take((size_t)kRowStep * kLeffChunk * 10 * sizeof(float));
  } else {
    L.xn = cv.take((size_t)L.Mo * L.ldx * ts);
    L.acc = cv.take((size_t)L.Mo * L.lda * sizeof(float));
    L.hid = cv.take((size_t)L.Mo * ldh * sizeof(float));
    L.dp2 = cv.take((size_t)L.Mh * ldh * sizeof(float));
    L.dp1 = cv.take((size_t)L.Mo * ldg * ts);
    L.stats = cv.take((size_t)2 * L.Mo * sizeof(float));
  }
  L.w = 0;
  if (ts == 2) {  // staged weight chunks, bf16 only
    const size_t w1 = (size_t)C * L.ldw1, w2 = (size_t)kLeffChunk * L.ldw2;
    L.w = cv.take(((which == 0 && w2 > w1) ? w2 : w1) * ts);
  }
  L.total = cv.off;
  return L;
}

__host__ __device__ inline int leff_bwd_tile_rows(int which, int ts, int C) {
  for (int th = 8; th > 2; th >>= 1)
    if (leff_bwd_layout(which, ts, C, th).total <= kSmemLimit) return th;
  return 2;
}

// halo pixel indices of tile `item` (-1 outside the image or padding rows)
template <typename T>
__device__ void tile_geometry(const LeffBwdParams<T>& p, int item, int Mh,
                              int nh, int* hpix, int& b, int& r0, int& c0) {
  const int nTw = p.W / 8, nT = (p.H / p.TH) * nTw;
  b = item / nT;
  r0 = ((item % nT) / nTw) * p.TH;
  c0 = (item % nTw) * 8;
  for (int i = threadIdx.x; i < Mh; i += blockDim.x) {
    int at = -1;
    if (i < nh) {
      const int r = r0 - 1 + i / 10, c = c0 - 1 + i % 10;
      if (r >= 0 && r < p.H && c >= 0 && c < p.W) at = (b * p.H + r) * p.W + c;
    }
    hpix[i] = at;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    leff_bwd_a_kernel(LeffBwdParams<T> p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const LeffBwdLayout L = leff_bwd_layout(0, sizeof(T), p.C, p.TH);
  const int C = p.C, Ch = p.Ch, W = p.W, H = p.H;
  const int tid = threadIdx.x, warp = tid >> 5;
  T* xn = reinterpret_cast<T*>(smem + L.xn);
  T* dyt = reinterpret_cast<T*>(smem + L.dyt);
  float* hid = reinterpret_cast<float*>(smem + L.hid);
  float* dg = reinterpret_cast<float*>(smem + L.dg);
  float* red = reinterpret_cast<float*>(smem + L.red);
  int* hpix = reinterpret_cast<int*>(smem + L.hpix);
  T* wbuf = reinterpret_cast<T*>(smem + L.w);
  constexpr bool kStage = sizeof(T) == 2;
  constexpr int ldh = LeffBwdLayout::ldh;
  const int ldx = L.ldx, Mh = L.Mh, Mo = L.Mo;
  int b, r0, c0;
  tile_geometry<T>(p, blockIdx.x, Mh, L.nh, hpix, b, r0, c0);
  __syncthreads();
  for (int idx = tid; idx < Mh * C; idx += blockDim.x) {
    const int i = idx / C, c = idx % C;
    xn[i * ldx + c] = hpix[i] >= 0 ? p.x[(size_t)hpix[i] * C + c]
                                   : from_f<T>(0.f);
  }
  for (int idx = tid; idx < Mo * C; idx += blockDim.x) {
    const int o = idx / C, c = idx % C;
    const size_t at = (size_t)(b * H + r0 + o / 8) * W + c0 + o % 8;
    dyt[o * ldx + c] = p.dy[at * C + c];
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
    if constexpr (kStage) {
      stage_tile<T>(wbuf, L.ldw1, p.w1 + k0, Ch, C, kLeffChunk);
      __syncthreads();
      block_gemm<T, false, false>(xn, ldx, wbuf, L.ldw1, hid, ldh, Mh,
                                  kLeffChunk, C);
    } else {
      block_gemm<T, false, false>(xn, ldx, p.w1 + k0, Ch, hid, ldh, Mh,
                                  kLeffChunk, C);
    }
    __syncthreads();
    if constexpr (kStage)
      stage_tile<T>(wbuf, L.ldw2, p.w2 + (size_t)k0 * C, C, kLeffChunk, C);
    const float b1j = p.b1[k0 + j], bdj = p.bd[k0 + j];
    float wdj[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) wdj[t] = to_f<T>(p.wd[t * Ch + k0 + j]);
    for (int i = grp; i < Mh; i += kRowStep)
      hid[i * ldh + j] =
          hpix[i] >= 0 ? rnd<T>(gelu(hid[i * ldh + j] + b1j)) : 0.f;
    __syncthreads();
    // dg = dy . W2[k0:k0+64, :]^T
    if constexpr (kStage)
      block_gemm<T, true, false>(dyt, ldx, wbuf, L.ldw2, dg, ldh, Mo,
                                 kLeffChunk, C);
    else
      block_gemm<T, true, false>(dyt, ldx, p.w2 + (size_t)k0 * C, C, dg, ldh,
                                 Mo, kLeffChunk, C);
    __syncthreads();
    float dwd[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float dbd = 0.f;
    for (int o = grp; o < Mo; o += kRowStep) {
      const float* h0 = hid + ((o / 8) * 10 + o % 8) * ldh + j;
      float pre = 0.f;
#pragma unroll
      for (int t = 0; t < 9; ++t)
        pre = fmaf(h0[((t / 3) * 10 + t % 3) * ldh], wdj[t], pre);
      pre += bdj;
      const size_t at =
          ((size_t)(b * H + r0 + o / 8) * W + c0 + o % 8) * Ch + k0 + j;
      p.g[at] = from_f<T>(gelu(pre));
      const float dp = rnd<T>(rnd<T>(dg[o * ldh + j]) * gelu_grad(pre));
      p.dpre2[at] = from_f<T>(dp);
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    leff_bwd_b_kernel(LeffBwdParams<T> p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const LeffBwdLayout L = leff_bwd_layout(1, sizeof(T), p.C, p.TH);
  const int C = p.C, Ch = p.Ch, W = p.W, H = p.H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  T* xn = reinterpret_cast<T*>(smem + L.xn);
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  float* hid = reinterpret_cast<float*>(smem + L.hid);
  float* dp2 = reinterpret_cast<float*>(smem + L.dp2);
  T* dp1 = reinterpret_cast<T*>(smem + L.dp1);
  float* stats = reinterpret_cast<float*>(smem + L.stats);
  int* hpix = reinterpret_cast<int*>(smem + L.hpix);
  T* wbuf = reinterpret_cast<T*>(smem + L.w);
  constexpr bool kStage = sizeof(T) == 2;
  constexpr int ldh = LeffBwdLayout::ldh, ldg = LeffBwdLayout::ldg;
  const int ldx = L.ldx, lda = L.lda, Mh = L.Mh, Mo = L.Mo;
  int b, r0, c0;
  tile_geometry<T>(p, blockIdx.x, Mh, L.nh, hpix, b, r0, c0);
  auto pix = [&](int o) {
    return (size_t)(b * H + r0 + o / 8) * W + c0 + o % 8;
  };
  for (int idx = tid; idx < Mo * C; idx += blockDim.x) {
    const int o = idx / C, c = idx % C;
    xn[o * ldx + c] = p.x[pix(o) * C + c];
    acc[o * lda + c] = 0.f;
  }
  __syncthreads();
  for (int o = warp; o < Mo; o += kWarps) {
    if (p.has_ln)
      ln_row<T>(xn + o * ldx, C, p.ln_s, p.ln_b, true, nullptr,
                stats + 2 * o);
    for (int c = lane; c < C; c += 32) p.ln[pix(o) * C + c] = xn[o * ldx + c];
  }
  __syncthreads();

  const int j = tid % kLeffChunk, grp = tid / kLeffChunk;
  for (int k0 = 0; k0 < Ch; k0 += kLeffChunk) {
    if constexpr (kStage) {
      stage_tile<T>(wbuf, L.ldw1, p.w1 + k0, Ch, C, kLeffChunk);
      __syncthreads();
      block_gemm<T, false, false>(xn, ldx, wbuf, L.ldw1, hid, ldh, Mo,
                                  kLeffChunk, C);
    } else {
      block_gemm<T, false, false>(xn, ldx, p.w1 + k0, Ch, hid, ldh, Mo,
                                  kLeffChunk, C);
    }
    for (int i = grp; i < Mh; i += kRowStep)
      dp2[i * ldh + j] = hpix[i] >= 0
                             ? to_f<T>(p.dpre2[(size_t)hpix[i] * Ch + k0 + j])
                             : 0.f;
    __syncthreads();
    const float b1j = p.b1[k0 + j];
    float wdj[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) wdj[t] = to_f<T>(p.wd[t * Ch + k0 + j]);
    float db1 = 0.f;  // this thread's rows of db1[k0 + j], fp32
    for (int o = grp; o < Mo; o += kRowStep) {
      // dh[q] = sum over taps (dy, dx) of dpre2[q - (dy - 1, dx - 1)] wd
      const float* d0 = dp2 + ((o / 8 + 2) * 10 + o % 8 + 2) * ldh + j;
      float dh = 0.f;
#pragma unroll
      for (int t = 0; t < 9; ++t)
        dh = fmaf(d0[-((t / 3) * 10 + t % 3) * ldh], wdj[t], dh);
      const float d32 = rnd<T>(dh) * gelu_grad(hid[o * ldh + j] + b1j);
      db1 += d32;
      const float dp = rnd<T>(d32);
      dp1[o * ldg + j] = from_f<T>(dp);
      p.dpre1[pix(o) * Ch + k0 + j] = from_f<T>(dp);
    }
    // row grp of hid is read by this thread's group only, and only for
    // column j by this thread: it takes the partial until the next chunk
    hid[grp * ldh + j] = db1;
    __syncthreads();
    if (tid < kLeffChunk) {
      float s = 0.f;
      for (int gi = 0; gi < kRowStep; ++gi) s += hid[gi * ldh + tid];
      p.part_b[(size_t)blockIdx.x * (2 * C + Ch) + 2 * C + k0 + tid] = s;
    }
    // dLN += dpre1 . W1[:, k0:k0+64]^T
    if constexpr (kStage)
      block_gemm<T, true, true>(dp1, ldg, wbuf, L.ldw1, acc, lda, Mo, C,
                                kLeffChunk);
    else
      block_gemm<T, true, true>(dp1, ldg, p.w1 + k0, Ch, acc, lda, Mo, C,
                                kLeffChunk);
    __syncthreads();
  }

  // LayerNorm VJP, one warp per pixel, on dLN rounded to T as the plain
  // path rounds it; acc keeps the fp32 dLN, which dln_s and dln_b sum, as
  // the TPU kernel sums its fp32 product (leff.py:683-688): summed over
  // every pixel, per-pixel rounding would add a random walk of roundings
  for (int o = warp; o < Mo; o += kWarps) {
    const size_t at = pix(o) * C;
    const float* row = acc + o * lda;
    float mean = 0.f, rstd = 1.f, s1 = 0.f, s2 = 0.f;
    if (p.has_ln) {
      mean = stats[2 * o];
      rstd = stats[2 * o + 1];
      for (int c = lane; c < C; c += 32) {
        const float dn = rnd<T>(row[c]);
        const float xh = (to_f<T>(p.x[at + c]) - mean) * rstd;
        const float dxh = dn * p.ln_s[c];
        s1 += dxh;
        s2 += dxh * xh;
      }
      s1 = warp_sum(s1) / C;
      s2 = warp_sum(s2) / C;
    }
    for (int c = lane; c < C; c += 32) {
      float d;
      if (p.has_ln) {
        const float xh = (to_f<T>(p.x[at + c]) - mean) * rstd;
        d = rstd * (rnd<T>(row[c]) * p.ln_s[c] - s1 - xh * s2);
      } else {
        d = rnd<T>(row[c]);
      }
      if (p.residual) d = rnd<T>(d) + to_f<T>(p.dy[at + c]);
      p.dx[at + c] = from_f<T>(d);
    }
  }
  if (!p.has_ln) return;
  __syncthreads();
  for (int c = tid; c < C; c += blockDim.x) {
    float ss = 0.f, sb = 0.f;
    for (int o = 0; o < Mo; ++o) {
      const float xh = (to_f<T>(p.x[pix(o) * C + c]) - stats[2 * o]) *
                       stats[2 * o + 1];
      ss = fmaf(acc[o * lda + c], xh, ss);
      sb += acc[o * lda + c];
    }
    p.part_b[(size_t)blockIdx.x * (2 * C + Ch) + c] = ss;
    p.part_b[(size_t)blockIdx.x * (2 * C + Ch) + C + c] = sb;
  }
}

template <typename T>
static int run(int which, LeffBwdParams<T>& p, cudaStream_t stream) {
  p.TH = leff_bwd_tile_rows(which, sizeof(T), p.C);
  const LeffBwdLayout L = leff_bwd_layout(which, sizeof(T), p.C, p.TH);
  auto kernel = which == 0 ? leff_bwd_a_kernel<T> : leff_bwd_b_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (e != cudaSuccess) return (int)e;
  const int blocks = p.B * (p.H / p.TH) * (p.W / 8);
  kernel<<<blocks, kThreads, L.total, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
static int run_bwd(int which, const void* x, const void* dy,
                   const float* ln_s, const float* ln_b, const void* w1,
                   const float* b1, const void* wd, const float* bd,
                   const void* w2, void* g, void* dpre2, float* part_a,
                   void* dx, void* ln, void* dpre1, float* part_b, int B,
                   int H, int W, int C, int Ch, int has_ln, int residual,
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
  p.B = B;
  p.H = H;
  p.W = W;
  p.C = C;
  p.Ch = Ch;
  p.has_ln = has_ln;
  p.residual = residual;
  return run<T>(which, p, static_cast<cudaStream_t>(stream));
}

}  // namespace uf

extern "C" {

// Tile height of backward kernel `which` (0: A, 1: B) for this dtype and
// width; H must be a multiple of it (8, 4 or 2).
int uf_leff_bwd_tile_rows(int which, int is_bf16, int C) {
  return uf::leff_bwd_tile_rows(which, is_bf16 ? 2 : 4, C);
}

// One of the two backward tile kernels (which = 0: A, 1: B). A reads x, dy,
// LN, w1, b1, wd, bd, w2 and writes g, dpre2, part_a; B reads x, dy, LN,
// w1, b1, wd, dpre2 and writes dx, ln, dpre1, part_b. Pointers a kernel
// does not use may be null. Returns a cudaError_t.
int uf_leff_bwd(int which, int is_bf16, const void* x, const void* dy,
                const float* ln_s, const float* ln_b, const void* w1,
                const float* b1, const void* wd, const float* bd,
                const void* w2, void* g, void* dpre2, float* part_a, void* dx,
                void* ln, void* dpre1, float* part_b, int B, int H, int W,
                int C, int Ch, int has_ln, int residual, void* stream) {
  if (is_bf16)
    return uf::run_bwd<uf::bf16>(which, x, dy, ln_s, ln_b, w1, b1, wd, bd, w2,
                                 g, dpre2, part_a, dx, ln, dpre1, part_b, B, H,
                                 W, C, Ch, has_ln, residual, stream);
  return uf::run_bwd<float>(which, x, dy, ln_s, ln_b, w1, b1, wd, bd, w2, g,
                            dpre2, part_a, dx, ln, dpre1, part_b, B, H, W, C,
                            Ch, has_ln, residual, stream);
}

}  // extern "C"
