// Kernel 7 (leff_bwd.cu) in bf16 at the widths that are no power of two:
// an --embed_dim 24-56 model's C 24-896 and an --embed_dim 72-128 model's
// C 72-2048 but the powers of two up to 1024 (hidden 4C, padded to a
// multiple of 64 by the host; C 24-120 may be 8 mod 16), C 2048 too
// (above leff_bwd_mma.cuh's tiles, a power of two). leff_bwd.cu's fp32
// FMA kernels A and B, on WMMA fragments through shared memory, as the
// forward's leff_tile.cuh takes these widths:
//   - a product of depth C (h and pre1 = LN(x) W1, dg = dy W2^T) takes
//     its weight in chunks of kChunk rows (or columns) staged into shared
//     memory, the last chunk's depth zero to the next 16, the token
//     tiles' columns C..C+7 zero: exact;
//   - dLN += dpre1 W1^T (depth 64, C outputs) takes W1's chunk columns in
//     pieces of kChunk rows of C, zero to the next 16 rows, into an fp32
//     Mo x (C16 + 4) accumulator for the whole hidden loop.
// The rounding points are leff_bwd_mma.cuh's (JAX's): h rounded to bf16,
// dg in fp32, dpre2 rounded after GELU', dbd from the fp32 dpre2 and dwd
// from the rounded one; dpre1 rounded once, db1 from its fp32 value; the
// LayerNorm VJP on the fp32 dLN. One block per TH x 8 output tile, every
// hidden chunk (no split), TH the most of 8, 4, 2 that fits shared memory
// with the tile's LN(x) (the halo's in A, the outputs' in B); where none
// does (A from C 1408, B at C 2048: the halo of 48 x (C + 8) bf16 or the
// 16 x (C + 4) fp32 dLN accumulator fills the block's 227 KB), the most
// that fits without it, its LN(x) then in the block's slot of
// p.xn_scratch in device memory (L2), read there by the W1 products. Its
// own translation unit, so that nvcc builds it beside leff_bwd.cu.
//
// What bounds it on the H100: the products of 2 C Ch multiply-adds a
// pixel (three of them, as kernel 7's other widths), here block-wide WMMA
// between barriers with the weights restaged per tile: latency and the
// staging's L2 reads set its pace, not the tensor cores (PERF.md §6).
#include "leff_bwd_mma.cuh"

namespace uf {

namespace {

constexpr int kChunk = 128;  // rows of a staged weight piece
constexpr int ldh = kLeffChunk + 4, ldg = kLeffChunk + 8;
constexpr int ldw = kLeffChunk + 8, ldt = kChunk + 8;

struct Layout {
  int TH, Mo, nh, Mh, ldx, ldy, lda;
  size_t xn, dyt, hid, dg, red, acc, dp2, dp1, stats, w, hpix, opix, total;
  bool xn_smem;  // the LN(x) tile in shared memory, else in xn_scratch
  __host__ __device__ int xn_rows(int which) const {
    return which == 0 ? Mh : Mo;
  }
};

// which = 0: kernel A, 1: kernel B
__host__ __device__ inline Layout layout(int which, int C, int TH) {
  Layout L;
  Carver cv;
  L.TH = TH;
  L.Mo = TH * 8;
  L.nh = (TH + 2) * 10;
  L.Mh = (L.nh + 15) / 16 * 16;
  L.ldy = C + 8;
  L.lda = (C + 15) / 16 * 16 + 4;
  L.dyt = L.dg = L.red = L.acc = L.dp2 = L.dp1 = L.stats = 0;
  L.hpix = cv.take((size_t)L.Mh * sizeof(int));
  L.opix = cv.take((size_t)L.Mo * sizeof(int));
  // a staged piece: kChunk x 64 of W1 (ld ldw), or 64 x kChunk of W2 (ld
  // ldt)
  const size_t piece = kChunk * ldw > kLeffChunk * ldt ? kChunk * ldw
                                                       : kLeffChunk * ldt;
  L.w = cv.take(piece * sizeof(bf16));
  if (which == 0) {
    L.dyt = cv.take((size_t)L.Mo * L.ldy * sizeof(bf16));
    L.hid = cv.take((size_t)L.Mh * ldh * sizeof(float));
    L.dg = cv.take((size_t)L.Mo * ldh * sizeof(float));
    L.red = cv.take((size_t)kRowStep * kLeffChunk * 10 * sizeof(float));
  } else {
    L.acc = cv.take((size_t)L.Mo * L.lda * sizeof(float));
    L.hid = cv.take((size_t)L.Mo * ldh * sizeof(float));
    L.dp2 = cv.take((size_t)L.Mh * ldh * sizeof(float));
    L.dp1 = cv.take((size_t)L.Mo * ldg * sizeof(bf16));
    L.stats = cv.take((size_t)2 * L.Mo * sizeof(float));
  }
  // the tile's LN(x), last: in shared memory where it fits
  const size_t xn = (size_t)L.xn_rows(which) * (C + 8) * sizeof(bf16);
  L.xn_smem = cv.off + xn <= kSmemLimit;
  L.xn = L.xn_smem ? cv.take(xn) : 0;
  L.ldx = L.xn_smem ? C + 8 : C;
  L.total = cv.off;
  return L;
}

// the LN(x) tile of kernel `which`'s block: in shared memory, or the
// block's slot of p.xn_scratch
__device__ bf16* xn_tile(const LeffBwdParams<bf16>& p, const Layout& L,
                         int which, unsigned char* smem) {
  return L.xn_smem ? reinterpret_cast<bf16*>(smem + L.xn)
                   : p.xn_scratch +
                         (size_t)blockIdx.x * L.xn_rows(which) * p.C;
}

// halo pixel indices of tile `item` (-1 outside the image or padding
// rows) and output pixel indices (-1 past the image)
__device__ void geometry(const LeffBwdParams<bf16>& p, const Layout& L,
                         int* hpix, int* opix) {
  const TileGeom geo(blockIdx.x, p.TH, p.H, p.W);
  for (int i = threadIdx.x; i < L.Mh; i += blockDim.x)
    hpix[i] = geo.halo(i, L.nh);
  for (int o = threadIdx.x; o < L.Mo; o += blockDim.x) opix[o] = geo.out(o);
}

// rows x C tile of a (pixels, C) tensor at the rows `pix` (zero at -1),
// its columns C..C+7 zero where C is 8 mod 16
__device__ void gather(bf16* dst, int ld, const bf16* src, const int* pix,
                       int rows, int C) {
  for (int idx = threadIdx.x; idx < rows * C; idx += blockDim.x) {
    const int i = idx / C, c = idx % C;
    dst[i * ld + c] = pix[i] >= 0 ? src[(size_t)pix[i] * C + c]
                                  : __float2bfloat16(0.f);
  }
  if (C % 16) zero_pad<bf16>(dst, ld, rows, C + 8, rows, C);
}

// out[M x 64] (fp32, ld ldh) = A[M x C] (ld lda) W1[:, k0:k0+64], W1's
// rows staged kChunk at a time, each piece's depth zero to the next 16
__device__ void product_w1(const LeffBwdParams<bf16>& p, const bf16* A,
                           int lda, int M, int k0, bf16* ws, float* out) {
  const int C = p.C;
  for (int kc = 0; kc < C; kc += kChunk) {
    const int kr = min(kChunk, C - kc), kr16 = (kr + 15) & ~15;
    stage_tile<bf16>(ws, ldw, p.w1 + (size_t)kc * p.Ch + k0, p.Ch, kr,
                     kLeffChunk);
    zero_pad<bf16>(ws, ldw, kr16, kLeffChunk, kr, kLeffChunk);
    __syncthreads();
    if (kc == 0)
      block_gemm<bf16, false, false>(A, lda, ws, ldw, out, ldh, M,
                                     kLeffChunk, kr16);
    else
      block_gemm<bf16, false, true>(A + kc, lda, ws, ldw, out, ldh, M,
                                    kLeffChunk, kr16);
    __syncthreads();
  }
}

}  // namespace

__global__ void __launch_bounds__(kThreads)
    leff_bwd_a_heads_kernel(LeffBwdParams<bf16> p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(0, p.C, p.TH);
  const int C = p.C, Ch = p.Ch;
  const int tid = threadIdx.x, warp = tid >> 5;
  bf16* xn = xn_tile(p, L, 0, smem);
  bf16* dyt = reinterpret_cast<bf16*>(smem + L.dyt);
  float* hid = reinterpret_cast<float*>(smem + L.hid);
  float* dg = reinterpret_cast<float*>(smem + L.dg);
  float* red = reinterpret_cast<float*>(smem + L.red);
  bf16* ws = reinterpret_cast<bf16*>(smem + L.w);
  int* hpix = reinterpret_cast<int*>(smem + L.hpix);
  int* opix = reinterpret_cast<int*>(smem + L.opix);
  const int ldx = L.ldx, ldy = L.ldy, Mh = L.Mh, Mo = L.Mo;
  geometry(p, L, hpix, opix);
  __syncthreads();
  gather(xn, ldx, p.x, hpix, Mh, C);
  gather(dyt, ldy, p.dy, opix, Mo, C);
  __syncthreads();
  if (p.has_ln) {
    for (int i = warp; i < Mh; i += kWarps)
      if (hpix[i] >= 0)
        ln_row<bf16>(xn + i * ldx, C, p.ln_s, p.ln_b, true, nullptr);
    __syncthreads();
  }

  const int j = tid % kLeffChunk, grp = tid / kLeffChunk;
  for (int k0 = 0; k0 < Ch; k0 += kLeffChunk) {
    // h = GELU(LN(x) W1 + b1) on the halo, rounded to bf16
    product_w1(p, xn, ldx, Mh, k0, ws, hid);
    const float b1j = p.b1[k0 + j], bdj = p.bd[k0 + j];
    float wdj[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) wdj[t] = to_f<bf16>(p.wd[t * Ch + k0 + j]);
    for (int i = grp; i < Mh; i += kRowStep)
      hid[i * ldh + j] =
          hpix[i] >= 0 ? rnd<bf16>(gelu(hid[i * ldh + j] + b1j)) : 0.f;
    // dg = dy . W2[k0:k0+64, :]^T, unrounded; W2's chunk rows staged
    // kChunk columns at a time (as N x K)
    for (int kc = 0; kc < C; kc += kChunk) {
      const int kr = min(kChunk, C - kc), kr16 = (kr + 15) & ~15;
      __syncthreads();  // the previous piece's readers, and hid's writers
      stage_tile<bf16>(ws, ldt, p.w2 + (size_t)k0 * C + kc, C, kLeffChunk,
                       kr);
      zero_pad<bf16>(ws, ldt, kLeffChunk, kr16, kLeffChunk, kr);
      __syncthreads();
      if (kc == 0)
        block_gemm<bf16, true, false>(dyt, ldy, ws, ldt, dg, ldh, Mo,
                                      kLeffChunk, kr16);
      else
        block_gemm<bf16, true, true>(dyt + kc, ldy, ws, ldt, dg, ldh, Mo,
                                     kLeffChunk, kr16);
    }
    __syncthreads();
    float dwd[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float dbd = 0.f;
    for (int o = grp; o < Mo; o += kRowStep) {
      if (opix[o] < 0) continue;
      const float* h0 = hid + ((o / 8) * 10 + o % 8) * ldh + j;
      float hv[9];
#pragma unroll
      for (int t = 0; t < 9; ++t) hv[t] = h0[((t / 3) * 10 + t % 3) * ldh];
      float pre = 0.f;
#pragma unroll
      for (int t = 0; t < 9; ++t) pre = fmaf(hv[t], wdj[t], pre);
      pre += bdj;
      const size_t at = (size_t)opix[o] * Ch + k0 + j;
      p.g[at] = __float2bfloat16(gelu(pre));
      const float d32 = dg[o * ldh + j] * gelu_grad(pre);
      const float dp = rnd<bf16>(d32);
      p.dpre2[at] = __float2bfloat16(dp);
      dbd += d32;
#pragma unroll
      for (int t = 0; t < 9; ++t) dwd[t] = fmaf(dp, hv[t], dwd[t]);
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
    leff_bwd_b_heads_kernel(LeffBwdParams<bf16> p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(1, p.C, p.TH);
  const int C = p.C, Ch = p.Ch;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  bf16* xn = xn_tile(p, L, 1, smem);
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  float* hid = reinterpret_cast<float*>(smem + L.hid);
  float* dp2 = reinterpret_cast<float*>(smem + L.dp2);
  bf16* dp1 = reinterpret_cast<bf16*>(smem + L.dp1);
  float* stats = reinterpret_cast<float*>(smem + L.stats);
  bf16* ws = reinterpret_cast<bf16*>(smem + L.w);
  int* hpix = reinterpret_cast<int*>(smem + L.hpix);
  int* opix = reinterpret_cast<int*>(smem + L.opix);
  const int ldx = L.ldx, lda = L.lda, Mh = L.Mh, Mo = L.Mo;
  geometry(p, L, hpix, opix);
  __syncthreads();
  gather(xn, ldx, p.x, opix, Mo, C);
  for (int idx = tid; idx < Mo * lda; idx += blockDim.x) acc[idx] = 0.f;
  __syncthreads();
  for (int o = warp; o < Mo; o += kWarps) {
    if (opix[o] < 0) continue;
    if (p.has_ln)
      ln_row<bf16>(xn + o * ldx, C, p.ln_s, p.ln_b, true, nullptr,
                   stats + 2 * o);
    for (int c = lane; c < C; c += 32)
      p.ln[(size_t)opix[o] * C + c] = xn[o * ldx + c];
  }
  __syncthreads();

  const int j = tid % kLeffChunk, grp = tid / kLeffChunk;
  for (int k0 = 0; k0 < Ch; k0 += kLeffChunk) {
    // pre1 = LN(x) W1 (fp32); the chunk's dpre2 on the halo
    for (int i = grp; i < Mh; i += kRowStep)
      dp2[i * ldh + j] = hpix[i] >= 0
          ? to_f<bf16>(p.dpre2[(size_t)hpix[i] * Ch + k0 + j]) : 0.f;
    product_w1(p, xn, ldx, Mo, k0, ws, hid);
    const float b1j = p.b1[k0 + j];
    float wdj[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) wdj[t] = to_f<bf16>(p.wd[t * Ch + k0 + j]);
    // dh = dw3x3^T(dpre2); dpre1 = dh GELU'(pre1 + b1) from the fp32 dh,
    // rounded once; db1 from the fp32 dpre1 (leff.py:675-682)
    float db1 = 0.f;
    for (int o = grp; o < Mo; o += kRowStep) {
      float dp = 0.f;
      if (opix[o] >= 0) {
        const float* d0 = dp2 + ((o / 8 + 2) * 10 + o % 8 + 2) * ldh + j;
        float dh = 0.f;
#pragma unroll
        for (int t = 0; t < 9; ++t)
          dh = fmaf(d0[-((t / 3) * 10 + t % 3) * ldh], wdj[t], dh);
        const float d32 = dh * gelu_grad(hid[o * ldh + j] + b1j);
        db1 += d32;
        dp = rnd<bf16>(d32);
        p.dpre1[(size_t)opix[o] * Ch + k0 + j] = __float2bfloat16(dp);
      }
      dp1[o * ldg + j] = __float2bfloat16(dp);
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
    // dLN += dpre1 . W1[:, k0:k0+64]^T, W1's rows in pieces of kChunk
    for (int n0 = 0; n0 < C; n0 += kChunk) {
      const int nn = min(kChunk, C - n0), nn16 = (nn + 15) & ~15;
      stage_tile<bf16>(ws, ldw, p.w1 + (size_t)n0 * Ch + k0, Ch, nn,
                       kLeffChunk);
      zero_pad<bf16>(ws, ldw, nn16, kLeffChunk, nn, kLeffChunk);
      __syncthreads();
      block_gemm<bf16, true, true>(dp1, ldg, ws, ldw, acc + n0, lda, Mo,
                                   nn16, kLeffChunk);
      __syncthreads();
    }
  }

  // LayerNorm VJP, one warp per pixel, on the fp32 dLN (leff.py:683-688);
  // without LN dx is the rounded dLN; dln_s sums the fp32 dLN
  for (int o = warp; o < Mo; o += kWarps) {
    if (opix[o] < 0) continue;
    const size_t at = (size_t)opix[o] * C;
    const float* row = acc + o * lda;
    float mean = 0.f, rstd = 1.f, s1 = 0.f, s2 = 0.f;
    if (p.has_ln) {
      mean = stats[2 * o];
      rstd = stats[2 * o + 1];
      for (int c = lane; c < C; c += 32) {
        const float xh = (to_f<bf16>(p.x[at + c]) - mean) * rstd;
        const float dxh = row[c] * p.ln_s[c];
        s1 += dxh;
        s2 += dxh * xh;
      }
      s1 = warp_sum(s1) / C;
      s2 = warp_sum(s2) / C;
    }
    for (int c = lane; c < C; c += 32) {
      float d;
      if (p.has_ln) {
        const float xh = (to_f<bf16>(p.x[at + c]) - mean) * rstd;
        d = rstd * (row[c] * p.ln_s[c] - s1 - xh * s2);
      } else {
        d = rnd<bf16>(row[c]);
      }
      if (p.residual) d = rnd<bf16>(d) + to_f<bf16>(p.dy[at + c]);
      p.dx[at + c] = __float2bfloat16(d);
    }
  }
  if (!p.has_ln) return;
  __syncthreads();
  for (int c = tid; c < C; c += blockDim.x) {
    float ss = 0.f;
    for (int o = 0; o < Mo; ++o) {
      if (opix[o] < 0) continue;
      const float xh = (to_f<bf16>(p.x[(size_t)opix[o] * C + c]) -
                        stats[2 * o]) * stats[2 * o + 1];
      ss = fmaf(acc[o * lda + c], xh, ss);
    }
    p.part_b[(size_t)blockIdx.x * (C + Ch) + c] = ss;
  }
}

int leff_bwd_heads_rows(int which, int C) {
  if (C % 8) return 0;
  // the most rows with LN(x) in shared memory, else without it
  for (int in_smem = 1; in_smem >= 0; --in_smem)
    for (int th = 8; th > 1; th >>= 1) {
      const Layout L = layout(which, C, th);
      if (L.total <= kSmemLimit && L.xn_smem >= in_smem) return th;
    }
  return 0;
}

int leff_bwd_heads_scratch(int which, int C) {
  const int th = leff_bwd_heads_rows(which, C);
  if (!th) return 0;
  const Layout L = layout(which, C, th);
  return L.xn_smem ? 0 : L.xn_rows(which);
}

int leff_bwd_heads(int which, LeffBwdParams<bf16>& p, cudaStream_t stream) {
  p.TH = leff_bwd_heads_rows(which, p.C);
  if (!p.TH || which > 1 || p.Ch % kLeffChunk)
    return (int)cudaErrorInvalidValue;
  const Layout L = layout(which, p.C, p.TH);
  // a C of 8 mod 16 reads the LN(x) tile's zero pad columns: shared memory
  if (!L.xn_smem && (p.xn_scratch == nullptr || p.C % 16))
    return (int)cudaErrorInvalidValue;
  auto kernel = which == 0 ? leff_bwd_a_heads_kernel : leff_bwd_b_heads_kernel;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (e != cudaSuccess) return (int)e;
  const int blocks = p.B * ((p.H + p.TH - 1) / p.TH) * ((p.W + 7) / 8);
  kernel<<<blocks, kThreads, L.total, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace uf
