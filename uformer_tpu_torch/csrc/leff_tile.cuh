// One TH x 8 output tile of the LeFF sub-block, computed by one thread
// block (a partial tile at the image's edge masked). Shared by leff.cu
// (one tile per block) and stage.cu. In fp32 they run it only at C 8, at
// widths that are no power of two and at C 1024: fp32 at C 16-512 is
// leff_f32.cuh's tile (three-pass TF32 on the tensor cores).
//
//   y = [x +] W2 . GELU(dw3x3(GELU(W1 . LN2(x) + b1)) + bd) + b2
//
// The block loads the tile with a 1-pixel halo, LayerNorms it once, then
// walks the 4C hidden in 64-channel chunks: first product on the halo,
// GELU, 3x3 depthwise + bias + GELU on the tile, and the chunk's share of
// the second product accumulated in fp32. The hidden never leaves shared
// memory. Halo pixels outside the image hold a zero hidden (SAME padding
// of the depthwise conv).
//
// In bf16 each chunk's weights (W1[:, k:k+64], then W2[k:k+64, :]) are
// first copied into shared memory with 16-byte loads, and the products
// take their B fragments from there rather than one fragment at a time
// from device memory. fp32 (this tile) has no room for the
// copy and reads them from device memory; at C = 1024 (an --embed_dim 64
// model's bottleneck and dec0, hidden 4096) its tile is 1 x 8, a halo of
// 32 rows of 4 KB. In bf16 at C 768 and 896 (an --embed_dim 48 or 56
// model's bottleneck, in the stage kernel) no tile fits beside the whole
// chunk: the 2 x 8 tile stages it in pieces of kw rows of W1 (columns of
// W2), the products accumulating over them. At C 24, 40 and 56 (8 mod 16)
// the bf16 products run 16 wider: the first over C + 8 (xn's columns and
// W1's rows past C zero), the second into C + 8 columns (W2's past C
// zero).
#pragma once

#include "common.cuh"

namespace uf {

template <typename T>
struct LeffParams {
  const T* x;         // (B, H, W, C)
  T* y;               // (B, H, W, C), never aliases x
  const float* ln_s;  // (C,)
  const float* ln_b;  // (C,)
  const T* w1;        // (C, Ch)
  const float* b1;    // (Ch,)
  const T* wd;        // (3, 3, Ch)
  const float* bd;    // (Ch,)
  const T* w2;        // (Ch, C)
  const float* b2;    // (C,)
  int B, H, W, C, Ch, TH;
  int has_ln, residual;
};

constexpr int kLeffChunk = 64;
static_assert(kThreads % kLeffChunk == 0, "a thread keeps one channel");

struct LeffLayout {
  static constexpr int ldh = kLeffChunk + 4, ldg = kLeffChunk + 8;
  int TH, Mo, nh, Mh, C16, kw, ldx, lda, ldw1, ldw2;
  size_t xn, acc, hid, g, hpix, w, total;
};

// The layout with the weight chunk staged (bf16) in pieces of kw rows of
// W1 / columns of W2: kw = C16 (C rounded up to 16) stages it whole.
__host__ __device__ inline LeffLayout leff_layout_kw(int tsize, int C,
                                                     int TH, int kw) {
  LeffLayout L;
  Carver cv;
  L.TH = TH;
  L.Mo = TH * 8;
  L.nh = (TH + 2) * 10;
  L.Mh = (L.nh + 15) / 16 * 16;
  L.C16 = (C + 15) / 16 * 16;
  L.kw = kw;
  L.ldx = C + 8;  // >= C16
  L.lda = L.C16 + 4;
  L.xn = cv.take((size_t)L.Mh * L.ldx * tsize);
  L.acc = cv.take((size_t)L.Mo * L.lda * sizeof(float));
  L.hid = cv.take((size_t)L.Mh * LeffLayout::ldh * sizeof(float));
  L.g = cv.take((size_t)L.Mo * LeffLayout::ldg * tsize);
  L.hpix = cv.take((size_t)L.Mh * sizeof(int));
  // the staged weight piece: W1[kc:kc+kw, k:k+64] (kw x 64) or
  // W2[k:k+64, n0:n0+kw] (64 x kw), padded rows; bf16 only
  L.ldw1 = kLeffChunk + 8;
  L.ldw2 = kw + 8;
  L.w = 0;
  if (tsize == 2) {
    const size_t w1 = (size_t)kw * L.ldw1, w2 = (size_t)kLeffChunk * L.ldw2;
    L.w = cv.take((w1 > w2 ? w1 : w2) * tsize);
  }
  L.total = cv.off;
  return L;
}

// The layout at tile height TH: the whole chunk staged where it fits, else
// (bf16 at C 768 and 896) the largest pieces of a multiple of 64 that do.
__host__ __device__ inline LeffLayout leff_layout(int tsize, int C, int TH) {
  const int C16 = (C + 15) / 16 * 16;
  LeffLayout L = leff_layout_kw(tsize, C, TH, C16);
  for (int kw = (C16 - 1) / kLeffChunk * kLeffChunk;
       tsize == 2 && L.total > kSmemLimit && kw >= kLeffChunk;
       kw -= kLeffChunk)
    L = leff_layout_kw(tsize, C, TH, kw);
  return L;
}

// Tile height: the tallest of 8, 4, 2 rows whose working set fits with the
// whole weight chunk staged; where none does, 1 in fp32 (C = 1024) and 2 in
// bf16 (C 768-1024; the products are 16 rows deep), whose chunk is then
// staged in pieces (leff_layout).
__host__ __device__ inline int leff_tile_rows(int tsize, int C) {
  const int C16 = (C + 15) / 16 * 16;
  for (int th = 8; th > 1; th >>= 1)
    if (leff_layout_kw(tsize, C, th, C16).total <= kSmemLimit) return th;
  return tsize == 4 ? 1 : 2;
}

template <typename T>
__device__ void leff_tile(const LeffParams<T>& p, int item,
                          unsigned char* smem) {
  const LeffLayout L = leff_layout(sizeof(T), p.C, p.TH);
  const int C = p.C, Ch = p.Ch, H = p.H, W = p.W, TH = p.TH;
  const int tid = threadIdx.x, warp = tid >> 5;
  // partial tiles at the bottom and right edges: their halo outside the
  // image holds a zero hidden, their outputs there are not written
  const int nTw = (W + 7) / 8, nT = ((H + TH - 1) / TH) * nTw;
  const int b = item / nT, r0 = ((item % nT) / nTw) * TH,
            c0 = (item % nTw) * 8;

  T* xn = reinterpret_cast<T*>(smem + L.xn);
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  float* hid = reinterpret_cast<float*>(smem + L.hid);
  T* g = reinterpret_cast<T*>(smem + L.g);
  int* hpix = reinterpret_cast<int*>(smem + L.hpix);
  T* wbuf = reinterpret_cast<T*>(smem + L.w);
  constexpr bool kStage = sizeof(T) == 2;
  const int ldx = L.ldx, lda = L.lda, Mh = L.Mh, Mo = L.Mo;
  constexpr int ldh = LeffLayout::ldh, ldg = LeffLayout::ldg;

  for (int i = tid; i < Mh; i += blockDim.x) {
    int at = -1;
    if (i < L.nh) {
      const int r = r0 - 1 + i / 10, c = c0 - 1 + i % 10;
      if (r >= 0 && r < H && c >= 0 && c < W) at = (b * H + r) * W + c;
    }
    hpix[i] = at;
  }
  __syncthreads();
  for (int idx = tid; idx < Mh * C; idx += blockDim.x) {
    const int i = idx / C, c = idx % C;
    xn[i * ldx + c] = hpix[i] >= 0 ? p.x[(size_t)hpix[i] * C + c]
                                   : from_f<T>(0.f);
  }
  if constexpr (kStage)  // the first product's pad columns (C 8 mod 16)
    zero_pad<T>(xn, ldx, Mh, L.C16, Mh, C);
  for (int idx = tid; idx < Mo * C; idx += blockDim.x)
    acc[(idx / C) * lda + idx % C] = 0.f;
  __syncthreads();
  if (p.has_ln) {
    for (int i = warp; i < Mh; i += kWarps)
      if (hpix[i] >= 0) ln_row<T>(xn + i * ldx, C, p.ln_s, p.ln_b, true,
                                  nullptr);
    __syncthreads();
  }

  const int kw = L.kw, C16 = L.C16;
  const bool whole = kw >= C;  // the weight chunk staged in one piece
  for (int k0 = 0; k0 < Ch; k0 += kLeffChunk) {
    if constexpr (kStage) {
      // W1's rows in pieces of kw, zero past C up to the next 16
      for (int kc = 0; kc < C; kc += kw) {
        const int kr = min(kw, C - kc), kr16 = (kr + 15) & ~15;
        stage_tile<T>(wbuf, L.ldw1, p.w1 + (size_t)kc * Ch + k0, Ch, kr,
                      kLeffChunk);
        zero_pad<T>(wbuf, L.ldw1, kr16, kLeffChunk, kr, kLeffChunk);
        __syncthreads();
        if (kc == 0)
          block_gemm<T, false, false>(xn, ldx, wbuf, L.ldw1, hid, ldh, Mh,
                                      kLeffChunk, kr16);
        else
          block_gemm<T, false, true>(xn + kc, ldx, wbuf, L.ldw1, hid, ldh,
                                     Mh, kLeffChunk, kr16);
        if (kc + kw < C) __syncthreads();
      }
    } else {
      block_gemm<T, false, false>(xn, ldx, p.w1 + k0, Ch, hid, ldh, Mh,
                                  kLeffChunk, C);
    }
    __syncthreads();
    if constexpr (kStage)
      if (whole) {
        stage_tile<T>(wbuf, L.ldw2, p.w2 + (size_t)k0 * C, C, kLeffChunk, C);
        zero_pad<T>(wbuf, L.ldw2, kLeffChunk, C16, kLeffChunk, C);
      }
    // each thread keeps one hidden channel j of the chunk, with its biases
    // and 9 taps in registers, and walks the rows
    const int j = tid % kLeffChunk;
    constexpr int kRowStep = kThreads / kLeffChunk;
    const float b1j = p.b1[k0 + j], bdj = p.bd[k0 + j];
    float wdj[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) wdj[t] = to_f<T>(p.wd[t * Ch + k0 + j]);
    for (int i = tid / kLeffChunk; i < Mh; i += kRowStep)
      hid[i * ldh + j] =
          hpix[i] >= 0 ? rnd<T>(gelu(hid[i * ldh + j] + b1j)) : 0.f;
    __syncthreads();
    for (int o = tid / kLeffChunk; o < Mo; o += kRowStep) {
      const float* h0 = hid + ((o / 8) * 10 + o % 8) * ldh + j;
      float sum = 0.f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          sum = fmaf(h0[(dy * 10 + dx) * ldh], wdj[dy * 3 + dx], sum);
      g[o * ldg + j] = from_f<T>(gelu(sum + bdj));
    }
    __syncthreads();
    if constexpr (kStage) {
      if (whole) {
        block_gemm<T, false, true>(g, ldg, wbuf, L.ldw2, acc, lda, Mo, C16,
                                   kLeffChunk);
      } else {
        // W2's columns in pieces of kw (C a multiple of 16 here)
        for (int n0 = 0; n0 < C; n0 += kw) {
          const int nn = min(kw, C - n0);
          stage_tile<T>(wbuf, L.ldw2, p.w2 + (size_t)k0 * C + n0, C,
                        kLeffChunk, nn);
          __syncthreads();
          block_gemm<T, false, true>(g, ldg, wbuf, L.ldw2, acc + n0, lda, Mo,
                                     nn, kLeffChunk);
          __syncthreads();
        }
      }
    } else
      block_gemm<T, false, true>(g, ldg, p.w2 + (size_t)k0 * C, C, acc, lda,
                                 Mo, C, kLeffChunk);
    __syncthreads();
  }

  for (int idx = tid; idx < Mo * C; idx += blockDim.x) {
    const int o = idx / C, n = idx % C;
    if (r0 + o / 8 >= H || c0 + o % 8 >= W) continue;
    const size_t at = ((size_t)(b * H + r0 + o / 8) * W + c0 + o % 8) * C + n;
    float out = rnd<T>(acc[o * lda + n] + p.b2[n]);
    if (p.residual) out = out + to_f<T>(p.x[at]);
    p.y[at] = from_f<T>(out);
  }
  __syncthreads();
}

}  // namespace uf
