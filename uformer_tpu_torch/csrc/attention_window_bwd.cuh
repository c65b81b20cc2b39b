// Backward of one 8x8 window of the LeWin attention sub-block, computed by
// one thread block from its 64 gathered tokens. attention_bwd.cu runs it
// on the image layout (tokens gathered at the shifted coordinates); a
// windowed caller passes the identity token map.
//
// Forward (recomputed here from x, as the TPU kernel does):
//   xm = LN1(x) + mod; q = (xm Wq + bq) * scale; k, v = xm Wkv + bkv;
//   P = softmax(q k^T + bias + mask) (fp32); O = P v; y = O Wo + bo [+ x]
// Backward, with g = dL/dy:
//   dO = g Wo^T; per head dP = dO v^T, dS = P (dP - rowsum(dP P)),
//   dv = P^T dO, dq = dS k * scale, dk = dS^T q; dxm = dq Wq^T + dkv Wkv^T;
//   dx = LN1 VJP(dxm) [+ g].
// Per token the window writes what the weight gradients need (xm and
// [dq | dk | dv] in window order, O at its image pixel); per window its
// share of dbias (dS), dmod (dxm) and dln_s / dln_b. wgrad.cuh sums them.
#pragma once

#include "attention_window.cuh"

namespace uf {

template <typename T>
struct AttnBwdParams {
  const T* x;          // (B, H, W, C) block input
  const T* g;          // (B, H, W, C) gradient of the output
  const T* mod;        // (64, C) or null
  const float* ln_s;   // (C,)
  const float* ln_b;   // (C,)
  const T* wq;         // (C, C) (in, out)
  const float* bq;     // (C,)
  const T* wkv;        // (C, 2C) [k | v]
  const float* bkv;    // (2C,)
  const T* wo;         // (C, C)
  const float* bias;   // (nH, 64, 64)
  T* dx;               // (B, H, W, C)
  T* xm_w;             // (windows * 64, C) xm, window order
  T* dqkv_w;           // (windows * 64, 3C) [dq | dk | dv], window order
  T* o_img;            // (B, H, W, C) head outputs at their pixels
  float* dbias_part;   // (windows, nH * 4096)
  float* dmod_part;    // (windows, 64 * C), or null without mod
  float* dln_part;     // (windows, 2C): dln_s then dln_b, or null
  T* x_scratch;        // (windows, 64, C) when xm misses shared memory
  T* do_scratch;       // (windows, 64, C) when dO misses shared memory
  int B, H, W, C, nH, shift;
  float scale;
  int has_ln, residual;
};

struct AttnBwdLayout {
  static constexpr int ldq = 40, ldp = 72, ldsp = 68, ldacc = 100;
  int ldx, ldd;
  size_t q, k, v, pt, sp, acc, pix, rid, stats, dsh, dsl, x, dO, total;
  bool x_smem, do_smem;
};

__host__ __device__ inline AttnBwdLayout attn_bwd_layout(int ts, int C) {
  AttnBwdLayout L;
  Carver cv;
  L.q = cv.take(64 * AttnBwdLayout::ldq * ts);
  L.k = cv.take(64 * AttnBwdLayout::ldq * ts);
  L.v = cv.take(64 * AttnBwdLayout::ldq * ts);
  L.pt = cv.take(64 * AttnBwdLayout::ldp * ts);
  L.sp = cv.take(64 * AttnBwdLayout::ldsp * sizeof(float));
  L.acc = cv.take(64 * AttnBwdLayout::ldacc * sizeof(float));
  L.pix = cv.take(64 * sizeof(int));
  L.rid = cv.take(64 * sizeof(int));
  L.stats = cv.take(128 * sizeof(float));
  // dS as the sum of two values of T (in fp32 the second is 0)
  L.dsh = cv.take(64 * AttnBwdLayout::ldp * ts);
  L.dsl = cv.take(64 * AttnBwdLayout::ldp * ts);
  // the token tile (xm, later dxm) and dO: in shared memory when they
  // fit, else in a global slot per window (row stride C)
  const size_t tile = (size_t)64 * (C + 8) * ts;
  L.x_smem = cv.off + tile <= kSmemLimit;
  L.x = L.x_smem ? cv.take(tile) : 0;
  L.ldx = L.x_smem ? C + 8 : C;
  L.do_smem = cv.off + tile <= kSmemLimit;
  L.dO = L.do_smem ? cv.take(tile) : 0;
  L.ldd = L.do_smem ? C + 8 : C;
  L.total = cv.off;
  return L;
}

// Backward of window `w`. pix[t] is the row of token t in x, g, dx and
// o_img; rid[t] its SW-MSA region id (all 0 when unshifted). Both live in
// the layout's pix / rid slots, filled and synchronised by the caller.
template <typename T>
__device__ void attention_window_bwd(const AttnBwdParams<T>& p, int w,
                                     unsigned char* smem) {
  const AttnBwdLayout L = attn_bwd_layout(sizeof(T), p.C);
  const int C = p.C, C3 = 3 * p.C;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr int ldq = AttnBwdLayout::ldq, ldp = AttnBwdLayout::ldp,
                ldsp = AttnBwdLayout::ldsp, lda = AttnBwdLayout::ldacc;
  T* q = reinterpret_cast<T*>(smem + L.q);
  T* k = reinterpret_cast<T*>(smem + L.k);
  T* v = reinterpret_cast<T*>(smem + L.v);
  T* PT = reinterpret_cast<T*>(smem + L.pt);
  float* SP = reinterpret_cast<float*>(smem + L.sp);
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  const int* pix = reinterpret_cast<const int*>(smem + L.pix);
  const int* rid = reinterpret_cast<const int*>(smem + L.rid);
  float* stats = reinterpret_cast<float*>(smem + L.stats);
  T* DSh = reinterpret_cast<T*>(smem + L.dsh);
  T* DSl = reinterpret_cast<T*>(smem + L.dsl);
  T* X = L.x_smem ? reinterpret_cast<T*>(smem + L.x)
                  : p.x_scratch + (size_t)w * 64 * C;
  T* DO = L.do_smem ? reinterpret_cast<T*>(smem + L.dO)
                    : p.do_scratch + (size_t)w * 64 * C;
  const int ldx = L.ldx, ldd = L.ldd;

  // dO = g Wo^T, in 64-column chunks; X holds the gathered g meanwhile
  for (int idx = tid; idx < 64 * C; idx += blockDim.x) {
    const int t = idx / C, c = idx % C;
    X[t * ldx + c] = p.g[(size_t)pix[t] * C + c];
  }
  __syncthreads();
  for (int n0 = 0; n0 < C; n0 += 64) {
    const int nn = min(64, C - n0);
    block_gemm<T, true, false>(X, ldx, p.wo + (size_t)n0 * C, C, acc, lda, 64,
                               nn, C);
    __syncthreads();
    for (int idx = tid; idx < 64 * nn; idx += blockDim.x) {
      const int t = idx / nn, j = idx % nn;
      DO[t * ldd + n0 + j] = from_f<T>(acc[t * lda + j]);
    }
    __syncthreads();
  }

  // xm = LN1(x) + mod, kept in X and written out for dWq, dWkv
  for (int idx = tid; idx < 64 * C; idx += blockDim.x) {
    const int t = idx / C, c = idx % C;
    X[t * ldx + c] = p.x[(size_t)pix[t] * C + c];
  }
  __syncthreads();
  for (int t = warp; t < 64; t += kWarps)
    ln_row<T>(X + t * ldx, C, p.ln_s, p.ln_b, p.has_ln,
              p.mod ? p.mod + t * C : nullptr, stats + 2 * t);
  __syncthreads();
  for (int idx = tid; idx < 64 * C; idx += blockDim.x) {
    const int t = idx / C, c = idx % C;
    p.xm_w[((size_t)w * 64 + t) * C + c] = X[t * ldx + c];
  }

  T* dqkv = p.dqkv_w + (size_t)w * 64 * C3;
  for (int h = 0; h < p.nH; ++h) {
    const int c0 = h * 32;
    block_gemm<T, false, false>(X, ldx, p.wq + c0, C, acc, lda, 64, 32, C);
    block_gemm<T, false, false>(X, ldx, p.wkv + c0, 2 * C, acc + 32, lda, 64,
                                32, C, 8);
    block_gemm<T, false, false>(X, ldx, p.wkv + C + c0, 2 * C, acc + 64, lda,
                                64, 32, C);
    __syncthreads();
    for (int idx = tid; idx < 64 * 32; idx += blockDim.x) {
      const int t = idx / 32, d = idx % 32;
      q[t * ldq + d] = from_f<T>((acc[t * lda + d] + p.bq[c0 + d]) * p.scale);
      k[t * ldq + d] = from_f<T>(acc[t * lda + 32 + d] + p.bkv[c0 + d]);
      v[t * ldq + d] = from_f<T>(acc[t * lda + 64 + d] + p.bkv[C + c0 + d]);
    }
    __syncthreads();
    block_gemm<T, true, false>(q, ldq, k, ldq, acc, lda, 64, 64, 32);
    __syncthreads();
    const float* bias_h = p.bias + (size_t)h * 4096;
    for (int t = warp; t < 64; t += kWarps) {
      float l0 = acc[t * lda + lane] + bias_h[t * 64 + lane];
      float l1 = acc[t * lda + lane + 32] + bias_h[t * 64 + lane + 32];
      if (p.shift) {
        if (rid[t] != rid[lane]) l0 -= 100.0f;
        if (rid[t] != rid[lane + 32]) l1 -= 100.0f;
      }
      const float m = warp_max(fmaxf(l0, l1));
      const float e0 = expf(l0 - m), e1 = expf(l1 - m);
      const float inv = 1.0f / warp_sum(e0 + e1);
      SP[t * ldsp + lane] = e0 * inv;
      SP[t * ldsp + lane + 32] = e1 * inv;
      PT[t * ldp + lane] = from_f<T>(e0 * inv);
      PT[t * ldp + lane + 32] = from_f<T>(e1 * inv);
    }
    __syncthreads();
    // this head's output, for dWo
    block_gemm<T, false, false>(PT, ldp, v, ldq, acc, lda, 64, 32, 64);
    __syncthreads();
    for (int idx = tid; idx < 64 * 32; idx += blockDim.x) {
      const int t = idx / 32, d = idx % 32;
      p.o_img[(size_t)pix[t] * C + c0 + d] = from_f<T>(acc[t * lda + d]);
    }
    __syncthreads();
    // dP = dO_h v^T; dS = P (dP - rowsum(dP P)), fp32
    block_gemm<T, true, false>(DO + c0, ldd, v, ldq, acc, lda, 64, 64, 32);
    __syncthreads();
    float* dbias = p.dbias_part + ((size_t)w * p.nH + h) * 4096;
    for (int t = warp; t < 64; t += kWarps) {
      const float dp0 = rnd<T>(acc[t * lda + lane]);
      const float dp1 = rnd<T>(acc[t * lda + lane + 32]);
      const float p0 = SP[t * ldsp + lane], p1 = SP[t * ldsp + lane + 32];
      const float r = warp_sum(dp0 * p0 + dp1 * p1);
      const float ds0 = p0 * (dp0 - r), ds1 = p1 * (dp1 - r);
      const T h0 = from_f<T>(ds0), h1 = from_f<T>(ds1);
      DSh[t * ldp + lane] = h0;
      DSh[t * ldp + lane + 32] = h1;
      DSl[t * ldp + lane] = from_f<T>(ds0 - to_f<T>(h0));
      DSl[t * ldp + lane + 32] = from_f<T>(ds1 - to_f<T>(h1));
      dbias[t * 64 + lane] = ds0;
      dbias[t * 64 + lane + 32] = ds1;
    }
    __syncthreads();
    // d(q * scale) = dS k, dk = dS^T (q * scale), dv = P^T dO_h. dS goes
    // in as the sum of its two bf16 halves (hi + lo), so the products keep
    // about 17 bits of the fp32 dS on the tensor cores.
    block_gemm<T, false, false>(DSh, ldp, k, ldq, acc, lda, 64, 32, 64);
    block_gemm<T, false, false, true>(DSh, ldp, q, ldq, acc + 32, lda, 64,
                                      32, 64, 8);
    block_gemm<T, false, false, true>(PT, ldp, DO + c0, ldd, acc + 64, lda,
                                      64, 32, 64);
    block_gemm<T, false, true>(DSl, ldp, k, ldq, acc, lda, 64, 32, 64);
    block_gemm<T, false, true, true>(DSl, ldp, q, ldq, acc + 32, lda, 64, 32,
                                     64, 8);
    __syncthreads();
    for (int idx = tid; idx < 64 * 32; idx += blockDim.x) {
      const int t = idx / 32, d = idx % 32;
      T* row = dqkv + (size_t)t * C3 + c0 + d;
      row[0] = from_f<T>(rnd<T>(acc[t * lda + d]) * p.scale);
      row[C] = from_f<T>(acc[t * lda + 32 + d]);
      row[2 * C] = from_f<T>(acc[t * lda + 64 + d]);
    }
    __syncthreads();
  }

  // dxm = dq Wq^T + [dk | dv] Wkv^T, in 64-column chunks, into X
  for (int n0 = 0; n0 < C; n0 += 64) {
    const int nn = min(64, C - n0);
    block_gemm<T, true, false>(dqkv, C3, p.wq + (size_t)n0 * C, C, acc, lda,
                               64, nn, C);
    block_gemm<T, true, true>(dqkv + C, C3, p.wkv + (size_t)n0 * 2 * C,
                              2 * C, acc, lda, 64, nn, 2 * C);
    __syncthreads();
    for (int idx = tid; idx < 64 * nn; idx += blockDim.x) {
      const int t = idx / nn, j = idx % nn;
      const float d = rnd<T>(acc[t * lda + j]);
      X[t * ldx + n0 + j] = from_f<T>(d);
      if (p.dmod_part)
        p.dmod_part[(size_t)w * 64 * C + t * C + n0 + j] = d;
    }
    __syncthreads();
  }

  // LayerNorm VJP, one warp per token; dx [+ g] back to its pixel
  for (int t = warp; t < 64; t += kWarps) {
    const size_t at = (size_t)pix[t] * C;
    const T* row = X + t * ldx;
    const float mean = stats[2 * t], rstd = stats[2 * t + 1];
    float s1 = 0.f, s2 = 0.f;
    if (p.has_ln) {
      for (int c = lane; c < C; c += 32) {
        const float xh = (to_f<T>(p.x[at + c]) - mean) * rstd;
        const float dxh = to_f<T>(row[c]) * p.ln_s[c];
        s1 += dxh;
        s2 += dxh * xh;
      }
      s1 = warp_sum(s1) / C;
      s2 = warp_sum(s2) / C;
    }
    for (int c = lane; c < C; c += 32) {
      float d = to_f<T>(row[c]);
      if (p.has_ln) {
        const float xh = (to_f<T>(p.x[at + c]) - mean) * rstd;
        d = rstd * (d * p.ln_s[c] - s1 - xh * s2);
      }
      if (p.residual) d = rnd<T>(d) + to_f<T>(p.g[at + c]);
      p.dx[at + c] = from_f<T>(d);
    }
  }
  if (!p.has_ln) return;
  __syncthreads();
  for (int c = tid; c < C; c += blockDim.x) {
    float ss = 0.f, sb = 0.f;
    for (int t = 0; t < 64; ++t) {
      const float dn = to_f<T>(X[t * ldx + c]);
      const float xh =
          (to_f<T>(p.x[(size_t)pix[t] * C + c]) - stats[2 * t]) *
          stats[2 * t + 1];
      ss = fmaf(dn, xh, ss);
      sb += dn;
    }
    p.dln_part[(size_t)w * 2 * C + c] = ss;
    p.dln_part[(size_t)w * 2 * C + C + c] = sb;
  }
}

}  // namespace uf
