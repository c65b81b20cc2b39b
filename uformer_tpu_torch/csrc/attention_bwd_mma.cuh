// Backward of the LeWin attention sub-block in bf16 on the tensor-core
// building block (mma_tile.cuh): the function, roundings and outputs of
// attention_window_bwd.cuh, with every product in mma.sync register
// accumulators and the weights brought into shared memory by cp.async
// rings. C = nH D in 8..1024 (powers of 2), D 8, 16, 32 or 64, at most
// 16 heads. Head dim 8 takes QK^T and dO v^T (depth D) on
// mma.sync.m16n8k8, as C = 8 takes its projections and dxm (depth C),
// through warp_mma_k; every other product keeps its depth of 16 or more.
// Head dim 64 at C 512 and 1024 (an --embed_dim 64 model's deepest
// stages: kBig) misses shared memory with both 64 x C token tiles beside
// the per-head buffers, so there g stays in device memory and comes in
// through the ring with the tile of Wo it meets (64 x KQ beside D x KQ),
// and the fp32 dxm goes out to part_dxm in column halves of 512 (64 x
// 1024 fp32 would need 128 accumulators a thread): every window then ends
// in attention_bwd_finish, which reads it back from there (L2).
//
// A block takes a work item of WN consecutive windows (the host picks WN
// from the windows and the SMs: 1-4 at C <= 128, 1 above), one after
// another. Per window:
//   (1) x and g gathered through the token map; xm = LN1(x) + mod (kept,
//       and written out for dWq, dWkv), g kept;
//   (2) per head, with its weight tiles streamed through a three-slot ring
//       (q, k and v columns of W as KQ x D tiles along K = C, then the
//       head's D rows of Wo as D x KQ tiles): q, k, v = xm W (+ bias, q
//       times the scale) and dO_h = g Wo[hD:hD+D, :]^T, each in
//       registers, rounded into shared memory (so the 64 x C dO of one
//       window is never formed); the core: warp w takes rows 16 (w / 4)
//       and keys 16 (w % 4) of S = q k^T, softmax and dP = dO v^T in
//       registers (row max and sums through shared memory across the four
//       warps of a row block), dS = P (dP - rowsum(dP P)) in fp32; P and
//       dS (as bf16 hi + lo) into shared memory; then O = P v, dq = dS k,
//       dk = dS^T q, dv = P^T dO, each m16 x n8 tile of them one warp's
//       register accumulator, written to o_img and [dq | dk | dv];
//   (3) dxm = [dq | dk | dv] W^T over K = 3C, both operands streamed (the
//       window's rows of dqkv_w and C x KX columns of W) through a ring
//       over the freed buffers, the 64 x C fp32 accumulator in registers;
//       rounded into shared memory for the LN VJP; dx [+ g].
// dbias, dmod and dln_s / dln_b are summed over the item's windows in the
// item's own partial rows (the first window writes, the next add, in
// window order), so the colsum after it reads WN times fewer rows.
// With kPad a token map may mark a padding row of a packed tile (pix -1):
// it reads x = g = 0 and is never written (attention_window_bwd.cuh says
// why it adds nothing to any gradient); without, the 8x8 window's code
// carries no guard.
#pragma once

#include "attention_window_bwd.cuh"
#include "mma_tile.cuh"
#include "window_core_mma.cuh"

namespace uf {

// Whether attention_bwd_item has a tile for (C, D): C a power of 2 from D
// with at most 16 heads
__host__ __device__ constexpr bool attn_bwd_mma_fits(int C, int D) {
  return (D == 8 || D == 16 || D == 32 || D == 64) && C >= D &&
         C <= 16 * D && (C & (C - 1)) == 0;
}

// Whether the (C, D) tile streams g with Wo and ends every window through
// part_dxm (the header's kBig)
__host__ __device__ constexpr bool attn_bwd_big(int C, int D) {
  return D == 64 && C >= 512;
}

template <int C, int D>
struct AttnBwdMma {
  static_assert(attn_bwd_mma_fits(C, D), "no attention backward tile");
  static constexpr bool kBig = attn_bwd_big(C, D);
  static constexpr int nH = C / D, NPN = D / 8;  // n8 tiles of a head
  // K of a weight tile (kBig: beside a 64 x KQ tile of g in each slot)
  static constexpr int KQ = kBig ? 32768 / C : C < 128 ? C : 128;
  static constexpr int NQ = C / KQ, TPH = 4 * NQ;
  // a head's projection: warp w < 4 NG takes m16 tile w / NG and PNW n8
  // tiles from 8 PNW (w % NG) (D 64: two n8 tiles a warp)
  static constexpr int PNW = 4 * NPN > kWarps ? 4 * NPN / kWarps : 1;
  static constexpr int NG = NPN / PNW;
  // K of a dxm tile: a divisor of 3C (8 at C = 8: an m16n8k8 product)
  static constexpr int KX = C >= 512 ? 16 : C >= 128 ? 32 : C;
  // columns of one dxm pass: all of C, or halves of 512 at C = 1024
  static constexpr int CN = C < 512 ? C : 512;
  static constexpr int ldx = C + 8, ldq = D + 8, ldp = 72, lda = C + 4;
  static constexpr int ldwq = D + 8, ldwo = KQ + 8, ldxa = KX + 8;
  static constexpr int ldg = KQ + 8;  // kBig: a slot's tile of g
  // dxm: warp w takes MT2 m16 tiles from 16 MT2 (w / NW2) x NT2 n8 tiles
  // from 8 NT2 (w % NW2) of a pass; at C = 16 half the warps, at C = 8 a
  // quarter
  static constexpr int PP = CN / 32;
  static constexpr int NT2 = PP < 1 ? 1 : PP > 4 ? 4 : PP;
  static constexpr int MT2 = PP / NT2 < 1 ? 1 : PP / NT2;
  static constexpr int NW2 = CN / (8 * NT2), JOBS2 = NW2 * (4 / MT2);
  static constexpr int kStages = 3;
  static constexpr size_t kSlotW =
      align128(2 * (KQ * ldwq > D * ldwo ? KQ * ldwq : D * ldwo));
  static constexpr size_t kSlot =
      kSlotW + (kBig ? align128(2 * 64 * ldg) : 0);
  static constexpr size_t kSlotX = align128(2 * (64 + CN) * ldxa);
  static constexpr size_t pix = 0;
  static constexpr size_t rid = pix + align128(4 * 64);
  static constexpr size_t stats = rid + align128(4 * 64);
  static constexpr size_t red = stats + align128(4 * 128);  // 3 x 64 x 4
  static constexpr size_t x = red + align128(4 * 3 * 256);
  static constexpr size_t g = x + align128(2 * 64 * ldx);  // none if kBig
  static constexpr size_t kQ = align128(2 * 64 * ldq);
  static constexpr size_t q =                                // q, k, v, dO
      g + (kBig ? 0 : align128(2 * 64 * ldx));
  static constexpr size_t kP = align128(2 * 64 * ldp);
  static constexpr size_t pt = q + 4 * kQ;                  // P, dS hi, lo
  static constexpr size_t ring = pt + 3 * kP;
  static constexpr size_t total = ring + kStages * kSlot;
  // the dxm phase: its ring over x .., its fp32 result over g .. (kBig:
  // in part_dxm)
  static_assert(x + kStages * kSlotX <= total, "dxm ring fits");
  static_assert(kBig || g + 4 * 64 * lda <= total, "fp32 dxm fits");
  static_assert(total <= kSmemLimit, "attention backward exceeds smem");
  static_assert(JOBS2 <= kWarps && 4 * NG <= kWarps, "a job a warp");
  static_assert(3 * C % KX == 0 && 3 * C / KX >= kStages - 1, "dxm tiles");
};

// The end of a window's backward from its fp32 dxm (rows of ldm floats,
// in shared memory or, kBig, in part_dxm): the item's dmod share (the first window writes,
// the next add), the dln_s / dln_b shares from the fp32 dxm, as the TPU
// kernel sums its fp32 product (attention_block.py:746-750), and the
// LayerNorm VJP, one warp per token, on the fp32 dxm too (the TPU kernel's
// dtok, :751-755; a VJP of the bf16-rounded dxm carried that rounding,
// amplified by 1/std, into dx), dx [+ g] back to its pixel; without LN
// dx is the rounded dxm. All
// threads call it; the caller synchronises before and after. kPad: skip
// padding rows (pix -1).
template <int C, int D, bool kPad>
__device__ void attention_bwd_epilogue(const AttnBwdParams<bf16>& p,
                                       int item, bool first,
                                       unsigned char* smem,
                                       const float* dxm, int lda) {
  using L = AttnBwdMma<C, D>;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int* pix = reinterpret_cast<const int*>(smem + L::pix);
  const float* stats = reinterpret_cast<const float*>(smem + L::stats);
  if (p.dmod_part) {
    float* dmod = p.dmod_part + (size_t)item * 64 * C;
    for (int i = tid; i < 64 * C; i += kThreads) {
      const float v = dxm[(i / C) * lda + i % C];
      dmod[i] = first ? v : dmod[i] + v;
    }
  }
  if (p.dln_part) {
    float* dln = p.dln_part + (size_t)item * 2 * C;
    for (int c = tid; c < C; c += kThreads) {
      float ss = 0.f, sb = 0.f;
      for (int t = 0; t < 64; ++t) {
        if constexpr (kPad)
          if (pix[t] < 0) continue;
        const float dn = dxm[t * lda + c];
        const float xh = (to_f<bf16>(p.x[(size_t)pix[t] * C + c]) -
                          stats[2 * t]) * stats[2 * t + 1];
        ss = fmaf(dn, xh, ss);
        sb += dn;
      }
      dln[c] = first ? ss : dln[c] + ss;
      dln[C + c] = first ? sb : dln[C + c] + sb;
    }
  }
  for (int t = warp; t < 64; t += kWarps) {
    if constexpr (kPad)
      if (pix[t] < 0) continue;
    const size_t at = (size_t)pix[t] * C;
    const float* row = dxm + t * lda;
    const float mean = stats[2 * t], rstd = stats[2 * t + 1];
    float s1 = 0.f, s2 = 0.f;
    if (p.has_ln) {
      for (int c = lane; c < C; c += 32) {
        const float xh = (to_f<bf16>(p.x[at + c]) - mean) * rstd;
        const float dxh = dxm[t * lda + c] * p.ln_s[c];
        s1 += dxh;
        s2 += dxh * xh;
      }
      s1 = warp_sum(s1) / C;
      s2 = warp_sum(s2) / C;
    }
    for (int c = lane; c < C; c += 32) {
      float d = rnd<bf16>(row[c]);
      if (p.has_ln) {
        const float xh = (to_f<bf16>(p.x[at + c]) - mean) * rstd;
        d = rstd * (row[c] * p.ln_s[c] - s1 - xh * s2);
      }
      if (p.residual) d = rnd<bf16>(d) + to_f<bf16>(p.g[at + c]);
      p.dx[at + c] = from_f<bf16>(d);
    }
  }
}

// Windows w0 .. w0 + nw - 1 (nw <= the item's WN) of the item `item`,
// heads h0 .. h0 + hn - 1 of them; token_map(w, t, &pix, &rid) gives each
// token's row and region id. With hn < nH (a window's heads split over
// blockIdx.y, nw 1), and always for kBig, the block writes its share of
// the window's fp32 dxm to part_dxm, and attention_bwd_finish ends the
// window. kPad: the map may mark padding rows (pix -1).
template <int C, int D, bool kPad = false, typename TokenMap>
__device__ void attention_bwd_item(const AttnBwdParams<bf16>& p, int item,
                                   int w0, int nw, int h0, int hn,
                                   unsigned char* smem, TokenMap token_map) {
  using L = AttnBwdMma<C, D>;
  constexpr bool kBig = L::kBig;
  constexpr int S = L::kStages, nH = L::nH, NPN = L::NPN, KQ = L::KQ,
                NQ = L::NQ, TPH = L::TPH, KX = L::KX, PNW = L::PNW,
                NG = L::NG, CN = L::CN;
  constexpr int ldx = L::ldx, ldq = L::ldq, ldp = L::ldp, ldg = L::ldg;
  constexpr int C3 = 3 * C;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t4 = lane & 3;
  int* pix = reinterpret_cast<int*>(smem + L::pix);
  int* rid = reinterpret_cast<int*>(smem + L::rid);
  float* stats = reinterpret_cast<float*>(smem + L::stats);
  float* red = reinterpret_cast<float*>(smem + L::red);
  bf16* X = reinterpret_cast<bf16*>(smem + L::x);
  bf16* G = reinterpret_cast<bf16*>(smem + L::g);
  bf16* qs = reinterpret_cast<bf16*>(smem + L::q);
  bf16* ks = reinterpret_cast<bf16*>(smem + L::q + L::kQ);
  bf16* vs = reinterpret_cast<bf16*>(smem + L::q + 2 * L::kQ);
  bf16* dos = reinterpret_cast<bf16*>(smem + L::q + 3 * L::kQ);
  bf16* PT = reinterpret_cast<bf16*>(smem + L::pt);
  bf16* DSh = reinterpret_cast<bf16*>(smem + L::pt + L::kP);
  bf16* DSl = reinterpret_cast<bf16*>(smem + L::pt + 2 * L::kP);
  unsigned char* ring = smem + L::ring;
  unsigned char* ringx = smem + L::x;
  float* dxm = reinterpret_cast<float*>(smem + L::g);
  float* dbias = p.dbias_part + (size_t)item * nH * 4096;
  const int rb = warp >> 2, cq = warp & 3;  // the core's rows and keys

  for (int wi = 0; wi < nw; ++wi) {
    const int w = w0 + wi;
    const bool first = wi == 0;
    // per head tile q: head h0 + q / TPH; s < 3 NQ: rows [KQ (s % NQ),
    // +KQ) x the head's D columns of wq, wk or wv (s / NQ); else the head's D
    // rows of wo x columns [KQ (s - 3 NQ), +KQ) (kBig: with g's 64 rows x
    // the same columns after it, which needs pix: not among the first
    // S - 1 tiles, issued before the token map)
    auto load_tile = [&](int qi) {
      bf16* dst = reinterpret_cast<bf16*>(ring + (qi % S) * L::kSlot);
      const int h = h0 + qi / TPH, s = qi % TPH;
      if (s < 3 * NQ) {
        const int pass = s / NQ, r0 = (s % NQ) * KQ;
        const bf16* src = pass == 0 ? p.wq + h * D
                                    : p.wkv + (pass - 1) * C + h * D;
        const int ld = pass == 0 ? C : 2 * C;
        constexpr int vpr = D / 8;
        for (int i = tid; i < KQ * vpr; i += kThreads) {
          const int r = i / vpr, v = i % vpr;
          cp_async16(dst + r * L::ldwq + v * 8,
                     src + (size_t)(r0 + r) * ld + v * 8);
        }
      } else {
        const int c0 = (s - 3 * NQ) * KQ;
        constexpr int vpr = KQ / 8;
        for (int i = tid; i < D * vpr; i += kThreads) {
          const int r = i / vpr, v = i % vpr;
          cp_async16(dst + r * L::ldwo + v * 8,
                     p.wo + (size_t)(h * D + r) * C + c0 + v * 8);
        }
        if constexpr (kBig) {
          bf16* gt = reinterpret_cast<bf16*>(
              reinterpret_cast<unsigned char*>(dst) + L::kSlotW);
          for (int i = tid; i < 64 * vpr; i += kThreads) {
            const int t = i / vpr, v = i % vpr;
            const bool ok = !kPad || pix[t] >= 0;
            cp_async16(gt + t * ldg + v * 8,
                       ok ? p.g + (size_t)pix[t] * C + c0 + v * 8 : p.g, ok);
          }
        }
      }
    };
    const int T = hn * TPH;
    static_assert(3 * NQ >= S - 1, "the first tiles read no g");
    for (int qi = 0; qi < S - 1; ++qi) {
      if (qi < T) load_tile(qi);
      cp_async_commit();
    }

    // (1) tokens, xm = LN1(x) + mod into X, g into G (kBig: g stays out)
    if (tid < 64) token_map(w, tid, pix + tid, rid + tid);
    __syncthreads();
    constexpr int vpr = C / 8;
    for (int idx = tid; idx < 64 * vpr; idx += kThreads) {
      const int t = idx / vpr, v = idx % vpr;
      uint4 xv = make_uint4(0u, 0u, 0u, 0u), gv = xv;
      if (!kPad || pix[t] >= 0) {
        const size_t at = (size_t)pix[t] * C + v * 8;
        xv = *reinterpret_cast<const uint4*>(p.x + at);
        if constexpr (!kBig) gv = *reinterpret_cast<const uint4*>(p.g + at);
      }
      *reinterpret_cast<uint4*>(X + t * ldx + v * 8) = xv;
      if constexpr (!kBig) *reinterpret_cast<uint4*>(G + t * ldx + v * 8) = gv;
    }
    __syncthreads();
    for (int t = warp; t < 64; t += kWarps)
      ln_row<bf16>(X + t * ldx, C, p.ln_s, p.ln_b, p.has_ln,
                   p.mod ? p.mod + t * C : nullptr, stats + 2 * t);
    __syncthreads();
    for (int idx = tid; h0 == 0 && idx < 64 * vpr; idx += kThreads) {
      const int t = idx / vpr, v = idx % vpr;
      *reinterpret_cast<uint4*>(p.xm_w + ((size_t)w * 64 + t) * C + v * 8) =
          *reinterpret_cast<const uint4*>(X + t * ldx + v * 8);
    }
    bf16* dqkv = p.dqkv_w + (size_t)w * 64 * C3;

    // (2) per head
    float acc[1][PNW][4];
    const bool pjob = warp < 4 * NG;
    const int pm = warp / NG, pn = (warp % NG) * 8 * PNW;
    for (int qi = 0; qi < T; ++qi) {
      cp_async_wait<S - 2>();
      __syncthreads();
      if (qi + S - 1 < T) load_tile(qi + S - 1);
      cp_async_commit();
      const bf16* wt =
          reinterpret_cast<const bf16*>(ring + (qi % S) * L::kSlot);
      const int h = h0 + qi / TPH, s = qi % TPH, pass = s / NQ,
                kt = s % NQ;
      const int c0 = h * D;
      if (pjob) {
        if (kt == 0) zero_acc(acc);
        if (pass < 3) {
          warp_mma_k<1, PNW, KQ>(acc, X + pm * 16 * ldx + kt * KQ, ldx,
                                 wt + pn, L::ldwq);
        } else if constexpr (kBig) {
          const bf16* gt = reinterpret_cast<const bf16*>(
              reinterpret_cast<const unsigned char*>(wt) + L::kSlotW);
          warp_mma_k<1, PNW, KQ, true>(acc, gt + pm * 16 * ldg, ldg,
                                       wt + pn * L::ldwo, L::ldwo);
        } else {
          warp_mma_k<1, PNW, KQ, true>(acc, G + pm * 16 * ldx + kt * KQ,
                                       ldx, wt + pn * L::ldwo, L::ldwo);
        }
        if (kt == NQ - 1) {
          // + bias (q times the scale), bf16; dO_h rounded as it is
          const float* bias =
              pass == 0 ? p.bq + c0 : p.bkv + (pass - 1) * C + c0;
          const float sc = pass == 0 ? p.scale : 1.0f;
          bf16* dst = pass == 0 ? qs : pass == 1 ? ks : pass == 2 ? vs : dos;
#pragma unroll
          for (int n = 0; n < PNW; ++n) {
            const int col = pn + n * 8 + 2 * t4;
            const float b0 = pass < 3 ? bias[col] : 0.f;
            const float b1 = pass < 3 ? bias[col + 1] : 0.f;
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int row = pm * 16 + gq + 8 * hh;
              *reinterpret_cast<uint32_t*>(dst + row * ldq + col) =
                  pack_bf16((acc[0][n][2 * hh] + b0) * sc,
                            (acc[0][n][2 * hh + 1] + b1) * sc);
            }
          }
        }
      }
      if (s < TPH - 1) continue;
      __syncthreads();

      // the core of head h
      float sa[1][2][4], pa[1][2][4];
      zero_acc(sa);
      warp_mma_k<1, 2, D, true>(sa, qs + rb * 16 * ldq, ldq,
                                ks + cq * 16 * ldq, ldq);
      const float* bias_h = p.bias + (size_t)h * 4096;
      float mx[2] = {-3.0e38f, -3.0e38f};
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = rb * 16 + gq + 8 * (e >> 1);
          const int u = cq * 16 + n * 8 + 2 * t4 + (e & 1);
          float l = sa[0][n][e] + bias_h[t * 64 + u];
          if (p.shift && rid[t] != rid[u]) l -= 100.0f;
          sa[0][n][e] = l;
          mx[e >> 1] = fmaxf(mx[e >> 1], l);
        }
      // a row's partials: the quad, then the four warps of its row block
      auto row_reduce = [&](float (&v)[2], float* slot, bool is_max) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
          for (int o = 1; o < 4; o <<= 1) {
            const float other = __shfl_xor_sync(0xffffffffu, v[hh], o);
            v[hh] = is_max ? fmaxf(v[hh], other) : v[hh] + other;
          }
          if (t4 == 0) slot[(rb * 16 + gq + 8 * hh) * 4 + cq] = v[hh];
        }
        __syncthreads();
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float* r4 = slot + (rb * 16 + gq + 8 * hh) * 4;
          v[hh] = is_max ? fmaxf(fmaxf(r4[0], r4[1]), fmaxf(r4[2], r4[3]))
                         : ((r4[0] + r4[1]) + r4[2]) + r4[3];
        }
      };
      row_reduce(mx, red, true);
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sa[0][n][e] = expf(sa[0][n][e] - mx[e >> 1]);
          sum[e >> 1] += sa[0][n][e];
        }
      row_reduce(sum, red + 256, false);
      const float inv[2] = {1.0f / sum[0], 1.0f / sum[1]};
      zero_acc(pa);
      warp_mma_k<1, 2, D, true>(pa, dos + rb * 16 * ldq, ldq,
                                vs + cq * 16 * ldq, ldq);
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sa[0][n][e] *= inv[e >> 1];                   // P, fp32
          pa[0][n][e] = rnd<bf16>(pa[0][n][e]);          // dP as bf16
          rs[e >> 1] += pa[0][n][e] * sa[0][n][e];
        }
      row_reduce(rs, red + 512, false);
      float* dbias_h = dbias + (size_t)h * 4096;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int t = rb * 16 + gq + 8 * hh;
          const int u = cq * 16 + n * 8 + 2 * t4;
          const float p0 = sa[0][n][2 * hh], p1 = sa[0][n][2 * hh + 1];
          const float ds0 = p0 * (pa[0][n][2 * hh] - rs[hh]);
          const float ds1 = p1 * (pa[0][n][2 * hh + 1] - rs[hh]);
          const __nv_bfloat162 hi = __floats2bfloat162_rn(ds0, ds1);
          *reinterpret_cast<uint32_t*>(PT + t * ldp + u) = pack_bf16(p0, p1);
          *reinterpret_cast<__nv_bfloat162*>(DSh + t * ldp + u) = hi;
          *reinterpret_cast<uint32_t*>(DSl + t * ldp + u) =
              pack_bf16(ds0 - __low2float(hi), ds1 - __high2float(hi));
          float2* db = reinterpret_cast<float2*>(dbias_h + t * 64 + u);
          if (first) {
            *db = make_float2(ds0, ds1);
          } else {
            const float2 o = *db;
            *db = make_float2(o.x + ds0, o.y + ds1);
          }
        }
      __syncthreads();
      // O = P v, d(q scale) = dS k, dk = dS^T (q scale), dv = P^T dO: dS
      // as its two bf16 halves (hi + lo), about 17 bits of the fp32 dS
      constexpr int kJobs = 4 * 4 * NPN;
      for (int job = warp; job < kJobs; job += kWarps) {
        const int prod = job / (4 * NPN), m = (job / NPN) % 4;
        const int n = (job % NPN) * 8;
        float o[1][1][4];
        zero_acc(o);
        if (prod == 0) {
          warp_mma<1, 1, 4>(o, PT + m * 16 * ldp, ldp, vs + n, ldq);
        } else if (prod == 1) {
          warp_mma<1, 1, 4>(o, DSh + m * 16 * ldp, ldp, ks + n, ldq);
          warp_mma<1, 1, 4>(o, DSl + m * 16 * ldp, ldp, ks + n, ldq);
        } else if (prod == 2) {
          warp_mma<1, 1, 4, true>(o, DSh + m * 16, ldp, qs + n, ldq);
          warp_mma<1, 1, 4, true>(o, DSl + m * 16, ldp, qs + n, ldq);
        } else {
          warp_mma<1, 1, 4, true>(o, PT + m * 16, ldp, dos + n, ldq);
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int t = m * 16 + gq + 8 * hh, col = c0 + n + 2 * t4;
          float v0 = o[0][0][2 * hh], v1 = o[0][0][2 * hh + 1];
          bf16* dst;
          if (prod == 0) {
            if constexpr (kPad)
              if (pix[t] < 0) continue;
            dst = p.o_img + (size_t)pix[t] * C + col;
          } else {
            if (prod == 1) {
              v0 = rnd<bf16>(v0) * p.scale;
              v1 = rnd<bf16>(v1) * p.scale;
            }
            dst = dqkv + (size_t)t * C3 + (prod - 1) * C + col;
          }
          *reinterpret_cast<uint32_t*>(dst) = pack_bf16(v0, v1);
        }
      }
      // (the next head's barriers order P, dS, q, k, v, dO before reuse)
    }
    cp_async_wait<0>();
    __syncthreads();  // every head done; [dq | dk | dv] of the window out

    // (3) dxm = [dq | dk | dv] W^T over the heads' columns of each (K =
    // 3 hn D, all of 3C unsplit) in tiles of KX: the window's rows of
    // dqkv_w and the CN x KX columns of wq or wkv (N x K), one pass per CN
    // output columns
    const int tps = hn * D / KX;  // tiles of each of dq, dk, dv
    const int TX = 3 * tps;
    const bool split = kBig || hn < nH;
    float* part =
        p.part_dxm + ((size_t)blockIdx.y * gridDim.x + item) * 64 * C;
    const bool xjob = warp < L::JOBS2;
    const int m2 = (warp / L::NW2) * 16 * L::MT2,
              n2 = (warp % L::NW2) * 8 * L::NT2;
    for (int nc = 0; nc < C; nc += CN) {
      auto load_x = [&](int qi) {
        bf16* xa = reinterpret_cast<bf16*>(ringx + (qi % S) * L::kSlotX);
        bf16* xb = xa + 64 * L::ldxa;
        const int k0 = (qi / tps) * C + h0 * D + (qi % tps) * KX;
        constexpr int vk = KX / 8;
        for (int i = tid; i < 64 * vk; i += kThreads) {
          const int r = i / vk, v = i % vk;
          cp_async16(xa + r * L::ldxa + v * 8,
                     dqkv + (size_t)r * C3 + k0 + v * 8);
        }
        const bf16* wsrc = k0 < C ? p.wq + k0 : p.wkv + (k0 - C);
        const int ld = k0 < C ? C : 2 * C;
        for (int i = tid; i < CN * vk; i += kThreads) {
          const int r = i / vk, v = i % vk;
          cp_async16(xb + r * L::ldxa + v * 8,
                     wsrc + (size_t)(nc + r) * ld + v * 8);
        }
      };
      for (int qi = 0; qi < S - 1; ++qi) {
        if (qi < TX) load_x(qi);
        cp_async_commit();
      }
      float accx[L::MT2][L::NT2][4];
      zero_acc(accx);
      for (int qi = 0; qi < TX; ++qi) {
        cp_async_wait<S - 2>();
        __syncthreads();
        if (qi + S - 1 < TX) load_x(qi + S - 1);
        cp_async_commit();
        const bf16* xa =
            reinterpret_cast<const bf16*>(ringx + (qi % S) * L::kSlotX);
        const bf16* xb = xa + 64 * L::ldxa;
        if (xjob)
          warp_mma_k<L::MT2, L::NT2, KX, true>(accx, xa + m2 * L::ldxa,
                                               L::ldxa, xb + n2 * L::ldxa,
                                               L::ldxa);
      }
      cp_async_wait<0>();
      __syncthreads();  // the ring is free: G .. takes the fp32 dxm
      if (xjob)
#pragma unroll
        for (int mi = 0; mi < L::MT2; ++mi)
#pragma unroll
          for (int n = 0; n < L::NT2; ++n)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int t = m2 + mi * 16 + gq + 8 * hh;
              const int col = nc + n2 + n * 8 + 2 * t4;
              const float2 v =
                  make_float2(accx[mi][n][2 * hh], accx[mi][n][2 * hh + 1]);
              if (split)
                *reinterpret_cast<float2*>(part + t * C + col) = v;
              else
                *reinterpret_cast<float2*>(dxm + t * L::lda + col) = v;
            }
    }
    __syncthreads();
    if (!split)
      attention_bwd_epilogue<C, D, kPad>(p, item, first, smem, dxm, L::lda);
    __syncthreads();  // the next window reuses every buffer
  }
}

// After a split (and for every kBig window): window w's dxm = its head
// groups' fp32 shares summed in group order, its LN statistics recomputed
// from x (ln_row's), then the epilogue. One block per window (its item).
// The sum goes into shared memory, or, kBig, into group 0's share in place
// (each value read and written by one thread), which the epilogue then
// reads. kPad as attention_bwd_item's.
template <int C, int D, bool kPad = false, typename TokenMap>
__device__ void attention_bwd_finish(const AttnBwdParams<bf16>& p, int w,
                                     int n_win, int groups,
                                     unsigned char* smem,
                                     TokenMap token_map) {
  using L = AttnBwdMma<C, D>;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int* pix = reinterpret_cast<int*>(smem + L::pix);
  int* rid = reinterpret_cast<int*>(smem + L::rid);
  float* stats = reinterpret_cast<float*>(smem + L::stats);
  float* dxm = L::kBig ? p.part_dxm + (size_t)w * 64 * C
                       : reinterpret_cast<float*>(smem + L::g);
  const int lda = L::kBig ? C : L::lda;
  if (tid < 64) token_map(w, tid, pix + tid, rid + tid);
  for (int i = tid; (!L::kBig || groups > 1) && i < 64 * C; i += kThreads) {
    float s = 0.f;
    for (int gi = 0; gi < groups; ++gi)
      s += p.part_dxm[((size_t)gi * n_win + w) * 64 * C + i];
    dxm[(i / C) * lda + i % C] = s;
  }
  __syncthreads();
  if (p.has_ln)
    for (int t = warp; t < 64; t += kWarps) {
      if constexpr (kPad)
        if (pix[t] < 0) continue;
      const bf16* row = p.x + (size_t)pix[t] * C;
      float s = 0.f;
      for (int c = lane; c < C; c += 32) s += to_f<bf16>(row[c]);
      const float mean = warp_sum(s) / C;
      float v = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float d = to_f<bf16>(row[c]) - mean;
        v += d * d;
      }
      const float rstd = 1.0f / sqrtf(warp_sum(v) / C + 1e-5f);
      if (lane == 0) {
        stats[2 * t] = mean;
        stats[2 * t + 1] = rstd;
      }
    }
  __syncthreads();
  attention_bwd_epilogue<C, D, kPad>(p, w, true, smem, dxm, lda);
}

// Launches kernel(p, wn, n_win, hpb, 0), one block of kThreads threads
// per work item of wn windows and group of hpb heads, with the (C, D)
// tile's shared memory; with the heads split (hpb < nH, wn 1) or kBig (wn
// 1), then kernel(..., 1), the finish, one block per window. Returns a
// cudaError_t.
template <int C, int D, typename K>
int launch_attn_bwd_mma(K kernel, const AttnBwdParams<bf16>& p, int wn,
                        int n_win, int hpb, cudaStream_t stream) {
  using L = AttnBwdMma<C, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::total);
  if (e != cudaSuccess) return (int)e;
  hpb = hpb < 1 || hpb > p.nH || p.nH % hpb ? p.nH : hpb;
  const int groups = p.nH / hpb;
  const bool finish = groups > 1 || L::kBig;
  wn = wn < 1 || finish ? 1 : wn;
  const dim3 grid((n_win + wn - 1) / wn, groups);
  kernel<<<grid, kThreads, L::total, stream>>>(p, wn, n_win, hpb, 0);
  if (finish) {
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    kernel<<<n_win, kThreads, L::total, stream>>>(p, wn, n_win, hpb, 1);
  }
  return (int)cudaGetLastError();
}

// Calls f(std::integral_constant<int, C>{}, std::integral_constant<int,
// D>{}) for a (C, D = C / nH) with a tile and returns its result, else
// cudaErrorInvalidValue. Head dim 8 from C = kMinC8 (the image layout's
// blocks take it from C = 32 only).
template <int kMinC8 = 8, typename F>
int with_bwd_tile(int C, int nH, F f) {
  return with_head_dim(C, nH, [&](auto d) {
    constexpr int D = decltype(d)::value;
    int r = (int)cudaErrorInvalidValue;
    auto width = [&](auto c) {
      constexpr int Cc = decltype(c)::value;
      if constexpr (attn_bwd_mma_fits(Cc, D) && (D != 8 || Cc >= kMinC8))
        if (C == Cc) r = f(c, d);
    };
    width(std::integral_constant<int, 8>{});
    width(std::integral_constant<int, 16>{});
    width(std::integral_constant<int, 32>{});
    width(std::integral_constant<int, 64>{});
    width(std::integral_constant<int, 128>{});
    width(std::integral_constant<int, 256>{});
    width(std::integral_constant<int, 512>{});
    width(std::integral_constant<int, 1024>{});
    return r;
  });
}

// Kernel 6 on the p.n_win windows of N = p.win^2 < 64 tokens of (Bw N, C)
// rows, in `tiles` packed tiles of 64 rows (attention_block_bwd_packed.cu);
// bf16 with wn tiles or hpb heads per block as launch_attn_bwd_mma takes
// them, fp32 a tile per block. 0 or a cudaError_t.
int attention_block_bwd_packed(const AttnBwdParams<bf16>& p, int tiles,
                               int wn, int hpb, cudaStream_t stream);
int attention_block_bwd_packed(const AttnBwdParams<float>& p, int tiles,
                               cudaStream_t stream);

}  // namespace uf
