// The LeWin attention sub-block in bf16 on the tensor-core building block
// (mma_tile.cuh), for the stage kernel at C 128, 256 and 512, head dim 8
// (C 128), 16, 32 or 64:
//
//   y = [x +] tokens^-1(proj(W-MSA(LN1(tokens(x)) + mod)))
//
// One work item is WN windows (M = 64 WN tokens, WN C <= 512), so that
// each weight tile copied into shared memory serves WN windows; the host
// picks WN from the number of windows and SMs. Per head h:
//   q, k, v (M x D each) = xm . W[:, hD:hD+D], three passes with register
//     accumulators, + bias (q times the scale), bf16 into shared memory;
//   the window core (window_core.cuh) per window, rounded to bf16 into
//     O_h (M x D);
//   acc += O_h . wo[hD:hD+D, :]: the output projection's M x C fp32
//     accumulator (M C / 512 registers a thread) stays in registers over
//     all heads.
// The weights stream as one sequence of tiles (KQ x D of wq, wk, wv, then
// D x C of wo, per head; at head dim 64 the wo rows in two tiles of 32, so
// that a slot stays 33 KB at C 512) through a ring of cp.async slots, the
// next tiles in flight while the current one is multiplied. At head dim
// 64 a work item holds at most 2 windows (attn_wide_wn_fits): the q, k,
// v and O tiles of 64 WN rows grow with D. The token map is
// attention_window's (shift, partition, reverse and unshift cost nothing);
// the roundings are its: LN output, + mod, q (after the scale), k, v, P,
// O, then rnd(acc + bo) [+ x]. Only the order of the fp32 sums differs.
// The stage kernel runs it with residual on; kernel 1 (attention_image.cu)
// runs it at C 128-512 as its own persistent kernel, residual either way.
#pragma once

#include "attention_window.cuh"
#include "mma_tile.cuh"

namespace uf {

// Whether attn_wide_item has a layout for (C, D): head dim 16, 32 or 64
// (an --embed_dim 64 model's stages), and 8 at C = 128 (the stage of an
// embed-8 model's bottleneck and dec0), whose 16-wide products (the
// window core's, O wo) take columns 8..15 of q, k, v and O zero and rows
// 8..15 of the wo tile zero: exact.
__host__ __device__ constexpr bool attn_wide_fits(int C, int D) {
  return ((C == 128 || C == 256 || C == 512) &&
          (D == 16 || D == 32 || D == 64)) ||
         (C == 128 && D == 8);
}

// Whether a work item of WN windows fits at (C, D): WN C at most 512,
// and at head dim 64 at most 2 windows, whose q, k, v and O tiles of
// 64 WN rows of D grow with D (ops/kernels/attention_image.py:
// wide_windows).
__host__ __device__ constexpr bool attn_wide_wn_fits(int C, int D, int WN) {
  return attn_wide_fits(C, D) && WN * C <= 512 && 512 % (WN * C) == 0 &&
         (D < 64 || WN <= 2);
}

template <int C, int D, int WN>
struct AttnWide {
  static_assert(attn_wide_wn_fits(C, D, WN), "no wide attention layout");
  static constexpr int M = 64 * WN;
  static constexpr int DP = D < 16 ? 16 : D;  // the head's padded width
  static constexpr int DO = D > 32 ? 32 : DP;  // rows of a wo tile
  static constexpr int NO = DP / DO;           // wo tiles per head
  static constexpr int KQ = C < 8192 / D ? C : 8192 / D;  // rows of a tile
  static constexpr int NQ = C / KQ;         // tiles of one of q, k, v
  static constexpr int TPH = 3 * NQ + NO;   // tiles per head
  static constexpr int ldx = C + 8, ldq = D + 8, ldp = 72, lda = 68;
  static constexpr int ldwq = D + 8, ldwo = C + 8;
  // q/k/v pass: warp w < NPW takes m16 tile w / NG and NT n8 tiles of the
  // head, in groups of NTG when one tile holds all of K
  static constexpr int NT = M * D >= 2048 ? M * D / 2048 : 1;
  static constexpr int NG = D / 8 / NT, NPW = M / 16 * NG;
  static constexpr int NTG = NQ == 1 && NT > 2 ? 2 : NT;
  // output projection: warp w takes MT2 m16 tiles x 32 columns
  static constexpr int NCG = C / 32, MT2 = M * C / 8192;
  static constexpr int kStages = 3;
  static constexpr size_t kSlot = align128(
      2 * (KQ * ldwq > DO * ldwo ? KQ * ldwq : DO * ldwo));
  static constexpr size_t xm = 0;
  static constexpr size_t qkv = xm + align128(2 * M * ldx);  // q, k, v
  static constexpr size_t kQKV = align128(2 * M * ldq);
  static constexpr size_t o = qkv + 3 * kQKV;
  static constexpr size_t p = o + kQKV;
  static constexpr size_t acc = p + align128(2 * 64 * ldp);
  static constexpr size_t pix = acc + align128(4 * 64 * lda);
  static constexpr size_t rid = pix + align128(4 * M);
  static constexpr size_t ring = rid + align128(4 * M);
  static constexpr size_t total = ring + kStages * kSlot;
  static_assert(total <= kSmemLimit, "wide attention exceeds shared memory");
};

// The token map of M = 64 WN rows, windows w0 .. of the image's (B, H / 8,
// W / 8) windows (pix -1 past the last); the caller synchronises.
template <typename T>
__device__ __forceinline__ void wide_tokens(const AttnParams<T>& p, int w0,
                                            int M, int* pix, int* rid) {
  const int H = p.H, W = p.W, sh = p.shift;
  const int nWw = W / 8, nW = (H / 8) * nWw, n_win = p.B * nW;
  for (int i = threadIdx.x; i < M; i += kThreads) {
    const int wi = w0 + i / 64, t = i % 64;
    int at = -1, r = 0;
    if (wi < n_win) {
      const int b = wi / nW, wl = wi % nW;
      const int gr = (wl / nWw) * 8 + t / 8, gc = (wl % nWw) * 8 + t % 8;
      at = (b * H + (gr + sh) % H) * W + (gc + sh) % W;
      r = window_region(wl, t, H, W, sh);
    }
    pix[i] = at;
    rid[i] = r;
  }
}

// The M rows of pix gathered into xm (zeros past the last window), then
// LN1 + mod in place; the caller's next barrier orders xm before use.
template <int C>
__device__ __forceinline__ void wide_gather_ln(const AttnParams<bf16>& p,
                                               int M, const int* pix,
                                               bf16* xm, int ldx) {
  const int tid = threadIdx.x, warp = tid >> 5;
  constexpr int vpr = C / 8;
  for (int idx = tid; idx < M * vpr; idx += kThreads) {
    const int i = idx / vpr, v = idx % vpr;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (pix[i] >= 0)
      val = *reinterpret_cast<const uint4*>(p.x + (size_t)pix[i] * C + v * 8);
    *reinterpret_cast<uint4*>(xm + i * ldx + v * 8) = val;
  }
  __syncthreads();
  for (int i = warp; i < M; i += kWarps)
    if (pix[i] >= 0)
      ln_row<bf16>(xm + i * ldx, C, p.ln_s, p.ln_b, p.has_ln,
                   p.mod ? p.mod + (i % 64) * C : nullptr);
}

// rnd(acc + bo) [+ x] of this warp's output tiles (MT2 m16 tiles from
// row0, 4 n8 tiles from col0), scattered back through the token map.
template <int C, int MT2>
__device__ __forceinline__ void wide_store(const AttnParams<bf16>& p,
                                           const float (&acco)[MT2][4][4],
                                           const int* pix, int row0,
                                           int col0) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mi = 0; mi < MT2; ++mi)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = row0 + mi * 16 + gq + 8 * hh;
        const int col = col0 + n * 8 + 2 * t4;
        if (pix[row] >= 0) {
          const size_t at = (size_t)pix[row] * C + col;
          float v0 = rnd<bf16>(acco[mi][n][2 * hh] + p.bo[col]);
          float v1 = rnd<bf16>(acco[mi][n][2 * hh + 1] + p.bo[col + 1]);
          if (p.residual) {
            const __nv_bfloat162 xv =
                *reinterpret_cast<const __nv_bfloat162*>(p.x + at);
            v0 += __low2float(xv);
            v1 += __high2float(xv);
          }
          *reinterpret_cast<uint32_t*>(p.y + at) = pack_bf16(v0, v1);
        }
      }
}

// Work item `item`: windows item WN .. item WN + WN - 1 of the image's
// (B, H / 8, W / 8) windows (those past the last are skipped). All
// kThreads threads call it; p.windows == 0.
template <int C, int D, int WN>
__device__ void attn_wide_item(const AttnParams<bf16>& p, int item,
                               unsigned char* smem) {
  using L = AttnWide<C, D, WN>;
  constexpr int S = L::kStages, M = L::M, KQ = L::KQ, NQ = L::NQ,
                TPH = L::TPH, ldx = L::ldx, ldq = L::ldq, DP = L::DP,
                DO = L::DO;
  const int nH = p.nH, sh = p.shift;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t4 = lane & 3;
  const int n_win = p.B * (p.H / 8) * (p.W / 8);
  const int w0 = item * WN;
  const int nvalid = min(WN, n_win - w0);
  bf16* xm = reinterpret_cast<bf16*>(smem + L::xm);
  bf16* qkv = reinterpret_cast<bf16*>(smem + L::qkv);
  bf16* O = reinterpret_cast<bf16*>(smem + L::o);
  bf16* P = reinterpret_cast<bf16*>(smem + L::p);
  float* accs = reinterpret_cast<float*>(smem + L::acc);
  int* pix = reinterpret_cast<int*>(smem + L::pix);
  int* rid = reinterpret_cast<int*>(smem + L::rid);
  unsigned char* ring = smem + L::ring;
  const int T = nH * TPH;

  // tile q: head q / TPH; s < 3 NQ: rows [KQ (s % NQ), +KQ) x the head's D
  // columns of wq, wk, wv (s / NQ); else rows [hD + DO o, +DO) x C of wo,
  // o = s - 3 NQ
  auto load_tile = [&](int q) {
    bf16* dst = reinterpret_cast<bf16*>(ring + (q % S) * L::kSlot);
    const int h = q / TPH, s = q % TPH;
    if (s < 3 * NQ) {
      const int pass = s / NQ, r0 = (s % NQ) * KQ;
      const bf16* src = pass == 0 ? p.wq : pass == 1 ? p.wk : p.wv;
      const int ld = pass == 0 ? C : p.ldkv;
      constexpr int vpr = D / 8;
      for (int i = tid; i < KQ * vpr; i += kThreads) {
        const int r = i / vpr, v = i % vpr;
        cp_async16(dst + r * L::ldwq + v * 8,
                   src + (size_t)(r0 + r) * ld + h * D + v * 8);
      }
    } else if constexpr (DP == D) {
      constexpr int vpr = C / 8;
      const int r0 = h * D + (s - 3 * NQ) * DO;
      for (int i = tid; i < DO * vpr; i += kThreads) {
        const int r = i / vpr, v = i % vpr;
        cp_async16(dst + r * L::ldwo + v * 8,
                   p.wo + (size_t)(r0 + r) * C + v * 8);
      }
    } else {  // rows D..DP-1 of the tile zero-filled
      constexpr int vpr = C / 8;
      for (int i = tid; i < DP * vpr; i += kThreads) {
        const int r = i / vpr, v = i % vpr;
        cp_async16(dst + r * L::ldwo + v * 8,
                   p.wo + (size_t)(h * D + (r < D ? r : 0)) * C + v * 8,
                   r < D);
      }
    }
  };
  for (int q = 0; q < S - 1; ++q) {
    if (q < T) load_tile(q);
    cp_async_commit();
  }

  // the token map of WN windows, then the gather and LN1 + mod
  wide_tokens(p, w0, M, pix, rid);
  if constexpr (DP != D)  // pad columns of q, k, v and O zero
    for (int i = tid; i < 4 * M; i += kThreads) {
      bf16* row = (i < 3 * M ? qkv + (i / M) * (L::kQKV / 2) : O) +
                  (i % M) * ldq + D;
      *reinterpret_cast<uint4*>(row) = make_uint4(0u, 0u, 0u, 0u);
    }
  __syncthreads();
  wide_gather_ln<C>(p, M, pix, xm, ldx);
  // (the first iteration's barrier orders xm before the products)

  float acco[L::MT2][4][4];
  zero_acc(acco);
  float accp[1][L::NTG][4];
  const bool pw = warp < L::NPW;
  const int mt = warp / L::NG, nq = (warp % L::NG) * L::NT * 8;
  const int row0 = (warp / L::NCG) * 16 * L::MT2, col0 = (warp % L::NCG) * 32;
  // + bias (q: times the scale), bf16 into q, k or v: accp's n8 tiles
  // from column nq + 8 n0
  auto pass_out = [&](int pass, int h, int n0) {
    const float* bias = (pass == 0 ? p.bq : pass == 1 ? p.bk : p.bv) + h * D;
    const float scale = pass == 0 ? p.scale : 1.0f;
    bf16* dst = qkv + pass * (L::kQKV / 2);
#pragma unroll
    for (int n = 0; n < L::NTG; ++n) {
      const int col = nq + (n0 + n) * 8 + 2 * t4;
      const float bb0 = bias[col], bb1 = bias[col + 1];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = mt * 16 + gq + 8 * hh;
        *reinterpret_cast<uint32_t*>(dst + row * ldq + col) =
            pack_bf16((accp[0][n][2 * hh] + bb0) * scale,
                      (accp[0][n][2 * hh + 1] + bb1) * scale);
      }
    }
  };
  for (int q = 0; q < T; ++q) {
    cp_async_wait<S - 2>();
    __syncthreads();
    // the slot of tile q - 1, which every thread has finished with
    if (q + S - 1 < T) load_tile(q + S - 1);
    cp_async_commit();
    const bf16* wt = reinterpret_cast<const bf16*>(ring + (q % S) * L::kSlot);
    const int h = q / TPH, s = q % TPH;
    if (s >= 3 * NQ) {
      warp_mma<L::MT2, 4, DO / 16>(acco, O + row0 * ldq + (s - 3 * NQ) * DO,
                                   ldq, wt + col0, L::ldwo);
      continue;
    }
    const int pass = s / NQ, kt = s % NQ;
    if (pw) {
      if constexpr (NQ == 1) {
#pragma unroll
        for (int n0 = 0; n0 < L::NT; n0 += L::NTG) {
          zero_acc(accp);
          warp_mma<1, L::NTG, KQ / 16>(accp, xm + mt * 16 * ldx, ldx,
                                       wt + nq + n0 * 8, L::ldwq);
          pass_out(pass, h, n0);
        }
      } else {
        if (kt == 0) zero_acc(accp);
        warp_mma<1, L::NT, KQ / 16>(accp, xm + mt * 16 * ldx + kt * KQ, ldx,
                                    wt + nq, L::ldwq);
        if (kt == NQ - 1) pass_out(pass, h, 0);
      }
    }
    if (pass < 2 || kt < NQ - 1) continue;
    __syncthreads();
    // the window core of each window into O_h
    const bf16* qs = qkv;
    const bf16* ks = qkv + L::kQKV / 2;
    const bf16* vs = qkv + L::kQKV;
    for (int w = 0; w < nvalid; ++w) {
      window_core<bf16, D, kWarps>(qs + w * 64 * ldq, ks + w * 64 * ldq,
                                   vs + w * 64 * ldq, ldq,
                                   p.bias + (size_t)h * 4096,
                                   sh ? rid + w * 64 : nullptr, 1.0f, P,
                                   L::ldp, accs, L::lda);
      for (int idx = tid; idx < 64 * D; idx += kThreads) {
        const int t = idx / D, d = idx % D;
        O[(w * 64 + t) * ldq + d] = from_f<bf16>(accs[t * L::lda + d]);
      }
      __syncthreads();
    }
  }

  // + bo, rounded, [+ x,] scattered back through the token map
  wide_store<C>(p, acco, pix, row0, col0);
  cp_async_wait<0>();
  __syncthreads();  // the caller's next item reuses every buffer
}


// ---- C = 1024 ---------------------------------------------------------
//
// At C = 1024 (an --embed_dim 64 model's bottleneck and dec0, 16 heads of
// 64) the 64-row x tile is 132 KB of bf16 and the concatenated O as much:
// both do not fit one block, and a 64 x 1024 fp32 output accumulator
// would take 128 registers a thread. So one window a work item, and:
//   - per head, q, k, v from xm in shared memory (128 x 64 weight tiles
//     through a two-slot cp.async ring), the window core, and O_h written
//     to the block's slot of the scratch tensor (64 x C bf16, in L2);
//   - after the last head's projections xm is dead: O is copied from the
//     slot over it;
//   - the output projection in two column halves of 512, each warp 64 rows
//     x 32 columns in registers (as at C = 512), wo streamed as 16 x 512
//     tiles through the same ring, then stored half by half.
// The roundings are attn_wide_item's; only the order of the fp32 sums
// differs. Weights: 8 MB a block, read by every window (L2-resident
// after the first).

__host__ __device__ constexpr bool attn_wide_l2_fits(int C, int D) {
  return C == 1024 && D == 64;
}

template <int C, int D>
struct AttnWideL2 {
  static_assert(attn_wide_l2_fits(C, D), "no C = 1024 attention layout");
  static constexpr int KQ = 8192 / D;       // rows of a q, k or v tile
  static constexpr int NQ = C / KQ;         // tiles of one of q, k, v
  static constexpr int TPH = 3 * NQ;        // tiles per head
  static constexpr int CH = 512;            // columns of an output half
  static constexpr int KO = 16;             // rows of a wo tile
  static constexpr int TPO = C / KO;        // wo tiles of a half
  static constexpr int ldx = C + 8, ldq = D + 8, ldp = 72, lda = 68;
  static constexpr int ldwq = D + 8, ldwo = CH + 8;
  // q/k/v pass: warp w takes m16 tile w / NG and NT n8 tiles of the head
  static constexpr int NT = 64 * D / 2048, NG = D / 8 / NT;
  static constexpr int kStages = 2;
  static constexpr size_t kSlot = align128(
      2 * (KQ * ldwq > KO * ldwo ? KQ * ldwq : KO * ldwo));
  static constexpr size_t xm = 0;  // LN1 + mod; then O
  static constexpr size_t qkv = xm + align128(2 * 64 * ldx);
  static constexpr size_t kQKV = align128(2 * 64 * ldq);
  static constexpr size_t p = qkv + 3 * kQKV;
  static constexpr size_t acc = p + align128(2 * 64 * ldp);
  static constexpr size_t pix = acc + align128(4 * 64 * lda);
  static constexpr size_t rid = pix + align128(4 * 64);
  static constexpr size_t ring = rid + align128(4 * 64);
  static constexpr size_t total = ring + kStages * kSlot;
  static_assert(64 / 16 * NG == kWarps, "q/k/v pass: a job a warp");
  static_assert(CH / 32 == kWarps, "output projection: 32 columns a warp");
  static_assert(total <= kSmemLimit, "C 1024 attention exceeds shared memory");
};

// Work item `item`: window `item` of the image's (B, H / 8, W / 8)
// windows. All kThreads threads call it; p.windows == 0; p.o_scratch
// holds a 64 x C slot per block (blockIdx.x).
template <int C, int D>
__device__ void attn_wide_item_l2(const AttnParams<bf16>& p, int item,
                                  unsigned char* smem) {
  using L = AttnWideL2<C, D>;
  constexpr int S = L::kStages, KQ = L::KQ, NQ = L::NQ, TPH = L::TPH,
                KO = L::KO, TPO = L::TPO, ldx = L::ldx, ldq = L::ldq;
  const int nH = p.nH, sh = p.shift;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t4 = lane & 3;
  bf16* xm = reinterpret_cast<bf16*>(smem + L::xm);
  bf16* qkv = reinterpret_cast<bf16*>(smem + L::qkv);
  bf16* P = reinterpret_cast<bf16*>(smem + L::p);
  float* accs = reinterpret_cast<float*>(smem + L::acc);
  int* pix = reinterpret_cast<int*>(smem + L::pix);
  int* rid = reinterpret_cast<int*>(smem + L::rid);
  unsigned char* ring = smem + L::ring;
  bf16* Og = p.o_scratch + (size_t)blockIdx.x * 64 * C;
  const int TQ = nH * TPH, T = TQ + 2 * TPO;

  // tile q < TQ: head q / TPH, rows [KQ (s % NQ), +KQ) x the head's D
  // columns of wq, wk, wv (s / NQ), s = q % TPH; else half o = (q - TQ) /
  // TPO of wo: rows [KO k, +KO) x columns [512 o, +512), k = (q - TQ) % TPO
  auto load_tile = [&](int q) {
    bf16* dst = reinterpret_cast<bf16*>(ring + (q % S) * L::kSlot);
    if (q < TQ) {
      const int h = q / TPH, s = q % TPH;
      const int pass = s / NQ, r0 = (s % NQ) * KQ;
      const bf16* src = pass == 0 ? p.wq : pass == 1 ? p.wk : p.wv;
      const int ld = pass == 0 ? C : p.ldkv;
      constexpr int vpr = D / 8;
      for (int i = tid; i < KQ * vpr; i += kThreads) {
        const int r = i / vpr, v = i % vpr;
        cp_async16(dst + r * L::ldwq + v * 8,
                   src + (size_t)(r0 + r) * ld + h * D + v * 8);
      }
    } else {
      const int o = (q - TQ) / TPO, r0 = ((q - TQ) % TPO) * KO;
      constexpr int vpr = L::CH / 8;
      for (int i = tid; i < KO * vpr; i += kThreads) {
        const int r = i / vpr, v = i % vpr;
        cp_async16(dst + r * L::ldwo + v * 8,
                   p.wo + (size_t)(r0 + r) * C + o * L::CH + v * 8);
      }
    }
  };
  for (int q = 0; q < S - 1; ++q) {
    load_tile(q);
    cp_async_commit();
  }
  wide_tokens(p, item, 64, pix, rid);
  __syncthreads();
  wide_gather_ln<C>(p, 64, pix, xm, ldx);
  // (the first iteration's barrier orders xm before the products)

  float accp[1][L::NT][4];
  float acco[4][4][4];
  const int mt = warp / L::NG, nq = (warp % L::NG) * L::NT * 8;
  for (int q = 0; q < T; ++q) {
    cp_async_wait<S - 2>();
    __syncthreads();
    // the slot of tile q - 1, which every thread has finished with
    if (q + S - 1 < T) load_tile(q + S - 1);
    cp_async_commit();
    const bf16* wt = reinterpret_cast<const bf16*>(ring + (q % S) * L::kSlot);
    if (q >= TQ) {  // the output projection over O (in xm's place)
      const int o = (q - TQ) / TPO, kt = (q - TQ) % TPO;
      if (kt == 0) zero_acc(acco);
      warp_mma<4, 4, KO / 16>(acco, xm + kt * KO, ldx, wt + warp * 32,
                              L::ldwo);
      if (kt == TPO - 1)
        wide_store<C>(p, acco, pix, 0, o * L::CH + warp * 32);
      continue;
    }
    const int h = q / TPH, s = q % TPH, pass = s / NQ, kt = s % NQ;
    if (kt == 0) zero_acc(accp);
    warp_mma<1, L::NT, KQ / 16>(accp, xm + mt * 16 * ldx + kt * KQ, ldx,
                                wt + nq, L::ldwq);
    if (kt == NQ - 1) {
      // + bias (q: times the scale), bf16 into q, k or v
      const float* bias =
          (pass == 0 ? p.bq : pass == 1 ? p.bk : p.bv) + h * D;
      const float scale = pass == 0 ? p.scale : 1.0f;
      bf16* dst = qkv + pass * (L::kQKV / 2);
#pragma unroll
      for (int n = 0; n < L::NT; ++n) {
        const int col = nq + n * 8 + 2 * t4;
        const float bb0 = bias[col], bb1 = bias[col + 1];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = mt * 16 + gq + 8 * hh;
          *reinterpret_cast<uint32_t*>(dst + row * ldq + col) =
              pack_bf16((accp[0][n][2 * hh] + bb0) * scale,
                        (accp[0][n][2 * hh + 1] + bb1) * scale);
        }
      }
    }
    if (pass < 2 || kt < NQ - 1) continue;
    __syncthreads();
    // the window core into O_h, in the block's scratch slot
    window_core<bf16, D, kWarps>(qkv, qkv + L::kQKV / 2, qkv + L::kQKV, ldq,
                                 p.bias + (size_t)h * 4096,
                                 sh ? rid : nullptr, 1.0f, P, L::ldp, accs,
                                 L::lda);
    for (int idx = tid; idx < 64 * D; idx += kThreads) {
      const int t = idx / D, d = idx % D;
      Og[(size_t)t * C + h * D + d] = from_f<bf16>(accs[t * L::lda + d]);
    }
    __syncthreads();
    if (h == nH - 1) {  // every projection is done: O over xm
      constexpr int vpr = C / 8;
      for (int i = tid; i < 64 * vpr; i += kThreads) {
        const int t = i / vpr, v = i % vpr;
        *reinterpret_cast<uint4*>(xm + t * ldx + v * 8) =
            *reinterpret_cast<const uint4*>(Og + (size_t)t * C + v * 8);
      }
      // (the next iteration's barrier orders O before the products)
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the caller's next item reuses every buffer
}

}  // namespace uf
