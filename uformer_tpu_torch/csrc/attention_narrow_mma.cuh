// The LeWin attention sub-block in bf16 at narrow widths (C 16, 32, 64
// at head dim D 16 or 32; C 8-64 at D 8; C 64 at D 64; C >= D) on the
// tensor-core building block (mma_tile.cuh):
//
//   y = [x +] tokens^-1(proj(W-MSA(LN1(tokens(x)) + mod)))
//
// Kernel 1's body at the stages of Uformer_B and Uformer_T that the stage
// kernel does not take (enc0, enc1, dec3; Uformer_T's C 32/64 stages),
// and kernel 5's on (Bw, 64, C) windows (Uformer_T's enc0).
// At these widths a window is little work (2 . 64 C (4 C + 128) operations
// against 2 . 64 C . 2 bytes), so what bounds the old block-per-window
// body is latency: block-wide barriers between WMMA products staged
// through shared memory, scalar gathers and weights read from L2. Design:
//
//   - persistent blocks: a block of WN groups of four warps walks work
//     items of WN windows (group g takes window item WN + g); the wq, wk,
//     wv and wo matrices, the biases, LN1's scale and bias, the modulator
//     and (for at most two heads) the relative-position bias are copied
//     into shared memory once per block. With four heads (C 64, D 16) the
//     bias is read through the read-only cache from L2 instead: 72 KB of
//     it would leave no room for four groups;
//   - the gather as a pipeline: each group copies its next window's 64
//     pixel rows with 16-byte cp.async through the token map while it
//     computes the current one (two buffers per group);
//   - each warp owns 16 of the window's 64 rows: it takes LN1 + mod of its
//     rows from the ldmatrix fragments into registers (row statistics by
//     quad shuffles), and per head computes its rows of q, k and v on
//     mma.sync (q times the scale, rounded, kept in registers as an A
//     operand; k and v rounded into shared memory), then waits on the
//     group's named barrier (bar.sync 1 + g, 128), never on the block's;
//   - the window core in registers (window_core_mma.cuh): S = q k^T
//     (16 x 64, eight n8 tiles), + bias, - 100 where the region ids differ
//     (one 32-bit mask per lane per window), row max and sum by quad
//     shuffles, P rounded to bf16 and repacked into A fragments for
//     O = P v; O rounded and repacked as the A operand of
//     acc += O wo[hD:, :].
//     The 16 x C output accumulator stays in registers over all heads;
//     S, P and O never touch shared memory;
//   - the epilogue rnd(acc + bo) [+ x] is staged in the window's own x
//     buffer and stored with 16-byte vectors through the token map.
//
// The token map is a parameter of the body (window_core_mma.cuh's
// ImageTokens: shift, partition, reverse and unshift at no cost;
// WindowTokens: identity windows at an offset; PackedTokens: 64-row tiles
// of whole windows of N = win^2 < 64 tokens, padding rows read as zeros
// and never written, the modulator and bias the host's tiles of them).
// Products of depth 8 (a head of 8, or C = 8) run on m16n8k8
// (warp_mma_ra8); at C = 8 LN1 takes the two registers of the m16k8
// fragment, its statistics over the 8 channels. The roundings are
// attention_window's: LN output, + mod, q (after the scale), k, v, P, O,
// then rnd(acc + bo) [+ x]. Only the order of the fp32 sums differs.
#pragma once

#include "attention_window.cuh"
#include "window_core_mma.cuh"

namespace uf {

// Whether attn_narrow has a layout for (C, D): C 16-64 at head dim 16 or
// 32, C 8-64 at head dim 8 (the products of depth 8, a head's QK^T and
// O wo and at C = 8 the projections, on mma.sync.m16n8k8), and C 64 at
// head dim 64 (one head: an --embed_dim 64 model's enc0 and dec3's
// attention, whose o[8][4] and q fragments double against head dim 32).
__host__ __device__ constexpr bool attn_narrow_fits(int C, int D) {
  return ((C == 8 || C == 16 || C == 32 || C == 64) &&
          (D == 8 || D == 16 || D == 32) && C >= D) ||
         (C == 64 && D == 64);
}

template <int C, int D, int WN>
struct AttnNarrow {
  static_assert(attn_narrow_fits(C, D) && (WN == 1 || WN == 2 || WN == 4),
                "no narrow attention layout");
  static constexpr int nH = C / D;
  static constexpr int kThreadsN = 128 * WN;
  static constexpr int ldx = C + 8, ldw = C + 8, ldk = D + 8, ldb = 72;
  static constexpr bool kBiasSmem = nH <= 2;
  static constexpr size_t kW = align128(2 * C * ldw);
  static constexpr size_t w = 0;                        // wq, wk, wv, wo
  static constexpr size_t vec = w + 4 * kW;             // fp32 6 x C
  static constexpr size_t mod = vec + align128(4 * 6 * C);
  static constexpr size_t bias = mod + align128(2 * 64 * ldx);
  static constexpr size_t group =
      bias + (kBiasSmem ? align128(4 * nH * 64 * ldb) : 0);
  static constexpr size_t kX = align128(2 * 64 * ldx);  // one x buffer
  static constexpr size_t kKV = align128(2 * 64 * ldk);  // k or v
  static constexpr size_t kGroup = 2 * kX + 2 * kKV;
  static constexpr size_t total = group + WN * kGroup;
  static_assert(total <= kSmemLimit, "narrow attention exceeds shared memory");
};

__device__ __forceinline__ void group_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ float2 bf2_to_f2(uint32_t v) {
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&v);
  return make_float2(__low2float(h), __high2float(h));
}

// All threads of a block of AttnNarrow<C, D, WN>::kThreadsN call it; each
// group of four warps walks windows (blockIdx.x + i gridDim.x) WN + group
// of the n_win windows of the token map `tok`.
template <int C, int D, int WN, typename Tokens>
__device__ void attn_narrow(const AttnParams<bf16>& p, const Tokens& tok,
                            int n_win, unsigned char* smem) {
  using L = AttnNarrow<C, D, WN>;
  constexpr int nH = L::nH, ldx = L::ldx, ldw = L::ldw, ldk = L::ldk,
                ldb = L::ldb, KC = frags_k(C), KD = frags_k(D),
                vpr = C / 8;
  // the m16k8 fragments of C = 8 hold two registers of four
  constexpr int RX = C == 8 ? 2 : 4;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t4 = lane & 3;
  const int g = warp >> 2, gt = tid & 127, r0 = (warp & 3) * 16;
  const int bar = 1 + g;
  bf16* wq = reinterpret_cast<bf16*>(smem + L::w);
  bf16* wk = reinterpret_cast<bf16*>(smem + L::w + L::kW);
  bf16* wv = reinterpret_cast<bf16*>(smem + L::w + 2 * L::kW);
  bf16* wo = reinterpret_cast<bf16*>(smem + L::w + 3 * L::kW);
  float* vec = reinterpret_cast<float*>(smem + L::vec);
  const float *ln_s = vec, *ln_b = vec + C, *bq = vec + 2 * C,
              *bk = vec + 3 * C, *bv = vec + 4 * C, *bo = vec + 5 * C;
  const bf16* mod = reinterpret_cast<const bf16*>(smem + L::mod);
  float* bias_s = reinterpret_cast<float*>(smem + L::bias);
  unsigned char* grp = smem + L::group + g * L::kGroup;
  bf16* xb[2] = {reinterpret_cast<bf16*>(grp),
                 reinterpret_cast<bf16*>(grp + L::kX)};
  bf16* ks = reinterpret_cast<bf16*>(grp + 2 * L::kX);
  bf16* vs = reinterpret_cast<bf16*>(grp + 2 * L::kX + L::kKV);

  // the block's weights, once
  for (int i = tid; i < C * vpr; i += L::kThreadsN) {
    const int r = i / vpr, c = (i % vpr) * 8;
    cp_async16(wq + r * ldw + c, p.wq + (size_t)r * C + c);
    cp_async16(wk + r * ldw + c, p.wk + (size_t)r * p.ldkv + c);
    cp_async16(wv + r * ldw + c, p.wv + (size_t)r * p.ldkv + c);
    cp_async16(wo + r * ldw + c, p.wo + (size_t)r * C + c);
  }
  if (p.mod)
    for (int i = tid; i < 64 * vpr; i += L::kThreadsN) {
      const int r = i / vpr, c = (i % vpr) * 8;
      cp_async16(reinterpret_cast<bf16*>(smem + L::mod) + r * ldx + c,
                 p.mod + (size_t)r * C + c);
    }
  if constexpr (L::kBiasSmem)
    for (int i = tid; i < nH * 64 * 16; i += L::kThreadsN) {
      const int r = i / 16, c = (i % 16) * 4;
      cp_async16(bias_s + r * ldb + c, p.bias + (size_t)r * 64 + c);
    }
  for (int i = tid; i < C; i += L::kThreadsN) {
    vec[i] = p.has_ln ? p.ln_s[i] : 1.f;
    vec[C + i] = p.has_ln ? p.ln_b[i] : 0.f;
    vec[2 * C + i] = p.bq[i];
    vec[3 * C + i] = p.bk[i];
    vec[4 * C + i] = p.bv[i];
    vec[5 * C + i] = p.bo[i];
  }
  // the group's 64 pixel rows of window w into dst
  // (rows the token map marks as padding read as zeros)
  auto load_x = [&](int w, bf16* dst) {
    for (int i = gt; i < 64 * vpr; i += 128) {
      const int t = i / vpr, c = (i % vpr) * 8;
      cp_async16(dst + t * ldx + c, p.x + (size_t)tok.pix(w, t) * C + c,
                 tok.valid(w, t));
    }
  };
  const int stride = gridDim.x * WN;
  int w = blockIdx.x * WN + g;
  if (w < n_win) load_x(w, xb[0]);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int ta = r0 + gq, tb = ta + 8;  // this lane's rows of the window
  const bool use_mod = p.mod != nullptr;
  for (int buf = 0; w < n_win; w += stride, buf ^= 1) {
    // window w has landed in xb[buf]; every warp of the group is done
    // with the previous window (xb[buf ^ 1], ks, vs)
    cp_async_wait<0>();
    group_sync(bar);
    if (w + stride < n_win) load_x(w + stride, xb[buf ^ 1]);
    cp_async_commit();
    const bf16* X = xb[buf];

    // the SW-MSA mask of this lane's rows
    const uint32_t mask = window_mask_bits(tok, w, ta, tb, t4);

    // LN1 + mod of this warp's 16 rows, as A fragments: xa[k][0, 2] hold
    // row ta, columns 16 k + 2 t4 + {0, 1} and + 8; xa[k][1, 3] row tb
    uint32_t xa[KC][4];
    if constexpr (C == 8) {
      uint32_t r[2];
      ldsm_x2(r, X + (r0 + (lane & 15)) * ldx);
      xa[0][0] = r[0];
      xa[0][1] = r[1];
      xa[0][2] = xa[0][3] = 0u;
    } else {
#pragma unroll
      for (int k = 0; k < KC; ++k)
        ldsm_x4(xa[k],
                X + (r0 + (lane & 15)) * ldx + k * 16 + (lane >> 4) * 8);
    }
    {
      float mean[2] = {0.f, 0.f}, rstd[2] = {0.f, 0.f};
      if (p.has_ln) {
        float s[2] = {0.f, 0.f};
#pragma unroll
        for (int k = 0; k < KC; ++k)
#pragma unroll
          for (int r = 0; r < RX; ++r) {
            const float2 v = bf2_to_f2(xa[k][r]);
            s[r & 1] += v.x + v.y;
          }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          s[hh] += __shfl_xor_sync(0xffffffffu, s[hh], 1);
          s[hh] += __shfl_xor_sync(0xffffffffu, s[hh], 2);
          mean[hh] = s[hh] / C;
        }
        float q[2] = {0.f, 0.f};
#pragma unroll
        for (int k = 0; k < KC; ++k)
#pragma unroll
          for (int r = 0; r < RX; ++r) {
            const float2 v = bf2_to_f2(xa[k][r]);
            const float d0 = v.x - mean[r & 1], d1 = v.y - mean[r & 1];
            q[r & 1] += d0 * d0 + d1 * d1;
          }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          q[hh] += __shfl_xor_sync(0xffffffffu, q[hh], 1);
          q[hh] += __shfl_xor_sync(0xffffffffu, q[hh], 2);
          rstd[hh] = 1.0f / sqrtf(q[hh] / C + 1e-5f);
        }
      }
#pragma unroll
      for (int k = 0; k < KC; ++k)
#pragma unroll
        for (int r = 0; r < RX; ++r) {
          const int hh = r & 1, c = 16 * k + 8 * (r >> 1) + 2 * t4;
          float2 v = bf2_to_f2(xa[k][r]);
          if (p.has_ln) {
            v.x = rnd<bf16>((v.x - mean[hh]) * rstd[hh] * ln_s[c] + ln_b[c]);
            v.y = rnd<bf16>((v.y - mean[hh]) * rstd[hh] * ln_s[c + 1] +
                            ln_b[c + 1]);
          }
          if (use_mod) {
            const float2 m = bf2_to_f2(*reinterpret_cast<const uint32_t*>(
                mod + (hh ? tb : ta) * ldx + c));
            v.x += m.x;
            v.y += m.y;
          }
          xa[k][r] = pack_bf16(v.x, v.y);
        }
    }

    float acco[C / 8][4];
    zero_acc(acco);

#pragma unroll 1
    for (int h = 0; h < nH; ++h) {
      const int c0 = h * D;
      if (h) group_sync(bar);  // every warp is done with head h - 1's k, v
      uint32_t qa[KD][4];
      {
        float acc[D / 8][4];
        // k and v of this warp's rows into shared memory
#pragma unroll
        for (int pass = 1; pass < 3; ++pass) {
          zero_acc(acc);
          if constexpr (C == 8)
            warp_mma_ra8<D / 8>(acc, xa[0], (pass == 1 ? wk : wv) + c0, ldw);
          else
            warp_mma_ra<D / 8, KC>(acc, xa, (pass == 1 ? wk : wv) + c0,
                                   ldw);
          const float* bb = (pass == 1 ? bk : bv) + c0;
          bf16* dst = pass == 1 ? ks : vs;
#pragma unroll
          for (int n = 0; n < D / 8; ++n) {
            const int col = 8 * n + 2 * t4;
            *reinterpret_cast<uint32_t*>(dst + ta * ldk + col) = pack_bf16(
                acc[n][0] + bb[col], acc[n][1] + bb[col + 1]);
            *reinterpret_cast<uint32_t*>(dst + tb * ldk + col) = pack_bf16(
                acc[n][2] + bb[col], acc[n][3] + bb[col + 1]);
          }
        }
        // q (+ bias, times the scale) stays in registers
        zero_acc(acc);
        if constexpr (C == 8)
          warp_mma_ra8<D / 8>(acc, xa[0], wq + c0, ldw);
        else
          warp_mma_ra<D / 8, KC>(acc, xa, wq + c0, ldw);
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          const int col = c0 + 8 * n + 2 * t4;
          acc[n][0] = (acc[n][0] + bq[col]) * p.scale;
          acc[n][1] = (acc[n][1] + bq[col + 1]) * p.scale;
          acc[n][2] = (acc[n][2] + bq[col]) * p.scale;
          acc[n][3] = (acc[n][3] + bq[col + 1]) * p.scale;
        }
        acc_to_a(acc, qa);
      }
      group_sync(bar);  // the window's 64 rows of k and v are in place

      // O_h = softmax(q k^T + bias [- 100]) v in registers (the scale is
      // in q), rounded, then acc += O_h wo[hD:hD+D, :]
      uint32_t oa[KD][4];
      {
        float o[D / 8][4];
        const float* bh = L::kBiasSmem ? bias_s + h * 64 * ldb
                                       : p.bias + (size_t)h * 4096;
        const int lb = L::kBiasSmem ? ldb : 64;
        window_core_mma<D, !L::kBiasSmem>(o, qa, ks, vs, ldk, bh + r0 * lb,
                                          lb, mask, 1.0f);
        acc_to_a(o, oa);
      }
      if constexpr (D == 8)
        warp_mma_ra8<C / 8>(acco, oa[0], wo + c0 * ldw, ldw);
      else
        warp_mma_ra<C / 8, KD>(acco, oa, wo + c0 * ldw, ldw);
    }

    // rnd(acc + bo) [+ x] into this warp's rows of the x buffer (its own:
    // no other warp reads them), then 16-byte stores through the map
    bf16* Y = xb[buf];
    __syncwarp();
#pragma unroll
    for (int n = 0; n < C / 8; ++n)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int col = 8 * n + 2 * t4;
        uint32_t* at = reinterpret_cast<uint32_t*>(Y + (hh ? tb : ta) * ldx +
                                                   col);
        float v0 = rnd<bf16>(acco[n][2 * hh] + bo[col]);
        float v1 = rnd<bf16>(acco[n][2 * hh + 1] + bo[col + 1]);
        if (p.residual) {
          const float2 xv = bf2_to_f2(*at);
          v0 += xv.x;
          v1 += xv.y;
        }
        *at = pack_bf16(v0, v1);
      }
    __syncwarp();
    for (int i = lane; i < 16 * vpr; i += 32) {
      const int t = r0 + i / vpr, c = (i % vpr) * 8;
      if (tok.valid(w, t))
        *reinterpret_cast<uint4*>(p.y + (size_t)tok.pix(w, t) * C + c) =
            *reinterpret_cast<const uint4*>(Y + t * ldx + c);
    }
  }
  cp_async_wait<0>();
}

}  // namespace uf
