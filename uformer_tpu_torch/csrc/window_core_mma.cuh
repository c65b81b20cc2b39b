// The window-attention core per warp, in registers, on the tensor-core
// building block (mma_tile.cuh): for 16 of a window's 64 rows and one
// head,
//
//   O = softmax(q k^T * scale + bias_h [- 100 where region ids differ]) v
//
// S = q k^T over eight n8 tiles, the bias and the SW-MSA mask (one 32-bit
// word per lane, window_mask_bits), the row max and sum by quad shuffles,
// expf, P rounded to bf16 and repacked from the accumulator layout into A
// fragments, and O = P v accumulated in fp32. S, P and O never touch
// shared memory and no barrier is taken: each warp runs the core on its
// own rows. It is the core of kernel 1's narrow body and kernel 5's
// (attention_narrow_mma.cuh) and of kernel 4's bf16 body
// (window_attention.cu). window_core.cuh is the block-wide form (WMMA
// through shared memory) that fp32 and the wide bodies run.
//
// The scale multiplies the fp32 logits (fmaf(s, scale, bias)): kernel 4
// scales them, as uformer_tpu/ops/pallas/window_attention.py:55 does; the
// block bodies fold the scale into q before rounding it and pass 1.0f,
// and fmaf(s, 1.0f, b) rounds exactly as s + b.
#pragma once

#include <cfloat>

#include "mma_tile.cuh"
#include "window_core.cuh"

namespace uf {

// acc[16 x 8 NT] += A[16 x 16 KS] . B[16 KS x 8 NT], warp_mma's product
// with A already in registers as KS k16 fragments (a[k][0..3] in the PTX
// ISA's m16k16 A layout); B in shared memory as warp_mma takes it (BT: B
// stored N x K row-major).
template <int NT, int KS, bool BT = false>
__device__ __forceinline__ void warp_mma_ra(float (&acc)[NT][4],
                                            const uint32_t (&a)[KS][4],
                                            const bf16* B, int ldb) {
  const int lane = threadIdx.x & 31;
  const int tr = (lane & 7) + ((lane >> 4) << 3), tc = ((lane >> 3) & 1) * 8;
  const int rr = lane & 15, rc = (lane >> 4) * 8;
  const bf16* b = BT ? B + tr * ldb + tc : B + rr * ldb + rc;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      if (n + 1 < NT) {
        uint32_t r[4];
        if (BT)
          ldsm_x4(r, b + n * 8 * ldb + ks * 16);
        else
          ldsm_x4_t(r, b + ks * 16 * ldb + n * 8);
        mma16816(acc[n], a[ks], r[0], r[1]);
        mma16816(acc[n + 1], a[ks], r[2], r[3]);
      } else {
        uint32_t r[2];
        if (BT)
          ldsm_x2(r, b + n * 8 * ldb + ks * 16);
        else
          ldsm_x2_t(r, b + ks * 16 * ldb + n * 8);
        mma16816(acc[n], a[ks], r[0], r[1]);
      }
    }
}

__device__ __forceinline__ void ldsm_x1(uint32_t& r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x1.shared.b16 {%0}, [%1];\n"
               : "=r"(r)
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x1_t(uint32_t& r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x1.trans.shared.b16 {%0}, [%1];\n"
               : "=r"(r)
               : "r"(smem_u32(p))
               : "memory");
}

// d += a . b for one m16n8k8 tile: a0, a1 the m16k8 A fragment (rows
// lane / 4 and + 8, columns 2 (lane % 4) + {0, 1}), b its k8n8 B fragment
__device__ __forceinline__ void mma1688(float (&d)[4], uint32_t a0,
                                        uint32_t a1, uint32_t b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b));
}

// acc[16 x 8 NT] += A[16 x 8] . B[8 x 8 NT], the product of depth 8 (a
// head or a width of 8): A in registers as a[0], a[1] (the m16k8
// fragment, the low half of an m16k16 one); B in shared memory, K x N
// row-major, or with BT N x K row-major. ldmatrix lane l addresses row
// l % 8 of the 8 x 8 matrix l / 8, matrix i being n8 tile n + i.
template <int NT, bool BT = false>
__device__ __forceinline__ void warp_mma_ra8(float (&acc)[NT][4],
                                             const uint32_t (&a)[4],
                                             const bf16* B, int ldb) {
  const int lane = threadIdx.x & 31;
  auto at = [&](int n) {
    return BT ? B + (n * 8 + lane) * ldb
              : B + (lane & 7) * ldb + (n + (lane >> 3)) * 8;
  };
  int n = 0;
#pragma unroll
  for (; n + 4 <= NT; n += 4) {
    uint32_t r[4];
    if (BT)
      ldsm_x4(r, at(n));
    else
      ldsm_x4_t(r, at(n));
#pragma unroll
    for (int i = 0; i < 4; ++i) mma1688(acc[n + i], a[0], a[1], r[i]);
  }
  if constexpr (NT % 4 >= 2) {
    uint32_t r[2];
    if (BT)
      ldsm_x2(r, at(NT / 4 * 4));
    else
      ldsm_x2_t(r, at(NT / 4 * 4));
    mma1688(acc[NT / 4 * 4], a[0], a[1], r[0]);
    mma1688(acc[NT / 4 * 4 + 1], a[0], a[1], r[1]);
  }
  if constexpr (NT % 2) {
    uint32_t r;
    if (BT)
      ldsm_x1(r, at(NT - 1));
    else
      ldsm_x1_t(r, at(NT - 1));
    mma1688(acc[NT - 1], a[0], a[1], r);
  }
}

// warp_mma's product over a depth K that is a multiple of 16 or is 8:
// acc[16 MT x 8 NT] += A[16 MT x K] . B[K x 8 NT], operands as warp_mma
// takes them (A row-major; BT: B stored N x K). At K = 8 each m16 tile's
// A comes in by ldmatrix.x2 as the m16k8 fragment and the product runs on
// mma.sync.m16n8k8 (warp_mma_ra8).
template <int MT, int NT, int K, bool BT = false>
__device__ __forceinline__ void warp_mma_k(float (&acc)[MT][NT][4],
                                           const bf16* A, int lda,
                                           const bf16* B, int ldb) {
  if constexpr (K % 16 == 0) {
    warp_mma<MT, NT, K / 16, false, BT>(acc, A, lda, B, ldb);
  } else {
    static_assert(K == 8, "warp_mma_k: K a multiple of 16, or 8");
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      uint32_t a2[2];
      ldsm_x2(a2, A + (m * 16 + (lane & 15)) * lda);
      const uint32_t a[4] = {a2[0], a2[1], 0u, 0u};
      warp_mma_ra8<NT, BT>(acc[m], a, B, ldb);
    }
  }
}

// A fragments of a product over K: K / 16 of them, or one (its high half
// zero) for K = 8.
__host__ __device__ constexpr int frags_k(int K) {
  return K >= 16 ? K / 16 : 1;
}

template <int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
}

// The NT n8 accumulator tiles of a 16-row product, rounded to bf16 and
// repacked as the A operand (NT / 2 k16 steps) of the next product; one
// tile (NT = 1) as an m16k8 fragment, its high half zero.
template <int NT>
__device__ __forceinline__ void acc_to_a(const float (&acc)[NT][4],
                                         uint32_t (&a)[frags_k(8 * NT)][4]) {
  if constexpr (NT == 1) {
    a[0][0] = pack_bf16(acc[0][0], acc[0][1]);
    a[0][1] = pack_bf16(acc[0][2], acc[0][3]);
    a[0][2] = a[0][3] = 0u;
    return;
  }
#pragma unroll
  for (int k = 0; k < NT / 2; ++k) {
    a[k][0] = pack_bf16(acc[2 * k][0], acc[2 * k][1]);
    a[k][1] = pack_bf16(acc[2 * k][2], acc[2 * k][3]);
    a[k][2] = pack_bf16(acc[2 * k + 1][0], acc[2 * k + 1][1]);
    a[k][3] = pack_bf16(acc[2 * k + 1][2], acc[2 * k + 1][3]);
  }
}

// The image token map (attention_window's): token t of window w is pixel
// ((r + s) mod H, (c + s) mod W) of image w / nW.
struct ImageTokens {
  int H, W, s, nWw, nW;
  __device__ ImageTokens(int H_, int W_, int s_)
      : H(H_), W(W_), s(s_), nWw(W_ / 8), nW((H_ / 8) * (W_ / 8)) {}
  __device__ __forceinline__ int pix(int w, int t) const {
    const int b = w / nW, wl = w % nW;
    const int gr = (wl / nWw) * 8 + t / 8, gc = (wl % nWw) * 8 + t % 8;
    return (b * H + (gr + s) % H) * W + (gc + s) % W;
  }
  // the window's place (row-major) among its image's nW windows
  __device__ __forceinline__ int place(int w) const { return w % nW; }
  __device__ __forceinline__ bool valid(int, int) const { return true; }
};

// Identity windows: token t of window w is row 64 w + t of (Bw, 64, C),
// window w sitting at place (w_off + w) mod nW of the image's windows.
struct WindowTokens {
  int H, W, s, w_off, nW;
  __device__ WindowTokens(int H_, int W_, int s_, int w_off_)
      : H(H_), W(W_), s(s_), w_off(w_off_), nW((H_ / 8) * (W_ / 8)) {}
  __device__ __forceinline__ int pix(int w, int t) const {
    return w * 64 + t;
  }
  __device__ __forceinline__ int place(int w) const {
    return (w_off + w) % nW;
  }
  __device__ __forceinline__ bool valid(int, int) const { return true; }
};

// Packed windows of N = win^2 < 64 tokens (win 1-7): work item w is a
// 64-row tile of G = 64 / N whole windows, rows w G N + t (t < G N) of the
// (Bw N, C) rows; window i lies at place (w_off + i) mod nW of its image
// (nW = (H / win) (W / win)). Rows G N .. 63 of a tile, and windows past
// Bw, are padding: read as zeros, never written. The bias of the tile
// (the host's tile bias) is -inf between two windows, so a window's rows
// weigh only its own keys.
struct PackedTokens {
  int H, W, s, w_off, nW, win, N, G, rows;
  __device__ PackedTokens(int H_, int W_, int s_, int w_off_, int win_,
                          int Bw)
      : H(H_), W(W_), s(s_), w_off(w_off_),
        nW((H_ / win_) * (W_ / win_)), win(win_), N(win_ * win_),
        G(64 / (win_ * win_)), rows(Bw * win_ * win_) {}
  __device__ __forceinline__ int pix(int w, int t) const {
    return w * G * N + t;
  }
  __device__ __forceinline__ bool valid(int w, int t) const {
    return t < G * N && w * G * N + t < rows;
  }
  // the region id (0..8) of row t of tile w in its own window
  __device__ __forceinline__ int region(int w, int t) const {
    const int i = w * G + t / N, tt = t % N;
    const int wl = (w_off + i) % nW, nWw = W / win;
    return 3 * region_id_w((wl / nWw) * win + tt / win, H, s, win) +
           region_id_w((wl % nWw) * win + tt % win, W, s, win);
  }
};

// The SW-MSA mask bits of window_mask_bits for a packed tile: every row
// and key by its own window's region ids (pairs of two windows carry -inf
// in the tile bias already).
__device__ __forceinline__ uint32_t window_mask_bits(const PackedTokens& tok,
                                                     int w, int ta, int tb,
                                                     int t4) {
  if (!tok.s) return 0u;
  const int ra = tok.region(w, ta), rb = tok.region(w, tb);
  uint32_t mask = 0u;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int rk = tok.region(w, 8 * j + 2 * t4 + e);
      mask |= (uint32_t)(rk != ra) << (4 * j + e);
      mask |= (uint32_t)(rk != rb) << (4 * j + 2 + e);
    }
  return mask;
}

// The SW-MSA mask of this lane's rows (ta, tb) of window w under the
// token map tok: bit 4 j + 2 hh + e is set where key 8 j + 2 (lane % 4) + e
// lies in another region than row (ta, tb)[hh] (window_region's ids);
// 0 when unshifted.
template <typename Tokens>
__device__ __forceinline__ uint32_t window_mask_bits(const Tokens& tok, int w,
                                                     int ta, int tb, int t4) {
  if (!tok.s) return 0u;
  const int wl = tok.place(w), nWw = tok.W / 8;
  const int gr = (wl / nWw) * 8, gc = (wl % nWw) * 8;
  // only the last row and column of windows hold more than one region
  if (gr < tok.H - 8 && gc < tok.W - 8) return 0u;
  auto rid = [&](int t) {
    return 3 * region_id(gr + t / 8, tok.H, tok.s) +
           region_id(gc + t % 8, tok.W, tok.s);
  };
  const int ra = rid(ta), rb = rid(tb);
  uint32_t mask = 0u;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int rk = rid(8 * j + 2 * t4 + e);
      mask |= (uint32_t)(rk != ra) << (4 * j + e);
      mask |= (uint32_t)(rk != rb) << (4 * j + 2 + e);
    }
  return mask;
}

// The core for the calling warp's rows r0 .. r0 + 15 of one window and
// head. qa: those rows of q as D / 16 A fragments (D = 8: one m16k8
// fragment, QK^T then on m16n8k8); ks, vs: the window's
// 64 x D k and v (bf16, leading dim ldk) in shared memory; bias: row r0
// of the head's fp32 (64, 64) bias (leading dim ldb), in shared memory,
// or with kLdg in device memory, read through the read-only cache; mask:
// window_mask_bits of rows (r0 + lane / 4, + 8). Returns O in the fp32
// accumulator layout: o[n][0..1] at row r0 + lane / 4, columns
// 8 n + 2 (lane % 4) + {0, 1}, o[n][2..3] eight rows on.
template <int D, bool kLdg>
__device__ __forceinline__ void window_core_mma(
    float (&o)[D / 8][4], const uint32_t (&qa)[frags_k(D)][4],
    const bf16* ks, const bf16* vs, int ldk, const float* bias, int ldb,
    uint32_t mask, float scale) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, t4 = lane & 3;
  uint32_t pa[4][4];
  {
    float s[8][4];
    zero_acc(s);
    if constexpr (D == 8)
      warp_mma_ra8<8, true>(s, qa[0], ks, ldk);
    else
      warp_mma_ra<8, D / 16, true>(s, qa, ks, ldk);
    float m[2] = {-FLT_MAX, -FLT_MAX};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int col = 8 * j + 2 * t4;
        const float* src = bias + (gq + 8 * hh) * ldb + col;
        const float2 bb = kLdg ? __ldg(reinterpret_cast<const float2*>(src))
                               : *reinterpret_cast<const float2*>(src);
        s[j][2 * hh] = fmaf(s[j][2 * hh], scale, bb.x);
        s[j][2 * hh + 1] = fmaf(s[j][2 * hh + 1], scale, bb.y);
      }
    if (mask)  // a window of the last row or column, shifted
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (mask >> (4 * j + e) & 1u) s[j][e] -= 100.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        m[hh] = fmaxf(m[hh], fmaxf(s[j][2 * hh], s[j][2 * hh + 1]));
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      m[hh] = fmaxf(m[hh], __shfl_xor_sync(0xffffffffu, m[hh], 1));
      m[hh] = fmaxf(m[hh], __shfl_xor_sync(0xffffffffu, m[hh], 2));
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m[e >> 1]);
        sum[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 1);
      sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 2);
      sum[hh] = 1.0f / sum[hh];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= sum[e >> 1];
    acc_to_a(s, pa);
  }
  zero_acc(o);
  warp_mma_ra<D / 8, 4>(o, pa, vs, ldk);
}

}  // namespace uf
