// Backward of one 8x8 window of the LeWin attention sub-block, computed by
// one thread block from its 64 gathered tokens, for head dim D in {8, 16,
// 32, 64} in fp32: the exact-check path (bf16 runs attention_bwd_mma.cuh,
// the same function on mma.sync tiles); for D in {24, 40, 48, 56} in
// fp32 and bf16 (attention_bwd_heads.cu, a translation unit of its own);
// and for head dims 72-128 in steps of 8 in fp32 and bf16
// (attention_bwd_big_heads.cu, its own unit): the body of width D in {80,
// 96, 112, 128} takes the head dim C / nH (D or D - 8) at run time, as the
// forward's attention_window.cuh does.
// attention_bwd.cu runs it on the image layout (tokens gathered at the
// shifted coordinates); attention_block_bwd.cu on (Bw, 64, C) windows with
// the identity token map, and attention_block_bwd_packed.cu on 64-row
// tiles of 64 / N whole windows of N = win^2 < 64 tokens.
//
// In bf16 the products run on WMMA fragments 16 wide: a head of 24, 40
// or 56 takes them 16 wide rounded up over zero pad columns (its q, k, v
// and dO tiles, dO copied per head into an aligned tile of its own), and
// every weight (and the window's [dq | dk | dv] rows for dxm) goes
// through shared memory in zero-padded chunks of kBwdChunk rows, so a C of
// 8 mod 16 (24, 40, 56) needs no fragment past its end. The rounding
// points are attention_bwd_mma.cuh's, which are JAX's: dO, q, k, v, P and
// dP rounded to bf16, dS in fp32 (as two bf16 halves into its products),
// and dxm kept in fp32 for dmod, dln_s / dln_b and the LayerNorm VJP: in
// shared memory over the dead xm and dO tiles where both fit there, else
// in the window's slot of part_dxm (uf_attention_bwd_scratch's bit 2).
//
// Head dims 72-128: [q | k | v] and [dq | dk | dv] of one head in a
// 64 x 3D accumulator, beside the staged chunk and the q, k, v, dO tiles,
// would need about 262 KB in bf16 at D 128 (the 64 x 3D fp32 accumulator
// alone 99 KB), over the 227 KB a block has. So, as the forward, the body
// keeps one 64 x D accumulator and makes q, k and v (each over its own
// staged chunks of the weight) and then dq, dk and dv in turn, each of the
// latter written to dqkv_w as it is made; xm, dO and bf16's fp32 dxm go to
// their global slots (x_scratch, do_scratch, part_dxm) where they miss
// shared memory. A head of 72, 88, 104 or 120 runs the next multiple of 16
// with zero columns hd..D-1 in q, k, v, dO and the staged chunks (exact),
// and writes only its hd true columns of dqkv_w, o_img and, through them,
// every gradient: a write at the padded width would land in the next
// head's columns. In fp32 dS has no low half (it is 0), and P and its
// fp32 copy share one tile, which leaves room for dO's head tile.
//
// A padding row of a tile (pix -1) reads x = g = 0 and is never written:
// its dO, dS and so its dq, dk, dv and dxm are exactly 0, and a real row's
// softmax weight on it is exactly 0 (the tile bias is -inf between
// windows), so it adds nothing to any gradient.
//
// Forward (recomputed here from x, as the TPU kernel does):
//   xm = LN1(x) + mod; q = (xm Wq + bq) * scale; k, v = xm Wkv + bkv;
//   P = softmax(q k^T + bias + mask) (fp32); O = P v; y = O Wo + bo [+ x]
// Backward, with g = dL/dy:
//   dO = g Wo^T; per head dP = dO v^T, dS = P (dP - rowsum(dP P)),
//   dv = P^T dO, dq = dS k * scale, dk = dS^T q; dxm = dq Wq^T + dkv Wkv^T;
//   dx = LN1 VJP(dxm) [+ g].
// Per token the window writes what the weight gradients need (xm and
// [dq | dk | dv] in window order, O at its token's row); per window its
// share of dbias (dS), dmod (dxm) and dln_s / dln_b. wgrad.cuh sums them.
#pragma once

#include "attention_window.cuh"
#include "window_core_mma.cuh"

namespace uf {

template <typename T>
struct AttnBwdParams {
  const T* x;          // (B, H, W, C) block input, or (Bw, 64, C) windows
  const T* g;          // gradient of the output, x's shape
  const T* mod;        // (64, C) or null
  const float* ln_s;   // (C,)
  const float* ln_b;   // (C,)
  const T* wq;         // (C, C) (in, out)
  const float* bq;     // (C,)
  const T* wkv;        // (C, 2C) [k | v]
  const float* bkv;    // (2C,)
  const T* wo;         // (C, C)
  const float* bias;   // (nH, 64, 64)
  T* dx;               // x's shape
  T* xm_w;             // (windows * 64, C) xm, window order
  T* dqkv_w;           // (windows * 64, 3C) [dq | dk | dv], window order
  T* o_img;            // x's shape: head outputs at their tokens' rows
  float* dbias_part;   // (windows, nH * 4096)
  float* dmod_part;    // (windows, 64 * C), or null without mod
  float* dln_part;     // (windows, 2C): dln_s then dln_b, or null
  T* x_scratch;        // (windows, 64, C) when xm misses shared memory
  T* do_scratch;       // (windows, 64, C) when dO misses shared memory
  float* part_dxm;     // (groups, windows, 64, C) fp32 dxm shares, bf16
                       // with a window's heads split over blocks
  int B, H, W, C, nH, shift;
  float scale;
  int has_ln, residual;
  int win, n_win;      // packed tiles: the window, and the Bw windows
};

constexpr int kBwdChunk = 64;  // bf16: K rows of a staged operand chunk

template <int D>
struct AttnBwdLayout {
  // head dims 72-128: one 64 x D accumulator, q, k, v and dq, dk, dv in turn
  static constexpr bool kBig = attn_big_head(D);
  static constexpr int kD16 = (D + 15) / 16 * 16;  // a bf16 head's products
  // the widest accumulator: [q | k | v], or one of them at head dims 72-128
  static constexpr int kQKV = kBig ? kD16 : (3 * kD16 > 64 ? 3 * kD16 : 64);
  static constexpr int ldq = D + 8, ldp = 72, ldsp = kBig ? ldp : 68,
                       ldacc = kQKV + 4;
  // bf16 staging: [q | k | v] head columns (kBwdChunk x 3 kD16; one of
  // them at head dims 72-128), or the two operands of a dO or dxm product
  // (64 x kBwdChunk each)
  static constexpr int ldw = (kBig ? kD16 : 3 * kD16) + 8,
                       lds = kBwdChunk + 8;
  static constexpr size_t kStage =
      kBwdChunk * ldw > 2 * 64 * lds ? kBwdChunk * ldw : 2 * 64 * lds;
  int ldx, ldd;
  size_t q, k, v, pt, sp, acc, pix, rid, stats, dsh, dsl, dh, w, x, dO,
      total;
  bool x_smem, do_smem;
  // bf16: the fp32 dxm over the xm and dO tiles (else in part_dxm)
  __host__ __device__ bool dxm_smem(int ts) const {
    return ts == 2 && x_smem && do_smem;
  }
};

template <int D>
__host__ __device__ inline AttnBwdLayout<D> attn_bwd_layout(int ts, int C) {
  using L_ = AttnBwdLayout<D>;
  L_ L;
  Carver cv;
  L.q = cv.take(64 * L_::ldq * ts);
  L.k = cv.take(64 * L_::ldq * ts);
  L.v = cv.take(64 * L_::ldq * ts);
  L.pt = cv.take(64 * L_::ldp * ts);
  // fp32 at head dims 72-128: P is its own fp32 copy
  const bool f32_big = L_::kBig && ts == 4;
  L.sp = f32_big ? L.pt : cv.take(64 * L_::ldsp * sizeof(float));
  L.acc = cv.take(64 * L_::ldacc * sizeof(float));
  L.pix = cv.take(64 * sizeof(int));
  L.rid = cv.take(64 * sizeof(int));
  L.stats = cv.take(128 * sizeof(float));
  // dS as the sum of two values of T (in fp32 the second is 0, and at
  // head dims 72-128 not stored)
  L.dsh = cv.take(64 * L_::ldp * ts);
  L.dsl = f32_big ? 0 : cv.take(64 * L_::ldp * ts);
  // the head's dO tile (bf16, and fp32 at head dims 72-128, zero past the
  // head's columns) and bf16's staged operand chunks
  L.dh = ts == 2 || L_::kBig ? cv.take(64 * L_::ldq * ts) : 0;
  L.w = ts == 2 ? cv.take(L_::kStage * ts) : 0;
  // the token tile (xm, later dxm) and dO: in shared memory when they
  // fit, else in a global slot per window (row stride C); X and dO
  // adjacent, so that bf16's fp32 dxm (64 x (C + 4)) fits over both
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

// The parameters of one backward launch, from a C entry's arguments (the
// order of uf_attention_bwd and uf_attention_block_bwd).
template <typename T>
AttnBwdParams<T> attn_bwd_params(
    const void* x, const void* g, const void* mod, const float* ln_s,
    const float* ln_b, const void* wq, const float* bq, const void* wkv,
    const float* bkv, const void* wo, const float* bias, void* dx,
    void* xm_w, void* dqkv_w, void* o_img, float* dbias_part,
    float* dmod_part, float* dln_part, void* x_scratch, void* do_scratch,
    float* part_dxm, int B, int H, int W, int C, int nH, int shift,
    float scale, int has_ln, int residual) {
  AttnBwdParams<T> p;
  p.x = static_cast<const T*>(x);
  p.g = static_cast<const T*>(g);
  p.mod = static_cast<const T*>(mod);
  p.ln_s = ln_s;
  p.ln_b = ln_b;
  p.wq = static_cast<const T*>(wq);
  p.bq = bq;
  p.wkv = static_cast<const T*>(wkv);
  p.bkv = bkv;
  p.wo = static_cast<const T*>(wo);
  p.bias = bias;
  p.dx = static_cast<T*>(dx);
  p.xm_w = static_cast<T*>(xm_w);
  p.dqkv_w = static_cast<T*>(dqkv_w);
  p.o_img = static_cast<T*>(o_img);
  p.dbias_part = dbias_part;
  p.dmod_part = dmod_part;
  p.dln_part = dln_part;
  p.x_scratch = static_cast<T*>(x_scratch);
  p.do_scratch = static_cast<T*>(do_scratch);
  p.part_dxm = part_dxm;
  p.B = B;
  p.H = H;
  p.W = W;
  p.C = C;
  p.nH = nH;
  p.shift = shift;
  p.scale = scale;
  p.has_ln = has_ln;
  p.residual = residual;
  p.win = 8;
  p.n_win = 0;
  return p;
}

// bf16: acc[64 x N16] (+)= A[64 x K] B^T with B an N x K row-major block
// (ldb) of a weight, A 64 rows (lda) in shared or device memory: both
// staged in chunks of kBwdChunk columns into `stage` (64 x lds each),
// zero to N16 rows of B and to the chunk's depth rounded up to 16, so
// that no fragment reads past either (K, N and the pointers any multiple
// of 8 entries). The first chunk overwrites acc unless `accum`. All
// threads call it; it synchronises before returning.
template <int lds>
__device__ void staged_product_nt(const bf16* A, int lda, const bf16* B,
                                  int ldb, int N, int K, float* acc, int ldc,
                                  bf16* stage, bool accum) {
  bf16* as = stage;
  bf16* bs = stage + 64 * lds;
  const int N16 = (N + 15) & ~15;
  for (int kc = 0; kc < K; kc += kBwdChunk) {
    const int kr = min(kBwdChunk, K - kc), kr16 = (kr + 15) & ~15;
    stage_tile<bf16>(as, lds, A + kc, lda, 64, kr);
    stage_tile<bf16>(bs, lds, B + kc, ldb, N, kr);
    zero_pad<bf16>(as, lds, 64, kr16, 64, kr);
    zero_pad<bf16>(bs, lds, N16, kr16, N, kr);
    __syncthreads();
    if (kc == 0 && !accum)
      block_gemm<bf16, true, false>(as, lds, bs, lds, acc, ldc, 64, N16,
                                    kr16);
    else
      block_gemm<bf16, true, true>(as, lds, bs, lds, acc, ldc, 64, N16,
                                   kr16);
    __syncthreads();
  }
}

// Backward of window `w`. pix[t] is the row of token t in x, g, dx and
// o_img, or -1 for a padding row; rid[t] its SW-MSA region id (all 0 when
// unshifted). Both live in the layout's pix / rid slots, filled and
// synchronised by the caller.
// The block has kThreads threads. fp32 at every D (FMA products); bf16 at
// D 24-56 and 80-128 (WMMA products through staged operands, the header's
// rounding points), where a C of 8 mod 16 keeps the xm tile in shared
// memory. At D 80-128 the head dim is C / nH (D, or D - 8 over zero
// columns) and q, k, v and dq, dk, dv are made in turn.
template <typename T, int D>
__device__ void attention_window_bwd(const AttnBwdParams<T>& p, int w,
                                     unsigned char* smem) {
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  using L_ = AttnBwdLayout<D>;
  const L_ L = attn_bwd_layout<D>(sizeof(T), p.C);
  const int C = p.C, C3 = 3 * p.C;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr int ldq = L_::ldq, ldp = L_::ldp, ldsp = L_::ldsp,
                lda = L_::ldacc, ldw = L_::ldw, lds = L_::lds;
  constexpr int DP = padded_head<T, D>();  // the products' head width
  // 16x16 tiles of a 64 x D head tile: products issued back to back start
  // on different warps
  constexpr int kHeadTiles = 4 * (DP / 16);
  constexpr bool kBig = L_::kBig;
  constexpr bool kLo = kBf16 || !kBig;  // dS's low half is stored
  const int hd = kBig ? C / p.nH : D;   // the true head dim
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
  T* dh = reinterpret_cast<T*>(smem + L.dh);     // the head's dO
  T* wst = reinterpret_cast<T*>(smem + L.w);     // bf16: staged chunks
  T* X = L.x_smem ? reinterpret_cast<T*>(smem + L.x)
                  : p.x_scratch + (size_t)w * 64 * C;
  T* DO = L.do_smem ? reinterpret_cast<T*>(smem + L.dO)
                    : p.do_scratch + (size_t)w * 64 * C;
  const int ldx = L.ldx, ldd = L.ldd;

  // dO = g Wo^T, in 64-column chunks; X holds the gathered g meanwhile
  for (int idx = tid; idx < 64 * C; idx += blockDim.x) {
    const int t = idx / C, c = idx % C;
    X[t * ldx + c] =
        pix[t] >= 0 ? p.g[(size_t)pix[t] * C + c] : from_f<T>(0.f);
  }
  if (kBf16 && C % 16)  // columns C..C+7 of X: the products' zero pad
    zero_pad<T>(X, ldx, 64, C + 8, 64, C);
  __syncthreads();
  for (int n0 = 0; n0 < C; n0 += 64) {
    const int nn = min(64, C - n0);
    if constexpr (kBf16)
      staged_product_nt<lds>(X, ldx, p.wo + (size_t)n0 * C, C, nn, C, acc,
                             lda, wst, false);
    else
      block_gemm<T, true, false>(X, ldx, p.wo + (size_t)n0 * C, C, acc, lda,
                                 64, nn, C);
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
    X[t * ldx + c] =
        pix[t] >= 0 ? p.x[(size_t)pix[t] * C + c] : from_f<T>(0.f);
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
    const int c0 = h * hd;
    if constexpr (kBig) {
      // q, k and v in turn into acc's first D columns (bf16: each over its
      // own staged chunks, zero to D columns and 16-row depths), rounded
      // into their tiles with zero columns from hd; the head's dO beside
      for (int m = 0; m < 3; ++m) {
        const T* wm = m == 0 ? p.wq : p.wkv + (m - 1) * C;
        const int ldm = m == 0 ? C : 2 * C;
        const float* bm = m == 0 ? p.bq : p.bkv + (m - 1) * C;
        const float sc = m == 0 ? p.scale : 1.0f;
        T* dst = m == 0 ? q : (m == 1 ? k : v);
        if constexpr (kBf16) {
          for (int kc = 0; kc < C; kc += kBwdChunk) {
            const int kr = min(kBwdChunk, C - kc), kr16 = (kr + 15) & ~15;
            stage_tile<T>(wst, ldw, wm + (size_t)kc * ldm + c0, ldm, kr, hd);
            zero_pad<T>(wst, ldw, kr16, D, kr, hd);
            __syncthreads();
            if (kc == 0)
              block_gemm<T, false, false>(X, ldx, wst, ldw, acc, lda, 64, D,
                                          kr16);
            else
              block_gemm<T, false, true>(X + kc, ldx, wst, ldw, acc, lda,
                                         64, D, kr16);
            __syncthreads();
          }
        } else {
          block_gemm<T, false, false>(X, ldx, wm + c0, ldm, acc, lda, 64, hd,
                                      C);
          __syncthreads();
        }
        for (int idx = tid; idx < 64 * D; idx += blockDim.x) {
          const int t = idx / D, d = idx % D;
          dst[t * ldq + d] =
              d < hd ? from_f<T>((acc[t * lda + d] + bm[c0 + d]) * sc)
                     : from_f<T>(0.f);
          if (m == 0)
            dh[t * ldq + d] = d < hd ? DO[t * ldd + c0 + d] : from_f<T>(0.f);
        }
        __syncthreads();
      }
    } else if constexpr (kBf16) {
      // [q | k | v] = xm [Wq | Wk | Wv][:, head], the weights' head
      // columns staged in chunks of kBwdChunk rows (the forward's
      // attention_window.cuh), zero to DP columns and 16-row depths
      for (int kc = 0; kc < C; kc += kBwdChunk) {
        const int kr = min(kBwdChunk, C - kc), kr16 = (kr + 15) & ~15;
        stage_tile<T>(wst, ldw, p.wq + (size_t)kc * C + c0, C, kr, D);
        stage_tile<T>(wst + DP, ldw, p.wkv + (size_t)kc * 2 * C + c0,
                      2 * C, kr, D);
        stage_tile<T>(wst + 2 * DP, ldw,
                      p.wkv + (size_t)kc * 2 * C + C + c0, 2 * C, kr, D);
        if constexpr (DP != D)
          for (int i = tid; i < kr16 * 3; i += blockDim.x)
            *reinterpret_cast<uint4*>(wst + (i / 3) * ldw + (i % 3) * DP +
                                      D) = make_uint4(0u, 0u, 0u, 0u);
        zero_pad<T>(wst, ldw, kr16, 3 * DP, kr, 3 * DP);
        __syncthreads();
        if (kc == 0)
          block_gemm<T, false, false>(X, ldx, wst, ldw, acc, lda, 64,
                                      3 * DP, kr16);
        else
          block_gemm<T, false, true>(X + kc, ldx, wst, ldw, acc, lda, 64,
                                     3 * DP, kr16);
        __syncthreads();
      }
    } else {
      block_gemm<T, false, false>(X, ldx, p.wq + c0, C, acc, lda, 64, D, C);
      block_gemm<T, false, false>(X, ldx, p.wkv + c0, 2 * C, acc + D, lda,
                                  64, D, C, kHeadTiles);
      block_gemm<T, false, false>(X, ldx, p.wkv + C + c0, 2 * C,
                                  acc + 2 * D, lda, 64, D, C,
                                  2 * kHeadTiles);
      __syncthreads();
    }
    if constexpr (!kBig) {
      for (int idx = tid; idx < 64 * D; idx += blockDim.x) {
        const int t = idx / D, d = idx % D;
        q[t * ldq + d] =
            from_f<T>((acc[t * lda + d] + p.bq[c0 + d]) * p.scale);
        k[t * ldq + d] = from_f<T>(acc[t * lda + DP + d] + p.bkv[c0 + d]);
        v[t * ldq + d] =
            from_f<T>(acc[t * lda + 2 * DP + d] + p.bkv[C + c0 + d]);
        if constexpr (kBf16) dh[t * ldq + d] = DO[t * ldd + c0 + d];
      }
      if constexpr (DP != D)  // zero pad columns: exact 16-wide products
        for (int t = tid; t < 64; t += blockDim.x) {
          *reinterpret_cast<uint4*>(q + t * ldq + D) = make_uint4(0, 0, 0, 0);
          *reinterpret_cast<uint4*>(k + t * ldq + D) = make_uint4(0, 0, 0, 0);
          *reinterpret_cast<uint4*>(v + t * ldq + D) = make_uint4(0, 0, 0, 0);
          *reinterpret_cast<uint4*>(dh + t * ldq + D) =
              make_uint4(0, 0, 0, 0);
        }
      __syncthreads();
    }
    block_gemm<T, true, false>(q, ldq, k, ldq, acc, lda, 64, 64, DP);
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
    block_gemm<T, false, false>(PT, ldp, v, ldq, acc, lda, 64, DP, 64);
    __syncthreads();
    for (int idx = tid; idx < 64 * hd; idx += blockDim.x) {
      const int t = idx / hd, d = idx % hd;
      if (pix[t] >= 0)
        p.o_img[(size_t)pix[t] * C + c0 + d] = from_f<T>(acc[t * lda + d]);
    }
    __syncthreads();
    // dP = dO_h v^T; dS = P (dP - rowsum(dP P)), fp32
    const T* doh = kBf16 || kBig ? dh : DO + c0;
    const int ldo = kBf16 || kBig ? ldq : ldd;
    block_gemm<T, true, false>(doh, ldo, v, ldq, acc, lda, 64, 64, DP);
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
      if constexpr (kLo) {
        DSl[t * ldp + lane] = from_f<T>(ds0 - to_f<T>(h0));
        DSl[t * ldp + lane + 32] = from_f<T>(ds1 - to_f<T>(h1));
      }
      dbias[t * 64 + lane] = ds0;
      dbias[t * 64 + lane + 32] = ds1;
    }
    __syncthreads();
    // d(q * scale) = dS k, dk = dS^T (q * scale), dv = P^T dO_h. dS goes
    // in as the sum of its two bf16 halves (hi + lo), so the products keep
    // about 17 bits of the fp32 dS on the tensor cores. Each lo product
    // starts on the warps of its hi product, whose tiles it accumulates.
    if constexpr (kBig) {
      // dq, dk and dv in turn into acc's first D columns, each written to
      // dqkv_w at the head's hd true columns as it is made
      for (int m = 0; m < 3; ++m) {
        if (m == 0) {
          block_gemm<T, false, false>(DSh, ldp, k, ldq, acc, lda, 64, DP, 64);
          if constexpr (kLo)
            block_gemm<T, false, true>(DSl, ldp, k, ldq, acc, lda, 64, DP,
                                       64);
        } else if (m == 1) {
          block_gemm<T, false, false, true>(DSh, ldp, q, ldq, acc, lda, 64,
                                            DP, 64);
          if constexpr (kLo)
            block_gemm<T, false, true, true>(DSl, ldp, q, ldq, acc, lda, 64,
                                             DP, 64);
        } else {
          block_gemm<T, false, false, true>(PT, ldp, doh, ldo, acc, lda, 64,
                                            DP, 64);
        }
        __syncthreads();
        for (int idx = tid; idx < 64 * hd; idx += blockDim.x) {
          const int t = idx / hd, d = idx % hd;
          const float a = acc[t * lda + d];
          dqkv[(size_t)t * C3 + m * C + c0 + d] =
              from_f<T>(m == 0 ? rnd<T>(a) * p.scale : a);
        }
        __syncthreads();
      }
    } else {
      block_gemm<T, false, false>(DSh, ldp, k, ldq, acc, lda, 64, DP, 64);
      block_gemm<T, false, false, true>(DSh, ldp, q, ldq, acc + DP, lda, 64,
                                        DP, 64, kHeadTiles);
      block_gemm<T, false, false, true>(PT, ldp, doh, ldo, acc + 2 * DP,
                                        lda, 64, DP, 64, 2 * kHeadTiles);
      block_gemm<T, false, true>(DSl, ldp, k, ldq, acc, lda, 64, DP, 64);
      block_gemm<T, false, true, true>(DSl, ldp, q, ldq, acc + DP, lda, 64,
                                       DP, 64, kHeadTiles);
      __syncthreads();
      for (int idx = tid; idx < 64 * D; idx += blockDim.x) {
        const int t = idx / D, d = idx % D;
        T* row = dqkv + (size_t)t * C3 + c0 + d;
        row[0] = from_f<T>(rnd<T>(acc[t * lda + d]) * p.scale);
        row[C] = from_f<T>(acc[t * lda + DP + d]);
        row[2 * C] = from_f<T>(acc[t * lda + 2 * DP + d]);
      }
      __syncthreads();
    }
  }

  // dxm = dq Wq^T + [dk | dv] Wkv^T, in 64-column chunks. fp32: rounded to
  // T into X for the LayerNorm VJP, as the plain path rounds it; bf16:
  // kept in fp32 (dxm32, over the dead xm and dO tiles or in part_dxm),
  // as attention_bwd_mma.cuh keeps it. The window's shares of dmod and
  // dln_s / dln_b from the fp32 dxm, as the TPU kernel sums its fp32
  // product (attention_block.py:746-750)
  const bool in_smem = L.dxm_smem(sizeof(T));
  float* dxm32 = in_smem ? reinterpret_cast<float*>(smem + L.x)
                         : p.part_dxm + (size_t)w * 64 * C;
  const int ldm = in_smem ? C + 4 : C;
  float* dln = p.dln_part ? p.dln_part + (size_t)w * 2 * C : nullptr;
  for (int n0 = 0; n0 < C; n0 += 64) {
    const int nn = min(64, C - n0);
    if constexpr (kBf16) {
      staged_product_nt<lds>(dqkv, C3, p.wq + (size_t)n0 * C, C, nn, C, acc,
                             lda, wst, false);
      staged_product_nt<lds>(dqkv + C, C3, p.wkv + (size_t)n0 * 2 * C,
                             2 * C, nn, 2 * C, acc, lda, wst, true);
    } else {
      block_gemm<T, true, false>(dqkv, C3, p.wq + (size_t)n0 * C, C, acc,
                                 lda, 64, nn, C);
      block_gemm<T, true, true>(dqkv + C, C3, p.wkv + (size_t)n0 * 2 * C,
                                2 * C, acc, lda, 64, nn, 2 * C);
      __syncthreads();
    }
    for (int idx = tid; idx < 64 * nn; idx += blockDim.x) {
      const int t = idx / nn, j = idx % nn;
      if constexpr (kBf16)
        dxm32[t * ldm + n0 + j] = acc[t * lda + j];
      else
        X[t * ldx + n0 + j] = from_f<T>(acc[t * lda + j]);
      if (p.dmod_part)
        p.dmod_part[(size_t)w * 64 * C + t * C + n0 + j] = acc[t * lda + j];
    }
    for (int j = tid; dln && j < nn; j += blockDim.x) {
      float ss = 0.f, sb = 0.f;
      for (int t = 0; t < 64; ++t) {
        if (pix[t] < 0) continue;
        const float dn = acc[t * lda + j];
        const float xh =
            (to_f<T>(p.x[(size_t)pix[t] * C + n0 + j]) - stats[2 * t]) *
            stats[2 * t + 1];
        ss = fmaf(dn, xh, ss);
        sb += dn;
      }
      dln[n0 + j] = ss;
      dln[C + n0 + j] = sb;
    }
    __syncthreads();
  }

  // LayerNorm VJP, one warp per token (bf16: on the fp32 dxm, the TPU
  // kernel's dtok, attention_block.py:751-755; without LN dx is the
  // rounded dxm); dx [+ g] back to its pixel
  for (int t = warp; t < 64; t += kWarps) {
    if (pix[t] < 0) continue;
    const size_t at = (size_t)pix[t] * C;
    const float mean = stats[2 * t], rstd = stats[2 * t + 1];
    auto dxm_at = [&](int c) {
      return kBf16 ? dxm32[t * ldm + c] : to_f<T>(X[t * ldx + c]);
    };
    float s1 = 0.f, s2 = 0.f;
    if (p.has_ln) {
      for (int c = lane; c < C; c += 32) {
        const float xh = (to_f<T>(p.x[at + c]) - mean) * rstd;
        const float dxh = dxm_at(c) * p.ln_s[c];
        s1 += dxh;
        s2 += dxh * xh;
      }
      s1 = warp_sum(s1) / C;
      s2 = warp_sum(s2) / C;
    }
    for (int c = lane; c < C; c += 32) {
      float d = rnd<T>(dxm_at(c));
      if (p.has_ln) {
        const float xh = (to_f<T>(p.x[at + c]) - mean) * rstd;
        d = rstd * (dxm_at(c) * p.ln_s[c] - s1 - xh * s2);
      }
      if (p.residual) d = rnd<T>(d) + to_f<T>(p.g[at + c]);
      p.dx[at + c] = from_f<T>(d);
    }
  }
}

// Kernel 6 one window (or packed tile) a block of attention_window_bwd
// (fp32 at every head dim; bf16 at 24-56 and 72-128): `map` 0 the image
// layout (the shifted 8x8 windows gathered from the NHWC image), 1 (Bw,
// 64, C) windows, 2 packed tiles of p.win (PackedTokens).
template <typename T, int D, int kMap>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_window_kernel(AttnBwdParams<T> p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const auto L = attn_bwd_layout<D>(sizeof(T), p.C);
  const int tid = threadIdx.x, w = blockIdx.x;
  const int H = p.H, W = p.W, s = p.shift;
  int* pix = reinterpret_cast<int*>(smem + L.pix);
  int* rid = reinterpret_cast<int*>(smem + L.rid);
  if (tid < 64) {
    if constexpr (kMap == 0) {
      const int nWw = W / 8, nW = (H / 8) * nWw;
      const int b = w / nW, wl = w % nW;
      const int gr = (wl / nWw) * 8 + tid / 8, gc = (wl % nWw) * 8 + tid % 8;
      pix[tid] = (b * H + (gr + s) % H) * W + (gc + s) % W;
      rid[tid] = window_region(wl, tid, H, W, s);
    } else if constexpr (kMap == 1) {
      pix[tid] = w * 64 + tid;
      rid[tid] = window_region(w % ((H / 8) * (W / 8)), tid, H, W, s);
    } else {
      const PackedTokens tok(H, W, s, 0, p.win, p.n_win);
      pix[tid] = tok.valid(w, tid) ? tok.pix(w, tid) : -1;
      rid[tid] = s ? tok.region(w, tid) : 0;
    }
  }
  __syncthreads();
  attention_window_bwd<T, D>(p, w, smem);
}

// Launches attention_bwd_window_kernel on `windows` blocks (windows or
// packed tiles) in token map `map`; 0 or a cudaError_t.
template <typename T, int D>
int launch_attn_bwd_window(const AttnBwdParams<T>& p, int windows, int map,
                           cudaStream_t stream) {
  const auto L = attn_bwd_layout<D>(sizeof(T), p.C);
  // a C of 8 mod 16 reads the xm tile's zero pad columns: shared memory
  if (sizeof(T) == 2 && p.C % 16 && !L.x_smem)
    return (int)cudaErrorInvalidValue;
  const auto kernel = map == 0   ? attention_bwd_window_kernel<T, D, 0>
                      : map == 1 ? attention_bwd_window_kernel<T, D, 1>
                                 : attention_bwd_window_kernel<T, D, 2>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (e != cudaSuccess) return (int)e;
  kernel<<<windows, kThreads, L.total, stream>>>(p);
  return (int)cudaGetLastError();
}

// launch_attn_bwd_window at head dim C / nH in 8, 16, 32, 64 (fp32, the
// exact-check path of attention_bwd.cu, attention_block_bwd.cu and
// attention_block_bwd_packed.cu).
template <typename T>
int launch_attn_bwd(const AttnBwdParams<T>& p, int windows, int map,
                    cudaStream_t stream) {
  return with_head_dim(p.C, p.nH, [&](auto d) {
    return launch_attn_bwd_window<T, decltype(d)::value>(p, windows, map,
                                                         stream);
  });
}

// The one-window body's scratch needs at (dtype size ts, C): bits 0 and 1
// the xm and dO tiles miss shared memory (a (windows, 64, C) scratch of
// the input's dtype each), bit 2 (bf16) the fp32 dxm goes to part_dxm.
template <int D>
int attn_bwd_window_scratch(int ts, int C) {
  const auto L = attn_bwd_layout<D>(ts, C);
  return (L.x_smem ? 0 : 1) | (L.do_smem ? 0 : 2) |
         (ts == 2 && !L.dxm_smem(ts) ? 4 : 0);
}

// Kernel 6 at head dims 24, 40, 48 and 56 (is_new_head_dim) by
// launch_attn_bwd_window, in `map` (attention_bwd_heads.cu); its scratch
// needs as uf_attention_bwd_scratch returns them.
template <typename T>
int attention_bwd_heads(const AttnBwdParams<T>& p, int windows, int map,
                        cudaStream_t stream);
int attention_bwd_heads_scratch(int ts, int C, int nH);

// The same at head dims 72-128, multiples of 8 (is_big_head_dim), on the
// body of width (C / nH) rounded up to 16 (attention_bwd_big_heads.cu).
template <typename T>
int attention_bwd_big_heads(const AttnBwdParams<T>& p, int windows, int map,
                            cudaStream_t stream);
int attention_bwd_big_heads_scratch(int ts, int C, int nH);

}  // namespace uf
