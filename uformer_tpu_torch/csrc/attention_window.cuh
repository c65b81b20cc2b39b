// One 8x8 window of the LeWin attention sub-block, computed by one thread
// block, for head dim D in {8, 16, 32, 64} (both ways) and, forward only,
// {24, 40, 48, 56} (stage.cu and attention_block.cu through
// with_new_head_dim, each in its own translation unit) and 72-128 in
// steps of 8 (with_big_head_dim: the body of width D in {80, 96, 112,
// 128} takes the head dim C / nH, D or D - 8, at run time). Shared by
// attention_image.cu (one window per block), stage.cu (a persistent block
// walks many windows) and attention_block.cu (one window, or one packed
// tile of windows of N = win^2 < 64 tokens, per block, windows already
// partitioned). In fp32 the stage runs it only at head dims 8, 24-56 and
// 64 and at C 1024: at C 64-512, head dims 16 and 32, its fp32 attention
// is attention_f32.cuh's (three-pass TF32 on the tensor cores).
//
// WMMA fragments are 16 wide: a bf16 head of 8, 24, 40 or 56 takes its
// products 16 wide rounded up, columns D..D+7 of q, k, v and of the
// staged weights zero (exact), and needs staged weights; fp32's FMA
// products take any D. WMMA has no bf16 k8 shape (m16n8k8 is mma.sync's,
// which these block-wide products do not use), so a product whose depth
// is 8 mod 16 (a head of 24-56, or C 24, 40, 56) takes a zero pad to the
// next 16 rather than a k8 tail.
//
//   y = [x +] tokens^-1(proj(W-MSA(LN1(tokens(x)) + mod)))
//
// The body has three parts:
//   (a) the token map (`window_tokens`): either the NHWC image read at the
//       shifted coordinates ((r + s) mod H, (c + s) mod W), so that shift,
//       partition, reverse and unshift cost nothing and shifted windows
//       partition the image (no halo, no write race); or identity windows,
//       token t of item i being row i*64 + t of a (Bw, 64, C) tensor. Both
//       give the SW-MSA region ids of the window's place in the image;
//   (b) LN1 + modulator and, per head, the q/k/v projections, the softmax
//       scale folded into q before it is rounded;
//   (c) the window core (window_core.cuh), then the output projection.
//
// In bf16 at C % 128 == 0 the weights go through shared memory: per head,
// 128-row chunks of the q, k and v columns (then 128 x 64 chunks of wo)
// are copied with 16-byte loads and the products read them from there.
// Read fragment by fragment from L2, each 16-deep k-step waited a full
// round trip, which bounded the projections at C >= 128. Head dims 24,
// 40 and 56 and C 8 mod 16 (no whole fragment in device memory) stage
// them too, at any C: the last chunk's rows past C, up to the next 16,
// and xm's and O's columns C..C+7 are zero.
//
// Head dims 72-128 (an --embed_dim 72-128 model: C 72-2048): the three
// 64 x D accumulators of q, k and v would not fit beside the staged
// chunk and the q, k, v tiles (about 260 KB in bf16 at D 128), so the
// body projects q, k and v in turn into one 64 x D accumulator, each over
// its own staged chunks (128 x D) of the weight; a head of 72, 88, 104 or
// 120 runs the next multiple of 16, its columns hd..D-1 of q, k, v and of
// the staged chunks zero (exact in both dtypes; fp32 reads its weights
// from device memory over the hd true columns). The softmax scale is the
// host's, of the true head dim.
//
// The 64 x C tiles of the LN1 output (xm) and of the concatenated head
// outputs (O) stay in shared memory where they fit beside the working
// set, xm first (every head's three projections read it, O only the
// output projection); otherwise each goes to the block's slot of the
// scratch tensor in device memory (L2), read there by the same products:
// at head dim 64, fp32 from C = 256 (O) and 512 (xm), bf16 from C = 512
// (O) and 1024 (xm: an --embed_dim 64 model's bottleneck and dec0); at
// head dims 72-128 O from C 448-768 and xm from C 1024-1792 in bf16, O
// from C 224-384 and xm from C 448-768 in fp32.
#pragma once

#include "window_core.cuh"

namespace uf {

template <typename T>
struct AttnParams {
  const T* x;        // (B, H, W, C) block input, or (Bw, 64, C) windows
  T* y;              // same shape as x, never aliases it
  const T* mod;      // (64, C) modulator, or null
  const float* ln_s; // (C,)
  const float* ln_b; // (C,)
  const T* wq;       // (C, C)   (in, out)
  const float* bq;   // (C,)
  const T* wk;       // (C, C) rows of stride ldkv: the k half of [k | v]
  const T* wv;       // (C, C) rows of stride ldkv: the v half
  const float* bk;   // (C,)
  const float* bv;   // (C,)
  const T* wo;       // (C, C)
  const float* bo;   // (C,)
  const float* bias; // (nH, 64, 64) relative-position bias
  T* o_scratch;      // (slots, 64 r, C): O and xm where they miss smem,
                     // r = AttnLayout::regions() of them
  int ldkv;          // 2C for one (C, 2C) [k | v] matrix, C for split ones
  int B, H, W, C, nH, shift;
  float scale;
  int has_ln, residual;
  int windows;       // token map: 0 the image, 1 identity windows
  int w_off;         // identity windows: image index of window 0
  int win, n_win;    // packed tiles: the window, and the Bw windows
};

// Whether bf16 stages the weights in shared memory: C a multiple of the
// 128-row chunk, or a head of 24, 40 or 56 or a C of 8 mod 16, which no
// whole 16-wide fragment of a device-memory weight covers (their chunks
// then carry zero pads).
__host__ __device__ constexpr bool attn_stage_w(int C, int D) {
  return C % 128 == 0 || (D > 8 && D % 16) || C % 16 || D > 64;
}

// Whether the body of width D takes its head dim at run time and
// projects q, k and v in turn (head dims 72-128).
__host__ __device__ constexpr bool attn_big_head(int D) { return D > 64; }

// Shared-memory layout of one window's working set.
template <int D>
struct AttnLayout {
  static constexpr int kD16 = (D + 15) / 16 * 16;  // a bf16 head's products
  // the widest accumulator: [q | k | v], or one of them at head dims 72-128
  static constexpr int kQKV = attn_big_head(D) ? kD16
                              : (3 * kD16 > 64 ? 3 * kD16 : 64);
  static constexpr int ldq = D + 8, ldp = 72, ldacc = kQKV + 4;
  static constexpr int kWChunk = 128, ldw = kQKV + 8;  // staged weights
  int ldx, ldo;
  size_t xm, q, k, v, p, acc, pix, rid, w, o, total;
  bool w_smem, x_smem, o_smem;
  // 64 x C tiles a scratch slot holds: xm and O where they miss smem
  __host__ __device__ int regions() const { return !x_smem + !o_smem; }
};

template <int D>
__host__ __device__ inline AttnLayout<D> attn_layout(int tsize, int C) {
  using L_ = AttnLayout<D>;
  L_ L;
  Carver cv;
  L.q = cv.take(64 * L_::ldq * tsize);
  L.k = cv.take(64 * L_::ldq * tsize);
  L.v = cv.take(64 * L_::ldq * tsize);
  L.p = cv.take(64 * L_::ldp * tsize);
  L.acc = cv.take(64 * L_::ldacc * sizeof(float));
  L.pix = cv.take(64 * sizeof(int));
  L.rid = cv.take(64 * sizeof(int));
  // staged weights: [q | k | v] head columns (kWChunk x 3D; one of them,
  // kWChunk x D, at head dims 72-128) or a wo chunk (kWChunk x 64), at
  // most C rounded up to 16 rows; bf16 where
  // attn_stage_w says so
  L.w_smem = tsize == 2 && attn_stage_w(C, D);
  const int w_rows = C < L_::kWChunk ? (C + 15) / 16 * 16 : L_::kWChunk;
  L.w = L.w_smem ? cv.take((size_t)w_rows * L_::ldw * tsize) : 0;
  // xm, then the concatenated head outputs, in shared memory where they
  // fit (both for bf16 up to C = 512); otherwise in the scratch slot
  const size_t t_bytes = (size_t)64 * (C + 8) * tsize;
  L.x_smem = cv.off + t_bytes <= kSmemLimit;
  L.xm = L.x_smem ? cv.take(t_bytes) : 0;
  L.ldx = L.x_smem ? C + 8 : C;
  L.o_smem = cv.off + t_bytes <= kSmemLimit;
  L.o = L.o_smem ? cv.take(t_bytes) : 0;
  L.ldo = L.o_smem ? C + 8 : C;
  L.total = cv.off;
  return L;
}

// (a) The token map: pix[t], the row of token t in x and y, and rid[t],
// its region id. The caller synchronises.
template <typename T>
__device__ __forceinline__ void window_tokens(const AttnParams<T>& p,
                                              int item, int* pix, int* rid) {
  const int t = threadIdx.x;
  if (t >= 64) return;
  const int H = p.H, W = p.W, s = p.shift;
  const int nWw = W / 8, nW = (H / 8) * nWw;
  if (p.windows) {
    pix[t] = item * 64 + t;
    rid[t] = window_region((p.w_off + item) % nW, t, H, W, s);
  } else {
    const int b = item / nW, wl = item % nW;
    const int gr = (wl / nWw) * 8 + t / 8, gc = (wl % nWw) * 8 + t % 8;
    pix[t] = (b * H + (gr + s) % H) * W + (gc + s) % W;
    rid[t] = window_region(wl, t, H, W, s);
  }
}

// The token map of packed tile `item` (window_core_mma.cuh:PackedTokens):
// pix[t] its row of the (Bw N, C) windows, -1 for padding; rid[t] its
// region id in its own window. The caller synchronises.
template <typename T>
__device__ __forceinline__ void packed_tokens(const AttnParams<T>& p,
                                              int item, int* pix, int* rid) {
  const int t = threadIdx.x;
  if (t >= 64) return;
  const int win = p.win, N = win * win, G = 64 / N, H = p.H, W = p.W;
  const int nWw = W / win, nW = (H / win) * nWw;
  const int i = item * G + t / N, tt = t % N;
  const bool ok = t < G * N && i < p.n_win;
  pix[t] = ok ? item * G * N + t : -1;
  const int wl = (p.w_off + i) % nW;
  rid[t] = p.shift ? 3 * region_id_w((wl / nWw) * win + tt / win, H,
                                     p.shift, win) +
                         region_id_w((wl % nWw) * win + tt % win, W,
                                     p.shift, win)
                   : 0;
}

// NW: the block's warps, as block_gemm takes it (0: read from blockDim).
// kPacked: item is a packed tile of whole windows of N = p.win^2 < 64
// tokens (mod and bias the host's (64, C) and (nH, 64, 64) tiles).
template <typename T, int D, int NW = kWarps, bool kPacked = false>
__device__ void attention_window(const AttnParams<T>& p, int item,
                                 unsigned char* smem, int slot) {
  using L_ = AttnLayout<D>;
  const L_ L = attn_layout<D>(sizeof(T), p.C);
  const int C = p.C;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int nw = NW > 0 ? NW : (int)(blockDim.x >> 5);

  T* slab = p.o_scratch + (size_t)slot * L.regions() * 64 * C;
  T* xm = L.x_smem ? reinterpret_cast<T*>(smem + L.xm) : slab;
  T* q = reinterpret_cast<T*>(smem + L.q);
  T* k = reinterpret_cast<T*>(smem + L.k);
  T* v = reinterpret_cast<T*>(smem + L.v);
  T* P = reinterpret_cast<T*>(smem + L.p);
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  int* pix = reinterpret_cast<int*>(smem + L.pix);
  int* rid = reinterpret_cast<int*>(smem + L.rid);
  T* O = L.o_smem ? reinterpret_cast<T*>(smem + L.o)
                  : slab + (L.x_smem ? 0 : (size_t)64 * C);
  T* wbuf = reinterpret_cast<T*>(smem + L.w);
  const bool stage_w = sizeof(T) == 2 && L.w_smem;
  const int ldx = L.ldx, ldo = L.ldo;
  constexpr int ldq = L_::ldq, ldp = L_::ldp, lda = L_::ldacc,
                KW = L_::kWChunk, ldw = L_::ldw;
  constexpr int kHeadTiles = 4 * (D / 16);  // 16x16 tiles of a 64 x D tile
  constexpr int DP = padded_head<T, D>();    // the products' head width
  constexpr bool kBig = attn_big_head(D);
  // the head dim: D, or at head dims 72-128 C / nH (D or D - 8)
  const int hd = kBig ? C / p.nH : D;

  // (a) token map, then the gather
  if constexpr (kPacked)
    packed_tokens<T>(p, item, pix, rid);
  else
    window_tokens<T>(p, item, pix, rid);
  __syncthreads();
  for (int idx = tid; idx < 64 * C; idx += blockDim.x) {
    const int t = idx / C, c = idx % C;
    if constexpr (kPacked)
      xm[t * ldx + c] = pix[t] >= 0 ? p.x[(size_t)pix[t] * C + c]
                                    : from_f<T>(0.f);
    else
      xm[t * ldx + c] = p.x[(size_t)pix[t] * C + c];
  }
  if (stage_w && C % 16) {  // columns C..C+7 of xm and O: the products' pad
    zero_pad<T>(xm, ldx, 64, C + 8, 64, C);
    zero_pad<T>(O, ldo, 64, C + 8, 64, C);
  }
  __syncthreads();
  // (b) LN1 + modulator, then per head the projections and (c) the core
  for (int t = warp; t < 64; t += nw)
    ln_row<T>(xm + t * ldx, C, p.ln_s, p.ln_b, p.has_ln,
              p.mod ? p.mod + t * C : nullptr);
  __syncthreads();

  for (int h = 0; h < p.nH; ++h) {
    const int c0 = h * hd;
    if constexpr (kBig) {
      // q, k and v in turn, each into acc's first D columns
      for (int m = 0; m < 3; ++m) {
        const T* wm = m == 0 ? p.wq : (m == 1 ? p.wk : p.wv);
        const int ldm = m == 0 ? C : p.ldkv;
        const float* bm = m == 0 ? p.bq : (m == 1 ? p.bk : p.bv);
        const float sc = m == 0 ? p.scale : 1.0f;
        T* dst = m == 0 ? q : (m == 1 ? k : v);
        if (stage_w) {
          // kr x hd chunks, zero to kr16 rows and D columns
          for (int kc = 0; kc < C; kc += KW) {
            const int kr = min(KW, C - kc), kr16 = (kr + 15) & ~15;
            stage_tile<T>(wbuf, ldw, wm + (size_t)kc * ldm + c0, ldm, kr,
                          hd);
            zero_pad<T>(wbuf, ldw, kr16, D, kr, hd);
            __syncthreads();
            if (kc == 0)
              block_gemm<T, false, false, false, NW>(xm, ldx, wbuf, ldw, acc,
                                                     lda, 64, D, kr16);
            else
              block_gemm<T, false, true, false, NW>(xm + kc, ldx, wbuf, ldw,
                                                    acc, lda, 64, D, kr16);
            __syncthreads();
          }
        } else {
          block_gemm<T, false, false, false, NW>(xm, ldx, wm + c0, ldm, acc,
                                                 lda, 64, hd, C);
          __syncthreads();
        }
        for (int idx = tid; idx < 64 * D; idx += blockDim.x) {
          const int t = idx / D, d = idx % D;
          dst[t * ldq + d] =
              d < hd ? from_f<T>((acc[t * lda + d] + bm[c0 + d]) * sc)
                     : from_f<T>(0.f);
        }
        __syncthreads();
      }
    } else if (stage_w) {
      // [q | k | v] = xm @ wbuf, accumulated over the chunks; a last chunk
      // of kr rows (C 8 mod 16) is zero from row kr to kr16
      for (int kc = 0; kc < C; kc += KW) {
        const int kr = min(KW, C - kc), kr16 = (kr + 15) & ~15;
        stage_tile<T>(wbuf, ldw, p.wq + (size_t)kc * C + c0, C, kr, D);
        stage_tile<T>(wbuf + DP, ldw, p.wk + (size_t)kc * p.ldkv + c0,
                      p.ldkv, kr, D);
        stage_tile<T>(wbuf + 2 * DP, ldw, p.wv + (size_t)kc * p.ldkv + c0,
                      p.ldkv, kr, D);
        if constexpr (DP != D)  // the pad columns of q, k and v
          for (int i = tid; i < kr16 * 3; i += blockDim.x)
            *reinterpret_cast<uint4*>(wbuf + (i / 3) * ldw + (i % 3) * DP +
                                      D) = make_uint4(0u, 0u, 0u, 0u);
        zero_pad<T>(wbuf, ldw, kr16, 3 * DP, kr, 3 * DP);
        __syncthreads();
        if (kc == 0)
          block_gemm<T, false, false, false, NW>(xm, ldx, wbuf, ldw, acc,
                                                 lda, 64, 3 * DP, kr16);
        else
          block_gemm<T, false, true, false, NW>(xm + kc, ldx, wbuf, ldw,
                                                acc, lda, 64, 3 * DP, kr16);
        __syncthreads();
      }
    } else {
      // q, k and v each start on their own warps
      block_gemm<T, false, false, false, NW>(xm, ldx, p.wq + c0, C, acc,
                                             lda, 64, D, C);
      block_gemm<T, false, false, false, NW>(xm, ldx, p.wk + c0, p.ldkv,
                                             acc + DP, lda, 64, D, C,
                                             kHeadTiles);
      block_gemm<T, false, false, false, NW>(xm, ldx, p.wv + c0, p.ldkv,
                                             acc + 2 * DP, lda, 64, D, C,
                                             2 * kHeadTiles);
      __syncthreads();
    }
    if constexpr (!kBig) {
      for (int idx = tid; idx < 64 * D; idx += blockDim.x) {
        const int t = idx / D, d = idx % D;
        q[t * ldq + d] =
            from_f<T>((acc[t * lda + d] + p.bq[c0 + d]) * p.scale);
        k[t * ldq + d] = from_f<T>(acc[t * lda + DP + d] + p.bk[c0 + d]);
        v[t * ldq + d] = from_f<T>(acc[t * lda + 2 * DP + d] + p.bv[c0 + d]);
      }
      if constexpr (DP != D)  // zero pad columns: exact 16-wide products
        for (int t = tid; t < 64; t += blockDim.x) {
          *reinterpret_cast<uint4*>(q + t * ldq + D) = make_uint4(0, 0, 0, 0);
          *reinterpret_cast<uint4*>(k + t * ldq + D) = make_uint4(0, 0, 0, 0);
          *reinterpret_cast<uint4*>(v + t * ldq + D) = make_uint4(0, 0, 0, 0);
        }
      __syncthreads();
    }
    window_core<T, D, NW>(q, k, v, ldq, p.bias + (size_t)h * 4096,
                      p.shift ? rid : nullptr, 1.0f, P, ldp, acc, lda);
    for (int idx = tid; idx < 64 * hd; idx += blockDim.x) {
      const int t = idx / hd, d = idx % hd;
      O[t * ldo + c0 + d] = from_f<T>(acc[t * lda + d]);
    }
    __syncthreads();
  }

  // output projection in 64-column chunks, + bias [+ residual], scatter
  for (int n0 = 0; n0 < C; n0 += 64) {
    const int nn = min(64, C - n0);
    if (stage_w) {
      // kr x nn chunks of wo, zero to kr16 rows and nn16 columns
      const int nn16 = (nn + 15) & ~15;
      for (int kc = 0; kc < C; kc += KW) {
        const int kr = min(KW, C - kc), kr16 = (kr + 15) & ~15;
        stage_tile<T>(wbuf, ldw, p.wo + (size_t)kc * C + n0, C, kr, nn);
        zero_pad<T>(wbuf, ldw, kr16, nn16, kr, nn);
        __syncthreads();
        if (kc == 0)
          block_gemm<T, false, false, false, NW>(O, ldo, wbuf, ldw, acc, lda,
                                                 64, nn16, kr16);
        else
          block_gemm<T, false, true, false, NW>(O + kc, ldo, wbuf, ldw, acc,
                                                lda, 64, nn16, kr16);
        __syncthreads();
      }
    } else {
      block_gemm<T, false, false, false, NW>(O, ldo, p.wo + n0, C, acc, lda,
                                             64, nn, C);
      __syncthreads();
    }
    for (int idx = tid; idx < 64 * nn; idx += blockDim.x) {
      const int t = idx / nn, j = idx % nn, n = n0 + j;
      if (kPacked && pix[t] < 0) continue;
      const size_t at = (size_t)pix[t] * C + n;
      float o = rnd<T>(acc[t * lda + j] + p.bo[n]);
      if (p.residual) o = o + to_f<T>(p.x[at]);
      p.y[at] = from_f<T>(o);
    }
    __syncthreads();
  }
}

// Calls f(std::integral_constant<int, D>{}) for the head dim C / nH (8,
// 16, 32 or 64: the bodies of both ways take each) and returns its result;
// cudaErrorInvalidValue for a head dim without a kernel (the wrappers
// check first).
template <typename F>
int with_head_dim(int C, int nH, F f) {
  if (nH > 0 && C == 16 * nH) return f(std::integral_constant<int, 16>{});
  if (nH > 0 && C == 32 * nH) return f(std::integral_constant<int, 32>{});
  if (nH > 0 && C == 8 * nH) return f(std::integral_constant<int, 8>{});
  if (nH > 0 && C == 64 * nH) return f(std::integral_constant<int, 64>{});
  return (int)cudaErrorInvalidValue;
}

// Whether C / nH is one of the head dims that only the forward's
// one-window bodies take (24, 40, 48, 56: kernels 3 and 5, each
// instantiated in a translation unit of its own, *_heads.cu).
__host__ inline bool is_new_head_dim(int C, int nH) {
  if (nH <= 0 || C % nH) return false;
  const int D = C / nH;
  return D == 24 || D == 40 || D == 48 || D == 56;
}

// with_head_dim for those head dims.
template <typename F>
int with_new_head_dim(int C, int nH, F f) {
  switch (is_new_head_dim(C, nH) ? C / nH : 0) {
    case 24: return f(std::integral_constant<int, 24>{});
    case 40: return f(std::integral_constant<int, 40>{});
    case 48: return f(std::integral_constant<int, 48>{});
    case 56: return f(std::integral_constant<int, 56>{});
  }
  return (int)cudaErrorInvalidValue;
}

// Whether C / nH is a head dim of 72-128, a multiple of 8: the forward's
// one-window bodies of width (C / nH) rounded up to 16 (kernels 3 and 5,
// each instantiated in a translation unit of its own, *_big_heads.cu).
__host__ inline bool is_big_head_dim(int C, int nH) {
  if (nH <= 0 || C % nH) return false;
  const int D = C / nH;
  return D > 64 && D <= 128 && D % 8 == 0;
}

// with_head_dim for those head dims: f gets the body's width, 80, 96, 112
// or 128 (the head dim itself, or the next multiple of 16).
template <typename F>
int with_big_head_dim(int C, int nH, F f) {
  switch (is_big_head_dim(C, nH) ? (C / nH + 15) / 16 * 16 : 0) {
    case 80: return f(std::integral_constant<int, 80>{});
    case 96: return f(std::integral_constant<int, 96>{});
    case 112: return f(std::integral_constant<int, 112>{});
    case 128: return f(std::integral_constant<int, 128>{});
  }
  return (int)cudaErrorInvalidValue;
}

// Whether attention_window takes (dtype, C, D): a bf16 head of 8 only
// with staged weights.
__host__ inline bool attn_window_fits(int tsize, int C, int D) {
  return D != 8 || tsize == 4 || C % AttnLayout<8>::kWChunk == 0;
}

}  // namespace uf
