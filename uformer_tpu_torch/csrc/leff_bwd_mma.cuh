// The LeFF backward in bf16 on the tensor-core building block
// (mma_tile.cuh): every product in mma.sync register accumulators, the
// weights in 16-24 KB tiles through a ring of cp.async slots (the
// forward's wide tile, leff_mma.cuh), C in 8..1024 with Ch a multiple of
// 64. At C = 1024 (an --embed_dim 64 model's bottleneck and dec0, hidden
// 4096) the tiles shrink until the token tiles fit beside the ring (A: 2
// x 8 outputs, B: 4 x 8) and B's dLN products take depth 8 (a W1 tile of
// C x 8) on mma.sync.m16n8k8. The functions, roundings and outputs are leff_bwd.cu's kernels A
// and B; only the order of fp32 sums differs. At C = 8 (an embed-8 model's
// outer stages, its hidden of 32 zero-padded to one chunk by the host) the
// products of depth C (h, dg, pre1) run on mma.sync.m16n8k8 (warp_mma_k),
// LN2's statistics and their VJP over the 8 channels; dLN (depth 64) keeps
// m16n8k16, on half the warps.
//
//   A (tile of TA x 8 outputs, halo (TA + 2) x 10): per 64-channel hidden
//     chunk, h = GELU(LN(x) W1 + b1) on the halo and dg = dy W2^T on the
//     tile, each in registers over K = C, the weight tiles streamed along
//     K (W1 rows x the chunk; W2's chunk rows x C columns, read as N x K);
//     h into shared memory as bf16, dg as fp32 (JAX's g2, leff.py:617-621:
//     rounding dg before GELU' as well as dpre2 after it doubled the bf16
//     error that every sum over pixels of dpre2, dh and dpre1 carries);
//     then per output and channel the depthwise step, + bd, GELU, GELU',
//     g and dpre2 = rnd(dg GELU'(pre2)) written, dbd summed from the fp32
//     dpre2 (as JAX's dhc, :641) and dwd from the rounded one, in fp32.
//   B (TB x 8 outputs): pre1 = LN(x) W1 in registers over K = C; dh =
//     dw3x3^T(dpre2 on the halo, brought in by cp.async with the chunk's
//     first weight tile); dpre1 = dh GELU'(pre1 + b1); dLN += dpre1
//     W1^T, the Mo x C fp32 accumulator in registers for the whole hidden
//     loop (W1 streamed a second time, as C x KW tiles along the chunk);
//     then the LayerNorm VJP and the residual.
// Both mask partial tiles (any H and W). Where the image has few tiles
// the host splits a tile's hidden chunks over blockIdx.y: A's chunks are
// independent (each writes its own columns); B's groups write fp32 dLN
// partials that leff_bwd_finish sums in group order before the LN VJP.
#pragma once

#include "leff_tile.cuh"
#include "mma_tile.cuh"
#include "window_core_mma.cuh"

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
  float* part_b;      // (tiles, C + Ch): dln_s, then db1           [B]
  float* part_dln;    // (groups, tiles, TH * 8, C) fp32 dLN partials [B]
  T* xn_scratch;      // (tiles, rows, C): a tile's LN(x) where it misses
                      // shared memory (uf_leff_bwd_scratch)   [A or B]
  int B, H, W, C, Ch, TH;
  int cpg;            // hidden chunks per blockIdx.y group
  int has_ln, residual;
};

constexpr int kRowStep = kThreads / kLeffChunk;  // 8 row groups

// bf16 at a C that is no power of two or above 1024 (leff_bwd_heads.cu,
// one tile a block, every hidden chunk): the output rows of kernel
// `which`'s tile (0 A, 1 B), 0 where none fits; the rows of its LN(x)
// tile in p.xn_scratch, 0 where it fits shared memory; the launch of A or
// B, 0 or a cudaError_t.
int leff_bwd_heads_rows(int which, int C);
int leff_bwd_heads_scratch(int which, int C);
int leff_bwd_heads(int which, LeffBwdParams<bf16>& p, cudaStream_t stream);

// Output pixel o of tile `item` (TH x 8 outputs of a (B, ceil(H / TH),
// ceil(W / 8)) grid): its row in x, or -1 past the image.
struct TileGeom {
  int b, r0, c0, H, W;
  __device__ TileGeom(int item, int TH, int H_, int W_) : H(H_), W(W_) {
    const int nTw = (W + 7) / 8, nT = ((H + TH - 1) / TH) * nTw;
    b = item / nT;
    r0 = ((item % nT) / nTw) * TH;
    c0 = (item % nTw) * 8;
  }
  __device__ int out(int o) const {
    const int r = r0 + o / 8, c = c0 + o % 8;
    return r < H && c < W ? (b * H + r) * W + c : -1;
  }
  // halo pixel i of a (TH + 2) x 10 halo (rows past nh are padding)
  __device__ int halo(int i, int nh) const {
    if (i >= nh) return -1;
    const int r = r0 - 1 + i / 10, c = c0 - 1 + i % 10;
    return r >= 0 && r < H && c >= 0 && c < W ? (b * H + r) * W + c : -1;
  }
};

template <int C>
struct LeffBwdMma {
  static_assert(C == 8 || C == 16 || C == 32 || C == 64 || C == 128 ||
                    C == 256 || C == 512 || C == 1024,
                "LeFF backward tiles: C 8-1024");
  static constexpr int kc = kLeffChunk;
  static constexpr int KT = C < 128 ? C : 128;  // K rows of a weight tile
  static constexpr int P = C / KT;              // K tiles of one product
  static constexpr int KW = kc / P;             // dLN: chunk columns a tile
  static constexpr int ldx = C + 8, ldh = kc + 8, ldt = KT + 8,
                       ldw = KW + 8, ldp = kc + 4;
  static constexpr int kStages = 3;
  static constexpr size_t kSlotA =
      align128(2 * (KT * ldh > kc * ldt ? KT * ldh : kc * ldt));
  static constexpr size_t kSlotB =
      align128(2 * (KT * ldh > C * ldw ? KT * ldh : C * ldw));
};

// ---- kernel A -----------------------------------------------------------

template <int C>
struct LeffBwdA {
  using Base = LeffBwdMma<C>;
  static constexpr int TH = C == 1024 ? 2 : C == 512 ? 4 : C <= 64 ? 16 : 8;
  static constexpr int kHalo = (TH + 2) * 10, kOut = TH * 8;
  static constexpr int kRows = (kHalo + 15) / 16 * 16;  // 48 .. 192
  // h on the halo: warp w < NJ1 takes MJ m16 tiles from 16 MJ (w / NC1) x
  // NJ n8 tiles from 8 NJ (w % NC1)
  static constexpr int MJ = TH == 16 ? 3 : 1, NJ = TH == 8 ? 4 : 2;
  static constexpr int NC1 = kLeffChunk / (8 * NJ);
  static constexpr int NJ1 = kRows / 16 / MJ * NC1;
  // dg on the tile: warp w < JOBG takes m16 tile w / NG2 and NJ2 n8 tiles
  // (at TH = 2 half the warps)
  static constexpr int NJ2 = kOut < 32 ? 1 : kOut / 32, NG2 = 8 / NJ2;
  static constexpr int JOBG = kOut / 16 * NG2;
  static constexpr size_t xn = 0;
  static constexpr size_t dyt = xn + align128(2 * kRows * Base::ldx);
  static constexpr size_t h = dyt + align128(2 * kOut * Base::ldx);
  // fp32 dg, then (once the depthwise step has read it) the tile's dwd
  // and dbd partials in the same bytes
  static constexpr size_t dg = h + align128(2 * kRows * Base::ldh);
  static constexpr size_t red = dg;
  static constexpr size_t hpix =
      dg + align128(4 * (kOut * Base::ldh > kRowStep * kLeffChunk * 10
                             ? kOut * Base::ldh
                             : kRowStep * kLeffChunk * 10));
  static constexpr size_t opix = hpix + align128(4 * kRows);
  static constexpr size_t ring = opix + align128(4 * kOut);
  static constexpr size_t total = ring + Base::kStages * Base::kSlotA;
  static_assert(NJ1 <= kWarps && JOBG <= kWarps, "a job a warp");
  static_assert(total <= kSmemLimit, "LeFF backward A exceeds shared memory");
};

template <int C>
__device__ void leff_bwd_a_tile(const LeffBwdParams<bf16>& p,
                                unsigned char* smem) {
  using B_ = LeffBwdMma<C>;
  using L = LeffBwdA<C>;
  constexpr int kc = kLeffChunk, P = B_::P, KT = B_::KT, S = B_::kStages;
  constexpr int ldx = B_::ldx, ldh = B_::ldh;
  const int Ch = p.Ch;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t4 = lane & 3;
  const TileGeom geo(blockIdx.x, L::TH, p.H, p.W);
  bf16* xn = reinterpret_cast<bf16*>(smem + L::xn);
  bf16* dyt = reinterpret_cast<bf16*>(smem + L::dyt);
  bf16* hs = reinterpret_cast<bf16*>(smem + L::h);
  float* dgs = reinterpret_cast<float*>(smem + L::dg);
  float* red = reinterpret_cast<float*>(smem + L::red);
  int* hpix = reinterpret_cast<int*>(smem + L::hpix);
  int* opix = reinterpret_cast<int*>(smem + L::opix);
  unsigned char* ring = smem + L::ring;
  const int ch0 = blockIdx.y * p.cpg;
  const int ch1 = min(Ch / kc, ch0 + p.cpg);
  const int T = (ch1 - ch0) * 2 * P;  // weight tiles of this block

  // tile q: chunk ch0 + q / 2P; s < P: W1 rows [KT s, +KT) x the chunk's
  // 64 columns; else W2's chunk rows x columns [KT (s - P), +KT)
  auto load_tile = [&](int q) {
    bf16* dst = reinterpret_cast<bf16*>(ring + (q % S) * B_::kSlotA);
    const int k0 = (ch0 + q / (2 * P)) * kc, s = q % (2 * P);
    if (s < P) {
      for (int i = tid; i < KT * 8; i += kThreads) {
        const int r = i >> 3, v = i & 7;
        cp_async16(dst + r * ldh + v * 8,
                   p.w1 + (size_t)(s * KT + r) * Ch + k0 + v * 8);
      }
    } else {
      constexpr int vpr = KT / 8;
      for (int i = tid; i < kc * vpr; i += kThreads) {
        const int r = i / vpr, v = i % vpr;
        cp_async16(dst + r * B_::ldt + v * 8,
                   p.w2 + (size_t)(k0 + r) * C + (s - P) * KT + v * 8);
      }
    }
  };
  for (int q = 0; q < S - 1; ++q) {
    if (q < T) load_tile(q);
    cp_async_commit();
  }

  for (int i = tid; i < L::kRows; i += kThreads)
    hpix[i] = geo.halo(i, L::kHalo);
  for (int o = tid; o < L::kOut; o += kThreads) opix[o] = geo.out(o);
  __syncthreads();
  constexpr int vpr = C / 8;
  for (int idx = tid; idx < L::kRows * vpr; idx += kThreads) {
    const int i = idx / vpr, v = idx % vpr;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (hpix[i] >= 0)
      val = *reinterpret_cast<const uint4*>(p.x + (size_t)hpix[i] * C +
                                            v * 8);
    *reinterpret_cast<uint4*>(xn + i * ldx + v * 8) = val;
  }
  for (int idx = tid; idx < L::kOut * vpr; idx += kThreads) {
    const int o = idx / vpr, v = idx % vpr;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (opix[o] >= 0)
      val = *reinterpret_cast<const uint4*>(p.dy + (size_t)opix[o] * C +
                                            v * 8);
    *reinterpret_cast<uint4*>(dyt + o * ldx + v * 8) = val;
  }
  __syncthreads();
  if (p.has_ln)
    for (int i = warp; i < L::kHalo; i += kWarps)
      if (hpix[i] >= 0)
        ln_row<bf16>(xn + i * ldx, C, p.ln_s, p.ln_b, true, nullptr);
  // (the first iteration's barrier orders xn before the products)

  float acc1[L::MJ][L::NJ][4];
  float accg[1][L::NJ2][4];
  const bool job1 = warp < L::NJ1;
  const int mt1 = (warp / L::NC1) * L::MJ, n1 = (warp % L::NC1) * 8 * L::NJ;
  const bool jobg = warp < L::JOBG;
  const int mg = warp / L::NG2, ng = (warp % L::NG2) * 8 * L::NJ2;
  const int j = tid & (kc - 1), grp = tid / kc;
  for (int q = 0; q < T; ++q) {
    cp_async_wait<S - 2>();
    __syncthreads();
    if (q + S - 1 < T) load_tile(q + S - 1);
    cp_async_commit();
    const bf16* wt =
        reinterpret_cast<const bf16*>(ring + (q % S) * B_::kSlotA);
    const int k0 = (ch0 + q / (2 * P)) * kc, s = q % (2 * P);
    if (s < P) {
      if (!job1) continue;
      if (s == 0) zero_acc(acc1);
      warp_mma_k<L::MJ, L::NJ, KT>(acc1, xn + mt1 * 16 * ldx + s * KT, ldx,
                                   wt + n1, ldh);
      if (s < P - 1) continue;
      // + b1, GELU, bf16; zero outside the image and in the padding rows
#pragma unroll
      for (int n = 0; n < L::NJ; ++n) {
        const int col = n1 + n * 8 + 2 * t4;
        const float bb0 = p.b1[k0 + col], bb1 = p.b1[k0 + col + 1];
#pragma unroll
        for (int mi = 0; mi < L::MJ; ++mi)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = (mt1 + mi) * 16 + gq + 8 * hh;
            const bool ok = hpix[row] >= 0;
            *reinterpret_cast<uint32_t*>(hs + row * ldh + col) =
                pack_bf16(ok ? gelu(acc1[mi][n][2 * hh] + bb0) : 0.f,
                          ok ? gelu(acc1[mi][n][2 * hh + 1] + bb1) : 0.f);
          }
      }
      continue;
    }
    // dg = dy . W2[k0:k0+64, :]^T, K along the tiles
    if (jobg) {
      if (s == P) zero_acc(accg);
      warp_mma_k<1, L::NJ2, KT, true>(accg,
                                      dyt + mg * 16 * ldx + (s - P) * KT,
                                      ldx, wt + ng * B_::ldt, B_::ldt);
    }
    if (s < 2 * P - 1) continue;
    // dg into shared memory, unrounded
#pragma unroll
    for (int n = 0; jobg && n < L::NJ2; ++n)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = mg * 16 + gq + 8 * hh, col = ng + n * 8 + 2 * t4;
        *reinterpret_cast<float2*>(dgs + row * ldh + col) =
            make_float2(accg[0][n][2 * hh], accg[0][n][2 * hh + 1]);
      }
    __syncthreads();
    // per output and channel: thread t takes channel t % 64 of outputs
    // t / 64 + 8 k
    float wdj[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) wdj[t] = to_f<bf16>(p.wd[t * Ch + k0 + j]);
    const float bdj = p.bd[k0 + j];
    float dwd[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float dbd = 0.f;
    for (int o = grp; o < L::kOut; o += kRowStep) {
      if (opix[o] < 0) continue;
      const bf16* h0 = hs + ((o / 8) * 10 + o % 8) * ldh + j;
      float hv[9];
#pragma unroll
      for (int t = 0; t < 9; ++t)
        hv[t] = __bfloat162float(h0[((t / 3) * 10 + t % 3) * ldh]);
      float pre = 0.f;
#pragma unroll
      for (int t = 0; t < 9; ++t) pre = fmaf(hv[t], wdj[t], pre);
      pre += bdj;
      const size_t at = (size_t)opix[o] * Ch + k0 + j;
      p.g[at] = __float2bfloat16(gelu(pre));
      const float d32 = dgs[o * ldh + j] * gelu_grad(pre);
      const float dp = rnd<bf16>(d32);
      p.dpre2[at] = __float2bfloat16(dp);
      dbd += d32;
#pragma unroll
      for (int t = 0; t < 9; ++t) dwd[t] = fmaf(dp, hv[t], dwd[t]);
    }
    __syncthreads();  // every read of dg done: red takes its bytes
    float* mine = red + (grp * kc + j) * 10;
#pragma unroll
    for (int t = 0; t < 9; ++t) mine[t] = dwd[t];
    mine[9] = dbd;
    __syncthreads();
    for (int i = tid; i < kc * 10; i += kThreads) {
      const int jj = i / 10, t = i % 10;
      float sum = 0.f;
      for (int gi = 0; gi < kRowStep; ++gi)
        sum += red[(gi * kc + jj) * 10 + t];
      p.part_a[(size_t)blockIdx.x * 10 * Ch + t * Ch + k0 + jj] = sum;
    }
    // (the next iteration's barrier orders red, h and dg before reuse)
  }
  cp_async_wait<0>();
}

// ---- kernel B -----------------------------------------------------------

template <int C>
struct LeffBwdB {
  using Base = LeffBwdMma<C>;
  static constexpr int TH = C == 1024 ? 4 : C <= 64 ? 16 : 8;
  static constexpr int kHalo = (TH + 2) * 10, kOut = TH * 8;
  static constexpr int kRows = (kHalo + 15) / 16 * 16;
  // pre1: warp w takes m16 tile w / NG1 and NJ1 n8 tiles of the chunk
  static constexpr int NJ1 = kOut / 32, NG1 = 8 / NJ1;
  // dLN: warp w < JOBS2 takes MT2 m16 tiles from 16 MT2 (w / NW2) x NT2
  // n8 tiles from 8 NT2 (w % NW2); every warp but at C = 8 (half of them);
  // at most the tile's kOut / 16 m16 tiles (C = 1024: 2 x 8)
  static constexpr int PP = kOut * C / 2048;
  static constexpr int NT2a = PP < 1 ? 1 : PP < 4 ? PP : 4;
  static constexpr int MT2a = PP / NT2a < 1 ? 1 : PP / NT2a;
  static constexpr int MT2 = MT2a < kOut / 16 ? MT2a : kOut / 16;
  static constexpr int NT2 = MT2 < MT2a ? PP / MT2 : NT2a;
  static constexpr int NW2 = C / (8 * NT2), JOBS2 = NW2 * (kOut / 16 / MT2);
  static constexpr int lda = C + 4;  // the epilogue's fp32 dLN rows
  static constexpr size_t stats = 0;
  static constexpr size_t hpix = stats + align128(4 * 2 * kOut);
  static constexpr size_t opix = hpix + align128(4 * kRows);
  static constexpr size_t red = opix + align128(4 * kOut);
  static constexpr size_t xn = red + align128(4 * kRowStep * kLeffChunk);
  static constexpr size_t pre = xn + align128(2 * kOut * Base::ldx);
  static constexpr size_t kDp2 = align128(2 * kRows * Base::ldh);
  static constexpr size_t dp2 = pre + align128(4 * kOut * Base::ldp);
  static constexpr size_t dp1 = dp2 + 2 * kDp2;
  static constexpr size_t ring = dp1 + align128(2 * kOut * Base::ldh);
  static constexpr size_t total = ring + Base::kStages * Base::kSlotB;
  // the epilogue's dLN (kOut x lda fp32) over xn .. ring
  static constexpr size_t acc = xn;
  static_assert(JOBS2 <= kWarps && (C == 8 || JOBS2 == kWarps),
                "dLN: a job a warp");
  static_assert(acc + 4 * kOut * lda <= total, "dLN fits the loop's buffers");
  static_assert(total <= kSmemLimit, "LeFF backward B exceeds shared memory");
};

// The LayerNorm VJP of a tile from its fp32 dLN (acc, kOut x lda in shared
// memory, rows of pixels opix) and LN statistics: dx [+ dy] per pixel from
// the fp32 dLN, unrounded as the TPU kernel's dt (leff.py:683-688), and
// the tile's dln_s sum from it too (dln_b is W1 db1, uf_leff_dln_b);
// without LN dx is the rounded dLN. All threads call it.
template <int C>
__device__ void leff_bwd_ln_vjp(const LeffBwdParams<bf16>& p, int tile,
                                const float* acc, const float* stats,
                                const int* opix) {
  using L = LeffBwdB<C>;
  constexpr int lda = L::lda;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int o = warp; o < L::kOut; o += kWarps) {
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
      p.dx[at + c] = from_f<bf16>(d);
    }
  }
  if (!p.has_ln) return;
  for (int c = tid; c < C; c += kThreads) {
    float ss = 0.f;
    for (int o = 0; o < L::kOut; ++o) {
      if (opix[o] < 0) continue;
      const float xh =
          (to_f<bf16>(p.x[(size_t)opix[o] * C + c]) - stats[2 * o]) *
          stats[2 * o + 1];
      ss = fmaf(acc[o * lda + c], xh, ss);
    }
    p.part_b[(size_t)tile * (C + p.Ch) + c] = ss;
  }
}

template <int C>
__device__ void leff_bwd_b_tile(const LeffBwdParams<bf16>& p,
                                unsigned char* smem) {
  using B_ = LeffBwdMma<C>;
  using L = LeffBwdB<C>;
  constexpr int kc = kLeffChunk, P = B_::P, KT = B_::KT, KW = B_::KW,
                S = B_::kStages;
  constexpr int ldx = B_::ldx, ldh = B_::ldh, ldp = B_::ldp;
  const int Ch = p.Ch;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t4 = lane & 3;
  const TileGeom geo(blockIdx.x, L::TH, p.H, p.W);
  float* stats = reinterpret_cast<float*>(smem + L::stats);
  int* hpix = reinterpret_cast<int*>(smem + L::hpix);
  int* opix = reinterpret_cast<int*>(smem + L::opix);
  float* red = reinterpret_cast<float*>(smem + L::red);
  bf16* xn = reinterpret_cast<bf16*>(smem + L::xn);
  float* pre = reinterpret_cast<float*>(smem + L::pre);
  bf16* dp1s = reinterpret_cast<bf16*>(smem + L::dp1);
  unsigned char* ring = smem + L::ring;
  auto dp2s = [&](int chunk) {
    return reinterpret_cast<bf16*>(smem + L::dp2 + (chunk & 1) * L::kDp2);
  };
  const int ch0 = blockIdx.y * p.cpg;
  const int ch1 = min(Ch / kc, ch0 + p.cpg);
  const int T = (ch1 - ch0) * 2 * P;

  for (int i = tid; i < L::kRows; i += kThreads)
    hpix[i] = geo.halo(i, L::kHalo);
  for (int o = tid; o < L::kOut; o += kThreads) opix[o] = geo.out(o);
  __syncthreads();

  // tile q: chunk c = ch0 + q / 2P; s < P: W1 rows [KT s, +KT) x the
  // chunk's columns (pre1, K x N), with the chunk's dpre2 halo at s = 0;
  // else all C rows x chunk columns [KW (s - P), +KW) (dLN, N x K)
  auto load_tile = [&](int q) {
    bf16* dst = reinterpret_cast<bf16*>(ring + (q % S) * B_::kSlotB);
    const int c = ch0 + q / (2 * P), k0 = c * kc, s = q % (2 * P);
    if (s < P) {
      for (int i = tid; i < KT * 8; i += kThreads) {
        const int r = i >> 3, v = i & 7;
        cp_async16(dst + r * ldh + v * 8,
                   p.w1 + (size_t)(s * KT + r) * Ch + k0 + v * 8);
      }
      if (s == 0) {
        bf16* d2 = dp2s(c);
        for (int i = tid; i < L::kRows * 8; i += kThreads) {
          const int r = i >> 3, v = i & 7;
          const bool ok = hpix[r] >= 0;
          cp_async16(d2 + r * ldh + v * 8,
                     p.dpre2 + (ok ? (size_t)hpix[r] * Ch + k0 + v * 8 : 0),
                     ok);
        }
      }
    } else {
      constexpr int vpr = KW / 8;
      for (int i = tid; i < C * vpr; i += kThreads) {
        const int r = i / vpr, v = i % vpr;
        cp_async16(dst + r * B_::ldw + v * 8,
                   p.w1 + (size_t)r * Ch + k0 + (s - P) * KW + v * 8);
      }
    }
  };
  for (int q = 0; q < S - 1; ++q) {
    if (q < T) load_tile(q);
    cp_async_commit();
  }

  // LN(x) of the tile's own pixels (zero past the image), written out for
  // dW1 by the first group
  constexpr int vpr = C / 8;
  for (int idx = tid; idx < L::kOut * vpr; idx += kThreads) {
    const int o = idx / vpr, v = idx % vpr;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (opix[o] >= 0)
      val = *reinterpret_cast<const uint4*>(p.x + (size_t)opix[o] * C +
                                            v * 8);
    *reinterpret_cast<uint4*>(xn + o * ldx + v * 8) = val;
  }
  __syncthreads();
  for (int o = warp; o < L::kOut; o += kWarps) {
    if (opix[o] < 0) continue;
    if (p.has_ln)
      ln_row<bf16>(xn + o * ldx, C, p.ln_s, p.ln_b, true, nullptr,
                   stats + 2 * o);
    if (blockIdx.y == 0)
      for (int c = lane; c < C; c += 32)
        p.ln[(size_t)opix[o] * C + c] = xn[o * ldx + c];
  }
  // (the first iteration's barrier orders xn before the products)

  float acc1[1][L::NJ1][4];
  float acc2[L::MT2][L::NT2][4];
  zero_acc(acc2);
  const int m1 = warp / L::NG1, n1 = (warp % L::NG1) * 8 * L::NJ1;
  const bool xjob = warp < L::JOBS2;
  const int m2 = (warp / L::NW2) * 16 * L::MT2,
            n2 = (warp % L::NW2) * 8 * L::NT2;
  const int j = tid & (kc - 1), grp = tid / kc;
  for (int q = 0; q < T; ++q) {
    cp_async_wait<S - 2>();
    __syncthreads();
    if (q + S - 1 < T) load_tile(q + S - 1);
    cp_async_commit();
    const bf16* wt =
        reinterpret_cast<const bf16*>(ring + (q % S) * B_::kSlotB);
    const int c = ch0 + q / (2 * P), k0 = c * kc, s = q % (2 * P);
    if (s >= P) {
      // dLN += dpre1 . W1[:, chunk]^T, K along the tiles
      if (xjob)
        warp_mma_k<L::MT2, L::NT2, KW, true>(
            acc2, dp1s + m2 * ldh + (s - P) * KW, ldh, wt + n2 * B_::ldw,
            B_::ldw);
      continue;
    }
    if (s == 0) zero_acc(acc1);
    warp_mma_k<1, L::NJ1, KT>(acc1, xn + m1 * 16 * ldx + s * KT, ldx,
                              wt + n1, ldh);
    if (s < P - 1) continue;
#pragma unroll
    for (int n = 0; n < L::NJ1; ++n)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = m1 * 16 + gq + 8 * hh, col = n1 + n * 8 + 2 * t4;
        *reinterpret_cast<float2*>(pre + row * ldp + col) =
            make_float2(acc1[0][n][2 * hh], acc1[0][n][2 * hh + 1]);
      }
    __syncthreads();
    // dh = dw3x3^T(dpre2) on the tile, dpre1 = dh GELU'(pre1 + b1) from the
    // fp32 dh and rounded once, as the TPU kernel's dh1 (leff.py:675-679:
    // its fp32 taps times dgelu, then dh1c); db1 from the fp32 dpre1
    // before its rounding (leff.py:682)
    const bf16* d2 = dp2s(c);
    float wdj[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) wdj[t] = to_f<bf16>(p.wd[t * Ch + k0 + j]);
    const float b1j = p.b1[k0 + j];
    float db1 = 0.f;
    for (int o = grp; o < L::kOut; o += kRowStep) {
      float dp = 0.f;
      if (opix[o] >= 0) {
        // dh[q] = sum over taps (dy, dx) of dpre2[q - (dy - 1, dx - 1)] wd
        const bf16* e0 = d2 + ((o / 8 + 2) * 10 + o % 8 + 2) * ldh + j;
        float dh = 0.f;
#pragma unroll
        for (int t = 0; t < 9; ++t)
          dh = fmaf(__bfloat162float(e0[-((t / 3) * 10 + t % 3) * ldh]),
                    wdj[t], dh);
        const float d32 = dh * gelu_grad(pre[o * ldp + j] + b1j);
        db1 += d32;
        dp = rnd<bf16>(d32);
        p.dpre1[(size_t)opix[o] * Ch + k0 + j] = __float2bfloat16(dp);
      }
      dp1s[o * ldh + j] = __float2bfloat16(dp);
    }
    red[grp * kc + j] = db1;
    __syncthreads();
    if (tid < kc) {
      float sum = 0.f;
      for (int gi = 0; gi < kRowStep; ++gi) sum += red[gi * kc + tid];
      p.part_b[(size_t)blockIdx.x * (C + Ch) + C + k0 + tid] = sum;
    }
    // (the next iteration's barrier orders dp1s before the dLN product)
  }
  cp_async_wait<0>();
  __syncthreads();  // every product done: acc may overlay the buffers

  auto put = [&](float* dst, int ld) {
    if (!xjob) return;
#pragma unroll
    for (int mi = 0; mi < L::MT2; ++mi)
#pragma unroll
      for (int n = 0; n < L::NT2; ++n)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int o = m2 + mi * 16 + gq + 8 * hh;
          const int col = n2 + n * 8 + 2 * t4;
          *reinterpret_cast<float2*>(dst + (size_t)o * ld + col) =
              make_float2(acc2[mi][n][2 * hh], acc2[mi][n][2 * hh + 1]);
        }
  };
  if (gridDim.y > 1) {  // this group's partial; leff_bwd_finish sums them
    const size_t tiles = gridDim.x;
    put(p.part_dln + ((size_t)blockIdx.y * tiles + blockIdx.x) * L::kOut * C,
        C);
    return;
  }
  float* acc = reinterpret_cast<float*>(smem + L::acc);
  put(acc, L::lda);
  __syncthreads();
  leff_bwd_ln_vjp<C>(p, blockIdx.x, acc, stats, opix);
}

// After a split B: per tile, dLN = the groups' partials summed in group
// order, LN statistics recomputed from x, then the LN VJP.
template <int C>
__device__ void leff_bwd_finish_tile(const LeffBwdParams<bf16>& p,
                                     int groups, unsigned char* smem) {
  using L = LeffBwdB<C>;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tiles = gridDim.x;
  const TileGeom geo(blockIdx.x, L::TH, p.H, p.W);
  float* stats = reinterpret_cast<float*>(smem + L::stats);
  int* opix = reinterpret_cast<int*>(smem + L::opix);
  float* acc = reinterpret_cast<float*>(smem + L::acc);
  for (int o = tid; o < L::kOut; o += kThreads) opix[o] = geo.out(o);
  for (int idx = tid; idx < L::kOut * C; idx += kThreads) {
    const int o = idx / C, c = idx % C;
    float sum = 0.f;
    for (int gi = 0; gi < groups; ++gi)
      sum += p.part_dln[((size_t)gi * tiles + blockIdx.x) * L::kOut * C +
                        idx];
    acc[o * L::lda + c] = sum;
  }
  __syncthreads();
  if (p.has_ln)
    for (int o = warp; o < L::kOut; o += kWarps) {
      if (opix[o] < 0) continue;
      // ln_row's statistics of the pixel
      const bf16* row = p.x + (size_t)opix[o] * C;
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
        stats[2 * o] = mean;
        stats[2 * o + 1] = rstd;
      }
    }
  __syncthreads();
  leff_bwd_ln_vjp<C>(p, blockIdx.x, acc, stats, opix);
}

}  // namespace uf
