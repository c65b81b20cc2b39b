// The LeFF sub-block in bf16 on the tensor-core building block
// (mma_tile.cuh): register accumulators, weight tiles copied by cp.async
// while earlier ones are multiplied.
//
//   y = [x +] W2 . GELU(dw3x3(GELU(W1 . LN2(x) + b1)) + bd) + b2
//
// Two tiles, by width:
//   wide (C 128, 256, 512, 1024; leff.cu and stage.cu): one TH x 8 output
//     tile per call, TH = 8, or 16 at C <= 256 where the image has tiles
//     enough, 4 at C = 1024 (an --embed_dim 64 model's bottleneck and dec0,
//     hidden 4096: its 8-row halo would need 231 KB). The TH 8 x C fp32
//     accumulator of the second product lives in registers for the whole
//     hidden loop, split by columns over the 16 warps (TH C / 64
//     registers a thread, at most 64). The hidden goes in 64-channel
//     chunks: first product on the (TH + 2) x 10 halo (padded to 64, 112
//     or 192 rows) in registers, + b1, GELU, bf16 into shared memory;
//     depthwise + bd + GELU into the bf16 g chunk; g . W2 chunk into the
//     accumulator. The weights stream as one sequence of 16 KB tiles (128
//     x 64 of W1, then 8192 / C x C of W2, per chunk; 16 x 1024 at C =
//     1024, in two slots) through a ring of cp.async slots. The 4-row
//     tile at C = 1024 costs a halo of 1.88x its outputs (1.25x at 8
//     rows) in the first product, and streams the 16 MB of weights once
//     per 32 outputs.
//   narrow (C 16, 32, 64 with Ch = 4C, and C 8 with its 32-wide hidden
//     zero-padded to 64 by the host, exact as GELU(0) = 0; leff.cu): at
//     C = 8 the first product takes x 16 wide, columns 8..15 and rows
//     8..15 of W1 zero, LN2's statistics over the 8 channels, and the
//     second product's one n8 tile goes to every other warp. W1, W2, wd
//     and the biases stay in shared memory for the whole launch; a
//     persistent
//     block walks 8 x 16 output tiles (halo 10 x 18 = 1.41 x the outputs,
//     against 1.56 at 8 x 8), loading the next tile's halo by cp.async
//     while it computes this one.
// Both mask partial tiles, so any H and W run. Roundings are those of
// leff_tile.cuh: LN output, GELU'd hidden, g, then rnd(acc + b2) + x.
#pragma once

#include "leff_tile.cuh"
#include "mma_tile.cuh"

namespace uf {

// g[o][j] for the TW outputs o = oy * TW + i of one row of the tile: 3 x 3
// depthwise over channel j of the GELU'd hidden chunk hs (halo rows of
// width TW + 2), + bd, GELU, bf16. Taps in (dy, dx) order, as leff_tile.
template <int TW>
__device__ __forceinline__ void depthwise_row(const bf16* hs, int ldh,
                                              bf16* gs, int ldg, int oy,
                                              int j, const float (&w)[9],
                                              float bd) {
  constexpr int HW = TW + 2;
  float s[TW];
#pragma unroll
  for (int i = 0; i < TW; ++i) s[i] = 0.f;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy)
#pragma unroll
    for (int dx = 0; dx < HW; ++dx) {
      const float h = __bfloat162float(hs[((oy + dy) * HW + dx) * ldh + j]);
#pragma unroll
      for (int i = 0; i < TW; ++i) {
        const int tx = dx - i;
        if (tx >= 0 && tx < 3) s[i] = fmaf(h, w[dy * 3 + tx], s[i]);
      }
    }
#pragma unroll
  for (int i = 0; i < TW; ++i)
    gs[(oy * TW + i) * ldg + j] = __float2bfloat16(gelu(s[i] + bd));
}

// ---- wide C -------------------------------------------------------------

// Whether leff_wide_tile has a layout for (C, TH): 8 or 16 output rows at
// C 128-256, 8 at 512, and 4 at 1024 (an --embed_dim 64 model's
// bottleneck and dec0, hidden 4096), whose 8-row tile's halo (112 rows x
// 2064 B) and 64 x 1024 fp32 accumulator would not fit.
__host__ __device__ constexpr bool leff_wide_fits(int C, int TH) {
  return ((C == 128 || C == 256) && (TH == 8 || TH == 16)) ||
         (C == 512 && TH == 8) || (C == 1024 && TH == 4);
}

template <int C, int TH>
struct LeffWide {
  static_assert(leff_wide_fits(C, TH), "no wide LeFF tile");
  static_assert(kThreads == 8 * kLeffChunk, "depthwise: a thread a channel");
  static constexpr int kHalo = (TH + 2) * 10, kOut = TH * 8;
  static constexpr int kRows = (kHalo + 15) / 16 * 16;  // 64, 112 or 192
  static constexpr int P = C / 128;        // W1 tiles per chunk
  static constexpr int KW2 = C < 512 ? 8192 / C : 16;  // rows of a W2 tile
  static constexpr int P2 = kLeffChunk / KW2;  // W2 tiles per chunk
  static constexpr int ldx = C + 8, ldh = kLeffChunk + 8;
  static constexpr int ldw1 = kLeffChunk + 8, ldw2 = C + 8;
  // first product: warp w < NJ1 takes MJ m16 tiles from 16 MJ (w / NC1) x
  // NJ n8 tiles from 8 NJ (w % NC1): 7 x 2 jobs of 1 x 4, 4 x 4 of 3 x 2,
  // or at 4 rows 4 x 4 of 1 x 2
  static constexpr int MJ = TH == 16 ? 3 : 1, NJ = TH == 8 ? 4 : 2;
  static constexpr int NC1 = kLeffChunk / (8 * NJ);
  static constexpr int NJ1 = kRows / 16 / MJ * NC1;
  // second product: warp w takes MT2 m16 tiles x NT2 n8 tiles (32
  // columns, or 64 at C 1024)
  static constexpr int NT2 = C == 1024 ? 8 : 4;
  static constexpr int NW2 = C / (8 * NT2), MT2 = kOut * NW2 / 256;
  static constexpr int kStages = C == 128 ? 3 : C == 1024 ? 2 : 4;
  static constexpr size_t kSlot = align128(
      2 * (128 * ldw1 > KW2 * ldw2 ? 128 * ldw1 : KW2 * ldw2));
  static constexpr size_t xn = 0;
  static constexpr size_t h = xn + align128(2 * kRows * ldx);
  static constexpr size_t g = h + align128(2 * kRows * ldh);
  static constexpr size_t hpix = g + align128(2 * kOut * ldh);
  static constexpr size_t ring = hpix + align128(4 * kRows);
  static constexpr size_t total = ring + kStages * kSlot;
  static_assert(NJ1 <= kWarps, "first product: a job a warp");
  static_assert(total <= kSmemLimit, "wide LeFF tile exceeds shared memory");
};

// Output rows of the wide tile for this image: 16 (twice the outputs per
// pass over the weights) where C <= 256, unless the halved tile count
// leaves the resident blocks so few tiles that the longer tile costs more
// rounds than it saves. A 16-row tile takes kTallCost times an 8-row one
// (1.38-1.62 on an H100 at C 128 and 256: forward_ab --what leff). 4 at
// C 1024 (leff_wide_fits).
constexpr double kTallCost = 1.6;
__host__ inline int leff_wide_rows(int B, int H, int W, int C, int slots) {
  if (C == 1024) return 4;
  if (C > 256) return 8;
  const long cols = (W + 7) / 8;
  const long r8 = ((long)B * ((H + 7) / 8) * cols + slots - 1) / slots;
  const long r16 = ((long)B * ((H + 15) / 16) * cols + slots - 1) / slots;
  return kTallCost * r16 <= r8 ? 16 : 8;
}

// Tile `item` of the (B, ceil(H / TH), ceil(W / 8)) grid. All kThreads
// threads call it; Ch is a multiple of 64.
template <int C, int TH>
__device__ void leff_wide_tile(const LeffParams<bf16>& p, int item,
                               unsigned char* smem) {
  using L = LeffWide<C, TH>;
  constexpr int kc = kLeffChunk, P = L::P, S = L::kStages;
  const int Ch = p.Ch, H = p.H, W = p.W;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t4 = lane & 3;
  const int nTw = (W + 7) / 8, nT = ((H + TH - 1) / TH) * nTw;
  const int b = item / nT, r0 = ((item % nT) / nTw) * TH,
            c0 = (item % nTw) * 8;
  bf16* xn = reinterpret_cast<bf16*>(smem + L::xn);
  bf16* hs = reinterpret_cast<bf16*>(smem + L::h);
  bf16* gs = reinterpret_cast<bf16*>(smem + L::g);
  int* hpix = reinterpret_cast<int*>(smem + L::hpix);
  unsigned char* ring = smem + L::ring;
  constexpr int TPC = P + L::P2;     // weight tiles per chunk
  const int T = (Ch / kc) * TPC;     // weight tiles in the sequence

  // tile q: chunk q / TPC; s < P: W1 rows [128 s, +128) x the chunk's 64
  // columns; else W2 rows [chunk + KW2 (s - P), +KW2) x all C columns
  auto load_tile = [&](int q) {
    bf16* dst = reinterpret_cast<bf16*>(ring + (q % S) * L::kSlot);
    const int k0 = (q / TPC) * kc, s = q % TPC;
    if (s < P) {
      for (int i = tid; i < 128 * 8; i += kThreads) {
        const int r = i >> 3, v = i & 7;
        cp_async16(dst + r * L::ldw1 + v * 8,
                   p.w1 + (size_t)(s * 128 + r) * Ch + k0 + v * 8);
      }
    } else {
      constexpr int vpr = C / 8;
      for (int i = tid; i < L::KW2 * vpr; i += kThreads) {
        const int r = i / vpr, v = i % vpr;
        cp_async16(dst + r * L::ldw2 + v * 8,
                   p.w2 + (size_t)(k0 + (s - P) * L::KW2 + r) * C + v * 8);
      }
    }
  };
  for (int q = 0; q < S - 1; ++q) {
    if (q < T) load_tile(q);
    cp_async_commit();
  }

  for (int i = tid; i < L::kRows; i += kThreads) {
    int at = -1;
    if (i < L::kHalo) {
      const int r = r0 - 1 + i / 10, c = c0 - 1 + i % 10;
      if (r >= 0 && r < H && c >= 0 && c < W) at = (b * H + r) * W + c;
    }
    hpix[i] = at;
  }
  __syncthreads();
  constexpr int vpr = C / 8;
  for (int idx = tid; idx < L::kRows * vpr; idx += kThreads) {
    const int i = idx / vpr, v = idx % vpr;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (hpix[i] >= 0)
      val = *reinterpret_cast<const uint4*>(p.x + (size_t)hpix[i] * C + v * 8);
    *reinterpret_cast<uint4*>(xn + i * L::ldx + v * 8) = val;
  }
  __syncthreads();
  if (p.has_ln)
    for (int i = warp; i < L::kHalo; i += kWarps)
      if (hpix[i] >= 0)
        ln_row<bf16>(xn + i * L::ldx, C, p.ln_s, p.ln_b, true, nullptr);
  // (the first iteration's barrier orders xn before the products)

  float acc2[L::MT2][L::NT2][4];
  zero_acc(acc2);
  float acc1[L::MJ][L::NJ][4];
  const bool job1 = warp < L::NJ1;
  const int mt1 = (warp / L::NC1) * L::MJ, n1 = (warp % L::NC1) * 8 * L::NJ;
  const int m2 = (warp / L::NW2) * 16 * L::MT2,
            n2 = (warp % L::NW2) * 8 * L::NT2;
  for (int q = 0; q < T; ++q) {
    cp_async_wait<S - 2>();
    __syncthreads();
    // the slot of tile q - 1, which every thread has finished with
    if (q + S - 1 < T) load_tile(q + S - 1);
    cp_async_commit();
    const bf16* wt = reinterpret_cast<const bf16*>(ring + (q % S) * L::kSlot);
    const int k0 = (q / TPC) * kc, s = q % TPC;
    if (s < P) {
      if (job1) {
        if (s == 0) zero_acc(acc1);
        warp_mma<L::MJ, L::NJ, 8>(acc1, xn + mt1 * 16 * L::ldx + s * 128,
                                  L::ldx, wt + n1, L::ldw1);
        if (s == P - 1) {
          // + b1, GELU, bf16; zero outside the image (SAME padding of the
          // depthwise conv) and in the padding rows
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
                *reinterpret_cast<uint32_t*>(hs + row * L::ldh + col) =
                    pack_bf16(ok ? gelu(acc1[mi][n][2 * hh] + bb0) : 0.f,
                              ok ? gelu(acc1[mi][n][2 * hh + 1] + bb1) : 0.f);
              }
          }
        }
      }
      if (s == P - 1) {
        __syncthreads();
        // depthwise: thread t takes channel t % 64 of output rows t / 64,
        // t / 64 + 8 (at 4 rows, threads 0-255 one each)
        const int j = tid & (kc - 1);
        float w[9];
#pragma unroll
        for (int t = 0; t < 9; ++t) w[t] = to_f<bf16>(p.wd[t * Ch + k0 + j]);
        const float bd = p.bd[k0 + j];
        if constexpr (TH >= 8) {
#pragma unroll
          for (int k = 0; k < TH / 8; ++k)
            depthwise_row<8>(hs, L::ldh, gs, L::ldh, tid / kc + 8 * k, j, w,
                             bd);
        } else if (tid / kc < TH) {
          depthwise_row<8>(hs, L::ldh, gs, L::ldh, tid / kc, j, w, bd);
        }
        // (the next iteration's barrier orders g before the product)
      }
    } else {
      warp_mma<L::MT2, L::NT2, L::KW2 / 16>(
          acc2, gs + m2 * L::ldh + (s - P) * L::KW2, L::ldh, wt + n2,
          L::ldw2);
    }
  }

#pragma unroll
  for (int mi = 0; mi < L::MT2; ++mi)
#pragma unroll
    for (int n = 0; n < L::NT2; ++n)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int o = m2 + mi * 16 + gq + 8 * hh, col = n2 + n * 8 + 2 * t4;
        const int r = r0 + o / 8, c = c0 + o % 8;
        if (r < H && c < W) {
          const size_t at = ((size_t)(b * H + r) * W + c) * C + col;
          float v0 = rnd<bf16>(acc2[mi][n][2 * hh] + p.b2[col]);
          float v1 = rnd<bf16>(acc2[mi][n][2 * hh + 1] + p.b2[col + 1]);
          if (p.residual) {
            const __nv_bfloat162 xv =
                *reinterpret_cast<const __nv_bfloat162*>(p.x + at);
            v0 += __low2float(xv);
            v1 += __high2float(xv);
          }
          *reinterpret_cast<uint32_t*>(p.y + at) = pack_bf16(v0, v1);
        }
      }
  cp_async_wait<0>();
  __syncthreads();  // the caller's next tile reuses every buffer
}

// ---- narrow C -----------------------------------------------------------

template <int C>
struct LeffNarrow {
  static_assert(C == 8 || C == 16 || C == 32 || C == 64,
                "narrow tile: C 8-64");
  // the hidden (4C, padded to a chunk) and the first product's depth
  static constexpr int Ch = 4 * C < kLeffChunk ? kLeffChunk : 4 * C;
  static constexpr int KP = C < 16 ? 16 : C;
  static constexpr int NT2 = C < 16 ? 1 : C / 16;  // n8 tiles a warp
  static constexpr int TW = 16, HW = TW + 2;  // 8 x 16 outputs, 10 x 18 halo
  static constexpr int kHalo = 10 * HW, kRows = 192, kOut = 8 * TW;
  static constexpr int ldx = C + 8, ldh = kLeffChunk + 8, ldr = C + 8;
  static constexpr int ldw1 = Ch + 8, ldw2 = C + 8;
  static constexpr size_t w1 = 0;
  static constexpr size_t w2 = w1 + align128(2 * KP * ldw1);
  static constexpr size_t wd = w2 + align128(2 * Ch * ldw2);  // fp32 9 x Ch
  static constexpr size_t b1 = wd + align128(4 * 9 * Ch);
  static constexpr size_t bd = b1 + align128(4 * Ch);
  static constexpr size_t b2 = bd + align128(4 * Ch);
  static constexpr size_t lns = b2 + align128(4 * C);       // LN2 scale, bias
  static constexpr size_t lnb = lns + align128(4 * C);
  static constexpr size_t kRaw = align128(2 * kHalo * ldr);  // a halo of x
  static constexpr size_t raw = lnb + align128(4 * C);       // two of them
  static constexpr size_t xn = raw + 2 * kRaw;
  static constexpr size_t h = xn + align128(2 * kRows * ldx);
  static constexpr size_t g = h + align128(2 * kRows * ldh);
  static constexpr size_t total = g + align128(2 * kOut * ldh);
  static_assert(total <= kSmemLimit, "narrow LeFF tile exceeds shared memory");
};

// Every tile of the (B, ceil(H / 8), ceil(W / 16)) grid from blockIdx.x
// in steps of gridDim.x. All kThreads threads call it; p.Ch == 4 C (64 at
// C = 8).
template <int C>
__device__ void leff_narrow(const LeffParams<bf16>& p, unsigned char* smem) {
  using L = LeffNarrow<C>;
  constexpr int Ch = L::Ch, kc = kLeffChunk, TW = L::TW, HW = L::HW;
  const int H = p.H, W = p.W;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t4 = lane & 3;
  const int nTw = (W + TW - 1) / TW, nT = ((H + 7) / 8) * nTw;
  const int items = p.B * nT;
  bf16* w1s = reinterpret_cast<bf16*>(smem + L::w1);
  bf16* w2s = reinterpret_cast<bf16*>(smem + L::w2);
  float* wds = reinterpret_cast<float*>(smem + L::wd);
  float* b1s = reinterpret_cast<float*>(smem + L::b1);
  float* bds = reinterpret_cast<float*>(smem + L::bd);
  float* b2s = reinterpret_cast<float*>(smem + L::b2);
  float* lns = reinterpret_cast<float*>(smem + L::lns);
  float* lnb = reinterpret_cast<float*>(smem + L::lnb);
  bf16* xn = reinterpret_cast<bf16*>(smem + L::xn);
  bf16* hs = reinterpret_cast<bf16*>(smem + L::h);
  bf16* gs = reinterpret_cast<bf16*>(smem + L::g);
  auto raw = [&](int buf) {
    return reinterpret_cast<bf16*>(smem + L::raw + buf * L::kRaw);
  };
  auto origin = [&](int item, int& b, int& r0, int& c0) {
    b = item / nT;
    r0 = ((item % nT) / nTw) * 8;
    c0 = (item % nTw) * TW;
  };
  // the halo of x, zero outside the image, rows of C values
  auto load_halo = [&](int item, bf16* dst) {
    int b, r0, c0;
    origin(item, b, r0, c0);
    constexpr int vpr = C / 8;
    for (int i = tid; i < L::kHalo * vpr; i += kThreads) {
      const int hr = i / vpr, v = i % vpr;
      const int r = r0 - 1 + hr / HW, c = c0 - 1 + hr % HW;
      const bool ok = r >= 0 && r < H && c >= 0 && c < W;
      cp_async16(dst + hr * L::ldr + v * 8,
                 p.x + (ok ? ((size_t)(b * H + r) * W + c) * C + v * 8 : 0),
                 ok);
    }
  };

  for (int i = tid; i < C * (Ch / 8); i += kThreads) {
    const int r = i / (Ch / 8), v = i % (Ch / 8);
    cp_async16(w1s + r * L::ldw1 + v * 8, p.w1 + (size_t)r * Ch + v * 8);
  }
  for (int i = tid; i < Ch * (C / 8); i += kThreads) {
    const int r = i / (C / 8), v = i % (C / 8);
    cp_async16(w2s + r * L::ldw2 + v * 8, p.w2 + (size_t)r * C + v * 8);
  }
  int item = blockIdx.x;
  if (item < items) load_halo(item, raw(0));
  cp_async_commit();
  for (int i = tid; i < 9 * Ch; i += kThreads) wds[i] = to_f<bf16>(p.wd[i]);
  for (int i = tid; i < Ch; i += kThreads) {
    b1s[i] = p.b1[i];
    bds[i] = p.bd[i];
  }
  for (int i = tid; i < C; i += kThreads) {
    b2s[i] = p.b2[i];
    if (p.has_ln) {
      lns[i] = p.ln_s[i];
      lnb[i] = p.ln_b[i];
    }
  }
  for (int i = tid; i < (L::kRows - L::kHalo) * L::ldx; i += kThreads)
    xn[L::kHalo * L::ldx + i] = from_f<bf16>(0.f);
  if constexpr (L::KP != C) {  // the first product's zero pad: exact
    for (int i = tid; i < (L::KP - C) * L::ldw1; i += kThreads)
      w1s[C * L::ldw1 + i] = from_f<bf16>(0.f);
    for (int i = tid; i < L::kHalo * (L::KP - C); i += kThreads)
      xn[(i / (L::KP - C)) * L::ldx + C + i % (L::KP - C)] =
          from_f<bf16>(0.f);
  }

  // second product: warp w takes m16 tile w / 2 and half the columns; at
  // C = 8 the even warps take the one n8 tile
  const int mt2 = warp >> 1, n2 = C < 16 ? 0 : (warp & 1) * (C / 2);
  const bool w2_warp = C >= 16 || !(warp & 1);
  for (int buf = 0; item < items; item += gridDim.x, buf ^= 1) {
    cp_async_wait<0>();
    __syncthreads();
    // the other halo buffer: the previous tile's, finished with
    if (item + (int)gridDim.x < items)
      load_halo(item + gridDim.x, raw(buf ^ 1));
    cp_async_commit();
    const bf16* cur = raw(buf);
    int b, r0, c0;
    origin(item, b, r0, c0);
    auto inside = [&](int hr) {
      const int r = r0 - 1 + hr / HW, c = c0 - 1 + hr % HW;
      return r >= 0 && r < H && c >= 0 && c < W;
    };
    // LN2 of the halo: thread t takes row t, fp32 statistics over its C
    // values (ln_row's arithmetic) in three passes over the row, eight
    // values at a time; rows outside the image stay zero
    for (int i = tid; i < L::kHalo; i += kThreads) {
      const uint4* src = reinterpret_cast<const uint4*>(cur + i * L::ldr);
      uint4* dst = reinterpret_cast<uint4*>(xn + i * L::ldx);
      auto vals = [&](int c8, float (&v)[8]) {
        const uint4 q = src[c8];
        const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[2 * e] = __low2float(h2[e]);
          v[2 * e + 1] = __high2float(h2[e]);
        }
      };
      if (!(p.has_ln && inside(i))) {
#pragma unroll
        for (int c8 = 0; c8 < C / 8; ++c8) dst[c8] = src[c8];
        continue;
      }
      float v[8], s = 0.f, var = 0.f;
#pragma unroll
      for (int c8 = 0; c8 < C / 8; ++c8) {
        vals(c8, v);
#pragma unroll
        for (int e = 0; e < 8; ++e) s += v[e];
      }
      const float mean = s / C;
#pragma unroll
      for (int c8 = 0; c8 < C / 8; ++c8) {
        vals(c8, v);
#pragma unroll
        for (int e = 0; e < 8; ++e) var += (v[e] - mean) * (v[e] - mean);
      }
      const float rstd = 1.0f / sqrtf(var / C + 1e-5f);
#pragma unroll
      for (int c8 = 0; c8 < C / 8; ++c8) {
        vals(c8, v);
        uint4 q;
        uint32_t* w = reinterpret_cast<uint32_t*>(&q);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * c8 + 2 * e;
          w[e] = pack_bf16((v[2 * e] - mean) * rstd * lns[c] + lnb[c],
                           (v[2 * e + 1] - mean) * rstd * lns[c + 1] +
                               lnb[c + 1]);
        }
        dst[c8] = q;
      }
    }
    __syncthreads();

    float acc2[1][L::NT2][4];
    zero_acc(acc2);
    for (int k0 = 0; k0 < Ch; k0 += kc) {
      {
        // first product on the halo (12 m16 tiles x the chunk's 64
        // columns): warp w takes m16 tiles 3 (w / 4) .. + 2 x 16 columns
        // from 16 (w % 4)
        const int mt = (warp >> 2) * 3, n1 = (warp & 3) * 16;
        float a1[3][2][4];
        zero_acc(a1);
        warp_mma<3, 2, L::KP / 16>(a1, xn + mt * 16 * L::ldx, L::ldx,
                                   w1s + k0 + n1, L::ldw1);
#pragma unroll
        for (int mi = 0; mi < 3; ++mi)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = (mt + mi) * 16 + gq + 8 * hh;
            const bool ok = row < L::kHalo && inside(row);
#pragma unroll
            for (int n = 0; n < 2; ++n) {
              const int col = n1 + n * 8 + 2 * t4;
              *reinterpret_cast<uint32_t*>(hs + row * L::ldh + col) =
                  pack_bf16(
                      ok ? gelu(a1[mi][n][2 * hh] + b1s[k0 + col]) : 0.f,
                      ok ? gelu(a1[mi][n][2 * hh + 1] + b1s[k0 + col + 1])
                         : 0.f);
            }
          }
      }
      __syncthreads();
      {
        // thread t: channel t % 64 of output row t / 64
        const int j = tid & (kc - 1);
        float w[9];
#pragma unroll
        for (int t = 0; t < 9; ++t) w[t] = wds[t * Ch + k0 + j];
        depthwise_row<TW>(hs, L::ldh, gs, L::ldh, tid / kc, j, w,
                          bds[k0 + j]);
      }
      __syncthreads();
      if (w2_warp)
        warp_mma<1, L::NT2, 4>(acc2, gs + mt2 * 16 * L::ldh, L::ldh,
                               w2s + k0 * L::ldw2 + n2, L::ldw2);
    }

    if (!w2_warp) continue;
#pragma unroll
    for (int n = 0; n < L::NT2; ++n)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int o = mt2 * 16 + gq + 8 * hh, col = n2 + n * 8 + 2 * t4;
        const int oy = o / TW, ox = o % TW;
        const int r = r0 + oy, c = c0 + ox;
        if (r < H && c < W) {
          float v0 = rnd<bf16>(acc2[0][n][2 * hh] + b2s[col]);
          float v1 = rnd<bf16>(acc2[0][n][2 * hh + 1] + b2s[col + 1]);
          if (p.residual) {
            const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(
                cur + ((oy + 1) * HW + ox + 1) * L::ldr + col);
            v0 += __low2float(xv);
            v1 += __high2float(xv);
          }
          *reinterpret_cast<uint32_t*>(
              p.y + ((size_t)(b * H + r) * W + c) * C + col) =
              pack_bf16(v0, v1);
        }
      }
  }
  cp_async_wait<0>();
}

}  // namespace uf
