// The LeFF sub-block in fp32 on the tensor cores (three-pass TF32,
// mma_tf32.cuh), at C 16, 32, 64, 128, 256 and 512 with a hidden of whole
// 64-channel chunks: kernel 2 (leff_f32.cu, a tile a block) and the stage
// kernel's LeFF half (stage_f32.cu, persistent blocks).
//
//   y = [x +] W2 . GELU(dw3x3(GELU(W1 . LN2(x) + b1)) + bd) + b2
//
// leff_mma.cuh's wide tile in fp32: one TH x 8 output tile (TH 8, or 4 at
// C 512, where an 8-row tile's 112-row halo of 516 floats would not fit
// beside the ring) with a one-pixel halo, padded to a multiple of 16
// rows. The hidden goes in 64-channel chunks: the first product on the
// halo (W1 tiles of min(C, 64) rows x 64) in registers, + b1, GELU, zero
// outside the image (the depthwise conv's SAME padding) into the fp32
// chunk h; the 3 x 3 depthwise + bd + GELU on the CUDA cores into the
// fp32 chunk g; g . W2 chunk (tiles of KW2 rows x C) into the TH 8 x C
// fp32 accumulator, which stays in registers for the whole hidden loop
// (at most 32 floats a thread). The weights stream as one sequence of
// tiles of at most 18 KB through a three-slot cp.async ring. Partial
// tiles at the image's edge are masked, so any H and W run. Nothing is
// rounded below fp32: only the order of the sums and the products' 2^-22
// split differ from the plain version.
#pragma once

#include "leff_tile.cuh"
#include "mma_tf32.cuh"

namespace uf {

__host__ __device__ constexpr bool leff_f32_fits(int C) {
  return C == 16 || C == 32 || C == 64 || C == 128 || C == 256 || C == 512;
}

// Output rows of the fp32 tile at width C.
__host__ __device__ constexpr int leff_f32_rows(int C) {
  return C == 512 ? 4 : 8;
}

__host__ __device__ constexpr int pow2_floor(int v) {
  int p = 1;
  while (2 * p <= v) p *= 2;
  return p;
}

template <int C, int TH>
struct LeffF32 {
  static_assert(leff_f32_fits(C) && TH == leff_f32_rows(C),
                "no fp32 LeFF tile");
  static_assert(kThreads == 8 * kLeffChunk, "depthwise: a thread a channel");
  static constexpr int kHalo = (TH + 2) * 10, kOut = TH * 8;
  static constexpr int kRows = (kHalo + 15) / 16 * 16;  // 112 or 64
  // A operands (xn, g) at 4 mod 8 floats; B operands (the weight tiles)
  // at 8 or 24 mod 32
  static constexpr int ldx = C + 4, ldh = kLeffChunk + 4;
  static constexpr int K1 = C < 64 ? C : 64;  // rows of a W1 tile
  static constexpr int P1 = C / K1;           // W1 tiles a chunk
  static constexpr int ldw1 = kLeffChunk + 8;
  static constexpr int KW2 = pow2_floor(4608 / (C + 8) < 64 ? 4608 / (C + 8)
                                                            : 64);
  static constexpr int P2 = kLeffChunk / KW2;  // W2 tiles a chunk
  static constexpr int ldw2 = C + 8;
  // first product: warp w < NJ1 takes m16 tile w / NC1 and NJ n8 tiles
  // from column 8 NJ (w % NC1) of the chunk
  static constexpr int MR = kRows / 16;
  static constexpr int NC1 = MR * 4 <= kWarps ? 4 : 2;
  static constexpr int NJ = 8 / NC1, NJ1 = MR * NC1;
  // second product: warp w < NJ2 takes MT2 m16 tiles x NT2 n8 tiles
  static constexpr int T2 = kOut / 16 * (C / 8);
  static constexpr int PW2 = T2 / 16 > 1 ? T2 / 16 : 1;
  static constexpr int NT2 = PW2 < 4 ? PW2 : 4;
  static constexpr int NW2 = C / (8 * NT2), MT2 = PW2 / NT2;
  static constexpr int NJ2 = kOut / 16 / MT2 * NW2;
  static constexpr int kStages = 3;
  static constexpr size_t kSlot =
      align128(4 * (K1 * ldw1 > KW2 * ldw2 ? K1 * ldw1 : KW2 * ldw2));
  static constexpr size_t xn = 0;
  static constexpr size_t h = xn + align128(4 * kRows * ldx);
  static constexpr size_t g = h + align128(4 * kRows * ldh);
  static constexpr size_t hpix = g + align128(4 * kOut * ldh);
  static constexpr size_t ring = hpix + align128(4 * kRows);
  static constexpr size_t total = ring + kStages * kSlot;
  static_assert(NJ1 <= kWarps && NJ2 <= kWarps, "a job a warp");
  static_assert(total <= kSmemLimit, "fp32 LeFF tile exceeds shared memory");
};

// g[o][j] for the TW outputs of row oy of the tile: 3 x 3 depthwise over
// channel j of the fp32 hidden chunk hs (halo rows TW + 2 wide), + bd,
// GELU. Taps in (dy, dx) order, as leff_tile.
template <int TW>
__device__ __forceinline__ void depthwise_row_f32(const float* hs, int ldh,
                                                  float* gs, int ldg, int oy,
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
      const float hv = hs[((oy + dy) * HW + dx) * ldh + j];
#pragma unroll
      for (int i = 0; i < TW; ++i) {
        const int tx = dx - i;
        if (tx >= 0 && tx < 3) s[i] = fmaf(hv, w[dy * 3 + tx], s[i]);
      }
    }
#pragma unroll
  for (int i = 0; i < TW; ++i) gs[(oy * TW + i) * ldg + j] = gelu(s[i] + bd);
}

// Tile `item` of the (B, ceil(H / TH), ceil(W / 8)) grid. All kThreads
// threads call it; Ch is a multiple of 64.
template <int C, int TH>
__device__ void leff_f32_tile(const LeffParams<float>& p, int item,
                              unsigned char* smem) {
  using L = LeffF32<C, TH>;
  constexpr int kc = kLeffChunk, P1 = L::P1, S = L::kStages, ldx = L::ldx,
                ldh = L::ldh;
  const int Ch = p.Ch, H = p.H, W = p.W;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t4 = lane & 3;
  const int nTw = (W + 7) / 8, nT = ((H + TH - 1) / TH) * nTw;
  const int b = item / nT, r0 = ((item % nT) / nTw) * TH,
            c0 = (item % nTw) * 8;
  float* xn = reinterpret_cast<float*>(smem + L::xn);
  float* hs = reinterpret_cast<float*>(smem + L::h);
  float* gs = reinterpret_cast<float*>(smem + L::g);
  int* hpix = reinterpret_cast<int*>(smem + L::hpix);
  unsigned char* ring = smem + L::ring;
  constexpr int TPC = P1 + L::P2;  // weight tiles a chunk
  const int T = (Ch / kc) * TPC;   // weight tiles in the sequence

  // tile q: chunk q / TPC; s < P1: W1 rows [K1 s, +K1) x the chunk's 64
  // columns; else W2 rows [chunk + KW2 (s - P1), +KW2) x all C columns
  auto load_tile = [&](int q) {
    float* dst = reinterpret_cast<float*>(ring + (q % S) * L::kSlot);
    const int k0 = (q / TPC) * kc, s = q % TPC;
    if (s < P1)
      cp_tile_f32(dst, L::ldw1, p.w1 + (size_t)s * L::K1 * Ch + k0, Ch,
                  L::K1, kc);
    else
      cp_tile_f32(dst, L::ldw2, p.w2 + (size_t)(k0 + (s - P1) * L::KW2) * C,
                  C, L::KW2, C);
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
  {
    constexpr int vpr = C / 4;
    for (int idx = tid; idx < L::kRows * vpr; idx += kThreads) {
      const int i = idx / vpr, c = (idx % vpr) * 4;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (hpix[i] >= 0)
        val = *reinterpret_cast<const float4*>(p.x + (size_t)hpix[i] * C + c);
      *reinterpret_cast<float4*>(xn + i * ldx + c) = val;
    }
  }
  __syncthreads();
  if (p.has_ln)
    for (int i = warp; i < L::kHalo; i += kWarps)
      if (hpix[i] >= 0)
        ln_row<float>(xn + i * ldx, C, p.ln_s, p.ln_b, true, nullptr);
  // (the first iteration's barrier orders xn before the products)

  float acc2[L::MT2][L::NT2][4];
  zero_acc(acc2);
  float acc1[1][L::NJ][4];
  const bool job1 = warp < L::NJ1, job2 = warp < L::NJ2;
  const int mt1 = warp / L::NC1, n1 = (warp % L::NC1) * 8 * L::NJ;
  const int m2 = (warp / L::NW2) * 16 * L::MT2,
            n2 = (warp % L::NW2) * 8 * L::NT2;
  for (int q = 0; q < T; ++q) {
    cp_async_wait<S - 2>();
    __syncthreads();
    // the slot of tile q - 1, which every thread has finished with
    if (q + S - 1 < T) load_tile(q + S - 1);
    cp_async_commit();
    const float* wt =
        reinterpret_cast<const float*>(ring + (q % S) * L::kSlot);
    const int k0 = (q / TPC) * kc, s = q % TPC;
    if (s >= P1) {
      if (job2)
        warp_mma3<L::MT2, L::NT2, L::KW2 / 8>(
            acc2, gs + m2 * ldh + (s - P1) * L::KW2, ldh, wt + n2, L::ldw2);
      continue;
    }
    if (job1) {
      if (s == 0) zero_acc(acc1);
      warp_mma3<1, L::NJ, L::K1 / 8>(acc1, xn + mt1 * 16 * ldx + s * L::K1,
                                     ldx, wt + n1, L::ldw1);
      if (s == P1 - 1) {
        // + b1, GELU; zero outside the image (SAME padding of the
        // depthwise conv) and in the padding rows
#pragma unroll
        for (int n = 0; n < L::NJ; ++n) {
          const int col = n1 + n * 8 + 2 * t4;
          const float bb0 = p.b1[k0 + col], bb1 = p.b1[k0 + col + 1];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = mt1 * 16 + gq + 8 * hh;
            const bool ok = hpix[row] >= 0;
            *reinterpret_cast<float2*>(hs + row * ldh + col) = make_float2(
                ok ? gelu(acc1[0][n][2 * hh] + bb0) : 0.f,
                ok ? gelu(acc1[0][n][2 * hh + 1] + bb1) : 0.f);
          }
        }
      }
    }
    if (s == P1 - 1) {
      __syncthreads();
      // depthwise: thread t takes channel t % 64 of output row t / 64 (at
      // 4 rows, threads 0-255)
      const int j = tid & (kc - 1);
      if (tid / kc < TH) {
        float w[9];
#pragma unroll
        for (int t = 0; t < 9; ++t) w[t] = p.wd[t * Ch + k0 + j];
        depthwise_row_f32<8>(hs, ldh, gs, ldh, tid / kc, j, w, p.bd[k0 + j]);
      }
      // (the next iteration's barrier orders g before the product)
    }
  }

  if (job2) {
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
            float2 v = make_float2(acc2[mi][n][2 * hh] + p.b2[col],
                                   acc2[mi][n][2 * hh + 1] + p.b2[col + 1]);
            if (p.residual) {
              const float2 xv = *reinterpret_cast<const float2*>(p.x + at);
              v.x += xv.x;
              v.y += xv.y;
            }
            *reinterpret_cast<float2*>(p.y + at) = v;
          }
        }
  }
  cp_async_wait<0>();
  __syncthreads();  // the caller's next tile reuses every buffer
}

}  // namespace uf
