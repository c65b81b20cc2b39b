// The LeWin attention sub-block in fp32 on the tensor cores, for the stage
// kernel (stage_f32.cu) at C 64, 128, 256 and 512, head dim 16 or 32:
//
//   y = x + tokens^-1(proj(W-MSA(LN1(tokens(x)) + mod)))
//
// The plan of attention_mma.cuh's bf16 body, in fp32, every product on
// the three-pass TF32 block of mma_tf32.cuh (fp32's accuracy, a third of
// the TF32 rate):
//   - a work item is WN windows (M = 64 WN tokens; 2 at C 64 and 128, 1
//     above: fp32 tiles are twice bf16's, and 64 x 516 floats of xm at
//     C 512 leave room for one window's q, k, v and logits beside the
//     ring), stage.cu picking WN from the windows and SMs;
//   - the weights stream as one sequence of tiles through a three-slot
//     cp.async ring: per head, KQ rows of its [q | k | v] columns (KQ x
//     3D, so that the three projections of a row block share one A
//     fragment), then its D rows of wo in tiles of DO rows;
//   - q, k, v (M x D each, + bias, q times the scale) in shared memory;
//     per window the core: S = q k^T (fp32 logits), + bias, -100 between
//     SW-MSA regions, softmax in fp32, O = P v written over the window's
//     q rows (dead by then);
//   - the output projection's M x C fp32 accumulator stays in registers
//     over all heads (M C / 512 floats a thread), + bo, + x at the end.
// The token map is attention_window's (shift, partition, reverse and
// unshift cost nothing). Nothing is rounded below fp32; only the order of
// the fp32 sums and the products' 2^-22 split differ from the plain
// version. The weights' ring slot is at most 17 KB: at C 512 the xm tile
// (132 KB) and one window's working set leave 50 KB for three slots.
#pragma once

#include "attention_mma.cuh"
#include "mma_tf32.cuh"

namespace uf {

// Whether the fp32 body takes (C, D), and the most windows a work item.
__host__ __device__ constexpr bool attn_f32_fits(int C, int D) {
  return (C == 64 || C == 128 || C == 256 || C == 512) &&
         (D == 16 || D == 32);
}
__host__ __device__ constexpr int attn_f32_max_windows(int C) {
  return C <= 128 ? 2 : 1;
}

template <int C, int D, int WN>
struct AttnF32 {
  static_assert(attn_f32_fits(C, D) && WN >= 1 &&
                    WN <= attn_f32_max_windows(C),
                "no fp32 attention layout");
  static constexpr int M = 64 * WN;
  // leading dims (floats): A operands and k (read as B^T) at 4 mod 8,
  // B operands (v, the weight tiles) at 8 or 24 mod 32
  static constexpr int ldx = C + 4, ldq = D + 4, ldv = D + 8, lds = 68;
  static constexpr int KQ = D == 32 ? 32 : 64;  // rows of a q|k|v tile
  static constexpr int NQ = C / KQ;             // q|k|v tiles of a head
  static constexpr int ldw = 3 * D + 8;
  static constexpr int DO = 4096 / C < D ? 4096 / C : D;  // rows of wo
  static constexpr int NO = D / DO;                       // wo tiles
  static constexpr int TPH = NQ + NO;                     // tiles a head
  static constexpr int ldo = C + 8;
  // q|k|v pass: warp w < NPW takes m16 tile w / NC1 and NT1 n8 tiles
  // from column 8 NT1 (w % NC1) of the 3D
  static constexpr int NC1 = M == 64 && D == 32 ? 4 : 2;
  static constexpr int NT1 = 3 * D / 8 / NC1;
  static constexpr int NPW = M / 16 * NC1;
  // output projection: warp w takes MTO m16 tiles x NTO n8 tiles
  static constexpr int TO = M / 16 * (C / 8);
  static constexpr int NTO = TO / 16 < 4 ? TO / 16 : 4;
  static constexpr int NCG = C / (8 * NTO), MTO = TO / 16 / NTO;
  static constexpr int kStages = 3;
  static constexpr size_t kSlot =
      align128(4 * (KQ * ldw > DO * ldo ? KQ * ldw : DO * ldo));
  static constexpr size_t xm = 0;
  static constexpr size_t q = xm + align128(4 * M * ldx);  // q, then O
  static constexpr size_t k = q + align128(4 * M * ldq);
  static constexpr size_t v = k + align128(4 * M * ldq);
  static constexpr size_t s = v + align128(4 * M * ldv);  // logits, P
  static constexpr size_t pix = s + align128(4 * 64 * lds);
  static constexpr size_t rid = pix + align128(4 * M);
  static constexpr size_t ring = rid + align128(4 * M);
  static constexpr size_t total = ring + kStages * kSlot;
  static_assert(NPW <= kWarps && NT1 * NC1 * 8 == 3 * D,
                "q|k|v pass: a job a warp");
  static_assert(M / 16 / MTO * NCG == kWarps,
                "output projection: a job a warp");
  static_assert(total <= kSmemLimit, "fp32 attention exceeds shared memory");
};

// The window core of one window and head: S = q k^T (q carries the
// scale), + bias_h [- 100 between regions], softmax in fp32, O = P v
// written over q. q, k: 64 x D (ldq); v: 64 x D (ldv); S: 64 x 68. All
// threads call it; it ends synchronised.
template <int D, int ldq, int ldv>
__device__ __forceinline__ void window_core_f32(float* q, const float* k,
                                                const float* v,
                                                const float* bias_h,
                                                const int* rid, float* S) {
  constexpr int lds = 68;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t4 = lane & 3;
  {
    // S: warp w takes m16 tile w / 4 and the n8 tiles 2 (w % 4), + 1
    const int m = warp >> 2, n0 = (warp & 3) * 16;
    float a[1][2][4];
    zero_acc(a);
    warp_mma3<1, 2, D / 8, true>(a, q + m * 16 * ldq, ldq, k + n0 * ldq,
                                 ldq);
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(S + (m * 16 + gq + 8 * hh) * lds + n0 +
                                   n * 8 + 2 * t4) =
            make_float2(a[0][n][2 * hh], a[0][n][2 * hh + 1]);
  }
  __syncthreads();
  // one warp a row, lanes at columns lane and lane + 32 (window_core's)
  for (int t = warp; t < 64; t += kWarps) {
    float l0 = S[t * lds + lane] + bias_h[t * 64 + lane];
    float l1 = S[t * lds + lane + 32] + bias_h[t * 64 + lane + 32];
    if (rid != nullptr) {
      if (rid[t] != rid[lane]) l0 -= 100.0f;
      if (rid[t] != rid[lane + 32]) l1 -= 100.0f;
    }
    const float mx = warp_max(fmaxf(l0, l1));
    const float e0 = expf(l0 - mx), e1 = expf(l1 - mx);
    const float inv = 1.0f / warp_sum(e0 + e1);
    S[t * lds + lane] = e0 * inv;
    S[t * lds + lane + 32] = e1 * inv;
  }
  __syncthreads();
  // O: warp w < 4 D / 8 takes m16 tile w / (D / 8) and n8 tile w % (D / 8)
  constexpr int NN = D / 8;
  if (warp < 4 * NN) {
    const int m = warp / NN, n = warp % NN;
    float a[1][1][4];
    zero_acc(a);
    warp_mma3<1, 1, 8>(a, S + m * 16 * lds, lds, v + n * 8, ldv);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<float2*>(q + (m * 16 + gq + 8 * hh) * ldq + n * 8 +
                                 2 * t4) =
          make_float2(a[0][0][2 * hh], a[0][0][2 * hh + 1]);
  }
  __syncthreads();
}

// Work item `item`: windows item WN .. item WN + WN - 1 of the image's
// (B, H / 8, W / 8) windows (those past the last are skipped). All
// kThreads threads call it; p.windows == 0.
template <int C, int D, int WN>
__device__ void attn_f32_item(const AttnParams<float>& p, int item,
                              unsigned char* smem) {
  using L = AttnF32<C, D, WN>;
  constexpr int S = L::kStages, M = L::M, NQ = L::NQ, TPH = L::TPH,
                KQ = L::KQ, ldx = L::ldx, ldq = L::ldq, ldv = L::ldv;
  const int nH = p.nH, sh = p.shift;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t4 = lane & 3;
  const int n_win = p.B * (p.H / 8) * (p.W / 8);
  const int w0 = item * WN;
  const int nvalid = min(WN, n_win - w0);
  float* xm = reinterpret_cast<float*>(smem + L::xm);
  float* q = reinterpret_cast<float*>(smem + L::q);
  float* k = reinterpret_cast<float*>(smem + L::k);
  float* v = reinterpret_cast<float*>(smem + L::v);
  float* Sb = reinterpret_cast<float*>(smem + L::s);
  int* pix = reinterpret_cast<int*>(smem + L::pix);
  int* rid = reinterpret_cast<int*>(smem + L::rid);
  unsigned char* ring = smem + L::ring;
  const int T = nH * TPH;

  // tile t: head t / TPH; s < NQ: rows [KQ s, +KQ) of the head's D
  // columns of wq, wk and wv side by side; else rows [hD + DO (s - NQ),
  // +DO) x C of wo
  auto load_tile = [&](int t) {
    float* dst = reinterpret_cast<float*>(ring + (t % S) * L::kSlot);
    const int h = t / TPH, s = t % TPH;
    if (s < NQ) {
      constexpr int vpr = D / 4, per = KQ * vpr;
      for (int i = tid; i < 3 * per; i += kThreads) {
        const int pass = i / per, r = (i % per) / vpr, c = (i % vpr) * 4;
        const float* src = pass == 0 ? p.wq : pass == 1 ? p.wk : p.wv;
        const int ld = pass == 0 ? C : p.ldkv;
        cp_async16(dst + r * L::ldw + pass * D + c,
                   src + (size_t)(s * KQ + r) * ld + h * D + c);
      }
    } else {
      cp_tile_f32(dst, L::ldo, p.wo + (size_t)(h * D + (s - NQ) * L::DO) * C,
                  C, L::DO, C);
    }
  };
  for (int t = 0; t < S - 1; ++t) {
    if (t < T) load_tile(t);
    cp_async_commit();
  }

  // the token map of WN windows, then the gather (zeros past the last
  // window) and LN1 + mod
  wide_tokens(p, w0, M, pix, rid);
  __syncthreads();
  {
    constexpr int vpr = C / 4;
    for (int idx = tid; idx < M * vpr; idx += kThreads) {
      const int i = idx / vpr, c = (idx % vpr) * 4;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (pix[i] >= 0)
        val = *reinterpret_cast<const float4*>(p.x + (size_t)pix[i] * C + c);
      *reinterpret_cast<float4*>(xm + i * ldx + c) = val;
    }
  }
  __syncthreads();
  for (int i = warp; i < M; i += kWarps)
    if (pix[i] >= 0)
      ln_row<float>(xm + i * ldx, C, p.ln_s, p.ln_b, p.has_ln,
                    p.mod ? p.mod + (i % 64) * C : nullptr);
  // (the first iteration's barrier orders xm before the products)

  float acco[L::MTO][L::NTO][4];
  zero_acc(acco);
  float acc1[1][L::NT1][4];
  const bool pw = warp < L::NPW;
  const int mt = warp / L::NC1, n1 = (warp % L::NC1) * L::NT1 * 8;
  const int row0 = (warp / L::NCG) * 16 * L::MTO,
            col0 = (warp % L::NCG) * 8 * L::NTO;
  for (int t = 0; t < T; ++t) {
    cp_async_wait<S - 2>();
    __syncthreads();
    // the slot of tile t - 1, which every thread has finished with
    if (t + S - 1 < T) load_tile(t + S - 1);
    cp_async_commit();
    const float* wt =
        reinterpret_cast<const float*>(ring + (t % S) * L::kSlot);
    const int h = t / TPH, s = t % TPH;
    if (s >= NQ) {  // acc += O_h rows of wo (O over q)
      warp_mma3<L::MTO, L::NTO, L::DO / 8>(
          acco, q + row0 * ldq + (s - NQ) * L::DO, ldq, wt + col0, L::ldo);
      continue;
    }
    if (pw) {
      if (s == 0) zero_acc(acc1);
      warp_mma3<1, L::NT1, KQ / 8>(acc1, xm + mt * 16 * ldx + s * KQ, ldx,
                                   wt + n1, L::ldw);
      if (s == NQ - 1) {
        // + bias (q: times the scale) into q, k or v
#pragma unroll
        for (int n = 0; n < L::NT1; ++n) {
          const int col = n1 + n * 8 + 2 * t4;
          const int pass = col / D, d = col % D;
          const float* bias = (pass == 0 ? p.bq : pass == 1 ? p.bk : p.bv) +
                              h * D + d;
          const float scale = pass == 0 ? p.scale : 1.0f;
          float* dst = pass == 0 ? q : pass == 1 ? k : v;
          const int ld = pass == 2 ? ldv : ldq;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            *reinterpret_cast<float2*>(dst + (mt * 16 + gq + 8 * hh) * ld +
                                       d) =
                make_float2((acc1[0][n][2 * hh] + bias[0]) * scale,
                            (acc1[0][n][2 * hh + 1] + bias[1]) * scale);
        }
      }
    }
    if (s < NQ - 1) continue;
    __syncthreads();
    for (int w = 0; w < nvalid; ++w)
      window_core_f32<D, ldq, ldv>(q + w * 64 * ldq, k + w * 64 * ldq,
                                   v + w * 64 * ldv,
                                   p.bias + (size_t)h * 4096,
                                   sh ? rid + w * 64 : nullptr, Sb);
  }

  // + bo [+ x], scattered back through the token map
#pragma unroll
  for (int mi = 0; mi < L::MTO; ++mi)
#pragma unroll
    for (int n = 0; n < L::NTO; ++n)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = row0 + mi * 16 + gq + 8 * hh;
        const int col = col0 + n * 8 + 2 * t4;
        if (pix[row] >= 0) {
          const size_t at = (size_t)pix[row] * C + col;
          float2 o = make_float2(acco[mi][n][2 * hh] + p.bo[col],
                                 acco[mi][n][2 * hh + 1] + p.bo[col + 1]);
          if (p.residual) {
            const float2 xv = *reinterpret_cast<const float2*>(p.x + at);
            o.x += xv.x;
            o.y += xv.y;
          }
          *reinterpret_cast<float2*>(p.y + at) = o;
        }
      }
  cp_async_wait<0>();
  __syncthreads();  // the caller's next item reuses every buffer
}

}  // namespace uf
