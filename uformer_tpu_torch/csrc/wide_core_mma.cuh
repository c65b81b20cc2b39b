// The bf16 forward core of kernels 4 and 5 at windows above 8 (N = win^2
// > 64 tokens, any size), on the H100's tensor cores:
//
//   O = softmax(q k^T [* scale] + bias_h [- 100 where region ids differ]) v
//
// per (window, head), the function of
// uformer_tpu/ops/pallas/window_attention.py:41-78 (kernel 4: the fp32
// logits scaled) and attention_block.py:285-318 (kernel 5: the scale
// folded into q, rounded after the projection). attention_wide.cu
// instantiates it for bf16 at head dims 8-64 in steps of 8; fp32 keeps
// the CUDA-core body there (wide_core_fwd<float, D>), whose checks the
// tensor cores could not pass.
//
// A block takes one head and one 64-row query tile over G windows (1, 2
// or 4: the host's rule, attention_wide.core_windows), four warps a
// window, each warp 16 query rows, and walks the keys in 64-key chunks:
//
//   - loads: each chunk's K and V (bf16, 64 x D a window) and the head's
//     fp32 64 x 64 bias block come in by cp.async, two stages in flight,
//     so chunk c + 1 loads while chunk c computes; rows and columns past
//     N and windows past Bw are zero-filled. The bias block depends on
//     (h, i, j) only, so one copy serves the block's G windows: the L2
//     reads of the bias table fall by G against one window a block;
//   - q: the block's q tiles stay in shared memory (kernel 5's rounded
//     times the rounded scale there, once); each warp reads its 16 rows'
//     A fragments by ldmatrix at each chunk, which leaves the registers
//     to S, P and O (held across chunks, they spilled at D 48-64);
//   - S = q k^T on mma.sync.m16n8k16 (the k8 tail of D 8, 24, 40 and 56
//     on m16n8k8), fp32 in the accumulator registers: eight n8 tiles a
//     warp a chunk. The bias, the -100 region mask (key region ids staged
//     per chunk, query ids in registers; only windows of the image's last
//     row or column of windows mix regions) and -inf past N are added
//     there;
//   - online softmax in fp32 with quad shuffles: running max and sum per
//     row, the accumulator rescaled when the max grows;
//   - P = exp(s - m) rounded to bf16 unnormalised and repacked from the
//     accumulator layout into A fragments (acc_to_a), O += P v on
//     mma.sync with V through ldmatrix.trans, fp32;
//   - O divided by the row sum once and rounded to bf16 once.
//
// The rounding points move against the plain version's (JAX's), which
// rounds the normalised probabilities: this core rounds exp(s - m_run)
// before the division. An emulation of both on the CPU
// (tests/test_torch_port_wide_core_mma.py) holds them within the bf16
// gates; PERF.md gives the ratios.
//
// With STATS (the backward's first pass, wide_core_bwd_mma.cuh) it also
// writes each live row's statistics as a float4 (m log2 e, 1 / l,
// rowsum(dO O), 0) at stats[(w nH + h) N + i]: the row max and sum of the
// same exponentials, and JAX's rowsum(dP P) taken from the fp32 O before
// its rounding and from dO (bf16, at O's strides).
//
// What bounds it on the H100: 4 N^2 D operations a (window, head) against
// 8 N D bytes of q, k, v and O: operations from N 256 on at D 32 (the
// tensor cores' 989 TFLOP/s); the softmax's exp and its fp32 arithmetic
// (an exp2 on the SFU and ~10 fp32 operations a logit) cost as much as
// the products at D 32 and more at D 8-16, and at small D the bias table
// (nH N^2 4 bytes) outweighs q, k, v. The design answers with bf16
// operands in registers, no S or P through shared memory, the bias block
// shared by G windows and loads overlapped with compute. On an H100 the
// products run at 70-110 TFLOP/s; each block reads a window's K and V
// once a query tile and the bias blocks through L2, which PERF.md counts
// as the likely limit. mma.sync is the rule here: it reuses
// mma_tile.cuh's and window_core_mma.cuh's tested building blocks. wgmma,
// TMA copies, a producer warp and 128-row query tiles are later work.
#pragma once

#include <cfloat>

#include "window_core.cuh"
#include "window_core_mma.cuh"

namespace uf {
namespace wide {

constexpr int kR = 64;  // query rows of a tile, keys of a chunk

// Region id (0..8) of token t of the window at place wl of the image's
// (H / win) x (W / win) windows (row-major) at shift s; 0 unshifted.
__device__ __forceinline__ int region(int wl, int t, int H, int W, int win,
                                      int s) {
  if (!s) return 0;
  const int nWw = W / win;
  return 3 * region_id_w((wl / nWw) * win + t / win, H, s, win) +
         region_id_w((wl % nWw) * win + t % win, W, s, win);
}

// A per-head operand of (window w, head h, token t, channel d) at
// base + w sw + h sh + t st + d (the wrappers keep each stride below 2^31).
struct View {
  int sw, sh, st;
  __device__ __forceinline__ size_t at(int w, int h, int t) const {
    return (size_t)w * sw + (size_t)h * sh + (size_t)t * st;
  }
};

struct CoreArgs {
  View in, out;
  const float* bias;  // (nH, N, N)
  int Bw, nH, N, H, W, win, shift, w_off;
  float scale;        // applied to q (scale_q) or to the fp32 logits
  int scale_q;        // 1: q rounded times the rounded scale (kernel 5)
};

constexpr int kMmaMaxG = 4;  // windows a block of the tensor-core core

// Shared memory of wide_core_mma at head dim D for G windows: the bias
// block's two stages (fp32, 64 x 72: float2 reads of a quad's rows hit
// distinct banks), then per window the q tile and two stages of K and V
// (bf16, rows an odd number of 16-byte units: ldmatrix phases
// conflict-free), then two stages of the G windows' 64 key region ids.
template <int D>
struct MmaCore {
  static constexpr int ldk = D + ((D / 8) % 2 ? 16 : 8);
  static constexpr int ldb = kR + 8;
  static constexpr size_t tile = (size_t)kR * ldk * sizeof(bf16);
  static constexpr size_t bias_stage = (size_t)kR * ldb * sizeof(float);
  __host__ __device__ static constexpr size_t bytes(int G) {
    return 2 * bias_stage + (size_t)G * 5 * tile + 2 * G * kR * sizeof(int);
  }
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// 2^x on the SFU (ex2.approx.ftz: 2 ulp; results below 2^-126 flush to
// 0, where a weight's bf16 rounding is long past mattering)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The 64 x 64 fp32 bias block of head h, rows i0.., columns j0.., into
// `bs` (row stride ldb), zero past N: 16-byte copies where the rows allow
// them (bias16), else 4-byte ones. Part of the caller's cp.async group.
__device__ __forceinline__ void load_bias_block(float* bs, int ldb,
                                                const CoreArgs& a, int h,
                                                int i0, int j0, int bias16) {
  const int N = a.N, tid = threadIdx.x, nthr = blockDim.x;
  if (bias16) {
    for (int idx = tid; idx < kR * kR / 4; idx += nthr) {
      const int r = idx / (kR / 4), c4 = (idx % (kR / 4)) * 4;
      const int i = i0 + r, j = j0 + c4;
      const bool ok = i < N && j < N;
      cp_async16(bs + r * ldb + c4,
                 a.bias + (ok ? ((size_t)h * N + i) * N + j : 0), ok);
    }
  } else {
    for (int idx = tid; idx < kR * kR; idx += nthr) {
      const int r = idx / kR, cc = idx % kR, i = i0 + r, j = j0 + cc;
      const bool ok = i < N && j < N;
      cp_async4(bs + r * ldb + cc,
                a.bias + (ok ? ((size_t)h * N + i) * N + j : 0), ok);
    }
  }
}

// 64 rows from t0 of one operand (bf16, D wide, at view `vw`) of the G
// windows from w0 into the tiles tile(gg) (row stride ldk), zero-filled
// past N and Bw. Part of the caller's cp.async group.
template <int D, typename F>
__device__ __forceinline__ void load_rows_mma(F tile, int ldk,
                                              const bf16* src, const View& vw,
                                              const CoreArgs& a, int G,
                                              int w0, int h, int t0) {
  constexpr int P8 = D / 8;
  for (int idx = threadIdx.x; idx < G * kR * P8; idx += blockDim.x) {
    const int gg = idx / (kR * P8), r = (idx / P8) % kR, p = idx % P8;
    const int t = t0 + r;
    const bool ok = w0 + gg < a.Bw && t < a.N;
    cp_async16(tile(gg) + r * ldk + 8 * p,
               src + (ok ? vw.at(w0 + gg, h, t) + 8 * p : 0), ok);
  }
}

// acc[8][4] += A[16 x D] B^T, A's 16 rows at `arow` (lane & 15's row of a
// 16-row slice, ldmatrix-ready), B a 64 x D tile stored row-major (N x K).
template <int D>
__device__ __forceinline__ void mma_abt(float (&acc)[8][4], const bf16* arow,
                                        const bf16* B, int ldk) {
  constexpr int KF = D / 16, TAIL = D % 16;
  const int lane = threadIdx.x & 31;
  if constexpr (KF > 0) {
    uint32_t fa[KF][4];
#pragma unroll
    for (int ks = 0; ks < KF; ++ks)
      ldsm_x4(fa[ks], arow + ks * 16 + (lane >> 4) * 8);
    warp_mma_ra<8, KF, true>(acc, fa, B, ldk);
  }
  if constexpr (TAIL != 0) {  // the k8 tail: one m16k8 fragment
    uint32_t r2[2];
    ldsm_x2(r2, arow + KF * 16);
    const uint32_t t8[4] = {r2[0], r2[1], 0u, 0u};
    warp_mma_ra8<8, true>(acc, t8, B + KF * 16, ldk);
  }
}

// Whether the window at place wl of the image mixes regions: shifted,
// in the image's last row or column of windows.
__device__ __forceinline__ bool mixes_regions(const CoreArgs& a, int wl) {
  const int nWw = a.W / a.win;
  return a.shift && ((wl / nWw) * a.win >= a.H - a.win ||
                     (wl % nWw) * a.win >= a.W - a.win);
}

// The region ids of tokens t0 .. t0 + 63 of the G windows from w0 into
// dst[gg 64 + t], -1 past N and Bw: plain stores, read after the caller's
// next barrier.
__device__ __forceinline__ void stage_regions(int* dst, const CoreArgs& a,
                                              int G, int w0, int t0) {
  const int nW = (a.H / a.win) * (a.W / a.win);
  for (int idx = threadIdx.x; idx < G * kR; idx += blockDim.x) {
    const int gg = idx / kR, t = t0 + idx % kR;
    dst[idx] = w0 + gg < a.Bw && t < a.N
                   ? region((a.w_off + w0 + gg) % nW, t, a.H, a.W, a.win,
                            a.shift)
                   : -1;
  }
}

// Block (t, h, wg): query tile t, head h, windows wg G .. wg G + G - 1
// (tiles fastest, so neighbouring blocks share a window's K and V).
template <int D, bool STATS = false>
__global__ void __launch_bounds__(32 * 4 * kMmaMaxG, 1)
    wide_core_mma(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                  CoreArgs a, int G, int bias16, const bf16* dO,
                  float4* stats) {
  using L = MmaCore<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Bs = reinterpret_cast<float*>(smem);
  bf16* tiles = reinterpret_cast<bf16*>(smem + 2 * L::bias_stage);
  // window g's q tile, and its K (kv 0) or V (kv 1) tile of stage st
  auto Qs = [&](int g) { return tiles + (size_t)g * 5 * kR * L::ldk; };
  auto KVs = [&](int g, int kv, int st) {
    return Qs(g) + (size_t)(1 + 2 * st + kv) * kR * L::ldk;
  };
  int* rk = reinterpret_cast<int*>(smem + 2 * L::bias_stage + G * 5 * L::tile);

  const int tiles_q = (a.N + kR - 1) / kR;
  const int qt = blockIdx.x % tiles_q;
  const int h = (blockIdx.x / tiles_q) % a.nH;
  const int w0 = blockIdx.x / tiles_q / a.nH * G;
  const int i0 = qt * kR, N = a.N;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, gq = lane >> 2, t4 = lane & 3;
  const int g = warp >> 2, r0 = (warp & 3) * 16;  // window, first row
  const int w = w0 + g;
  const bool live = w < a.Bw;
  const int nW = (a.H / a.win) * (a.W / a.win);
  const int chunks = (N + kR - 1) / kR;

  // K, V and the bias block of chunk c into stage st, one cp.async group;
  // then (plain stores, read after the next barriers) the key region ids
  auto load_chunk = [&](int c, int st) {
    const int j0 = c * kR;
    load_rows_mma<D>([&](int gg) { return KVs(gg, 0, st); }, L::ldk, k,
                     a.in, a, G, w0, h, j0);
    load_rows_mma<D>([&](int gg) { return KVs(gg, 1, st); }, L::ldk, v,
                     a.in, a, G, w0, h, j0);
    load_bias_block(Bs + (size_t)st * kR * L::ldb, L::ldb, a, h, i0, j0,
                    bias16);
    cp_async_commit();
    if (a.shift) stage_regions(rk + st * G * kR, a, G, w0, j0);
  };

  // the q tiles join chunk 0's group
  load_rows_mma<D>(Qs, L::ldk, q, a.in, a, G, w0, h, i0);
  load_chunk(0, 0);
  if (chunks > 1) load_chunk(1, 1);

  // this lane's rows r0 + gq and r0 + gq + 8: their region ids, and
  // whether the window mixes regions (the image's last row or column of
  // windows, shifted)
  const int wl = (a.w_off + w) % nW;
  const bool mixed = mixes_regions(a, wl);
  int rq[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = i0 + r0 + gq + 8 * hh;
    rq[hh] = mixed && i < N ? region(wl, i, a.H, a.W, a.win, a.shift) : -2;
  }

  float o[D / 8][4];
  zero_acc(o);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const float ls = a.scale_q ? 1.0f : a.scale;
  constexpr float kLog2e = 1.4426950408889634f;
  const bf16* qrow = Qs(g) + (r0 + (lane & 15)) * L::ldk;

  for (int c = 0; c < chunks; ++c) {
    const int st = c & 1, j0 = c * kR;
    if (c + 1 < chunks)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    if (c == 0 && a.scale_q) {  // q rounded times the rounded scale, once
      const float sc = rnd<bf16>(a.scale);
      for (int idx = tid; idx < G * kR * (D / 2); idx += nthr) {
        const int gg = idx / (kR * (D / 2)), r = (idx / (D / 2)) % kR;
        auto* p2 = reinterpret_cast<__nv_bfloat162*>(
            Qs(gg) + r * L::ldk + 2 * (idx % (D / 2)));
        const float2 f = __bfloat1622float2(*p2);
        *p2 = __floats2bfloat162_rn(f.x * sc, f.y * sc);
      }
      __syncthreads();
    }
    if (live) {
      const bf16* ks_ = KVs(g, 0, st);
      float s[8][4];
      zero_acc(s);
      mma_abt<D>(s, qrow, ks_, L::ldk);  // q's fragments read each chunk
      const float* brow =
          Bs + ((size_t)st * kR + r0 + gq) * L::ldb + 2 * t4;
      const int* rkc = rk + (st * G + g) * kR + 2 * t4;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float2 bb =
              *reinterpret_cast<const float2*>(brow + hh * 8 * L::ldb + 8 * j);
          s[j][2 * hh] = fmaf(s[j][2 * hh], ls, bb.x);
          s[j][2 * hh + 1] = fmaf(s[j][2 * hh + 1], ls, bb.y);
        }
      if (mixed)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (rkc[8 * j + (e & 1)] != rq[e >> 1]) s[j][e] -= 100.0f;
      if (j0 + kR > N)  // keys past N weigh exactly 0
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (j0 + 8 * j + 2 * t4 + (e & 1) >= N) s[j][e] = -INFINITY;
      float mb[2], al[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = m[hh];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          mx = fmaxf(mx, fmaxf(s[j][2 * hh], s[j][2 * hh + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        al[hh] = ex2((m[hh] - mx) * kLog2e);  // 0 at the first chunk
        m[hh] = mx;
        mb[hh] = mx * kLog2e;
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = ex2(fmaf(s[j][e], kLog2e, -mb[e >> 1]));
          sum[e >> 1] += s[j][e];
        }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) l[hh] = fmaf(l[hh], al[hh], sum[hh]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] *= al[e >> 1];
      uint32_t pa[4][4];
      acc_to_a(s, pa);
      warp_mma_ra<D / 8, 4>(o, pa, KVs(g, 1, st), L::ldk);
    }
    __syncthreads();  // every warp is done with stage st
    if (c + 2 < chunks) load_chunk(c + 2, st);
  }

  if (!live) return;
  float inv[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float t = l[hh];
    t += __shfl_xor_sync(0xffffffffu, t, 1);
    t += __shfl_xor_sync(0xffffffffu, t, 2);
    inv[hh] = 1.0f / t;
  }
  if constexpr (STATS) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int i = i0 + r0 + gq + 8 * hh;
      float dsum = 0.f;
      if (i < N) {
        const bf16* drow = dO + a.out.at(w, h, i) + 2 * t4;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          const float2 d2 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(drow + 8 * n));
          dsum = fmaf(o[n][2 * hh] * inv[hh], d2.x, dsum);
          dsum = fmaf(o[n][2 * hh + 1] * inv[hh], d2.y, dsum);
        }
      }
      dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
      dsum += __shfl_xor_sync(0xffffffffu, dsum, 2);
      if (i < N && t4 == 0)
        stats[((size_t)w * a.nH + h) * N + i] =
            make_float4(m[hh] * kLog2e, inv[hh], dsum, 0.f);
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = i0 + r0 + gq + 8 * hh;
    if (i >= N) continue;
    bf16* dst = out + a.out.at(w, h, i) + 2 * t4;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(dst + 8 * n) =
          pack_bf16(o[n][2 * hh] * inv[hh], o[n][2 * hh + 1] * inv[hh]);
  }
}

}  // namespace wide
}  // namespace uf
