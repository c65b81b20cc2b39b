// Windows above 8 (N = win^2 > 64 tokens, any size: 81 at window 9, 1024
// at window 32, 4096 at 64) in kernels 4, 5 and 6, for Hopper (sm_90a).
//
// Replaces, at those windows, uformer_tpu/ops/pallas/window_attention.py:
// fused_window_attention (kernel 4), attention_block.py:
// fused_attention_block (kernel 5) and attention_block.py:
// fused_attention_block_bwd (kernel 6). The TPU kernels take a whole
// window (N x N logits) into VMEM; on the H100 a window of 256 tokens at
// C = 512 is 256 KB of bf16 x alone, so nothing here holds a window:
//
//   - the projections stream 64-row tiles of every window's tokens
//     (out = A B + bias, A's rows any tokens, 64 x 64 output tiles, fp32
//     accumulation: wide_gemm_mma on the tensor cores in bf16,
//     wide_gemm_f32 in fp32; [Wq | Wkv] read in place as two parts), with
//     LN1 and the modulator applied first per token (wide_xm, ln_row's
//     arithmetic);
//   - the core takes one head and 64 query rows of a window a block and
//     walks the keys in 64-key chunks with a running max and running sum
//     in fp32 (online softmax), never holding a window's N x N logits. N
//     that is no multiple of 64 pads query rows with zeros (never
//     written) and keys with -inf logits (weight exactly 0); the SW-MSA
//     shift mask is computed inline from each token's region id (JAX's
//     _region_ids: slices from size - win and size - shift). bf16 runs on
//     the tensor cores (wide_core_mma.cuh: G windows a block sharing each
//     staged bias block, K and V by cp.async two stages deep, S and P in
//     registers); fp32 runs wide_core_fwd on the CUDA cores (the 64 x D
//     query tile and one 64 x D chunk of K and V in shared memory, the
//     relative-position bias read per chunk through L2), whose checks
//     hold at 1e-4 with TF32 off, which the tensor cores could not;
//   - the backward recomputes from x as JAX's does: q, k, v by the same
//     projection, the logits q k^T scaled in fp32 (JAX's kernel 6 takes
//     the unscaled q there, where its forward folds the scale into q),
//     then per (window, head, query tile) the softmax statistics over all
//     key chunks first (wide_core_bwd_q, which also writes the head's O
//     for dWo), then per chunk dP = dO v^T and
//     dS = P (dP - rowsum(dO O)), dq = dS k; per (window, head, key chunk)
//     dk = dS^T q and dv = P^T dO over the query tiles (wide_core_bwd_kv).
//     Every sum has one owner and a fixed order: no atomics, bits repeat.
//     dS leaves as fp32 (G, nH' N N) rows of a group of G windows and nH'
//     heads (the caller's pointers offset to the group's first window and
//     head, w_off its first window's place), which colsum folds into
//     dbias group after group in a fixed order: the fp32 scratch is
//     bounded by the caller's budget, not by Bw nH N^2. That is the fp32
//     core, on the CUDA cores; bf16 runs the tensor-core core
//     (wide_core_bwd_mma.cuh, attention_wide_bwd_mma.cu: the forward's core
//     for O and the statistics, then dq and dk | dv at JAX's rounding
//     points, dS summed over each block's windows before it leaves);
//     dxm = [dq | dk | dv] [Wq | Wkv]^T out in fp32;
//     the LayerNorm VJP on that fp32 dxm (JAX's dtok) per token
//     (wide_ln_bwd, with fixed per-block dln partials); dmod is colsum of
//     dxm over windows; dWqkv, dWo by wgrad.cu.
//
// What bounds it on the H100: at the win-16 Uformer's serve stage 0 (C 32,
// one head, 2048 windows of a batch-8 256^2 image) the core's 2 N D
// multiply-adds a token against 2 x 2 D bytes of q, k, v and O make it
// bound by operations (the tensor cores' 989 TFLOP/s) from N 256 on; at
// small D the bias table's bytes and the softmax's exp and fp32
// arithmetic weigh as much as the products (wide_core_mma.cuh says what
// its design does about each). The projections are bound by operations
// from C 64 on and run on the tensor cores in bf16. The backward's fp32
// cores (wide_core_bwd_q, wide_core_bwd_kv) compute on the CUDA cores, a
// simple body whose checks hold at 1e-4; bf16 takes the tensor-core
// backward (wide_core_bwd_mma.cuh), whose times stand beside the bound in
// PERF.md.
#include "common.cuh"
#include "mma_tile.cuh"
#include "wide_core_mma.cuh"
#include "window_core.cuh"

namespace uf {
namespace wide {

constexpr int kT = 256;  // threads of every kernel here
constexpr int ldt = kR + 1;

// Shared-memory tiles of the cores: four fp32 64 x D operand tiles (ld
// D + 1), one 64 x 64 logit / probability tile (ld 65), and 64 rows each
// of the running max, sum and rescale and the query and key region ids.
template <int D>
struct CoreSmem {
  static constexpr int ld = D + 1;
  static constexpr size_t tile = (size_t)kR * ld * sizeof(float);
  static constexpr size_t sq = (size_t)kR * ldt * sizeof(float);
  static constexpr size_t bytes = 4 * tile + sq + 5 * kR * sizeof(float);
};

// Blocks of a (window, head, 64-row tile) grid; block b's indices.
__device__ __forceinline__ void tile_of(int b, int tiles, int nH, int* t,
                                        int* h, int* w) {
  *t = b % tiles;
  b /= tiles;
  *h = b % nH;
  *w = b / nH;
}

// The rounded q tile the logits take: q rounded times the rounded scale
// (the block's `q * scale` in the working dtype, ops/attention.py), or q.
template <typename T, int D>
__device__ void load_q(float* Qs, const T* q, const CoreArgs& a, int w,
                       int h, int i0) {
  const float sc = rnd<T>(a.scale);
  for (int idx = threadIdx.x; idx < kR * D; idx += kT) {
    const int r = idx / D, d = idx % D, i = i0 + r;
    float v = 0.f;
    if (i < a.N) {
      v = to_f<T>(q[a.in.at(w, h, i) + d]);
      if (a.scale_q) v = rnd<T>(v * sc);
    }
    Qs[r * (D + 1) + d] = v;
  }
}

template <typename T, int D>
__device__ void load_rows(float* dst, const T* src, const View& v, int w,
                          int h, int j0, int N) {
  for (int idx = threadIdx.x; idx < kR * D; idx += kT) {
    const int r = idx / D, d = idx % D, j = j0 + r;
    dst[r * (D + 1) + d] = j < N ? to_f<T>(src[v.at(w, h, j) + d]) : 0.f;
  }
}

// The 4 x 4 logits of thread (ty, tx) = (tid / 16, tid % 16): rows
// 4 ty + ii, keys tx + 16 jj of the (i0, j0) tile: q k^T (times the scale
// unless q carries it) + bias, -100 across regions, -inf past N.
template <int D>
__device__ __forceinline__ void logits(float s[4][4], const float* Qs,
                                       const float* Ks, const CoreArgs& a,
                                       int h, int i0, int j0, const int* rq,
                                       const int* rk) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) s[ii][jj] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float qa[4], kb[4];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) qa[ii] = Qs[(4 * ty + ii) * (D + 1) + d];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) kb[jj] = Ks[(tx + 16 * jj) * (D + 1) + d];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[ii][jj] = fmaf(qa[ii], kb[jj], s[ii][jj]);
  }
  const float ls = a.scale_q ? 1.0f : a.scale;
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int r = 4 * ty + ii, i = i0 + r;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int c = tx + 16 * jj, j = j0 + c;
      if (j >= a.N) {
        s[ii][jj] = -INFINITY;
        continue;
      }
      float v = s[ii][jj] * ls;
      if (i < a.N) {
        v += a.bias[((size_t)h * a.N + i) * a.N + j];
        if (a.shift && rq[r] != rk[c]) v -= 100.0f;
      }
      s[ii][jj] = v;
    }
  }
}

__device__ __forceinline__ void regions(int* rid, const CoreArgs& a, int w,
                                        int t0) {
  const int t = threadIdx.x;
  if (t < kR) {
    const int nW = (a.H / a.win) * (a.W / a.win);
    const int wl = (a.w_off + w) % nW;
    rid[t] = t0 + t < a.N ? region(wl, t0 + t, a.H, a.W, a.win, a.shift) : 0;
  }
}

// The forward's online softmax over every key chunk for the block's 64
// query rows: o (this thread's row tid / 4, channels tid % 4 + 4 e)
// unnormalised; m_s, l_s the rows' running max and sum; S a 64 x 65
// scratch tile. Ends synchronised.
template <typename T, int D>
__device__ void online_softmax(float (&o)[D / 4], const float* Qs,
                               float* Ks, float* Vs, float* S, float* m_s,
                               float* l_s, float* a_s, const int* rq,
                               int* rk, const T* k, const T* v,
                               const CoreArgs& a, int w, int h, int i0) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ty = tid / 16, tx = tid % 16, r = tid >> 2, dc = tid & 3;
#pragma unroll
  for (int e = 0; e < D / 4; ++e) o[e] = 0.f;
  const int chunks = (a.N + kR - 1) / kR;
  for (int c = 0; c < chunks; ++c) {
    const int j0 = c * kR;
    __syncthreads();  // the last chunk's K, V and P are read
    load_rows<T, D>(Ks, k, a.in, w, h, j0, a.N);
    load_rows<T, D>(Vs, v, a.in, w, h, j0, a.N);
    regions(rk, a, w, j0);
    __syncthreads();
    float s[4][4];
    logits<D>(s, Qs, Ks, a, h, i0, j0, rq, rk);
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) S[(4 * ty + ii) * ldt + tx + 16 * jj] =
          s[ii][jj];
    __syncthreads();
    for (int rr = warp * 8; rr < warp * 8 + 8; ++rr) {
      const float s0 = S[rr * ldt + lane], s1 = S[rr * ldt + lane + 32];
      const float mx = warp_max(fmaxf(s0, s1));
      const float m_old = c ? m_s[rr] : -INFINITY;
      const float m_new = fmaxf(m_old, mx);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      S[rr * ldt + lane] = p0;
      S[rr * ldt + lane + 32] = p1;
      const float sum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float al = c ? expf(m_old - m_new) : 0.f;
        a_s[rr] = al;
        l_s[rr] = (c ? l_s[rr] * al : 0.f) + sum;
        m_s[rr] = m_new;
      }
    }
    __syncthreads();
    const float al = a_s[r];
#pragma unroll
    for (int e = 0; e < D / 4; ++e) o[e] *= al;
    for (int j = 0; j < kR; ++j) {
      const float p = S[r * ldt + j];
#pragma unroll
      for (int e = 0; e < D / 4; ++e)
        o[e] = fmaf(p, Vs[j * (D + 1) + dc + 4 * e], o[e]);
    }
  }
  __syncthreads();
}

struct Carve {
  float *Qs, *Ks, *Vs, *Xs, *S, *m_s, *l_s, *a_s;
  int *rq, *rk;
};

template <int D>
__device__ Carve carve(unsigned char* smem) {
  using L = CoreSmem<D>;
  Carve c;
  c.Qs = reinterpret_cast<float*>(smem);
  c.Ks = reinterpret_cast<float*>(smem + L::tile);
  c.Vs = reinterpret_cast<float*>(smem + 2 * L::tile);
  c.Xs = reinterpret_cast<float*>(smem + 3 * L::tile);
  c.S = reinterpret_cast<float*>(smem + 4 * L::tile);
  float* tail = reinterpret_cast<float*>(smem + 4 * L::tile + L::sq);
  c.m_s = tail;
  c.l_s = tail + kR;
  c.a_s = tail + 2 * kR;
  c.rq = reinterpret_cast<int*>(tail + 3 * kR);
  c.rk = reinterpret_cast<int*>(tail + 4 * kR);
  return c;
}

// Kernel 4 and kernel 5's fp32 core: out = softmax(logits) v per (window,
// head, query tile), on the CUDA cores (bf16: wide_core_mma.cuh).
template <typename T, int D>
__global__ void __launch_bounds__(kT)
    wide_core_fwd(const T* q, const T* k, const T* v, T* out, CoreArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  Carve m = carve<D>(smem);
  const int tiles = (a.N + kR - 1) / kR;
  int qt, h, w;
  tile_of(blockIdx.x, tiles, a.nH, &qt, &h, &w);
  const int i0 = qt * kR;
  load_q<T, D>(m.Qs, q, a, w, h, i0);
  regions(m.rq, a, w, i0);
  float o[D / 4];
  online_softmax<T, D>(o, m.Qs, m.Ks, m.Vs, m.S, m.m_s, m.l_s, m.a_s, m.rq,
                       m.rk, k, v, a, w, h, i0);
  const int r = threadIdx.x >> 2, dc = threadIdx.x & 3, i = i0 + r;
  if (i < a.N) {
    const float inv = 1.0f / m.l_s[r];
    T* dst = out + a.out.at(w, h, i);
#pragma unroll
    for (int e = 0; e < D / 4; ++e) dst[dc + 4 * e] = from_f<T>(o[e] * inv);
  }
}

// Window and token products such as w N + i and w nH + h are int: the
// wrappers refuse Bw N, Bw nH ceil(N / 64) blocks and the View strides
// past 2^31 - 1 (`attention_wide.check_int32`).
struct BwdArgs {
  CoreArgs a;      // in: the (Bw N, 3C) q | k | v rows; out: o_tok (Bw N, C)
  const float* dO; // (Bw N, C) fp32
  int C;           // the row width (nH may be a group of the heads)
  float* ds;       // (Bw, nH, N, N) fp32 dS
  float* stats;    // (Bw, nH, N, 2): row max, row sum
  void* dqkv;      // (Bw N, 3C)
};

// dq (and O, the statistics, dS) per (window, head, query tile).
template <typename T, int D>
__global__ void __launch_bounds__(kT) wide_core_bwd_q(const T* qkv, T* o_tok,
                                                      BwdArgs b) {
  extern __shared__ __align__(128) unsigned char smem[];
  Carve m = carve<D>(smem);
  const CoreArgs& a = b.a;
  const int tiles = (a.N + kR - 1) / kR, C = b.C;
  int qt, h, w;
  tile_of(blockIdx.x, tiles, a.nH, &qt, &h, &w);
  const int i0 = qt * kR, tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16, r = tid >> 2, dc = tid & 3;
  const T* q = qkv;
  const T* k = qkv + C;
  const T* v = qkv + 2 * C;
  load_q<T, D>(m.Qs, q, a, w, h, i0);
  regions(m.rq, a, w, i0);
  float o[D / 4];
  online_softmax<T, D>(o, m.Qs, m.Ks, m.Vs, m.S, m.m_s, m.l_s, m.a_s, m.rq,
                       m.rk, k, v, a, w, h, i0);
  // dO of the tile (fp32) into Xs; O normalised; rowsum(dO O) into a_s
  float* dOs = m.Xs;
  for (int idx = tid; idx < kR * D; idx += kT) {
    const int rr = idx / D, d = idx % D, i = i0 + rr;
    dOs[rr * (D + 1) + d] =
        i < a.N ? b.dO[(size_t)(w * a.N + i) * C + h * D + d] : 0.f;
  }
  __syncthreads();
  const int i = i0 + r;
  const float inv = 1.0f / m.l_s[r];
  float dsum = 0.f;
#pragma unroll
  for (int e = 0; e < D / 4; ++e) {
    o[e] *= inv;
    dsum = fmaf(o[e], dOs[r * (D + 1) + dc + 4 * e], dsum);
  }
  dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
  dsum += __shfl_xor_sync(0xffffffffu, dsum, 2);
  if (i < a.N) {
    T* dst = o_tok + a.out.at(w, h, i);
#pragma unroll
    for (int e = 0; e < D / 4; ++e) dst[dc + 4 * e] = from_f<T>(o[e]);
    if (dc == 0) {
      float* st = b.stats + ((size_t)(w * a.nH + h) * a.N + i) * 2;
      st[0] = m.m_s[r];
      st[1] = m.l_s[r];
    }
  }
  __syncthreads();
  if (dc == 0) m.a_s[r] = dsum;
  // dS and dq over the key chunks
  float dq[D / 4];
#pragma unroll
  for (int e = 0; e < D / 4; ++e) dq[e] = 0.f;
  const int chunks = tiles;
  for (int c = 0; c < chunks; ++c) {
    const int j0 = c * kR;
    __syncthreads();
    load_rows<T, D>(m.Ks, k, a.in, w, h, j0, a.N);
    load_rows<T, D>(m.Vs, v, a.in, w, h, j0, a.N);
    regions(m.rk, a, w, j0);
    __syncthreads();
    float s[4][4], dp[4][4];
    logits<D>(s, m.Qs, m.Ks, a, h, i0, j0, m.rq, m.rk);
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) dp[ii][jj] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float ga[4], vb[4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) ga[ii] = dOs[(4 * ty + ii) * (D + 1) + d];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) vb[jj] = m.Vs[(tx + 16 * jj) * (D + 1) + d];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          dp[ii][jj] = fmaf(ga[ii], vb[jj], dp[ii][jj]);
    }
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int rr = 4 * ty + ii, ir = i0 + rr;
      const float mr = m.m_s[rr], lr = 1.0f / m.l_s[rr], Dr = m.a_s[rr];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int cc = tx + 16 * jj, j = j0 + cc;
        const float p = j < a.N ? expf(s[ii][jj] - mr) * lr : 0.f;
        const float ds = (ir < a.N && j < a.N) ? p * (dp[ii][jj] - Dr) : 0.f;
        m.S[rr * ldt + cc] = ds;
        if (ir < a.N && j < a.N)
          b.ds[((size_t)(w * a.nH + h) * a.N + ir) * a.N + j] = ds;
      }
    }
    __syncthreads();
    for (int j = 0; j < kR; ++j) {
      const float ds = m.S[r * ldt + j];
#pragma unroll
      for (int e = 0; e < D / 4; ++e)
        dq[e] = fmaf(ds, m.Ks[j * (D + 1) + dc + 4 * e], dq[e]);
    }
  }
  if (i < a.N) {
    // logits = q k^T times the scale (or q rounded times the rounded
    // scale): dq = dS k times that scale
    const float sc = a.scale_q ? rnd<T>(a.scale) : a.scale;
    T* dst = static_cast<T*>(b.dqkv) + (size_t)(w * a.N + i) * 3 * C + h * D;
#pragma unroll
    for (int e = 0; e < D / 4; ++e) dst[dc + 4 * e] = from_f<T>(dq[e] * sc);
  }
}

// dk = dS^T q, dv = P^T dO per (window, head, key chunk), over the query
// tiles in order.
template <typename T, int D>
__global__ void __launch_bounds__(kT) wide_core_bwd_kv(const T* qkv,
                                                       BwdArgs b) {
  extern __shared__ __align__(128) unsigned char smem[];
  Carve m = carve<D>(smem);
  const CoreArgs& a = b.a;
  const int tiles = (a.N + kR - 1) / kR, C = b.C;
  int kc, h, w;
  tile_of(blockIdx.x, tiles, a.nH, &kc, &h, &w);
  const int j0 = kc * kR, tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16, jr = tid >> 2, dc = tid & 3;
  const T* q = qkv;
  const T* k = qkv + C;
  float* dOs = m.Xs;
  load_rows<T, D>(m.Ks, k, a.in, w, h, j0, a.N);
  regions(m.rk, a, w, j0);
  float dk[D / 4], dv[D / 4];
#pragma unroll
  for (int e = 0; e < D / 4; ++e) dk[e] = dv[e] = 0.f;
  for (int qt = 0; qt < tiles; ++qt) {
    const int i0 = qt * kR;
    __syncthreads();
    load_q<T, D>(m.Qs, q, a, w, h, i0);
    for (int idx = tid; idx < kR * D; idx += kT) {
      const int rr = idx / D, d = idx % D, i = i0 + rr;
      dOs[rr * (D + 1) + d] =
          i < a.N ? b.dO[(size_t)(w * a.N + i) * C + h * D + d] : 0.f;
    }
    regions(m.rq, a, w, i0);
    if (tid < kR) {
      const int i = i0 + tid;
      const float* st = b.stats + ((size_t)(w * a.nH + h) * a.N + i) * 2;
      m.m_s[tid] = i < a.N ? st[0] : 0.f;
      m.l_s[tid] = i < a.N ? 1.0f / st[1] : 0.f;
    }
    __syncthreads();
    float s[4][4];
    logits<D>(s, m.Qs, m.Ks, a, h, i0, j0, m.rq, m.rk);
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int rr = 4 * ty + ii;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int cc = tx + 16 * jj;
        const bool live = i0 + rr < a.N && j0 + cc < a.N;
        m.S[rr * ldt + cc] =
            live ? expf(s[ii][jj] - m.m_s[rr]) * m.l_s[rr] : 0.f;
      }
    }
    __syncthreads();
    for (int rr = 0; rr < kR; ++rr) {
      const float p = m.S[rr * ldt + jr];
#pragma unroll
      for (int e = 0; e < D / 4; ++e)
        dv[e] = fmaf(p, dOs[rr * (D + 1) + dc + 4 * e], dv[e]);
    }
    __syncthreads();
    for (int idx = tid; idx < kR * kR; idx += kT) {
      const int rr = idx / kR, cc = idx % kR, i = i0 + rr, j = j0 + cc;
      m.S[rr * ldt + cc] =
          (i < a.N && j < a.N)
              ? b.ds[((size_t)(w * a.nH + h) * a.N + i) * a.N + j]
              : 0.f;
    }
    __syncthreads();
    for (int rr = 0; rr < kR; ++rr) {
      const float ds = m.S[rr * ldt + jr];
#pragma unroll
      for (int e = 0; e < D / 4; ++e)
        dk[e] = fmaf(ds, m.Qs[rr * (D + 1) + dc + 4 * e], dk[e]);
    }
  }
  const int j = j0 + jr;
  if (j < a.N) {
    // logits = q k^T times the scale (or the scaled q's): dk takes it too
    const float ks = a.scale_q ? 1.0f : a.scale;
    T* row = static_cast<T*>(b.dqkv) + (size_t)(w * a.N + j) * 3 * C + h * D;
#pragma unroll
    for (int e = 0; e < D / 4; ++e) {
      row[C + dc + 4 * e] = from_f<T>(dk[e] * ks);
      row[2 * C + dc + 4 * e] = from_f<T>(dv[e]);
    }
  }
}

// The B operand of a projection: its rows (K x Nn, or with BT its
// transpose Nn x K), each of `len` entries, stored as two row-major parts:
// entries [0, split) of row r at b1[r split + c], the rest at b2[r (len -
// split) + c - split] ([Wq | Wkv] without a concatenated copy); b2 null:
// one matrix (split = len). The bias (Nn,) splits at the same column.
template <typename T>
struct BSplit {
  const T* b1;
  const T* b2;
  const float* bias1;
  const float* bias2;
  int split, len;
  __device__ __forceinline__ const T* at(int r, int c) const {
    return c < split ? b1 + (size_t)r * split + c
                     : b2 + (size_t)r * (len - split) + (c - split);
  }
  __device__ __forceinline__ float bias(int n) const {
    if (!bias1) return 0.f;
    return n < split ? bias1[n] : bias2[n - split];
  }
};

// fp32 (the exact-check path): out (M x Nn) = A (M x K, row-major) B +
// bias on the CUDA cores. 64 x 64 output tiles, one a block (blockIdx.x
// along M), 4 x 4 outputs a thread, K in chunks of 16, fp32 sums in K
// order.
template <bool BT>
__global__ void __launch_bounds__(kT)
    wide_gemm_f32(const float* A, BSplit<float> B, float* out, int M, int K,
                  int Nn) {
  __shared__ float As[16][kR + 4];
  __shared__ float Bs[16][kR + 4];
  const int m0 = blockIdx.x * kR, n0 = blockIdx.y * kR, tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  float acc[4][4];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[ii][jj] = 0.f;
  for (int k0 = 0; k0 < K; k0 += 16) {
    for (int i = tid; i < kR * 16; i += kT) {
      const int r = i / 16, kk = i % 16, gm = m0 + r, gk = k0 + kk;
      As[kk][r] = gm < M && gk < K ? A[(size_t)gm * K + gk] : 0.f;
    }
    for (int i = tid; i < kR * 16; i += kT) {
      const int n = BT ? i / 16 : i % kR, kk = BT ? i % 16 : i / kR;
      const int gn = n0 + n, gk = k0 + kk;
      Bs[kk][n] = gn < Nn && gk < K ? *(BT ? B.at(gn, gk) : B.at(gk, gn))
                                    : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) av[ii] = As[kk][4 * ty + ii];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) bv[jj] = Bs[kk][tx + 16 * jj];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[ii][jj] = fmaf(av[ii], bv[jj], acc[ii][jj]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int gm = m0 + 4 * ty + ii;
    if (gm >= M) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int gn = n0 + tx + 16 * jj;
      if (gn < Nn) out[(size_t)gm * Nn + gn] = acc[ii][jj] + B.bias(gn);
    }
  }
}

// bf16: the same product on the tensor cores (mma_tile.cuh's warp_mma):
// 64 x 64 output tiles, K in chunks of kGK brought in by cp.async 16-byte
// copies (zero-filled past M, Nn and K), eight warps each a 16 x 32 slice
// (one m16 tile, four n8 tiles), fp32 accumulators; out in bf16 or fp32.
// K, Nn and the split are multiples of 8 (C is).
constexpr int kGK = 32;
constexpr int kLdA = kGK + 8;  // 80-byte rows: ldmatrix phases conflict-free
constexpr int kLdB = kR + 8;   // a K x N chunk's rows

template <typename TO, bool BT>
__global__ void __launch_bounds__(kT)
    wide_gemm_mma(const bf16* A, BSplit<bf16> B, TO* out, int M, int K,
                  int Nn) {
  __shared__ __align__(128) bf16 As[kR * kLdA];
  __shared__ __align__(128) bf16 Bs[BT ? kR * kLdA : kGK * kLdB];
  const int m0 = blockIdx.x * kR, n0 = blockIdx.y * kR, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = (warp & 3) * 16, wn = (warp >> 2) * 32;
  float acc[1][4][4];
  zero_acc(acc);
  for (int k0 = 0; k0 < K; k0 += kGK) {
    {  // A: 64 rows of 4 x 8 entries, one copy a thread
      const int r = tid >> 2, kk = (tid & 3) * 8, gm = m0 + r, gk = k0 + kk;
      const bool ok = gm < M && gk < K;
      cp_async16(As + r * kLdA + kk, ok ? A + (size_t)gm * K + gk : A, ok);
    }
    if (BT) {  // B^T: 64 rows (n) of 4 x 8 entries (k)
      const int n = tid >> 2, kk = (tid & 3) * 8, gn = n0 + n, gk = k0 + kk;
      const bool ok = gn < Nn && gk < K;
      cp_async16(Bs + n * kLdA + kk, ok ? B.at(gn, gk) : B.b1, ok);
    } else {  // B: 32 rows (k) of 8 x 8 entries (n)
      const int kk = tid >> 3, n = (tid & 7) * 8, gn = n0 + n, gk = k0 + kk;
      const bool ok = gn < Nn && gk < K;
      cp_async16(Bs + kk * kLdB + n, ok ? B.at(gk, gn) : B.b1, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (BT)
      warp_mma<1, 4, kGK / 16, false, true>(acc, As + wm * kLdA, kLdA,
                                            Bs + wn * kLdA, kLdA);
    else
      warp_mma<1, 4, kGK / 16, false, false>(acc, As + wm * kLdA, kLdA,
                                             Bs + wn, kLdB);
    __syncthreads();
  }
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int gm = m0 + wm + (lane >> 2) + 8 * (e >> 1);
      const int gn = n0 + wn + 8 * n + 2 * (lane & 3) + (e & 1);
      if (gm < M && gn < Nn)
        out[(size_t)gm * Nn + gn] = from_f<TO>(acc[0][n][e] + B.bias(gn));
    }
}

// xm = [LN](x) rounded, + mod[t mod N] rounded (ln_row's arithmetic), a
// warp a token.
template <typename T>
__global__ void __launch_bounds__(kT)
    wide_xm(const T* x, const T* mod, const float* ln_s, const float* ln_b,
            T* xm, int M, int N, int C, int has_ln) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kT / 32) + (threadIdx.x >> 5);
  if (row >= M) return;
  const T* xr = x + (size_t)row * C;
  float mean = 0.f, rstd = 0.f;
  if (has_ln) {
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += to_f<T>(xr[c]);
    mean = warp_sum(s) / C;
    float var = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = to_f<T>(xr[c]) - mean;
      var += d * d;
    }
    rstd = 1.0f / sqrtf(warp_sum(var) / C + 1e-5f);
  }
  const T* mr = mod ? mod + (size_t)(row % N) * C : nullptr;
  for (int c = lane; c < C; c += 32) {
    float y = to_f<T>(xr[c]);
    if (has_ln) y = rnd<T>((y - mean) * rstd * ln_s[c] + ln_b[c]);
    if (mr) y = y + to_f<T>(mr[c]);
    xm[(size_t)row * C + c] = from_f<T>(y);
  }
}

constexpr int kMaxCPerLane = 32;  // C <= 1024

// dx from the fp32 dxm: the LayerNorm VJP (statistics from x, as wide_xm
// computes them) or, without LN, dxm rounded; a warp a token, block b
// taking rows [b rows, (b + 1) rows) and writing its dln_s | dln_b sums
// (2C, fp32, the warps' shares added in warp order) to dln_part[b], dln_s
// first, then dln_b through the same shared rows.
template <typename T>
__global__ void __launch_bounds__(kT)
    wide_ln_bwd(const T* x, const float* dxm, const float* ln_s, T* dx,
                float* dln_part, int M, int C, int has_ln, int rows) {
  __shared__ float red[kT / 32][32 * kMaxCPerLane];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float ss[kMaxCPerLane], sb[kMaxCPerLane];
#pragma unroll
  for (int e = 0; e < kMaxCPerLane; ++e) ss[e] = sb[e] = 0.f;
  const int r0 = blockIdx.x * rows, r1 = min(M, r0 + rows);
  for (int row = r0 + warp; row < r1; row += kT / 32) {
    const T* xr = x + (size_t)row * C;
    const float* gr = dxm + (size_t)row * C;
    T* out = dx + (size_t)row * C;
    if (!has_ln) {
      for (int c = lane; c < C; c += 32) out[c] = from_f<T>(gr[c]);
      continue;
    }
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += to_f<T>(xr[c]);
    const float mean = warp_sum(s) / C;
    float var = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = to_f<T>(xr[c]) - mean;
      var += d * d;
    }
    const float rstd = 1.0f / sqrtf(warp_sum(var) / C + 1e-5f);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int e = 0; e < kMaxCPerLane; ++e) {
      const int c = lane + 32 * e;
      if (c < C) {
        const float xh = (to_f<T>(xr[c]) - mean) * rstd;
        const float dxh = gr[c] * ln_s[c];
        s1 += dxh;
        s2 += dxh * xh;
        ss[e] = fmaf(gr[c], xh, ss[e]);
        sb[e] += gr[c];
      }
    }
    s1 = warp_sum(s1) / C;
    s2 = warp_sum(s2) / C;
#pragma unroll
    for (int e = 0; e < kMaxCPerLane; ++e) {
      const int c = lane + 32 * e;
      if (c < C) {
        const float xh = (to_f<T>(xr[c]) - mean) * rstd;
        out[c] = from_f<T>(rstd * (gr[c] * ln_s[c] - s1 - xh * s2));
      }
    }
  }
  if (!has_ln) return;
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int e = 0; e < kMaxCPerLane; ++e) {
      const int c = lane + 32 * e;
      if (c < C) red[warp][c] = half ? sb[e] : ss[e];
    }
    __syncthreads();
    for (int c = threadIdx.x; c < C; c += kT) {
      float t = 0.f;
      for (int wv = 0; wv < kT / 32; ++wv) t += red[wv][c];
      dln_part[(size_t)blockIdx.x * 2 * C + half * C + c] = t;
    }
    __syncthreads();
  }
}

template <typename T, int D>
static int core_fwd_fma(const T* q, const T* k, const T* v, T* out,
                        const CoreArgs& a, cudaStream_t s) {
  const size_t smem = CoreSmem<D>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      wide_core_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e) return (int)e;
  const long long blocks = (long long)a.Bw * a.nH * ((a.N + kR - 1) / kR);
  wide_core_fwd<T, D><<<(unsigned)blocks, kT, smem, s>>>(q, k, v, out, a);
  return (int)cudaGetLastError();
}

// bf16: the tensor-core core, G windows (1, 2 or 4) a block. The bias
// block comes in 16-byte copies where its rows allow them (N % 4 == 0,
// the table 16-byte aligned), else in 4-byte ones.
template <int D>
static int core_fwd_mma(const bf16* q, const bf16* k, const bf16* v,
                        bf16* out, const CoreArgs& a, int G,
                        cudaStream_t s) {
  if (G != 1 && G != 2 && G != kMmaMaxG) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) %
      16)
    return (int)cudaErrorMisalignedAddress;
  if (a.in.sw % 8 || a.in.sh % 8 || a.in.st % 8 || a.out.sw % 8 ||
      a.out.sh % 8 || a.out.st % 8)
    return (int)cudaErrorInvalidValue;
  const size_t smem = MmaCore<D>::bytes(G);
  cudaError_t e = cudaFuncSetAttribute(
      wide_core_mma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e) return (int)e;
  const int bias16 =
      a.N % 4 == 0 && reinterpret_cast<uintptr_t>(a.bias) % 16 == 0;
  const long long blocks =
      (long long)((a.Bw + G - 1) / G) * a.nH * ((a.N + kR - 1) / kR);
  wide_core_mma<D><<<(unsigned)blocks, 128 * G, smem, s>>>(
      q, k, v, out, a, G, bias16, nullptr, nullptr);
  return (int)cudaGetLastError();
}

template <typename T, int D>
static int core_bwd(const T* qkv, T* o_tok, const BwdArgs& b,
                    cudaStream_t s) {
  const size_t smem = CoreSmem<D>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      wide_core_bwd_q<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (!e)
    e = cudaFuncSetAttribute(wide_core_bwd_kv<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e) return (int)e;
  const CoreArgs& a = b.a;
  const long long blocks = (long long)a.Bw * a.nH * ((a.N + kR - 1) / kR);
  wide_core_bwd_q<T, D><<<(unsigned)blocks, kT, smem, s>>>(qkv, o_tok, b);
  e = cudaGetLastError();
  if (e) return (int)e;
  wide_core_bwd_kv<T, D><<<(unsigned)blocks, kT, smem, s>>>(qkv, b);
  return (int)cudaGetLastError();
}

template <typename T, int D>
static int core_fwd(const T* q, const T* k, const T* v, T* out,
                    const CoreArgs& a, int G, cudaStream_t s) {
  if constexpr (std::is_same<T, bf16>::value)
    return core_fwd_mma<D>(q, k, v, out, a, G, s);
  else
    return core_fwd_fma<T, D>(q, k, v, out, a, s);
}

template <typename T>
static int core_fwd_d(int D, const void* q, const void* k, const void* v,
                      void* out, const CoreArgs& a, int G, cudaStream_t s) {
  auto Q = static_cast<const T*>(q);
  auto K = static_cast<const T*>(k);
  auto V = static_cast<const T*>(v);
  auto O = static_cast<T*>(out);
  switch (D) {
    case 8: return core_fwd<T, 8>(Q, K, V, O, a, G, s);
    case 16: return core_fwd<T, 16>(Q, K, V, O, a, G, s);
    case 24: return core_fwd<T, 24>(Q, K, V, O, a, G, s);
    case 32: return core_fwd<T, 32>(Q, K, V, O, a, G, s);
    case 40: return core_fwd<T, 40>(Q, K, V, O, a, G, s);
    case 48: return core_fwd<T, 48>(Q, K, V, O, a, G, s);
    case 56: return core_fwd<T, 56>(Q, K, V, O, a, G, s);
    case 64: return core_fwd<T, 64>(Q, K, V, O, a, G, s);
  }
  return (int)cudaErrorInvalidValue;
}

// fp32 only: bf16 runs attention_wide_bwd_mma.cu
static int core_bwd_d(int D, const void* qkv, void* o_tok, const BwdArgs& b,
                      cudaStream_t s) {
  auto Q = static_cast<const float*>(qkv);
  auto O = static_cast<float*>(o_tok);
  switch (D) {
    case 8: return core_bwd<float, 8>(Q, O, b, s);
    case 16: return core_bwd<float, 16>(Q, O, b, s);
    case 24: return core_bwd<float, 24>(Q, O, b, s);
    case 32: return core_bwd<float, 32>(Q, O, b, s);
    case 40: return core_bwd<float, 40>(Q, O, b, s);
    case 48: return core_bwd<float, 48>(Q, O, b, s);
    case 56: return core_bwd<float, 56>(Q, O, b, s);
    case 64: return core_bwd<float, 64>(Q, O, b, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
static BSplit<T> b_split(const void* b1, const void* b2, int split, int len,
                         const float* bias1, const float* bias2) {
  BSplit<T> b;
  b.b1 = static_cast<const T*>(b1);
  b.b2 = static_cast<const T*>(b2);
  b.bias1 = bias1;
  b.bias2 = bias2;
  b.split = b2 ? split : len;
  b.len = len;
  return b;
}

template <typename TO>
static int gemm_bf16(int b_trans, const void* a, BSplit<bf16> b, void* out,
                     int M, int K, int Nn, cudaStream_t s) {
  if (K % 8 || Nn % 8 || b.split % 8) return (int)cudaErrorInvalidValue;
  const dim3 grid((M + kR - 1) / kR, (Nn + kR - 1) / kR);
  auto A = static_cast<const bf16*>(a);
  auto O = static_cast<TO*>(out);
  if (b_trans)
    wide_gemm_mma<TO, true><<<grid, kT, 0, s>>>(A, b, O, M, K, Nn);
  else
    wide_gemm_mma<TO, false><<<grid, kT, 0, s>>>(A, b, O, M, K, Nn);
  return (int)cudaGetLastError();
}

static int gemm_f32(int b_trans, const void* a, BSplit<float> b, void* out,
                    int M, int K, int Nn, cudaStream_t s) {
  const dim3 grid((M + kR - 1) / kR, (Nn + kR - 1) / kR);
  auto A = static_cast<const float*>(a);
  auto O = static_cast<float*>(out);
  if (b_trans)
    wide_gemm_f32<true><<<grid, kT, 0, s>>>(A, b, O, M, K, Nn);
  else
    wide_gemm_f32<false><<<grid, kT, 0, s>>>(A, b, O, M, K, Nn);
  return (int)cudaGetLastError();
}

static CoreArgs core_args(int Bw, int nH, int N, int H, int W, int win,
                          int shift, int w_off, float scale, int scale_q,
                          const float* bias) {
  CoreArgs a;
  a.bias = bias;
  a.Bw = Bw;
  a.nH = nH;
  a.N = N;
  a.H = H;
  a.W = W;
  a.win = win;
  a.shift = shift;
  a.w_off = w_off;
  a.scale = scale;
  a.scale_q = scale_q;
  return a;
}

}  // namespace wide
}  // namespace uf

using namespace uf;

extern "C" {

// Each returns a cudaError_t. is_bf16 selects bf16 (else fp32) for the
// activations and weight matrices; biases, LayerNorm parameters, the
// (nH, N, N) bias and the fp32 buffers named so are fp32.

// xm (M, C) = [LN](x) + mod[row mod N] (mod (N, C) or null).
int uf_wide_xm(int is_bf16, const void* x, const void* mod,
               const float* ln_s, const float* ln_b, void* xm, int M, int N,
               int C, int has_ln, void* stream) {
  const int blocks = (M + wide::kT / 32 - 1) / (wide::kT / 32);
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    wide::wide_xm<bf16><<<blocks, wide::kT, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(mod), ln_s,
        ln_b, static_cast<bf16*>(xm), M, N, C, has_ln);
  else
    wide::wide_xm<float><<<blocks, wide::kT, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(mod), ln_s,
        ln_b, static_cast<float*>(xm), M, N, C, has_ln);
  return (int)cudaGetLastError();
}

// out (M, Nn) = a (M, K) b + bias; b (K, Nn), or with b_trans (Nn, K),
// its rows split at `split` between b1 and b2 (b2 null: b1 alone), the
// bias (Nn,) between bias1 and bias2 (null: none); out in the working
// dtype, or fp32 with out_f32. bf16 on the tensor cores: K, Nn and split
// multiples of 8.
int uf_wide_gemm(int is_bf16, int b_trans, int out_f32, const void* a,
                 const void* b1, const void* b2, int split,
                 const float* bias1, const float* bias2, void* out, int M,
                 int K, int Nn, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int len = b_trans ? K : Nn;
  if (!is_bf16)
    return wide::gemm_f32(
        b_trans, a, wide::b_split<float>(b1, b2, split, len, bias1, bias2),
        out, M, K, Nn, s);
  const auto b = wide::b_split<bf16>(b1, b2, split, len, bias1, bias2);
  return out_f32 ? wide::gemm_bf16<float>(b_trans, a, b, out, M, K, Nn, s)
                 : wide::gemm_bf16<bf16>(b_trans, a, b, out, M, K, Nn, s);
}

// The core: out = softmax(q k^T [scale] + bias [+ mask]) v per window and
// head. q, k, v share the strides (sw, sh, st) (window, head, token); out
// has its own. scale_q: q is rounded times the rounded scale (the block);
// else the fp32 logits are scaled (kernel 4). bf16 runs the tensor-core
// core with G windows a block (1, 2 or 4; q, k, v and out 16-byte
// aligned, their strides multiples of 8); fp32 the CUDA-core core, which
// ignores G. The caller keeps the strides and the blocks below 2^31.
int uf_wide_core(int is_bf16, const void* q, const void* k, const void* v,
                 int in_sw, int in_sh, int in_st, const float* bias,
                 void* out, int out_sw, int out_sh, int out_st, int Bw,
                 int nH, int N, int D, int H, int W, int win, int shift,
                 int w_off, float scale, int scale_q, int G, void* stream) {
  wide::CoreArgs a = wide::core_args(Bw, nH, N, H, W, win, shift, w_off,
                                     scale, scale_q, bias);
  a.in = {in_sw, in_sh, in_st};
  a.out = {out_sw, out_sh, out_st};
  auto s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? wide::core_fwd_d<bf16>(D, q, k, v, out, a, G, s)
                 : wide::core_fwd_d<float>(D, q, k, v, out, a, G, s);
}

// The fp32 backward core of the block (bf16: uf_wide_core_bwd_mma) on Bw
// windows and nH heads of rows C wide: qkv (Bw N, 3C) rows of q | k | v;
// dO (Bw N, C) fp32; each pointer (and bias, (nH, N, N) of its heads) at
// the group's first window and head, w_off the first window's place in
// its image. Writes o_tok (Bw N, C), dqkv (Bw N, 3C) = dq | dk | dv (dq
// and dk with the scale) in those heads' columns, ds (Bw, nH, N, N) fp32
// and stats (Bw, nH, N, 2).
int uf_wide_core_bwd(const void* qkv, const float* dO, const float* bias,
                     void* o_tok, void* dqkv, float* ds, float* stats,
                     int Bw, int nH, int N, int D, int C, int H, int W,
                     int win, int shift, int w_off, float scale,
                     void* stream) {
  wide::BwdArgs b;
  // the fp32 logits scaled, from the unscaled q, as JAX's backward kernel
  // takes them (attention_block.py:674-678)
  b.a = wide::core_args(Bw, nH, N, H, W, win, shift, w_off, scale, 0, bias);
  b.a.in = {N * 3 * C, D, 3 * C};
  b.a.out = {N * C, D, C};
  b.dO = dO;
  b.C = C;
  b.ds = ds;
  b.stats = stats;
  b.dqkv = dqkv;
  return wide::core_bwd_d(D, qkv, o_tok, b,
                          static_cast<cudaStream_t>(stream));
}

// dx (M, C) from the fp32 dxm (M, C): the LayerNorm VJP with has_ln (its
// dln_s | dln_b sums of each block's `rows` rows into dln_part (blocks,
// 2C)), else dxm rounded. C <= 1024.
int uf_wide_ln_bwd(int is_bf16, const void* x, const float* dxm,
                   const float* ln_s, void* dx, float* dln_part, int M,
                   int C, int has_ln, int rows, int blocks, void* stream) {
  if (C > 32 * wide::kMaxCPerLane) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    wide::wide_ln_bwd<bf16><<<blocks, wide::kT, 0, s>>>(
        static_cast<const bf16*>(x), dxm, ln_s, static_cast<bf16*>(dx),
        dln_part, M, C, has_ln, rows);
  else
    wide::wide_ln_bwd<float><<<blocks, wide::kT, 0, s>>>(
        static_cast<const float*>(x), dxm, ln_s, static_cast<float*>(dx),
        dln_part, M, C, has_ln, rows);
  return (int)cudaGetLastError();
}

}  // extern "C"
