// The bf16 backward core of kernel 6 at windows above 8 (N = win^2 > 64
// tokens, any size), on the H100's tensor cores: per (window, head), with
// S = q k^T scale + bias_h [- 100 where region ids differ] (the fp32
// logits scaled, from the unscaled q, as
// uformer_tpu/ops/pallas/attention_block.py:674-678 takes them),
//
//   P = softmax(S), dP = dO v^T, dS = P (dP - rowsum(dP P)),
//   dq = bf16(dS scale) k, dk = bf16(dS scale)^T q, dv = bf16(P)^T dO,
//   dbias_h += sum over windows of dS (fp32),
//
// the unpacked core of JAX's fused_attention_block_bwd
// (attention_block.py:652-712) with its rounding points: dO (g Wo^T) in
// bf16, P normalised before its rounding, dS in fp32 for dbias and
// (dS scale) rounded once for dq and dk; every product takes bf16
// operands and sums in fp32 (mma.sync's contract). attention_wide_bwd_mma.cu
// instantiates it at head dims 8-64 in steps of 8; fp32 keeps the CUDA-core
// bodies (attention_wide.cu: wide_core_bwd_q / _kv), whose checks hold at
// 1e-4, which the tensor cores could not.
//
// Three passes, FlashAttention-2's deterministic split (no atomics: every
// sum has one owner and a fixed order, so bits repeat):
//
//   1. O and the row statistics: the forward's tensor-core core
//      (wide_core_mma.cuh, STATS) writes O for dWo and, per row, the max
//      and sum of its exponentials and rowsum(dO O) from the fp32 O;
//   2. wide_core_bwd_dq: a block takes a 64-row query tile of G windows
//      (1 or 2) and one head, four warps a window, 16 rows a warp, and
//      walks the 64-key chunks: S = q k^T and dP = dO v^T on
//      mma.sync.m16n8k16 (the k8 tail of D 8, 24, 40 and 56 on m16n8k8),
//      the bias block (staged once for the G windows), the region mask and
//      -inf past N added in the accumulators, P = exp(s - m) / l from the
//      statistics, dS in fp32, dq += bf16(dS scale) k with k through
//      ldmatrix.trans. It is dbias's one writer: the block's live windows'
//      dS summed in window order through shared memory, one fp32 row a
//      (block, head), so the scratch and colsum's read shrink G times;
//   3. wide_core_bwd_dkv: a block takes a 64-key chunk of G windows and one
//      head and walks the query tiles with the keys as the M dimension:
//      S^T = k q^T and dP^T = v dO^T come out in the accumulator layout, so
//      P^T and dS^T become A fragments (acc_to_a) for dv += bf16(P^T) dO
//      and dk += bf16(dS^T scale) q. It recomputes dS and never reads it
//      back; the bias block is read transposed out of shared memory (rows
//      68 floats: the transposed reads hit 32 distinct banks).
//
// Loads: q, dO, K and V tiles (bf16) and the fp32 bias blocks by cp.async
// two stages deep (the streamed operand's next chunk or tile loads while
// this one computes); rows past N and windows past Bw are zero-filled,
// never written and never summed. The fragments are read from shared
// memory by ldmatrix at each chunk (held across chunks, the forward's q
// spilled at D 48-64).
//
// What bounds it on the H100: 18 N^2 D operations a (window, head) over
// the three passes (4 in the first, 6 in the second, 8 in the third)
// against about 12 N D bytes of q, k, v, dO, O, dq, dk and dv and 4 N^2
// of bias (and the G-summed dS, written once and read by colsum): bound by
// operations from N 256 on (the tensor cores' 989 TFLOP/s), with the
// softmax's exponentials and the fp32 elementwise work per logit weighing
// as much as the products at D 8-32. wgmma, TMA, a producer warp and
// 128-row tiles are later work.
#pragma once

#include "wide_core_mma.cuh"

namespace uf {
namespace wide {

constexpr int kBwdMaxG = 2;  // windows a block of the dq and dkv passes

struct BwdMmaArgs {
  CoreArgs a;          // q, k, v at a.in's strides; dO at a.out's
  const bf16* q;       // the group's first window and head
  const bf16* k;
  const bf16* v;
  const bf16* dO;
  const float4* stats; // (Bw, nH, N): m log2 e, 1 / l, rowsum(dO O), 0
  float* ds;           // (ceil(Bw / G), nH, N, N): each block's dS summed
  bf16* dqkv;          // rows of 3C: dq | dk | dv at the group's head
  int C, G, bias16;
};

// Shared memory of wide_core_bwd_dq at head dim D for G windows: two
// stages of the fp32 bias block (64 x 72), per window its q and dO tiles
// and two stages of K and V (bf16, MmaCore's rows), then per window the
// fp32 dS tile it hands to the window sum (64 x 72: the accumulator
// layout's float2 stores hit distinct banks), then two stages of the G
// windows' key region ids.
template <int D>
struct MmaBwdQ {
  static constexpr int ldk = MmaCore<D>::ldk;
  static constexpr int ldb = kR + 8;
  static constexpr size_t tile = (size_t)kR * ldk * sizeof(bf16);
  static constexpr size_t ftile = (size_t)kR * ldb * sizeof(float);
  __host__ __device__ static constexpr size_t bytes(int G) {
    return 2 * ftile + (size_t)G * (6 * tile + ftile) +
           2 * G * kR * sizeof(int);
  }
};

// Shared memory of wide_core_bwd_dkv: two stages of the fp32 bias block
// (64 x 68, read transposed), per window its K and V tiles and two stages
// of q and dO, per window two stages of the query rows' statistics
// (float4), then two stages of the G windows' query region ids.
template <int D>
struct MmaBwdKV {
  static constexpr int ldk = MmaCore<D>::ldk;
  static constexpr int ldb = kR + 4;
  static constexpr size_t tile = (size_t)kR * ldk * sizeof(bf16);
  static constexpr size_t ftile = (size_t)kR * ldb * sizeof(float);
  static constexpr size_t stat = (size_t)kR * sizeof(float4);
  __host__ __device__ static constexpr size_t bytes(int G) {
    return 2 * ftile + (size_t)G * (6 * tile + 2 * stat) +
           2 * G * kR * sizeof(int);
  }
};

// Pass 2: dq and dbias's dS. Block (t, h, wg): query tile t, head h,
// windows wg G .. wg G + G - 1 (tiles fastest).
template <int D>
__global__ void __launch_bounds__(32 * 4 * kBwdMaxG, 1)
    wide_core_bwd_dq(BwdMmaArgs b) {
  using L = MmaBwdQ<D>;
  const CoreArgs& a = b.a;
  const int G = b.G, N = a.N;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Bs = reinterpret_cast<float*>(smem);
  bf16* tiles = reinterpret_cast<bf16*>(smem + 2 * L::ftile);
  // window g's q and dO tiles, and its K (kv 0) or V (kv 1) of stage st
  auto Qs = [&](int g) { return tiles + (size_t)g * 6 * kR * L::ldk; };
  auto DOs = [&](int g) { return Qs(g) + (size_t)kR * L::ldk; };
  auto KVs = [&](int g, int kv, int st) {
    return Qs(g) + (size_t)(2 + 2 * st + kv) * kR * L::ldk;
  };
  float* Xs0 =
      reinterpret_cast<float*>(smem + 2 * L::ftile + (size_t)G * 6 * L::tile);
  auto Xs = [&](int g) { return Xs0 + (size_t)g * kR * L::ldb; };
  int* rk =
      reinterpret_cast<int*>(smem + L::bytes(G) - 2 * G * kR * sizeof(int));

  const int tiles_q = (N + kR - 1) / kR;
  const int qt = blockIdx.x % tiles_q;
  const int h = (blockIdx.x / tiles_q) % a.nH;
  const int wg = blockIdx.x / tiles_q / a.nH, w0 = wg * G;
  const int i0 = qt * kR;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, gq = lane >> 2, t4 = lane & 3;
  const int g = warp >> 2, r0 = (warp & 3) * 16;
  const int w = w0 + g;
  const bool live = w < a.Bw;
  const int nW = (a.H / a.win) * (a.W / a.win);
  const int chunks = tiles_q;

  auto load_chunk = [&](int c, int st) {
    const int j0 = c * kR;
    load_rows_mma<D>([&](int gg) { return KVs(gg, 0, st); }, L::ldk, b.k,
                     a.in, a, G, w0, h, j0);
    load_rows_mma<D>([&](int gg) { return KVs(gg, 1, st); }, L::ldk, b.v,
                     a.in, a, G, w0, h, j0);
    load_bias_block(Bs + (size_t)st * kR * L::ldb, L::ldb, a, h, i0, j0,
                    b.bias16);
    cp_async_commit();
    if (a.shift) stage_regions(rk + st * G * kR, a, G, w0, j0);
  };

  // the q and dO tiles join chunk 0's group
  load_rows_mma<D>(Qs, L::ldk, b.q, a.in, a, G, w0, h, i0);
  load_rows_mma<D>(DOs, L::ldk, b.dO, a.out, a, G, w0, h, i0);
  load_chunk(0, 0);
  if (chunks > 1) load_chunk(1, 1);

  const int wl = (a.w_off + w) % nW;
  const bool mixed = mixes_regions(a, wl);
  int rq[2];
  float mb[2], il[2], di[2];
  bool rowok[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = i0 + r0 + gq + 8 * hh;
    rowok[hh] = live && i < N;
    rq[hh] = mixed && i < N ? region(wl, i, a.H, a.W, a.win, a.shift) : -2;
    float4 st = make_float4(0.f, 0.f, 0.f, 0.f);
    if (rowok[hh]) st = b.stats[((size_t)w * a.nH + h) * N + i];
    mb[hh] = st.x;
    il[hh] = st.y;
    di[hh] = st.z;
  }

  float dq[D / 8][4];
  zero_acc(dq);
  constexpr float kLog2e = 1.4426950408889634f;
  const bf16* qrow = Qs(g) + (r0 + (lane & 15)) * L::ldk;
  const bf16* drow = DOs(g) + (r0 + (lane & 15)) * L::ldk;
  const int nlive = min(G, a.Bw - w0);
  float* dsh = b.ds + ((size_t)wg * a.nH + h) * N * N;

  for (int c = 0; c < chunks; ++c) {
    const int st = c & 1, j0 = c * kR;
    if (c + 1 < chunks)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    if (live) {
      const bf16* ks_ = KVs(g, 0, st);
      float s[8][4], dp[8][4];
      zero_acc(s);
      zero_acc(dp);
      mma_abt<D>(s, qrow, ks_, L::ldk);
      mma_abt<D>(dp, drow, KVs(g, 1, st), L::ldk);
      const float* brow =
          Bs + ((size_t)st * kR + r0 + gq) * L::ldb + 2 * t4;
      const int* rkc = rk + (st * G + g) * kR + 2 * t4;
      float* xrow = Xs(g) + (r0 + gq) * L::ldb + 2 * t4;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float2 bb =
              *reinterpret_cast<const float2*>(brow + hh * 8 * L::ldb + 8 * j);
          float d2[2];
#pragma unroll
          for (int e1 = 0; e1 < 2; ++e1) {
            const int e = 2 * hh + e1;
            float sv = fmaf(s[j][e], a.scale, e1 ? bb.y : bb.x);
            if (mixed && rkc[8 * j + e1] != rq[hh]) sv -= 100.0f;
            // keys past N weigh exactly 0; rows past N and dead rows 0
            const bool keyok = j0 + 8 * j + 2 * t4 + e1 < N;
            const float p = rowok[hh] && keyok
                                ? ex2(fmaf(sv, kLog2e, -mb[hh])) * il[hh]
                                : 0.f;
            d2[e1] = p * (dp[j][e] - di[hh]);
            s[j][e] = d2[e1] * a.scale;
          }
          *reinterpret_cast<float2*>(xrow + hh * 8 * L::ldb + 8 * j) =
              make_float2(d2[0], d2[1]);
        }
      uint32_t pa[4][4];
      acc_to_a(s, pa);
      warp_mma_ra<D / 8, 4>(dq, pa, ks_, L::ldk);
    }
    __syncthreads();  // every warp is done with stage st and its dS tile
    // the block's dS: its live windows' tiles summed in window order
    for (int idx = tid; idx < kR * kR; idx += nthr) {
      const int r = idx / kR, cc = idx % kR, i = i0 + r, j = j0 + cc;
      if (i >= N || j >= N) continue;
      float t = Xs(0)[r * L::ldb + cc];
      for (int gg = 1; gg < nlive; ++gg) t += Xs(gg)[r * L::ldb + cc];
      dsh[(size_t)i * N + j] = t;
    }
    if (c + 2 < chunks) load_chunk(c + 2, st);
  }

  if (!live) return;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = i0 + r0 + gq + 8 * hh;
    if (i >= N) continue;
    bf16* dst = b.dqkv + ((size_t)w * N + i) * 3 * b.C + h * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(dst + 8 * n) =
          pack_bf16(dq[n][2 * hh], dq[n][2 * hh + 1]);
  }
}

// Pass 3: dk and dv. Block (t, h, wg): key chunk t, head h, windows wg G
// .. wg G + G - 1, over the query tiles in order.
template <int D>
__global__ void __launch_bounds__(32 * 4 * kBwdMaxG, 1)
    wide_core_bwd_dkv(BwdMmaArgs b) {
  using L = MmaBwdKV<D>;
  const CoreArgs& a = b.a;
  const int G = b.G, N = a.N;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Bs = reinterpret_cast<float*>(smem);
  bf16* tiles = reinterpret_cast<bf16*>(smem + 2 * L::ftile);
  // window g's K and V tiles, and its q (qd 0) or dO (qd 1) of stage st
  auto Ks = [&](int g) { return tiles + (size_t)g * 6 * kR * L::ldk; };
  auto Vs = [&](int g) { return Ks(g) + (size_t)kR * L::ldk; };
  auto QDs = [&](int g, int qd, int st) {
    return Ks(g) + (size_t)(2 + 2 * st + qd) * kR * L::ldk;
  };
  float4* S0 =
      reinterpret_cast<float4*>(smem + 2 * L::ftile + (size_t)G * 6 * L::tile);
  auto Ss = [&](int g, int st) { return S0 + (size_t)(2 * g + st) * kR; };
  int* rq =
      reinterpret_cast<int*>(smem + L::bytes(G) - 2 * G * kR * sizeof(int));

  const int chunks = (N + kR - 1) / kR, tiles_q = chunks;
  const int kc = blockIdx.x % chunks;
  const int h = (blockIdx.x / chunks) % a.nH;
  const int wg = blockIdx.x / chunks / a.nH, w0 = wg * G;
  const int j0 = kc * kR;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, gq = lane >> 2, t4 = lane & 3;
  const int g = warp >> 2, r0 = (warp & 3) * 16;
  const int w = w0 + g;
  const bool live = w < a.Bw;
  const int nW = (a.H / a.win) * (a.W / a.win);

  // q, dO, the statistics and the bias block of query tile t into stage
  // st, one cp.async group; then (plain stores) the query region ids
  auto load_tile = [&](int t, int st) {
    const int i0 = t * kR;
    load_rows_mma<D>([&](int gg) { return QDs(gg, 0, st); }, L::ldk, b.q,
                     a.in, a, G, w0, h, i0);
    load_rows_mma<D>([&](int gg) { return QDs(gg, 1, st); }, L::ldk, b.dO,
                     a.out, a, G, w0, h, i0);
    for (int idx = tid; idx < G * kR; idx += nthr) {
      const int gg = idx / kR, r = idx % kR, i = i0 + r;
      const bool ok = w0 + gg < a.Bw && i < N;
      cp_async16(Ss(gg, st) + r,
                 b.stats + (ok ? ((size_t)(w0 + gg) * a.nH + h) * N + i : 0),
                 ok);
    }
    load_bias_block(Bs + (size_t)st * kR * L::ldb, L::ldb, a, h, i0, j0,
                    b.bias16);
    cp_async_commit();
    if (a.shift) stage_regions(rq + st * G * kR, a, G, w0, i0);
  };

  // the K and V tiles join tile 0's group
  load_rows_mma<D>(Ks, L::ldk, b.k, a.in, a, G, w0, h, j0);
  load_rows_mma<D>(Vs, L::ldk, b.v, a.in, a, G, w0, h, j0);
  load_tile(0, 0);
  if (tiles_q > 1) load_tile(1, 1);

  const int wl = (a.w_off + w) % nW;
  const bool mixed = mixes_regions(a, wl);
  int rk[2];  // this lane's keys r0 + gq and r0 + gq + 8
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int j = j0 + r0 + gq + 8 * hh;
    rk[hh] = mixed && j < N ? region(wl, j, a.H, a.W, a.win, a.shift) : -2;
  }

  float dk[D / 8][4], dv[D / 8][4];
  zero_acc(dk);
  zero_acc(dv);
  constexpr float kLog2e = 1.4426950408889634f;
  const bf16* krow = Ks(g) + (r0 + (lane & 15)) * L::ldk;
  const bf16* vrow = Vs(g) + (r0 + (lane & 15)) * L::ldk;

  for (int t = 0; t < tiles_q; ++t) {
    const int st = t & 1, i0 = t * kR;
    if (t + 1 < tiles_q)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    if (live) {
      const bf16* qs_ = QDs(g, 0, st);
      const bf16* dos = QDs(g, 1, st);
      float s[8][4], dp[8][4];  // S^T and dP^T: keys x queries
      zero_acc(s);
      zero_acc(dp);
      mma_abt<D>(s, krow, qs_, L::ldk);
      mma_abt<D>(dp, vrow, dos, L::ldk);
      const float* bcol = Bs + (size_t)st * kR * L::ldb + r0 + gq;
      const float4* sts = Ss(g, st);
      const int* rqc = rq + (st * G + g) * kR;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e1 = 0; e1 < 2; ++e1) {
          const int i = 8 * n + 2 * t4 + e1;  // the query, in the tile
          const float4 sti = sts[i];
          const bool qok = i0 + i < N;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int e = 2 * hh + e1;
            float sv = fmaf(s[n][e], a.scale, bcol[i * L::ldb + 8 * hh]);
            if (mixed && rqc[i] != rk[hh]) sv -= 100.0f;
            const float p =
                qok ? ex2(fmaf(sv, kLog2e, -sti.x)) * sti.y : 0.f;
            s[n][e] = p;
            dp[n][e] = p * (dp[n][e] - sti.z) * a.scale;
          }
        }
      uint32_t pa[4][4];
      acc_to_a(s, pa);
      warp_mma_ra<D / 8, 4>(dv, pa, dos, L::ldk);
      acc_to_a(dp, pa);
      warp_mma_ra<D / 8, 4>(dk, pa, qs_, L::ldk);
    }
    __syncthreads();  // every warp is done with stage st
    if (t + 2 < tiles_q) load_tile(t + 2, st);
  }

  if (!live) return;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int j = j0 + r0 + gq + 8 * hh;
    if (j >= N) continue;
    bf16* row = b.dqkv + ((size_t)w * N + j) * 3 * b.C + h * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(row + b.C + 8 * n) =
          pack_bf16(dk[n][2 * hh], dk[n][2 * hh + 1]);
      *reinterpret_cast<uint32_t*>(row + 2 * b.C + 8 * n) =
          pack_bf16(dv[n][2 * hh], dv[n][2 * hh + 1]);
    }
  }
}

}  // namespace wide
}  // namespace uf
