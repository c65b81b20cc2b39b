// Kernel 6's bf16 backward core at windows above 8 on the tensor cores
// (wide_core_bwd_mma.cuh), in a translation unit of its own so that the
// build's one nvcc process a source compiles it beside attention_wide.cu.
// Replaces, in bf16, attention_wide.cu's CUDA-core wide_core_bwd_q and
// wide_core_bwd_kv (which keep fp32) for
// uformer_tpu/ops/pallas/attention_block.py: fused_attention_block_bwd's
// unpacked core (:652-712).
#include "common.cuh"
#include "mma_tile.cuh"
#include "wide_core_bwd_mma.cuh"
#include "wide_core_mma.cuh"

namespace uf {
namespace wide {

template <typename F>
static cudaError_t smem_limit(F kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The three passes on one group: O and the statistics (the forward's core
// with STATS, Gf windows a block), then dq and dS, then dk and dv (G
// windows a block each).
template <int D>
static int core_bwd_mma(bf16* o_tok, const BwdMmaArgs& b, int Gf,
                        cudaStream_t s) {
  const CoreArgs& a = b.a;
  const int tiles = (a.N + kR - 1) / kR;
  cudaError_t e = smem_limit(wide_core_mma<D, true>, MmaCore<D>::bytes(Gf));
  if (!e) e = smem_limit(wide_core_bwd_dq<D>, MmaBwdQ<D>::bytes(b.G));
  if (!e) e = smem_limit(wide_core_bwd_dkv<D>, MmaBwdKV<D>::bytes(b.G));
  if (e) return (int)e;
  const long long fblocks = (long long)((a.Bw + Gf - 1) / Gf) * a.nH * tiles;
  wide_core_mma<D, true><<<(unsigned)fblocks, 128 * Gf, MmaCore<D>::bytes(Gf),
                           s>>>(b.q, b.k, b.v, o_tok, a, Gf, b.bias16, b.dO,
                                const_cast<float4*>(b.stats));
  e = cudaGetLastError();
  if (e) return (int)e;
  const long long blocks =
      (long long)((a.Bw + b.G - 1) / b.G) * a.nH * tiles;
  wide_core_bwd_dq<D><<<(unsigned)blocks, 128 * b.G, MmaBwdQ<D>::bytes(b.G),
                        s>>>(b);
  e = cudaGetLastError();
  if (e) return (int)e;
  wide_core_bwd_dkv<D><<<(unsigned)blocks, 128 * b.G,
                         MmaBwdKV<D>::bytes(b.G), s>>>(b);
  return (int)cudaGetLastError();
}

}  // namespace wide
}  // namespace uf

using namespace uf;

extern "C" {

// The bf16 backward core of the block on Bw windows and nH heads of rows C
// wide: qkv (Bw N, 3C) rows of q | k | v and dO (Bw N, C), both bf16; each
// pointer (and bias, (nH, N, N) fp32 of its heads) at the group's first
// window and head, w_off the first window's place in its image. Writes
// o_tok (Bw N, C), dqkv (Bw N, 3C) = dq | dk | dv (dq and dk with the
// scale) in those heads' columns, ds (ceil(Bw / G), nH, N, N) fp32: each
// block's G windows' dS summed in window order, and stats (Bw, nH, N)
// float4. G (1 or 2) windows a block of the dq and dk | dv passes, Gf (1,
// 2 or 4) of the first; pointers 16-byte aligned, C a multiple of 8. The
// caller keeps the strides, blocks and dS rows below 2^31.
int uf_wide_core_bwd_mma(const void* qkv, const void* dO, const float* bias,
                         void* o_tok, void* dqkv, float* ds, void* stats,
                         int Bw, int nH, int N, int D, int C, int H, int W,
                         int win, int shift, int w_off, float scale, int G,
                         int Gf, void* stream) {
  if ((G != 1 && G != wide::kBwdMaxG) ||
      (Gf != 1 && Gf != 2 && Gf != wide::kMmaMaxG) || C % 8)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(qkv) | reinterpret_cast<uintptr_t>(dO) |
       reinterpret_cast<uintptr_t>(o_tok) |
       reinterpret_cast<uintptr_t>(dqkv) |
       reinterpret_cast<uintptr_t>(stats)) %
      16)
    return (int)cudaErrorMisalignedAddress;
  wide::BwdMmaArgs b;
  wide::CoreArgs& a = b.a;
  a.in = {N * 3 * C, D, 3 * C};
  a.out = {N * C, D, C};
  a.bias = bias;
  a.Bw = Bw;
  a.nH = nH;
  a.N = N;
  a.H = H;
  a.W = W;
  a.win = win;
  a.shift = shift;
  a.w_off = w_off;
  a.scale = scale;  // the fp32 logits scaled, from the unscaled q
  a.scale_q = 0;
  auto Q = static_cast<const bf16*>(qkv);
  b.q = Q;
  b.k = Q + C;
  b.v = Q + 2 * C;
  b.dO = static_cast<const bf16*>(dO);
  b.stats = static_cast<const float4*>(stats);
  b.ds = ds;
  b.dqkv = static_cast<bf16*>(dqkv);
  b.C = C;
  b.G = G;
  b.bias16 = N % 4 == 0 && reinterpret_cast<uintptr_t>(bias) % 16 == 0;
  auto O = static_cast<bf16*>(o_tok);
  auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 8: return wide::core_bwd_mma<8>(O, b, Gf, s);
    case 16: return wide::core_bwd_mma<16>(O, b, Gf, s);
    case 24: return wide::core_bwd_mma<24>(O, b, Gf, s);
    case 32: return wide::core_bwd_mma<32>(O, b, Gf, s);
    case 40: return wide::core_bwd_mma<40>(O, b, Gf, s);
    case 48: return wide::core_bwd_mma<48>(O, b, Gf, s);
    case 56: return wide::core_bwd_mma<56>(O, b, Gf, s);
    case 64: return wide::core_bwd_mma<64>(O, b, Gf, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
