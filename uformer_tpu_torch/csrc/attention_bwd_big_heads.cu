// Kernel 6 (attention_bwd.cu, attention_block_bwd.cu,
// attention_block_bwd_packed.cu) at head dims 72-128 in steps of 8: the
// blocks of an --embed_dim 72-128 model (C = D nH, 72-2048) in their three
// layouts at windows 1-8 (the image's shifted 8x8 windows, (Bw, 64, C)
// windows, packed tiles of smaller ones), in fp32 and bf16, on the
// one-window-per-block body of attention_window_bwd.cuh at width 80, 96,
// 112 or 128 (with_big_head_dim: a head of 72, 88, 104 or 120 over zero
// columns): q, k, v and then dq, dk, dv made in turn in one 64 x D
// accumulator, xm, dO and bf16's fp32 dxm in device memory where they miss
// shared memory. Its own translation unit, so that nvcc builds these
// bodies beside the others.
//
// Replaces uformer_tpu/ops/pallas/attention_block.py:
// fused_attention_block_bwd at head dims above 64 (its hg = 1 head a
// group, :898), in the layouts kernel 6's other units take.
//
// What bounds it on the H100: per window 7 products of 64 x C x C (dO, the
// q, k, v recompute, dxm) and per head eight 64 x 64 x D ones, 14 C^2
// operations a token (58.7 M at C 2048); one window a block runs them
// block-wide with a
// barrier between steps, its weights staged through shared memory 64 rows
// at a time and re-read by every window (from HBM past the L2 at C >=
// 1792 in bf16), so latency and the weights' reads, not the tensor cores'
// rate, set its pace (PERF.md §6).
#include "attention_window_bwd.cuh"

namespace uf {

template <typename T>
int attention_bwd_big_heads(const AttnBwdParams<T>& p, int windows, int map,
                            cudaStream_t stream) {
  return with_big_head_dim(p.C, p.nH, [&](auto d) {
    return launch_attn_bwd_window<T, decltype(d)::value>(p, windows, map,
                                                         stream);
  });
}

template int attention_bwd_big_heads<float>(const AttnBwdParams<float>&,
                                            int, int, cudaStream_t);
template int attention_bwd_big_heads<bf16>(const AttnBwdParams<bf16>&, int,
                                           int, cudaStream_t);

int attention_bwd_big_heads_scratch(int ts, int C, int nH) {
  return with_big_head_dim(C, nH, [&](auto d) {
    return attn_bwd_window_scratch<decltype(d)::value>(ts, C);
  });
}

}  // namespace uf
