// Kernel 6 (attention_bwd.cu, attention_block_bwd.cu,
// attention_block_bwd_packed.cu) at head dims 24, 40, 48 and 56: the
// blocks of an --embed_dim 24-56 model (C = D nH, 24-896, no power of
// two) in their three layouts at windows 1-8 (the image's shifted 8x8
// windows, (Bw, 64, C) windows, packed tiles of smaller ones), in fp32 and
// bf16, on the one-window-per-block body of attention_window_bwd.cuh
// (bf16: WMMA products through zero-padded staged operands, dxm in fp32).
// Its own translation unit, so that nvcc builds these bodies beside the
// others and the old head dims' instantiations keep their bits.
//
// What bounds it on the H100: as the other head dims' kernel 6, per
// window 7 products of 64 x C x C and the per-head softmax VJP; this
// body runs them block-wide with a barrier between steps and its weights
// staged through shared memory chunk by chunk, so latency, not the
// tensor cores' rate or the bytes, sets its pace (PERF.md §6).
#include "attention_window_bwd.cuh"

namespace uf {

template <typename T>
int attention_bwd_heads(const AttnBwdParams<T>& p, int windows, int map,
                        cudaStream_t stream) {
  return with_new_head_dim(p.C, p.nH, [&](auto d) {
    return launch_attn_bwd_window<T, decltype(d)::value>(p, windows, map,
                                                         stream);
  });
}

template int attention_bwd_heads<float>(const AttnBwdParams<float>&, int,
                                        int, cudaStream_t);
template int attention_bwd_heads<bf16>(const AttnBwdParams<bf16>&, int, int,
                                       cudaStream_t);

int attention_bwd_heads_scratch(int ts, int C, int nH) {
  return with_new_head_dim(C, nH, [&](auto d) {
    return attn_bwd_window_scratch<decltype(d)::value>(ts, C);
  });
}

}  // namespace uf
