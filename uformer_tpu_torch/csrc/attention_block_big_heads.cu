// Kernel 5 (attention_block.cu) at head dims 72-128 in steps of 8: the
// blocks of an --embed_dim 72-128 model (C = D nH, 72-2048) off the stage
// kernel, on 8x8 windows or packed tiles of smaller ones, in fp32 and
// bf16, on the one-window-per-block body of attention_window.cuh at width
// 80, 96, 112 or 128 (q, k and v projected in turn; bf16 weights staged
// in zero-padded chunks; xm and O in the block's scratch slot where they
// miss shared memory). Its own translation unit, so that nvcc builds these
// bodies beside the others.
#include "attention_block.cuh"

namespace uf {

template <typename T>
int attention_block_big_heads(const AttnParams<T>& p, int blocks,
                              bool packed, cudaStream_t stream) {
  return with_big_head_dim(p.C, p.nH, [&](auto d) {
    constexpr int D = decltype(d)::value;
    return packed ? launch_block<T, D, true>(p, blocks, stream)
                  : launch_block<T, D>(p, blocks, stream);
  });
}

template int attention_block_big_heads<float>(const AttnParams<float>&, int,
                                              bool, cudaStream_t);
template int attention_block_big_heads<bf16>(const AttnParams<bf16>&, int,
                                             bool, cudaStream_t);

}  // namespace uf
