// Kernel 5 (attention_block.cu) at head dims 24, 40, 48 and 56: the
// blocks of an --embed_dim 24-56 model (C = D nH, 24-896, no power of
// two), on 8x8 windows or packed tiles of smaller ones, in fp32 and bf16,
// on the one-window-per-block body of attention_window.cuh (bf16: weights
// staged in zero-padded chunks, products 16 wide rounded up). Its own
// translation unit, so that nvcc builds these bodies beside the others.
#include "attention_block.cuh"

namespace uf {

template <typename T>
int attention_block_heads(const AttnParams<T>& p, int blocks, bool packed,
                          cudaStream_t stream) {
  return with_new_head_dim(p.C, p.nH, [&](auto d) {
    constexpr int D = decltype(d)::value;
    return packed ? launch_block<T, D, true>(p, blocks, stream)
                  : launch_block<T, D>(p, blocks, stream);
  });
}

template int attention_block_heads<float>(const AttnParams<float>&, int,
                                          bool, cudaStream_t);
template int attention_block_heads<bf16>(const AttnParams<bf16>&, int, bool,
                                         cudaStream_t);

}  // namespace uf
