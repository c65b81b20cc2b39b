// The whole-stage kernel (stage.cu) at head dims 24, 40, 48 and 56: the
// stages of an --embed_dim 24-56 model that run it (C = 16 D: 384, 640,
// 768, 896), in fp32 and bf16, on the one-window attention body of
// attention_window.cuh (bf16: weights staged in zero-padded chunks) and
// leff_tile (at C 768 and 896 in bf16 its weight chunk staged in pieces).
// Its own translation unit, so that nvcc builds these bodies beside the
// others.
#include "stage.cuh"

namespace uf {

template <typename T>
int stage_heads(const StageParams<T>& p, cudaStream_t stream) {
  return with_new_head_dim(p.C, p.nH, [&](auto d) {
    return launch_stage<T, decltype(d)::value, 0, 1, 0>(p, stream);
  });
}

template int stage_heads<float>(const StageParams<float>&, cudaStream_t);
template int stage_heads<bf16>(const StageParams<bf16>&, cudaStream_t);

}  // namespace uf
