// The whole-stage kernel (stage.cu) at head dims 72-128 in steps of 8:
// the stages of an --embed_dim 72-128 model that run it (C % 128 == 0: C
// 128-2048, e.g. every level of embed 128, the bottleneck and dec0 of
// embed 72), in fp32 and bf16, on the one-window attention body of
// attention_window.cuh at width 80, 96, 112 or 128 (q, k and v projected
// in turn) and leff_tile (its weight chunk staged in pieces from C 768 in
// bf16; its halo in the scratch slots from C 1408). Its own translation
// unit, so that nvcc builds these bodies beside the others.
#include "stage.cuh"

namespace uf {

template <typename T>
int stage_big_heads(const StageParams<T>& p, cudaStream_t stream) {
  return with_big_head_dim(p.C, p.nH, [&](auto d) {
    return launch_stage<T, decltype(d)::value, 0, 1, 0>(p, stream);
  });
}

template int stage_big_heads<float>(const StageParams<float>&, cudaStream_t);
template int stage_big_heads<bf16>(const StageParams<bf16>&, cudaStream_t);

}  // namespace uf
