// The whole-stage kernel (stage.cu) in fp32 at head dim 32 (Uformer_B's
// and Uformer_S's stages, C 64-512) on the three-pass TF32 bodies:
// attention_f32.cuh's attention half and leff_f32.cuh's LeFF tile. Its
// own translation unit, so that nvcc builds these bodies beside the
// others; stage_f32_d16.cu holds head dim 16.
#include "stage.cuh"

namespace uf {

template int stage_f32<32>(const StageParams<float>&, int, cudaStream_t);

}  // namespace uf
