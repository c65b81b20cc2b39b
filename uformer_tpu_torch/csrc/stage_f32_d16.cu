// The whole-stage kernel (stage.cu) in fp32 at head dim 16 (Uformer_T's
// stages, C 64-256; C 512 too) on the three-pass TF32 bodies, as
// stage_f32.cu at head dim 32.
#include "stage.cuh"

namespace uf {

template int stage_f32<16>(const StageParams<float>&, int, cudaStream_t);

}  // namespace uf
