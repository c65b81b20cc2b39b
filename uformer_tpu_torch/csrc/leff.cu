// LeFF sub-block for Hopper (sm_90a).
//
// Replaces uformer_tpu/ops/pallas/leff.py:fused_leff (whole-image and
// small-image variants, with the pixel packing they need on the TPU):
// [x +] W2 . GELU(dw3x3(GELU(W1 . LN2(x) + b1)) + bd) + b2, erf GELU.
//
// What bounds it on the H100: at C >= 128 the products (4 C Ch MACs per
// pixel, the first on a 1-pixel halo too); at C <= 64 the bytes of x and
// y. The 4C-wide hidden never touches device memory. bf16 runs the tiles
// of leff_mma.cuh on mma.sync with register accumulators: the wide tile
// (C 128-1024, one 8 x 8 or 16 x 8 output tile per block, 4 x 8 at C =
// 1024, weights streamed through a cp.async ring) and the narrow one (C
// 16-64, weights resident, one persistent block per SM walking 8 x 16
// tiles, the next halo prefetched; also C = 8, its 32-wide hidden
// zero-padded to 64 by the host). fp32 at C 16-512 (every fp32 LeFF of
// Uformer_T, _S and _B: the eval CLI's default dtype) runs the three-pass
// TF32 tile of leff_f32.cuh (leff_f32.cu, a tile a block). fp32 at C 8
// and at widths that are no power of two or 1024, and bf16 at widths
// without an mma tile, run the WMMA/FMA tile of leff_tile.cuh, one TH x 8
// tile per block (1 x 8 in fp32 at C = 1024), partial tiles masked; at C
// 1408-2048 (an --embed_dim 88-128 model's bottleneck and dec0) its halo
// goes to the caller's scratch slots, one a block, and the blocks walk
// the tiles over them.
#include "leff_f32.cuh"
#include "leff_mma.cuh"

namespace uf {

// Kernel 2 on the three-pass TF32 tile (leff_f32.cu), leff_f32_rows(C)
// rows a tile; cudaErrorInvalidValue where it has no such tile.
int leff_f32(const LeffParams<float>& p, cudaStream_t stream);

// Whether fp32 at (C, Ch) runs that tile.
__host__ inline bool f32_tile(int C, int Ch) {
  return leff_f32_fits(C) && Ch % kLeffChunk == 0;
}

// leff_tile over the image's tiles from blockIdx.x in steps of gridDim.x
// (one each where the grid has a block a tile), slot blockIdx.x
template <typename T>
__global__ void __launch_bounds__(kThreads) leff_kernel(LeffParams<T> p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tiles = p.B * ((p.H + p.TH - 1) / p.TH) * ((p.W + 7) / 8);
  for (int it = blockIdx.x; it < tiles; it += gridDim.x)
    leff_tile<T>(p, it, smem, blockIdx.x);
}

template <int C, int TH>
__global__ void __launch_bounds__(kThreads, 1)
    leff_wide_kernel(LeffParams<bf16> p) {
  extern __shared__ __align__(128) unsigned char smem[];
  leff_wide_tile<C, TH>(p, blockIdx.x, smem);
}

template <int C>
__global__ void __launch_bounds__(kThreads, 1)
    leff_narrow_kernel(LeffParams<bf16> p) {
  extern __shared__ __align__(128) unsigned char smem[];
  leff_narrow<C>(p, smem);
}

// Which body takes (dtype, C, Ch): the wide or narrow mma tile (bf16), or
// leff_tile.
__host__ inline bool wide_tile(int tsize, int C, int Ch) {
  return tsize == 2 && (C == 128 || C == 256 || C == 512 || C == 1024) &&
         Ch % 64 == 0;
}
__host__ inline bool narrow_tile(int tsize, int C, int Ch) {
  return tsize == 2 && (((C == 16 || C == 32 || C == 64) && Ch == 4 * C) ||
                        (C == 8 && Ch == kLeffChunk));
}

// The blocks of `kernel` (kThreads threads, smem bytes) resident on the
// card at once, in *slots.
template <typename K>
static cudaError_t resident(K kernel, size_t smem, int* slots) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  *slots = (per_sm > 0 ? per_sm : 1) * sms;
  return e;
}

template <int C, int TH>
static int launch_wide_rows(const LeffParams<bf16>& p, cudaStream_t stream) {
  constexpr size_t smem = LeffWide<C, TH>::total;
  cudaError_t e = cudaFuncSetAttribute(
      leff_wide_kernel<C, TH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = p.B * ((p.H + TH - 1) / TH) * ((p.W + 7) / 8);
  leff_wide_kernel<C, TH><<<blocks, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int C>
static int launch_wide(const LeffParams<bf16>& p, cudaStream_t stream) {
  if constexpr (C == 1024) {
    return launch_wide_rows<C, 4>(p, stream);
  } else {
    int slots = 0;
    cudaError_t e = resident(leff_wide_kernel<C, 8>, LeffWide<C, 8>::total,
                             &slots);
    if (e != cudaSuccess) return (int)e;
    if constexpr (C <= 256)
      if (leff_wide_rows(p.B, p.H, p.W, C, slots) == 16)
        return launch_wide_rows<C, 16>(p, stream);
    return launch_wide_rows<C, 8>(p, stream);
  }
}

template <int C>
static int launch_narrow(const LeffParams<bf16>& p, cudaStream_t stream) {
  constexpr size_t smem = LeffNarrow<C>::total;
  int slots = 0;
  cudaError_t e = resident(leff_narrow_kernel<C>, smem, &slots);
  if (e != cudaSuccess) return (int)e;
  const int tiles = p.B * ((p.H + 7) / 8) * ((p.W + 15) / 16);
  leff_narrow_kernel<C><<<slots < tiles ? slots : tiles, kThreads, smem,
                          stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
static int run(const void* x, void* y, const float* ln_s, const float* ln_b,
               const void* w1, const float* b1, const void* wd,
               const float* bd, const void* w2, const float* b2, int B, int H,
               int W, int C, int Ch, int has_ln, int residual, void* scratch,
               int slots, void* stream) {
  LeffParams<T> p;
  p.x = static_cast<const T*>(x);
  p.y = static_cast<T*>(y);
  p.ln_s = ln_s;
  p.ln_b = ln_b;
  p.w1 = static_cast<const T*>(w1);
  p.b1 = b1;
  p.wd = static_cast<const T*>(wd);
  p.bd = bd;
  p.w2 = static_cast<const T*>(w2);
  p.b2 = b2;
  p.scratch = static_cast<T*>(scratch);
  p.B = B;
  p.H = H;
  p.W = W;
  p.C = C;
  p.Ch = Ch;
  p.TH = leff_tile_rows(sizeof(T), C);
  p.has_ln = has_ln;
  p.residual = residual;
  auto s = static_cast<cudaStream_t>(stream);
  if constexpr (std::is_same<T, float>::value)
    if (f32_tile(C, Ch)) return leff_f32(p, s);
  if constexpr (std::is_same<T, bf16>::value) {
    if (wide_tile(2, C, Ch)) {
      if (C == 128) return launch_wide<128>(p, s);
      if (C == 256) return launch_wide<256>(p, s);
      if (C == 512) return launch_wide<512>(p, s);
      return launch_wide<1024>(p, s);
    }
    if (narrow_tile(2, C, Ch)) {
      if (C == 8) return launch_narrow<8>(p, s);
      if (C == 16) return launch_narrow<16>(p, s);
      if (C == 32) return launch_narrow<32>(p, s);
      return launch_narrow<64>(p, s);
    }
  }
  const LeffLayout L = leff_layout(sizeof(T), C, p.TH);
  cudaError_t e = cudaFuncSetAttribute(
      leff_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L.total);
  if (e != cudaSuccess) return (int)e;
  int blocks = B * ((H + p.TH - 1) / p.TH) * ((W + 7) / 8);
  if (!L.x_smem) {  // the halo in the caller's slots: a block a slot
    if (scratch == nullptr || slots < 1) return (int)cudaErrorInvalidValue;
    if (blocks > slots) blocks = slots;
  }
  leff_kernel<T><<<blocks, kThreads, L.total, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace uf

extern "C" {

// The tile's rows for this dtype and width: 1 where the mma tiles run
// (bf16's, and fp32's three-pass TF32 tile at C 16-512), else leff_tile's
// tile height (8, 4, 2 or 1). Every tile masks partial tiles, so any H and
// W run; the spatial path sizes its slabs' halo by it.
int uf_leff_tile_rows(int is_bf16, int C, int Ch) {
  const int ts = is_bf16 ? 2 : 4;
  if (uf::wide_tile(ts, C, Ch) || uf::narrow_tile(ts, C, Ch)) return 1;
  if (!is_bf16 && uf::f32_tile(C, Ch)) return 1;
  return uf::leff_tile_rows(ts, C);
}

// The elements (of the working dtype) of one block's scratch slot at
// (dtype, C, Ch): leff_tile's LayerNormed halo where it misses shared
// memory (C 1408-2048), else 0.
int uf_leff_scratch(int is_bf16, int C, int Ch) {
  const int ts = is_bf16 ? 2 : 4;
  if (uf::wide_tile(ts, C, Ch) || uf::narrow_tile(ts, C, Ch)) return 0;
  if (!is_bf16 && uf::f32_tile(C, Ch)) return 0;
  return (int)uf::leff_layout(ts, C, uf::leff_tile_rows(ts, C)).slot;
}

// Returns a cudaError_t (0 on success). is_bf16 selects bf16 (else fp32)
// for x, y, w1, wd and w2; biases and LayerNorm parameters are fp32.
// scratch: `slots` slots of uf_leff_scratch elements each where that is
// not 0 (the launch then takes at most `slots` blocks), else ignored.
int uf_leff(int is_bf16, const void* x, void* y, const float* ln_s,
            const float* ln_b, const void* w1, const float* b1,
            const void* wd, const float* bd, const void* w2, const float* b2,
            int B, int H, int W, int C, int Ch, int has_ln, int residual,
            void* scratch, int slots, void* stream) {
  if (is_bf16)
    return uf::run<uf::bf16>(x, y, ln_s, ln_b, w1, b1, wd, bd, w2, b2, B, H,
                             W, C, Ch, has_ln, residual, scratch, slots,
                             stream);
  return uf::run<float>(x, y, ln_s, ln_b, w1, b1, wd, bd, w2, b2, B, H, W, C,
                        Ch, has_ln, residual, scratch, slots, stream);
}

}  // extern "C"
