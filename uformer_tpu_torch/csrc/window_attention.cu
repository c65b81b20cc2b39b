// Window-attention core for Hopper (sm_90a), standalone.
//
// Replaces uformer_tpu/ops/pallas/window_attention.py:fused_window_attention:
//
//   out[h, w] = softmax(q[h, w] k[h, w]^T * scale + bias[h]
//                       [- 100 where the SW-MSA region ids differ]) v[h, w]
//
// on q, k, v, out of shape (nH, Bw, 64, D), D in {16, 32}, fp32 or bf16,
// with the logits and the softmax in fp32 and the mask built inline from
// the window's place in the image (window w is window w mod nW of its
// image), as the TPU kernel does.
//
// What bounds it on the H100: memory. Per window and head it reads
// 3*64*D and writes 64*D values against 4*64*64*D multiply-adds, so at
// D = 16 in bf16 the 8192 windows of a 256^2 batch-8 stage move about
// 67 MB (20 us at 3.35 TB/s) for 2.1 GFLOP (2 us on the tensor cores).
// Design: one block per (head, group of kGroup windows); the head's
// 16 KB bias is copied into shared memory once per block, so the group
// re-reads it from there rather than once per window; each window's q, k
// and v tiles are copied in with 16-byte loads, and the core
// (window_core.cuh) runs its two products on the tensor cores (WMMA,
// fp32 accumulation). Four warps per block: the 64x64 logits are 16
// fragment tiles, the output 4 or 8.
#include "window_core.cuh"

namespace uf {

constexpr int kCoreThreads = 128;
constexpr int kGroup = 8;  // windows per block

template <typename T>
struct WinAttnParams {
  const T *q, *k, *v;  // (nH, Bw, 64, D)
  const float* bias;   // (nH, 64, 64)
  T* out;              // (nH, Bw, 64, D)
  int Bw, H, W, shift;
  float scale;
};

template <int D>
struct CoreLayout {
  static constexpr int ldq = D + 8, ldp = 72, lda = 68;
  size_t q, k, v, p, acc, bias, rid, total;
};

template <int D>
__host__ __device__ inline CoreLayout<D> core_layout(int tsize) {
  using L_ = CoreLayout<D>;
  L_ L;
  Carver cv;
  L.q = cv.take(64 * L_::ldq * tsize);
  L.k = cv.take(64 * L_::ldq * tsize);
  L.v = cv.take(64 * L_::ldq * tsize);
  L.p = cv.take(64 * L_::ldp * tsize);
  L.acc = cv.take(64 * L_::lda * sizeof(float));
  L.bias = cv.take(4096 * sizeof(float));
  L.rid = cv.take(64 * sizeof(int));
  L.total = cv.off;
  return L;
}

template <typename T, int D>
__global__ void __launch_bounds__(kCoreThreads)
    window_attention_kernel(WinAttnParams<T> p) {
  extern __shared__ __align__(128) unsigned char smem[];
  using L_ = CoreLayout<D>;
  const L_ L = core_layout<D>(sizeof(T));
  constexpr int ldq = L_::ldq, V = 16 / sizeof(T), vpr = D / V;
  T* q = reinterpret_cast<T*>(smem + L.q);
  T* k = reinterpret_cast<T*>(smem + L.k);
  T* v = reinterpret_cast<T*>(smem + L.v);
  T* P = reinterpret_cast<T*>(smem + L.p);
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  float* bias = reinterpret_cast<float*>(smem + L.bias);
  int* rid = reinterpret_cast<int*>(smem + L.rid);
  const int tid = threadIdx.x, h = blockIdx.y;
  const int nW = (p.H / 8) * (p.W / 8);

  stage_tile<float>(bias, 64, p.bias + (size_t)h * 4096, 64, 64, 64);
  const int w0 = blockIdx.x * kGroup;
  const int w1 = min(w0 + kGroup, p.Bw);
  for (int w = w0; w < w1; ++w) {
    const size_t base = ((size_t)h * p.Bw + w) * 64 * D;
    for (int i = tid; i < 64 * vpr; i += blockDim.x) {
      const int t = i / vpr, c = (i % vpr) * V;
      const size_t at = base + (size_t)t * D + c;
      *reinterpret_cast<uint4*>(q + t * ldq + c) =
          *reinterpret_cast<const uint4*>(p.q + at);
      *reinterpret_cast<uint4*>(k + t * ldq + c) =
          *reinterpret_cast<const uint4*>(p.k + at);
      *reinterpret_cast<uint4*>(v + t * ldq + c) =
          *reinterpret_cast<const uint4*>(p.v + at);
    }
    if (tid < 64) rid[tid] = window_region(w % nW, tid, p.H, p.W, p.shift);
    __syncthreads();
    window_core<T, D, kCoreThreads / 32>(q, k, v, ldq, bias,
                                         p.shift ? rid : nullptr, p.scale, P,
                                         L_::ldp, acc, L_::lda);
    for (int idx = tid; idx < 64 * D; idx += blockDim.x)
      p.out[base + idx] = from_f<T>(acc[(idx / D) * L_::lda + idx % D]);
    __syncthreads();
  }
}

template <typename T, int D>
static int launch(const WinAttnParams<T>& p, int nH, cudaStream_t stream) {
  const size_t smem = core_layout<D>(sizeof(T)).total;
  cudaError_t e = cudaFuncSetAttribute(
      window_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.Bw + kGroup - 1) / kGroup, nH);
  window_attention_kernel<T, D><<<grid, kCoreThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
static int run(const void* q, const void* k, const void* v,
               const float* bias, void* out, int nH, int Bw, int D, int H,
               int W, int shift, float scale, void* stream) {
  WinAttnParams<T> p;
  p.q = static_cast<const T*>(q);
  p.k = static_cast<const T*>(k);
  p.v = static_cast<const T*>(v);
  p.bias = bias;
  p.out = static_cast<T*>(out);
  p.Bw = Bw;
  p.H = H;
  p.W = W;
  p.shift = shift;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 16) return launch<T, 16>(p, nH, s);
  if (D == 32) return launch<T, 32>(p, nH, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace uf

extern "C" {

// Returns a cudaError_t. is_bf16 selects bf16 (else fp32) for q, k, v and
// out; the (nH, 64, 64) bias is fp32. Window w of the Bw lies at place
// w mod nW of an H x W image (region ids of the shift mask).
int uf_window_attention(int is_bf16, const void* q, const void* k,
                        const void* v, const float* bias, void* out, int nH,
                        int Bw, int D, int H, int W, int shift, float scale,
                        void* stream) {
  if (is_bf16)
    return uf::run<uf::bf16>(q, k, v, bias, out, nH, Bw, D, H, W, shift,
                             scale, stream);
  return uf::run<float>(q, k, v, bias, out, nH, Bw, D, H, W, shift, scale,
                        stream);
}

}  // extern "C"
