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
// 67 MB (20 us at 3.35 TB/s) for 2.1 GFLOP (a few us on the tensor
// cores) and 33.5 M expf (about 9 us of the SMs' special-function units).
//
// bf16 design (window_attention_mma_kernel): persistent blocks of four
// warps, each block walking a contiguous range of the (head, window)
// pairs head-major, the head's bias in shared memory (reloaded behind a
// block barrier where the range crosses a head); the q, k and v tiles of
// the next window arrive by 16-byte cp.async into a second buffer while
// the current one computes; each warp runs the core on its 16 rows in
// registers (window_core_mma.cuh): q by ldmatrix into A fragments, k and
// v read from shared memory, the mask bits from the window's place, O
// rounded to bf16, staged in the warp's own q rows and stored with
// 16-byte vectors. (One warp a window, taking its four slices in turn,
// and the bias read through the read-only cache measured slower on the
// H100: PERF.md §6, kernel 4's design steps.) fp32 (the exact-check
// path) runs one block per (head, group of kGroup windows) on
// window_core.cuh (WMMA through shared memory), the head's bias in shared
// memory for the group.
#include "attention_image.cuh"
#include "window_core_mma.cuh"

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

// The bf16 body's shared memory: the head's bias and two buffers of one
// window's q, k and v tiles.
template <int D>
struct WinMma {
  static constexpr int ldk = D + 8, ldb = 72;
  static constexpr size_t kTile = align128(2 * 64 * ldk);  // q, k or v
  static constexpr size_t kBuf = 3 * kTile;
  static constexpr size_t bias = 0, buf = align128(4 * 64 * ldb);
  static constexpr size_t total = buf + 2 * kBuf;
};

// Four warps a window, one 16-row slice each; block b takes windows
// [b chunk, (b + 1) chunk) of the nH * Bw, head-major (window j: head
// j / Bw, at offset 64 D j). 128 registers a thread at most.
template <int D>
__global__ void __launch_bounds__(128, 4)
    window_attention_mma_kernel(WinAttnParams<bf16> p, int nH, int chunk) {
  using L = WinMma<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int ldk = L::ldk, ldb = L::ldb, vpr = D / 8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t4 = lane & 3, r0 = warp * 16;
  const int ta = r0 + gq, tb = ta + 8;  // this lane's rows of the window
  float* bias_s = reinterpret_cast<float*>(smem + L::bias);
  const WindowTokens tok(p.H, p.W, p.shift, 0);
  const int j0 = blockIdx.x * chunk, j1 = min(j0 + chunk, nH * p.Bw);
  auto tile = [&](int buf, int m) {
    return reinterpret_cast<bf16*>(smem + L::buf + buf * L::kBuf +
                                   m * L::kTile);
  };
  auto load = [&](int j, int buf) {
    const size_t base = (size_t)j * 64 * D;
    for (int i = tid; i < 3 * 64 * vpr; i += 128) {
      const int m = i / (64 * vpr), t = (i / vpr) % 64, c = (i % vpr) * 8;
      const bf16* src = m == 0 ? p.q : (m == 1 ? p.k : p.v);
      cp_async16(tile(buf, m) + t * ldk + c, src + base + t * D + c);
    }
  };
  if (j0 < j1) load(j0, 0);
  cp_async_commit();

  for (int j = j0, buf = 0; j < j1; ++j, buf ^= 1) {
    const int h = j / p.Bw, w = j % p.Bw;
    if (j == j0 || w == 0) {  // the head's bias, behind block barriers
      __syncthreads();
      for (int i = tid; i < 64 * 16; i += 128) {
        const int r = i / 16, c = (i % 16) * 4;
        *reinterpret_cast<float4*>(bias_s + r * ldb + c) =
            __ldg(reinterpret_cast<const float4*>(
                p.bias + (size_t)h * 4096 + r * 64 + c));
      }
    }
    // window j has landed in buffer buf; every warp is done with buf ^ 1
    cp_async_wait<0>();
    __syncthreads();
    if (j + 1 < j1) load(j + 1, buf ^ 1);
    cp_async_commit();
    bf16* Q = tile(buf, 0);
    uint32_t qa[D / 16][4];
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
      ldsm_x4(qa[k], Q + (r0 + (lane & 15)) * ldk + k * 16 + (lane >> 4) * 8);
    float o[D / 8][4];
    window_core_mma<D, false>(o, qa, tile(buf, 1), tile(buf, 2), ldk,
                              bias_s + r0 * ldb, ldb,
                              window_mask_bits(tok, w, ta, tb, t4), p.scale);
    // O rounded into this warp's own q rows (no other warp reads them),
    // then 16-byte stores
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int col = 8 * n + 2 * t4;
      *reinterpret_cast<uint32_t*>(Q + ta * ldk + col) =
          pack_bf16(o[n][0], o[n][1]);
      *reinterpret_cast<uint32_t*>(Q + tb * ldk + col) =
          pack_bf16(o[n][2], o[n][3]);
    }
    __syncwarp();
    const size_t base = (size_t)j * 64 * D;
#pragma unroll
    for (int i = lane; i < 16 * vpr; i += 32) {
      const int t = r0 + i / vpr, c = (i % vpr) * 8;
      *reinterpret_cast<uint4*>(p.out + base + t * D + c) =
          *reinterpret_cast<const uint4*>(Q + t * ldk + c);
    }
  }
  cp_async_wait<0>();
}

template <int D>
static int launch_mma(const WinAttnParams<bf16>& p, int nH, int chunk,
                      int grid, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      window_attention_mma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)WinMma<D>::total);
  if (e != cudaSuccess) return (int)e;
  window_attention_mma_kernel<D>
      <<<grid, 128, WinMma<D>::total, stream>>>(p, nH, chunk);
  return (int)cudaGetLastError();
}

template <typename T>
static int run(const void* q, const void* k, const void* v,
               const float* bias, void* out, int nH, int Bw, int D, int H,
               int W, int shift, float scale, int chunk, int grid,
               void* stream) {
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
  if constexpr (std::is_same<T, bf16>::value) {
    if (D == 16) return launch_mma<16>(p, nH, chunk, grid, s);
    if (D == 32) return launch_mma<32>(p, nH, chunk, grid, s);
  } else {
    if (D == 16) return launch<T, 16>(p, nH, s);
    if (D == 32) return launch<T, 32>(p, nH, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace uf

extern "C" {

// The blocks of the bf16 body at head dim D resident on the card at once;
// 0 for fp32, which runs a block per (head, group of windows); a negated
// cudaError_t on failure.
int uf_window_attention_slots(int is_bf16, int D) {
  if (!is_bf16) return 0;
  int slots = 0;
  cudaError_t e = cudaErrorInvalidValue;
  if (D == 16)
    e = uf::resident_slots(uf::window_attention_mma_kernel<16>, 128,
                           uf::WinMma<16>::total, &slots);
  if (D == 32)
    e = uf::resident_slots(uf::window_attention_mma_kernel<32>, 128,
                           uf::WinMma<32>::total, &slots);
  return e ? -(int)e : slots;
}

// Returns a cudaError_t. is_bf16 selects bf16 (else fp32) for q, k, v and
// out; the (nH, 64, 64) bias is fp32. Window w of the Bw lies at place
// w mod nW of an H x W image (region ids of the shift mask). bf16:
// `chunk` windows a block, `grid` blocks (window_attention_plan); fp32
// ignores them.
int uf_window_attention(int is_bf16, const void* q, const void* k,
                        const void* v, const float* bias, void* out, int nH,
                        int Bw, int D, int H, int W, int shift, float scale,
                        int chunk, int grid, void* stream) {
  if (is_bf16)
    return uf::run<uf::bf16>(q, k, v, bias, out, nH, Bw, D, H, W, shift,
                             scale, chunk, grid, stream);
  return uf::run<float>(q, k, v, bias, out, nH, Bw, D, H, W, shift, scale,
                        chunk, grid, stream);
}

}  // extern "C"
