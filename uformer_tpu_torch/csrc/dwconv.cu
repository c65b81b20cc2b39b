// Depthwise 3x3 convolution for Hopper (sm_90a).
//
// Replaces uformer_tpu/ops/pallas/dwconv.py:dwconv3x3:
//
//   y[b, i, j, c] = sum_{dy, dx} x[b, i + dy - 1, j + dx - 1, c] w[dy, dx, c]
//                   + bias[c]
//
// on NHWC x, stride 1, zero padding at the borders of each image: x and w
// widened to fp32, the nine products summed in fp32 (dy outer, dx inner),
// the fp32 bias added, and one rounding to x's dtype. w may be fp32 or
// bf16 (widening a bf16 weight is exact), the bias fp32 or absent.
//
// What bounds it on the H100: memory. Each value is read once and written
// once against nine multiply-adds, so a (8192, 8, 8, 64) bf16 launch moves
// 134 MB (40 us at 3.35 TB/s) for 0.6 GFLOP (9 us on the fp32 pipes).
// Design: a block stages one tile with its one-pixel zero halo in shared
// memory: nb whole images, or Th rows x Tw columns of one image, times a
// chunk of at most 64 channels, by 16-byte cp.async copies all in flight
// at once (the halo outside the image is zero-filled, not loaded), beside
// the chunk's nine fp32 weight rows and its bias. Each thread then
// computes kDwCols neighbouring pixels of a row x one 16-byte vector of
// channels (8 bf16 or 4 fp32), so each staged input vector and weight row
// it reads serves up to three of its outputs, and writes each with one
// 16-byte store. A (Bw, 8, 8, C) window batch is a batch of 8 x 8 images,
// so each window is padded with zeros, never with its neighbours' pixels.
// C that is not a multiple of the vector width runs the same code one
// element at a time. No tensor cores. Against one pixel per thread and
// plain loads, these two took the (8192, 8, 8, 64) launch from 0.127 to
// 0.096 ms (CUDA-graph device time, H100 80GB HBM3 at 700 W; PERF.md).
#include <algorithm>
#include <climits>

#include "common.cuh"

namespace uf {

constexpr int kDwThreads = 256;
constexpr int kDwChunk = 64;          // channels per block
constexpr int kDwItems = 1024;        // target outputs (pixel x vector)
constexpr int kDwCols = 4;            // neighbouring outputs per thread
constexpr size_t kDwSmem = 40 * 1024;  // below the 48 KB default

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <typename T, typename WT>
struct DwParams {
  const T* x;       // (B, H, W, C)
  const WT* w;      // (3, 3, C)
  const float* b;   // (C,) or nullptr
  T* y;             // (B, H, W, C)
  int B, H, W, C;
  int nb, Th, Tw, Cc;  // tile: images, rows, columns, channels
  int n_c, n_w, n_h;   // tiles along C, W and H
};

// V fp32 values of a shared-memory weight row: 16-byte loads when V is a
// multiple of 4 (rows start at multiples of 4 floats: Cc and v * V are)
template <int V>
__device__ __forceinline__ void load_row(float* dst, const float* src) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
      const float4 f = reinterpret_cast<const float4*>(src)[q];
      dst[4 * q] = f.x;
      dst[4 * q + 1] = f.y;
      dst[4 * q + 2] = f.z;
      dst[4 * q + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) dst[j] = src[j];
  }
}

// shared memory of a tile: the staged input, then 9 weight rows + bias
__host__ __device__ inline size_t dw_tile_bytes(int nb, int Th, int Tw,
                                                int Cc, int esize) {
  return (size_t)nb * (Th + 2) * (Tw + 2) * Cc * esize;
}

// 16-, 8- or 4-byte asynchronous copy global -> shared (cp.async), zero
// filled when !valid: the halo outside the image costs no load
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
                 "l"(src), "n"(BYTES), "r"(n));
}

template <typename T, typename WT, int V>
__global__ void __launch_bounds__(kDwThreads)
    dwconv3x3_kernel(DwParams<T, WT> p) {
  extern __shared__ __align__(128) unsigned char smem[];
  using VT = Vec<T, V>;
  int t = blockIdx.x;
  const int ci = t % p.n_c;
  t /= p.n_c;
  const int wi = t % p.n_w;
  t /= p.n_w;
  const int hi = t % p.n_h;
  t /= p.n_h;
  const int c0 = ci * p.Cc, w0 = wi * p.Tw, h0 = hi * p.Th, b0 = t * p.nb;
  const int cc = min(p.Cc, p.C - c0), tw = min(p.Tw, p.W - w0);
  const int th = min(p.Th, p.H - h0), nb = min(p.nb, p.B - b0);
  const int cv = cc / V;  // vectors per pixel; V divides cc
  const int sw = tw + 2, sh = th + 2;
  Carver carve;
  T* tile = reinterpret_cast<T*>(
      smem + carve.take(dw_tile_bytes(p.nb, p.Th, p.Tw, p.Cc, sizeof(T))));
  float* wts = reinterpret_cast<float*>(
      smem + carve.take((size_t)10 * p.Cc * sizeof(float)));

  // the tile and its halo, pixel after pixel with stride cc (input vector
  // i at element i * V), by asynchronous copies all in flight at once
  const int n_in = nb * sh * sw * cv;
  for (int i = threadIdx.x; i < n_in; i += blockDim.x) {
    const int v = i % cv;
    int r = i / cv;
    const int col = r % sw;
    r /= sw;
    const int row = r % sh, img = r / sh;
    const int gy = h0 + row - 1, gx = w0 + col - 1;
    const bool in = gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
    const T* src =
        in ? p.x + (((size_t)(b0 + img) * p.H + gy) * p.W + gx) * p.C + c0 +
                 v * V
           : p.x;
    if constexpr (sizeof(VT) >= 4) {
      cp_async<sizeof(VT)>(tile + (size_t)i * V, src, in);
    } else {
      tile[i] = in ? *src : from_f<T>(0.f);
    }
  }
  for (int i = threadIdx.x; i < 10 * cc; i += blockDim.x) {
    const int tap = i / cc, c = i % cc;
    wts[tap * p.Cc + c] =
        tap < 9 ? to_f<WT>(p.w[(size_t)tap * p.C + c0 + c])
                : (p.b != nullptr ? p.b[c0 + c] : 0.f);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // each thread: kDwCols neighbouring pixels of one row x one vector;
  // per output the taps are summed dy outer, dx inner
  constexpr int R = kDwCols;
  const int gw = (tw + R - 1) / R;
  const int n_out = nb * th * gw * cv;
  for (int i = threadIdx.x; i < n_out; i += blockDim.x) {
    const int v = i % cv;
    int r = i / cv;
    const int cg = r % gw;
    r /= gw;
    const int row = r % th, img = r / th;
    const int col0 = cg * R;
    float acc[R][V];
#pragma unroll
    for (int o = 0; o < R; ++o)
#pragma unroll
      for (int j = 0; j < V; ++j) acc[o][j] = 0.f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      float w3[3][V];
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        load_row<V>(w3[dx], wts + (dy * 3 + dx) * p.Cc + v * V);
      const T* trow = tile + (size_t)(img * sh + row + dy) * sw * cc + v * V;
#pragma unroll
      for (int k = 0; k < R + 2; ++k) {
        // past the tile's last column only for outputs that are not stored
        const int col = min(col0 + k, sw - 1);
        const VT xv = *reinterpret_cast<const VT*>(trow + (size_t)col * cc);
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const int o = k - dx;
          if (o >= 0 && o < R) {
#pragma unroll
            for (int j = 0; j < V; ++j)
              acc[o][j] = fmaf(to_f<T>(xv.v[j]), w3[dx][j], acc[o][j]);
          }
        }
      }
    }
    float bv[V];
    load_row<V>(bv, wts + 9 * p.Cc + v * V);
    T* out = p.y + (((size_t)(b0 + img) * p.H + h0 + row) * p.W + w0 + col0) *
                       p.C + c0 + v * V;
#pragma unroll
    for (int o = 0; o < R; ++o) {
      if (col0 + o < tw) {
        VT ov;
#pragma unroll
        for (int j = 0; j < V; ++j) ov.v[j] = from_f<T>(acc[o][j] + bv[j]);
        *reinterpret_cast<VT*>(out + (size_t)o * p.C) = ov;
      }
    }
  }
}

// The tile of one block: a channel chunk of at most kDwChunk, up to 32
// columns, rows (or, when one image fits, whole images) up to about
// kDwItems outputs, halved until the shared memory fits in kDwSmem.
template <typename T, typename WT>
static size_t plan(DwParams<T, WT>& p, int V) {
  p.Cc = std::min(p.C, kDwChunk);
  p.Tw = std::min(p.W, 32);
  const int cv = p.Cc / V;
  p.Th = std::max(1, std::min(p.H, kDwItems / (p.Tw * cv)));
  p.nb = 1;
  if (p.Th == p.H && p.Tw == p.W)
    p.nb = std::max(1, std::min(p.B, kDwItems / (p.H * p.W * cv)));
  size_t smem;
  for (;;) {
    Carver carve;
    carve.take(dw_tile_bytes(p.nb, p.Th, p.Tw, p.Cc, sizeof(T)));
    carve.take((size_t)10 * p.Cc * sizeof(float));
    smem = carve.off;
    if (smem <= kDwSmem) break;
    if (p.nb > 1)
      p.nb = (p.nb + 1) / 2;
    else if (p.Th > 1)
      p.Th = (p.Th + 1) / 2;
    else if (p.Tw > 1)
      p.Tw = (p.Tw + 1) / 2;
    else
      break;
  }
  p.n_c = (p.C + p.Cc - 1) / p.Cc;
  p.n_w = (p.W + p.Tw - 1) / p.Tw;
  p.n_h = (p.H + p.Th - 1) / p.Th;
  return smem;
}

template <typename T, typename WT, int V>
static int launch(DwParams<T, WT> p, cudaStream_t stream) {
  const size_t smem = plan(p, V);
  const long long grid =
      (long long)p.n_c * p.n_w * p.n_h * ((p.B + p.nb - 1) / p.nb);
  if (smem > 48 * 1024 || grid > INT_MAX) return (int)cudaErrorInvalidValue;
  dwconv3x3_kernel<T, WT, V>
      <<<(unsigned)grid, kDwThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, typename WT>
static int run(const void* x, const void* w, const float* b, void* y, int B,
               int H, int W, int C, int vec, void* stream) {
  constexpr int V = 16 / sizeof(T);
  if (vec && C % V) return (int)cudaErrorInvalidValue;
  DwParams<T, WT> p;
  p.x = static_cast<const T*>(x);
  p.w = static_cast<const WT*>(w);
  p.b = b;
  p.y = static_cast<T*>(y);
  p.B = B;
  p.H = H;
  p.W = W;
  p.C = C;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec ? launch<T, WT, V>(p, s) : launch<T, WT, 1>(p, s);
}

}  // namespace uf

extern "C" {

// Returns a cudaError_t. x_bf16 selects bf16 (else fp32) for x and y,
// w_bf16 the same for w; b is fp32 or null. vec: 16-byte vectors along C
// (C a multiple of 8 bf16 or 4 fp32, x and y 16-byte aligned).
int uf_dwconv3x3(int x_bf16, int w_bf16, const void* x, const void* w,
                 const float* b, void* y, int B, int H, int W, int C, int vec,
                 void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1) return (int)cudaErrorInvalidValue;
  if (x_bf16)
    return w_bf16 ? uf::run<uf::bf16, uf::bf16>(x, w, b, y, B, H, W, C, vec,
                                                stream)
                  : uf::run<uf::bf16, float>(x, w, b, y, B, H, W, C, vec,
                                             stream);
  return w_bf16 ? uf::run<float, uf::bf16>(x, w, b, y, B, H, W, C, vec,
                                           stream)
                : uf::run<float, float>(x, w, b, y, B, H, W, C, vec, stream);
}

}  // extern "C"
