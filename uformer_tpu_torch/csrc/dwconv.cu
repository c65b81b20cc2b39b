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
// bf16 (widening a bf16 weight is exact), the bias fp32 or absent. One
// launch can apply NQ = 3 weight sets to the same x (the q, k and v
// convolutions of the conv token projection) and write three outputs,
// with an optional ReLU before the rounding: relu(rnd(v)) == rnd(relu(v)),
// so the result is that of three single launches and a ReLU, bit for bit.
//
// What bounds it on the H100: memory. Each value is read once and written
// once against nine multiply-adds, so a (8192, 8, 8, 64) bf16 launch moves
// 134 MB (40 us at 3.35 TB/s) for 0.6 GFLOP (9 us on the fp32 pipes); the
// fused q/k/v launch reads x once for three outputs (4 activations of
// bytes instead of 6). Measured, both forms run at 2-3x that bound, held
// by instruction issue and latency rather than bytes: the index decode
// below is multiply-shift division, and the fused form's three convs are
// unrolled so that their loads and products interleave (PERF.md §6).
// Design: persistent blocks walk tiles (nb whole
// images, or Th rows x Tw columns of one image, times a chunk of at most
// 64 channels; the host's dwconv_plan in ops/kernels/dwconv.py picks them)
// through a ring of kDwStages shared-memory slots: while a tile is
// computed and stored, the next two tiles' 16-byte cp.async copies are in
// flight (the halo outside the image zero-filled, not loaded). Each thread
// computes kDwCols neighbouring pixels of a row x one 16-byte vector of
// channels (8 bf16 or 4 fp32), so each staged input vector and weight row
// it reads serves up to three of its outputs, and writes each with one
// 16-byte store. A (Bw, 8, 8, C) window batch is a batch of 8 x 8 images,
// so each window is padded with zeros, never with its neighbours' pixels.
// C that is not a multiple of the vector width runs the same code one
// element at a time. No tensor cores.
#include <algorithm>
#include <climits>

#include "common.cuh"
#include "mma_tile.cuh"

namespace uf {

constexpr int kDwThreads = 256;
constexpr int kDwCols = 4;    // neighbouring outputs per thread
constexpr int kDwStages = 3;  // ring slots

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// n / d for 0 <= n < 2^31 by a multiply and a shift, the divisor's magic
// number found once on the host: an index decode costs a few instructions,
// not the twenty-odd of an integer division
struct FastDiv {
  int d;
  unsigned m, s;
  __host__ void set(int div) {
    d = div;
    m = s = 0;
    if (d > 1) {
      unsigned l = 0;
      while ((1u << l) < (unsigned)d) ++l;  // ceil(log2 d)
      m = (unsigned)(((1ull << (31 + l)) + d - 1) / d);
      s = l - 1;
    }
  }
  __device__ __forceinline__ int div(int n) const {
    return d == 1 ? n : (int)(__umulhi((unsigned)n, m) >> s);
  }
};

template <typename T, typename WT>
struct DwParams {
  const T* x;       // (B, H, W, C)
  const WT* w;      // (NQ, 3, 3, C)
  const float* b;   // (NQ, C) or nullptr
  T* y;             // (NQ, B, H, W, C)
  int B, H, W, C;
  int nb, Th, Tw, Cc;  // tile: images, rows, columns, channels
  int ldp;             // elements between staged pixels: Cc + 16 bytes
  int relu;
  // Cc / V, Tw + 2, Th + 2, ceil(Tw / kDwCols), Th; tiles along W and H,
  // tiles per channel chunk
  FastDiv cv, sw, sh, gw, th, n_w, n_h, per_c;
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

// V values rounded to T (bf16 pairs by one packed conversion)
template <typename T, int V>
__device__ __forceinline__ Vec<T, V> round_vec(const float (&v)[V]) {
  Vec<T, V> out;
  if constexpr (std::is_same<T, bf16>::value && V % 2 == 0) {
#pragma unroll
    for (int j = 0; j < V; j += 2)
      *reinterpret_cast<__nv_bfloat162*>(&out.v[j]) =
          __floats2bfloat162_rn(v[j], v[j + 1]);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) out.v[j] = from_f<T>(v[j]);
  }
  return out;
}

// bytes of one ring slot: a tile with its one-pixel halo, each pixel's
// Cc channels padded by 16 bytes (neighbouring pixels' vectors then fall
// on other banks)
__host__ __device__ inline size_t dw_slot_bytes(int nb, int Th, int Tw,
                                                int Cc, int esize) {
  return align128((size_t)nb * (Th + 2) * (Tw + 2) * (Cc * esize + 16));
}

// shared memory of a launch: the ring, then NQ x (9 weight rows + bias)
__host__ __device__ inline size_t dw_smem_bytes(int nb, int Th, int Tw,
                                                int Cc, int esize, int nq) {
  return kDwStages * dw_slot_bytes(nb, Th, Tw, Cc, esize) +
         (size_t)nq * 10 * Cc * sizeof(float);
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

// Tile t of the walk: channel chunk outermost (a block's consecutive
// tiles mostly share their weights), then images, rows, columns; cc, nb,
// th, tw are what the image leaves of the tile's extent.
struct DwTile {
  int c0, b0, h0, w0, cc, nb, th, tw;
  template <typename P>
  __device__ DwTile(const P& p, int t) {
    const int c = p.per_c.div(t);
    t -= c * p.per_c.d;
    int q = p.n_w.div(t);
    w0 = (t - q * p.n_w.d) * p.Tw;
    t = q;
    q = p.n_h.div(t);
    h0 = (t - q * p.n_h.d) * p.Th;
    b0 = q * p.nb;
    c0 = c * p.Cc;
    cc = min(p.Cc, p.C - c0);
    tw = min(p.Tw, p.W - w0);
    th = min(p.Th, p.H - h0);
    nb = min(p.nb, p.B - b0);
  }
};

template <typename T, typename WT, int V, int NQ>
__global__ void __launch_bounds__(kDwThreads, 1)
    dwconv3x3_kernel(DwParams<T, WT> p, int tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  using VT = Vec<T, V>;
  const size_t slot = dw_slot_bytes(p.nb, p.Th, p.Tw, p.Cc, sizeof(T));
  float* wts = reinterpret_cast<float*>(smem + kDwStages * slot);
  auto ring = [&](int k) {
    return reinterpret_cast<T*>(smem + (k % kDwStages) * slot);
  };
  const size_t plane = (size_t)p.B * p.H * p.W * p.C;  // one output
  const int ldp = p.ldp, sw = p.sw.d, sh = p.sh.d, cvf = p.cv.d;

  // tile t and its halo into `tile` (pixel (img, row, col) at element
  // ((img sh + row) sw + col) ldp), by asynchronous copies; the walk
  // covers the full tile's extent and skips what lies past the image
  auto load = [&](int t, T* tile) {
    const DwTile d(p, t);
    const int n_in = p.nb * sh * sw * cvf;
    for (int i = threadIdx.x; i < n_in; i += blockDim.x) {
      int q = p.cv.div(i);
      const int v = i - q * cvf;
      int r = p.sw.div(q);
      const int col = q - r * sw;
      const int img = p.sh.div(r), row = r - img * sh;
      if (img >= d.nb || v * V >= d.cc || row >= d.th + 2 ||
          col >= d.tw + 2)
        continue;
      const int gy = d.h0 + row - 1, gx = d.w0 + col - 1;
      const bool in = gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
      const T* src = in ? p.x + (((size_t)(d.b0 + img) * p.H + gy) * p.W +
                                 gx) * p.C + d.c0 + v * V
                        : p.x;
      T* dst = tile + (size_t)((img * sh + row) * sw + col) * ldp + v * V;
      if constexpr (sizeof(VT) >= 4) {
        cp_async<sizeof(VT)>(dst, src, in);
      } else {
        *dst = in ? *src : from_f<T>(0.f);
      }
    }
  };

  for (int s = 0; s < kDwStages - 1; ++s) {
    const int t = blockIdx.x + s * gridDim.x;
    if (t < tiles) load(t, ring(s));
    cp_async_commit();
  }
  int w_c0 = -1;  // the channel chunk whose weights are in wts
  for (int k = 0, t = blockIdx.x; t < tiles; ++k, t += gridDim.x) {
    // tile t has landed; every thread is done with tile t - gridDim.x,
    // whose slot takes the tile kDwStages - 1 ahead
    cp_async_wait<kDwStages - 2>();
    __syncthreads();
    const int ahead = t + (kDwStages - 1) * gridDim.x;
    if (ahead < tiles) load(ahead, ring(k + kDwStages - 1));
    cp_async_commit();

    const DwTile d(p, t);
    if (d.c0 != w_c0) {
      for (int i = threadIdx.x; i < NQ * 10 * d.cc; i += blockDim.x) {
        const int q = i / (10 * d.cc), tap = (i / d.cc) % 10, c = i % d.cc;
        wts[(q * 10 + tap) * p.Cc + c] =
            tap < 9 ? to_f<WT>(p.w[(size_t)(q * 9 + tap) * p.C + d.c0 + c])
                    : (p.b != nullptr ? p.b[q * p.C + d.c0 + c] : 0.f);
      }
      w_c0 = d.c0;
      __syncthreads();
    }
    const T* tile = ring(k);

    // each thread: kDwCols neighbouring pixels of one row x one vector,
    // for each weight set; per output the taps are summed dy outer, dx
    // inner
    constexpr int R = kDwCols;
    const int n_out = p.nb * p.Th * p.gw.d * cvf;
    for (int i = threadIdx.x; i < n_out; i += blockDim.x) {
      int q = p.cv.div(i);
      const int v = i - q * cvf;
      int r = p.gw.div(q);
      const int col0 = (q - r * p.gw.d) * R;
      const int img = p.th.div(r), row = r - img * p.Th;
      if (img >= d.nb || v * V >= d.cc || row >= d.th || col0 >= d.tw)
        continue;
      const size_t out = (((size_t)(d.b0 + img) * p.H + d.h0 + row) * p.W +
                          d.w0 + col0) * p.C + d.c0 + v * V;
      // the NQ convs unrolled: the compiler interleaves their loads and
      // products (255 registers at NQ = 3, one block per SM; on an H100,
      // 8-14% faster than one conv after another at two blocks per SM)
#pragma unroll
      for (int qi = 0; qi < NQ; ++qi) {
        const float* wq = wts + qi * 10 * p.Cc;
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
            load_row<V>(w3[dx], wq + (dy * 3 + dx) * p.Cc + v * V);
          const T* trow = tile + (size_t)((img * sh + row + dy) * sw) * ldp +
                          v * V;
#pragma unroll
          for (int k2 = 0; k2 < R + 2; ++k2) {
            // past the tile's last column only for outputs not stored
            const int col = min(col0 + k2, d.tw + 1);
            const VT xv = *reinterpret_cast<const VT*>(trow +
                                                       (size_t)col * ldp);
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) {
              const int o = k2 - dx;
              if (o >= 0 && o < R) {
#pragma unroll
                for (int j = 0; j < V; ++j)
                  acc[o][j] = fmaf(to_f<T>(xv.v[j]), w3[dx][j], acc[o][j]);
              }
            }
          }
        }
        float bv[V];
        load_row<V>(bv, wq + 9 * p.Cc + v * V);
        T* y = p.y + qi * plane + out;
#pragma unroll
        for (int o = 0; o < R; ++o) {
          if (col0 + o < d.tw) {
#pragma unroll
            for (int j = 0; j < V; ++j) {
              acc[o][j] += bv[j];
              if (p.relu && acc[o][j] < 0.f) acc[o][j] = 0.f;
            }
            *reinterpret_cast<VT*>(y + (size_t)o * p.C) =
                round_vec<T, V>(acc[o]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
}

// f(V, NQ) as integral constants for the kernel of (vec, nq)
template <typename T, typename F>
static int with_dw(int vec, int nq, F f) {
  constexpr int V = 16 / sizeof(T);
  using I1 = std::integral_constant<int, 1>;
  using I3 = std::integral_constant<int, 3>;
  using IV = std::integral_constant<int, V>;
  if (nq == 1) return vec ? f(IV{}, I1{}) : f(I1{}, I1{});
  if (nq == 3) return vec ? f(IV{}, I3{}) : f(I1{}, I3{});
  return (int)cudaErrorInvalidValue;
}

template <typename T, typename WT>
static int slots(int vec, int nq, int smem) {
  return with_dw<T>(vec, nq, [&](auto v, auto q) {
    auto kernel = dwconv3x3_kernel<T, WT, decltype(v)::value,
                                   decltype(q)::value>;
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kDwThreads, smem);
    if (e == cudaSuccess && per_sm < 1) e = cudaErrorInvalidConfiguration;
    return e == cudaSuccess ? per_sm * sms : -(int)e;
  });
}

template <typename T, typename WT>
static int run(const void* x, const void* w, const float* b, void* y, int B,
               int H, int W, int C, int vec, int nq, int relu, int nb,
               int Th, int Tw, int Cc, int grid, void* stream) {
  constexpr int V = 16 / sizeof(T);
  if ((vec && Cc % V) || Cc < 1 || nb < 1 || Th < 1 || Tw < 1 || grid < 1)
    return (int)cudaErrorInvalidValue;
  DwParams<T, WT> p;
  p.x = static_cast<const T*>(x);
  p.w = static_cast<const WT*>(w);
  p.b = b;
  p.y = static_cast<T*>(y);
  p.B = B;
  p.H = H;
  p.W = W;
  p.C = C;
  p.nb = nb;
  p.Th = Th;
  p.Tw = Tw;
  p.Cc = Cc;
  p.ldp = Cc + 16 / (int)sizeof(T);
  p.relu = relu;
  const int vw = vec ? V : 1, n_w = (W + Tw - 1) / Tw, n_h = (H + Th - 1) / Th;
  const long long per_c = (long long)((B + nb - 1) / nb) * n_h * n_w;
  const long long tiles = per_c * ((C + Cc - 1) / Cc);
  if (tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  p.cv.set(Cc / vw);
  p.sw.set(Tw + 2);
  p.sh.set(Th + 2);
  p.gw.set((Tw + kDwCols - 1) / kDwCols);
  p.th.set(Th);
  p.n_w.set(n_w);
  p.n_h.set(n_h);
  p.per_c.set((int)per_c);
  const size_t smem = dw_smem_bytes(nb, Th, Tw, Cc, sizeof(T), nq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_dw<T>(vec, nq, [&](auto v, auto q) {
    auto kernel = dwconv3x3_kernel<T, WT, decltype(v)::value,
                                   decltype(q)::value>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<grid, kDwThreads, smem, s>>>(p, (int)tiles);
    return (int)cudaGetLastError();
  });
}

}  // namespace uf

extern "C" {

// The blocks of the kernel for (dtypes, vec, nq) with `smem` bytes of
// shared memory (dwconv_plan's) resident on the card at once, or a
// negated cudaError_t.
int uf_dwconv3x3_slots(int x_bf16, int w_bf16, int vec, int nq, int smem) {
  if (x_bf16)
    return w_bf16 ? uf::slots<uf::bf16, uf::bf16>(vec, nq, smem)
                  : uf::slots<uf::bf16, float>(vec, nq, smem);
  return w_bf16 ? uf::slots<float, uf::bf16>(vec, nq, smem)
                : uf::slots<float, float>(vec, nq, smem);
}

// Returns a cudaError_t. x_bf16 selects bf16 (else fp32) for x and y,
// w_bf16 the same for w; b is fp32 or null. vec: 16-byte vectors along C
// (C a multiple of 8 bf16 or 4 fp32, x and y 16-byte aligned). nq: 1, or
// 3 weight sets w (3, 3, 3, C) and biases b (3, C) into y (3, B, H, W, C);
// relu: max(v, 0) before the rounding. The tile (nb images, Th rows, Tw
// columns, Cc channels) and the grid are dwconv_plan's.
int uf_dwconv3x3(int x_bf16, int w_bf16, const void* x, const void* w,
                 const float* b, void* y, int B, int H, int W, int C, int vec,
                 int nq, int relu, int nb, int Th, int Tw, int Cc, int grid,
                 void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1) return (int)cudaErrorInvalidValue;
  if (x_bf16)
    return w_bf16 ? uf::run<uf::bf16, uf::bf16>(x, w, b, y, B, H, W, C, vec,
                                                nq, relu, nb, Th, Tw, Cc,
                                                grid, stream)
                  : uf::run<uf::bf16, float>(x, w, b, y, B, H, W, C, vec, nq,
                                             relu, nb, Th, Tw, Cc, grid,
                                             stream);
  return w_bf16 ? uf::run<float, uf::bf16>(x, w, b, y, B, H, W, C, vec, nq,
                                           relu, nb, Th, Tw, Cc, grid, stream)
                : uf::run<float, float>(x, w, b, y, B, H, W, C, vec, nq, relu,
                                        nb, Th, Tw, Cc, grid, stream);
}

}  // extern "C"
