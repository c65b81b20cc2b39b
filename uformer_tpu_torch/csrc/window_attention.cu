// Window-attention core for Hopper (sm_90a), standalone.
//
// Replaces uformer_tpu/ops/pallas/window_attention.py:fused_window_attention:
//
//   out[h, w] = softmax(q[h, w] k[h, w]^T * scale + bias[h]
//                       [- 100 where the SW-MSA region ids differ]) v[h, w]
//
// on q, k, v, out of shape (nH, Bw, N, D), N = win^2 (win 1-8), D in
// {8, 16, 32, 64}, fp32 or bf16, with the logits and the softmax in fp32 and
// the mask built inline from the window's place in the image (window w is
// window w mod nW of its image, nW = (H / win)(W / win)), as the TPU
// kernel does. Windows of N < 64 run in packed 64-row tiles of 64 / N
// whole windows of a head (window_core_mma.cuh:PackedTokens), with the
// host's tile of the bias, -inf between two windows
// (ops/kernels/window_attention.py:tile_bias); padding rows read as zeros
// and are never written. In bf16 head dim 8 takes QK^T on m16n8k8;
// fp32's core takes FMA products at any D.
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
  const T *q, *k, *v;  // (nH, Bw, N, D)
  const float* bias;   // (nH, 64, 64): the bias, or its tile at N < 64
  T* out;              // (nH, Bw, N, D)
  int Bw, H, W, shift, win;
  float scale;
};

// Work item j of kernel 4: head j / per_head and its window (or packed
// tile) w = j % per_head, whose 64 rows start at row `base` of the
// (nH Bw N, D) rows; row t is real where valid(t).
template <bool kPacked>
struct CoreItems {
  int Bw, N, G, per_head;
  __device__ CoreItems(int Bw_, int win)
      : Bw(Bw_), N(win * win), G(64 / (win * win)),
        per_head(kPacked ? (Bw_ + G - 1) / G : Bw_) {}
  __device__ __forceinline__ size_t base(int j) const {
    if (!kPacked) return (size_t)j * 64;
    return ((size_t)(j / per_head) * Bw + (size_t)(j % per_head) * G) * N;
  }
  __device__ __forceinline__ bool valid(int j, int t) const {
    return !kPacked ||
           (t < G * N && (j % per_head) * G * N + t < Bw * N);
  }
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

template <typename T, int D, bool kPacked = false>
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
  const CoreItems<kPacked> items(p.Bw, p.win);
  const PackedTokens tok(p.H, p.W, p.shift, 0, p.win, p.Bw);

  stage_tile<float>(bias, 64, p.bias + (size_t)h * 4096, 64, 64, 64);
  const int w0 = blockIdx.x * kGroup;
  const int w1 = min(w0 + kGroup, items.per_head);
  for (int w = w0; w < w1; ++w) {
    const int j = h * items.per_head + w;
    const size_t base = items.base(j) * D;
    for (int i = tid; i < 64 * vpr; i += blockDim.x) {
      const int t = i / vpr, c = (i % vpr) * V;
      const size_t at = base + (size_t)t * D + c;
      const bool ok = items.valid(j, t);
      const uint4 z = make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(q + t * ldq + c) =
          ok ? *reinterpret_cast<const uint4*>(p.q + at) : z;
      *reinterpret_cast<uint4*>(k + t * ldq + c) =
          ok ? *reinterpret_cast<const uint4*>(p.k + at) : z;
      *reinterpret_cast<uint4*>(v + t * ldq + c) =
          ok ? *reinterpret_cast<const uint4*>(p.v + at) : z;
    }
    if (tid < 64)
      rid[tid] = kPacked ? (p.shift ? tok.region(w, tid) : 0)
                         : window_region(w % nW, tid, p.H, p.W, p.shift);
    __syncthreads();
    window_core<T, D, kCoreThreads / 32>(q, k, v, ldq, bias,
                                         p.shift ? rid : nullptr, p.scale, P,
                                         L_::ldp, acc, L_::lda);
    for (int idx = tid; idx < 64 * D; idx += blockDim.x)
      if (items.valid(j, idx / D))
        p.out[base + idx] = from_f<T>(acc[(idx / D) * L_::lda + idx % D]);
    __syncthreads();
  }
}

template <typename T, int D, bool kPacked>
static int launch(const WinAttnParams<T>& p, int nH, cudaStream_t stream) {
  const size_t smem = core_layout<D>(sizeof(T)).total;
  auto kernel = window_attention_kernel<T, D, kPacked>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int G = 64 / (p.win * p.win);
  const int per_head = kPacked ? (p.Bw + G - 1) / G : p.Bw;
  const dim3 grid((per_head + kGroup - 1) / kGroup, nH);
  kernel<<<grid, kCoreThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// The token map of kernel 4's mask bits: identity windows at place
// w mod nW, or packed tiles.
template <bool kPacked>
__device__ __forceinline__ auto make_core_tokens(
    const WinAttnParams<bf16>& p) {
  if constexpr (kPacked)
    return PackedTokens(p.H, p.W, p.shift, 0, p.win, p.Bw);
  else
    return WindowTokens(p.H, p.W, p.shift, 0);
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
// j / Bw, at offset 64 D j), or with kPacked the packed tiles of each
// head's windows (CoreItems). 128 registers a thread at most.
template <int D, bool kPacked = false>
__global__ void __launch_bounds__(128, 4)
    window_attention_mma_kernel(WinAttnParams<bf16> p, int nH, int chunk) {
  using L = WinMma<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int ldk = L::ldk, ldb = L::ldb, vpr = D / 8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t4 = lane & 3, r0 = warp * 16;
  const int ta = r0 + gq, tb = ta + 8;  // this lane's rows of the window
  float* bias_s = reinterpret_cast<float*>(smem + L::bias);
  using Tokens =
      typename std::conditional<kPacked, PackedTokens, WindowTokens>::type;
  const Tokens tok = make_core_tokens<kPacked>(p);
  const CoreItems<kPacked> items(p.Bw, p.win);
  const int j0 = blockIdx.x * chunk,
            j1 = min(j0 + chunk, nH * items.per_head);
  auto tile = [&](int buf, int m) {
    return reinterpret_cast<bf16*>(smem + L::buf + buf * L::kBuf +
                                   m * L::kTile);
  };
  auto load = [&](int j, int buf) {
    const size_t base = items.base(j) * D;
    for (int i = tid; i < 3 * 64 * vpr; i += 128) {
      const int m = i / (64 * vpr), t = (i / vpr) % 64, c = (i % vpr) * 8;
      const bf16* src = m == 0 ? p.q : (m == 1 ? p.k : p.v);
      cp_async16(tile(buf, m) + t * ldk + c, src + base + t * D + c,
                 items.valid(j, t));
    }
  };
  if (j0 < j1) load(j0, 0);
  cp_async_commit();

  for (int j = j0, buf = 0; j < j1; ++j, buf ^= 1) {
    const int h = j / items.per_head, w = j % items.per_head;
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
    uint32_t qa[frags_k(D)][4];
    if constexpr (D == 8) {  // the m16k8 fragment, its high half zero
      uint32_t r[2];
      ldsm_x2(r, Q + (r0 + (lane & 15)) * ldk);
      qa[0][0] = r[0];
      qa[0][1] = r[1];
      qa[0][2] = qa[0][3] = 0u;
    } else {
#pragma unroll
      for (int k = 0; k < D / 16; ++k)
        ldsm_x4(qa[k],
                Q + (r0 + (lane & 15)) * ldk + k * 16 + (lane >> 4) * 8);
    }
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
    const size_t base = items.base(j) * D;
#pragma unroll
    for (int i = lane; i < 16 * vpr; i += 32) {
      const int t = r0 + i / vpr, c = (i % vpr) * 8;
      if (items.valid(j, t))
        *reinterpret_cast<uint4*>(p.out + base + t * D + c) =
            *reinterpret_cast<const uint4*>(Q + t * ldk + c);
    }
  }
  cp_async_wait<0>();
}

template <int D, bool kPacked>
static int launch_mma(const WinAttnParams<bf16>& p, int nH, int chunk,
                      int grid, cudaStream_t stream) {
  auto kernel = window_attention_mma_kernel<D, kPacked>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)WinMma<D>::total);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, 128, WinMma<D>::total, stream>>>(p, nH, chunk);
  return (int)cudaGetLastError();
}

// f(IntC<D>, IntC<packed>) for head dim D, packed tiles or not
template <typename F>
static int with_core(int D, int packed, F f) {
  auto by_d = [&](auto pk) {
    if (D == 16) return f(IntC<16>{}, pk);
    if (D == 32) return f(IntC<32>{}, pk);
    if (D == 8) return f(IntC<8>{}, pk);
    if (D == 64) return f(IntC<64>{}, pk);
    return (int)cudaErrorInvalidValue;
  };
  return packed ? by_d(IntC<1>{}) : by_d(IntC<0>{});
}

template <typename T>
static int run(const void* q, const void* k, const void* v,
               const float* bias, void* out, int nH, int Bw, int D, int H,
               int W, int win, int shift, float scale, int chunk, int grid,
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
  p.win = win;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (win < 1 || win > 8) return (int)cudaErrorInvalidValue;
  return with_core(D, win != 8, [&](auto d, auto pk) {
    constexpr int Dd = decltype(d)::value;
    constexpr bool kPacked = decltype(pk)::value;
    if constexpr (std::is_same<T, bf16>::value)
      return launch_mma<Dd, kPacked>(p, nH, chunk, grid, s);
    else
      return launch<T, Dd, kPacked>(p, nH, s);
  });
}

}  // namespace uf

extern "C" {

// The blocks of the bf16 body at head dim D (on packed tiles or not)
// resident on the card at once; 0 for fp32, which runs a block per (head,
// group of windows); a negated cudaError_t on failure.
int uf_window_attention_slots(int is_bf16, int D, int packed) {
  if (!is_bf16) return 0;
  int slots = 0;
  const int e = uf::with_core(D, packed, [&](auto d, auto pk) {
    constexpr int Dd = decltype(d)::value;
    constexpr bool kPacked = decltype(pk)::value;
    return (int)uf::resident_slots(
        uf::window_attention_mma_kernel<Dd, kPacked>, 128,
        uf::WinMma<Dd>::total, &slots);
  });
  return e ? -e : slots;
}

// Returns a cudaError_t. is_bf16 selects bf16 (else fp32) for q, k, v and
// out, (nH, Bw, win^2, D); the (nH, 64, 64) bias (at win < 8 its tile,
// tile_bias) is fp32. Window w of the Bw lies at place w mod nW of an
// H x W image (region ids of the shift mask). bf16: `chunk` windows (or
// packed tiles) a block, `grid` blocks (window_attention_plan); fp32
// ignores them.
int uf_window_attention(int is_bf16, const void* q, const void* k,
                        const void* v, const float* bias, void* out, int nH,
                        int Bw, int D, int H, int W, int win, int shift,
                        float scale, int chunk, int grid, void* stream) {
  if (is_bf16)
    return uf::run<uf::bf16>(q, k, v, bias, out, nH, Bw, D, H, W, win,
                             shift, scale, chunk, grid, stream);
  return uf::run<float>(q, k, v, bias, out, nH, Bw, D, H, W, win, shift,
                        scale, chunk, grid, stream);
}

}  // extern "C"
