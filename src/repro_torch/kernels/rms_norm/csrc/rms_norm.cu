// RMSNorm forward and backward for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference's rms_norm
// (src/repro/models/common.py) is plain jnp, which XLA fuses on the TPU.
// The port's plain version (models/common.py::rms_norm) runs on the card
// as 10 eager ops forward and 17 backward, each a pass over an fp32 copy
// of the rows; under remat "full" a norm costs ~37 launches a step.  These
// kernels take their place on CUDA tensors (kernels/rms_norm/kernel.py):
//
//   forward   y  = x r (1 + w),  r = rsqrt(mean(x^2) + eps)       1 launch
//   backward  g  = (1 + w) dy,   xh = x r
//             dx = r (g - xh mean(xh g))
//             dw = sum over rows of dy xh                        2 launches
//
// Arithmetic is fp32 whatever the storage type (fp32 or bf16), in the
// plain version's order: the sum of squares, r, then (x r)(1 + w), and
// one rounding to x's dtype at the store.  Nothing in fp32 touches device
// memory but the backward's per-block partial sums of dw.
//
// Rows.  x is `rows` rows of d elements, row i at x + i * x_stride (unit
// column stride), so a strided view (multi-head latent attention's latent
// c, 512 columns of a 576-column row) is read in place.  y and dx are
// written as contiguous rows.
//
// Block shape follows d.  A row is split into chunks: 16 bytes (8 bf16 or
// 4 fp32 elements, one vector load) on the vector route, which the host
// takes when d, the row strides and every pointer are whole vectors; one
// element on the element route otherwise (an odd d, a misaligned view, an
// fp32 row past 4,096 backward).  `tpr` threads, a power of two from 4 to
// 512 that the host picks from d, take a row together: thread `lane`
// holds chunks lane, lane + tpr, ... (at most kNV: 4 vectors forward, 2
// backward, or 16 elements), so a warp's loads are coalesced and the row
// is read once, into registers.  Below 32 threads a row (qwen's head rows
// of 128 elements: 4 threads forward, 8 backward; the latent rows of 512:
// 16 and 32) a warp holds several rows and sums each by shuffles within
// its lanes; at 64 and above (d_model 2048: 64 threads of 4 vectors
// forward, 128 of 2 backward) a row's warps add their sums through shared
// memory.  Blocks are persistent (the host sizes the grid to what stays
// resident: 2 blocks of 512 an SM at the vector route's ~60 / ~100
// registers) and walk the rows a row group at a time, on the vector route
// loading the next group's chunks before they work on this one's; (1 + w)
// sits in shared memory in fp32 for the whole walk.
//
// Backward.  One pass: each thread reads its chunks of x and dy once,
// the row sums sum(x^2) and sum(x g) are one pair reduction, r is
// recomputed in registers and dx written.  Each thread adds dy xh of its
// columns over the rows it walks; at the end a block sums its row groups
// in a fixed order (through shared memory) and writes one fp32 row of
// partials; a second launch (rms_norm_dw_kernel) sums the partial rows in
// a fixed order and writes dw in w's dtype.  No atomics, so dw is the
// same bits from run to run on one card (the grid depends on the card's
// SM count).  One 512-thread block an SM: the partials cost 2 x 132 x d x
// 4 bytes (2.2 MB at d 2048, 4.3% of the (4,096 x 2,048) backward's
// traffic).
//
// Bound on an H100 (3.35 TB/s): ~10 flops an element, so bytes bound
// both.  Forward: x read and y written, 4 bytes an element in bf16; at
// (4,096 x 2,048) 33.5 MB, 10.0 us.  Backward: x, dy read and dx written,
// 6 bytes an element; 50.3 MB, 15.0 us.  By Little's law ~25 KB must be in
// flight an SM; with the next group's loads issued early a thread keeps 64
// B (forward: 4 vectors of x; backward: 2 of x and 2 of dy) in flight
// through the whole walk.
// Timed alone with cold operands (chip_smoke.py's check_norm): forward
// 13.96 us (72%; PyTorch's copy of x, the same bytes, 12.2-12.8), 13.2 us
// at (65,536 x 128) (76%); backward with its dw launch 23.2-23.5 us (64%)
// and 22.1-22.3 us (68%).  The forward's shapes timed alone at both
// (1, 2 or 4 vectors a thread; blocks of 128-1,024 threads; persistent or
// a block a row group): 4 vectors a thread in persistent 512-thread
// blocks is the fastest at both, 2 vectors read 67% / 73%, and a block a
// row group without the walk's prefetch 47-60% at d 2048.  Not kept
// either: 8 vectors a thread forward (one warp a row at d 2048, no
// prefetch), two row groups a pass (the backward spills), 4 vectors a
// thread backward (spills at the 512-thread bound), 1,024-thread backward
// blocks without prefetch (58-60%).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// One chunk of a row as it is stored: a 16-byte vector (VE elements) or
// one element (VE = 1), held raw in registers and widened on use.
template <typename T, int VE>
struct Chunk {
  static_assert(VE == 1 || VE * sizeof(T) == 16, "a chunk is 16 bytes or 1 element");
  static constexpr bool kVec = VE > 1;
  typename std::conditional<kVec, uint4, T>::type raw;

  __device__ __forceinline__ void load(const T* p) {
    raw = *reinterpret_cast<const decltype(raw)*>(p);
  }
  __device__ __forceinline__ void zero() {
    if constexpr (kVec) raw = make_uint4(0, 0, 0, 0);
    else raw = from_f<T>(0.f);
  }
  __device__ __forceinline__ float at(int e) const {
    if constexpr (kVec) return to_f(reinterpret_cast<const T*>(&raw)[e]);
    else return to_f(raw);
  }
};

template <typename T, int VE>
__device__ __forceinline__ void store_chunk(T* p, const float (&f)[VE]) {
  if constexpr (VE > 1) {
    uint4 u;
    T* t = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int e = 0; e < VE; ++e) t[e] = from_f<T>(f[e]);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
    *p = from_f<T>(f[0]);
  }
}

__device__ __forceinline__ float weight_at(const void* w, int w_bf16, int col) {
  return w_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(w)[col])
                : static_cast<const float*>(w)[col];
}

// N fp32 row sums carried together through one reduction.
template <int N>
struct Sums {
  float v[N];
};
template <int N>
__device__ __forceinline__ Sums<N> operator+(Sums<N> a, const Sums<N>& b) {
#pragma unroll
  for (int i = 0; i < N; ++i) a.v[i] += b.v[i];
  return a;
}
template <int N>
__device__ __forceinline__ Sums<N> shfl_xor(Sums<N> a, int off) {
#pragma unroll
  for (int i = 0; i < N; ++i) a.v[i] = __shfl_xor_sync(0xffffffffu, a.v[i], off);
  return a;
}

// The sums over the tpr threads of each row group (aligned groups, tpr a
// power of two), the same bits in every thread of the group (a xor
// butterfly, then the group's warps in order).  At tpr > 32 it passes one
// __syncthreads; `red` is 2 x 32 slots of shared memory, used by turns
// (`par`), so one barrier a pass suffices.
template <int N>
__device__ __forceinline__ Sums<N> group_sum(Sums<N> v, int tpr,
                                             Sums<N> (*red)[32], int par) {
  const int width = tpr < 32 ? tpr : 32;
  for (int off = 1; off < width; off <<= 1) v = v + shfl_xor(v, off);
  if (tpr <= 32) return v;
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[par][warp] = v;
  __syncthreads();
  const int nw = tpr >> 5, first = warp / nw * nw;
  Sums<N> s = red[par][first];
  for (int i = 1; i < nw; ++i) s = s + red[par][first + i];
  return s;
}

// (1 + w) in fp32 into shared memory (d floats), for the block's walk.
__device__ __forceinline__ void load_weight(float* wsm, const void* w,
                                            int w_bf16, int d) {
  for (int i = threadIdx.x; i < d; i += blockDim.x)
    wsm[i] = 1.f + weight_at(w, w_bf16, i);
  __syncthreads();
}

template <int VE>
__device__ __forceinline__ void weight_chunk(const float* wsm, int c,
                                             float (&f)[VE]) {
  if constexpr (VE == 8) {
    const float4 a = reinterpret_cast<const float4*>(wsm)[2 * c];
    const float4 b = reinterpret_cast<const float4*>(wsm)[2 * c + 1];
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  } else if constexpr (VE == 4) {
    const float4 a = reinterpret_cast<const float4*>(wsm)[c];
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  } else {
    f[0] = wsm[c];
  }
}

// The route's chunk and its chunks a thread by direction: 16-byte
// vectors, at most 4 a thread forward and 2 backward (which holds x and
// dy); or elements, at most 16.  The vector route loads the next row
// group's chunks while it works on this one's (kPrefetch: ~60 registers
// forward, ~100 backward, hence a 512-thread backward block); the element
// route's 16 elements of x and dy a thread leave no registers for it.
template <typename T, bool kVec, bool kBwd>
struct Route {
  static constexpr int VE = kVec ? 16 / sizeof(T) : 1;
  static constexpr int kNV = kVec ? (kBwd ? 2 : 4) : 16;
  static constexpr bool kPrefetch = kVec;
};
// Threads a row at most, and of a backward block holding several rows.
constexpr int kMaxTpr = 512, kBwdThreads = 512;

// Row r's chunks of this thread (lane + k tpr), zero past the row or past
// the rows.
template <typename T, int VE, int kNV>
__device__ __forceinline__ void load_row(Chunk<T, VE> (&v)[kNV],
                                         const T* __restrict__ p,
                                         long long stride, long long r,
                                         long long rows, int lane, int tpr,
                                         int chunks) {
  const T* pr = p + (r < rows ? r : 0) * stride;
#pragma unroll
  for (int k = 0; k < kNV; ++k) {
    const int c = lane + k * tpr;
    if (r < rows && c < chunks) v[k].load(pr + static_cast<long long>(c) * VE);
    else v[k].zero();
  }
}

// A block walks row groups: in a pass group g takes row base + g, base
// advancing by gridDim.x x groups.
template <typename T, int VE, int kNV>
__global__ void __launch_bounds__(1024)
rms_norm_fwd_kernel(const T* __restrict__ x, long long x_stride,
                    const void* __restrict__ w, int w_bf16, T* __restrict__ y,
                    long long rows, int d, int tpr, float eps) {
  constexpr bool kPrefetch = Route<T, (VE > 1), false>::kPrefetch;
  extern __shared__ float4 wsm4[];
  float* wsm = reinterpret_cast<float*>(wsm4);
  __shared__ Sums<1> red[2][32];
  const int groups = blockDim.x / tpr, g = threadIdx.x / tpr,
            lane = threadIdx.x % tpr, chunks = d / VE;
  const float inv_d = 1.f / static_cast<float>(d);
  const long long step = static_cast<long long>(gridDim.x) * groups;
  long long base = static_cast<long long>(blockIdx.x) * groups;
  Chunk<T, VE> xv[kNV];
  if (kPrefetch) load_row(xv, x, x_stride, base + g, rows, lane, tpr, chunks);
  load_weight(wsm, w, w_bf16, d);
  int par = 0;
  for (; base < rows; base += step) {
    const long long r = base + g;
    Chunk<T, VE> nx[kNV];
    if constexpr (kPrefetch)
      load_row(nx, x, x_stride, r + step, rows, lane, tpr, chunks);
    else
      load_row(xv, x, x_stride, r, rows, lane, tpr, chunks);
    Sums<1> ss{{0.f}};
#pragma unroll
    for (int k = 0; k < kNV; ++k)
#pragma unroll
      for (int e = 0; e < VE; ++e) ss.v[0] += xv[k].at(e) * xv[k].at(e);
    ss = group_sum(ss, tpr, red, par);
    par ^= 1;
    if (r < rows) {
      const float rstd = rsqrtf(ss.v[0] * inv_d + eps);
      T* yr = y + r * d;
#pragma unroll
      for (int k = 0; k < kNV; ++k) {
        const int c = lane + k * tpr;
        if (c >= chunks) continue;
        float wp[VE], o[VE];
        weight_chunk<VE>(wsm, c, wp);
#pragma unroll
        for (int e = 0; e < VE; ++e) o[e] = (xv[k].at(e) * rstd) * wp[e];
        store_chunk<T, VE>(yr + static_cast<long long>(c) * VE, o);
      }
    }
    if constexpr (kPrefetch) {
#pragma unroll
      for (int k = 0; k < kNV; ++k) xv[k] = nx[k];
    }
  }
}

template <typename T, int VE, int kNV>
__global__ void __launch_bounds__(kBwdThreads)
rms_norm_bwd_kernel(const T* __restrict__ x, long long x_stride,
                    const T* __restrict__ dy, long long dy_stride,
                    const void* __restrict__ w, int w_bf16,
                    T* __restrict__ dx, float* __restrict__ partial,
                    long long rows, int d, int tpr, float eps) {
  constexpr bool kPrefetch = Route<T, (VE > 1), true>::kPrefetch;
  extern __shared__ float4 wsm4[];
  float* wsm = reinterpret_cast<float*>(wsm4);
  __shared__ Sums<2> red[2][32];
  __shared__ float buf[kBwdThreads * VE];
  const int groups = blockDim.x / tpr, g = threadIdx.x / tpr,
            lane = threadIdx.x % tpr, chunks = d / VE;
  const float inv_d = 1.f / static_cast<float>(d);
  const long long step = static_cast<long long>(gridDim.x) * groups;
  long long base = static_cast<long long>(blockIdx.x) * groups;
  Chunk<T, VE> xv[kNV], gv[kNV];
  if (kPrefetch) {
    load_row(xv, x, x_stride, base + g, rows, lane, tpr, chunks);
    load_row(gv, dy, dy_stride, base + g, rows, lane, tpr, chunks);
  }
  load_weight(wsm, w, w_bf16, d);
  float acc[kNV][VE];
#pragma unroll
  for (int k = 0; k < kNV; ++k)
#pragma unroll
    for (int e = 0; e < VE; ++e) acc[k][e] = 0.f;
  int par = 0;
  for (; base < rows; base += step) {
    const long long r = base + g;
    Chunk<T, VE> nx[kNV], ng[kNV];
    if constexpr (kPrefetch) {
      load_row(nx, x, x_stride, r + step, rows, lane, tpr, chunks);
      load_row(ng, dy, dy_stride, r + step, rows, lane, tpr, chunks);
    } else {
      load_row(xv, x, x_stride, r, rows, lane, tpr, chunks);
      load_row(gv, dy, dy_stride, r, rows, lane, tpr, chunks);
    }
    Sums<2> s{{0.f, 0.f}};  // sum x^2, sum x g with g = (1 + w) dy
#pragma unroll
    for (int k = 0; k < kNV; ++k) {
      const int c = lane + k * tpr;
      float wp[VE];
      weight_chunk<VE>(wsm, c < chunks ? c : 0, wp);
#pragma unroll
      for (int e = 0; e < VE; ++e) {
        const float xe = xv[k].at(e);
        s.v[0] += xe * xe;
        s.v[1] += xe * (wp[e] * gv[k].at(e));
      }
    }
    s = group_sum(s, tpr, red, par);
    par ^= 1;
    if (r < rows) {
      const float rstd = rsqrtf(s.v[0] * inv_d + eps);
      const float m = rstd * s.v[1] * inv_d;  // mean(xh g)
      T* dxr = dx + r * d;
#pragma unroll
      for (int k = 0; k < kNV; ++k) {
        const int c = lane + k * tpr;
        if (c >= chunks) continue;
        float wp[VE], o[VE];
        weight_chunk<VE>(wsm, c, wp);
#pragma unroll
        for (int e = 0; e < VE; ++e) {
          const float xh = xv[k].at(e) * rstd, dye = gv[k].at(e);
          o[e] = rstd * (wp[e] * dye - xh * m);
          acc[k][e] += dye * xh;
        }
        store_chunk<T, VE>(dxr + static_cast<long long>(c) * VE, o);
      }
    }
    if constexpr (kPrefetch) {
#pragma unroll
      for (int k = 0; k < kNV; ++k) {
        xv[k] = nx[k];
        gv[k] = ng[k];
      }
    }
  }
  // this block's partial row of dw: its row groups summed in order
  float* out = partial + static_cast<long long>(blockIdx.x) * d;
  if (groups == 1) {
#pragma unroll
    for (int k = 0; k < kNV; ++k)
#pragma unroll
      for (int e = 0; e < VE; ++e) {
        const int col = (lane + k * tpr) * VE + e;
        if (col < d) out[col] = acc[k][e];
      }
    return;
  }
  const int span = tpr * VE;  // columns of one k across a group
#pragma unroll
  for (int k = 0; k < kNV; ++k) {
    if (k * span >= d) break;
    __syncthreads();
#pragma unroll
    for (int e = 0; e < VE; ++e) buf[g * span + lane * VE + e] = acc[k][e];
    __syncthreads();
    for (int j = threadIdx.x; j < span; j += blockDim.x) {
      const int col = k * span + j;
      if (col >= d) continue;
      float t = buf[j];
      for (int q = 1; q < groups; ++q) t += buf[q * span + j];
      out[col] = t;
    }
  }
}

// dw[col] = sum over p < parts of partial[p][col], in order of p: a block
// takes 32 columns, its 16 warps every 16th partial row, then one warp
// adds the 16 sums in order.
constexpr int kDwCols = 32, kDwSlices = 16;

__global__ void __launch_bounds__(kDwCols * kDwSlices)
rms_norm_dw_kernel(const float* __restrict__ partial, int parts, int d,
                   void* __restrict__ dw, int w_bf16) {
  __shared__ float s[kDwSlices][kDwCols + 1];
  const int cx = threadIdx.x % kDwCols, sy = threadIdx.x / kDwCols;
  const int col = blockIdx.x * kDwCols + cx;
  float a = 0.f;
  if (col < d)
    for (int p = sy; p < parts; p += kDwSlices)
      a += partial[static_cast<long long>(p) * d + col];
  s[sy][cx] = a;
  __syncthreads();
  if (sy != 0 || col >= d) return;
  float t = s[0][cx];
  for (int q = 1; q < kDwSlices; ++q) t += s[q][cx];
  if (w_bf16) static_cast<__nv_bfloat16*>(dw)[col] = __float2bfloat16_rn(t);
  else static_cast<float*>(dw)[col] = t;
}

// The launch's shape is one the kernels take: tpr a power of two in
// [4, kMaxTpr], threads a multiple of it up to the kernels' bounds (a
// backward block is kBwdThreads), the row in at most kNV chunks a thread,
// and the vector route on whole vectors.
template <typename T, bool kVec, bool kBwd>
bool shape_ok(int d, int tpr, int threads) {
  using R = Route<T, kVec, kBwd>;
  if (d <= 0 || tpr < 4 || tpr > kMaxTpr || (tpr & (tpr - 1)) ||
      threads % tpr || threads > 1024 || d % R::VE)
    return false;
  if (kBwd && threads != kBwdThreads) return false;
  return (d / R::VE + tpr - 1) / tpr <= R::kNV;
}

// One kernel of the pair for a storage type and route, and its dynamic
// shared memory, (1 + w): d floats.  Past 16 KB (where static and dynamic
// shared memory together could pass the default 48 KB) the kernel is
// allowed the size, once a device and size.
template <typename T, bool kVec, bool kBwd>
struct Kernel {
  using R = Route<T, kVec, kBwd>;
  static auto ptr() {
    if constexpr (kBwd) return rms_norm_bwd_kernel<T, R::VE, R::kNV>;
    else return rms_norm_fwd_kernel<T, R::VE, R::kNV>;
  }
  static cudaError_t smem(int d, size_t* bytes) {
    static int allowed[64];
    *bytes = static_cast<size_t>(d) * sizeof(float);
    if (*bytes <= 16 * 1024) return cudaSuccess;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= 64) return cudaErrorInvalidDevice;
    if (allowed[dev] >= static_cast<int>(*bytes)) return cudaSuccess;
    err = cudaFuncSetAttribute(ptr(), cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(*bytes));
    if (err == cudaSuccess) allowed[dev] = static_cast<int>(*bytes);
    return err;
  }
  static int occupancy(int threads, int d) {
    size_t bytes;
    cudaError_t err = smem(d, &bytes);
    int n = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, ptr(), threads, bytes);
    return err == cudaSuccess ? n : -static_cast<int>(err);
  }
};

template <typename T, bool kVec>
int fwd(const void* x, long long x_stride, const void* w, int w_bf16, void* y,
        long long rows, int d, int tpr, int threads, int blocks, float eps,
        cudaStream_t st) {
  using K = Kernel<T, kVec, false>;
  size_t smem;
  if (!shape_ok<T, kVec, false>(d, tpr, threads) || blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = K::smem(d, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto kernel = K::ptr();
  kernel<<<blocks, threads, smem, st>>>(static_cast<const T*>(x), x_stride, w,
                                        w_bf16, static_cast<T*>(y), rows, d,
                                        tpr, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kVec>
int bwd(const void* x, long long x_stride, const void* dy, long long dy_stride,
        const void* w, int w_bf16, void* dx, void* dw, float* partial,
        long long rows, int d, int tpr, int threads, int blocks, float eps,
        cudaStream_t st) {
  using K = Kernel<T, kVec, true>;
  size_t smem;
  if (!shape_ok<T, kVec, true>(d, tpr, threads) || blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = K::smem(d, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto kernel = K::ptr();
  kernel<<<blocks, threads, smem, st>>>(
      static_cast<const T*>(x), x_stride, static_cast<const T*>(dy), dy_stride,
      w, w_bf16, static_cast<T*>(dx), partial, rows, d, tpr, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rms_norm_dw_kernel<<<(d + kDwCols - 1) / kDwCols, kDwCols * kDwSlices, 0,
                       st>>>(partial, blocks, d, dw, w_bf16);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kVec>
int occupancy(int bwd_kernel, int threads, int d) {
  return bwd_kernel ? Kernel<T, kVec, true>::occupancy(threads, d)
                    : Kernel<T, kVec, false>::occupancy(threads, d);
}

}  // namespace

extern "C" {

// dtype and w_dtype: 0 = float32, 1 = bfloat16 (x, y, dy, dx share
// dtype); vec: 1 = the 16-byte route.  Each returns 0 or a CUDA error.

// Resident blocks an SM of the forward (bwd = 0) or backward (bwd = 1)
// kernel at `threads` threads and rows of d, or minus a CUDA error.
int rms_norm_occupancy(int dtype, int vec, int bwd, int threads, int d) {
  if (dtype == 0)
    return vec ? occupancy<float, true>(bwd, threads, d)
               : occupancy<float, false>(bwd, threads, d);
  if (dtype == 1)
    return vec ? occupancy<__nv_bfloat16, true>(bwd, threads, d)
               : occupancy<__nv_bfloat16, false>(bwd, threads, d);
  return -static_cast<int>(cudaErrorInvalidValue);
}

int rms_norm_fwd(const void* x, long long x_stride, const void* w, int w_dtype,
                 void* y, long long rows, int d, int dtype, int vec, int tpr,
                 int threads, int blocks, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w_dtype != 0 && w_dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return (vec ? fwd<float, true> : fwd<float, false>)(
        x, x_stride, w, w_dtype, y, rows, d, tpr, threads, blocks, eps, st);
  if (dtype == 1)
    return (vec ? fwd<__nv_bfloat16, true> : fwd<__nv_bfloat16, false>)(
        x, x_stride, w, w_dtype, y, rows, d, tpr, threads, blocks, eps, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// partial: blocks x d fp32 scratch; dw in w's dtype.
int rms_norm_bwd(const void* x, long long x_stride, const void* dy,
                 long long dy_stride, const void* w, int w_dtype, void* dx,
                 void* dw, void* partial, long long rows, int d, int dtype,
                 int vec, int tpr, int threads, int blocks, float eps,
                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  if (w_dtype != 0 && w_dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return (vec ? bwd<float, true> : bwd<float, false>)(
        x, x_stride, dy, dy_stride, w, w_dtype, dx, dw, p, rows, d, tpr,
        threads, blocks, eps, st);
  if (dtype == 1)
    return (vec ? bwd<__nv_bfloat16, true> : bwd<__nv_bfloat16, false>)(
        x, x_stride, dy, dy_stride, w, w_dtype, dx, dw, p, rows, d, tpr,
        threads, blocks, eps, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
