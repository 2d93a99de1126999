// DEPOSITUM prox and update kernels for Hopper (sm_90a).
//
// Replaces the four Pallas TPU kernels of the JAX reference's
// src/repro/kernels/prox/kernel.py:
//   * _fused_sweep_kernel    (via fused_update_sweep_pallas)
//       nu' = gamma nu + (1 - gamma) y ;  x' = prox_{alpha h}(x - alpha nu')
//       for h in l1 | mcp | scad (_prox_block);
//   * _tracking_sweep_kernel (via fused_tracking_sweep_pallas)
//       y' = y + beta (g_new - g_old), and when gated g_kept = live ? g_new : g_old;
//   * _fused_kernel          (via fused_update_pallas): the one-config fused
//       update, which is fused_update_kernel's ungated instantiation on a
//       (1, 1, n) view with a (1, 5) table (entry point prox_sweep_update);
//   * _prox_kernel           (via prox_pallas): the standalone prox of any
//       leaf, prox_kernel below (entry point prox_apply).  It reads x and
//       writes out, 8 B an element in fp32, ~8 flops: a byte-bound stream.
//
// Layout: every operand is a contiguous (S, C, d) view (S stacked configs,
// C clients, d elements of one parameter leaf).  The grid is 2-D: grid.y
// walks the S*C rows, grid.x the d axis.  Each block reads its row's
// hyperparameters from the (S, 5) table [lam, theta, alpha, gamma, beta]
// and its cohort-gate value from the (S, C) mask once, into registers.  A
// frozen row (mask <= 0) is copied through unchanged, bit for bit, without
// reading the operands it does not need.  The TPU layout's (rows, 128)
// padding is gone: loads are float4 when d % 4 == 0 and the pointers are
// 16-byte aligned, otherwise scalar with a bounds check.
//
// Bound on an H100 (3.35 TB/s HBM3): both kernels are pure streams with ~10
// flops per element, far below the 67 TFLOP/s fp32 rate, so bytes bound
// them.  The update moves 5 x 4 B per fp32 element (read x, y, nu; write
// x', nu'), tracking 4 x 4 B (5 x 4 B gated: g_kept is written too).  At
// the main path's shapes (10 clients x 10,346 parameters, six leaves) the
// byte bound is well under a microsecond a step, so launch latency, not
// bytes, sets the time: fusing all leaves into one launch, or a CUDA
// graph, is the lever for later work.
//
// Arithmetic is fp32 whatever the storage type (fp32 or bf16), one rounding
// per operation in the same order as the plain PyTorch version
// (kernel.py); the build passes -fmad=false so nvcc does not contract
// multiply-add pairs, and no --use_fast_math (it would change division and
// flush denormals).  The prox kind and the gate are template parameters;
// hyperparameters are runtime values, so new values never rebuild.
//
// C interface: each entry point launches on the given stream, allocates
// nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocksX = 1024;  // grid-stride along d beyond this
constexpr int kMaxRows = 65535;    // grid.y limit; grid-stride over rows beyond

enum Kind { kL1 = 0, kMcp = 1, kScad = 2 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// torch.sign: +1, -1, and 0 for +-0 and NaN
__device__ __forceinline__ float sgn(float v) {
  return static_cast<float>((0.f < v) - (v < 0.f));
}

// torch.clamp_min(v, 0): NaN propagates
__device__ __forceinline__ float max0(float v) { return v < 0.f ? 0.f : v; }

struct UpdateConsts {
  float gamma, omg, alpha;  // momentum and step
  float thr;                // alpha * lam
  float tl;                 // theta * lam
  float div;                // 1 - alpha / theta            (mcp)
  float hi1;                // (1 + alpha) * lam            (scad)
  float tm1, tla, den;      // theta - 1, theta*lam*alpha, theta - 1 - alpha (scad)
};

__device__ __forceinline__ UpdateConsts load_consts(const float* p) {
  const float lam = p[0], theta = p[1], alpha = p[2], gamma = p[3];
  UpdateConsts c;
  c.gamma = gamma;
  c.omg = 1.f - gamma;
  c.alpha = alpha;
  c.thr = alpha * lam;
  c.tl = theta * lam;
  c.div = 1.f - alpha / theta;
  c.hi1 = (1.f + alpha) * lam;
  c.tm1 = theta - 1.f;
  c.tla = (theta * lam) * alpha;
  c.den = (theta - 1.f) - alpha;
  return c;
}

template <int K>
__device__ __forceinline__ float prox(float s, const UpdateConsts& c) {
  const float a = fabsf(s);
  const float soft = sgn(s) * max0(a - c.thr);
  if (K == kL1) return soft;
  if (K == kMcp) {
    const float out = (a <= c.tl) ? soft / c.div : s;
    return (a <= c.thr) ? 0.f : out;
  }
  // sign(s) * theta * lam * alpha == sgn(s) * tla exactly (sgn is +-1 or 0)
  const float r2 = (c.tm1 * s - sgn(s) * c.tla) / c.den;
  return (a <= c.hi1) ? soft : ((a <= c.tl) ? r2 : s);
}

template <int K>
__device__ __forceinline__ void update_elem(float x, float y, float nu,
                                            const UpdateConsts& c,
                                            float& xo, float& nuo) {
  const float nn = c.gamma * nu + c.omg * y;
  nuo = nn;
  xo = prox<K>(x - c.alpha * nn, c);
}

template <typename T, int K, bool GATED, bool VEC>
__global__ void __launch_bounds__(kThreads)
fused_update_kernel(const T* __restrict__ x, const T* __restrict__ y,
                    const T* __restrict__ nu, const float* __restrict__ params,
                    const float* __restrict__ mask, T* __restrict__ xo,
                    T* __restrict__ nuo, int S, int C, long long d) {
  const long long rows = static_cast<long long>(S) * C;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
    const long long base = row * d;
    if (GATED && !(mask[row] > 0.f)) {  // frozen row: copy through
      if (VEC) {
        const float4* x4 = reinterpret_cast<const float4*>(x + base);
        const float4* n4 = reinterpret_cast<const float4*>(nu + base);
        float4* xo4 = reinterpret_cast<float4*>(xo + base);
        float4* no4 = reinterpret_cast<float4*>(nuo + base);
        for (long long i = tid; i < d / 4; i += stride) {
          xo4[i] = x4[i];
          no4[i] = n4[i];
        }
      } else {
        for (long long i = tid; i < d; i += stride) {
          xo[base + i] = x[base + i];
          nuo[base + i] = nu[base + i];
        }
      }
      continue;
    }
    const UpdateConsts c = load_consts(params + 5 * (row / C));
    if (VEC) {
      const float4* x4 = reinterpret_cast<const float4*>(x + base);
      const float4* y4 = reinterpret_cast<const float4*>(y + base);
      const float4* n4 = reinterpret_cast<const float4*>(nu + base);
      float4* xo4 = reinterpret_cast<float4*>(xo + base);
      float4* no4 = reinterpret_cast<float4*>(nuo + base);
      for (long long i = tid; i < d / 4; i += stride) {
        const float4 a = x4[i], b = y4[i], n = n4[i];
        float4 ox, on;
        update_elem<K>(a.x, b.x, n.x, c, ox.x, on.x);
        update_elem<K>(a.y, b.y, n.y, c, ox.y, on.y);
        update_elem<K>(a.z, b.z, n.z, c, ox.z, on.z);
        update_elem<K>(a.w, b.w, n.w, c, ox.w, on.w);
        xo4[i] = ox;
        no4[i] = on;
      }
    } else {
      for (long long i = tid; i < d; i += stride) {
        float ox, on;
        update_elem<K>(to_f(x[base + i]), to_f(y[base + i]),
                       to_f(nu[base + i]), c, ox, on);
        xo[base + i] = from_f<T>(ox);
        nuo[base + i] = from_f<T>(on);
      }
    }
  }
}

// Standalone prox of a flat leaf of n elements; params is a 5-wide table
// row [lam, theta, alpha, gamma, beta] of which lam, theta, alpha are read.
template <typename T, int K, bool VEC>
__global__ void __launch_bounds__(kThreads)
prox_kernel(const T* __restrict__ x, const float* __restrict__ params,
            T* __restrict__ out, long long n) {
  const UpdateConsts c = load_consts(params);
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  if (VEC) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (long long i = tid; i < n / 4; i += stride) {
      const float4 a = x4[i];
      o4[i] = make_float4(prox<K>(a.x, c), prox<K>(a.y, c), prox<K>(a.z, c),
                          prox<K>(a.w, c));
    }
  } else {
    for (long long i = tid; i < n; i += stride) out[i] = from_f<T>(prox<K>(to_f(x[i]), c));
  }
}

template <typename T, bool GATED, bool VEC>
__global__ void __launch_bounds__(kThreads)
tracking_kernel(const T* __restrict__ y, const T* __restrict__ gn,
                const T* __restrict__ go, const float* __restrict__ params,
                const float* __restrict__ mask, T* __restrict__ yo,
                T* __restrict__ gk, int S, int C, long long d) {
  const long long rows = static_cast<long long>(S) * C;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
    const long long base = row * d;
    const bool live = !GATED || mask[row] > 0.f;
    if (!live) {  // frozen row: y and the old gradient pass through
      if (VEC) {
        const float4* y4 = reinterpret_cast<const float4*>(y + base);
        const float4* go4 = reinterpret_cast<const float4*>(go + base);
        float4* yo4 = reinterpret_cast<float4*>(yo + base);
        float4* gk4 = reinterpret_cast<float4*>(gk + base);
        for (long long i = tid; i < d / 4; i += stride) {
          yo4[i] = y4[i];
          gk4[i] = go4[i];
        }
      } else {
        for (long long i = tid; i < d; i += stride) {
          yo[base + i] = y[base + i];
          gk[base + i] = go[base + i];
        }
      }
      continue;
    }
    const float beta = params[5 * (row / C) + 4];
    if (VEC) {
      const float4* y4 = reinterpret_cast<const float4*>(y + base);
      const float4* gn4 = reinterpret_cast<const float4*>(gn + base);
      const float4* go4 = reinterpret_cast<const float4*>(go + base);
      float4* yo4 = reinterpret_cast<float4*>(yo + base);
      float4* gk4 = reinterpret_cast<float4*>(gk + base);
      for (long long i = tid; i < d / 4; i += stride) {
        const float4 a = y4[i], n = gn4[i], o = go4[i];
        float4 r;
        r.x = a.x + beta * (n.x - o.x);
        r.y = a.y + beta * (n.y - o.y);
        r.z = a.z + beta * (n.z - o.z);
        r.w = a.w + beta * (n.w - o.w);
        yo4[i] = r;
        if (GATED) gk4[i] = n;
      }
    } else {
      for (long long i = tid; i < d; i += stride) {
        const T n = gn[base + i];
        yo[base + i] = from_f<T>(to_f(y[base + i]) +
                                 beta * (to_f(n) - to_f(go[base + i])));
        if (GATED) gk[base + i] = n;
      }
    }
  }
}

dim3 grid_for(int S, int C, long long d, bool vec) {
  const long long per_block = static_cast<long long>(kThreads) * (vec ? 4 : 1);
  long long bx = (d + per_block - 1) / per_block;
  if (bx > kMaxBlocksX) bx = kMaxBlocksX;
  long long by = static_cast<long long>(S) * C;
  if (by > kMaxRows) by = kMaxRows;
  return dim3(static_cast<unsigned>(bx), static_cast<unsigned>(by));
}

template <typename T, int K, bool GATED, bool VEC>
int launch_update(const void* x, const void* y, const void* nu,
                  const void* params, const void* mask, void* xo, void* nuo,
                  int S, int C, long long d, cudaStream_t stream) {
  fused_update_kernel<T, K, GATED, VEC><<<grid_for(S, C, d, VEC), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const T*>(nu), static_cast<const float*>(params),
      static_cast<const float*>(mask), static_cast<T*>(xo),
      static_cast<T*>(nuo), S, C, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int K, bool GATED>
int update_vec(int vec, const void* x, const void* y, const void* nu,
               const void* params, const void* mask, void* xo, void* nuo,
               int S, int C, long long d, cudaStream_t st) {
  if constexpr (std::is_same<T, float>::value) {
    if (vec) return launch_update<T, K, GATED, true>(x, y, nu, params, mask, xo, nuo, S, C, d, st);
  }
  return launch_update<T, K, GATED, false>(x, y, nu, params, mask, xo, nuo, S, C, d, st);
}

template <typename T, int K>
int update_gate(int vec, const void* x, const void* y, const void* nu,
                const void* params, const void* mask, void* xo, void* nuo,
                int S, int C, long long d, cudaStream_t st) {
  return mask ? update_vec<T, K, true>(vec, x, y, nu, params, mask, xo, nuo, S, C, d, st)
              : update_vec<T, K, false>(vec, x, y, nu, params, mask, xo, nuo, S, C, d, st);
}

template <typename T>
int update_kind(int kind, int vec, const void* x, const void* y, const void* nu,
                const void* params, const void* mask, void* xo, void* nuo,
                int S, int C, long long d, cudaStream_t st) {
  switch (kind) {
    case kL1: return update_gate<T, kL1>(vec, x, y, nu, params, mask, xo, nuo, S, C, d, st);
    case kMcp: return update_gate<T, kMcp>(vec, x, y, nu, params, mask, xo, nuo, S, C, d, st);
    case kScad: return update_gate<T, kScad>(vec, x, y, nu, params, mask, xo, nuo, S, C, d, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, bool GATED, bool VEC>
int launch_tracking(const void* y, const void* gn, const void* go,
                    const void* params, const void* mask, void* yo, void* gk,
                    int S, int C, long long d, cudaStream_t stream) {
  tracking_kernel<T, GATED, VEC><<<grid_for(S, C, d, VEC), kThreads, 0, stream>>>(
      static_cast<const T*>(y), static_cast<const T*>(gn),
      static_cast<const T*>(go), static_cast<const float*>(params),
      static_cast<const float*>(mask), static_cast<T*>(yo),
      static_cast<T*>(gk), S, C, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool GATED>
int tracking_vec(int vec, const void* y, const void* gn, const void* go,
                 const void* params, const void* mask, void* yo, void* gk,
                 int S, int C, long long d, cudaStream_t st) {
  if constexpr (std::is_same<T, float>::value) {
    if (vec) return launch_tracking<T, GATED, true>(y, gn, go, params, mask, yo, gk, S, C, d, st);
  }
  return launch_tracking<T, GATED, false>(y, gn, go, params, mask, yo, gk, S, C, d, st);
}

template <typename T>
int tracking_dispatch(int vec, const void* y, const void* gn, const void* go,
                      const void* params, const void* mask, void* yo, void* gk,
                      int S, int C, long long d, cudaStream_t st) {
  return mask ? tracking_vec<T, true>(vec, y, gn, go, params, mask, yo, gk, S, C, d, st)
              : tracking_vec<T, false>(vec, y, gn, go, params, mask, yo, gk, S, C, d, st);
}

template <typename T, int K, bool VEC>
int launch_prox(const void* x, const void* params, void* out, long long n,
                cudaStream_t stream) {
  prox_kernel<T, K, VEC><<<grid_for(1, 1, n, VEC), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(params),
      static_cast<T*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int K>
int prox_vec(int vec, const void* x, const void* params, void* out,
             long long n, cudaStream_t st) {
  if constexpr (std::is_same<T, float>::value) {
    if (vec) return launch_prox<T, K, true>(x, params, out, n, st);
  }
  return launch_prox<T, K, false>(x, params, out, n, st);
}

template <typename T>
int prox_kind(int kind, int vec, const void* x, const void* params, void* out,
              long long n, cudaStream_t st) {
  switch (kind) {
    case kL1: return prox_vec<T, kL1>(vec, x, params, out, n, st);
    case kMcp: return prox_vec<T, kMcp>(vec, x, params, out, n, st);
    case kScad: return prox_vec<T, kScad>(vec, x, params, out, n, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  vec = 1 only for float32 with
// d % 4 == 0 and 16-byte-aligned pointers.  mask == NULL: ungated.
int prox_sweep_update(const void* x, const void* y, const void* nu,
                      const void* params, const void* mask, void* xo,
                      void* nuo, int S, int C, long long d, int kind,
                      int dtype, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return update_kind<float>(kind, vec, x, y, nu, params, mask, xo, nuo, S, C, d, st);
  if (dtype == 1 && !vec)
    return update_kind<__nv_bfloat16>(kind, 0, x, y, nu, params, mask, xo, nuo, S, C, d, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// g_kept (gk) is written only when gated (mask != NULL).
int prox_sweep_tracking(const void* y, const void* gn, const void* go,
                        const void* params, const void* mask, void* yo,
                        void* gk, int S, int C, long long d, int dtype,
                        int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return tracking_dispatch<float>(vec, y, gn, go, params, mask, yo, gk, S, C, d, st);
  if (dtype == 1 && !vec)
    return tracking_dispatch<__nv_bfloat16>(0, y, gn, go, params, mask, yo, gk, S, C, d, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Standalone prox of n elements.  vec = 1 only for float32 with n % 4 == 0
// and 16-byte-aligned pointers.
int prox_apply(const void* x, const void* params, void* out, long long n,
               int kind, int dtype, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return prox_kind<float>(kind, vec, x, params, out, n, st);
  if (dtype == 1 && !vec) return prox_kind<__nv_bfloat16>(kind, 0, x, params, out, n, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
