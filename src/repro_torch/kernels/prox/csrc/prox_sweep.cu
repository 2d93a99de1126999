// DEPOSITUM prox and update kernels for Hopper (sm_90a).
//
// Replaces the four Pallas TPU kernels of the JAX reference's
// src/repro/kernels/prox/kernel.py:
//   * _fused_sweep_kernel    (via fused_update_sweep_pallas)
//       nu' = gamma nu + (1 - gamma) y ;  x' = prox_{alpha h}(x - alpha nu')
//       for h in l1 | mcp | scad (_prox_block): fused_update_kernel;
//   * _tracking_sweep_kernel (via fused_tracking_sweep_pallas)
//       y' = y + beta (g_new - g_old), and when gated g_kept = live ? g_new : g_old:
//       tracking_kernel;
//   * _fused_kernel          (via fused_update_pallas): the one-config fused
//       update, which is fused_update_kernel's ungated instantiation on one
//       leaf of one (1, 1, n) row with a (1, 5) table;
//   * _prox_kernel           (via prox_pallas): the standalone prox of any
//       leaf, prox_kernel below (entry point prox_apply_grouped).  It reads
//       x and writes out, 8 B an element in fp32, ~8 flops: a byte-bound
//       stream.
//
// Grouped launches.  Every kernel here takes every leaf of a parameter
// tree in ONE launch (per dtype, per kMaxLeaves leaves).  A leaf table goes
// to the kernel by value, as a __grid_constant__ parameter: per leaf its
// operand and output pointers, d (elements of one (s, c) row), its first
// block in the launch and a vec flag; eight 8-byte words a leaf (struct
// Leaf), kMaxLeaves = 48 leaves, 3,080 bytes with the count, inside CUDA's
// classic 4 KB of parameters.  A tree with more leaves takes one launch per
// 48.  The grid is 1-D: leaf l owns blocks [first_l, first_l + S*C*tiles_l),
// tiles_l = ceil(d_l / kTile), kTile = 1024 elements (256 threads x float4).
// A block finds its leaf by a scan of the table's prefixes (<= 48 entries,
// read from the parameter space), then its (s, c) row and its tile of that
// row; it reads the row's hyperparameters from the (S, 5) table [lam, theta,
// alpha, gamma, beta] and its cohort-gate value from the (S, C) mask once,
// into registers.  A frozen row (mask <= 0) is copied through unchanged,
// bit for bit, without reading the operands it does not need.  Loads are
// float4 where the leaf's vec flag says so (fp32, d % 4 == 0 and all five
// pointers 16-byte aligned), otherwise scalar, masked at the tile's end.
// The standalone prox and the one-config update walk the same table with
// one row a leaf (a whole leaf of any shape is one row of d elements) and
// one (1, 5) parameter row for the whole call; the prox reads in[0] and
// writes out[0] only.
//
// The paper's MLP step (six leaves of 7,872 / 64 / 2,048 / 32 / 320 / 10
// elements a client, 10 clients) is 14 tiles a row x 10 rows = 140 blocks,
// about one wave on 132 SMs.  The host packs the table into a reused
// buffer and makes one ctypes call per launch: nothing is read back from
// the device and nothing is allocated here, so the launches can be
// captured in a CUDA graph.
//
// Bound on an H100 (3.35 TB/s HBM3): the kernels are pure streams with ~10
// flops per element, far below the 67 TFLOP/s fp32 rate, so bytes bound
// them.  The update moves 5 x 4 B per fp32 element (read x, y, nu; write
// x', nu'), tracking 4 x 4 B (5 x 4 B gated: g_kept is written too).  At
// the main path's shapes (10 clients x 10,346 parameters) the byte bound is
// 0.6 us a step for the update and 0.5 us for tracking, below one launch's
// latency: the number of launches and the host's work around each, not
// bytes, set the time there, hence one launch for all leaves of a step.
// At large shapes (one leaf of 4 x 16 x 2^20) the same kernel streams at
// ~90% of 3.35 TB/s.
//
// Arithmetic is fp32 whatever the storage type (fp32 or bf16), one rounding
// per operation in the same order as the plain PyTorch version
// (kernel.py); the build passes -fmad=false so nvcc does not contract
// multiply-add pairs, and no --use_fast_math (it would change division and
// flush denormals).  The prox kind and the gate are template parameters;
// hyperparameters are runtime values, so new values never rebuild.
//
// C interface: each entry point launches on the given stream, allocates
// nothing, and returns cudaGetLastError() (cudaErrorInvalidValue for a bad
// argument, without launching).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstring>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = kThreads * 4;  // elements of one row a block takes
constexpr int kMaxLeaves = 48;       // leaves in one launch's table

enum Kind { kL1 = 0, kMcp = 1, kScad = 2 };

// One leaf of a grouped launch, as kernel.py's leaf_tables packs it: eight
// 8-byte words.
struct Leaf {
  const void* in[3];  // update: x, y, nu       tracking: y, g_new, g_old
  void* out[2];       // update: x', nu'        tracking: y', g_kept (NULL ungated)
  long long d;        // elements of one (s, c) row
  long long first;    // the leaf's first block in the launch
  long long vec;      // 1: float4 loads and stores
};

struct LeafTable {
  Leaf leaf[kMaxLeaves];
  int n;  // leaves in use
};

static_assert(sizeof(Leaf) == 64, "kernel.py packs eight int64 words a leaf");
static_assert(sizeof(LeafTable) + 64 <= 4096,
              "the table and the other parameters must fit in 4 KB");

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

// A block's place in a grouped launch: its leaf, (s, c) row and tile.
struct Place {
  int leaf;
  long long row;
  long long off;  // element offset of the tile in the leaf's operands
  int n;          // elements of the tile, <= kTile
};

__device__ __forceinline__ Place place_of(const LeafTable& t) {
  const long long b = blockIdx.x;
  int l = 0;
  while (l + 1 < t.n && b >= t.leaf[l + 1].first) ++l;
  const long long d = t.leaf[l].d;
  // the host keeps every launch under 2^31 blocks, so 32-bit division
  const unsigned tiles = static_cast<unsigned>((d + kTile - 1) / kTile);
  const unsigned local = static_cast<unsigned>(b - t.leaf[l].first);
  const unsigned row = local / tiles;
  const long long start = static_cast<long long>(local - row * tiles) * kTile;
  const long long left = d - start;
  Place p;
  p.leaf = l;
  p.row = row;
  p.off = static_cast<long long>(row) * d + start;
  p.n = static_cast<int>(left < kTile ? left : kTile);
  return p;
}

template <typename T, int K, bool GATED>
__global__ void __launch_bounds__(kThreads)
fused_update_kernel(const __grid_constant__ LeafTable t,
                    const float* __restrict__ params,
                    const float* __restrict__ mask, int C) {
  const Place p = place_of(t);
  const Leaf& L = t.leaf[p.leaf];
  const T* __restrict__ x = static_cast<const T*>(L.in[0]) + p.off;
  const T* __restrict__ y = static_cast<const T*>(L.in[1]) + p.off;
  const T* __restrict__ nu = static_cast<const T*>(L.in[2]) + p.off;
  T* __restrict__ xo = static_cast<T*>(L.out[0]) + p.off;
  T* __restrict__ nuo = static_cast<T*>(L.out[1]) + p.off;
  const bool vec = std::is_same<T, float>::value && L.vec;
  const int i = threadIdx.x;
  if (GATED && !(mask[p.row] > 0.f)) {  // frozen row: copy through
    if (vec) {
      if (i < p.n / 4) {
        reinterpret_cast<float4*>(xo)[i] = reinterpret_cast<const float4*>(x)[i];
        reinterpret_cast<float4*>(nuo)[i] = reinterpret_cast<const float4*>(nu)[i];
      }
    } else {
      for (int j = i; j < p.n; j += kThreads) {
        xo[j] = x[j];
        nuo[j] = nu[j];
      }
    }
    return;
  }
  const UpdateConsts c = load_consts(params + 5 * (p.row / C));
  if (vec) {
    if (i < p.n / 4) {
      const float4 a = reinterpret_cast<const float4*>(x)[i];
      const float4 b = reinterpret_cast<const float4*>(y)[i];
      const float4 n = reinterpret_cast<const float4*>(nu)[i];
      float4 ox, on;
      update_elem<K>(a.x, b.x, n.x, c, ox.x, on.x);
      update_elem<K>(a.y, b.y, n.y, c, ox.y, on.y);
      update_elem<K>(a.z, b.z, n.z, c, ox.z, on.z);
      update_elem<K>(a.w, b.w, n.w, c, ox.w, on.w);
      reinterpret_cast<float4*>(xo)[i] = ox;
      reinterpret_cast<float4*>(nuo)[i] = on;
    }
  } else {
    for (int j = i; j < p.n; j += kThreads) {
      float ox, on;
      update_elem<K>(to_f(x[j]), to_f(y[j]), to_f(nu[j]), c, ox, on);
      xo[j] = from_f<T>(ox);
      nuo[j] = from_f<T>(on);
    }
  }
}

template <typename T, bool GATED>
__global__ void __launch_bounds__(kThreads)
tracking_kernel(const __grid_constant__ LeafTable t,
                const float* __restrict__ params,
                const float* __restrict__ mask, int C) {
  const Place p = place_of(t);
  const Leaf& L = t.leaf[p.leaf];
  const T* __restrict__ y = static_cast<const T*>(L.in[0]) + p.off;
  const T* __restrict__ gn = static_cast<const T*>(L.in[1]) + p.off;
  const T* __restrict__ go = static_cast<const T*>(L.in[2]) + p.off;
  T* __restrict__ yo = static_cast<T*>(L.out[0]) + p.off;
  T* __restrict__ gk = static_cast<T*>(L.out[1]) + p.off;  // gated only
  const bool vec = std::is_same<T, float>::value && L.vec;
  const int i = threadIdx.x;
  if (GATED && !(mask[p.row] > 0.f)) {  // frozen row: y and the old gradient pass through
    if (vec) {
      if (i < p.n / 4) {
        reinterpret_cast<float4*>(yo)[i] = reinterpret_cast<const float4*>(y)[i];
        reinterpret_cast<float4*>(gk)[i] = reinterpret_cast<const float4*>(go)[i];
      }
    } else {
      for (int j = i; j < p.n; j += kThreads) {
        yo[j] = y[j];
        gk[j] = go[j];
      }
    }
    return;
  }
  const float beta = params[5 * (p.row / C) + 4];
  if (vec) {
    if (i < p.n / 4) {
      const float4 a = reinterpret_cast<const float4*>(y)[i];
      const float4 n = reinterpret_cast<const float4*>(gn)[i];
      const float4 o = reinterpret_cast<const float4*>(go)[i];
      float4 r;
      r.x = a.x + beta * (n.x - o.x);
      r.y = a.y + beta * (n.y - o.y);
      r.z = a.z + beta * (n.z - o.z);
      r.w = a.w + beta * (n.w - o.w);
      reinterpret_cast<float4*>(yo)[i] = r;
      if (GATED) reinterpret_cast<float4*>(gk)[i] = n;
    }
  } else {
    for (int j = i; j < p.n; j += kThreads) {
      const T n = gn[j];
      yo[j] = from_f<T>(to_f(y[j]) + beta * (to_f(n) - to_f(go[j])));
      if (GATED) gk[j] = n;
    }
  }
}

// Standalone prox of every leaf of a table (one row a leaf); params is one
// 5-wide row [lam, theta, alpha, gamma, beta] of which lam, theta, alpha
// are read.
template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
prox_kernel(const __grid_constant__ LeafTable t,
            const float* __restrict__ params) {
  const Place p = place_of(t);
  const Leaf& L = t.leaf[p.leaf];
  const T* __restrict__ x = static_cast<const T*>(L.in[0]) + p.off;
  T* __restrict__ out = static_cast<T*>(L.out[0]) + p.off;
  const UpdateConsts c = load_consts(params);
  const int i = threadIdx.x;
  if (std::is_same<T, float>::value && L.vec) {
    if (i < p.n / 4) {
      const float4 a = reinterpret_cast<const float4*>(x)[i];
      reinterpret_cast<float4*>(out)[i] = make_float4(
          prox<K>(a.x, c), prox<K>(a.y, c), prox<K>(a.z, c), prox<K>(a.w, c));
    }
  } else {
    for (int j = i; j < p.n; j += kThreads) out[j] = from_f<T>(prox<K>(to_f(x[j]), c));
  }
}

// The table the host packed (n leaves of eight words) as the kernel's
// by-value parameter; false on an argument no launch can take.
bool table_from(const void* leaves, int n, int C, long long blocks, LeafTable& t) {
  if (!leaves || n < 1 || n > kMaxLeaves || C < 1 || blocks < 1 || blocks > INT_MAX)
    return false;
  std::memcpy(t.leaf, leaves, sizeof(Leaf) * n);
  t.n = n;
  return true;
}

template <typename T, int K, bool GATED>
int launch_update(const LeafTable& t, const void* params, const void* mask,
                  int C, long long blocks, cudaStream_t st) {
  fused_update_kernel<T, K, GATED><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      t, static_cast<const float*>(params), static_cast<const float*>(mask), C);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int K>
int update_gate(const LeafTable& t, const void* params, const void* mask,
                int C, long long blocks, cudaStream_t st) {
  return mask ? launch_update<T, K, true>(t, params, mask, C, blocks, st)
              : launch_update<T, K, false>(t, params, mask, C, blocks, st);
}

template <typename T>
int update_kind(int kind, const LeafTable& t, const void* params,
                const void* mask, int C, long long blocks, cudaStream_t st) {
  switch (kind) {
    case kL1: return update_gate<T, kL1>(t, params, mask, C, blocks, st);
    case kMcp: return update_gate<T, kMcp>(t, params, mask, C, blocks, st);
    case kScad: return update_gate<T, kScad>(t, params, mask, C, blocks, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int tracking_gate(const LeafTable& t, const void* params, const void* mask,
                  int C, long long blocks, cudaStream_t st) {
  const float* p = static_cast<const float*>(params);
  const float* m = static_cast<const float*>(mask);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (mask)
    tracking_kernel<T, true><<<grid, kThreads, 0, st>>>(t, p, m, C);
  else
    tracking_kernel<T, false><<<grid, kThreads, 0, st>>>(t, p, m, C);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int prox_kind(int kind, const LeafTable& t, const void* params,
              long long blocks, cudaStream_t st) {
  const unsigned grid = static_cast<unsigned>(blocks);
  const float* p = static_cast<const float*>(params);
  switch (kind) {
    case kL1: prox_kernel<T, kL1><<<grid, kThreads, 0, st>>>(t, p); break;
    case kMcp: prox_kernel<T, kMcp><<<grid, kThreads, 0, st>>>(t, p); break;
    case kScad: prox_kernel<T, kScad><<<grid, kThreads, 0, st>>>(t, p); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One grouped launch of the fused update over the n leaves at `leaves`
// (n x 64 bytes, struct Leaf), all of one dtype (0 = float32, 1 =
// bfloat16), `blocks` blocks in all.  params: the (S, 5) table; mask: the
// (S, C) gate or NULL (ungated).
int prox_sweep_update_grouped(const void* leaves, int n, const void* params,
                              const void* mask, int C, long long blocks,
                              int kind, int dtype, void* stream) {
  LeafTable t;
  if (!table_from(leaves, n, C, blocks, t)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return update_kind<float>(kind, t, params, mask, C, blocks, st);
  if (dtype == 1) return update_kind<__nv_bfloat16>(kind, t, params, mask, C, blocks, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The same for the tracking axpy; g_kept (out[1]) is written only when
// gated (mask != NULL).
int prox_sweep_tracking_grouped(const void* leaves, int n, const void* params,
                                const void* mask, int C, long long blocks,
                                int dtype, void* stream) {
  LeafTable t;
  if (!table_from(leaves, n, C, blocks, t)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return tracking_gate<float>(t, params, mask, C, blocks, st);
  if (dtype == 1) return tracking_gate<__nv_bfloat16>(t, params, mask, C, blocks, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// One grouped launch of the standalone prox over the n leaves at `leaves`
// (one row each: in[0] is x, out[0] the result), all of one dtype;
// params: one (1, 5) row for the whole call.  The grid is the table's own:
// the last leaf's first block plus its tiles.
int prox_apply_grouped(const void* leaves, int n, const void* params,
                       int kind, int dtype, void* stream) {
  if (!leaves || n < 1 || n > kMaxLeaves) return static_cast<int>(cudaErrorInvalidValue);
  Leaf last;
  std::memcpy(&last, static_cast<const Leaf*>(leaves) + (n - 1), sizeof(Leaf));
  const long long blocks = last.first + (last.d + kTile - 1) / kTile;
  LeafTable t;
  if (!table_from(leaves, n, 1, blocks, t)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return prox_kind<float>(kind, t, params, blocks, st);
  if (dtype == 1) return prox_kind<__nv_bfloat16>(kind, t, params, blocks, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
