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
// tiles_l = ceil(d_l / kTile), where kTile is the storage type's (struct
// Walk): 1,024 elements in fp32, 256 x 8 x 2 = 4,096 in bf16.  A block finds its leaf by a binary search of the table's
// prefixes (<= 48 entries, six steps, read from the parameter space), then
// its (s, c) row and its tile of that row; it reads the row's
// hyperparameters from the (S, 5) table [lam, theta, alpha, gamma, beta]
// and its cohort-gate value from the (S, C) mask once, into registers.  A
// frozen row (mask <= 0) is copied through unchanged, bit for bit, without
// reading the operands it does not need.
//
// The walk of a tile.  Each thread holds kUnroll slots of 16 bytes of each
// operand (struct Pack: 4 fp32 or 8 bf16 elements) and issues all of its
// tile's loads before any arithmetic, so a thread keeps 3 x kUnroll x 16
// bytes in flight.  Where the leaf's vec flag says so (d a multiple of the
// slot's elements and all five pointers 16-byte aligned; the host decides,
// kernel.py's leaf_tables) a slot is one 16-byte load or store; otherwise
// (a ragged d, a misaligned view) a slot's elements are loaded and stored
// one by one at a stride of kThreads, masked at the tile's end.  Both
// routes cover the tile once, coalesced, and compute alike.  The standalone
// prox and the one-config update walk the same table with one row a leaf
// (a whole leaf of any shape is one row of d elements) and one (1, 5)
// parameter row for the whole call; the prox reads in[0] and writes out[0]
// only.
//
// The paper's MLP step (six fp32 leaves of 7,872 / 64 / 2,048 / 32 / 320 /
// 10 elements a client, 10 clients) is 14 tiles a row x 10 rows = 140
// blocks, about one wave on 132 SMs: fp32 keeps its 1,024-element tile so
// that this step still fills the card.  The full-width training step
// (Qwen3-1.7B, 311 bf16 leaves x 2 clients, 4.065e9 elements) is 992,482
// blocks at the 4,096-element bf16 tile.  The host packs the table into a
// reused buffer and makes one ctypes call per launch: nothing is read back
// from the device and nothing is allocated here, so the launches can be
// captured in a CUDA graph.
//
// Bound on an H100 (3.35 TB/s HBM3): the kernels are pure streams with ~10
// flops per element, far below the 67 TFLOP/s fp32 rate, so bytes bound
// them.  The update moves 5 elements of storage per element (read x, y,
// nu; write x', nu'), tracking 4 (5 gated: g_kept is written too); a
// frozen row moves 4 in both (x, nu or y, g_old read and copied).  By
// Little's law 3.35 TB/s x ~0.7 us of DRAM latency needs ~18 KB in flight
// an SM: at 2 bf16 slots a thread (55-64 registers: four 256-thread blocks
// an SM) an SM keeps 1,024 x 3 x 2 x 16 B = 96 KB in flight.  At the main
// path's shapes (10 clients x 10,346 parameters) the byte bound is 0.6 us a
// step for the update and 0.5 us for tracking, below one launch's latency:
// the number of launches and the host's work around each, not bytes, set
// the time there, hence one launch for all leaves of a step.
//
// Streaming cache hints (__ldcs / __stcs, ld.global.nc.L1::no_allocate)
// and a __launch_bounds__ minimum of blocks an SM were timed on the card
// at the training step and did not help these pure streams, so neither
// is kept.
//
// Arithmetic is fp32 whatever the storage type (fp32 or bf16), one rounding
// per operation in the same order as the plain PyTorch version
// (kernel.py), and one __float2bfloat16_rn for each stored bf16 result; a
// bf16 element is widened to fp32 exactly (a 16-bit shift).  The build
// passes -fmad=false so nvcc does not contract multiply-add pairs, and no
// --use_fast_math (it would change division and flush denormals).  The prox
// kind and the gate are template parameters; hyperparameters are runtime
// values, so new values never rebuild.
//
// prox_sweep_tile() reports the tile of each storage type, and the host
// checks it against its own.
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
constexpr int kMaxLeaves = 48;       // leaves in one launch's table

// The walk of one storage type: kUnroll slots of kVec elements (16 bytes)
// a thread, kTile elements of one row a block.  fp32 keeps one slot (the
// MLP step's tiles fill the card); bf16 takes two.
template <typename T> struct Walk;
template <> struct Walk<float> {
  static constexpr int kVec = 4, kUnroll = 1;
  static constexpr int kTile = kThreads * kVec * kUnroll;
};
template <> struct Walk<__nv_bfloat16> {
  static constexpr int kVec = 8, kUnroll = 2;
  static constexpr int kTile = kThreads * kVec * kUnroll;
};
static_assert(Walk<float>::kTile == 1024, "kernel.py's TILES[float32]");
static_assert(Walk<__nv_bfloat16>::kTile == 4096, "kernel.py's TILES[bfloat16]");

enum Kind { kL1 = 0, kMcp = 1, kScad = 2 };

// One leaf of a grouped launch, as kernel.py's leaf_tables packs it: eight
// 8-byte words.
struct Leaf {
  const void* in[3];  // update: x, y, nu       tracking: y, g_new, g_old
  void* out[2];       // update: x', nu'        tracking: y', g_kept (NULL ungated)
  long long d;        // elements of one (s, c) row
  long long first;    // the leaf's first block in the launch
  long long vec;      // 1: 16-byte loads and stores
};

struct LeafTable {
  Leaf leaf[kMaxLeaves];
  int n;  // leaves in use
};

static_assert(sizeof(Leaf) == 64, "kernel.py packs eight int64 words a leaf");
static_assert(sizeof(LeafTable) + 64 <= 4096,
              "the table and the other parameters must fit in 4 KB");

// 16 bytes of storage in registers: kVec elements read and written as
// fp32, or copied as raw bits.
template <typename T> struct Pack;
template <> struct Pack<float> {
  unsigned w[4];
  __device__ __forceinline__ float get(int e) const { return __uint_as_float(w[e]); }
  __device__ __forceinline__ void set(int e, float v) { w[e] = __float_as_uint(v); }
  __device__ __forceinline__ unsigned bits(int e) const { return w[e]; }
  __device__ __forceinline__ void set_bits(int e, unsigned b) { w[e] = b; }
};
template <> struct Pack<__nv_bfloat16> {
  unsigned w[4];  // element 2k in the low half of w[k], as in memory
  __device__ __forceinline__ float get(int e) const {  // exact: a shift
    const unsigned v = w[e >> 1];
    return __uint_as_float((e & 1) ? (v & 0xffff0000u) : (v << 16));
  }
  __device__ __forceinline__ unsigned bits(int e) const {
    return (e & 1) ? (w[e >> 1] >> 16) : (w[e >> 1] & 0xffffu);
  }
  __device__ __forceinline__ void set_bits(int e, unsigned b) {
    unsigned& v = w[e >> 1];
    v = (e & 1) ? ((v & 0xffffu) | (b << 16)) : ((v & 0xffff0000u) | b);
  }
  __device__ __forceinline__ void set(int e, float v) {
    set_bits(e, __bfloat16_as_ushort(__float2bfloat16_rn(v)));
  }
};

// an element of T as raw bits, for the scalar route
template <typename T> using Bits =
    typename std::conditional<sizeof(T) == 4, unsigned, unsigned short>::type;

// A thread's share of one tile of n elements: slot u, element e is tile
// element (i + u kThreads) kVec + e on the vector route, i + (u kVec + e)
// kThreads on the scalar one (i = threadIdx.x).
template <typename T, bool VEC>
struct Tile {
  static constexpr int N = Walk<T>::kVec, U = Walk<T>::kUnroll;
  int n;

  __device__ __forceinline__ int at(int u, int e) const {
    return VEC ? (threadIdx.x + u * kThreads) * N + e
               : threadIdx.x + (u * N + e) * kThreads;
  }
  // on the vector route n is a multiple of N: a slot is in or out whole
  __device__ __forceinline__ bool has(int u, int e) const {
    return at(u, VEC ? 0 : e) < n;
  }
  __device__ __forceinline__ void load(Pack<T> (&v)[U], const T* src) const {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (VEC) {
        if (has(u, 0)) {
          const uint4 r = *reinterpret_cast<const uint4*>(src + at(u, 0));
          v[u].w[0] = r.x, v[u].w[1] = r.y, v[u].w[2] = r.z, v[u].w[3] = r.w;
        }
      } else {
        v[u] = Pack<T>{};
#pragma unroll
        for (int e = 0; e < N; ++e)
          if (has(u, e)) v[u].set_bits(e, reinterpret_cast<const Bits<T>*>(src)[at(u, e)]);
      }
    }
  }
  __device__ __forceinline__ void store(T* dst, const Pack<T> (&v)[U]) const {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (VEC) {
        if (has(u, 0))
          *reinterpret_cast<uint4*>(dst + at(u, 0)) =
              make_uint4(v[u].w[0], v[u].w[1], v[u].w[2], v[u].w[3]);
      } else {
#pragma unroll
        for (int e = 0; e < N; ++e)
          if (has(u, e))
            reinterpret_cast<Bits<T>*>(dst)[at(u, e)] = static_cast<Bits<T>>(v[u].bits(e));
      }
    }
  }
};

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

// A block's place in a grouped launch: its leaf, (s, c) row and tile.
struct Place {
  int leaf;
  long long row;
  long long off;  // element offset of the tile in the leaf's operands
  int n;          // elements of the tile, <= the tile
};

template <int TILE>
__device__ __forceinline__ Place place_of(const LeafTable& t) {
  const long long b = blockIdx.x;
  int l = 0;  // the last leaf whose first block is <= b (firsts increase)
  for (int hi = t.n - 1; l < hi;) {
    const int mid = (l + hi + 1) >> 1;
    if (b >= t.leaf[mid].first) l = mid; else hi = mid - 1;
  }
  const long long d = t.leaf[l].d;
  // the host keeps every launch under 2^31 blocks, so 32-bit division
  const unsigned tiles = static_cast<unsigned>((d + TILE - 1) / TILE);
  const unsigned local = static_cast<unsigned>(b - t.leaf[l].first);
  const unsigned row = local / tiles;
  const long long start = static_cast<long long>(local - row * tiles) * TILE;
  const long long left = d - start;
  Place p;
  p.leaf = l;
  p.row = row;
  p.off = static_cast<long long>(row) * d + start;
  p.n = static_cast<int>(left < TILE ? left : TILE);
  return p;
}

template <typename T, int K, bool GATED, bool VEC>
__device__ __forceinline__ void update_tile(const Leaf& L, const Place& p,
                                            float live, const float* row) {
  const Tile<T, VEC> w{p.n};
  constexpr int N = Walk<T>::kVec, U = Walk<T>::kUnroll;
  const T* x = static_cast<const T*>(L.in[0]) + p.off;
  const T* y = static_cast<const T*>(L.in[1]) + p.off;
  const T* nu = static_cast<const T*>(L.in[2]) + p.off;
  T* xo = static_cast<T*>(L.out[0]) + p.off;
  T* nuo = static_cast<T*>(L.out[1]) + p.off;
  Pack<T> a[U], b[U], n[U];
  w.load(a, x);   // x and nu first: a frozen row copies them through
  w.load(n, nu);
  if (GATED && !(live > 0.f)) {
    w.store(xo, a);
    w.store(nuo, n);
    return;
  }
  w.load(b, y);
  const UpdateConsts c = load_consts(row);
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int e = 0; e < N; ++e) {
      if (!w.has(u, e)) continue;
      const float nn = c.gamma * n[u].get(e) + c.omg * b[u].get(e);
      a[u].set(e, prox<K>(a[u].get(e) - c.alpha * nn, c));
      n[u].set(e, nn);
    }
  }
  w.store(xo, a);
  w.store(nuo, n);
}

template <typename T, int K, bool GATED>
__global__ void __launch_bounds__(kThreads)
fused_update_kernel(const __grid_constant__ LeafTable t,
                    const float* __restrict__ params,
                    const float* __restrict__ mask, int C) {
  const Place p = place_of<Walk<T>::kTile>(t);
  const Leaf& L = t.leaf[p.leaf];
  const float live = GATED ? mask[p.row] : 1.f;
  const float* row = params + 5 * (p.row / C);
  if (L.vec)
    update_tile<T, K, GATED, true>(L, p, live, row);
  else
    update_tile<T, K, GATED, false>(L, p, live, row);
}

template <typename T, bool GATED, bool VEC>
__device__ __forceinline__ void tracking_tile(const Leaf& L, const Place& p,
                                              float live, const float* row) {
  const Tile<T, VEC> w{p.n};
  constexpr int N = Walk<T>::kVec, U = Walk<T>::kUnroll;
  const T* y = static_cast<const T*>(L.in[0]) + p.off;
  const T* gn = static_cast<const T*>(L.in[1]) + p.off;
  const T* go = static_cast<const T*>(L.in[2]) + p.off;
  T* yo = static_cast<T*>(L.out[0]) + p.off;
  T* gk = static_cast<T*>(L.out[1]) + p.off;  // gated only
  Pack<T> a[U], n[U], o[U];
  w.load(a, y);   // y and the old gradient first: a frozen row keeps them
  w.load(o, go);
  if (GATED && !(live > 0.f)) {
    w.store(yo, a);
    w.store(gk, o);
    return;
  }
  w.load(n, gn);
  const float beta = row[4];
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int e = 0; e < N; ++e)
      if (w.has(u, e)) a[u].set(e, a[u].get(e) + beta * (n[u].get(e) - o[u].get(e)));
  }
  w.store(yo, a);
  if (GATED) w.store(gk, n);
}

template <typename T, bool GATED>
__global__ void __launch_bounds__(kThreads)
tracking_kernel(const __grid_constant__ LeafTable t,
                const float* __restrict__ params,
                const float* __restrict__ mask, int C) {
  const Place p = place_of<Walk<T>::kTile>(t);
  const Leaf& L = t.leaf[p.leaf];
  const float live = GATED ? mask[p.row] : 1.f;
  const float* row = params + 5 * (p.row / C);
  if (L.vec)
    tracking_tile<T, GATED, true>(L, p, live, row);
  else
    tracking_tile<T, GATED, false>(L, p, live, row);
}

template <typename T, int K, bool VEC>
__device__ __forceinline__ void prox_tile(const Leaf& L, const Place& p,
                                          const float* row) {
  const Tile<T, VEC> w{p.n};
  constexpr int N = Walk<T>::kVec, U = Walk<T>::kUnroll;
  Pack<T> a[U];
  w.load(a, static_cast<const T*>(L.in[0]) + p.off);
  const UpdateConsts c = load_consts(row);
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int e = 0; e < N; ++e)
      if (w.has(u, e)) a[u].set(e, prox<K>(a[u].get(e), c));
  }
  w.store(static_cast<T*>(L.out[0]) + p.off, a);
}

// Standalone prox of every leaf of a table (one row a leaf); params is one
// 5-wide row [lam, theta, alpha, gamma, beta] of which lam, theta, alpha
// are read.
template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
prox_kernel(const __grid_constant__ LeafTable t,
            const float* __restrict__ params) {
  const Place p = place_of<Walk<T>::kTile>(t);
  const Leaf& L = t.leaf[p.leaf];
  if (L.vec)
    prox_tile<T, K, true>(L, p, params);
  else
    prox_tile<T, K, false>(L, p, params);
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

// Elements of one row a block takes for a storage type (0 = float32, 1 =
// bfloat16); 0 for another dtype.
int prox_sweep_tile(int dtype) {
  if (dtype == 0) return Walk<float>::kTile;
  if (dtype == 1) return Walk<__nv_bfloat16>::kTile;
  return 0;
}

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
  const long long tile = prox_sweep_tile(dtype);
  if (!leaves || n < 1 || n > kMaxLeaves || tile == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Leaf last;
  std::memcpy(&last, static_cast<const Leaf*>(leaves) + (n - 1), sizeof(Leaf));
  const long long blocks = last.first + (last.d + tile - 1) / tile;
  LeafTable t;
  if (!table_from(leaves, n, 1, blocks, t)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return prox_kind<float>(kind, t, params, blocks, st);
  if (dtype == 1) return prox_kind<__nv_bfloat16>(kind, t, params, blocks, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
