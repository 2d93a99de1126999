// Flash-attention forward for Hopper (sm_90a), fp32 on the CUDA cores.
//
// This kernel serves fp32 inputs only: it is the exact path the fp32
// models rely on.  bf16 inputs go to the tensor-core kernel in
// flash_fwd_sm90.cu beside this file.
//
// Replaces the Pallas TPU kernel of the JAX reference,
// src/repro/kernels/flash_attention/kernel.py::_fa_kernel (via
// flash_attention): blockwise online-softmax attention, forward only, with
// GQA (query head h reads kv head h / (H / KV), K/V never repeated), a
// causal mask, and a sliding window that applies only when causal.
//
// Layout: q and o are contiguous (B, Lq, H, D), k and v (B, Lk, KV, D), in
// float32; D is a template parameter (64, 128 or 256).  Rows
// and columns both index from 0, as in the reference.  Lq and Lk are
// arbitrary: the ragged tails of the last tiles are masked, with no
// divisibility rule.
//
// Design (simple and right first).  One CTA per (q tile of kBQ = 32 rows,
// head, batch) with 8 warps; warp w owns query rows 4w .. 4w+3 of the tile.  The Q tile is loaded once
// into shared memory as fp32; the CTA then walks the K/V tiles of kBK = 32
// keys that intersect the causal / window band (tiles wholly outside it are
// skipped: the result is the same function), loading each into shared
// memory as fp32.  For each of its rows a warp computes the 32 scores of
// the tile with lane j on key j (K rows padded to D + 1 floats, so the
// lanes' reads fall in 32 different banks), masks them, and updates the
// running max m and sum l with warp shuffles; the fp32 accumulator of the
// output row is spread over the lanes (lane holds columns lane + 32c), and
// P V is accumulated by broadcasting each lane's probability with
// __shfl_sync.  The output is written once, after the last tile.
//
// Masking follows the reference kernel exactly: masked scores are
// NEG_INF = -1e30 (never -inf: -inf - -inf is NaN), p = 0 where masked,
// alpha = 0 while the running max is still NEG_INF, and the denominator is
// max(l, 1e-30), so a row with no visible key comes out 0.  expf, not the
// fast-math intrinsics.
//
// Bound on an H100: 4 D flops per visible (query, key) pair and head (QK^T
// and PV) against 67 TFLOP/s fp32 on the CUDA cores, or the bytes of q, k,
// v and o against 3.35 TB/s.  The kernel reads shared memory twice per
// multiply-add in the QK^T loop, so it sits well above that bound.
//
// C interface: launches on the given stream, allocates nothing, returns
// cudaGetLastError() (or the error of setting the shared-memory limit).

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kBQ = kWarps * kRowsPerWarp;  // query rows per CTA
constexpr int kBK = 32;                     // keys per tile: one per lane
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float v) { return v; }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <int D>
constexpr size_t smem_bytes() {
  // Q [kBQ][D], K [kBK][D + 1] (padded), V [kBK][D], all fp32
  return sizeof(float) * (kBQ * D + kBK * (D + 1) + kBK * D);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Lq, int Lk,
                 int H, int KV, float scale, int causal, int window) {
  static_assert(D % 32 == 0, "D must be a multiple of the warp width");
  constexpr int kCols = D / 32;  // output columns per lane
  constexpr int kStride = D + 1;
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kBQ * D;
  float* vs = ks + kBK * kStride;

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  const long long q_rs = static_cast<long long>(H) * D;    // q / o row stride
  const long long kv_rs = static_cast<long long>(KV) * D;  // k / v row stride
  const T* qb = q + static_cast<long long>(b) * Lq * q_rs + static_cast<long long>(h) * D;
  const T* kb = k + static_cast<long long>(b) * Lk * kv_rs + static_cast<long long>(kvh) * D;
  const T* vb = v + static_cast<long long>(b) * Lk * kv_rs + static_cast<long long>(kvh) * D;
  T* ob = o + static_cast<long long>(b) * Lq * q_rs + static_cast<long long>(h) * D;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int i = q0 + r;
    qs[idx] = i < Lq ? to_f(qb[static_cast<long long>(i) * q_rs + c]) : 0.f;
  }

  // K tiles that intersect the band of this q tile
  int kt_begin = 0;
  int kt_end = (Lk + kBK - 1) / kBK;
  if (causal) {
    const int last_row = min(q0 + kBQ, Lq) - 1;
    kt_end = min(kt_end, last_row / kBK + 1);       // keys j <= last_row
    if (window > 0) {
      const int first_key = q0 - window + 1;        // first key row q0 sees
      if (first_key > 0) kt_begin = first_key / kBK;
    }
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kCols];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int r = idx / D, c = idx % D;
      const int j = k0 + r;
      float kk = 0.f, vv = 0.f;
      if (j < Lk) {
        const long long off = static_cast<long long>(j) * kv_rs + c;
        kk = to_f(kb[off]);
        vv = to_f(vb[off]);
      }
      ks[r * kStride + c] = kk;
      vs[r * D + c] = vv;
    }
    __syncthreads();

    // scores of this warp's rows against key j = k0 + lane
    const int j = k0 + lane;
    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
    const float* kr = ks + lane * kStride;
    const float* qw = qs + warp * kRowsPerWarp * D;
#pragma unroll 4
    for (int c = 0; c < D; c += 4) {
      const float k_0 = kr[c], k_1 = kr[c + 1], k_2 = kr[c + 2], k_3 = kr[c + 3];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(qw + r * D + c);
        s[r] += qv.x * k_0;
        s[r] += qv.y * k_1;
        s[r] += qv.z * k_2;
        s[r] += qv.w * k_3;
      }
    }

    float p[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int i = q0 + warp * kRowsPerWarp + r;
      bool valid = j < Lk;
      if (causal) {
        valid = valid && j <= i;
        if (window > 0) valid = valid && j > i - window;
      }
      const float sc = valid ? s[r] * scale : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sc));
      const float pr = valid ? expf(sc - m_new) : 0.f;
      const float alpha = (m[r] == kNegInf) ? 0.f : expf(m[r] - m_new);
      l[r] = alpha * l[r] + warp_sum(pr);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= alpha;
      p[r] = pr;
    }

    // acc += P V: lane's columns lane + 32c, key jj's probability broadcast
#pragma unroll 4
    for (int jj = 0; jj < kBK; ++jj) {
      float pj[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) pj[r] = __shfl_sync(kFull, p[r], jj);
      const float* vr = vs + jj * D + lane;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float vv = vr[32 * c];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) acc[r][c] += pj[r] * vv;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i = q0 + warp * kRowsPerWarp + r;
    if (i >= Lq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    T* orow = ob + static_cast<long long>(i) * q_rs + lane;
#pragma unroll
    for (int c = 0; c < kCols; ++c) orow[32 * c] = from_f<T>(acc[r][c] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Lq, int Lk, int H, int KV, float scale, int causal,
           int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Lq + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Lq, Lk, H, KV, scale,
      causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v, void* o,
             int B, int Lq, int Lk, int H, int KV, float scale, int causal,
             int window, cudaStream_t st) {
  switch (D) {
    case 64: return launch<T, 64>(q, k, v, o, B, Lq, Lk, H, KV, scale, causal, window, st);
    case 128: return launch<T, 128>(q, k, v, o, B, Lq, Lk, H, KV, scale, causal, window, st);
    case 256: return launch<T, 256>(q, k, v, o, B, Lq, Lk, H, KV, scale, causal, window, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// float32 only.  The wrapper checks shapes, H % KV == 0, contiguity and
// that B and H fit the grid.
int flash_fwd(const void* q, const void* k, const void* v, void* o, int B,
              int Lq, int Lk, int H, int KV, int D, float scale, int causal,
              int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return launch_d<float>(D, q, k, v, o, B, Lq, Lk, H, KV, scale, causal, window, st);
}

}  // extern "C"
