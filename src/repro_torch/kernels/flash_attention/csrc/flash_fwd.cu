// Flash-attention forward for Hopper (sm_90a), fp32 on the CUDA cores.
//
// This kernel serves fp32 inputs only: it is the exact path the fp32
// models rely on (full fp32 FFMA: no TF32, no tensor cores).  bf16 inputs
// go to the tensor-core kernel in flash_fwd_sm90.cu beside this file.
//
// Replaces the Pallas TPU kernel of the JAX reference,
// src/repro/kernels/flash_attention/kernel.py::_fa_kernel (via
// flash_attention): blockwise online-softmax attention, forward only, with
// GQA (query head h reads kv head h / (H / KV), K/V never repeated), a
// causal mask, and a sliding window that applies only when causal.
//
// Layout: q and o are contiguous (B, Lq, H, D), k and v (B, Lk, KV, D), in
// float32; D is a template parameter (64, 128 or 256).  Rows and columns
// both index from 0, as in the reference.  Lq and Lk are arbitrary: the
// ragged tails of the last tiles are zero-filled and masked, with no
// divisibility rule.
//
// What bounds it.  The work is 4 D flops per visible (query, key) pair and
// head (Q K^T and P V), against 67 TFLOP/s fp32 on the CUDA cores (the
// bytes of q, k, v and o against 3.35 TB/s are far less at the served
// shapes).  The products read their operands from shared memory, which
// delivers 128 bytes a clock to an SM: a warp's 128-bit load takes four
// of those clocks (one per quarter-warp, broadcast or not), while the SM
// retires four warp-wide FFMA instructions a clock.  So a thread must do
// 16 FFMA for every 128-bit load to keep the FFMA units fed, which takes
// register micro-tiles about 8 x 8, as in an SGEMM.  The first design
// (one key a lane) did half an FFMA a load.
//
// Design: two register-tiled products a K/V tile.  One CTA of 256 threads
// takes BQ query rows of one (batch, head) and walks the K/V tiles of BK
// keys that meet the causal / window band; tiles wholly outside it are
// skipped (the result is the same function).  Thread (ty, tx), ty =
// tid / 16 and tx = tid % 16, owns R query rows, ty R .. ty R + R - 1.
// BQ = 128, R = 8, BK = 64 at D = 64 and 128; BQ = 64, R = 4, BK = 32 at
// D = 256 (its rows are twice as wide).
//   * S = Q K^T: keys tx + 16 c (c < BK / 16), an R x BK/16 micro-tile of
//     scores in registers (8 x 4 at D = 128), from float4 reads of the Q
//     rows (broadcast within a quarter-warp) and of the K rows (padded to
//     D + 4 floats, so the 8 rows a quarter-warp reads fall in distinct
//     bank groups): 12 loads for 128 FFMA a float4 step at D = 128.
//   * Online softmax on the micro-tile's rows, in base 2 (exp2f, with
//     log2(e) folded into the score scale): the row max and row sum are
//     reduced across the 16 threads of a row group with __shfl_xor_sync
//     (offsets 8 .. 1, inside one half-warp).  Masking follows the
//     reference kernel exactly: masked scores are NEG_INF = -1e30 (never
//     -inf: -inf - -inf is NaN), p = 0 where masked, alpha = 0 while the
//     running max is still NEG_INF, and the denominator is max(l, 1e-30),
//     so a row with no visible key comes out 0.  Only tiles that cross the
//     diagonal, the window's edge or the end of the keys are masked
//     element by element.
//   * O += P V: P is staged key-major in shared memory (rows of BQ + 4
//     floats).  The accumulator is an R-row x D/16-column micro-tile in
//     registers (8 x 8 at D = 128; columns 4 tx + 64 c), fed by float4
//     reads of P (broadcast) and of V: 4 loads for 64 FFMA a key.
//   * Loads: 16-byte cp.async.cg (4-byte cp.async where a pointer is not
//     16-byte aligned), committed in groups.  K is double-buffered: tile
//     t + 1 streams in during all of tile t.  V has one buffer, refilled
//     right after the barrier that ends tile t - 1's P V, so it streams in
//     during tile t's Q K^T and softmax.  Two barriers a tile.  Q is
//     loaded once, with the first K tile.
//   * Shared memory (Q, 2 x K, V, P): 117,760 bytes at D = 64, 199,680 at
//     D = 128, 173,568 at D = 256, set with cudaFuncSetAttribute; one CTA,
//     8 warps, an SM.
//   * Causal balance: the grid is 1-D with the query tile slowest and
//     reversed, so the heaviest (last) query tiles of every head start
//     first.
//
// C interface: launches on the given stream, allocates nothing, returns
// cudaGetLastError() (or the error of setting the shared-memory limit, or
// cudaErrorInvalidValue for a grid that does not fit).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 16;    // threads sharing a row group
constexpr int kPad = 4;       // floats of padding a row of K and of P
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

// query rows a CTA (BQ), rows a thread (R), keys a K/V tile (BK)
template <int D> struct Tiles;
template <> struct Tiles<64> { static constexpr int BQ = 128, R = 8, BK = 64; };
template <> struct Tiles<128> { static constexpr int BQ = 128, R = 8, BK = 64; };
template <> struct Tiles<256> { static constexpr int BQ = 64, R = 4, BK = 32; };

template <int D>
constexpr size_t smem_bytes() {
  using T = Tiles<D>;
  // Q [BQ][D], 2 x K [BK][D + 4], V [BK][D], P [BK][BQ + 4]
  return sizeof(float) * (T::BQ * D + 2 * T::BK * (D + kPad) + T::BK * D +
                          T::BK * (T::BQ + kPad));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Rows [r0, r0 + ROWS) of an operand with row stride rs floats into shared
// rows of STRIDE floats; rows at or past L are zero-filled.
template <int ROWS, int D, int STRIDE>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int r0,
                                          int L, long long rs, bool vec16) {
  constexpr int kChunks = D / 4;
#pragma unroll 4
  for (int idx = threadIdx.x; idx < ROWS * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = (idx % kChunks) * 4;
    const bool ok = r0 + r < L;
    const float* g = ok ? src + static_cast<long long>(r0 + r) * rs + c : src;
    float* s = dst + r * STRIDE + c;
    if (vec16) {
      cp_async16(s, g, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) cp_async4(s + e, ok ? g + e : src, ok);
    }
  }
}

__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = kGroup / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = kGroup / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      int Lq, int Lk, int H, int KV, float scale, int causal,
                      int window, int vec16) {
  constexpr int BQ = Tiles<D>::BQ, R = Tiles<D>::R, BK = Tiles<D>::BK;
  static_assert(BQ / R * kGroup == kThreads, "threads must tile BQ rows");
  static_assert(R % 4 == 0 && BK % kGroup == 0 && D % (4 * kGroup) == 0, "tiles");
  constexpr int kKeys = BK / kGroup;       // keys a thread: tx + 16 c
  constexpr int kCols = D / (4 * kGroup);  // float4 columns: 4 tx + 64 c
  constexpr int KS = D + kPad;             // row stride of K
  constexpr int PS = BQ + kPad;            // row stride of P (key-major)
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // [BQ][D]
  float* ks = qs + BQ * D;                       // 2 x [BK][KS]
  float* vs = ks + 2 * BK * KS;                  // [BK][D]
  float* ps = vs + BK * D;                       // [BK][PS]

  // 1-D grid, query tile slowest and reversed: heaviest tiles first
  const int nq = (Lq + BQ - 1) / BQ;
  const int heads = gridDim.x / nq;    // B * H
  const int qt = nq - 1 - static_cast<int>(blockIdx.x) / heads;
  const int hb = static_cast<int>(blockIdx.x) % heads;
  const int h = hb % H, b = hb / H;
  const int kvh = h / (H / KV);
  const int q0 = qt * BQ;
  const int tid = threadIdx.x;
  const int tx = tid % kGroup, ty = tid / kGroup;
  const float sl2 = scale * kLog2e;    // scores in base 2

  const long long q_rs = static_cast<long long>(H) * D;    // q / o row stride
  const long long kv_rs = static_cast<long long>(KV) * D;  // k / v row stride
  const float* qb = q + static_cast<long long>(b) * Lq * q_rs + static_cast<long long>(h) * D;
  const float* kb = k + static_cast<long long>(b) * Lk * kv_rs + static_cast<long long>(kvh) * D;
  const float* vb = v + static_cast<long long>(b) * Lk * kv_rs + static_cast<long long>(kvh) * D;
  float* ob = o + static_cast<long long>(b) * Lq * q_rs + static_cast<long long>(h) * D;

  // K tiles that meet the band of this query tile
  int kt_begin = 0;
  int kt_end = (Lk + BK - 1) / BK;
  if (causal) {
    const int last_row = min(q0 + BQ, Lq) - 1;
    kt_end = min(kt_end, last_row / BK + 1);        // keys j <= last_row
    if (window > 0) {
      const int first_key = q0 - window + 1;        // first key row q0 sees
      if (first_key > 0) kt_begin = first_key / BK;
    }
  }

  load_rows<BQ, D, D>(qs, qb, q0, Lq, q_rs, vec16);
  if (kt_begin < kt_end) load_rows<BK, D, KS>(ks, kb, kt_begin * BK, Lk, kv_rs, vec16);
  cp_commit();

  float m[R], l[R], acc[R][4 * kCols];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * kCols; ++c) acc[r][c] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    const float* kst = ks + ((kt - kt_begin) & 1) * BK * KS;
    // K of tile kt has landed, and every warp is past tile kt - 1's P V:
    // the V and P buffers are free
    cp_wait<0>();
    __syncthreads();
    load_rows<BK, D, D>(vs, vb, k0, Lk, kv_rs, vec16);
    cp_commit();
    if (kt + 1 < kt_end)
      load_rows<BK, D, KS>(ks + ((kt + 1 - kt_begin) & 1) * BK * KS, kb, k0 + BK, Lk,
                           kv_rs, vec16);
    cp_commit();

    // S = Q K^T on the R x kKeys micro-tile
    float s[R][kKeys];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < kKeys; ++c) s[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; d += 4) {
      float4 a[R], kk[kKeys];
#pragma unroll
      for (int r = 0; r < R; ++r)
        a[r] = *reinterpret_cast<const float4*>(qs + (ty * R + r) * D + d);
#pragma unroll
      for (int c = 0; c < kKeys; ++c)
        kk[c] = *reinterpret_cast<const float4*>(kst + (tx + kGroup * c) * KS + d);
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < kKeys; ++c) {
          s[r][c] += a[r].x * kk[c].x;
          s[r][c] += a[r].y * kk[c].y;
          s[r][c] += a[r].z * kk[c].z;
          s[r][c] += a[r].w * kk[c].w;
        }
    }

    // mask (only tiles that cross the diagonal, the window's edge or the
    // end of the keys), then the online softmax of each row, in base 2
    const bool edge = k0 + BK > Lk ||
                      (causal && (k0 + BK - 1 > q0 ||
                                  (window > 0 && k0 <= q0 + BQ - 1 - window)));
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = q0 + ty * R + r;
      bool valid[kKeys];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < kKeys; ++c) {
        valid[c] = true;
        if (edge) {
          const int j = k0 + tx + kGroup * c;
          valid[c] = j < Lk;
          if (causal) {
            valid[c] = valid[c] && j <= i;
            if (window > 0) valid[c] = valid[c] && j > i - window;
          }
        }
        s[r][c] = valid[c] ? s[r][c] * sl2 : kNegInf;
        mx = fmaxf(mx, s[r][c]);
      }
      const float m_new = fmaxf(m[r], group_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kKeys; ++c) {
        s[r][c] = valid[c] ? exp2f(s[r][c] - m_new) : 0.f;
        sum += s[r][c];
      }
      const float alpha = (m[r] == kNegInf) ? 0.f : exp2f(m[r] - m_new);
      l[r] = alpha * l[r] + group_sum(sum);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * kCols; ++c) acc[r][c] *= alpha;
    }

    // P, key-major
#pragma unroll
    for (int c = 0; c < kKeys; ++c)
#pragma unroll
      for (int g = 0; g < R / 4; ++g)
        *reinterpret_cast<float4*>(ps + (tx + kGroup * c) * PS + ty * R + 4 * g) =
            make_float4(s[4 * g][c], s[4 * g + 1][c], s[4 * g + 2][c], s[4 * g + 3][c]);
    // V of tile kt has landed (K of tile kt + 1 may still be in flight),
    // and P is written
    cp_wait<1>();
    __syncthreads();

    // O += P V on the R x D/16 micro-tile
#pragma unroll 8
    for (int j = 0; j < BK; ++j) {
      float pr[R];
#pragma unroll
      for (int g = 0; g < R / 4; ++g) {
        const float4 p = *reinterpret_cast<const float4*>(ps + j * PS + ty * R + 4 * g);
        pr[4 * g] = p.x;
        pr[4 * g + 1] = p.y;
        pr[4 * g + 2] = p.z;
        pr[4 * g + 3] = p.w;
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float4 vv = *reinterpret_cast<const float4*>(
            vs + j * D + 4 * tx + 4 * kGroup * c);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          acc[r][4 * c + 0] += pr[r] * vv.x;
          acc[r][4 * c + 1] += pr[r] * vv.y;
          acc[r][4 * c + 2] += pr[r] * vv.z;
          acc[r][4 * c + 3] += pr[r] * vv.w;
        }
      }
    }
  }
  cp_wait<0>();  // a tile with no key in its band still loaded Q

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = q0 + ty * R + r;
    if (i >= Lq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    float* orow = ob + static_cast<long long>(i) * q_rs + 4 * tx;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const float4 out = make_float4(acc[r][4 * c] / denom, acc[r][4 * c + 1] / denom,
                                     acc[r][4 * c + 2] / denom, acc[r][4 * c + 3] / denom);
      float* dst = orow + 4 * kGroup * c;
      if (vec16) {
        *reinterpret_cast<float4*>(dst) = out;
      } else {
        dst[0] = out.x;
        dst[1] = out.y;
        dst[2] = out.z;
        dst[3] = out.w;
      }
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Lq, int Lk, int H, int KV, float scale, int causal,
           int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_fp32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int BQ = Tiles<D>::BQ;
  const long long blocks = static_cast<long long>((Lq + BQ - 1) / BQ) * H * B;
  if (blocks < 1 || blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int vec16 = ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) %
                     16) == 0;
  flash_fwd_fp32_kernel<D><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Lq, Lk, H, KV,
      scale, causal, window, vec16);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// float32 only.  The wrapper checks shapes, H % KV == 0, contiguity and
// that B and H fit the grid.
int flash_fwd(const void* q, const void* k, const void* v, void* o, int B,
              int Lq, int Lk, int H, int KV, int D, float scale, int causal,
              int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(q, k, v, o, B, Lq, Lk, H, KV, scale, causal, window, st);
    case 128: return launch<128>(q, k, v, o, B, Lq, Lk, H, KV, scale, causal, window, st);
    case 256: return launch<256>(q, k, v, o, B, Lq, Lk, H, KV, scale, causal, window, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
