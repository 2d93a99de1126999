// Flash-attention backward for Hopper (sm_90a), bf16 on the tensor cores.
//
// Replaces no TPU kernel.  The JAX reference's Pallas kernel
// (src/repro/kernels/flash_attention/kernel.py:34, _fa_kernel) has no
// backward: the reference trains attention through _sdpa, which holds the
// L x L scores in fp32.  This is the gradient of flash_fwd_sm90.cu beside
// it, so that training attends through the kernels with no score matrix in
// device memory.  Same semantics as the forward: GQA (query head h reads kv
// head h / (H / KV)), a causal mask, a sliding window that applies only
// when causal, rows and columns both from 0, any Lq and Lk; a row with no
// visible key has zero gradient.
//
// Layout: q and dQ are contiguous (B, Lq, H, D) bfloat16, o and dO
// (B, Lq, H, DV); k and dK (B, Lk, KV, D), v and dV (B, Lk, KV, DV); D and
// DV are template parameters: D = DV at 64, 80, 96 or 128, and (D 192, DV
// 128), multi-head latent attention's query/key and value heads.
// lse (the forward's row logsumexp of the scaled scores, natural log, +inf
// past Lq and for a row with no visible key) and Delta are fp32 (B, H,
// lq_pad), lq_pad = ceil(Lq / 128) * 128.
//
// Bound on an H100 SXM: 2 (3 D + 2 DV) flops per visible (query, key) pair
// and head (the five products Q K^T, dO V^T, P^T dO, dS^T Q, dS K: 10 D at
// D = DV) against 989
// TFLOP/s bf16 on the tensor cores; the bytes of q, k, v, o, dO and the
// three gradients against 3.35 TB/s bound it only at short lengths.
//
// Design.  Three launches on the stream:
//   1. delta: Delta_i = rowsum(dO_i * O_i) in fp32, one warp a row (0 in
//      the padded rows).
//   2. dkdv: one CTA per (K/V tile of 128 keys, kv head, batch), two
//      warpgroups of 64 keys each.  K and V are loaded once by TMA; the CTA
//      then walks the q tiles of 64 rows that meet its causal / window band,
//      for each of the H / KV query heads of its group, with Q, dO and the
//      rows' lse and Delta arriving by TMA (and a 1-D bulk copy) in a ring
//      of kStages stages.  Per q tile, in registers:
//        S^T = K Q^T and dP^T = V dO^T by wgmma m64n64k16 (both operands
//          K-major in shared memory, 128-byte swizzle), one commit;
//        P^T = exp2(S^T scale log2(e) - lse log2(e)), the normalised
//          probabilities, and dS^T = P^T (dP^T - Delta), fp32, each rounded
//          to bf16 only in the A-register fragments of the next products
//          (the m64nN accumulator layout is the m64k16 A fragment);
//        dV += P^T dO and dK += dS^T Q by wgmma m64nDk16, A from registers,
//          B = the dO or Q tile, MN-major (D contiguous: the transpose bit).
//      dK and dV stay in fp32 registers for the whole walk, so they need no
//      atomics and K and V are read once; dK is scaled once at the end.
//   3. dq: one CTA per (q tile of 128 rows, head, batch), two warpgroups of
//      64 rows; Q and dO are loaded once, K and V tiles of 64 keys stream
//      through the ring; per tile S = Q K^T and dP = dO V^T (m64n64k16),
//      dS = P (dP - Delta), then dQ += dS K (m64nDk16, A from registers, B
//      the K tile MN-major).  dQ stays in fp32 registers and is written
//      once, scaled, as bf16.  This recomputes S and dP, two products more
//      than one kernel with dQ summed across CTAs by atomics would make; in
//      return dQ is summed in a fixed order (the gradients are
//      deterministic) and every product has the shape the forward already
//      uses.
//   At (192, 128) dkdv walks q tiles of 32 rows (S^T and dP^T by m64n32k16,
//   dK += dS^T Q by m64n192k16), so that dK (96 floats a thread), dV (64),
//   S^T, dP^T and their fragments fit 255 registers; dq keeps its tiles
//   and runs dQ += dS K by m64n192k16.
// Both main kernels are 256 threads with no producer warpgroup: thread 0
// issues the TMA loads, refilling a stage once every thread has arrived on
// its "empty" mbarrier, so each thread may hold up to 255 registers.  Only
// tiles that meet the band are visited, and only tiles that a band edge or
// the ragged end of Lk crosses are masked (a masked score is -inf, so its
// p is 0 exactly).  The dkdv grid walks key tiles in order (the first key
// tiles of a causal band see the most query rows: they launch first); the
// dq grid walks q tiles in reverse, as the forward does.
//
// Arithmetic: fp32 accumulators throughout; P and dS are rounded to bf16
// only as wgmma operands.  exp2 of scores pre-scaled by scale log2(e)
// (ex2.approx) stands for exp, as in the forward.
//
// C interface: launches on the given stream, allocates nothing, returns 0,
// a CUDA error code, or 1000 + the CUresult of cuTensorMapEncodeTiled.

#include <climits>

#include "sm90_common.cuh"

namespace {

constexpr int kThreads = 256;  // two consumer warpgroups
constexpr int kStages = 2;     // ring depth
constexpr float kLog2e = 1.4426950408889634f;

// dkdv: 128 keys a CTA, 64 query rows a step (32 at D 192)
template <int D, int DV>
struct DkdvTile {
  static constexpr int KN = 128;
  static constexpr int QM = D <= 128 ? 64 : 32;
  static constexpr int kBoxes = (D + 63) / 64;
  static constexpr int kBoxesV = (DV + 63) / 64;
  static constexpr uint32_t kKBytes = KN * kBoxes * 128;    // the K tile
  static constexpr uint32_t kVBytes = KN * kBoxesV * 128;   // the V tile
  static constexpr uint32_t kQBytes = QM * kBoxes * 128;    // a Q stage
  static constexpr uint32_t kDOBytes = QM * kBoxesV * 128;  // a dO stage
  static constexpr uint32_t kRowBytes = QM * 4;             // lse or Delta rows
  static constexpr uint32_t kOffV = kKBytes;
  static constexpr uint32_t kOffQ = kOffV + kVBytes;
  static constexpr uint32_t kOffDO = kOffQ + kStages * kQBytes;
  static constexpr uint32_t kOffRows = kOffDO + kStages * kDOBytes;  // lse, Delta a stage
  static constexpr uint32_t kOffBar = kOffRows + kStages * 2 * kRowBytes;
  // full_kv, full[kStages], empty[kStages]
  static constexpr uint32_t kSmem = kOffBar + 8 * (1 + 2 * kStages) + 1024;
};

// dq: 128 query rows a CTA, 64 keys a step
template <int D, int DV>
struct DqTile {
  static constexpr int QM = 128;
  static constexpr int KN = 64;
  static constexpr int kBoxes = (D + 63) / 64;
  static constexpr int kBoxesV = (DV + 63) / 64;
  static constexpr uint32_t kQBytes = QM * kBoxes * 128;    // Q
  static constexpr uint32_t kDOBytes = QM * kBoxesV * 128;  // dO
  static constexpr uint32_t kKBytes = KN * kBoxes * 128;    // a K stage
  static constexpr uint32_t kVBytes = KN * kBoxesV * 128;   // a V stage
  static constexpr uint32_t kOffDO = kQBytes;
  static constexpr uint32_t kOffK = kOffDO + kDOBytes;
  static constexpr uint32_t kOffV = kOffK + kStages * kKBytes;
  static constexpr uint32_t kOffBar = kOffV + kStages * kVBytes;
  // full_q, full[kStages], empty[kStages]
  static constexpr uint32_t kSmem = kOffBar + 8 * (1 + 2 * kStages) + 1024;
};

// Delta_i = rowsum(dO_i * O_i), fp32, one warp a row of (B, H, lq_pad);
// 0 for the padded rows.
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const __nv_bfloat16* __restrict__ o,
                       const __nv_bfloat16* __restrict__ dout,
                       float* __restrict__ delta, int Lq, int H, int D,
                       int lq_pad, long long rows) {
  const long long r = static_cast<long long>(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  const int i = static_cast<int>(r % lq_pad);
  const long long bh = r / lq_pad;
  const int h = static_cast<int>(bh % H);
  const long long b = bh / H;
  float acc = 0.f;
  if (i < Lq) {
    const long long off = ((b * Lq + i) * H + h) * D;
    const __nv_bfloat162* orow = reinterpret_cast<const __nv_bfloat162*>(o + off);
    const __nv_bfloat162* drow = reinterpret_cast<const __nv_bfloat162*>(dout + off);
    for (int c = lane; c < D / 2; c += 32) {
      const float2 a = __bfloat1622float2(orow[c]);
      const float2 d = __bfloat1622float2(drow[c]);
      acc = fmaf(a.x, d.x, fmaf(a.y, d.y, acc));
    }
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) acc += __shfl_xor_sync(kFull, acc, m);
  if (lane == 0) delta[r] = acc;
}

template <int D, int DV>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_do,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                      int Lq, int Lk, int H, int KV, int B, int lq_pad, float scale,
                      float scale_log2, int causal, int window) {
  using T = DkdvTile<D, DV>;
  constexpr int KN = T::KN, QM = T::QM;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sK = base, sV = base + T::kOffV;
  auto sQ = [&](int s) { return base + T::kOffQ + s * T::kQBytes; };
  auto sDO = [&](int s) { return base + T::kOffDO + s * T::kDOBytes; };
  auto sRows = [&](int s) { return base + T::kOffRows + s * 2 * T::kRowBytes; };
  const uint32_t bar_kv = base + T::kOffBar;
  auto bar_f = [&](int s) { return bar_kv + 8u * (1 + s); };
  auto bar_e = [&](int s) { return bar_kv + 8u * (1 + kStages + s); };

  const int bk = blockIdx.x % (B * KV);
  const int kt = blockIdx.x / (B * KV);
  const int kvh = bk % KV, b = bk / KV;
  const int G = H / KV;
  const int k0 = kt * KN;

  // the q tiles that meet this key tile's causal / window band
  int qt_begin = 0, qt_end = (Lq + QM - 1) / QM;
  if (causal) {
    qt_begin = k0 / QM;
    if (window > 0) {
      const long long last_row = static_cast<long long>(k0) + KN - 1 + window - 1;
      if (last_row / QM + 1 < qt_end) qt_end = static_cast<int>(last_row / QM + 1);
    }
  }
  const int nq = max(qt_end - qt_begin, 0);
  const int n_it = G * nq;

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_f(s), 1);
      mbar_init(bar_e(s), kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // stage it % kStages <- Q, dO, lse and Delta of step it: head g of the
  // group (slowest), q tile qt_begin + it % nq.  The lambda holds the
  // maps' addresses in parameter space, never a copy.
  const CUtensorMap* const map_q = &tm_q;
  const CUtensorMap* const map_do = &tm_do;
  auto issue = [&](int it) {
    const int s = it % kStages;
    const int h = kvh * G + it / nq;
    const int q0 = (qt_begin + it % nq) * QM;
    mbar_expect_tx(bar_f(s), T::kQBytes + T::kDOBytes + 2 * T::kRowBytes);
    for (int x = 0; x < T::kBoxes; ++x)
      tma_load_4d(sQ(s) + x * QM * 128, map_q, bar_f(s), 64 * x, h, q0, b);
    for (int x = 0; x < T::kBoxesV; ++x)
      tma_load_4d(sDO(s) + x * QM * 128, map_do, bar_f(s), 64 * x, h, q0, b);
    const long long row = (static_cast<long long>(b) * H + h) * lq_pad + q0;
    bulk_load(sRows(s), lse + row, T::kRowBytes, bar_f(s));
    bulk_load(sRows(s) + T::kRowBytes, delta + row, T::kRowBytes, bar_f(s));
  };
  if (threadIdx.x == 0 && n_it > 0) {
    mbar_expect_tx(bar_kv, T::kKBytes + T::kVBytes);
    for (int x = 0; x < T::kBoxes; ++x)
      tma_load_4d(sK + x * KN * 128, &tm_k, bar_kv, 64 * x, kvh, k0, b);
    for (int x = 0; x < T::kBoxesV; ++x)
      tma_load_4d(sV + x * KN * 128, &tm_v, bar_kv, 64 * x, kvh, k0, b);
    for (int it = 0; it < min(kStages, n_it); ++it) issue(it);
  }
  __syncwarp();

  constexpr int kA = D / 2;    // dK accumulator floats per thread
  constexpr int kAV = DV / 2;  // dV accumulator floats per thread
  constexpr int kS = QM / 2;   // S^T or dP^T accumulator floats per thread
  float dk_acc[kA], dv_acc[kAV];
#pragma unroll
  for (int i = 0; i < kA; ++i) dk_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kAV; ++i) dv_acc[i] = 0.f;
  const int key_wg = k0 + 64 * wg;                  // first key of the warpgroup
  const int key0 = key_wg + 16 * warp + lane / 4;   // this thread's keys: key0, key0 + 8
  const int col0 = 2 * (lane % 4);                  // its first q row of each 8
  const uint32_t sKw = sK + wg * 64 * 128, sVw = sV + wg * 64 * 128;
  const float* rows_g = reinterpret_cast<const float*>(smem_raw + (base - raw) + T::kOffRows);

  if (n_it > 0) mbar_wait(bar_kv, 0);
  for (int it = 0; it < n_it; ++it) {
    const int s = it % kStages;
    const uint32_t ph = (it / kStages) & 1;
    const int q0 = (qt_begin + it % nq) * QM;
    const float* lse_s = rows_g + s * 2 * QM;
    const float* delta_s = lse_s + QM;
    mbar_wait(bar_f(s), ph);

    // S^T = K Q^T, dP^T = V dO^T
    float st[kS], dpt[kS];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;  // bytes into the box row
      mma_ss<QM>(st, sw128_desc(sKw + (kk / 4) * KN * 128 + col, 16),
                 sw128_desc(sQ(s) + (kk / 4) * QM * 128 + col, 16), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < DV / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;
      mma_ss<QM>(dpt, sw128_desc(sVw + (kk / 4) * KN * 128 + col, 16),
                 sw128_desc(sDO(s) + (kk / 4) * QM * 128 + col, 16), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence<kS>(st);
    reg_fence<kS>(dpt);

    // masks only where a band edge or the end of Lq or Lk crosses the tile
    const bool edge =
        q0 + QM > Lq || key_wg + 64 > Lk ||
        (causal && (key_wg + 63 > q0 || (window > 0 && q0 + QM - 1 >= key_wg + window)));

    // P^T and dS^T as bf16 A fragments: k-slice kk (16 q rows) is 8-column
    // chunks 2kk and 2kk + 1; register t holds chunk 2kk + t / 2 of key
    // row r = t % 2
    uint32_t pa[QM / 16][4], da[QM / 16][4];
#pragma unroll
    for (int kk = 0; kk < QM / 16; ++kk) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int i = 2 * kk + (t >> 1), r = t & 1;
        float p[2], d[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * i + col0 + e;  // q row within the tile
          float sv = st[4 * i + 2 * r + e];
          if (edge) {
            const int j = key0 + 8 * r, qi = q0 + c;
            bool ok = j < Lk && qi < Lq;
            if (causal) {
              ok = ok && j <= qi;
              if (window > 0) ok = ok && qi < j + window;
            }
            if (!ok) sv = -INFINITY;
          }
          p[e] = ex2(fmaf(sv, scale_log2, -lse_s[c] * kLog2e));
          d[e] = p[e] * (dpt[4 * i + 2 * r + e] - delta_s[c]);
        }
        pa[kk][t] = pack_bf16(p[0], p[1]);
        da[kk][t] = pack_bf16(d[0], d[1]);
      }
    }

    // dV += P^T dO, dK += dS^T Q
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < QM / 16; ++kk)
      mma_rs<DV>(dv_acc, pa[kk], sw128_desc(sDO(s) + kk * 16 * 128, QM * 128));
#pragma unroll
    for (int kk = 0; kk < QM / 16; ++kk)
      mma_rs<D>(dk_acc, da[kk], sw128_desc(sQ(s) + kk * 16 * 128, QM * 128));
    wgmma_commit();
    wgmma_wait_all();
    reg_fence<kAV>(dv_acc);
    reg_fence<kA>(dk_acc);

    mbar_arrive(bar_e(s));  // this stage is free once every thread is here
    if (threadIdx.x == 0 && it + kStages < n_it) {
      mbar_wait(bar_e(s), ph);
      issue(it + kStages);
    }
    __syncwarp();
  }

  // dK (scaled) and dV, bf16 pairs; keys past Lk are not written
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = key0 + 8 * r;
    if (j >= Lk) continue;
    const long long row = (static_cast<long long>(b) * Lk + j) * KV + kvh;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<uint32_t*>(dk + row * D + col0 + 8 * i) =
          pack_bf16(dk_acc[4 * i + 2 * r] * scale, dk_acc[4 * i + 2 * r + 1] * scale);
#pragma unroll
    for (int i = 0; i < DV / 8; ++i)
      *reinterpret_cast<uint32_t*>(dv + row * DV + col0 + 8 * i) =
          pack_bf16(dv_acc[4 * i + 2 * r], dv_acc[4 * i + 2 * r + 1]);
  }
}

template <int D, int DV>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int Lq, int Lk, int H, int KV,
                    int B, int n_qt, float scale, float scale_log2, int causal,
                    int window) {
  using T = DqTile<D, DV>;
  constexpr int QM = T::QM, KN = T::KN;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sDO = base + T::kOffDO;
  auto sK = [&](int s) { return base + T::kOffK + s * T::kKBytes; };
  auto sV = [&](int s) { return base + T::kOffV + s * T::kVBytes; };
  const uint32_t bar_q = base + T::kOffBar;
  auto bar_f = [&](int s) { return bar_q + 8u * (1 + s); };
  auto bar_e = [&](int s) { return bar_q + 8u * (1 + kStages + s); };

  // q tile slowest and reversed: the longest causal tiles launch first
  const int bh = blockIdx.x % (B * H);
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x / (B * H));
  const int h = bh % H, b = bh / H;
  const int kvh = h / (H / KV);
  const int q0 = qt * QM;

  // the K tiles that meet this q tile's causal / window band
  int kt_begin = 0, kt_end = (Lk + KN - 1) / KN;
  if (causal) {
    const int last_row = min(q0 + QM, Lq) - 1;
    kt_end = min(kt_end, last_row / KN + 1);
    if (window > 0) {
      const int first_key = q0 - window + 1;
      if (first_key > 0) kt_begin = first_key / KN;
    }
  }
  const int n_tiles = max(kt_end - kt_begin, 0);

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_f(s), 1);
      mbar_init(bar_e(s), kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const CUtensorMap* const map_k = &tm_k;
  const CUtensorMap* const map_v = &tm_v;
  auto issue = [&](int it) {
    const int s = it % kStages;
    const int k0 = (kt_begin + it) * KN;
    mbar_expect_tx(bar_f(s), T::kKBytes + T::kVBytes);
    for (int x = 0; x < T::kBoxes; ++x)
      tma_load_4d(sK(s) + x * KN * 128, map_k, bar_f(s), 64 * x, kvh, k0, b);
    for (int x = 0; x < T::kBoxesV; ++x)
      tma_load_4d(sV(s) + x * KN * 128, map_v, bar_f(s), 64 * x, kvh, k0, b);
  };
  if (threadIdx.x == 0 && n_tiles > 0) {
    mbar_expect_tx(bar_q, T::kQBytes + T::kDOBytes);
    for (int x = 0; x < T::kBoxes; ++x)
      tma_load_4d(sQ + x * QM * 128, &tm_q, bar_q, 64 * x, h, q0, b);
    for (int x = 0; x < T::kBoxesV; ++x)
      tma_load_4d(sDO + x * QM * 128, &tm_do, bar_q, 64 * x, h, q0, b);
    for (int it = 0; it < min(kStages, n_tiles); ++it) issue(it);
  }
  __syncwarp();

  constexpr int kA = D / 2;   // dQ accumulator floats per thread
  constexpr int kS = KN / 2;  // S or dP accumulator floats per thread
  const int row_wg = q0 + 64 * wg;                  // first row of the warpgroup
  const int row0 = row_wg + 16 * warp + lane / 4;   // this thread's rows: row0, row0 + 8
  const int col0 = 2 * (lane % 4);                  // its first key of each 8
  const uint32_t sQw = sQ + wg * 64 * 128, sDOw = sDO + wg * 64 * 128;
  float lse2[2], dlt[2];  // lse log2(e) and Delta of the two rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long at = (static_cast<long long>(b) * H + h) * n_qt * QM + row0 + 8 * r;
    lse2[r] = lse[at] * kLog2e;
    dlt[r] = delta[at];
  }
  float dq_acc[kA];
#pragma unroll
  for (int i = 0; i < kA; ++i) dq_acc[i] = 0.f;

  if (n_tiles > 0) mbar_wait(bar_q, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    const uint32_t ph = (it / kStages) & 1;
    const int k0 = (kt_begin + it) * KN;
    mbar_wait(bar_f(s), ph);

    // S = Q K^T, dP = dO V^T
    float sc[kS], dp[kS];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;
      mma_ss<KN>(sc, sw128_desc(sQw + (kk / 4) * QM * 128 + col, 16),
                 sw128_desc(sK(s) + (kk / 4) * KN * 128 + col, 16), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < DV / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;
      mma_ss<KN>(dp, sw128_desc(sDOw + (kk / 4) * QM * 128 + col, 16),
                 sw128_desc(sV(s) + (kk / 4) * KN * 128 + col, 16), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence<kS>(sc);
    reg_fence<kS>(dp);

    const bool edge =
        k0 + KN > Lk ||
        (causal && (k0 + KN - 1 > row_wg || (window > 0 && k0 <= row_wg + 63 - window)));

    // dS as bf16 A fragments (k-slices of 16 keys)
    uint32_t da[KN / 16][4];
#pragma unroll
    for (int kk = 0; kk < KN / 16; ++kk) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int i = 2 * kk + (t >> 1), r = t & 1;
        float d[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float sv = sc[4 * i + 2 * r + e];
          if (edge) {
            const int row = row0 + 8 * r, j = k0 + 8 * i + col0 + e;
            bool ok = j < Lk;
            if (causal) {
              ok = ok && j <= row;
              if (window > 0) ok = ok && j > row - window;
            }
            if (!ok) sv = -INFINITY;
          }
          const float p = ex2(fmaf(sv, scale_log2, -lse2[r]));
          d[e] = p * (dp[4 * i + 2 * r + e] - dlt[r]);
        }
        da[kk][t] = pack_bf16(d[0], d[1]);
      }
    }

    // dQ += dS K
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KN / 16; ++kk)
      mma_rs<D>(dq_acc, da[kk], sw128_desc(sK(s) + kk * 16 * 128, KN * 128));
    wgmma_commit();
    wgmma_wait_all();
    reg_fence<kA>(dq_acc);

    mbar_arrive(bar_e(s));
    if (threadIdx.x == 0 && it + kStages < n_tiles) {
      mbar_wait(bar_e(s), ph);
      issue(it + kStages);
    }
    __syncwarp();
  }

  // dQ (scaled), bf16 pairs
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= Lq) continue;
    __nv_bfloat16* qrow = dq + ((static_cast<long long>(b) * Lq + row) * H + h) * D + col0;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<uint32_t*>(qrow + 8 * i) =
          pack_bf16(dq_acc[4 * i + 2 * r] * scale, dq_acc[4 * i + 2 * r + 1] * scale);
  }
}

template <int D, int DV>
int launch_dv(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const float* lse, float* delta, void* dq, void* dk,
              void* dv, int B, int Lq, int Lk, int H, int KV, float scale, int causal,
              int window, cudaStream_t stream) {
  using A = DkdvTile<D, DV>;
  using Q = DqTile<D, DV>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const long long n_qt = (Lq + Q::QM - 1) / Q::QM;
  const long long lq_pad = n_qt * Q::QM;
  const long long n_kt = (Lk + A::KN - 1) / A::KN;
  const long long rows = static_cast<long long>(B) * H * lq_pad;
  const long long delta_blocks = (rows + 7) / 8;
  const long long dkdv_blocks = n_kt * B * KV;
  const long long dq_blocks = n_qt * B * H;
  if (delta_blocks > INT_MAX || dkdv_blocks > INT_MAX || dq_blocks > INT_MAX ||
      lq_pad > INT_MAX)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const float scale_log2 = scale * kLog2e;

  flash_bwd_delta_kernel<<<static_cast<unsigned>(delta_blocks), 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout),
      delta, Lq, H, DV, static_cast<int>(lq_pad), rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  CUtensorMap tq, tk, tv, tdo;
  int err = make_map(encode, &tq, q, D, H, Lq, B, A::QM);
  if (!err) err = make_map(encode, &tdo, dout, DV, H, Lq, B, A::QM);
  if (!err) err = make_map(encode, &tk, k, D, KV, Lk, B, A::KN);
  if (!err) err = make_map(encode, &tv, v, DV, KV, Lk, B, A::KN);
  if (err) return err;
  e = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<D, DV>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(A::kSmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dkdv_kernel<D, DV><<<static_cast<unsigned>(dkdv_blocks), kThreads, A::kSmem, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), Lq, Lk, H, KV, B, static_cast<int>(lq_pad), scale,
      scale_log2, causal, window);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  err = make_map(encode, &tq, q, D, H, Lq, B, Q::QM);
  if (!err) err = make_map(encode, &tdo, dout, DV, H, Lq, B, Q::QM);
  if (!err) err = make_map(encode, &tk, k, D, KV, Lk, B, Q::KN);
  if (!err) err = make_map(encode, &tv, v, DV, KV, Lk, B, Q::KN);
  if (err) return err;
  e = cudaFuncSetAttribute(flash_bwd_dq_kernel<D, DV>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(Q::kSmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dq_kernel<D, DV><<<static_cast<unsigned>(dq_blocks), kThreads, Q::kSmem, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<__nv_bfloat16*>(dq), Lq, Lk, H, KV, B,
      static_cast<int>(n_qt), scale, scale_log2, causal, window);
  return static_cast<int>(cudaGetLastError());
}

// D = DV, the switch's instantiations
template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq, void* dk,
           void* dv, int B, int Lq, int Lk, int H, int KV, float scale, int causal,
           int window, cudaStream_t stream) {
  return launch_dv<D, D>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Lq, Lk, H, KV,
                         scale, causal, window, stream);
}

}  // namespace

extern "C" {

// bf16 only.  The wrapper checks shapes, H % KV == 0, contiguity and
// 16-byte alignment of q, k, v, dout, lse and delta (TMA's rule), passes B,
// Lq, Lk, H >= 1 (a tensor map has no empty dimension), and allocates dq,
// dk, dv and the Delta scratch (B, H, lq_pad).  DV is v's, o's and dO's
// head dim: D, or 128 at D 192.
int flash_bwd_sm90(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, float* delta, void* dq,
                   void* dk, void* dv, int B, int Lq, int Lk, int H, int KV, int D,
                   int DV, float scale, int causal, int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (DV != D) {
    if (D == 192 && DV == 128)
      return launch_dv<192, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Lq, Lk, H,
                                 KV, scale, causal, window, st);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (D) {
    case 64: return launch<64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Lq, Lk, H, KV, scale, causal, window, st);
    case 80: return launch<80>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Lq, Lk, H, KV, scale, causal, window, st);
    case 96: return launch<96>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Lq, Lk, H, KV, scale, causal, window, st);
    case 128: return launch<128>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Lq, Lk, H, KV, scale, causal, window, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
