// Flash-attention forward for Hopper (sm_90a), bf16 on the tensor cores.
//
// Replaces the Pallas TPU kernel of the JAX reference for bfloat16 inputs:
// src/repro/kernels/flash_attention/kernel.py:34 (_fa_kernel, reached
// through flash_attention).  Blockwise online-softmax attention with GQA
// (query head h reads kv head h / (H / KV); K and V are never repeated), a
// causal mask, and a sliding window that applies only when causal.  fp32
// inputs go to flash_fwd.cu beside this file.  On request it also writes
// each row's logsumexp, which its backward (flash_bwd_sm90.cu) reads.
//
// Layout: q is contiguous (B, Lq, H, D) bfloat16, k (B, Lk, KV, D), v
// (B, Lk, KV, DV) and o (B, Lq, H, DV); D and DV are template parameters:
// D = DV at 64, 80, 96, 128 or 256, and (D 192, DV 128), the query/key and
// value heads of multi-head latent attention (128 + 64 RoPE columns against
// 128).  Rows and columns both index from 0, as in the reference.  Lq and Lk
// are arbitrary: no divisibility rule.
//
// Bound on an H100 SXM: 2 (D + DV) flops per visible (query, key) pair and
// head (Q K^T and P V) against 989 TFLOP/s bf16 on the tensor cores; the bytes
// of q, k, v and o against 3.35 TB/s bound it only at short lengths.
//
// Design.  One CTA per (q tile of 128 rows, head, batch), three
// warpgroups:
//   * warpgroup 0 is the producer: after setmaxnreg drops it to 40
//     registers, one thread issues every load with TMA.  q, k and v are
//     described to TMA as 4-D tensors (D, heads, L, B), so a box
//     {64, 1, rows, 1} is one head's rows of 64 columns (128 bytes, the
//     widest box the 128-byte swizzle allows); a tile of D columns is
//     ceil(D / 64) boxes, the GQA kv head is a coordinate, and rows past Lq
//     or Lk arrive as zeros.  The map's inner dimension is the true D, so at
//     D 80 and 96 the second box starts at column 64 and runs past the end
//     of the row: TMA fills its last 48 or 32 columns with zeros in shared
//     memory and reads nothing past column D from device memory (the
//     transaction count is the whole box, zero fill included, as for the
//     rows past Lq or Lk).  The Q tile is loaded once; K and V tiles go
//     into a ring of kStages shared-memory stages, each with its own "full"
//     mbarrier (transaction bytes) for K and for V, and one "empty"
//     mbarrier on which every consumer thread arrives when its P V product
//     on the stage has retired.
//   * warpgroups 1 and 2 are the consumers (setmaxnreg raises them to 232
//     registers); each owns 64 query rows.  Per K/V tile:
//       S = Q K^T by wgmma m64nBNk16, A = the Q tile and B = the K tile,
//         both from shared memory, K-major, 128-byte swizzle descriptors;
//       the online softmax in registers: the m64nN fp32 accumulator gives
//         each thread two rows (r and r + 8) and 2 of every 8 columns, so a
//         row's max needs two quad shuffles; the sum stays a per-thread
//         partial until the end;
//       P = exp2(S scale log2(e) - m) un-normalised, rounded to bf16 in
//         registers: the accumulator layout of S, 16 columns at a time, is
//         the A-register fragment of the next wgmma;
//       O += P V by wgmma m64nDk16 with A from registers and B = the V tile
//         in shared memory, which is MN-major (D contiguous): the
//         instruction's transpose bit for B, no copy.  At D 80 and 96 that
//         is one m64n80k16 or m64n96k16 over the two boxes, not an n64 and
//         a narrower tail instruction: the leading byte offset is the
//         stride between boxes, as at D 128, and the second 64-column atom
//         of the canonical MN-major 128-byte-swizzled layout gives its
//         first 16 or 32 columns.  Q K^T runs D / 16 k-steps, so neither
//         product reads the zero-filled columns.
//     BN = 128 keys a tile for DV <= 128 and 64 for DV = 256, so S, O and
//     P fit the 232 registers.  At (192, 128) a Q or K tile is three boxes
//     and a V tile two; Q K^T runs 12 k-steps over the three, and the
//     registers are D 128's (O is DV wide).
// Only K tiles that meet the causal / window band are loaded, and only the
// tiles a band edge (or the ragged end of Lk) crosses are masked.  The grid
// is one dimension with the q tile slowest and reversed, so the CTAs with
// the most K tiles (the last q tiles of a causal band) launch first and the
// tail of the grid is short tiles.
//
// Masking keeps the reference's guards in an equivalent form: a masked
// score is -inf, so exp2 gives p = 0 for it exactly; the running max starts
// at -inf, and while it is -inf the rescale factor alpha is 0 and the
// exponent's offset is 0; the denominator is max(l, 1e-30), so a row with
// no visible key comes out 0.  P is rounded to bf16 before P V (the
// reference oracle rounds the normalised probabilities to bf16 there too);
// l sums the unrounded fp32 p.  exp2 of scores pre-scaled by scale log2(e)
// (ex2.approx) stands for exp.
//
// C interface: launches on the given stream, allocates nothing, returns 0,
// a CUDA error code, or 1000 + the CUresult of cuTensorMapEncodeTiled.
// The driver entry point is looked up through the runtime, so the library
// links nothing beyond the runtime.

#include <climits>

#include "sm90_common.cuh"

namespace {

constexpr int kConsumers = 2;                     // consumer warpgroups
constexpr int kThreads = 128 * (1 + kConsumers);  // + the producer
constexpr int kBM = 64 * kConsumers;              // query rows per CTA
constexpr int kStages = 2;                        // K/V ring depth
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

template <int D, int DV>
struct Tile {
  static constexpr int BN = DV <= 128 ? 128 : 64;  // keys per K/V tile
  static constexpr int kBoxes = (D + 63) / 64;     // 64-column swizzle boxes
  static constexpr int kBoxesV = (DV + 63) / 64;   // of a V tile
  // bytes of a tile as TMA writes it: whole boxes, the zero fill past D
  // included (also the transaction count of its loads)
  static constexpr uint32_t kQBytes = kBM * kBoxes * 128;
  static constexpr uint32_t kKBytes = BN * kBoxes * 128;   // one K tile
  static constexpr uint32_t kVBytes = BN * kBoxesV * 128;  // one V tile
  static constexpr uint32_t kOffK = kQBytes;
  static constexpr uint32_t kOffV = kOffK + kStages * kKBytes;
  static constexpr uint32_t kOffBar = kOffV + kStages * kVBytes;
  // full_q, full_k[kStages], full_v[kStages], empty[kStages]
  static constexpr uint32_t kBars = 1 + 3 * kStages;
  // + slack to align the base to the 1024 bytes of a swizzle atom; and at
  // least 116 KB, so that no two CTAs share an SM: setmaxnreg's budget
  // (40 + 2 x 232 registers per thread slot) takes the whole register file
  static constexpr uint32_t kNeed = kOffBar + 8 * kBars + 1024;
  static constexpr uint32_t kSmem = kNeed > 116 * 1024 ? kNeed : 116 * 1024;
};

template <int D, int DV>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                      int Lq, int Lk, int H, int KV, int B, int n_qt,
                      float scale_log2, int causal, int window) {
  using T = Tile<D, DV>;
  constexpr int BN = T::BN;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sK = base + T::kOffK, sV = base + T::kOffV;
  const uint32_t bar_q = base + T::kOffBar;
  auto bar_k = [&](int s) { return bar_q + 8u * (1 + s); };
  auto bar_v = [&](int s) { return bar_q + 8u * (1 + kStages + s); };
  auto bar_e = [&](int s) { return bar_q + 8u * (1 + 2 * kStages + s); };

  // q tile slowest and reversed: the longest causal tiles launch first
  const int bh = blockIdx.x % (B * H);
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x / (B * H));
  const int h = bh % H, b = bh / H;
  const int kvh = h / (H / KV);
  const int q0 = qt * kBM;

  // the K tiles that meet this q tile's causal / window band
  int kt_begin = 0, kt_end = (Lk + BN - 1) / BN;
  if (causal) {
    const int last_row = min(q0 + kBM, Lq) - 1;
    kt_end = min(kt_end, last_row / BN + 1);
    if (window > 0) {
      const int first_key = q0 - window + 1;
      if (first_key > 0) kt_begin = first_key / BN;
    }
  }
  const int n_tiles = max(kt_end - kt_begin, 0);

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_k(s), 1);
      mbar_init(bar_v(s), 1);
      mbar_init(bar_e(s), 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == 0) {
      mbar_expect_tx(bar_q, T::kQBytes);
      for (int x = 0; x < T::kBoxes; ++x)
        tma_load_4d(sQ + x * kBM * 128, &tm_q, bar_q, 64 * x, h, q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        const uint32_t ph = (it / kStages) & 1;
        const int k0 = (kt_begin + it) * BN;
        mbar_wait(bar_e(s), ph ^ 1);  // the stage's last readers are done
        const uint32_t dk = sK + s * T::kKBytes, dv = sV + s * T::kVBytes;
        mbar_expect_tx(bar_k(s), T::kKBytes);
        for (int x = 0; x < T::kBoxes; ++x)
          tma_load_4d(dk + x * BN * 128, &tm_k, bar_k(s), 64 * x, kvh, k0, b);
        mbar_expect_tx(bar_v(s), T::kVBytes);
        for (int x = 0; x < T::kBoxesV; ++x)
          tma_load_4d(dv + x * BN * 128, &tm_v, bar_v(s), 64 * x, kvh, k0, b);
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    constexpr int kS = BN / 2;  // S accumulator floats per thread
    constexpr int kO = DV / 2;  // O accumulator floats per thread
    const int cw = wg - 1;
    const int warp = tid / 32, lane = tid % 32;
    const int row_wg = q0 + 64 * cw;                  // first row of the warpgroup
    const int row0 = row_wg + 16 * warp + lane / 4;   // this thread's rows: row0, row0 + 8
    const int col0 = 2 * (lane % 4);                  // its first column of each 8
    const uint32_t sQw = sQ + cw * 64 * 128;

    float acc[kO];
#pragma unroll
    for (int i = 0; i < kO; ++i) acc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};  // per-thread partial sums, reduced at the end

    mbar_wait(bar_q, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      const uint32_t ph = (it / kStages) & 1;
      const int k0 = (kt_begin + it) * BN;

      // S = Q K^T
      float sc[kS];
      const uint32_t sKs = sK + s * T::kKBytes;
      mbar_wait(bar_k(s), ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;  // bytes into the box row
        mma_ss<BN>(sc, sw128_desc(sQw + (kk / 4) * kBM * 128 + col, 16),
                   sw128_desc(sKs + (kk / 4) * BN * 128 + col, 16), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence<kS>(sc);

      // masks only where a band edge or the end of Lk crosses the tile
      const bool edge =
          k0 + BN > Lk ||
          (causal && (k0 + BN - 1 > row_wg ||
                      (window > 0 && k0 <= row_wg + 63 - window)));
      if (edge) {
#pragma unroll
        for (int i = 0; i < BN / 8; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = row0 + 8 * (e >> 1);
            const int j = k0 + 8 * i + col0 + (e & 1);
            bool ok = j < Lk;
            if (causal) {
              ok = ok && j <= row;
              if (window > 0) ok = ok && j > row - window;
            }
            if (!ok) sc[4 * i + e] = -INFINITY;
          }
        }
      }

      // online softmax: rows row0 (r = 0) and row0 + 8 (r = 1)
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        mx[0] = fmaxf(mx[0], fmaxf(sc[4 * i], sc[4 * i + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
      }
      float mu[2], alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
        mu[r] = mx[r] == -INFINITY ? 0.f : mx[r] * scale_log2;
        alpha[r] = ex2(m[r] * scale_log2 - mu[r]);  // 0 while m is -inf
        m[r] = mx[r];
      }

      // P = exp2(S scale log2(e) - mu), bf16, in the A fragment of P V:
      // k-slice kk (16 keys) is 8-column chunks 2kk and 2kk + 1; register t
      // holds chunk 2kk + t / 2 of row r = t % 2
      uint32_t pa[BN / 16][4];
      float ls[2] = {0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int i = 2 * kk + (t >> 1), r = t & 1;
          const float p0 = ex2(fmaf(sc[4 * i + 2 * r], scale_log2, -mu[r]));
          const float p1 = ex2(fmaf(sc[4 * i + 2 * r + 1], scale_log2, -mu[r]));
          ls[r] += p0 + p1;
          pa[kk][t] = pack_bf16(p0, p1);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + ls[r];
#pragma unroll
      for (int i = 0; i < DV / 8; ++i) {
        acc[4 * i] *= alpha[0];
        acc[4 * i + 1] *= alpha[0];
        acc[4 * i + 2] *= alpha[1];
        acc[4 * i + 3] *= alpha[1];
      }

      // O += P V
      const uint32_t sVs = sV + s * T::kVBytes;
      mbar_wait(bar_v(s), ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        mma_rs<DV>(acc, pa[kk], sw128_desc(sVs + kk * 16 * 128, BN * 128));
      wgmma_commit();
      wgmma_wait_all();
      reg_fence<kO>(acc);
      mbar_arrive(bar_e(s));  // K and V of this stage are free
    }

    // O / max(l, 1e-30), written as bf16 pairs; with lse, each row's
    // logsumexp of its scaled scores (+inf past Lq and where no key is
    // visible), one store a row, over the padded n_qt x kBM rows
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(kFull, l[r], 1);
      l[r] += __shfl_xor_sync(kFull, l[r], 2);
      const int row = row0 + 8 * r;
      if (lse != nullptr && (lane & 3) == 0)
        lse[(static_cast<long long>(b) * H + h) * n_qt * kBM + row] =
            row < Lq && l[r] > 0.f
                ? (m[r] * scale_log2 + log2f(l[r])) * 0.6931471805599453f
                : INFINITY;
      if (row >= Lq) continue;
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
      __nv_bfloat16* orow =
          o + ((static_cast<long long>(b) * Lq + row) * H + h) * DV + col0;
#pragma unroll
      for (int i = 0; i < DV / 8; ++i)
        *reinterpret_cast<uint32_t*>(orow + 8 * i) =
            pack_bf16(acc[4 * i + 2 * r] * inv, acc[4 * i + 2 * r + 1] * inv);
    }
  }
}


template <int D, int DV>
int launch_dv(const void* q, const void* k, const void* v, void* o, float* lse, int B,
              int Lq, int Lk, int H, int KV, float scale, int causal, int window,
              cudaStream_t stream) {
  using T = Tile<D, DV>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap tq, tk, tv;
  int err = make_map(encode, &tq, q, D, H, Lq, B, kBM);
  if (!err) err = make_map(encode, &tk, k, D, KV, Lk, B, T::BN);
  if (!err) err = make_map(encode, &tv, v, DV, KV, Lk, B, T::BN);
  if (err) return err;
  const long long n_qt = (Lq + kBM - 1) / kBM;
  const long long blocks = n_qt * B * H;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_sm90_kernel<D, DV>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(T::kSmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_fwd_sm90_kernel<D, DV><<<static_cast<unsigned>(blocks), kThreads, T::kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, Lq, Lk, H, KV, B,
      static_cast<int>(n_qt), scale * 1.4426950408889634f, causal, window);
  return static_cast<int>(cudaGetLastError());
}

// D = DV, the switch's instantiations
template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
           int Lq, int Lk, int H, int KV, float scale, int causal, int window,
           cudaStream_t stream) {
  return launch_dv<D, D>(q, k, v, o, lse, B, Lq, Lk, H, KV, scale, causal, window, stream);
}

}  // namespace

extern "C" {

// bf16 only.  The wrapper checks shapes, H % KV == 0, contiguity and
// 16-byte alignment of q, k, v (TMA's rule), and passes B, Lq, Lk, H >= 1
// (a tensor map has no empty dimension).  lse is null (no logsumexp) or
// fp32 (B, H, ceil(Lq / 128) * 128), the rows padded to whole q tiles.  DV
// is v's and o's head dim: D, or 128 at D 192.
int flash_fwd_sm90(const void* q, const void* k, const void* v, void* o, float* lse,
                   int B, int Lq, int Lk, int H, int KV, int D, int DV, float scale,
                   int causal, int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (DV != D) {
    if (D == 192 && DV == 128)
      return launch_dv<192, 128>(q, k, v, o, lse, B, Lq, Lk, H, KV, scale, causal, window, st);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (D) {
    case 64: return launch<64>(q, k, v, o, lse, B, Lq, Lk, H, KV, scale, causal, window, st);
    case 80: return launch<80>(q, k, v, o, lse, B, Lq, Lk, H, KV, scale, causal, window, st);
    case 96: return launch<96>(q, k, v, o, lse, B, Lq, Lk, H, KV, scale, causal, window, st);
    case 128: return launch<128>(q, k, v, o, lse, B, Lq, Lk, H, KV, scale, causal, window, st);
    case 256: return launch<256>(q, k, v, o, lse, B, Lq, Lk, H, KV, scale, causal, window, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
