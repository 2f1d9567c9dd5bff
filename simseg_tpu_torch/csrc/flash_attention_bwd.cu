// Bias-free softmax attention, backward, for Hopper (sm_90a): bf16 q, k, v,
// o, g and gradients, float32 scores, probabilities and accumulators.
//
// Replaces the TPU kernel simseg_tpu/ops/flash_attention.py:flash_mha_train's
// backward (_mha_bwd_pallas / _mha_bwd_kernel), and the backward halves of
// flash_mha_rowblock (_rowblock_dq_kernel, _rowblock_dkdv_kernel) and
// flash_mha_stream (_stream_dq_kernel, _stream_dkdv_kernel), whose split
// and delta = rowsum(g * o) this design shares. For each (batch b, head h),
// with q pre-scaled by hd^-1/2, p = softmax(q k^T) and g = dL/do:
//
//   dv = bf16(p)^T g        dp = g v^T
//   ds = bf16(p * (dp - delta))        delta = rowsum(g * o)
//   dq = ds k               dk = ds^T q
//
// on (B, T, H, hd) tensors read in place through their strides.
//
// The TPU design held the whole (T, T) f32 score tile of one (b, h) in
// VMEM (6.7 MB at T = 1297, against 227 KB of shared memory in an H100
// block) and took rowsum(p * dp) from it. This design is FlashAttention-2's
// split, with nothing of size T x T stored anywhere:
//   - a pre-pass computes delta = rowsum(g * o) in f32 from the bf16 output
//     o of the forward, 8 lanes and 16-byte loads per row. rowsum(p * dp)
//     equals it in exact arithmetic; the two differ at bf16 rounding, as o
//     is bf16;
//   - p is recomputed from s as exp(s - lse), with the per-row log-sum-exp
//     that the forward kernel wrote (flash_attention.cu), so no max or sum
//     pass over the keys is needed;
//   - the dq pass: q and g rows resident in shared memory, k/v tiles of 64
//     rows streamed; S = Q K^T and dP = G V^T, ds in registers, dQ += dS K;
//   - the dk/dv pass: k and v rows resident, q and g tiles (with their lse
//     and delta) streamed; S^T = K Q^T and dP^T = V G^T, then
//     dV += P^T G and dK += dS^T Q;
//   - no atomics: every output element is written by one thread, once, so
//     the result does not depend on the order of the blocks;
//   - rows past Tq or Tk are zero-filled by the loads, masked out of p (key
//     columns past Tk) or given lse = +inf (query rows past Tq, so p = 0),
//     and not stored; there is no ceiling on T, and offsets are 64-bit.
//
// What bounds it on this card: 10 B H Tq Tk hd operations on the tensor
// cores (0.42 ms per ViT-B layer at B = 32, T = 1297 at 989 TFLOP/s bf16);
// q/k/v/o/g in and dq/dk/dv out are about a third of that in bytes. The
// two-pass split recomputes S and dP in both passes, 14 B H T^2 hd in all,
// which is its price for writing every output once. What the design does
// about the rest:
//   - every product is a warpgroup wgmma (m64n64k16, bf16 -> f32): each of
//     the CTA's consumer warpgroups (three in the dq pass, two in the dk/dv
//     pass at hd 64) owns 64 resident rows, and they share each streamed
//     tile, which divides the stream's traffic per row as many times;
//   - all tiles sit in shared memory in the 128-byte swizzled layout that
//     wgmma reads without bank conflicts (hd > 64 as hd/64 slabs of 64
//     columns). The score products read both operands from there K-major;
//     the accumulating products take A (bf16 P, dS or their transposes)
//     straight from the registers of the f32 accumulator that produced
//     them, whose layout is wgmma's register A layout, and read B MN-major
//     (wgmma's transpose bit) from the same tile that the score product read
//     K-major. P and dS never touch shared memory;
//   - one producer warp loads every tile with TMA (4-d tensor maps over
//     (hd, H, T, B), so a ragged tile's rows past T come in as zeros, not
//     as the next image's tokens) into a ring of stages that completes on
//     mbarriers, while the consumer warpgroups compute on the stage before;
//     setmaxnreg moves registers from the producer to the consumers. lse and
//     delta rows are not 16-byte aligned at odd T, so the producer warp
//     copies them with plain loads. Two consumer warpgroups take turns at
//     issuing their products (ping-pong), so one computes p and ds while
//     the other's products run;
//   - each CTA accumulates 64 columns of the head dim, so registers do not
//     grow with hd: for hd > 64 the grid has hd / 64 CTAs per row tile, each
//     recomputing S and dP over the full hd.
// What is left: a single recompute of S (dq summed across CTAs in a fixed
// order, so that the result stays deterministic).
//
// The Hopper helpers (warp roles, mbarriers, TMA, wgmma, the tensor-map
// encoder) are shared with the forward kernel in hopper_sm90.cuh. The host
// function encodes the tensor maps per call (libcuda's
// cuTensorMapEncodeTiled, looked up through the runtime, so the build links
// no libcuda), returns the first error as an int (0 = cudaSuccess) and
// allocates nothing: delta's (B, H, Tq) f32 scratch comes from the caller.
// All launches are on the caller's stream.

#include "hopper_sm90.cuh"

namespace {

constexpr int kRows = 64;           // rows per warpgroup and per streamed tile
constexpr int kChunk = 64;          // head-dim columns accumulated per CTA
constexpr int kDeltaThreads = 256;  // 8 lanes per row in the delta pass

// consumer warpgroups per CTA of each pass, as many as shared memory and
// registers allow: the dq pass keeps 96 accumulator registers a thread and
// fits three in 160 registers; the dk/dv pass keeps 128 and spills at three
template <int HD>
struct Warpgroups {
  static constexpr int kDq = HD <= 128 ? 3 : HD <= 192 ? 2 : 1;
  static constexpr int kDkdv = HD <= 192 ? 2 : 1;
};

// The CTA of a pass with WG consumer warpgroups and one producer
// warpgroup, and its shared memory: two resident (WG x 64, HD) tiles, then
// kStages stages of two streamed (64, HD) tiles and (in the dk/dv pass)
// their 64 lse and 64 delta values in a 1024-byte pad that keeps every tile
// 1024-byte aligned, then the mbarriers; 1024 bytes of slack to align the
// base. Tiles are laid out in the 128-byte swizzle (hopper_sm90.cuh).
template <int HD, int WG>
struct Smem : WarpRoles<WG> {
  static constexpr uint32_t kResident = WG * kRows * HD * 2;
  static constexpr uint32_t kTile = kRows * HD * 2;
  static constexpr uint32_t kStage = 2 * kTile + 1024;
  static constexpr uint32_t kRing = 2 * kResident;
  static constexpr int kStages = kRing + 3 * kStage + 7 * 8 + 1024 <= 232448 ? 3 : 2;
  static constexpr uint32_t kBars = kRing + kStages * kStage;
  static constexpr size_t kBytes = kBars + (2 * kStages + 1) * 8 + 1024;
  static_assert(2 * kRows * 4 <= 1024, "lse and delta fit the stage's pad");
  static_assert(kBytes <= 232448, "fits an H100 block");

  uint32_t base;
  __device__ explicit Smem(uint32_t b) : base(b) {}
  __device__ uint32_t stage(int j) const { return base + kRing + (j % kStages) * kStage; }
  __device__ uint32_t full(int j) const { return base + kBars + 8 * (j % kStages); }
  __device__ uint32_t empty(int j) const { return base + kBars + 8 * (kStages + j % kStages); }
  __device__ uint32_t resident() const { return base + kBars + 16 * kStages; }
};

// The producer: the two resident tiles (rows [res0, res0 + kWG x 64)) once,
// then streamed tiles j = 0 .. n - 1 (rows [64 j, 64 j + 64) of T rows) into
// the ring as the consumers free it; with kStats, a whole warp, which also
// copies the tile's 64 lse and delta values (lse = +inf past T) beside
// them, else one thread.
template <int HD, bool kStats, class S>
__device__ void produce(const S& L, unsigned char* gbase, const CUtensorMap* r0,
                        const CUtensorMap* r1, int res0, const CUtensorMap* s0,
                        const CUtensorMap* s1, int n, int T, int h, int b,
                        const float* lse, const float* delta) {
  constexpr int RR = S::kWG * kRows;
  const int lane = threadIdx.x % 32;
  if (lane == 0) {
    mbar_expect(L.resident(), 2 * S::kResident);
    tma_tile<RR, HD>(L.base, r0, h, res0, b, L.resident());
    tma_tile<RR, HD>(L.base + S::kResident, r1, h, res0, b, L.resident());
  }
  for (int j = 0; j < n; ++j) {
    mbar_wait(L.empty(j), ((j / S::kStages) & 1) ^ 1);
    const uint32_t st = L.stage(j);
    if (lane == 0) {
      mbar_expect(L.full(j), 2 * S::kTile);
      tma_tile<kRows, HD>(st, s0, h, j * kRows, b, L.full(j));
      tma_tile<kRows, HD>(st + S::kTile, s1, h, j * kRows, b, L.full(j));
    }
    if constexpr (kStats) {
      float* stats = reinterpret_cast<float*>(gbase + (st + 2 * S::kTile - L.base));
#pragma unroll
      for (int r = lane; r < kRows; r += 32) {
        const int i = j * kRows + r;
        stats[r] = i < T ? lse[i] : INFINITY;
        stats[kRows + r] = i < T ? delta[i] : 0.f;
      }
      mbar_arrive(L.full(j));
    }
  }
}

// The consumer warpgroups of a CTA wait on the same stages, so left alone
// they issue their products at the same moments and compute p and ds while
// the tensor cores idle. Two warpgroups take turns instead (ping-pong): a
// warpgroup waits for its turn (named barrier 1 + wg, at which the other
// arrives), issues one batch of products and passes the turn on, so one
// warpgroup's products run while the other computes. (Three warpgroups in
// strict rotation measured slower than none: they run without turns.)
template <int WG>
__device__ __forceinline__ void turn_wait(int wg) {
  if constexpr (WG == 2) {
    if (wg == 0) asm volatile("bar.sync 1, 256;\n" ::: "memory");
    else asm volatile("bar.sync 2, 256;\n" ::: "memory");
  }
}

template <int WG>
__device__ __forceinline__ void turn_pass(int wg) {
  if constexpr (WG == 2) {
    if (wg == 0) asm volatile("bar.arrive 2, 256;\n" ::: "memory");
    else asm volatile("bar.arrive 1, 256;\n" ::: "memory");
  }
}

// the two score products of a tile: x (64 x 64) = X A^T and y = Y B^T over
// the head dim, X and Y this warpgroup's 64 rows of the resident tiles, A
// and B the streamed ones
template <int HD, int WG>
__device__ __forceinline__ void score_products(float* x, float* y, uint32_t rx, uint32_t ry,
                                               int wg, uint32_t sa, uint32_t sb) {
  constexpr int RR = WG * kRows;
  turn_wait<WG>(wg);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    wgmma_ss(x, kmajor<RR>(rx, wg * kRows, kk), kmajor<kRows>(sa, 0, kk), kk);
    wgmma_ss(y, kmajor<RR>(ry, wg * kRows, kk), kmajor<kRows>(sb, 0, kk), kk);
  }
  wg_commit();
  turn_pass<WG>(wg);
  wg_wait();
  pin<32>(x);
  pin<32>(y);
}

// stores 64 columns of the thread's rows row0 + g and row0 + g + 8 of an
// accumulator as bf16, rows past T skipped
__device__ __forceinline__ void store_rows(bf16* out, const Strides& s, int b, int h,
                                           int row0, int T, int c0, const float* acc,
                                           int g, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= T) continue;
    bf16* p = out + offset(s, b, row, h) + c0;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(p + 8 * i + 2 * t) =
          __floats2bfloat162_rn(acc[4 * i + 2 * r], acc[4 * i + 2 * r + 1]);
  }
}

// ------------------------------------------------------------------ kernels
// delta[(b * H + h) * T + i] = sum_d g[b, i, h, d] o[b, i, h, d] in f32
template <int HD>
__global__ void __launch_bounds__(kDeltaThreads)
    delta_kernel(const bf16* __restrict__ g, const bf16* __restrict__ o,
                 float* __restrict__ delta, int T, int H, long rows, Strides gs,
                 Strides os) {
  const long id = (long)blockIdx.x * kDeltaThreads + threadIdx.x;
  const long row = id / 8 < rows ? id / 8 : rows - 1;  // a ragged last warp repeats a row
  const int sub = threadIdx.x % 8;
  const int i = (int)(row % T);
  const int h = (int)((row / T) % H);
  const int b = (int)(row / ((long)T * H));
  const bf16* gp = g + offset(gs, b, i, h);
  const bf16* op = o + offset(os, b, i, h);
  float acc = 0.f;
#pragma unroll
  for (int c = sub; c < HD / 8; c += 8) {
    const uint4 gv = *reinterpret_cast<const uint4*>(gp + 8 * c);
    const uint4 ov = *reinterpret_cast<const uint4*>(op + 8 * c);
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 x = __bfloat1622float2(g2[e]), y = __bfloat1622float2(o2[e]);
      acc += x.x * y.x + x.y * y.y;
    }
  }
#pragma unroll
  for (int m = 4; m > 0; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (sub == 0 && id / 8 < rows) delta[row] = acc;
}

// dq for one (b, h, kWG x 64 q rows, 64 head-dim columns)
template <int HD>
__global__ void __launch_bounds__(Smem<HD, Warpgroups<HD>::kDq>::kLaunch, 1)
    dq_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
              const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mg,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dq, int Tq, int Tk, Strides dqs) {
  using S = Smem<HD, Warpgroups<HD>::kDq>;
  constexpr int RR = S::kWG * kRows;  // resident rows
  constexpr int NCH = HD / kChunk;
  extern __shared__ unsigned char smem[];
  const S L{aligned_base(smem)};
  const int q0 = (blockIdx.x / NCH) * RR;
  const int c0 = (blockIdx.x % NCH) * kChunk;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long stat0 = ((long)b * gridDim.y + h) * Tq;
  const int nt = (Tk + kRows - 1) / kRows;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) init_barriers(L, false);
  __syncthreads();

  if (wg == S::kWG) {  // the producer warpgroup: one thread loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(S::kProducerRegs));
    if (threadIdx.x % 128 == 0)
      produce<HD, false>(L, nullptr, &mq, &mg, q0, &mk, &mv, nt, Tk, h, b, nullptr, nullptr);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(S::kConsumerRegs));
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    const int gr = lane / 4;  // accumulator row (and row + 8)
    const int t = lane % 4;   // accumulator column pair 2t, 2t + 1
    const int row0 = q0 + wg * kRows + warp * 16;  // this warp's 16 rows
    float lse_r[2], del_r[2];  // rows gr and gr + 8
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + gr + 8 * r;
      lse_r[r] = row < Tq ? lse[stat0 + row] : 0.f;
      del_r[r] = row < Tq ? delta[stat0 + row] : 0.f;
    }
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    if (wg == S::kWG - 1) turn_pass<S::kWG>(wg);  // warpgroup 0 goes first
    mbar_wait(L.resident(), 0);

    for (int j = 0; j < nt; ++j) {
      const int valid = min(kRows, Tk - j * kRows);
      mbar_wait(L.full(j), (j / S::kStages) & 1);
      const uint32_t sK = L.stage(j), sV = sK + S::kTile;

      // S = Q K^T and dP = G V^T: this warpgroup's 64 q rows x 64 keys
      float s[32], dp[32];
      score_products<HD, S::kWG>(s, dp, L.base, L.base + S::kResident, wg, sK, sV);

      // p = exp(s - lse), 0 past Tk; ds = p (dp - delta), packed as A
      uint32_t a[16];
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int c = acc_col(i, t);
        const float l = lse_r[(i >> 1) & 1], d = del_r[(i >> 1) & 1];
        const float p0 = c < valid ? __expf(s[i] - l) : 0.f;
        const float p1 = c + 1 < valid ? __expf(s[i + 1] - l) : 0.f;
        a[i / 2] = pack_bf16(p0 * (dp[i] - d), p1 * (dp[i + 1] - d));
      }

      // dQ += bf16(dS) K[:, c0 : c0 + 64]
      pin<32>(acc);
      pin<16>(a);
      turn_wait<S::kWG>(wg);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc, a + 4 * kk, mnmajor(sK, c0, kk));
      wg_commit();
      turn_pass<S::kWG>(wg);
      wg_wait();
      pin<32>(acc);
      pin<16>(a);
      __syncwarp();
      if (lane == 0) mbar_arrive(L.empty(j));
    }
    store_rows(dq, dqs, b, h, row0, Tq, c0, acc, gr, t);
  }
}

// dk and dv for one (b, h, kWG x 64 key rows, 64 head-dim columns)
template <int HD>
__global__ void __launch_bounds__(Smem<HD, Warpgroups<HD>::kDkdv>::kLaunch, 1)
    dkdv_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mg,
                const float* __restrict__ lse, const float* __restrict__ delta,
                bf16* __restrict__ dk, bf16* __restrict__ dv, int Tq, int Tk,
                Strides dks, Strides dvs) {
  using S = Smem<HD, Warpgroups<HD>::kDkdv>;
  constexpr int RR = S::kWG * kRows;
  constexpr int NCH = HD / kChunk;
  extern __shared__ unsigned char smem[];
  const S L{aligned_base(smem)};
  // generic pointer to the same bytes, for the lse and delta values
  unsigned char* gbase = smem + (L.base - smem_addr(smem));
  const int k0 = (blockIdx.x / NCH) * RR;
  const int c0 = (blockIdx.x % NCH) * kChunk;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long stat0 = ((long)b * gridDim.y + h) * Tq;
  const int nt = (Tq + kRows - 1) / kRows;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) init_barriers(L, true);
  __syncthreads();

  if (wg == S::kWG) {  // the producer warpgroup: one warp loads, three idle
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(S::kProducerRegs));
    if (threadIdx.x % 128 < 32)
      produce<HD, true>(L, gbase, &mk, &mv, k0, &mq, &mg, nt, Tq, h, b, lse + stat0,
                  delta + stat0);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(S::kConsumerRegs));
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    const int gr = lane / 4;
    const int t = lane % 4;
    float adk[32], adv[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) adk[i] = adv[i] = 0.f;
    if (wg == S::kWG - 1) turn_pass<S::kWG>(wg);  // warpgroup 0 goes first
    mbar_wait(L.resident(), 0);

    for (int j = 0; j < nt; ++j) {
      mbar_wait(L.full(j), (j / S::kStages) & 1);
      const uint32_t sQ = L.stage(j), sG = sQ + S::kTile;
      const float* sL = reinterpret_cast<const float*>(gbase + (sQ + 2 * S::kTile - L.base));
      const float* sD = sL + kRows;

      // S^T = K Q^T and dP^T = V G^T: this warpgroup's 64 keys x 64 q rows
      float s[32], dp[32];
      score_products<HD, S::kWG>(s, dp, L.base, L.base + S::kResident, wg, sQ, sG);

      // p^T = exp(s^T - lse), ds^T = p^T (dp^T - delta), packed as A; the q
      // row is the column
      uint32_t ap[16], ad[16];
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int c = acc_col(i, t);
        const float2 l = *reinterpret_cast<const float2*>(sL + c);
        const float2 d = *reinterpret_cast<const float2*>(sD + c);
        const float p0 = __expf(s[i] - l.x), p1 = __expf(s[i + 1] - l.y);
        ap[i / 2] = pack_bf16(p0, p1);
        ad[i / 2] = pack_bf16(p0 * (dp[i] - d.x), p1 * (dp[i + 1] - d.y));
      }

      // dV += bf16(P^T) G[:, c0 : c0 + 64]; dK += bf16(dS^T) Q[:, c0 : c0 + 64]
      pin<32>(adv);
      pin<32>(adk);
      pin<16>(ap);
      pin<16>(ad);
      turn_wait<S::kWG>(wg);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs(adv, ap + 4 * kk, mnmajor(sG, c0, kk));
        wgmma_rs(adk, ad + 4 * kk, mnmajor(sQ, c0, kk));
      }
      wg_commit();
      turn_pass<S::kWG>(wg);
      wg_wait();
      pin<32>(adv);
      pin<32>(adk);
      pin<16>(ap);
      pin<16>(ad);
      __syncwarp();
      if (lane == 0) mbar_arrive(L.empty(j));
    }
    const int row0 = k0 + wg * kRows + warp * 16;
    store_rows(dk, dks, b, h, row0, Tk, c0, adk, gr, t);
    store_rows(dv, dvs, b, h, row0, Tk, c0, adv, gr, t);
  }
}

// ------------------------------------------------------------------- host
struct Args {
  const bf16 *q, *k, *v, *o, *g;
  const float* lse;
  float* delta;
  bf16 *dq, *dk, *dv;
  int B, Tq, Tk, H;
  Strides qs, ks, vs, os, gs, dqs, dks, dvs;
};

template <int HD>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const long rows = (long)a.B * a.H * a.Tq;
  delta_kernel<HD><<<(unsigned)((rows * 8 + kDeltaThreads - 1) / kDeltaThreads),
                     kDeltaThreads, 0, stream>>>(a.g, a.o, a.delta, a.Tq, a.H, rows,
                                                 a.gs, a.os);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  CUtensorMap mq, mk, mv, mg;
  if ((err = tensor_map(&mq, a.q, a.B, a.Tq, a.H, HD, a.qs, kRows)) != cudaSuccess ||
      (err = tensor_map(&mk, a.k, a.B, a.Tk, a.H, HD, a.ks, kRows)) != cudaSuccess ||
      (err = tensor_map(&mv, a.v, a.B, a.Tk, a.H, HD, a.vs, kRows)) != cudaSuccess ||
      (err = tensor_map(&mg, a.g, a.B, a.Tq, a.H, HD, a.gs, kRows)) != cudaSuccess)
    return err;

  using Q = Smem<HD, Warpgroups<HD>::kDq>;
  using K = Smem<HD, Warpgroups<HD>::kDkdv>;
  constexpr int NCH = HD / kChunk;
  constexpr int RQ = Q::kWG * kRows, RK = K::kWG * kRows;  // resident rows
  err = cudaFuncSetAttribute(dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Q::kBytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dkdv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)K::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid_q(((a.Tq + RQ - 1) / RQ) * NCH, a.H, a.B);
  dq_kernel<HD><<<grid_q, Q::kThreads, Q::kBytes, stream>>>(mq, mk, mv, mg, a.lse, a.delta,
                                                            a.dq, a.Tq, a.Tk, a.dqs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_k(((a.Tk + RK - 1) / RK) * NCH, a.H, a.B);
  dkdv_kernel<HD><<<grid_k, K::kThreads, K::kBytes, stream>>>(
      mq, mk, mv, mg, a.lse, a.delta, a.dk, a.dv, a.Tq, a.Tk, a.dks, a.dvs);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o, g: (B, T, H, hd) bf16 inputs (o the forward's output, g =
// dL/do); lse: (B, H, Tq) f32 from the forward; delta: (B, H, Tq) f32
// scratch; dq, dk, dv: (B, T, H, hd) bf16 outputs. strides: 24 element
// strides (batch, token, head) of q, k, v, o, g, dq, dk, dv in turn; the
// head-dim stride is 1, and every row and stride is 16-byte aligned.
extern "C" int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                        const void* o, const void* g, const void* lse,
                                        void* delta, void* dq, void* dk, void* dv,
                                        int B, int Tq, int Tk, int H, int hd,
                                        const long long* strides, void* stream_ptr) {
  if (B < 1 || Tq < 1 || Tk < 1 || H < 1 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  Strides s[8];
  for (int i = 0; i < 8; ++i)
    s[i] = Strides{(long)strides[3 * i], (long)strides[3 * i + 1],
                   (long)strides[3 * i + 2]};
  const Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
               static_cast<const bf16*>(v), static_cast<const bf16*>(o),
               static_cast<const bf16*>(g), static_cast<const float*>(lse),
               static_cast<float*>(delta), static_cast<bf16*>(dq),
               static_cast<bf16*>(dk), static_cast<bf16*>(dv), B, Tq, Tk, H,
               s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7]};
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  switch (hd) {
    case 64: return (int)launch<64>(a, st);
    case 128: return (int)launch<128>(a, st);
    case 192: return (int)launch<192>(a, st);
    case 256: return (int)launch<256>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
