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
//     o of the forward, one warp per row. rowsum(p * dp) equals it in exact
//     arithmetic; the two differ at bf16 rounding, as o is bf16;
//   - p is recomputed from s as exp(s - lse), with the per-row log-sum-exp
//     that the forward kernel wrote (flash_attention.cu), so no max or sum
//     pass over the keys is needed;
//   - the dq pass: one CTA of 4 warps per (b, h, 64 q rows); q and g rows
//     resident in shared memory, k/v tiles of 64 rows streamed; each warp
//     owns 16 q rows and keeps S, dP and its dq accumulators in registers;
//   - the dk/dv pass: one CTA per (b, h, 64 key rows); k and v resident, q
//     and g tiles (with their lse and delta) streamed; each warp owns 16 key
//     rows and computes S^T = K Q^T and dP^T = V G^T, so P^T and dS^T come
//     out of the accumulators already in the layout of an mma A operand;
//   - every product is mma.sync m16n8k16 bf16 -> f32; the B operands of the
//     accumulating products (g, q, k read along the key or query axis) are
//     transposed on load by ldmatrix.trans;
//   - each CTA accumulates 64 columns of the head dim, so registers do not
//     grow with hd: for hd > 64 the grid has hd / 64 CTAs per row tile, each
//     recomputing S and dP over the full hd;
//   - no atomics: every output element is written by one thread, once, so
//     the result does not depend on the order of the blocks;
//   - rows past Tq or Tk are bounds-checked (zero-filled in shared memory,
//     masked out of p, not stored); there is no ceiling on T.
// What bounds it on this card: 10 B H Tq Tk hd operations on the tensor
// cores (about 0.21 ms per ViT-B layer at B = 16, T = 1297 at 989 TFLOP/s
// bf16); q/k/v/o/g in and dq/dk/dv out are about a third of that in bytes.
// This version recomputes S in both passes (14 B H T^2 hd in all) and does
// not overlap loads with products; wgmma, TMA and pipelining are later work.
//
// The host function returns the first launch error as an int (0 =
// cudaSuccess) and allocates nothing: delta's (B, H, Tq) f32 scratch comes
// from the caller. All launches are on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;              // rows per resident and per streamed tile
constexpr int kWarps = kRows / 16;     // one warp per 16 resident rows
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;                // bf16 row padding (16 bytes)
constexpr int kChunk = 64;             // head-dim columns accumulated per CTA
constexpr int kDeltaWarps = 8;         // rows per block of the delta pass

template <int HD>
struct Tile {
  static constexpr int kLd = HD + kPad;  // shared-memory row, bf16
  // four (kRows, HD) bf16 tiles, then lse and delta of the streamed tile
  static constexpr size_t kBytes =
      4 * (size_t)kRows * kLd * sizeof(bf16) + 2 * kRows * sizeof(float);
};

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// four 8x8 bf16 matrices, transposed: with lanes 0-15 addressing rows
// r0..r0+15 at column c and lanes 16-31 the same rows at column c + 8, b0/b1
// are the m16n8k16 B fragments of columns c..c+7 and b2/b3 of c+8..c+15,
// for B[k][n] = tile[r0 + k][n]
__device__ __forceinline__ void ldsm_x4_trans(const bf16* p, uint32_t* b) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"((uint32_t)__cvta_generic_to_shared(p)));
}

// the A fragment of rows [row0, row0 + 16) and columns [kk, kk + 16) of a
// shared-memory tile with row length ld
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* tile, int ld,
                                       int kk, int g, int t) {
  a[0] = ld32(tile + g * ld + kk + 2 * t);
  a[1] = ld32(tile + (g + 8) * ld + kk + 2 * t);
  a[2] = ld32(tile + g * ld + kk + 8 + 2 * t);
  a[3] = ld32(tile + (g + 8) * ld + kk + 8 + 2 * t);
}

// the 16 x 16 A fragment kk of a warp's 16 x 64 f32 accumulator rows,
// rounded to bf16 (the accumulator layout is the A operand layout)
__device__ __forceinline__ void pack_a(uint32_t* a, float (*acc)[4], int kk) {
  a[0] = pack_bf16(acc[2 * kk][0], acc[2 * kk][1]);
  a[1] = pack_bf16(acc[2 * kk][2], acc[2 * kk][3]);
  a[2] = pack_bf16(acc[2 * kk + 1][0], acc[2 * kk + 1][1]);
  a[3] = pack_bf16(acc[2 * kk + 1][2], acc[2 * kk + 1][3]);
}

// rows [0, valid) of a (kRows, HD) tile from global (row stride `stride`
// elements, 16-byte aligned rows) into shared memory; rows past valid are 0
template <int HD>
__device__ void load_tile(bf16* dst, const bf16* src, long stride, int valid) {
  constexpr int kChunks = HD / 8;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < kRows * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = idx % kChunks;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) v = *reinterpret_cast<const uint4*>(src + r * stride + c * 8);
    *reinterpret_cast<uint4*>(dst + r * Tile<HD>::kLd + c * 8) = v;
  }
}

struct Strides {  // element strides (batch, token, head); head-dim stride 1
  long sb, st, sh;
};

__device__ __forceinline__ long offset(const Strides& s, int b, long t, int h) {
  return b * s.sb + t * s.st + h * s.sh;
}

// delta[(b * H + h) * T + i] = sum_d g[b, i, h, d] o[b, i, h, d] in f32
template <int HD>
__global__ void __launch_bounds__(kDeltaWarps * 32)
    delta_kernel(const bf16* __restrict__ g, const bf16* __restrict__ o,
                 float* __restrict__ delta, int T, int H, long rows, Strides gs,
                 Strides os) {
  const long row = (long)blockIdx.x * kDeltaWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const int i = (int)(row % T);
  const int h = (int)((row / T) % H);
  const int b = (int)(row / ((long)T * H));
  const bf16* gp = g + offset(gs, b, i, h);
  const bf16* op = o + offset(os, b, i, h);
  float acc = 0.f;
  for (int d = 2 * lane; d < HD; d += 64) {
    const float2 gv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(gp + d));
    const float2 ov = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(op + d));
    acc += gv.x * ov.x + gv.y * ov.y;
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (lane == 0) delta[row] = acc;
}

// dq for one (b, h, 64 q rows, 64 head-dim columns)
template <int HD>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ g,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dq, int Tq, int Tk, Strides qs, Strides ks,
              Strides vs, Strides gs, Strides dqs) {
  constexpr int LD = Tile<HD>::kLd;
  constexpr int NS = kRows / 8;   // S tiles (16 x 8) per warp per k/v tile
  constexpr int NC = kChunk / 8;  // dq tiles (16 x 8) per warp
  constexpr int NCH = HD / kChunk;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sG = sQ + kRows * LD;
  bf16* sK = sG + kRows * LD;
  bf16* sV = sK + kRows * LD;

  const int q0 = (blockIdx.x / NCH) * kRows;
  const int c0 = (blockIdx.x % NCH) * kChunk;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int H = gridDim.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gr = lane / 4;  // fragment row (and row + 8)
  const int t = lane % 4;   // fragment column pair 2t, 2t + 1

  load_tile<HD>(sQ, q + offset(qs, b, q0, h), qs.st, min(kRows, Tq - q0));
  load_tile<HD>(sG, g + offset(gs, b, q0, h), gs.st, min(kRows, Tq - q0));

  const long stat0 = ((long)b * H + h) * Tq;
  float lse_r[2], del_r[2];  // rows gr and gr + 8 of this warp
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + gr + 8 * r;
    lse_r[r] = row < Tq ? lse[stat0 + row] : 0.f;
    del_r[r] = row < Tq ? delta[stat0 + row] : 0.f;
  }

  float acc[NC][4];
#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const bf16* qw = sQ + warp * 16 * LD;
  const bf16* gw = sG + warp * 16 * LD;

  for (int kv0 = 0; kv0 < Tk; kv0 += kRows) {
    const int valid = min(kRows, Tk - kv0);
    __syncthreads();  // the previous tile is consumed; Q and G are ready
    load_tile<HD>(sK, k + offset(ks, b, kv0, h), ks.st, valid);
    load_tile<HD>(sV, v + offset(vs, b, kv0, h), vs.st, valid);
    __syncthreads();

    // S = Q K^T and dP = G V^T: this warp's 16 q rows x 64 key columns
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      uint32_t aq[4], ag[4];
      load_a(aq, qw, LD, kk, gr, t);
      load_a(ag, gw, LD, kk, gr, t);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        // B[k][j] = K[j][k] (resp. V): k contiguous along a row
        const bf16* kr = sK + (n * 8 + gr) * LD + kk + 2 * t;
        const bf16* vr = sV + (n * 8 + gr) * LD + kk + 2 * t;
        mma_bf16(s[n], aq, ld32(kr), ld32(kr + 8));
        mma_bf16(dp[n], ag, ld32(vr), ld32(vr + 8));
      }
    }

    // p = exp(s - lse), 0 past Tk; ds = p (dp - delta), kept in s
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = n * 8 + 2 * t + (e & 1) < valid
                            ? __expf(s[n][e] - lse_r[e / 2]) : 0.f;
        s[n][e] = p * (dp[n][e] - del_r[e / 2]);
      }

    // dq += bf16(ds) K[:, c0 : c0 + 64]
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      uint32_t a[4];
      pack_a(a, s, kk);
#pragma unroll
      for (int n = 0; n < NC; n += 2) {
        uint32_t bk[4];
        ldsm_x4_trans(sK + (kk * 16 + (lane & 15)) * LD + c0 + n * 8 + (lane >> 4) * 8, bk);
        mma_bf16(acc[n], a, bk[0], bk[1]);
        mma_bf16(acc[n + 1], a, bk[2], bk[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + gr + 8 * r;
    if (row >= Tq) continue;
    bf16* out = dq + offset(dqs, b, row, h) + c0;
#pragma unroll
    for (int n = 0; n < NC; ++n)
      *reinterpret_cast<__nv_bfloat162*>(out + n * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

// dk and dv for one (b, h, 64 key rows, 64 head-dim columns)
template <int HD>
__global__ void __launch_bounds__(kThreads)
    dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ g,
                const float* __restrict__ lse, const float* __restrict__ delta,
                bf16* __restrict__ dk, bf16* __restrict__ dv, int Tq, int Tk,
                Strides qs, Strides ks, Strides vs, Strides gs, Strides dks,
                Strides dvs) {
  constexpr int LD = Tile<HD>::kLd;
  constexpr int NS = kRows / 8;   // S^T tiles (16 x 8) per warp per q tile
  constexpr int NC = kChunk / 8;  // dk, dv tiles (16 x 8) per warp
  constexpr int NCH = HD / kChunk;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + kRows * LD;
  bf16* sQ = sV + kRows * LD;
  bf16* sG = sQ + kRows * LD;
  float* sL = reinterpret_cast<float*>(sG + kRows * LD);
  float* sD = sL + kRows;

  const int k0 = (blockIdx.x / NCH) * kRows;
  const int c0 = (blockIdx.x % NCH) * kChunk;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int H = gridDim.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gr = lane / 4;
  const int t = lane % 4;

  load_tile<HD>(sK, k + offset(ks, b, k0, h), ks.st, min(kRows, Tk - k0));
  load_tile<HD>(sV, v + offset(vs, b, k0, h), vs.st, min(kRows, Tk - k0));

  float adk[NC][4], adv[NC][4];
#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[n][e] = adv[n][e] = 0.f;
  const bf16* kw = sK + warp * 16 * LD;
  const bf16* vw = sV + warp * 16 * LD;
  const long stat0 = ((long)b * H + h) * Tq;

  for (int q0 = 0; q0 < Tq; q0 += kRows) {
    const int valid = min(kRows, Tq - q0);
    __syncthreads();  // the previous tile is consumed; K and V are ready
    load_tile<HD>(sQ, q + offset(qs, b, q0, h), qs.st, valid);
    load_tile<HD>(sG, g + offset(gs, b, q0, h), gs.st, valid);
    for (int i = threadIdx.x; i < kRows; i += kThreads) {
      // +inf makes p = exp(s - lse) exactly 0 for rows past Tq
      sL[i] = i < valid ? lse[stat0 + q0 + i] : INFINITY;
      sD[i] = i < valid ? delta[stat0 + q0 + i] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V G^T: this warp's 16 key rows x 64 q columns
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      uint32_t ak[4], av[4];
      load_a(ak, kw, LD, kk, gr, t);
      load_a(av, vw, LD, kk, gr, t);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const bf16* qr = sQ + (n * 8 + gr) * LD + kk + 2 * t;
        const bf16* gr_ = sG + (n * 8 + gr) * LD + kk + 2 * t;
        mma_bf16(s[n], ak, ld32(qr), ld32(qr + 8));
        mma_bf16(dp[n], av, ld32(gr_), ld32(gr_ + 8));
      }
    }

    // p^T = exp(s^T - lse) in s, ds^T = p^T (dp^T - delta) in dp; the q
    // index is the column
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = n * 8 + 2 * t + (e & 1);
        const float p = __expf(s[n][e] - sL[i]);
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - sD[i]);
      }

    // dv += bf16(p^T) G[:, c0 : c0 + 64]; dk += bf16(ds^T) Q[:, c0 : c0 + 64]
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      uint32_t ap[4], ad[4];
      pack_a(ap, s, kk);
      pack_a(ad, dp, kk);
      const int row = kk * 16 + (lane & 15);
      const int col = c0 + (lane >> 4) * 8;
#pragma unroll
      for (int n = 0; n < NC; n += 2) {
        uint32_t bg[4], bq[4];
        ldsm_x4_trans(sG + row * LD + col + n * 8, bg);
        ldsm_x4_trans(sQ + row * LD + col + n * 8, bq);
        mma_bf16(adv[n], ap, bg[0], bg[1]);
        mma_bf16(adv[n + 1], ap, bg[2], bg[3]);
        mma_bf16(adk[n], ad, bq[0], bq[1]);
        mma_bf16(adk[n + 1], ad, bq[2], bq[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = k0 + warp * 16 + gr + 8 * r;
    if (row >= Tk) continue;
    bf16* outk = dk + offset(dks, b, row, h) + c0;
    bf16* outv = dv + offset(dvs, b, row, h) + c0;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(outk + n * 8 + 2 * t) =
          __floats2bfloat162_rn(adk[n][2 * r], adk[n][2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(outv + n * 8 + 2 * t) =
          __floats2bfloat162_rn(adv[n][2 * r], adv[n][2 * r + 1]);
    }
  }
}

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
  delta_kernel<HD><<<(unsigned)((rows + kDeltaWarps - 1) / kDeltaWarps),
                     kDeltaWarps * 32, 0, stream>>>(a.g, a.o, a.delta, a.Tq, a.H,
                                                    rows, a.gs, a.os);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t bytes = Tile<HD>::kBytes;
  err = cudaFuncSetAttribute(dq_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dkdv_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  constexpr int NCH = HD / kChunk;
  const dim3 grid_q(((a.Tq + kRows - 1) / kRows) * NCH, a.H, a.B);
  dq_kernel<HD><<<grid_q, kThreads, bytes, stream>>>(
      a.q, a.k, a.v, a.g, a.lse, a.delta, a.dq, a.Tq, a.Tk, a.qs, a.ks, a.vs,
      a.gs, a.dqs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_k(((a.Tk + kRows - 1) / kRows) * NCH, a.H, a.B);
  dkdv_kernel<HD><<<grid_k, kThreads, bytes, stream>>>(
      a.q, a.k, a.v, a.g, a.lse, a.delta, a.dk, a.dv, a.Tq, a.Tk, a.qs, a.ks,
      a.vs, a.gs, a.dks, a.dvs);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o, g: (B, T, H, hd) bf16 inputs (o the forward's output, g =
// dL/do); lse: (B, H, Tq) f32 from the forward; delta: (B, H, Tq) f32
// scratch; dq, dk, dv: (B, T, H, hd) bf16 outputs. strides: 24 element
// strides (batch, token, head) of q, k, v, o, g, dq, dk, dv in turn; the
// head-dim stride is 1.
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
