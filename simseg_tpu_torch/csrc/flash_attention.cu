// Bias-free softmax attention, forward, for Hopper (sm_90a): bf16 q, k, v
// and output, float32 scores, softmax statistics and accumulators.
//
// Replaces the TPU kernel simseg_tpu/ops/flash_attention.py:flash_mha
// (_mha_pallas / _mha_kernel). For each (batch b, head h):
//
//   o[b, :, h] = softmax(q[b, :, h] k[b, :, h]^T) v[b, :, h]
//
// with q pre-scaled by hd^-1/2, on (B, T, H, hd) tensors read in place
// through their strides (no fold to (B*H, T, hd), no transpose copies).
//
// The TPU design kept the whole (T, T) f32 score tile of one (b, h) in
// VMEM: 6.7 MB at T = 1297, against 227 KB of shared memory in an H100
// block. This design streams k/v instead, with an online softmax:
//   - one CTA of 4 warps per (b, h, 64-row q tile); each warp owns 16 q
//     rows; k/v tiles of KV rows are staged in shared memory;
//   - S = Q K^T and O += P V run on the tensor cores as mma.sync
//     m16n8k16 bf16 products accumulating in f32; S, P and O never leave
//     registers: the layout of an S accumulator tile is the layout of the
//     P operand, so P is rounded to bf16 in place;
//   - each thread keeps the running max m and sum l of its two rows in
//     f32 and rescales its O accumulators by exp(m_old - m_new); O is
//     divided by l at the end (the TPU kernel normalised p before its
//     bf16 cast: the two differ at bf16 rounding);
//   - key columns past Tk are masked out, query rows past Tq not stored.
// What bounds it on this card: 4 B H Tq Tk hd operations on the tensor
// cores (about 0.084 ms per ViT-B layer at B = 16, T = 1297 at 989 TFLOP/s
// bf16); q/k/v/o traffic is a tenth of that. wgmma, TMA and overlapping
// the k/v loads with the products are later work.
//
// The host function returns the launch error as an int (0 = cudaSuccess)
// and allocates nothing; the launch is on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;              // q rows per CTA
constexpr int kWarps = kRows / 16;     // one warp per 16 q rows
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;                // bf16 row padding (16 bytes)

// k/v rows per tile: fewer for wide heads, to keep O in registers
template <int HD>
struct Tile {
  static constexpr int kKV = HD <= 128 ? 64 : 32;
  static constexpr int kLd = HD + kPad;  // shared-memory row, bf16
  static constexpr size_t kBytes =
      (size_t)(kRows + 2 * kKV) * kLd * sizeof(bf16);
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

// rows [0, valid) of a (rows, HD) tile from global (row stride `stride`
// elements, 16-byte aligned rows) into shared memory; rows past valid are 0
template <int HD>
__device__ void load_tile(bf16* dst, const bf16* src, long stride, int rows,
                          int valid) {
  constexpr int kChunks = HD / 8;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < rows * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = idx % kChunks;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) v = *reinterpret_cast<const uint4*>(src + r * stride + c * 8);
    *reinterpret_cast<uint4*>(dst + r * Tile<HD>::kLd + c * 8) = v;
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, int Tq,
                     int Tk, long q_sb, long q_st, long q_sh, long k_sb, long k_st,
                     long k_sh, long v_sb, long v_st, long v_sh, long o_sb,
                     long o_st, long o_sh) {
  constexpr int KV = Tile<HD>::kKV;
  constexpr int LD = Tile<HD>::kLd;
  constexpr int NS = KV / 8;   // S tiles (16 x 8) per warp per k/v tile
  constexpr int NO = HD / 8;   // O tiles (16 x 8) per warp
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + kRows * LD;
  bf16* sV = sK + KV * LD;

  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;   // fragment row (and row + 8)
  const int t = lane % 4;   // fragment column pair 2t, 2t + 1
  const bf16* kb = k + b * k_sb + h * k_sh;
  const bf16* vb = v + b * v_sb + h * v_sh;

  load_tile<HD>(sQ, q + b * q_sb + h * q_sh + (long)q0 * q_st, q_st, kRows,
                min(kRows, Tq - q0));

  float acc_o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_o[n][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8
  float l_run[2] = {0.f, 0.f};
  const bf16* qw = sQ + warp * 16 * LD;

  for (int kv0 = 0; kv0 < Tk; kv0 += KV) {
    const int valid = min(KV, Tk - kv0);
    __syncthreads();  // the previous tile is consumed; Q is ready
    load_tile<HD>(sK, kb + (long)kv0 * k_st, k_st, KV, valid);
    load_tile<HD>(sV, vb + (long)kv0 * v_st, v_st, KV, valid);
    __syncthreads();

    // S = Q K^T: this warp's 16 rows x KV columns
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      uint32_t a[4];
      a[0] = ld32(qw + g * LD + kk + 2 * t);
      a[1] = ld32(qw + (g + 8) * LD + kk + 2 * t);
      a[2] = ld32(qw + g * LD + kk + 8 + 2 * t);
      a[3] = ld32(qw + (g + 8) * LD + kk + 8 + 2 * t);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        // B[k][j] = K[j][k]: k contiguous along a row of K
        const bf16* kr = sK + (n * 8 + g) * LD + kk + 2 * t;
        mma_bf16(s[n], a, ld32(kr), ld32(kr + 8));
      }
    }

    // online softmax on rows g (e = 0, 1) and g + 8 (e = 2, 3)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (n * 8 + 2 * t + (e & 1) >= valid) s[n][e] = -INFINITY;
        mx[e / 2] = fmaxf(mx[e / 2], s[n][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);  // finite: valid >= 1
      alpha[r] = __expf(m_run[r] - m_new);         // 0 on the first tile
      m_run[r] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = __expf(s[n][e] - m_run[e / 2]);
        sum[e / 2] += s[n][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l_run[r] = l_run[r] * alpha[r] + sum[r];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_o[n][e] *= alpha[e / 2];

    // O += P V, P as bf16 A fragments straight from the S accumulators
#pragma unroll
    for (int kk = 0; kk < KV / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        // B[k][j] = V[k][j] for two 8-column tiles, transposed on load:
        // lanes 0-15 address rows kk*16 + 0..15 at column n*8, lanes
        // 16-31 the same rows at column n*8 + 8
        const bf16* vr = sV + (kk * 16 + (lane & 15)) * LD + n * 8 + (lane >> 4) * 8;
        uint32_t b0, b1, b2, b3;
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
            : "=r"(b0), "=r"(b1), "=r"(b2), "=r"(b3)
            : "r"((uint32_t)__cvta_generic_to_shared(vr)));
        mma_bf16(acc_o[n], a, b0, b1);
        mma_bf16(acc_o[n + 1], a, b2, b3);
      }
    }
  }

  // o = O / l for the rows below Tq, two bf16 per store
  bf16* ob = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= Tq) continue;
    const float inv = 1.f / l_run[r];
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long)row * o_st + n * 8 + 2 * t) =
          __floats2bfloat162_rn(acc_o[n][2 * r] * inv, acc_o[n][2 * r + 1] * inv);
  }
}

template <int HD>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B,
                   int Tq, int Tk, int H, const long long* st, cudaStream_t stream) {
  const size_t bytes = Tile<HD>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + kRows - 1) / kRows, H, B);
  flash_fwd_kernel<HD><<<grid, kThreads, bytes, stream>>>(
      q, k, v, o, Tq, Tk, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11]);
  return cudaGetLastError();
}

}  // namespace

// strides: 12 element strides (batch, token, head) of q, k, v, o in turn;
// the head-dim stride is 1
extern "C" int flash_attention_fwd_bf16(const void* q, const void* k, const void* v,
                                        void* o, int B, int Tq, int Tk, int H, int hd,
                                        const long long* strides, void* stream_ptr) {
  if (B < 1 || Tq < 1 || Tk < 1 || H < 1 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  switch (hd) {
    case 64: return (int)launch<64>(qp, kp, vp, op, B, Tq, Tk, H, strides, st);
    case 128: return (int)launch<128>(qp, kp, vp, op, B, Tq, Tk, H, strides, st);
    case 192: return (int)launch<192>(qp, kp, vp, op, B, Tq, Tk, H, strides, st);
    case 256: return (int)launch<256>(qp, kp, vp, op, B, Tq, Tk, H, strides, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
