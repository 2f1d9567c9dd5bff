// Streaming bilateral matrix-vector product for Hopper (sm_90a), float32:
//
//   out[b, i, c] = sum_j K_b[i, j] q[b, j, c],
//   K_b[i, j] = exp(-0.5 |f_i - f_j|^2)
//
// over the N cells of image b, with f the (B, N, 8) features (zero-padded
// past the used ones) and C <= 8 columns of q. K is never stored.
//
// Replaces the TPU kernels simseg_tpu/ops/crf_pallas.py:bilateral_matvec
// (_kernel) and bilateral_matvec_batched (_kernel_batched); the first is
// the second at B = 1. The TPU kernels pad N to a multiple of 512 with
// rows at 1e4 whose weight underflows to 0; here the cells past N are left
// out by bounds checks and nothing is padded. The TPU kernels expand the
// distance as |f_i|^2 + |f_j|^2 - 2 f_i.f_j, which cancels in float32 at
// the CRF's |f|^2 ~ 1.5e3 (up to 1.1e-4 relative in the product); this
// kernel sums the squared differences instead, which do not cancel.
//
// What bounds it on this card: operations on the CUDA cores. Every pair
// (i, j) costs the 8-wide squared distance, one exp and C multiply-adds:
// B N^2 pairs (430 M at B = 16, N = 5184), against N (8 + 2C) floats of
// input and output per image. The design keeps the row side in registers
// and walks the column side through shared memory:
//   - one CTA of 128 threads per (b, 256-row tile), two rows per thread,
//     the rows' features and C accumulators in registers;
//   - 256-cell column tiles of features and q staged in shared
//     memory, read by every thread of the block at the same address
//     (broadcast, no bank conflicts).
// The host function returns the launch error as an int (0 = cudaSuccess)
// and allocates nothing; the launch is on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFeat = 8;
constexpr int kThreads = 128;
constexpr int kRowsPerThread = 2;
constexpr int kRowTile = kThreads * kRowsPerThread;
constexpr int kColTile = 256;

template <int C>
__global__ void __launch_bounds__(kThreads)
    bilateral_matvec_kernel(const float* __restrict__ feat,
                            const float* __restrict__ q, float* __restrict__ out,
                            int N) {
  __shared__ __align__(16) float s_feat[kColTile][kFeat];
  __shared__ float s_q[kColTile][C];
  const int b = blockIdx.y;
  const float* fb = feat + (long)b * N * kFeat;
  const float* qb = q + (long)b * N * C;

  float fi[kRowsPerThread][kFeat];
  float acc[kRowsPerThread][C];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int i = blockIdx.x * kRowTile + r * kThreads + threadIdx.x;
#pragma unroll
    for (int t = 0; t < kFeat; ++t) fi[r][t] = i < N ? fb[(long)i * kFeat + t] : 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.f;
  }

  for (int j0 = 0; j0 < N; j0 += kColTile) {
    __syncthreads();
    for (int jj = threadIdx.x; jj < kColTile; jj += kThreads) {
      const int j = j0 + jj;
#pragma unroll
      for (int t = 0; t < kFeat; ++t) s_feat[jj][t] = j < N ? fb[(long)j * kFeat + t] : 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) s_q[jj][c] = j < N ? qb[(long)j * C + c] : 0.f;
    }
    __syncthreads();
    const int jn = min(kColTile, N - j0);  // cells past N take no part
    for (int jj = 0; jj < jn; ++jj) {
      const float4 fa = *reinterpret_cast<const float4*>(&s_feat[jj][0]);
      const float4 fz = *reinterpret_cast<const float4*>(&s_feat[jj][4]);
      float qj[C];
#pragma unroll
      for (int c = 0; c < C; ++c) qj[c] = s_q[jj][c];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        // |f_i - f_j|^2 over the 8 columns (the zero padding adds 0)
        float e = fi[r][0] - fa.x, d2 = e * e;
        e = fi[r][1] - fa.y; d2 += e * e;
        e = fi[r][2] - fa.z; d2 += e * e;
        e = fi[r][3] - fa.w; d2 += e * e;
        e = fi[r][4] - fz.x; d2 += e * e;
        e = fi[r][5] - fz.y; d2 += e * e;
        e = fi[r][6] - fz.z; d2 += e * e;
        e = fi[r][7] - fz.w; d2 += e * e;
        const float kv = __expf(-0.5f * d2);
#pragma unroll
        for (int c = 0; c < C; ++c) acc[r][c] += kv * qj[c];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int i = blockIdx.x * kRowTile + r * kThreads + threadIdx.x;
    if (i >= N) continue;
#pragma unroll
    for (int c = 0; c < C; ++c) out[((long)b * N + i) * C + c] = acc[r][c];
  }
}

template <int C>
cudaError_t launch(const float* feat, const float* q, float* out, int B, int N,
                   cudaStream_t stream) {
  const dim3 grid((N + kRowTile - 1) / kRowTile, B);
  bilateral_matvec_kernel<C><<<grid, kThreads, 0, stream>>>(feat, q, out, N);
  return cudaGetLastError();
}

}  // namespace

// feat (B, N, 8), q (B, N, C), out (B, N, C): contiguous float32
extern "C" int bilateral_matvec_f32(const float* feat, const float* q, float* out,
                                    int B, int N, int C, void* stream_ptr) {
  if (B < 1 || B > 65535 || N < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  switch (C) {
    case 1: return (int)launch<1>(feat, q, out, B, N, st);
    case 2: return (int)launch<2>(feat, q, out, B, N, st);
    case 3: return (int)launch<3>(feat, q, out, B, N, st);
    case 4: return (int)launch<4>(feat, q, out, B, N, st);
    case 5: return (int)launch<5>(feat, q, out, B, N, st);
    case 6: return (int)launch<6>(feat, q, out, B, N, st);
    case 7: return (int)launch<7>(feat, q, out, B, N, st);
    case 8: return (int)launch<8>(feat, q, out, B, N, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* bilateral_matvec_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
