// Mean-field dense CRF (binary label-difference form) + optional binary
// closing, for Hopper (sm_90a), float32.
//
// Replaces the TPU kernel simseg_tpu/ops/crf_fused.py:mean_field_fused
// (_mean_field_kernel, _build_kmat, _mf_class). Per (image, class) map:
//
//   d0 = tanh(du / 2)
//   repeat num_iters:  d = tanh((du + gc * G(d) + bc * B(d)) / 2)
//   mask = d > 0, then optionally a k x k closing (window max, then min,
//   each over the taps that lie inside the image)
//
// G is the separable truncated Gaussian normalised on both sides by
// ah[y] * aw[x]; B splats d to the stride-s grid (box mean), applies the
// symmetric-normalised bilateral kernel bn_i K_ij bn_j over the N cells of
// the image, and slices back (nearest).
//
// What bounds it on this card: at the main-path shape (B images of 288^2,
// K = 5, s = 8, N = 1296) the floating-point work (~170 MFLOP per image,
// CUDA cores, float32) and the HBM traffic of the fine-grid maps are of
// the same order. The TPU design kept the whole (N, N) matrix and every
// fine-grid map in VMEM; an SM has 227 KB of shared memory and one 288^2
// float32 map alone takes 331 KB, so this design instead:
//   - never stores K: each pass recomputes exp(-|f_i - f_j|^2 / 2) from the
//     8-float features, one warp per 4 rows, the cells' features and
//     weighted messages staged through shared memory in 256-cell tiles
//     (degree pass once, then one pass per iteration for all K classes);
//   - keeps d in HBM between iterations (ping-pong buffers) and runs the
//     Gaussian on 32x32 output tiles with a radius-r halo in shared memory;
//   - runs the closing as four separable uint8 passes.
// Launches are all on the caller's stream; the host function returns the
// first launch error as an int (0 = cudaSuccess) and allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFeat = 8;          // padded feature width (2 pos + 3 rgb + 3 zero)
constexpr int kUsedFeat = 5;
constexpr int kMaxClasses = 8;
constexpr int kMaxRadius = 16;
constexpr int kTile = 32;         // Gaussian output tile edge
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr int kCellTile = kThreads;  // cells staged per shared-memory tile

__global__ void init_kernel(const float* __restrict__ du, float* __restrict__ d,
                            long n) {
  long i = blockIdx.x * (long)blockDim.x + threadIdx.x;
  if (i < n) d[i] = tanhf(du[i] * 0.5f);
}

// q[p, c] = mean of d[p] over stride cell c (p indexes the B*K planes)
__global__ void splat_kernel(const float* __restrict__ d, float* __restrict__ q,
                             int planes, int H, int W, int s) {
  const int ws = W / s;
  const int n = (H / s) * ws;
  long idx = blockIdx.x * (long)blockDim.x + threadIdx.x;
  if (idx >= (long)planes * n) return;
  const int p = (int)(idx / n);
  const int c = (int)(idx % n);
  const float* src = d + (long)p * H * W + (long)(c / ws) * s * W + (c % ws) * s;
  float acc = 0.f;
  for (int y = 0; y < s; ++y)
    for (int x = 0; x < s; ++x) acc += src[(long)y * W + x];
  q[idx] = acc / (float)(s * s);
}

// Bilateral product for image b = blockIdx.y over rows i of this block:
//   degree mode (q == nullptr): out[b, i] = 1 / sqrt(sum_j K_ij + 1e-20)
//   message mode:               out[b, c, i] = bn_i sum_j K_ij bn_j q[b, c, j]
// with K_ij = exp(-0.5 max(|f_i|^2 + |f_j|^2 - 2 f_i.f_j, 0)).
__global__ void bilateral_kernel(const float* __restrict__ feat,
                                 const float* __restrict__ q,
                                 const float* __restrict__ bn,
                                 float* __restrict__ out, int N, int C) {
  __shared__ float s_feat[kUsedFeat + 1][kCellTile];  // 5 features + |f|^2
  __shared__ float s_val[kMaxClasses][kCellTile];
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * kRowsPerBlock + warp * kRowsPerWarp;
  const float* fb = feat + (long)b * N * kFeat;

  float fi[kRowsPerWarp][kUsedFeat];
  float sqi[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i = row0 + r;
    sqi[r] = 0.f;
#pragma unroll
    for (int t = 0; t < kUsedFeat; ++t) {
      fi[r][t] = i < N ? fb[(long)i * kFeat + t] : 0.f;
      sqi[r] += fi[r][t] * fi[r][t];
    }
  }
  float acc[kRowsPerWarp][kMaxClasses];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < kMaxClasses; ++c) acc[r][c] = 0.f;

  for (int j0 = 0; j0 < N; j0 += kCellTile) {
    __syncthreads();
    const int j = j0 + threadIdx.x;
    float sq = 0.f;
#pragma unroll
    for (int t = 0; t < kUsedFeat; ++t) {
      const float f = j < N ? fb[(long)j * kFeat + t] : 0.f;
      s_feat[t][threadIdx.x] = f;
      sq += f * f;
    }
    s_feat[kUsedFeat][threadIdx.x] = sq;
    for (int c = 0; c < C; ++c) {
      float v = 0.f;  // cells past N carry zero weight
      if (j < N) v = q ? q[((long)b * C + c) * N + j] * bn[(long)b * N + j] : 1.f;
      s_val[c][threadIdx.x] = v;
    }
    __syncthreads();
    const int jn = min(kCellTile, N - j0);
    for (int jj = lane; jj < jn; jj += 32) {
      float fj[kUsedFeat];
#pragma unroll
      for (int t = 0; t < kUsedFeat; ++t) fj[t] = s_feat[t][jj];
      const float sqj = s_feat[kUsedFeat][jj];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        float dot = 0.f;
#pragma unroll
        for (int t = 0; t < kUsedFeat; ++t) dot += fi[r][t] * fj[t];
        const float d2 = sqi[r] + sqj - 2.f * dot;
        const float k = expf(-0.5f * fmaxf(d2, 0.f));
#pragma unroll
        for (int c = 0; c < kMaxClasses; ++c)
          if (c < C) acc[r][c] += k * s_val[c][jj];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i = row0 + r;
#pragma unroll
    for (int c = 0; c < kMaxClasses; ++c) {
      if (c >= C) continue;
      float v = acc[r][c];
      for (int off = 16; off > 0; off /= 2)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0 && i < N) {
        if (q == nullptr)
          out[(long)b * N + i] = 1.f / sqrtf(v + 1e-20f);
        else
          out[((long)b * C + c) * N + i] = bn[(long)b * N + i] * v;
      }
    }
  }
}

// d_out = tanh((du + gc G(d_in) + bc m[cell]) / 2) on one kTile^2 tile of
// plane p = blockIdx.z; m is (planes, N) on the stride-s grid.
__global__ void update_kernel(const float* __restrict__ d_in,
                              const float* __restrict__ du,
                              const float* __restrict__ m,
                              const float* __restrict__ taps,
                              const float* __restrict__ ah,
                              const float* __restrict__ aw,
                              float* __restrict__ d_out, int H, int W, int s,
                              int radius, float gc, float bc) {
  __shared__ float s_in[kTile + 2 * kMaxRadius][kTile + 2 * kMaxRadius];
  __shared__ float s_rows[kTile + 2 * kMaxRadius][kTile];
  __shared__ float s_taps[2 * kMaxRadius + 1];
  const int p = blockIdx.z;
  const int y0 = blockIdx.y * kTile;
  const int x0 = blockIdx.x * kTile;
  const int span = kTile + 2 * radius;
  const int ntaps = 2 * radius + 1;
  const long plane = (long)H * W;
  const float* dp = d_in + p * plane;

  for (int t = threadIdx.x; t < ntaps; t += blockDim.x) s_taps[t] = taps[t];
  // the halo outside the image is zero: the band matrices are truncated
  for (int idx = threadIdx.x; idx < span * span; idx += blockDim.x) {
    const int ty = idx / span, tx = idx % span;
    const int y = y0 - radius + ty, x = x0 - radius + tx;
    float v = 0.f;
    if (y >= 0 && y < H && x >= 0 && x < W) v = dp[(long)y * W + x] * ah[y] * aw[x];
    s_in[ty][tx] = v;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < span * kTile; idx += blockDim.x) {
    const int ty = idx / kTile, tx = idx % kTile;
    float a = 0.f;
    for (int t = 0; t < ntaps; ++t) a += s_taps[t] * s_in[ty][tx + t];
    s_rows[ty][tx] = a;
  }
  __syncthreads();
  const int ws = W / s;
  const float* mp = m + (long)p * (H / s) * ws;
  for (int idx = threadIdx.x; idx < kTile * kTile; idx += blockDim.x) {
    const int ty = idx / kTile, tx = idx % kTile;
    const int y = y0 + ty, x = x0 + tx;
    if (y >= H || x >= W) continue;
    float a = 0.f;
    for (int t = 0; t < ntaps; ++t) a += s_taps[t] * s_rows[ty + t][tx];
    const float g = a * ah[y] * aw[x];
    const float mb = mp[(y / s) * ws + x / s];
    const long o = p * plane + (long)y * W + x;
    d_out[o] = tanhf((du[o] + gc * g + bc * mb) * 0.5f);
  }
}

// may run in place (d == out) when the last iterate already sits in out
template <typename T>
__global__ void threshold_kernel(const float* d, T* out, long n) {
  long i = blockIdx.x * (long)blockDim.x + threadIdx.x;
  if (i < n) out[i] = d[i] > 0.f ? T(1) : T(0);
}

// One separable closing pass: max or min over [v - k/2, v + k - 1 - k/2]
// along x (along_x) or y, over the taps inside the image only.
template <typename T>
__global__ void window_kernel(const uint8_t* __restrict__ in, T* __restrict__ out,
                              long n, int H, int W, int k, int along_x,
                              int is_max) {
  long i = blockIdx.x * (long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long plane = (long)H * W;
  const long base = i - i % plane;
  const int y = (int)(i % plane / W), x = (int)(i % W);
  const int lo = -(k / 2), hi = k - 1 - k / 2;
  uint8_t a = is_max ? 0 : 1;
  for (int t = lo; t <= hi; ++t) {
    const int yy = along_x ? y : y + t;
    const int xx = along_x ? x + t : x;
    if (yy < 0 || yy >= H || xx < 0 || xx >= W) continue;
    const uint8_t v = in[base + (long)yy * W + xx];
    a = is_max ? (v > a ? v : a) : (v < a ? v : a);
  }
  out[i] = T(a);
}

inline unsigned blocks_for(long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" int crf_mean_field_f32(
    const float* du, const float* feat, const float* taps, const float* ah,
    const float* aw, int B, int K, int H, int W, int stride, int radius,
    int num_iters, float gaussian_compat, float bilateral_compat,
    int closing_ksize, float* d_work, float* q, float* m, float* bn,
    uint8_t* mask_a, uint8_t* mask_b, float* out, void* stream_ptr) {
  if (B < 1 || K < 1 || K > kMaxClasses || radius < 0 || radius > kMaxRadius ||
      stride < 1 || H % stride || W % stride || num_iters < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream_ptr;
  const long total = (long)B * K * H * W;
  const int planes = B * K;
  const int N = (H / stride) * (W / stride);
  cudaError_t err;
#define CRF_CHECK()                                    \
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err

  const dim3 bil_grid((N + kRowsPerBlock - 1) / kRowsPerBlock, B);
  bilateral_kernel<<<bil_grid, kThreads, 0, st>>>(feat, nullptr, nullptr, bn, N, 1);
  CRF_CHECK();

  float* cur = d_work;
  float* nxt = out;
  init_kernel<<<blocks_for(total), kThreads, 0, st>>>(du, cur, total);
  CRF_CHECK();
  const dim3 upd_grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, planes);
  for (int it = 0; it < num_iters; ++it) {
    splat_kernel<<<blocks_for((long)planes * N), kThreads, 0, st>>>(cur, q, planes, H, W,
                                                                   stride);
    CRF_CHECK();
    bilateral_kernel<<<bil_grid, kThreads, 0, st>>>(feat, q, bn, m, N, K);
    CRF_CHECK();
    update_kernel<<<upd_grid, kThreads, 0, st>>>(cur, du, m, taps, ah, aw, nxt, H, W,
                                                 stride, radius, gaussian_compat,
                                                 bilateral_compat);
    CRF_CHECK();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }

  const unsigned nb = blocks_for(total);
  if (closing_ksize <= 1) {
    threshold_kernel<float><<<nb, kThreads, 0, st>>>(cur, out, total);
    CRF_CHECK();
    return 0;
  }
  const int k = closing_ksize;
  threshold_kernel<uint8_t><<<nb, kThreads, 0, st>>>(cur, mask_a, total);
  CRF_CHECK();
  window_kernel<uint8_t><<<nb, kThreads, 0, st>>>(mask_a, mask_b, total, H, W, k, 1, 1);
  CRF_CHECK();
  window_kernel<uint8_t><<<nb, kThreads, 0, st>>>(mask_b, mask_a, total, H, W, k, 0, 1);
  CRF_CHECK();
  window_kernel<uint8_t><<<nb, kThreads, 0, st>>>(mask_a, mask_b, total, H, W, k, 1, 0);
  CRF_CHECK();
  window_kernel<float><<<nb, kThreads, 0, st>>>(mask_b, out, total, H, W, k, 0, 0);
  CRF_CHECK();
#undef CRF_CHECK
  return 0;
}

extern "C" const char* crf_mean_field_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
