// Streaming bilateral matrix-vector product for Hopper (sm_90a), float32:
//
//   out[b, i, c] = sum_j K_b[i, j] q[b, j, c],
//   K_b[i, j] = exp(-0.5 |f_i - f_j|^2)
//
// over the N cells of image b, with f the (B, N, F) features (F <= 8) and
// any number C of columns of q, read through its strides. K is never
// stored.
//
// Replaces the TPU kernels simseg_tpu/ops/crf_pallas.py:bilateral_matvec
// (_kernel) and bilateral_matvec_batched (_kernel_batched); the first is
// the second at B = 1. The TPU kernels pad N to a multiple of 512 with
// rows at 1e4 whose weight underflows to 0; here the cells past N are left
// out and nothing is padded. The TPU kernels expand the distance as
// |f_i|^2 + |f_j|^2 - 2 f_i.f_j, which cancels in float32 at the CRF's
// |f|^2 ~ 1.5e3 (up to 1.1e-4 relative in the product); this kernel sums
// the squared differences instead, which do not cancel.
//
// What bounds it on this card: instructions on the CUDA cores. Every pair
// (i, j) costs the F-wide squared distance, one exp2 and C multiply-adds:
// B N^2 pairs (430 M at B = 16, N = 5184), against N (F + 2C) floats of
// input and output per image. The design spends as few issue slots per
// pair as it can and fills the card at any batch:
//   - the row side in registers, kRows = 6 rows a thread (192 a warp),
//     scaled once by s = sqrt(0.5 log2 e), so that K = exp2(-|g_i - s f_j|^2)
//     and the difference g_i - s f_j is one FFMA: at F = 5 and C = 5 a pair
//     is 5 FFMA, 1 FMUL and 4 FFMA for the distance, one MUFU.EX2 and 5 FFMA;
//   - the feature count a template argument (5, the CRF's, or 8 with the
//     features past F zero), the columns in groups of at most 8 (kGroup,
//     one template instance per group width, the groups along grid z);
//   - the column side as one record per cell in shared memory (F features,
//     then the group's q values, padded to a multiple of 4 floats), read by
//     the whole warp at one address as 128-bit broadcasts: 3 loads per 6
//     pairs at F = C = 5;
//   - 64-cell column tiles in a two-stage ring filled by cp.async while the
//     other stage is computed, shared by the CTA's warps (four, 768 rows);
//   - the columns split into S chunks across CTAs, S from N alone, so
//     that the grid fills the card at one image and an image's sums do not
//     depend on the batch: each CTA writes its chunk's partial sums to the
//     workspace, and a second small kernel (bilateral_sum_kernel) adds the
//     S partials of every output in chunk order. No atomics touch the sums,
//     so two calls are bit-equal and image b's result is the same at any
//     batch. (The last CTA of each row tile adding them through a counter
//     measured slower at (16, 5184), PERF.md: it took registers from the
//     product, and its S rounds of loads wait in the kernel's tail.)
// The plan (warps per CTA, S, the chunk size, shared memory, workspace)
// comes from ops/crf_pallas.py:launch_plan; the host function refuses one
// that does not match its own count. It returns the launch error as an int
// (0 = cudaSuccess) and allocates nothing; the launches are on the
// caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 6;               // rows per thread
constexpr int kWarpRows = 32 * kRows;  // rows per warp
constexpr int kTile = 64;              // column cells per staged tile
constexpr int kStages = 2;
constexpr int kMaxFeat = 8;
constexpr int kGroup = 8;              // columns of q per group, at most
constexpr int kMaxWarps = 8;
constexpr int kMaxGroups = 65535;      // of G x B, grid z of the chunk sum
constexpr int kSumThreads = 256;
// sqrt(0.5 log2 e): exp(-0.5 |f_i - f_j|^2) = exp2(-|s f_i - s f_j|^2)
constexpr float kScale = 0.849321800288019f;

// floats of one cell's record: FK features, CW values of q, padded to 4
__host__ __device__ constexpr int record_floats(int fk, int cw) {
  return (fk + cw + 3) / 4 * 4;
}

struct Params {
  const float* feat;          // (B, N, F) contiguous
  const float* q;             // (B, N, C) through its strides
  long long q_sb, q_sn, q_sc;
  float* out;                 // (B, N, C) contiguous
  float* part;                // (G, B, S, CW, N) partial sums
  int B, N, F, C, S, cs, tiles;
};

// component k (a constant after unrolling) of a float4
__device__ __forceinline__ float part4(const float4& x, int k) {
  return k == 0 ? x.x : k == 1 ? x.y : k == 2 ? x.z : x.w;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 4 bytes global -> shared, zero-filled where !valid (src is not read)
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// records of cells j .. j + kTile - 1 of image b, column group g, into
// rec; cells at or past j1, features past F and columns past C are zero
template <int FK, int CW>
__device__ __forceinline__ void stage_tile(const Params& p, float* rec, int b, int g,
                                           int j, int j1) {
  constexpr int REC = record_floats(FK, CW);
  const float* fb = p.feat + (long long)b * p.N * p.F;
  for (int e = threadIdx.x; e < kTile * FK; e += blockDim.x) {
    const int cell = e / FK, t = e - cell * FK;
    const bool ok = j + cell < j1 && t < p.F;
    cp_async4(rec + cell * REC + t, ok ? fb + (long long)(j + cell) * p.F + t : p.feat,
              ok);
  }
  const float* qb = p.q + b * p.q_sb;
  for (int e = threadIdx.x; e < kTile * CW; e += blockDim.x) {
    const int c = e / kTile, cell = e - c * kTile;
    const int col = g * kGroup + c;
    const bool ok = j + cell < j1 && col < p.C;
    cp_async4(rec + cell * REC + FK + c,
              ok ? qb + (j + cell) * p.q_sn + col * p.q_sc : p.q, ok);
  }
  cp_async_commit();
}

// grid (row tiles x S, B, G), blockDim.x = 32 x warps: CTA (rt, s) takes
// rows rt x warps x 192 ... and the cells of chunk s
template <int FK, int CW>
__global__ void __launch_bounds__(kMaxWarps * 32)
    bilateral_matvec_kernel(const Params p) {
  constexpr int REC = record_floats(FK, CW);
  extern __shared__ __align__(16) float smem[];  // kStages x kTile x REC
  const int rt = blockIdx.x / p.S, s = blockIdx.x - rt * p.S;
  const int b = blockIdx.y, g = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int base = (rt * (blockDim.x >> 5) + warp) * kWarpRows;
  const bool active = base < p.N;  // a warp past N only stages tiles
  const int j0 = s * p.cs, j1 = min(p.N, j0 + p.cs);

  float gi[kRows][FK], acc[kRows][CW];
  const float* fb = p.feat + (long long)b * p.N * p.F;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = base + 32 * r + lane;
#pragma unroll
    for (int t = 0; t < FK; ++t)
      gi[r][t] = i < p.N && t < p.F ? kScale * fb[(long long)i * p.F + t] : 0.f;
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[r][c] = 0.f;
  }

  const int ntiles = (j1 - j0 + kTile - 1) / kTile;
  stage_tile<FK, CW>(p, smem, b, g, j0, j1);
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait_all();
    __syncthreads();  // tile t landed; every warp is done with tile t - 1
    const int jt = j0 + t * kTile;
    if (t + 1 < ntiles)
      stage_tile<FK, CW>(p, smem + ((t + 1) % kStages) * kTile * REC, b, g,
                         jt + kTile, j1);
    if (!active) continue;
    const float* rec = smem + (t % kStages) * kTile * REC;
    const int jn = min(kTile, j1 - jt);
    // two cells an iteration, four at CW = 1 (the degree): with fewer, the
    // compiler puts a cell's six MUFU.EX2 together at the loop's end, each
    // before its dependent FFMA, and the degree measured 4-16% slower
#pragma unroll(CW == 1 ? 4 : 2)
    for (int j = 0; j < jn; ++j) {
      float4 v[REC / 4];
#pragma unroll
      for (int k = 0; k < REC / 4; ++k)
        v[k] = reinterpret_cast<const float4*>(rec + j * REC)[k];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        // -|g_i - s f_j|^2, summed in feature order
        float d = fmaf(part4(v[0], 0), -kScale, gi[r][0]);
        float nd2 = __fmul_rn(-d, d);
#pragma unroll
        for (int u = 1; u < FK; ++u) {
          d = fmaf(part4(v[u / 4], u % 4), -kScale, gi[r][u]);
          nd2 = fmaf(-d, d, nd2);
        }
        const float w = ex2(nd2);
#pragma unroll
        for (int c = 0; c < CW; ++c)
          acc[r][c] = fmaf(w, part4(v[(FK + c) / 4], (FK + c) % 4), acc[r][c]);
      }
    }
  }

  if (!active) return;
  // this chunk's partial sums; bilateral_sum_kernel adds them
  float* ps = p.part + ((((long long)g * p.B + b) * p.S + s) * CW) * p.N;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = base + 32 * r + lane;
    if (i >= p.N) continue;
#pragma unroll
    for (int c = 0; c < CW; ++c) ps[(long long)c * p.N + i] = acc[r][c];
  }
}

// out[b, i, g * 8 + c] = the S partial sums of part[g, b, :, c, i] added
// in chunk order (a copy at S = 1); grid (ceil(N / 256), CW, G x B)
__global__ void __launch_bounds__(kSumThreads)
    bilateral_sum_kernel(const float* __restrict__ part, float* __restrict__ out,
                         int B, int N, int C, int S, int CW) {
  const int i = blockIdx.x * kSumThreads + threadIdx.x, c = blockIdx.y;
  const int g = blockIdx.z / B, b = blockIdx.z - g * B;
  if (i >= N || g * kGroup + c >= C) return;
  const float* pk = part + ((long long)blockIdx.z * S * CW + c) * N + i;
  const long long step = (long long)CW * N;
  float sum = pk[0];
#pragma unroll 4
  for (int k = 1; k < S; ++k) sum += pk[k * step];
  out[((long long)b * N + i) * C + g * kGroup + c] = sum;
}

template <int FK, int CW>
cudaError_t launch(const Params& p, int warps, int groups, int smem, cudaStream_t st) {
  const dim3 grid(p.tiles * p.S, p.B, groups);
  bilateral_matvec_kernel<FK, CW><<<grid, warps * 32, smem, st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 sum_grid((p.N + kSumThreads - 1) / kSumThreads, CW, groups * p.B);
  bilateral_sum_kernel<<<sum_grid, kSumThreads, 0, st>>>(p.part, p.out, p.B, p.N, p.C,
                                                          p.S, CW);
  return cudaGetLastError();
}

template <int FK>
cudaError_t by_width(const Params& p, int cw, int warps, int groups, int smem,
                     cudaStream_t st) {
  switch (cw) {
    case 1: return launch<FK, 1>(p, warps, groups, smem, st);
    case 2: return launch<FK, 2>(p, warps, groups, smem, st);
    case 3: return launch<FK, 3>(p, warps, groups, smem, st);
    case 4: return launch<FK, 4>(p, warps, groups, smem, st);
    case 5: return launch<FK, 5>(p, warps, groups, smem, st);
    case 6: return launch<FK, 6>(p, warps, groups, smem, st);
    case 7: return launch<FK, 7>(p, warps, groups, smem, st);
    case 8: return launch<FK, 8>(p, warps, groups, smem, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// feat (B, N, F) contiguous float32, F <= 8; q (B, N, C) float32 with
// element strides q_sb, q_sn, q_sc; out (B, N, C) contiguous float32. The
// plan (ops/crf_pallas.py:launch_plan): warps per CTA, S chunks of
// chunk_cells cells, smem bytes per CTA; work holds work_floats floats,
// the (G, B, S, CW, N) partial sums.
extern "C" int bilateral_matvec_f32(const float* feat, const float* q, long long q_sb,
                                    long long q_sn, long long q_sc, float* out,
                                    float* work, long long work_floats, int B, int N,
                                    int F, int C, int warps, int chunks,
                                    int chunk_cells, int smem, void* stream_ptr) {
  if (B < 1 || B > 65535 || N < 1 || F < 1 || F > kMaxFeat || C < 1 || warps < 1 ||
      warps > kMaxWarps || chunk_cells < 1 || chunks < 1)
    return (int)cudaErrorInvalidValue;
  const int fk = F == 5 ? 5 : kMaxFeat;
  const int cw = C < kGroup ? C : kGroup;
  const int groups = (C + kGroup - 1) / kGroup;
  Params p = {};
  p.tiles = (N + warps * kWarpRows - 1) / (warps * kWarpRows);
  if ((long long)groups * B > kMaxGroups ||
      chunks != (N + chunk_cells - 1) / chunk_cells ||
      (long long)p.tiles * chunks > 0x7fffffffLL ||
      smem != kStages * kTile * record_floats(fk, cw) * 4 ||
      work_floats < (long long)groups * B * chunks * cw * N)
    return (int)cudaErrorInvalidValue;
  p.feat = feat, p.q = q, p.q_sb = q_sb, p.q_sn = q_sn, p.q_sc = q_sc, p.out = out;
  p.part = work;
  p.B = B, p.N = N, p.F = F, p.C = C, p.S = chunks, p.cs = chunk_cells;
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  if (fk == 5) return (int)by_width<5>(p, cw, warps, groups, smem, st);
  return (int)by_width<kMaxFeat>(p, cw, warps, groups, smem, st);
}

extern "C" const char* bilateral_matvec_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
