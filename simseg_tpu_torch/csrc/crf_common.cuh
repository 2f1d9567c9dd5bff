// What the CRF kernels of both compute types share (crf_mean_field.cu,
// float32; crf_mean_field_bf16.cu, the TPU kernels' bf16 mode): the call's
// parameters, the phases of one cooperative launch and their items, the
// grid barrier, the closing on bit-packed masks (and the tail's argmax), and
// the launch. The per-type parts (features, the bilateral product, the
// update, the cell means) live in each source.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxClasses = 8;
constexpr int kMaxRadius = 16;
constexpr int kMaxTileH = 32;     // update tile rows (a multiple of s)
constexpr int kMaxTileW = 64;     // update tile columns (a multiple of s)
constexpr int kStrip = 8;         // Gaussian outputs per thread
constexpr int kBand = 32;         // closing rows per item
constexpr int kSmemLimit = 232448;

struct Params {
  const float* du;          // (B, K, H, W), or (B, K, H/f, W/f) for the tail
  const void* rgb;          // (B, H, W, 3) uint8 or float32
  const float* taps;        // float32: 2 radius + 1
  const float* ah;          // float32: H
  const float* aw;          // float32: W
  const float* wtab;        // bf16: (W + 8, 4 ceil((2r + 1) / 4)) bandw[x + t - r,
                            //   x], bf16 values, zero-padded
  const float* htab;        // bf16: (H + 8, ...) bandh[y, y + t - r], the same
  const float* scores;      // tail: (B, K)
  const void* cand_idx;     // tail: (B, K) int32 or int64
  float* feat;              // float32: (B, N, 8) scaled features (5 used);
                            // bf16: (B, Np / 2, 12) features by cell pair
  float* bn;                // (B, N); bf16: (B, Np), bf16 values
  float* q;                 // float32: (B, K, N) cell means of d
  float* m;                 // (B, K, N) messages (bf16: bf16 values; before
                            //   the first message, the cell means of d0)
  float* d0;                // float32: (B, K, H, W) iterates ah[y] aw[x] d: odd
  float* d1;                //   iterations write d1, even ones d0
  __nv_bfloat16* e[2];      // bf16: (B, K, H, Wp) iterates, even and odd
  __nv_bfloat16* v;         // bf16: (B, Np / 2, 8, 2) bn q by cell pair and class
  uint32_t* bits;           // (B, K, H, ceil(W / 32)) the last iterate's d > 0
  float* out;               // float32 mean field: (B, K, H, W) 0/1 masks
  __nv_bfloat16* out16;     // bf16 mean field: (B, K, H, W) 0/1 masks
  int* pred;                // tail: (B, H, W)
  float* best_w;            // tail: (B, H, W)
  unsigned* barrier;        // two zeroed words: arrivals, releases
  int B, K, H, W, f, s, radius, iters, ck;
  int rgb_u8, idx64;
  float gc, bc, sxy, srgb;  // bf16: gc, bc rounded to bf16
  float scale;              // bf16: 1 / s^2 rounded to bf16
  int N, ws, hs;            // cells, cells per row, cell rows
  int Np, Wp;               // bf16: cells padded to 16, iterate row pitch
  int wlo, whi, hlo, hhi;   // bf16: the table rows with the interior's taps
  int TH, TW, tiles_x, tiles, fused_splat, tail;
  int bands;
};

// ------------------------------------------------------------ the phases

enum Kind { kFeat = 1, kInit = 2, kSplat = 4, kDegree = 8, kMessage = 16,
            kUpdate = 32, kZero = 64, kClose = 128 };

struct Phase {
  int kinds, it;
};

// no iteration: zero the mask bits; du > 0 into them; the closing.
// Else: the features and the cell means of d0 = tanh(du / 2); the degree
// and zeroing the mask bits; per iteration the message, the update (the
// last one writes the mask bits, not d) and, for tiles not of whole cells,
// the cell means of d; the closing.
__host__ __device__ inline int num_phases(const Params& p) {
  if (p.iters == 0) return 3;
  return 3 + 2 * p.iters + (p.fused_splat ? 0 : p.iters - 1);
}

__host__ __device__ inline Phase phase_at(const Params& p, int ph) {
  if (ph == num_phases(p) - 1) return {kClose, 0};
  if (p.iters == 0) return {ph == 0 ? kZero : kInit, -1};
  if (ph == 0) return {kFeat | kSplat, -1};
  if (ph == 1) return {kDegree | kZero, -1};
  const int per = p.fused_splat ? 2 : 3;
  const int it = (ph - 2) / per, r = (ph - 2) - it * per;
  return {r == 0 ? kMessage : r == 1 ? kUpdate : kSplat, it};
}

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// the items of a kind, the bilateral products' at rows rows an item (the
// bf16 kernel runs those and its cell means by items of its own)
__host__ __device__ inline int items_of(const Params& p, int kind, int rows) {
  const int planes = p.B * p.K;
  switch (kind) {
    case kFeat: return p.B * p.hs;
    case kInit: case kUpdate: return planes * p.tiles;
    case kSplat: return planes * cdiv(p.N, kThreads);
    case kDegree: case kMessage: return p.B * cdiv(p.N, rows);
    case kZero: return planes;
    case kClose: return (p.tail ? p.B : p.B * p.K) * p.bands;
  }
  return 0;
}

// ---------------------------------------------------------- device parts

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// the 32 mask bits of pixels pos .. pos + 31 of a packed row; words
// outside the row read as fill
__device__ __forceinline__ uint32_t word_at(const uint32_t* row, int q, int ww,
                                            uint32_t fill) {
  return q >= 0 && q < ww ? row[q] : fill;
}
__device__ __forceinline__ uint32_t bits_at(const uint32_t* row, int pos, int ww,
                                            uint32_t fill) {
  const int q = pos >> 5, r = pos & 31;
  const uint32_t lo = word_at(row, q, ww, fill);
  return r == 0 ? lo : (lo >> r) | (word_at(row, q + 1, ww, fill) << (32 - r));
}

__host__ __device__ inline int close_rows(int H, int ck) {
  return imin(H, kBand + 2 * (ck - 1));
}

// shared-memory words of a closing band: two working copies of its rows
// and the closed band (the tail keeps the K closed bands)
__host__ __device__ inline int close_words(int K, int H, int W, int ck, bool tail) {
  const int ww = (W + 31) / 32;
  return 2 * close_rows(H, ck) * ww + (tail ? K : 1) * kBand * ww;
}

// rows y0 .. y0 + th - 1 of maps c_lo .. c_hi - 1 of image b: the closing
// of the mask bits, then (kTail, all K maps) the argmax, or (mean field)
// the closed masks as floats (kBf16Out: as bf16)
template <bool kTail, bool kBf16Out = false>
__device__ void close_item(const Params& p, int b, int c_lo, int c_hi, int band,
                           uint32_t* smem) {
  const int H = p.H, W = p.W, ww = (W + 31) >> 5, k = p.ck;
  const int a = k >> 1, z = k - 1 - a;     // window [v - a, v + z]
  const int y0 = band * kBand, th = min(kBand, H - y0);
  const int r0 = max(0, y0 - 2 * a), r1 = min(H, y0 + th + 2 * z);
  const int e0 = max(0, y0 - a), e1 = min(H, y0 + th + z);
  const int rr = close_rows(H, k);
  uint32_t* buf0 = smem;
  uint32_t* buf1 = buf0 + rr * ww;
  uint32_t* fin = buf1 + rr * ww;
  const uint32_t tail_bits = (W & 31) ? ~((1u << (W & 31)) - 1u) : 0u;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int c = c_lo; c < c_hi; ++c) {
    const size_t plane = ((size_t)b * p.K + c) * H * W;
    uint32_t* done = fin + (kTail ? c * kBand * ww : 0);
    const int t0 = k > 1 ? r0 : y0, t1 = k > 1 ? r1 : y0 + th;
    uint32_t* tbuf = k > 1 ? buf0 : done;
    const uint32_t* src = p.bits + (((size_t)b * p.K + c) * H + t0) * ww;
    __syncthreads();
    for (int t = tid; t < (t1 - t0) * ww; t += kThreads) tbuf[t] = __ldcg(src + t);
    if (k > 1) {
      __syncthreads();
      for (int t = tid; t < (r1 - r0) * ww; t += kThreads) {   // dilate along x
        const int r = t / ww, w = t - r * ww;
        uint32_t acc = 0u;
        for (int o = -a; o <= z; ++o) acc |= bits_at(buf0 + r * ww, w * 32 + o, ww, 0u);
        buf1[t] = acc;
      }
      __syncthreads();
      for (int t = tid; t < (e1 - e0) * ww; t += kThreads) {   // dilate along y
        const int r = t / ww, w = t - r * ww, y = e0 + r;
        uint32_t acc = 0u;
        for (int yy = max(0, y - a); yy <= min(H - 1, y + z); ++yy)
          acc |= buf1[(yy - r0) * ww + w];
        if (w == ww - 1) acc |= tail_bits;  // past the image: erosion's identity
        buf0[(y - r0) * ww + w] = acc;
      }
      __syncthreads();
      for (int t = tid; t < (e1 - e0) * ww; t += kThreads) {   // erode along x
        const int r = t / ww, w = t - r * ww;
        const uint32_t* row = buf0 + (e0 - r0 + r) * ww;
        uint32_t acc = 0xffffffffu;
        for (int o = -a; o <= z; ++o) acc &= bits_at(row, w * 32 + o, ww, 0xffffffffu);
        buf1[(e0 - r0 + r) * ww + w] = acc;
      }
      __syncthreads();
      for (int t = tid; t < th * ww; t += kThreads) {          // erode along y
        const int r = t / ww, w = t - r * ww, y = y0 + r;
        uint32_t acc = 0xffffffffu;
        for (int yy = max(0, y - a); yy <= min(H - 1, y + z); ++yy)
          acc &= buf1[(yy - r0) * ww + w];
        done[t] = acc;
      }
    }
    if (!kTail) {
      __syncthreads();
      for (int t = warp; t < th * ww; t += kWarps) {
        const int r = t / ww, w = t - r * ww;
        const int x = w * 32 + lane;
        if (x >= W) continue;
        const float bit = (float)((done[t] >> lane) & 1u);
        const size_t o = plane + (size_t)(y0 + r) * W + x;
        if (kBf16Out) p.out16[o] = __float2bfloat16_rn(bit);
        else p.out[o] = bit;
      }
    }
  }
  if (!kTail) return;
  __syncthreads();
  const size_t img = (size_t)b * H * W;
  for (int t = warp; t < th * ww; t += kWarps) {
    const int r = t / ww, w = t - r * ww;
    const int x = w * 32 + lane;
    if (x >= W) continue;
    float best = 0.f;
    int idx = 0;
    for (int c = 0; c < p.K; ++c) {
      const float wgt = (float)((fin[c * kBand * ww + t] >> lane) & 1u) *
                        __ldg(p.scores + b * p.K + c);
      const int ci = p.idx64 ? (int)__ldg((const long long*)p.cand_idx + b * p.K + c)
                             : __ldg((const int*)p.cand_idx + b * p.K + c);
      if (c == 0 || wgt > best) {
        best = wgt;
        idx = ci;
      }
    }
    const size_t o = img + (size_t)(y0 + r) * W + x;
    p.pred[o] = best > 0.f ? idx : 0;
    p.best_w[o] = best;
  }
}

// a closing item of the call: one band of one map (mean field) or of all K
// maps of an image (tail)
template <bool kTail, bool kBf16Out>
__device__ void close_dispatch(const Params& p, int item, float* smem) {
  const int mp = item / p.bands, band = item - mp * p.bands;
  uint32_t* words = reinterpret_cast<uint32_t*>(smem);
  if (kTail) {
    close_item<true, kBf16Out>(p, mp, 0, p.K, band, words);
  } else {
    const int b = mp / p.K;
    close_item<false, kBf16Out>(p, b, mp - b * p.K, mp - b * p.K + 1, band, words);
  }
}

// Every block of the grid arrives before any leaves (the grid is
// co-resident: a cooperative launch). bar[0] counts arrivals and is back
// to 0 at each release, bar[1] counts releases. The arrival is a
// release-acquire add and the wait an acquire load at gpu scope, so every
// write before the barrier is seen by every read after it.
__device__ void grid_barrier(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned seen, arrived, now;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(seen) : "l"(bar + 1) : "memory");
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
                 : "=r"(arrived) : "l"(bar) : "memory");
    if (arrived == gridDim.x - 1) {
      asm volatile("st.relaxed.gpu.global.u32 [%0], 0;" ::"l"(bar) : "memory");
      asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(bar + 1) : "memory");
    } else {
      do {
        __nanosleep(32);
        asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(now) : "l"(bar + 1) : "memory");
      } while (now == seen);
    }
  }
  __syncthreads();
}

// --------------------------------------------------------------- the host

// fills the shape fields of p shared by both types (TH x TW the update
// tile, ops/crf_fused.py:launch_plan's); false if the kernels do not take
// the call
bool setup_shape(Params& p, int B, int K, int H, int W, int f, int stride, int radius,
                 int iters, int ck, int TH, int TW, bool tail) {
  if (B < 1 || K < 1 || K > kMaxClasses || H < 1 || W < 1 || radius < 0 ||
      radius > kMaxRadius || stride < 1 || H % stride || W % stride || iters < 0 ||
      f < 1 || H % f || W % f || (long long)H * W >= (1ll << 30) || TH < 1 ||
      TH > kMaxTileH || TW < 1 || TW > kMaxTileW)
    return false;
  p.B = B, p.K = K, p.H = H, p.W = W, p.f = f, p.s = stride, p.radius = radius;
  p.iters = iters;
  p.ck = ck > 1 ? ck : 1;
  p.ws = W / stride;
  p.hs = H / stride;
  p.N = p.hs * p.ws;
  p.TH = TH, p.TW = TW;
  p.tiles_x = cdiv(W, TW);
  p.tiles = cdiv(H, TH) * p.tiles_x;
  p.fused_splat = TH % stride == 0 && TW % stride == 0;
  p.bands = cdiv(H, kBand);
  p.tail = tail;
  return true;
}

// one cooperative launch of the phases lo .. hi - 1 (by default every
// phase) of kernel (a __global__ taking (Params, first phase, end phase)):
// as many blocks as the card holds at once
template <typename Kernel>
cudaError_t launch(Kernel kernel, Params p, int smem, unsigned* barrier, cudaStream_t st,
                   int lo = 0, int hi = 1 << 30) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev, sms, per_sm;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
          cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                           smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  p.barrier = barrier;
  hi = imin(hi, num_phases(p));
  void* args[] = {&p, &lo, &hi};
  return cudaLaunchCooperativeKernel((const void*)kernel, dim3(sms * per_sm),
                                     dim3(kThreads), args, (size_t)smem, st);
}

}  // namespace
