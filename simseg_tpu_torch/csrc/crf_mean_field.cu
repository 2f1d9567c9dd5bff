// Mean-field dense CRF (binary label-difference form) + binary closing,
// and the whole decode tail, for Hopper (sm_90a), float32; and the same two
// entry points in the TPU kernels' bf16 mode (namespace crf_bf16, at the
// end of this file).
//
// Replaces the TPU kernels simseg_tpu/ops/crf_fused.py:mean_field_fused
// (_mean_field_kernel) and :seg_decode_tail_fused (_decode_tail_kernel).
// Per (image, class) map:
//
//   d0 = tanh(du / 2)
//   repeat num_iters:  d = tanh((du + gc * G(d) + bc * B(d)) / 2)
//   mask = d > 0, then a k x k closing (window max, then min, each over
//   the taps that lie inside the image)
//
// G is the separable truncated Gaussian normalised on both sides by
// ah[y] * aw[x]; B splats d to the stride-s grid (box mean), applies the
// symmetric-normalised bilateral kernel bn_i K_ij bn_j over the N cells of
// the image, and slices back (nearest). The tail entry point reads the
// unaries on the patch grid at (y / f, x / f) (their nearest upsample by
// f) and folds the K closed masks of a pixel into a running best of
// mask * scores[b, k] with a strict '>' (argmax's first-occurrence rule):
// pred = cand_idx of the best (0 where the best weight is <= 0), best_w.
//
// What bounds it on this card: at the main-path shape (16 images of 288^2,
// K = 5, s = 8, N = 1296, radius 9, 3 iterations) the float32 work of the
// bilateral passes (N^2 pairs per image and pass, for all K classes at
// once) and of the Gaussian, and the HBM traffic of the fine maps (du read
// and an iterate read and written per iteration, 26.5 MB each), are each
// some tens of microseconds; a chain of small launches, per-element integer
// division and byte-wide passes through HBM cost far more. So:
//   - one cooperative launch runs every phase, a grid barrier between two:
//     the features and d0 with its cell means; the degree (and zeroing the
//     mask bits); per iteration the message and the update; the closing.
//     Each phase is a loop over independent items, one block per item;
//   - the features are computed from the image inside the kernel, and
//     pre-scaled by sqrt(log2(e) / 2), so that K_ij = ex2(-|g_i - g_j|^2)
//     (the difference form: no cancellation) with no further multiply;
//   - the message: 40 rows per block, 5 per warp in registers, the lanes
//     over the cells, staged 512 at a time with bn_j q_j for all K classes
//     (a template argument), so one shared load serves 5 pairs; the lanes'
//     sums in a fixed butterfly order;
//   - the update: a tile of whole stride cells (up to 32 x 64) with a
//     radius-r halo, copied in one cp.async batch with the tile's unaries,
//     both Gaussian passes register-blocked 8 outputs a thread with the
//     taps in registers and the loops unrolled to the radius (a template
//     argument); the iterates are stored normalised (ah[y] aw[x] d, the
//     Gaussian's input); the new d's cell means (the next splat) are taken
//     in the same item; the last update writes d > 0 as mask bits;
//   - tanh(u / 2) = 1 - 2 / (1 + e^u) with the fast exponential (absolute
//     error about 1e-7);
//   - the closing: a band of 32 rows, the masks 32 pixels to a word,
//     dilate and erode as separable OR / AND of shifted words in shared
//     memory; the tail's argmax reads the K closed bands there;
//   - 32-bit index math inside a map, no integer division per element;
//     every reduction in a fixed order, so two calls give the same bits.
// Strides past 32, which no tile of whole cells takes, run in the same
// launch with the cell means as a phase of their own.
//
// Launches are on the caller's stream; the host functions return the launch
// error as an int (0 = cudaSuccess) and allocate nothing: the caller passes
// one float32 workspace (ops/crf_fused.py:workspace_floats) and the grid
// barrier's two words, zeroed before their first call: the arrival count is
// back to 0 after every barrier, and the release count is only compared.

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
constexpr int kRows = 40;         // message rows per item, kRowsPerWarp a warp
constexpr int kRowsPerWarp = kRows / kWarps;
constexpr int kChunk = 512;       // message cells staged per tile
constexpr int kBand = 32;         // closing rows per item
constexpr int kSmemLimit = 232448;
// sqrt(log2(e) / 2): exp(-|f_i - f_j|^2 / 2) = exp2(-|g_i - g_j|^2), g = c f
constexpr float kFeatScale = 0.84932180028801904f;

struct Params {
  const float* du;          // (B, K, H, W), or (B, K, H/f, W/f) for the tail
  const void* rgb;          // (B, H, W, 3) uint8 or float32
  const float* taps;        // 2 radius + 1
  const float* ah;          // H
  const float* aw;          // W
  const float* scores;      // tail: (B, K)
  const void* cand_idx;     // tail: (B, K) int32 or int64
  float* feat;              // (B, N, 8) scaled features (5 used)
  float* bn;                // (B, N)
  float* q;                 // (B, K, N) cell means of d
  float* m;                 // (B, K, N) messages
  float* d0;                // (B, K, H, W) iterates ah[y] aw[x] d: odd
  float* d1;                //   iterations write d1, even ones d0
  uint32_t* bits;           // (B, K, H, ceil(W / 32)) the last iterate's d > 0
  float* out;               // mean field: (B, K, H, W) 0/1 masks
  int* pred;                // tail: (B, H, W)
  float* best_w;            // tail: (B, H, W)
  unsigned* barrier;        // two zeroed words: arrivals, releases
  int B, K, H, W, f, s, radius, iters, ck;
  int rgb_u8, idx64;
  float gc, bc, sxy, srgb;
  int N, ws, hs;            // cells, cells per row, cell rows
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
// the cell means of d; the closing. d0 is never stored: the first update
// and the cell means of d0 read du.
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
__host__ __device__ inline float* iterate(const Params& p, int i) {
  return (i & 1) ? p.d1 : p.d0;
}
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

__host__ __device__ inline int items_of(const Params& p, int kind) {
  const int planes = p.B * p.K;
  switch (kind) {
    case kFeat: return p.B * p.hs;
    case kInit: case kUpdate: return planes * p.tiles;
    case kSplat: return planes * cdiv(p.N, kThreads);
    case kDegree: case kMessage: return p.B * cdiv(p.N, kRows);
    case kZero: return planes;
    case kClose: return (p.tail ? p.B : p.B * p.K) * p.bands;
  }
  return 0;
}

__host__ __device__ inline int phase_items(const Params& p, int ph) {
  const Phase phase = phase_at(p, ph);
  int n = 0;
  for (int kind = 1; kind <= kClose; kind <<= 1)
    if (phase.kinds & kind) n += items_of(p, kind);
  return n;
}

// ---------------------------------------------------------- device parts

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// tanh(u / 2) = 1 - 2 / (1 + e^u) with the fast exponential and division:
// absolute error about 1e-7, and +-1 where e^u overflows or vanishes
__device__ __forceinline__ float tanh_half(float u) {
  return 1.f - __fdividef(2.f, 1.f + __expf(u));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// scaled features of the cells of cell row cy of image b (as
// ops/crf.py:bilateral_features): the s rows summed per pixel and channel
// (neighbouring threads on neighbouring bytes), then s columns per cell
__device__ void feature_item(const Params& p, int b, int cy, float* smem) {
  const int s = p.s, n3 = 3 * p.W;
  const size_t base = ((size_t)b * p.H + (size_t)cy * s) * n3;
  __syncthreads();
  for (int j = threadIdx.x; j < n3; j += kThreads) {
    float a = 0.f;
#pragma unroll 4
    for (int y = 0; y < s; ++y)
      a += p.rgb_u8 ? (float)__ldg((const uint8_t*)p.rgb + base + (size_t)y * n3 + j)
                    : __ldg((const float*)p.rgb + base + (size_t)y * n3 + j);
    smem[j] = a;
  }
  __syncthreads();
  const float area = (float)(s * s);
  for (int cx = threadIdx.x; cx < p.ws; cx += kThreads) {
    float sum[3] = {0.f, 0.f, 0.f};
    for (int x = 0; x < s; ++x)
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) sum[ch] += smem[(cx * s + x) * 3 + ch];
    float* out = p.feat + ((size_t)b * p.N + cy * p.ws + cx) * 8;
    out[0] = ((cy + 0.5f) * s - 0.5f) / p.sxy * kFeatScale;
    out[1] = ((cx + 0.5f) * s - 0.5f) / p.sxy * kFeatScale;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) out[2 + ch] = sum[ch] / area / p.srgb * kFeatScale;
  }
}

// Bilateral product for image b over rows row0 .. row0 + kRows - 1, each
// warp kRowsPerWarp of them in registers, its lanes over the cells (each
// lane its own staged cell: no bank conflict, and one shared load serves
// kRowsPerWarp pairs):
//   C == 0 (degree):  bn[b, i] = 1 / sqrt(sum_j K_ij + 1e-20)
//   C == K (message): m[b, c, i] = bn_i sum_j K_ij bn_j q[b, c, j]
template <int C>
__device__ void message_item(const Params& p, int b, int row0, float* smem) {
  constexpr int kAcc = C > 0 ? C : 1;
  float* s_f = smem;                 // [5][kChunk] scaled features
  float* s_v = smem + 5 * kChunk;    // [C][kChunk] bn_j q[b, c, j]
  const int N = p.N, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = row0 + warp * kRowsPerWarp;
  const float* fb = p.feat + (size_t)b * N * 8;
  const float* bnb = p.bn + (size_t)b * N;
  float gi[kRowsPerWarp][5];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int t = 0; t < 5; ++t)
      gi[r][t] = r0 + r < N ? __ldcg(fb + (size_t)(r0 + r) * 8 + t) : 0.f;
  float acc[kRowsPerWarp][kAcc];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < kAcc; ++c) acc[r][c] = 0.f;

  for (int j0 = 0; j0 < N; j0 += kChunk) {
    const int jn = min(kChunk, N - j0);
    __syncthreads();
    for (int jj = tid; jj < jn; jj += kThreads) {
      const float* fj = fb + (size_t)(j0 + jj) * 8;
#pragma unroll
      for (int t = 0; t < 5; ++t) s_f[t * kChunk + jj] = __ldcg(fj + t);
      if (C > 0) {
        const float bj = __ldcg(bnb + j0 + jj);
#pragma unroll
        for (int c = 0; c < C; ++c)
          s_v[c * kChunk + jj] = __ldcg(p.q + ((size_t)b * C + c) * N + j0 + jj) * bj;
      }
    }
    __syncthreads();
#pragma unroll 2
    for (int jj = lane; jj < jn; jj += 32) {
      float fj[5], v[kAcc];
#pragma unroll
      for (int t = 0; t < 5; ++t) fj[t] = s_f[t * kChunk + jj];
      if (C > 0)
#pragma unroll
        for (int c = 0; c < kAcc; ++c) v[c] = s_v[c * kChunk + jj];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float e0 = gi[r][0] - fj[0], e1 = gi[r][1] - fj[1], e2 = gi[r][2] - fj[2];
        const float e3 = gi[r][3] - fj[3], e4 = gi[r][4] - fj[4];
        const float d2 = fmaf(e4, e4, fmaf(e3, e3, fmaf(e2, e2, fmaf(e1, e1, e0 * e0))));
        const float kij = ex2_approx(-d2);
        if (C == 0) {
          acc[r][0] += kij;
        } else {
#pragma unroll
          for (int c = 0; c < kAcc; ++c) acc[r][c] = fmaf(kij, v[c], acc[r][c]);
        }
      }
    }
  }
  // the lanes' sums, in the same butterfly order on every call
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < kAcc; ++c)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[r][c] += __shfl_xor_sync(0xffffffffu, acc[r][c], off);
  if (lane != 0) return;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i = r0 + r;
    if (i >= N) break;
    if (C == 0) {
      p.bn[(size_t)b * N + i] = 1.f / sqrtf(acc[r][0] + 1e-20f);
    } else {
      const float bi = __ldcg(bnb + i);
#pragma unroll
      for (int c = 0; c < kAcc; ++c) p.m[((size_t)b * C + c) * N + i] = bi * acc[r][c];
    }
  }
}

// shared-memory layout of an update tile (floats), the same on the host
struct TileLayout {
  int thp, twp, pin, prow, in, rows, ah, aw, taps, du, hy, hx, yi, total;
};

__host__ __device__ inline TileLayout tile_layout(int TH, int TW, int radius) {
  TileLayout l;
  const int span = 2 * radius;
  l.thp = cdiv(TH, kStrip) * kStrip;
  l.twp = cdiv(TW, kStrip) * kStrip;
  l.pin = (l.twp + span) | 1;        // odd pitches: no bank conflicts
  l.prow = l.twp + 1;
  l.in = 0;
  l.rows = l.in + (l.thp + span) * l.pin;
  l.ah = l.rows + (l.thp + span) * l.prow;
  l.aw = l.ah + l.thp + span;
  l.taps = l.aw + l.twp + span;
  l.du = l.taps + 2 * kMaxRadius + 1;
  l.hy = l.du + l.thp * l.twp;
  l.hx = l.hy + l.thp + span;
  l.yi = l.hx + l.twp + span;
  l.total = l.yi + l.thp;
  return l;
}

// One tile of plane pl. Iteration it:
//   d' = tanh((du + gc G(d) + bc m[cell]) / 2),
// the iterates stored as ah[y] aw[x] d (the Gaussian's input; d0 written
// with the cell means of d0); d' into the next iterate, or, at the last
// iteration, d' > 0 into the mask bits; when the tile holds whole cells
// and d' is needed again, the tile's cell means of d' into q.
// kInit (no iteration): du > 0 into the mask bits.
template <int R, bool kCoarse, bool kInit>
__device__ void update_item(const Params& p, int pl, int tile, int it, float* smem) {
  constexpr int kSpan = 2 * R;
  const int H = p.H, W = p.W, s = p.s;
  const bool last = kInit || it == p.iters - 1;
  const bool write_q = p.fused_splat && !last;
  const int tyi = tile / p.tiles_x, txi = tile - tyi * p.tiles_x;
  const int y0 = tyi * p.TH, x0 = txi * p.TW;
  const int th = min(p.TH, H - y0), tw = min(p.TW, W - x0);
  const int rows = th + kSpan, cols = tw + kSpan;
  const TileLayout l = tile_layout(p.TH, p.TW, R);
  float* s_in = smem + l.in;
  float* s_rows = smem + l.rows;
  float* s_ah = smem + l.ah;
  float* s_aw = smem + l.aw;
  float* s_taps = smem + l.taps;
  float* s_du = smem + l.du;
  int* s_hy = reinterpret_cast<int*>(smem + l.hy);
  int* s_hx = reinterpret_cast<int*>(smem + l.hx);
  int* s_yi = reinterpret_cast<int*>(smem + l.yi);
  const int tid = threadIdx.x, lane = tid & 31;
  const size_t pbase = (size_t)pl * H * W;
  const int gw = W / p.f;
  const size_t cbase = (size_t)pl * (H / p.f) * gw;

  __syncthreads();  // the previous item is done with shared memory
  if (kCoarse) {    // patch-grid row offsets and columns of the halo
    for (int r = tid; r < rows; r += kThreads) {
      const int y = y0 - R + r;
      s_hy[r] = y >= 0 && y < H ? (y / p.f) * gw : 0;
    }
    for (int c = tid; c < cols; c += kThreads) {
      const int x = x0 - R + c;
      s_hx[c] = x >= 0 && x < W ? x / p.f : 0;
    }
    __syncthreads();
  }
  // one batch of copies: the normalisations and taps, du's tile (fine
  // unaries), the halo of the normalised iterate (zero outside the image)
  for (int r = tid; r < rows; r += kThreads) {
    const int y = y0 - R + r;
    const bool in = y >= 0 && y < H;
    cp_async4(s_ah + r, in ? p.ah + y : p.ah, in ? 4 : 0);
  }
  for (int c = tid; c < cols; c += kThreads) {
    const int x = x0 - R + c;
    const bool in = x >= 0 && x < W;
    cp_async4(s_aw + c, in ? p.aw + x : p.aw, in ? 4 : 0);
  }
  if (!kInit && tid <= kSpan) cp_async4(s_taps + tid, p.taps + tid, 4);
  if (!kCoarse) {
    const int dr = kThreads / tw, dc = kThreads - dr * tw;
    int r = tid / tw, c = tid - r * tw;
    for (int i = tid; i < th * tw; i += kThreads) {
      cp_async4(s_du + r * l.twp + c, p.du + pbase + (y0 + r) * W + x0 + c, 4);
      r += dr;
      c += dc;
      if (c >= tw) {
        c -= tw;
        ++r;
      }
    }
  }
  const int dr = kThreads / cols, dc = kThreads - dr * cols;
  if (!kInit) {
    const float* src = iterate(p, it) + pbase;
    int r = tid / cols, c = tid - r * cols;
    for (int i = tid; i < rows * cols; i += kThreads) {
      const int y = y0 - R + r, x = x0 - R + c;
      const bool in = y >= 0 && y < H && x >= 0 && x < W;
      cp_async4(s_in + r * l.pin + c, in ? src + y * W + x : src, in ? 4 : 0);
      r += dr;
      c += dc;
      if (c >= cols) {
        c -= cols;
        ++r;
      }
    }
  }
  for (int r = tid; r < th; r += kThreads) s_yi[r] = ((y0 + r) / s) * p.ws;
  cp_async_wait_all();
  __syncthreads();

  float tap[kSpan + 1];
  if (!kInit) {
#pragma unroll
    for (int t = 0; t <= kSpan; ++t) tap[t] = s_taps[t];
  }
  if (!kInit) {
    // along x: rows th + 2R (<= 64), strips of kStrip outputs
    const int strips = cdiv(tw, kStrip);
    for (int u = tid; u < 64 * strips; u += kThreads) {
      const int rr = u & 63, st = u >> 6;
      if (rr >= rows) continue;
      const float* srow = s_in + rr * l.pin + st * kStrip;
      float w[kStrip + kSpan], a[kStrip];
#pragma unroll
      for (int k = 0; k < kStrip + kSpan; ++k) w[k] = srow[k];
#pragma unroll
      for (int o = 0; o < kStrip; ++o) a[o] = 0.f;
#pragma unroll
      for (int t = 0; t <= kSpan; ++t)
#pragma unroll
        for (int o = 0; o < kStrip; ++o) a[o] = fmaf(tap[t], w[o + t], a[o]);
#pragma unroll
      for (int o = 0; o < kStrip; ++o) s_rows[rr * l.prow + st * kStrip + o] = a[o];
    }
    __syncthreads();
  }

  // along y and the update: columns tw (<= 64), strips of kStrip rows; a
  // warp's lanes are 32 neighbouring columns of one strip
  float* s_d = s_in;  // the new d, for the cell means
  float* dst = last ? nullptr : iterate(p, it + 1) + pbase;
  uint32_t* bits = p.bits + (size_t)pl * H * ((W + 31) >> 5);
  const int ystrips = cdiv(th, kStrip);
  for (int u = tid; u < 64 * ystrips; u += kThreads) {
    const int xl = u & 63, ys = u >> 6;
    const bool active = xl < tw;
    const int x = x0 + xl;
    const int cx = x / s;
    float g[kStrip];
    if (!kInit && active) {
      const float* src = s_rows + ys * kStrip * l.prow + xl;
      float w[kStrip + kSpan];
#pragma unroll
      for (int k = 0; k < kStrip + kSpan; ++k)
        w[k] = ys * kStrip + k < rows ? src[k * l.prow] : 0.f;
#pragma unroll
      for (int o = 0; o < kStrip; ++o) g[o] = 0.f;
#pragma unroll
      for (int t = 0; t <= kSpan; ++t)
#pragma unroll
        for (int o = 0; o < kStrip; ++o) g[o] = fmaf(tap[t], w[o + t], g[o]);
      const float awx = s_aw[R + xl];
#pragma unroll
      for (int o = 0; o < kStrip; ++o) g[o] *= s_ah[R + ys * kStrip + o] * awx;
    }
#pragma unroll
    for (int o = 0; o < kStrip; ++o) {
      const int ty = ys * kStrip + o;
      if (ty >= th) break;  // the same for the whole warp
      const int y = y0 + ty;
      float dn = 0.f;
      bool fg = false;
      if (active) {
        const float uv = kCoarse ? __ldg(p.du + cbase + s_hy[R + ty] + s_hx[R + xl])
                                 : s_du[ty * l.twp + xl];
        if (kInit) {
          fg = uv > 0.f;
        } else {
          const float mv = __ldcg(p.m + (size_t)pl * p.N + s_yi[ty] + cx);
          dn = tanh_half(uv + (p.gc * g[o] + p.bc * mv));
          fg = dn > 0.f;
        }
      }
      if (last) {
        // the warp's 32 columns start at x - lane: at most two words
        const uint32_t b = __ballot_sync(0xffffffffu, fg);
        const int xb = x - lane, q = xb >> 5, sh = xb & 31;
        uint32_t* row = bits + y * ((W + 31) >> 5);
        if (lane == 0 && (b << sh)) atomicOr(row + q, b << sh);
        if (lane == 0 && sh && (b >> (32 - sh))) atomicOr(row + q + 1, b >> (32 - sh));
      } else if (active) {
        dst[y * W + x] = dn * s_ah[R + ty] * s_aw[R + xl];
        if (write_q) s_d[ty * l.prow + xl] = dn;
      }
    }
  }
  if (!write_q) return;
  // the cell means: each row's s columns, then each cell's s rows (the
  // row sums over s_rows, which the Gaussian is done with)
  __syncthreads();
  const int ncx = tw / s, ncells = (th / s) * ncx;
  for (int u = tid; u < th * ncx; u += kThreads) {
    const int ty = u / ncx, cxl = u - ty * ncx;
    const float* src = s_d + ty * l.prow + cxl * s;
    float a = 0.f;
    for (int x = 0; x < s; ++x) a += src[x];
    s_rows[u] = a;
  }
  __syncthreads();
  const float area = (float)(s * s);
  for (int c = tid; c < ncells; c += kThreads) {
    const int cyl = c / ncx, cxl = c - cyl * ncx;
    float a = 0.f;
    for (int y = 0; y < s; ++y) a += s_rows[(cyl * s + y) * ncx + cxl];
    p.q[(size_t)pl * p.N + (y0 / s + cyl) * p.ws + x0 / s + cxl] = a / area;
  }
}

// q of cells c0 .. c0 + kThreads - 1 of plane pl: the cell means of d0 =
// tanh(du / 2), which goes to the first iterate normalised (it = -1), or,
// for strides too wide for a tile of whole cells, of d after iteration it
template <bool kCoarse>
__device__ void splat_item(const Params& p, int pl, int c0, int it) {
  const int c = c0 + threadIdx.x;
  if (c >= p.N) return;
  const int s = p.s, f = p.f, W = p.W, cy = c / p.ws, cx = c - cy * p.ws;
  float a = 0.f;
  if (it >= 0) {  // the iterate is stored normalised: ah[y] aw[x] d
    const float* src = iterate(p, it + 1) + (size_t)pl * p.H * W + (size_t)cy * s * W + cx * s;
    for (int y = 0; y < s; ++y) {
      const float ah = __ldg(p.ah + cy * s + y);
#pragma unroll 4
      for (int x = 0; x < s; ++x) a += __ldcg(src + y * W + x) / (ah * __ldg(p.aw + cx * s + x));
    }
  } else if (!kCoarse) {
    const size_t o = (size_t)pl * p.H * W + (size_t)cy * s * W + cx * s;
    for (int y = 0; y < s; ++y) {
      const float ah = __ldg(p.ah + cy * s + y);
#pragma unroll 4
      for (int x = 0; x < s; ++x) {
        const float t = tanh_half(__ldg(p.du + o + y * W + x));
        a += t;
        p.d0[o + y * W + x] = t * ah * __ldg(p.aw + cx * s + x);
      }
    }
  } else {
    // the patch grid at (y / f, x / f), the quotients kept by counting
    const int gw = W / f;
    const float* src = p.du + (size_t)pl * (p.H / f) * gw;
    const size_t o = (size_t)pl * p.H * W + (size_t)cy * s * W + cx * s;
    int yq = cy * s / f, yr = cy * s - yq * f;
    for (int y = 0; y < s; ++y) {
      const float ah = __ldg(p.ah + cy * s + y);
      int xq = cx * s / f, xr = cx * s - xq * f;
      for (int x = 0; x < s; ++x) {
        const float t = tanh_half(__ldg(src + yq * gw + xq));
        a += t;
        p.d0[o + y * W + x] = t * ah * __ldg(p.aw + cx * s + x);
        if (++xr == f) xr = 0, ++xq;
      }
      if (++yr == f) yr = 0, ++yq;
    }
  }
  p.q[(size_t)pl * p.N + c] = a / (float)(s * s);
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

// rows y0 .. y0 + th - 1 of maps c_lo .. c_hi - 1 of image b: the closing
// of the mask bits, then (kTail, all K maps) the argmax, or (mean field)
// the closed masks as floats
template <bool kTail>
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
        if (x < W)
          p.out[plane + (size_t)(y0 + r) * W + x] = (float)((done[t] >> lane) & 1u);
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

// ------------------------------------------------------------ the kernel

template <bool kCoarse>
__device__ void update_dispatch(const Params& p, int pl, int tile, int it, float* smem) {
  switch (p.radius) {
#define CRF_R(r) \
  case r: update_item<r, kCoarse, false>(p, pl, tile, it, smem); break;
    CRF_R(0) CRF_R(1) CRF_R(2) CRF_R(3) CRF_R(4) CRF_R(5) CRF_R(6) CRF_R(7)
    CRF_R(8) CRF_R(9) CRF_R(10) CRF_R(11) CRF_R(12) CRF_R(13) CRF_R(14)
    CRF_R(15) CRF_R(16)
#undef CRF_R
  }
}

__device__ void message_dispatch(const Params& p, int C, int b, int row0, float* smem) {
  switch (C) {
    case 0: message_item<0>(p, b, row0, smem); break;
    case 1: message_item<1>(p, b, row0, smem); break;
    case 2: message_item<2>(p, b, row0, smem); break;
    case 3: message_item<3>(p, b, row0, smem); break;
    case 4: message_item<4>(p, b, row0, smem); break;
    case 5: message_item<5>(p, b, row0, smem); break;
    case 6: message_item<6>(p, b, row0, smem); break;
    case 7: message_item<7>(p, b, row0, smem); break;
    case 8: message_item<8>(p, b, row0, smem); break;
  }
}

// item `item` of one phase: finds its kind by the phase's kinds in order
template <bool kCoarse>
__device__ void run_item(const Params& p, const Phase& phase, int item, float* smem) {
  for (int kind = 1; kind <= kClose; kind <<= 1) {
    if (!(phase.kinds & kind)) continue;
    const int n = items_of(p, kind);
    if (item >= n) {
      item -= n;
      continue;
    }
    switch (kind) {
      case kFeat: {
        const int b = item / p.hs;
        feature_item(p, b, item - b * p.hs, smem);
        break;
      }
      case kInit: {
        const int pl = item / p.tiles;
        update_item<0, kCoarse, true>(p, pl, item - pl * p.tiles, -1, smem);
        break;
      }
      case kSplat: {
        const int per = cdiv(p.N, kThreads), pl = item / per;
        splat_item<kCoarse>(p, pl, (item - pl * per) * kThreads, phase.it);
        break;
      }
      case kDegree: case kMessage: {
        const int per = cdiv(p.N, kRows), b = item / per;
        message_dispatch(p, kind == kDegree ? 0 : p.K, b, (item - b * per) * kRows, smem);
        break;
      }
      case kUpdate: {
        const int pl = item / p.tiles;
        update_dispatch<kCoarse>(p, pl, item - pl * p.tiles, phase.it, smem);
        break;
      }
      case kZero: {
        const int n = p.H * ((p.W + 31) >> 5);
        for (int t = threadIdx.x; t < n; t += kThreads) p.bits[(size_t)item * n + t] = 0u;
        break;
      }
      case kClose: {
        const int mp = item / p.bands, band = item - mp * p.bands;
        uint32_t* words = reinterpret_cast<uint32_t*>(smem);
        if (kCoarse) {
          close_item<true>(p, mp, 0, p.K, band, words);
        } else {
          const int b = mp / p.K;
          close_item<false>(p, b, mp - b * p.K, mp - b * p.K + 1, band, words);
        }
        break;
      }
    }
    return;
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

// phases ph_lo .. ph_hi - 1, the items of each spread over the grid, a
// grid barrier between two phases
template <bool kCoarse>
__global__ void __launch_bounds__(kThreads, 2)
crf_kernel(const __grid_constant__ Params p, int ph_lo, int ph_hi) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  for (int ph = ph_lo; ph < ph_hi; ++ph) {
    if (ph > ph_lo) grid_barrier(p.barrier);
    const Phase phase = phase_at(p, ph);
    const int n = phase_items(p, ph);
    for (int item = blockIdx.x; item < n; item += gridDim.x)
      run_item<kCoarse>(p, phase, item, smem);
  }
}

// --------------------------------------------------------------- the host

// shared memory a call needs (bytes): the largest of an update tile, a
// message tile (the degree's and the K-class one) and a closing band (the
// tail keeps the K closed bands)
inline int smem_need(int K, int H, int W, int TH, int TW, int radius, int iters,
                     int ck, bool tail) {
  int need = tile_layout(TH, TW, radius).total;
  if (iters > 0) {
    need = imax(need, kChunk * (5 + K));
  }
  const int ww = (W + 31) / 32;
  need = imax(need, 2 * close_rows(H, ck) * ww + (tail ? K : 1) * kBand * ww);
  if (iters > 0) need = imax(need, 3 * W);  // a cell row's column sums
  return need * 4;
}

// fills p from the call's arguments and carves the workspace: feat (B, N,
// 8), bn (B, N), q and m (B, K, N), two iterates (B, K, H, W), the mask
// bits (B, K, H, ceil(W / 32)) words
bool setup(Params& p, int B, int K, int H, int W, int f, int stride, int radius,
           int iters, int ck, int TH, int TW, int smem, bool tail, float* work) {
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
  if (smem > kSmemLimit || smem < smem_need(K, H, W, TH, TW, radius, iters, p.ck, tail))
    return false;
  const size_t bn = (size_t)B * p.N, plane = (size_t)H * W;
  p.feat = work;
  p.bn = p.feat + bn * 8;
  p.q = p.bn + bn;
  p.m = p.q + bn * K;
  p.d0 = p.m + bn * K;
  p.d1 = p.d0 + (size_t)B * K * plane;
  p.bits = reinterpret_cast<uint32_t*>(p.d1 + (size_t)B * K * plane);
  p.tail = tail;
  return true;
}

// one cooperative launch of every phase: as many blocks as the card holds
// at once
template <bool kCoarse>
cudaError_t launch(Params p, int smem, unsigned* barrier, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      crf_kernel<kCoarse>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev, sms, per_sm;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
          cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, crf_kernel<kCoarse>,
                                                           kThreads, smem)) !=
          cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  p.barrier = barrier;
  int lo = 0, hi = num_phases(p);
  void* args[] = {&p, &lo, &hi};
  return cudaLaunchCooperativeKernel((const void*)crf_kernel<kCoarse>,
                                     dim3(sms * per_sm), dim3(kThreads), args,
                                     (size_t)smem, st);
}

}  // namespace

// du (B, K, H, W) f32; rgb (B, H, W, 3) uint8 (rgb_u8) or f32; taps, ah,
// aw the Gaussian constants; tile_h x tile_w the update tile and smem the
// shared memory per block (ops/crf_fused.py:launch_plan); work the
// workspace (crf_workspace_floats in ops/crf_fused.py); barrier two zeroed
// words; out (B, K, H, W) f32 0/1 masks.
extern "C" int crf_mean_field_f32(
    const float* du, const void* rgb, int rgb_u8, const float* taps, const float* ah,
    const float* aw, int B, int K, int H, int W, int stride, int radius,
    int num_iters, float gaussian_compat, float bilateral_compat, float sxy,
    float srgb, int closing_ksize, int tile_h, int tile_w, int smem, float* work,
    unsigned* barrier, float* out, void* stream_ptr) {
  Params p = {};
  if (!setup(p, B, K, H, W, 1, stride, radius, num_iters, closing_ksize, tile_h,
             tile_w, smem, false, work))
    return (int)cudaErrorInvalidValue;
  p.du = du, p.rgb = rgb, p.rgb_u8 = rgb_u8, p.taps = taps, p.ah = ah, p.aw = aw;
  p.gc = gaussian_compat, p.bc = bilateral_compat, p.sxy = sxy, p.srgb = srgb;
  p.out = out;
  return (int)launch<false>(p, smem, barrier, (cudaStream_t)stream_ptr);
}

// du_coarse (B, K, H/f, W/f) f32, scores (B, K) f32 (0 for invalid
// candidates), cand_idx (B, K) int32 or (idx64) int64; the rest as above;
// out pred (B, H, W) int32, best_w (B, H, W) f32.
extern "C" int crf_decode_tail_f32(
    const float* du_coarse, const void* rgb, int rgb_u8, const float* taps,
    const float* ah, const float* aw, const float* scores, const void* cand_idx,
    int idx64, int B, int K, int H, int W, int du_factor, int stride, int radius,
    int num_iters, float gaussian_compat, float bilateral_compat, float sxy,
    float srgb, int closing_ksize, int tile_h, int tile_w, int smem, float* work,
    unsigned* barrier, int* pred, float* best_w, void* stream_ptr) {
  Params p = {};
  if (!setup(p, B, K, H, W, du_factor, stride, radius, num_iters, closing_ksize,
             tile_h, tile_w, smem, true, work))
    return (int)cudaErrorInvalidValue;
  p.du = du_coarse, p.rgb = rgb, p.rgb_u8 = rgb_u8, p.taps = taps, p.ah = ah;
  p.aw = aw, p.scores = scores, p.cand_idx = cand_idx, p.idx64 = idx64;
  p.gc = gaussian_compat, p.bc = bilateral_compat, p.sxy = sxy, p.srgb = srgb;
  p.pred = pred, p.best_w = best_w;
  return (int)launch<true>(p, smem, barrier, (cudaStream_t)stream_ptr);
}

// --------------------------------------------------------- the bf16 mode
//
// The TPU kernels' default compute_dtype, bfloat16
// (simseg_tpu/ops/crf_fused.py:315 mean_field_fused, :439
// seg_decode_tail_fused): the same function as above, rounded to bf16
// where the TPU kernel rounds:
//   - K_ij = exp(-max(sq_i + sq_j - 2 f_i.f_j, 0) / 2) in float32 (the
//     expanded distance of _build_kmat), stored as bf16; the degree summed
//     in float32 from the unrounded entries, bn = bf16(rsqrt(degree));
//   - the iterate d in bf16; each product with a constant matrix summed in
//     float32 and rounded to bf16: the two Gaussian passes (the bands'
//     entries, normalisation folded in, rounded to bf16 on the host), the
//     splat's row sums and then its column sums, K (bn q); the cell mean's
//     scale, bn q, m bn, gc G, bc B and each sum of the update rounded to
//     bf16, tanh of the bf16 argument rounded to bf16 (_mf_class);
//   - the closing on 0/1 masks (exact); bf16 masks out, or the tail's
//     argmax in float32.
// A simple design, in launches of its own, each a loop over independent
// items: the features; K and bn (B N^2 bf16 in the workspace, 54 MB at the
// main path's 16 images); d0; per iteration the splat, the message (a warp
// a row of K, the K classes at once, bn q staged in shared memory) and the
// update (a 32 x 32 tile with its radius-r halo in shared memory, the two
// Gaussian passes rounded between them); four closing passes over byte
// masks; the output. What bounds it at the main path's shape is the bytes:
// K written once and read once per iteration, the bf16 iterates and byte
// masks, some 0.3 GB through L2 and device memory; fusing passes, as the
// float32 kernel does, is later work.
namespace crf_bf16 {

constexpr int kThreads = 256;
constexpr int kTile = 32;             // update tile, outputs a side
constexpr int kMaxClasses = 8;
constexpr int kMaxRadius = 16;
constexpr int kHalo = kTile + 2 * kMaxRadius;
constexpr int kTaps = 2 * kMaxRadius + 1;
constexpr int kChunk = 1024;          // message cells staged per pass
constexpr int kRowsPerWarp = 2;       // message rows
constexpr int kRowsPerBlock = kRowsPerWarp * kThreads / 32;

struct Params {
  const float* du;          // (B, K, H, W), or (B, K, H/f, W/f) for the tail
  const void* rgb;          // (B, H, W, 3) uint8 or float32
  const float* wtab;        // (W, 2r+1): bandw[x + t - r, x], bf16 values
  const float* htab;        // (H, 2r+1): bandh[y, y + t - r], bf16 values
  const float* scores;      // tail: (B, K)
  const void* cand_idx;     // tail: (B, K) int32 or int64
  float* feat;              // (B, N, 8): the 5 features, [5] = |f|^2
  float* bn;                // (B, N) bf16 values
  float* v;                 // (B, K, N) bn q, bf16 values
  float* m;                 // (B, K, N) bn K (bn q), bf16 values
  __nv_bfloat16* d[2];      // (B, K, H, W) iterates
  uint8_t* mk[2];           // (B, K, H, W) 0/1 masks
  __nv_bfloat16* kmat;      // (B, N, N)
  __nv_bfloat16* out;       // mean field: (B, K, H, W) 0/1 masks
  int* pred;                // tail: (B, H, W)
  float* best_w;            // tail: (B, H, W)
  int B, K, H, W, f, s, radius, iters, ck, rgb_u8, idx64;
  float gc, bc, scale, sxy, srgb;   // gc, bc and scale are bf16 values
  int N, ws;
};

__device__ __forceinline__ float rbf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// du rounded to bf16: the fine map, or the patch grid at (y / f, x / f)
__device__ __forceinline__ float unary(const Params& p, int pl, int y, int x) {
  if (p.f == 1) return rbf(__ldg(p.du + ((size_t)pl * p.H + y) * p.W + x));
  const int gw = p.W / p.f;
  return rbf(__ldg(p.du + ((size_t)pl * (p.H / p.f) + y / p.f) * gw + x / p.f));
}

// a thread a cell: the box-mean colour and the features (as
// ops/crf.py:bilateral_features) and their squared norm
__global__ void feat_kernel(Params p) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= p.B * p.N) return;
  const int b = c / p.N, i = c - b * p.N, cy = i / p.ws, cx = i - cy * p.ws;
  const int s = p.s;
  float sum[3] = {0.f, 0.f, 0.f};
  for (int y = 0; y < s; ++y) {
    const size_t row = ((size_t)b * p.H + (size_t)cy * s + y) * p.W + (size_t)cx * s;
    for (int x = 0; x < s; ++x)
      for (int ch = 0; ch < 3; ++ch) {
        const size_t o = (row + x) * 3 + ch;
        sum[ch] += p.rgb_u8 ? (float)__ldg((const uint8_t*)p.rgb + o)
                            : __ldg((const float*)p.rgb + o);
      }
  }
  float fv[5];
  fv[0] = __fsub_rn(__fmul_rn((float)cy + 0.5f, (float)s), 0.5f) / p.sxy;
  fv[1] = __fsub_rn(__fmul_rn((float)cx + 0.5f, (float)s), 0.5f) / p.sxy;
  for (int ch = 0; ch < 3; ++ch) fv[2 + ch] = sum[ch] / (float)(s * s) / p.srgb;
  float sq = 0.f;
  float* out = p.feat + (size_t)c * 8;
  for (int t = 0; t < 5; ++t) {
    out[t] = fv[t];
    sq = __fadd_rn(sq, __fmul_rn(fv[t], fv[t]));
  }
  out[5] = sq;
}

// a warp a row i of image b's K: bf16 entries, bn_i from the float32 sum
__global__ void kmat_kernel(Params p) {
  const int b = blockIdx.y, lane = threadIdx.x & 31;
  const int i = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (i >= p.N) return;  // the whole warp
  const float* fb = p.feat + (size_t)b * p.N * 8;
  float fi[6];
  for (int t = 0; t < 6; ++t) fi[t] = __ldg(fb + (size_t)i * 8 + t);
  __nv_bfloat16* row = p.kmat + ((size_t)b * p.N + i) * p.N;
  float acc = 0.f;
  for (int j = lane; j < p.N; j += 32) {
    const float* fj = fb + (size_t)j * 8;
    float dot = 0.f;
    for (int t = 0; t < 5; ++t) dot = __fadd_rn(dot, __fmul_rn(fi[t], __ldg(fj + t)));
    const float d2 = __fsub_rn(__fadd_rn(fi[5], __ldg(fj + 5)), __fmul_rn(2.f, dot));
    const float k = expf(-0.5f * fmaxf(d2, 0.f));
    row[j] = __float2bfloat16_rn(k);
    acc += k;
  }
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.bn[(size_t)b * p.N + i] = rbf(1.f / sqrtf(acc + 1e-20f));
}

// d0 = tanh(du / 2) in bf16; with no iteration, its sign is the mask
__global__ void init_kernel(Params p) {
  const int pl = blockIdx.y, e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= p.H * p.W) return;
  const int y = e / p.W, x = e - y * p.W;
  const float d = rbf(tanhf(rbf(unary(p, pl, y, x) * 0.5f)));
  const size_t o = (size_t)pl * p.H * p.W + e;
  if (p.iters == 0) p.mk[0][o] = d > 0.f;
  else p.d[0][o] = __float2bfloat16_rn(d);
}

// a thread a cell of plane pl: q = (column sum of the s row sums) * scale,
// each rounded to bf16, and bn q
__global__ void splat_kernel(Params p, const __nv_bfloat16* cur) {
  const int pl = blockIdx.y, c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= p.N) return;
  const int b = pl / p.K, cy = c / p.ws, cx = c - cy * p.ws, s = p.s;
  const __nv_bfloat16* d = cur + (size_t)pl * p.H * p.W + (size_t)cy * s * p.W + cx * s;
  float col = 0.f;
  for (int y = 0; y < s; ++y) {
    float row = 0.f;
    for (int x = 0; x < s; ++x) row += __bfloat162float(d[(size_t)y * p.W + x]);
    col += rbf(row);
  }
  const float q = rbf(rbf(col) * p.scale);
  p.v[(size_t)pl * p.N + c] = rbf(q * __ldg(p.bn + (size_t)b * p.N + c));
}

// rows j of image b, kRowsPerWarp a warp, the lanes over the cells i:
// m[b, k, j] = bn_j sum_i K_ji (bn q)[b, k, i], the sum rounded to bf16,
// then the product
__global__ void message_kernel(Params p) {
  __shared__ float s_v[kMaxClasses * kChunk];
  const int b = blockIdx.y, tid = threadIdx.x, lane = tid & 31;
  const int j0 = blockIdx.x * kRowsPerBlock + (tid >> 5) * kRowsPerWarp;
  const int N = p.N, K = p.K;
  float acc[kRowsPerWarp][kMaxClasses];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int k = 0; k < kMaxClasses; ++k) acc[r][k] = 0.f;
  for (int c0 = 0; c0 < N; c0 += kChunk) {
    const int cn = min(kChunk, N - c0);
    __syncthreads();
    for (int t = tid; t < K * cn; t += kThreads) {
      const int k = t / cn, i = t - k * cn;
      s_v[k * kChunk + i] = p.v[((size_t)b * K + k) * N + c0 + i];
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int j = j0 + r;
      if (j >= N) break;
      const __nv_bfloat16* krow = p.kmat + ((size_t)b * N + j) * N + c0;
      for (int i = lane; i < cn; i += 32) {
        const float kv = __bfloat162float(krow[i]);
#pragma unroll
        for (int k = 0; k < kMaxClasses; ++k)
          if (k < K) acc[r][k] = fmaf(kv, s_v[k * kChunk + i], acc[r][k]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int k = 0; k < kMaxClasses; ++k)
      for (int off = 16; off > 0; off >>= 1)
        acc[r][k] += __shfl_xor_sync(0xffffffffu, acc[r][k], off);
  if (lane != 0) return;
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int j = j0 + r;
    if (j >= N) break;
    const float bj = p.bn[(size_t)b * N + j];
    for (int k = 0; k < K; ++k)
      p.m[((size_t)b * K + k) * N + j] = rbf(rbf(acc[r][k]) * bj);
  }
}

// one 32 x 32 tile of plane pl: G(d) by rows then columns (each pass
// rounded to bf16), the update, and d' (or, at the last iteration, d' > 0)
__global__ void update_kernel(Params p, const __nv_bfloat16* cur,
                              __nv_bfloat16* next, uint8_t* mask) {
  __shared__ float s_in[kHalo][kHalo + 1];
  __shared__ float s_row[kHalo][kTile + 1];
  __shared__ float s_wt[kTile][kTaps];
  __shared__ float s_ht[kTile][kTaps];
  const int H = p.H, W = p.W, R = p.radius, taps = 2 * R + 1, tid = threadIdx.x;
  const int pl = blockIdx.y, tiles_x = (W + kTile - 1) / kTile;
  const int tyi = blockIdx.x / tiles_x, txi = blockIdx.x - tyi * tiles_x;
  const int y0 = tyi * kTile, x0 = txi * kTile;
  const int rows = kTile + 2 * R, cols = kTile + 2 * R;
  const __nv_bfloat16* src = cur + (size_t)pl * H * W;
  for (int t = tid; t < rows * cols; t += kThreads) {
    const int r = t / cols, c = t - r * cols, y = y0 - R + r, x = x0 - R + c;
    s_in[r][c] = y >= 0 && y < H && x >= 0 && x < W
                     ? __bfloat162float(src[(size_t)y * W + x]) : 0.f;
  }
  for (int t = tid; t < kTile * taps; t += kThreads) {
    const int o = t / taps, k = t - o * taps;
    s_wt[o][k] = x0 + o < W ? __ldg(p.wtab + (size_t)(x0 + o) * taps + k) : 0.f;
    s_ht[o][k] = y0 + o < H ? __ldg(p.htab + (size_t)(y0 + o) * taps + k) : 0.f;
  }
  __syncthreads();
  for (int t = tid; t < rows * kTile; t += kThreads) {
    const int r = t / kTile, o = t - r * kTile;
    float a = 0.f;
    for (int k = 0; k < taps; ++k) a = fmaf(s_wt[o][k], s_in[r][o + k], a);
    s_row[r][o] = rbf(a);
  }
  __syncthreads();
  const size_t pbase = (size_t)pl * H * W;
  for (int t = tid; t < kTile * kTile; t += kThreads) {
    const int oy = t / kTile, ox = t - oy * kTile, y = y0 + oy, x = x0 + ox;
    if (y >= H || x >= W) continue;
    float a = 0.f;
    for (int k = 0; k < taps; ++k) a = fmaf(s_ht[oy][k], s_row[oy + k][ox], a);
    const float g = rbf(a);
    const float mv = p.m[(size_t)pl * p.N + (y / p.s) * p.ws + x / p.s];
    float u = rbf(unary(p, pl, y, x) + rbf(p.gc * g));
    u = rbf(u + rbf(p.bc * mv));
    const float dn = rbf(tanhf(rbf(u * 0.5f)));
    const size_t o = pbase + (size_t)y * W + x;
    if (mask) mask[o] = dn > 0.f;
    else next[o] = __float2bfloat16_rn(dn);
  }
}

// one pass of the k x k closing over byte masks, along y or x: OR (dilate)
// or AND (erode) over the taps of [v - k / 2, v + k - 1 - k / 2] that lie
// inside the image (ops/morphology.py's window)
__global__ void close_kernel(Params p, const uint8_t* in, uint8_t* out, int along_y,
                             int erode) {
  const int pl = blockIdx.y, e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= p.H * p.W) return;
  const int y = e / p.W, x = e - y * p.W, a = p.ck / 2, z = p.ck - 1 - a;
  const uint8_t* src = in + (size_t)pl * p.H * p.W;
  int acc = erode;
  if (along_y) {
    for (int yy = max(0, y - a); yy <= min(p.H - 1, y + z); ++yy)
      acc = erode ? acc & src[(size_t)yy * p.W + x] : acc | src[(size_t)yy * p.W + x];
  } else {
    const uint8_t* row = src + (size_t)y * p.W;
    for (int xx = max(0, x - a); xx <= min(p.W - 1, x + z); ++xx)
      acc = erode ? acc & row[xx] : acc | row[xx];
  }
  out[(size_t)pl * p.H * p.W + e] = (uint8_t)acc;
}

__global__ void masks_out_kernel(Params p, const uint8_t* mask) {
  const int pl = blockIdx.y, e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= p.H * p.W) return;
  const size_t o = (size_t)pl * p.H * p.W + e;
  p.out[o] = __float2bfloat16_rn(mask[o] ? 1.f : 0.f);
}

// the tail: a pixel's best mask * scores[b, k] by a strict '>' (argmax's
// first-occurrence rule), pred 0 where the best is <= 0
__global__ void argmax_kernel(Params p, const uint8_t* mask) {
  const int b = blockIdx.y, e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= p.H * p.W) return;
  float best = 0.f;
  int idx = 0;
  for (int c = 0; c < p.K; ++c) {
    const float wgt = (float)mask[((size_t)b * p.K + c) * p.H * p.W + e] *
                      __ldg(p.scores + b * p.K + c);
    const int ci = p.idx64 ? (int)__ldg((const long long*)p.cand_idx + b * p.K + c)
                           : __ldg((const int*)p.cand_idx + b * p.K + c);
    if (c == 0 || wgt > best) {
      best = wgt;
      idx = ci;
    }
  }
  const size_t o = (size_t)b * p.H * p.W + e;
  p.pred[o] = best > 0.f ? idx : 0;
  p.best_w[o] = best;
}

inline size_t align256(size_t n) { return (n + 255) & ~(size_t)255; }

// bytes of the workspace (ops/crf_fused.py:workspace_bytes_bf16): feat,
// bn, bn q, m, two iterates, two masks, K
inline size_t workspace_bytes(int B, int K, int H, int W, int s) {
  const size_t n = (size_t)(H / s) * (W / s), bn = (size_t)B * n;
  const size_t px = (size_t)B * K * H * W;
  return align256(bn * 8 * 4) + align256(bn * 4) + 2 * align256(bn * K * 4) +
         2 * align256(px * 2) + 2 * align256(px) + align256(bn * n * 2);
}

bool setup(Params& p, int B, int K, int H, int W, int f, int s, int radius,
           int iters, int ck, void* work, long long work_bytes) {
  if (B < 1 || K < 1 || K > kMaxClasses || H < 1 || W < 1 || radius < 0 ||
      radius > kMaxRadius || s < 1 || H % s || W % s || iters < 0 || f < 1 ||
      H % f || W % f || (long long)H * W >= (1ll << 30) || B * K > 65535 ||
      work_bytes < (long long)workspace_bytes(B, K, H, W, s))
    return false;
  p.B = B, p.K = K, p.H = H, p.W = W, p.f = f, p.s = s, p.radius = radius;
  p.iters = iters, p.ck = ck > 1 ? ck : 1;
  p.ws = W / s;
  p.N = (H / s) * p.ws;
  const size_t bn = (size_t)B * p.N, px = (size_t)B * K * H * W;
  char* w = (char*)work;
  p.feat = (float*)w, w += align256(bn * 8 * 4);
  p.bn = (float*)w, w += align256(bn * 4);
  p.v = (float*)w, w += align256(bn * K * 4);
  p.m = (float*)w, w += align256(bn * K * 4);
  for (int i = 0; i < 2; ++i) p.d[i] = (__nv_bfloat16*)w, w += align256(px * 2);
  for (int i = 0; i < 2; ++i) p.mk[i] = (uint8_t*)w, w += align256(px);
  p.kmat = (__nv_bfloat16*)w;
  return true;
}

// every launch of a call on stream st, the error of the first that fails
cudaError_t run(const Params& p, bool tail, cudaStream_t st) {
  const int planes = p.B * p.K, hw = p.H * p.W;
  const dim3 px(cdiv(hw, kThreads), planes), cells(cdiv(p.N, kThreads), planes);
  cudaError_t err;
#define CRF_BF16_LAUNCH(kernel, grid, ...)              \
  kernel<<<grid, kThreads, 0, st>>>(__VA_ARGS__);        \
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (p.iters > 0) {
    CRF_BF16_LAUNCH(feat_kernel, dim3(cdiv(p.B * p.N, kThreads)), p)
    CRF_BF16_LAUNCH(kmat_kernel, dim3(cdiv(p.N, kThreads / 32), p.B), p)
  }
  CRF_BF16_LAUNCH(init_kernel, px, p)
  const int tiles = cdiv(p.H, kTile) * cdiv(p.W, kTile);
  for (int it = 0; it < p.iters; ++it) {
    const bool last = it == p.iters - 1;
    CRF_BF16_LAUNCH(splat_kernel, cells, p, p.d[it & 1])
    CRF_BF16_LAUNCH(message_kernel, dim3(cdiv(p.N, kRowsPerBlock), p.B), p)
    CRF_BF16_LAUNCH(update_kernel, dim3(tiles, planes), p, p.d[it & 1],
                    last ? nullptr : p.d[(it + 1) & 1], last ? p.mk[0] : nullptr)
  }
  if (p.ck > 1) {
    CRF_BF16_LAUNCH(close_kernel, px, p, p.mk[0], p.mk[1], 0, 0)
    CRF_BF16_LAUNCH(close_kernel, px, p, p.mk[1], p.mk[0], 1, 0)
    CRF_BF16_LAUNCH(close_kernel, px, p, p.mk[0], p.mk[1], 0, 1)
    CRF_BF16_LAUNCH(close_kernel, px, p, p.mk[1], p.mk[0], 1, 1)
  }
  if (tail) {
    CRF_BF16_LAUNCH(argmax_kernel, dim3(cdiv(hw, kThreads), p.B), p, p.mk[0])
  } else {
    CRF_BF16_LAUNCH(masks_out_kernel, px, p, p.mk[0])
  }
#undef CRF_BF16_LAUNCH
  return cudaSuccess;
}

}  // namespace crf_bf16

// The bf16 mode of crf_mean_field_f32: du (B, K, H, W) f32 (rounded to
// bf16 on reading); wtab (W, 2 radius + 1) and htab (H, 2 radius + 1) the
// Gaussian bands' entries rounded to bf16 (ops/crf_fused.py:bf16_tables);
// gc, bc and scale (1 / stride^2) rounded to bf16; work a workspace of
// work_bytes (ops/crf_fused.py:workspace_bytes_bf16); out (B, K, H, W)
// bf16 0/1 masks.
extern "C" int crf_mean_field_bf16(
    const float* du, const void* rgb, int rgb_u8, const float* wtab, const float* htab,
    int B, int K, int H, int W, int stride, int radius, int num_iters,
    float gaussian_compat, float bilateral_compat, float scale, float sxy, float srgb,
    int closing_ksize, void* work, long long work_bytes, void* out, void* stream_ptr) {
  crf_bf16::Params p = {};
  if (!crf_bf16::setup(p, B, K, H, W, 1, stride, radius, num_iters, closing_ksize,
                       work, work_bytes))
    return (int)cudaErrorInvalidValue;
  p.du = du, p.rgb = rgb, p.rgb_u8 = rgb_u8, p.wtab = wtab, p.htab = htab;
  p.gc = gaussian_compat, p.bc = bilateral_compat, p.scale = scale;
  p.sxy = sxy, p.srgb = srgb;
  p.out = (__nv_bfloat16*)out;
  return (int)crf_bf16::run(p, false, (cudaStream_t)stream_ptr);
}

// The bf16 mode of crf_decode_tail_f32: du_coarse (B, K, H/f, W/f) f32,
// scores (B, K) f32, cand_idx (B, K) int32 or (idx64) int64, the rest as
// crf_mean_field_bf16; out pred (B, H, W) int32, best_w (B, H, W) f32.
extern "C" int crf_decode_tail_bf16(
    const float* du_coarse, const void* rgb, int rgb_u8, const float* wtab,
    const float* htab, const float* scores, const void* cand_idx, int idx64, int B,
    int K, int H, int W, int du_factor, int stride, int radius, int num_iters,
    float gaussian_compat, float bilateral_compat, float scale, float sxy, float srgb,
    int closing_ksize, void* work, long long work_bytes, int* pred, float* best_w,
    void* stream_ptr) {
  crf_bf16::Params p = {};
  if (!crf_bf16::setup(p, B, K, H, W, du_factor, stride, radius, num_iters,
                       closing_ksize, work, work_bytes))
    return (int)cudaErrorInvalidValue;
  p.du = du_coarse, p.rgb = rgb, p.rgb_u8 = rgb_u8, p.wtab = wtab, p.htab = htab;
  p.scores = scores, p.cand_idx = cand_idx, p.idx64 = idx64;
  p.gc = gaussian_compat, p.bc = bilateral_compat, p.scale = scale;
  p.sxy = sxy, p.srgb = srgb;
  p.pred = pred, p.best_w = best_w;
  return (int)crf_bf16::run(p, true, (cudaStream_t)stream_ptr);
}

extern "C" const char* crf_mean_field_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
