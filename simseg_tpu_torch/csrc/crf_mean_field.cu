// Mean-field dense CRF (binary label-difference form) + binary closing,
// and the whole decode tail, for Hopper (sm_90a), float32. The same two
// entry points in the TPU kernels' bf16 mode are crf_mean_field_bf16.cu;
// what both share (the parameters, the phases, the grid barrier, the
// closing, the launch) is crf_common.cuh.
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

#include "crf_common.cuh"

namespace {

constexpr int kRows = 40;         // message rows per item, kRowsPerWarp a warp
constexpr int kRowsPerWarp = kRows / kWarps;
constexpr int kChunk = 512;       // message cells staged per tile
// sqrt(log2(e) / 2): exp(-|f_i - f_j|^2 / 2) = exp2(-|g_i - g_j|^2), g = c f
constexpr float kFeatScale = 0.84932180028801904f;

__host__ __device__ inline float* iterate(const Params& p, int i) {
  return (i & 1) ? p.d1 : p.d0;
}

__host__ __device__ inline int phase_items(const Params& p, int ph) {
  const Phase phase = phase_at(p, ph);
  int n = 0;
  for (int kind = 1; kind <= kClose; kind <<= 1)
    if (phase.kinds & kind) n += items_of(p, kind, kRows);
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
    const int n = items_of(p, kind, kRows);
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
      case kClose:
        close_dispatch<kCoarse, false>(p, item, smem);
        break;
    }
    return;
  }
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
  need = imax(need, close_words(K, H, W, ck, tail));
  if (iters > 0) need = imax(need, 3 * W);  // a cell row's column sums
  return need * 4;
}

// fills p from the call's arguments and carves the workspace: feat (B, N,
// 8), bn (B, N), q and m (B, K, N), two iterates (B, K, H, W), the mask
// bits (B, K, H, ceil(W / 32)) words
bool setup(Params& p, int B, int K, int H, int W, int f, int stride, int radius,
           int iters, int ck, int TH, int TW, int smem, bool tail, float* work) {
  if (!setup_shape(p, B, K, H, W, f, stride, radius, iters, ck, TH, TW, tail) ||
      smem > kSmemLimit || smem < smem_need(K, H, W, TH, TW, radius, iters, p.ck, tail))
    return false;
  const size_t bn = (size_t)B * p.N, plane = (size_t)H * W;
  p.feat = work;
  p.bn = p.feat + bn * 8;
  p.q = p.bn + bn;
  p.m = p.q + bn * K;
  p.d0 = p.m + bn * K;
  p.d1 = p.d0 + (size_t)B * K * plane;
  p.bits = reinterpret_cast<uint32_t*>(p.d1 + (size_t)B * K * plane);
  return true;
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
  return (int)launch(crf_kernel<false>, p, smem, barrier, (cudaStream_t)stream_ptr);
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
  return (int)launch(crf_kernel<true>, p, smem, barrier, (cudaStream_t)stream_ptr);
}

extern "C" const char* crf_mean_field_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
