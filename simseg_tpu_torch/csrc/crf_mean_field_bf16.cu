// The CRF kernels of crf_mean_field.cu in the TPU kernels' default
// compute_dtype, bfloat16 (simseg_tpu/ops/crf_fused.py:315 mean_field_fused,
// :439 seg_decode_tail_fused), for Hopper (sm_90a): the same function,
// rounded to bf16 where the TPU kernel rounds (_build_kmat, _mf_class):
//   - K_ij = exp(-max(sq_i + sq_j - 2 f_i.f_j, 0) / 2) in float32 (the
//     expanded distance), rounded to bf16 as a matrix entry; the degree
//     summed in float32 from the unrounded entries, bn = bf16(rsqrt(degree));
//   - the iterate d in bf16; each product with a constant matrix summed in
//     float32 and rounded to bf16: the two Gaussian passes (the bands'
//     entries, normalisation folded in, rounded to bf16 on the host,
//     ops/crf_fused.py:bf16_tables), the splat's row sums and then its
//     column sums, K (bn q); the cell mean's scale, bn q, m bn, gc G, bc B
//     and each sum of the update rounded to bf16, tanh of the bf16 argument
//     rounded to bf16;
//   - the closing on 0/1 masks (exact); bf16 masks out, or the tail's
//     argmax in float32.
//
// What bounds it at the main path's shape (16 images of 288^2, K = 5,
// s = 8, N = 1296, radius 9, 3 iterations): the K entries, N^2 per image and
// bilateral pass, each a float32 distance and exponential (four passes: the
// degree and three messages), and the update's two Gaussian passes and bf16
// chain; the bytes (du read, a bf16 iterate read and written per iteration)
// are some 60 MB. The design is the float32 kernel's, fitted to the bf16
// numerics:
//   - one cooperative launch runs every phase, a grid barrier between two,
//     with the float32 kernel's phase loop, barrier words and closing
//     (crf_common.cuh): the features and d0 with its cell means; the degree
//     (and zeroing the mask bits); per iteration the message and the update;
//     the closing on bit-packed masks (and the tail's argmax);
//   - K is never stored: the degree and message phases recompute its rows
//     from the features, in float32 as JAX does, and round each entry to
//     bf16 in registers;
//   - the message on the tensor cores: mma.sync m16n8k16, bf16 x bf16 ->
//     float32, 16 rows of K (the A operand, built in registers) against bn q
//     of 16 cells and the 8 class slots (the B operand); bf16 products are
//     exact in float32 and the sum is float32, as the MXU's dot with
//     preferred_element_type=float32. A block takes a contiguous run of
//     16-row groups (mostly of one image: its features stay in L1), its
//     8 warps a fixed eighth of the cells each, the eight partial sums
//     added in warp order: the same bits on every call, whatever the grid;
//   - the update: a tile of whole stride cells (up to 32 x 64) with its
//     radius-r halo of the bf16 iterate copied in one cp.async batch (bf16,
//     a row pitch odd in words); both Gaussian passes register-blocked 8
//     outputs a thread (the window in registers, the loops unrolled to the
//     radius, a template argument). The bands' entries differ per output
//     only near the border: a strip of the interior takes its taps into
//     registers once, the others read each output's row of the table as
//     float4 through L1 (a warp's lanes share the strip: 32 rows in the row
//     pass, 32 columns in the column pass, so each read is one address).
//     The tables are per call's map, not per tile: nothing to copy. The
//     column pass loads the strip's unaries and messages before its band
//     sums, so their latency overlaps the sums, and runs the 8 outputs'
//     bf16 chains side by side; the next iteration's splat (bn q of the
//     tile's cells) is taken in the same item; the last update writes
//     d > 0 as mask bits;
//   - du is read once a call by the first phase (the fine map, or the patch
//     grid at (y / f, x / f)) and once per update for the tile's unaries;
//   - 32-bit index math inside a map; every reduction in a fixed order.
// The iterates are bf16 with rows padded to an even pitch (4-byte copies);
// no (B, N, N) buffer exists. Strides past 32 run the cell means as a
// phase of their own, as in float32.
//
// Where the numerics are not defined bit for bit (an order of summation),
// the kernel takes the plain version's (ops/crf_fused.py): |f|^2 summed in
// the order of PyTorch's sum over five entries, exp and tanh the accurate
// float32 functions. Departures from a first design, each timed on the
// card (chip_smoke.py 16a prints the time of each phase): per-output taps
// copied into shared memory with every tile were slower than the tables
// read through L1, so the tables stay in global memory; double-buffering the
// halo copies and a splat in warp shuffles each slowed the update (both
// raise the register count past the 128 a thread that two blocks a
// multiprocessor allow); du is read as float32, not stored once as bf16:
// the update is bound by its instruction latency, not by bytes.
//
// Launches are on the caller's stream; the host functions return the launch
// error as an int (0 = cudaSuccess) and allocate nothing: the caller passes
// the workspace (ops/crf_fused.py:workspace_bytes_bf16) and the grid
// barrier's two words (shared with the float32 kernels: calls on one stream
// run in order).

#include "crf_common.cuh"

namespace {

__device__ __forceinline__ float rbf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// tanh(u / 2) of a bf16 u, as JAX's bf16 tanh(u * half): each step rounded
__device__ __forceinline__ float tanh_half(float u) {
  return rbf(tanhf(rbf(u * 0.5f)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// bn q of cell c, class k of image b, in the message's B-operand layout
__device__ __forceinline__ void put_v(const Params& p, int b, int c, int k, float v) {
  p.v[(((size_t)b * (p.Np >> 1) + (c >> 1)) * 8 + k) * 2 + (c & 1)] =
      __float2bfloat16_rn(v);
}

// features of the cells of cell row cy of image b (ops/crf.py:
// bilateral_features) and their squared norm, by cell pair: (f0, f0', f1,
// f1', ..., f4, f4', sq, sq') for cells 2i, 2i + 1; the last row also
// fills the padding cells N .. Np - 1 (features 0, sq = inf: every K entry
// with them is exactly 0)
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
  float* fb = p.feat + (size_t)b * p.Np * 6;
  for (int cx = threadIdx.x; cx < p.ws; cx += kThreads) {
    float sum[3] = {0.f, 0.f, 0.f};
    for (int x = 0; x < s; ++x)
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) sum[ch] += smem[(cx * s + x) * 3 + ch];
    float fv[6];
    fv[0] = __fsub_rn(__fmul_rn((float)cy + 0.5f, (float)s), 0.5f) / p.sxy;
    fv[1] = __fsub_rn(__fmul_rn((float)cx + 0.5f, (float)s), 0.5f) / p.sxy;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) fv[2 + ch] = sum[ch] / (float)(s * s) / p.srgb;
    // |f|^2 in the order of PyTorch's sum over the last five entries, the
    // plain version's: (f0^2 + f4^2) + f2^2, plus f1^2 + f3^2
    float sq[5];
#pragma unroll
    for (int t = 0; t < 5; ++t) sq[t] = __fmul_rn(fv[t], fv[t]);
    fv[5] = __fadd_rn(__fadd_rn(__fadd_rn(sq[0], sq[4]), sq[2]), __fadd_rn(sq[1], sq[3]));
    const int c = cy * p.ws + cx;
    float* o = fb + (size_t)(c >> 1) * 12 + (c & 1);
#pragma unroll
    for (int t = 0; t < 6; ++t) o[2 * t] = fv[t];
  }
  if (cy != p.hs - 1) return;
  for (int c = p.N + threadIdx.x; c < p.Np; c += kThreads) {
    float* o = fb + (size_t)(c >> 1) * 12 + (c & 1);
#pragma unroll
    for (int t = 0; t < 5; ++t) o[2 * t] = 0.f;
    o[10] = __int_as_float(0x7f800000);
  }
}

// The cell means of cell row cy of plane pl, rounded as JAX's box
// products: each row's s values summed and rounded, the s row sums summed
// and rounded, times 1 / s^2 rounded. A thread takes a row segment of one
// cell (its s loads issued together), the row sums meet in shared memory
// (W floats). it = -1: of d0 = tanh(du / 2), which goes to the first
// iterate, the means to m (bn is not known yet); else of the iterate after
// iteration it (strides too wide for a tile of whole cells), bn q to v.
template <bool kCoarse>
__device__ void splat_item(const Params& p, int pl, int cy, int it, float* smem) {
  const int s = p.s, f = p.f, W = p.W, Wp = p.Wp, ws = p.ws;
  const size_t o = ((size_t)pl * p.H + (size_t)cy * s) * Wp;
  __syncthreads();  // the previous item is done with shared memory
  for (int seg = threadIdx.x; seg < W; seg += kThreads) {
    const int r = seg / ws, cx = seg - r * ws, x0 = cx * s;
    float row = 0.f;
    if (it >= 0) {
      const __nv_bfloat16* src = p.e[(it + 1) & 1] + o + (size_t)r * Wp + x0;
#pragma unroll 8
      for (int x = 0; x < s; ++x) row += __bfloat162float(src[x]);
    } else {
      __nv_bfloat16* dst = p.e[0] + o + (size_t)r * Wp + x0;
      if (!kCoarse) {
        const float* src = p.du + ((size_t)pl * p.H + (size_t)cy * s + r) * W + x0;
#pragma unroll 8
        for (int x = 0; x < s; ++x) {
          const float d = tanh_half(rbf(__ldg(src + x)));
          dst[x] = __float2bfloat16_rn(d);
          row += d;
        }
      } else {
        // the patch grid at (y / f, x / f), the quotient along x kept by
        // counting
        const int gw = W / f;
        const float* src = p.du + ((size_t)pl * (p.H / f) + (cy * s + r) / f) * gw;
        int xq = x0 / f, xr = x0 - xq * f;
        for (int x = 0; x < s; ++x) {
          const float d = tanh_half(rbf(__ldg(src + xq)));
          dst[x] = __float2bfloat16_rn(d);
          row += d;
          if (++xr == f) xr = 0, ++xq;
        }
      }
    }
    smem[seg] = rbf(row);
  }
  __syncthreads();
  const int b = pl / p.K;
  for (int cx = threadIdx.x; cx < ws; cx += kThreads) {
    float col = 0.f;
    for (int r = 0; r < s; ++r) col += smem[r * ws + cx];
    const float q = rbf(rbf(col) * p.scale);
    const int c = cy * ws + cx;
    if (it < 0) p.m[(size_t)pl * p.N + c] = q;
    else put_v(p, b, c, pl - b * p.K, rbf(q * __ldcg(p.bn + (size_t)b * p.Np + c)));
  }
}

// K_ij of _build_kmat: sq_i + sq_j - 2 f_i.f_j in float32, clamped at 0,
// exp(-x / 2); fi holds row i's five features and sq
__device__ __forceinline__ float kentry(const float* fi, float g0, float g1, float g2,
                                        float g3, float g4, float sq) {
  float dot = fi[0] * g0;
  dot = fmaf(fi[1], g1, dot);
  dot = fmaf(fi[2], g2, dot);
  dot = fmaf(fi[3], g3, dot);
  dot = fmaf(fi[4], g4, dot);
  const float d2 = fmaf(-2.f, dot, fi[5] + sq);
  return expf(-0.5f * fmaxf(d2, 0.f));
}

// Rows j0 .. j0 + 15 of image b's K (row group rg), by the whole block:
// warp w takes the 16-cell steps w, w + 8, ... and the block adds the eight
// partial sums in warp order.
//   kDeg:  bn_j = bf16(rsqrt(sum_i K_ij + 1e-20)) from the unrounded
//          entries, and v_j = bf16(q_j bn_j) of every class from the cell
//          means of d0 in m (0 for padding cells and class slots);
//   else:  m_j = bf16(bf16(sum_i bf16(K_ji) v_i) bn_j) on the tensor cores.
template <bool kDeg>
__device__ void bilateral_rows(const Params& p, int rg, float* smem) {
  const int per = p.Np >> 4, b = rg / per, j0 = (rg - b * per) << 4;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const float4* F = reinterpret_cast<const float4*>(p.feat) + (size_t)b * per * 24;
  const uint32_t* V = reinterpret_cast<const uint32_t*>(p.v) + (size_t)b * per * 64;
  float fr[2][6];  // this lane's rows of K: j0 + g and j0 + g + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = j0 + g + 8 * r, h = j & 1;
    const float4* fj = F + (j >> 1) * 3;
    const float4 a = fj[0], c = fj[1], d = fj[2];
    fr[r][0] = h ? a.y : a.x;
    fr[r][1] = h ? a.w : a.z;
    fr[r][2] = h ? c.y : c.x;
    fr[r][3] = h ? c.w : c.z;
    fr[r][4] = h ? d.y : d.x;
    fr[r][5] = h ? d.w : d.z;
  }
  float acc[4] = {0.f, 0.f, 0.f, 0.f}, deg[2] = {0.f, 0.f};
  for (int ks = warp; ks < per; ks += kWarps) {
    // the lane's cells: 16 ks + 2t, + 1 (pair 8 ks + t) and + 8, + 9
    // (pair 8 ks + t + 4), the A fragment's columns
    float kv[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4* fc = F + (ks * 8 + t + 4 * h) * 3;
      const float4 a = fc[0], c = fc[1], d = fc[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        kv[r][2 * h] = kentry(fr[r], a.x, a.z, c.x, c.z, d.x, d.z);
        kv[r][2 * h + 1] = kentry(fr[r], a.y, a.w, c.y, c.w, d.y, d.w);
      }
    }
    if (kDeg) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) deg[r] += kv[r][c];
    } else {
      const uint32_t a0 = pack_bf16(kv[0][0], kv[0][1]), a1 = pack_bf16(kv[1][0], kv[1][1]);
      const uint32_t a2 = pack_bf16(kv[0][2], kv[0][3]), a3 = pack_bf16(kv[1][2], kv[1][3]);
      const uint32_t b0 = V[(ks * 8 + t) * 8 + g], b1 = V[(ks * 8 + t + 4) * 8 + g];
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
  }
  float* part = smem;  // [kWarps][128]: each warp's sums
  __syncthreads();     // the previous row group is done with them
  if (kDeg) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      deg[r] += __shfl_xor_sync(0xffffffffu, deg[r], 1);
      deg[r] += __shfl_xor_sync(0xffffffffu, deg[r], 2);
      if (t == 0) part[warp * 16 + g + 8 * r] = deg[r];
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) part[warp * 128 + lane * 4 + i] = acc[i];
  }
  __syncthreads();
  if (tid >= 128) return;
  const float* bnb = p.bn + (size_t)b * p.Np;
  if (kDeg) {  // a thread a (row, class slot)
    const int row = tid >> 3, k = tid & 7, j = j0 + row;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += part[w * 16 + row];
    const bool real = j < p.N;
    const float bnj = real ? rbf(1.f / sqrtf(sum + 1e-20f)) : 0.f;
    if (k == 0) p.bn[(size_t)b * p.Np + j] = bnj;
    put_v(p, b, j, k,
          real && k < p.K ? rbf(__ldcg(p.m + ((size_t)b * p.K + k) * p.N + j) * bnj) : 0.f);
  } else {     // a thread an accumulator: the C fragment's (row, class)
    const int ln = tid >> 2, i = tid & 3;
    const int j = j0 + (ln >> 2) + 8 * (i >> 1), k = 2 * (ln & 3) + (i & 1);
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += part[w * 128 + tid];
    if (j < p.N && k < p.K)
      p.m[((size_t)b * p.K + k) * p.N + j] = rbf(rbf(sum) * __ldcg(bnb + j));
  }
}

// shared-memory layout of an update tile (words), the same on the host
struct TileLayout {
  int thp, twp, pin, prow, in, rows, d, total;
};

__host__ __device__ inline TileLayout tile_layout(int TH, int TW, int radius) {
  TileLayout l;
  const int span = 2 * radius;
  l.thp = cdiv(TH, kStrip) * kStrip;
  l.twp = cdiv(TW, kStrip) * kStrip;
  const int cols = l.twp + span + 2;    // bf16: every strip's window
  l.pin = cols % 4 ? cols : cols + 2;   // bf16 pitch, odd in words
  l.prow = l.twp + 1;
  l.in = 0;
  l.rows = l.in + (l.thp + span) * l.pin / 2;
  l.d = l.rows + (l.thp + span) * l.prow;
  l.total = l.d + l.thp * l.prow;
  return l;
}

// the band sums of a strip's kStrip outputs: output o's taps (kSpan + 1,
// a table row of kTq float4, read through L1: the same for every lane of
// the warp) against the window w from w[o]; tap after tap for all outputs
// at once (kStrip independent sums), each in tap order
template <int kSpan>
__device__ __forceinline__ void band_strip(const float4* taps, const float* w, float* a) {
  constexpr int kTq = (kSpan + 4) / 4;
#pragma unroll
  for (int o = 0; o < kStrip; ++o) a[o] = 0.f;
#pragma unroll
  for (int q = 0; q < kTq; ++q) {
    float4 tv[kStrip];
#pragma unroll
    for (int o = 0; o < kStrip; ++o) tv[o] = __ldg(taps + o * kTq + q);
#pragma unroll
    for (int o = 0; o < kStrip; ++o) {
      if (4 * q + 0 <= kSpan) a[o] = fmaf(tv[o].x, w[o + 4 * q + 0], a[o]);
      if (4 * q + 1 <= kSpan) a[o] = fmaf(tv[o].y, w[o + 4 * q + 1], a[o]);
      if (4 * q + 2 <= kSpan) a[o] = fmaf(tv[o].z, w[o + 4 * q + 2], a[o]);
      if (4 * q + 3 <= kSpan) a[o] = fmaf(tv[o].w, w[o + 4 * q + 3], a[o]);
    }
  }
}

// band_strip for a strip whose outputs share one row of taps (the
// interior): the taps in registers, the same sums in the same order
template <int kSpan>
__device__ __forceinline__ void band_strip_uniform(const float4* taps, const float* w,
                                                   float* a) {
  constexpr int kTq = (kSpan + 4) / 4;
  float tap[4 * kTq];
#pragma unroll
  for (int q = 0; q < kTq; ++q) {
    const float4 tv = __ldg(taps + q);
    tap[4 * q] = tv.x, tap[4 * q + 1] = tv.y, tap[4 * q + 2] = tv.z, tap[4 * q + 3] = tv.w;
  }
#pragma unroll
  for (int o = 0; o < kStrip; ++o) a[o] = 0.f;
#pragma unroll
  for (int t = 0; t <= kSpan; ++t)
#pragma unroll
    for (int o = 0; o < kStrip; ++o) a[o] = fmaf(tap[t], w[o + t], a[o]);
}

// One tile of plane pl. Iteration it:
//   g = bf16(bandh (bf16(d bandw))) over the tile, from its halo,
//   d' = tanh((du + gc g + bc m[cell]) / 2) in bf16,
// d' into the next iterate, or, at the last iteration, d' > 0 into the mask
// bits; when the tile holds whole cells and d' is needed again, bn q of the
// tile's cells into v. kInit (no iteration): d0 > 0 into the mask bits.
template <int R, bool kCoarse, bool kInit>
__device__ void update_item(const Params& p, int pl, int tile, int it, float* smem) {
  constexpr int kSpan = 2 * R, kTq = (kSpan + 4) / 4;
  const int H = p.H, W = p.W, Wp = p.Wp, s = p.s, f = p.f;
  const bool last = kInit || it == p.iters - 1;
  const bool write_q = p.fused_splat && !last;
  const int tyi = tile / p.tiles_x, txi = tile - tyi * p.tiles_x;
  const int y0 = tyi * p.TH, x0 = txi * p.TW;
  const int th = min(p.TH, H - y0), tw = min(p.TW, W - x0);
  const int rows = th + kSpan;
  const TileLayout l = tile_layout(p.TH, p.TW, R);
  __nv_bfloat16* s_in = reinterpret_cast<__nv_bfloat16*>(smem + l.in);
  float* s_rows = smem + l.rows;
  float* s_d = smem + l.d;
  const int tid = threadIdx.x, lane = tid & 31;
  const float4* wtab = reinterpret_cast<const float4*>(p.wtab);
  const float4* htab = reinterpret_cast<const float4*>(p.htab);

  if (!kInit) {
    // the halo of the bf16 iterate by pairs, zero outside the image, in
    // one batch of copies; its first column even (4-byte copies)
    const int xs = (x0 - R) & ~1;
    __syncthreads();  // the previous item is done with shared memory
    const int npair = (x0 + tw + R - xs + 1) >> 1;
    const __nv_bfloat16* src = p.e[it & 1] + (size_t)pl * H * Wp;
    const int dr = kThreads / npair, dc = kThreads - dr * npair;
    int r = tid / npair, c = tid - r * npair;
    for (int i = tid; i < rows * npair; i += kThreads) {
      const int y = y0 - R + r, x = xs + 2 * c;
      const int bytes = y >= 0 && y < H && x >= 0 && x < W ? (x + 1 < W ? 4 : 2) : 0;
      cp_async4(s_in + r * l.pin + 2 * c, bytes ? src + (size_t)y * Wp + x : src, bytes);
      r += dr;
      c += dc;
      if (c >= npair) {
        c -= npair;
        ++r;
      }
    }
    cp_async_wait_all();
    __syncthreads();
    // along x: rows th + 2R (<= 64), strips of kStrip outputs; a warp's
    // lanes are 32 rows of one strip
    const int off = x0 - R - xs, strips = cdiv(tw, kStrip);
    for (int u = tid; u < 64 * strips; u += kThreads) {
      const int rr = u & 63, st = u >> 6;
      if (rr >= rows) continue;
      const __nv_bfloat16* srow = s_in + rr * l.pin + off + st * kStrip;
      float w[kStrip + kSpan];
#pragma unroll
      for (int k = 0; k < kStrip + kSpan; ++k) w[k] = __bfloat162float(srow[k]);
      const int xg = x0 + st * kStrip;  // the strip's first output column
      float a[kStrip];
      if (xg >= p.wlo && xg + kStrip - 1 <= p.whi)
        band_strip_uniform<kSpan>(wtab + (size_t)p.wlo * kTq, w, a);
      else
        band_strip<kSpan>(wtab + (size_t)xg * kTq, w, a);
#pragma unroll
      for (int o = 0; o < kStrip; ++o) s_rows[rr * l.prow + st * kStrip + o] = rbf(a[o]);
    }
    __syncthreads();
  }

  // along y and the update: columns tw (<= 64), strips of kStrip rows; a
  // warp's lanes are 32 neighbouring columns of one strip. The strip's
  // unaries and messages are loaded first (their rows and cells kept by
  // counting), and the band sums run while they arrive
  __nv_bfloat16* dst = last ? nullptr : p.e[(it + 1) & 1] + (size_t)pl * H * Wp;
  uint32_t* bits = p.bits + (size_t)pl * H * ((W + 31) >> 5);
  const float gc = p.gc, bc = p.bc;
  const int gw = W / f, ystrips = cdiv(th, kStrip);
  for (int u = tid; u < 64 * ystrips; u += kThreads) {
    const int xl = u & 63, ys = u >> 6;
    const bool active = xl < tw;
    const int x = x0 + xl, yg = y0 + ys * kStrip;
    float uv[kStrip], mv[kStrip];
    {
      const float* fine = p.du + ((size_t)pl * H + yg) * W + x;
      const float* coarse = p.du + (size_t)pl * (H / f) * gw + (active ? x / f : 0);
      const float* msg = p.m + (size_t)pl * p.N + (active ? x / s : 0);
      int yq = yg / f, yr = yg - yq * f, cy = yg / s, cr = yg - cy * s;
#pragma unroll
      for (int o = 0; o < kStrip; ++o) {
        const bool ok = active && ys * kStrip + o < th;
        uv[o] = ok ? __ldg(kCoarse ? coarse + (size_t)yq * gw : fine + (size_t)o * W) : 0.f;
        mv[o] = !kInit && ok ? __ldcg(msg + cy * p.ws) : 0.f;
        if (++yr == f) yr = 0, ++yq;
        if (++cr == s) cr = 0, ++cy;
      }
    }
    float g[kStrip];
#pragma unroll
    for (int o = 0; o < kStrip; ++o) g[o] = 0.f;
    if (!kInit && active) {
      const float* src = s_rows + ys * kStrip * l.prow + xl;
      float w[kStrip + kSpan];
#pragma unroll
      for (int k = 0; k < kStrip + kSpan; ++k)
        w[k] = ys * kStrip + k < rows ? src[k * l.prow] : 0.f;
      if (yg >= p.hlo && yg + kStrip - 1 <= p.hhi)
        band_strip_uniform<kSpan>(htab + (size_t)p.hlo * kTq, w, g);
      else
        band_strip<kSpan>(htab + (size_t)yg * kTq, w, g);
    }
    float dn[kStrip];
#pragma unroll
    for (int o = 0; o < kStrip; ++o) {
      const float du = rbf(uv[o]);
      dn[o] = kInit ? tanh_half(du)
                    : tanh_half(rbf(rbf(du + rbf(gc * rbf(g[o]))) + rbf(bc * mv[o])));
    }
#pragma unroll
    for (int o = 0; o < kStrip; ++o) {
      const int ty = ys * kStrip + o;
      if (ty >= th) break;  // the same for the whole warp
      const int y = y0 + ty;
      if (last) {
        // the warp's 32 columns start at x - lane: at most two words
        const uint32_t b = __ballot_sync(0xffffffffu, active && dn[o] > 0.f);
        const int xb = x - lane, q = xb >> 5, sh = xb & 31;
        uint32_t* row = bits + y * ((W + 31) >> 5);
        if (lane == 0 && (b << sh)) atomicOr(row + q, b << sh);
        if (lane == 0 && sh && (b >> (32 - sh))) atomicOr(row + q + 1, b >> (32 - sh));
      } else if (active) {
        dst[(size_t)y * Wp + x] = __float2bfloat16_rn(dn[o]);
        if (write_q) s_d[ty * l.prow + xl] = dn[o];
      }
    }
  }
  if (!write_q) return;
  // the next splat: each row's s columns, then each cell's s rows (over
  // s_rows, which the Gaussian is done with), then bn q
  __syncthreads();
  const int ncx = tw / s, ncells = (th / s) * ncx;
  for (int u = tid; u < th * ncx; u += kThreads) {
    const int ty = u / ncx, cxl = u - ty * ncx;
    const float* src = s_d + ty * l.prow + cxl * s;
    float a = 0.f;
    for (int x = 0; x < s; ++x) a += src[x];
    s_rows[u] = rbf(a);
  }
  __syncthreads();
  const int b = pl / p.K, k = pl - b * p.K;
  for (int c = tid; c < ncells; c += kThreads) {
    const int cyl = c / ncx, cxl = c - cyl * ncx;
    float a = 0.f;
    for (int y = 0; y < s; ++y) a += s_rows[(cyl * s + y) * ncx + cxl];
    const int cell = (y0 / s + cyl) * p.ws + x0 / s + cxl;
    const float q = rbf(rbf(a) * p.scale);
    put_v(p, b, cell, k, rbf(q * __ldcg(p.bn + (size_t)b * p.Np + cell)));
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

// item `item` of a block-wide kind
template <bool kCoarse>
__device__ void run_item(const Params& p, int kind, int it, int item, float* smem) {
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
    case kUpdate: {
      const int pl = item / p.tiles;
      update_dispatch<kCoarse>(p, pl, item - pl * p.tiles, it, smem);
      break;
    }
    case kSplat: {
      const int pl = item / p.hs;
      splat_item<kCoarse>(p, pl, item - pl * p.hs, it, smem);
      break;
    }
    case kZero: {
      const int n = p.H * ((p.W + 31) >> 5);
      for (int t = threadIdx.x; t < n; t += kThreads) p.bits[(size_t)item * n + t] = 0u;
      break;
    }
    case kClose:
      close_dispatch<kCoarse, true>(p, item, smem);
      break;
  }
}

// phases ph_lo .. ph_hi - 1 (crf_common.cuh's), a grid barrier between
// two: the block-wide kinds' items spread over the grid; the degree and
// the messages by 16-row groups, each block a contiguous run of them
template <bool kCoarse>
__global__ void __launch_bounds__(kThreads, 2)
crf_bf16_kernel(const __grid_constant__ Params p, int ph_lo, int ph_hi) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  for (int ph = ph_lo; ph < ph_hi; ++ph) {
    if (ph > ph_lo) grid_barrier(p.barrier);
    const Phase phase = phase_at(p, ph);
    for (int kind = 1; kind <= kClose; kind <<= 1) {
      if (!(phase.kinds & kind)) continue;
      if (kind == kDegree || kind == kMessage) {
        const long long n = (long long)p.B * (p.Np >> 4);
        const int lo = (int)(n * blockIdx.x / gridDim.x);
        const int hi = (int)(n * (blockIdx.x + 1) / gridDim.x);
        for (int rg = lo; rg < hi; ++rg) {
          if (kind == kDegree) bilateral_rows<true>(p, rg, smem);
          else bilateral_rows<false>(p, rg, smem);
        }
        continue;
      }
      const int n = kind == kSplat ? p.B * p.K * p.hs : items_of(p, kind, 1);
      for (int item = blockIdx.x; item < n; item += gridDim.x)
        run_item<kCoarse>(p, kind, phase.it, item, smem);
    }
  }
}

// --------------------------------------------------------------- the host

// shared memory a call needs (bytes): the largest of an update tile, a cell
// row's column sums (the features), the bilateral rows' partial sums and a
// closing band (the tail keeps the K closed bands)
inline int smem_need(int K, int H, int W, int TH, int TW, int radius, int iters,
                     int ck, bool tail) {
  int need = tile_layout(TH, TW, radius).total;
  if (iters > 0) need = imax(need, imax(3 * W, kWarps * 128));
  need = imax(need, close_words(K, H, W, ck, tail));
  return need * 4;
}

inline size_t align256(size_t n) { return (n + 255) & ~(size_t)255; }

// bytes of the workspace (ops/crf_fused.py:workspace_bytes_bf16): the
// features by cell pair (B, Np / 2, 12) f32, bn (B, Np) f32, m (B, K, N)
// f32, bn q (B, Np / 2, 8, 2) bf16, two bf16 iterates (B, K, H, Wp), the
// mask bits (B, K, H, ceil(W / 32)) words; Np = N rounded up to 16, Wp = W
// rounded up to even
inline size_t workspace_bytes(int B, int K, int H, int W, int s) {
  const size_t n = (size_t)(H / s) * (W / s), np = (n + 15) & ~(size_t)15;
  const size_t px = (size_t)B * K * H * (W + (W & 1));
  return align256((size_t)B * np * 24) + align256((size_t)B * np * 4) +
         align256((size_t)B * K * n * 4) + align256((size_t)B * np * 16) +
         2 * align256(px * 2) + align256((size_t)B * K * H * ((W + 31) / 32) * 4);
}

// fills p from the call's arguments and carves the workspace
bool setup(Params& p, int B, int K, int H, int W, int f, int stride, int radius,
           int iters, int ck, int TH, int TW, int smem, bool tail, void* work,
           long long work_bytes) {
  if (!setup_shape(p, B, K, H, W, f, stride, radius, iters, ck, TH, TW, tail) ||
      smem > kSmemLimit || smem < smem_need(K, H, W, TH, TW, radius, iters, p.ck, tail) ||
      work_bytes < (long long)workspace_bytes(B, K, H, W, stride))
    return false;
  p.Np = (p.N + 15) & ~15;
  p.Wp = W + (W & 1);
  const size_t np = p.Np, px = (size_t)B * K * H * p.Wp;
  char* w = (char*)work;
  p.feat = (float*)w, w += align256((size_t)B * np * 24);
  p.bn = (float*)w, w += align256((size_t)B * np * 4);
  p.m = (float*)w, w += align256((size_t)B * K * p.N * 4);
  p.v = (__nv_bfloat16*)w, w += align256((size_t)B * np * 16);
  for (int i = 0; i < 2; ++i) p.e[i] = (__nv_bfloat16*)w, w += align256(px * 2);
  p.bits = (uint32_t*)w;
  return true;
}

// the phases the calls run (crf_mean_field_bf16_phases)
int g_phase_lo = 0, g_phase_hi = 1 << 30;

}  // namespace

// For a profile by phase: the calls that follow run only their phases lo ..
// hi - 1 (phase_at: the features and d0; the degree; per iteration the
// message and the update; the closing), on whatever the workspace holds;
// (0, 1 << 30), the default, runs every phase.
extern "C" void crf_mean_field_bf16_phases(int lo, int hi) {
  g_phase_lo = lo, g_phase_hi = hi;
}

// The bf16 mode of crf_mean_field_f32: du (B, K, H, W) f32 (rounded to
// bf16 on reading); wtab (W + 8, 4 ceil((2 radius + 1) / 4)) and htab
// (H + 8, the same) the Gaussian bands' entries rounded to bf16
// (ops/crf_fused.py:bf16_tables), each row zero-padded to a float4 and 8
// zero rows after the map's; rows wlo .. whi of wtab (hlo .. hhi of htab)
// hold the same taps (ops/crf_fused.py:_device_tables);
// gc, bc and scale (1 / stride^2) rounded to bf16; tile_h x tile_w the
// update tile and smem the shared memory per block
// (ops/crf_fused.py:launch_plan_bf16); work a workspace of work_bytes
// (ops/crf_fused.py:workspace_bytes_bf16); barrier two zeroed words; out
// (B, K, H, W) bf16 0/1 masks.
extern "C" int crf_mean_field_bf16(
    const float* du, const void* rgb, int rgb_u8, const float* wtab, const float* htab,
    int wlo, int whi, int hlo, int hhi, int B, int K, int H, int W, int stride,
    int radius, int num_iters,
    float gaussian_compat, float bilateral_compat, float scale, float sxy, float srgb,
    int closing_ksize, int tile_h, int tile_w, int smem, void* work,
    long long work_bytes, unsigned* barrier, void* out, void* stream_ptr) {
  Params p = {};
  if (!setup(p, B, K, H, W, 1, stride, radius, num_iters, closing_ksize, tile_h,
             tile_w, smem, false, work, work_bytes))
    return (int)cudaErrorInvalidValue;
  p.du = du, p.rgb = rgb, p.rgb_u8 = rgb_u8, p.wtab = wtab, p.htab = htab;
  p.wlo = wlo, p.whi = whi, p.hlo = hlo, p.hhi = hhi;
  p.gc = gaussian_compat, p.bc = bilateral_compat, p.scale = scale;
  p.sxy = sxy, p.srgb = srgb;
  p.out16 = (__nv_bfloat16*)out;
  return (int)launch(crf_bf16_kernel<false>, p, smem, barrier, (cudaStream_t)stream_ptr,
                     g_phase_lo, g_phase_hi);
}

// The bf16 mode of crf_decode_tail_f32: du_coarse (B, K, H/f, W/f) f32,
// scores (B, K) f32, cand_idx (B, K) int32 or (idx64) int64, the rest as
// crf_mean_field_bf16; out pred (B, H, W) int32, best_w (B, H, W) f32.
extern "C" int crf_decode_tail_bf16(
    const float* du_coarse, const void* rgb, int rgb_u8, const float* wtab,
    const float* htab, int wlo, int whi, int hlo, int hhi, const float* scores,
    const void* cand_idx, int idx64, int B,
    int K, int H, int W, int du_factor, int stride, int radius, int num_iters,
    float gaussian_compat, float bilateral_compat, float scale, float sxy, float srgb,
    int closing_ksize, int tile_h, int tile_w, int smem, void* work,
    long long work_bytes, unsigned* barrier, int* pred, float* best_w,
    void* stream_ptr) {
  Params p = {};
  if (!setup(p, B, K, H, W, du_factor, stride, radius, num_iters, closing_ksize,
             tile_h, tile_w, smem, true, work, work_bytes))
    return (int)cudaErrorInvalidValue;
  p.du = du_coarse, p.rgb = rgb, p.rgb_u8 = rgb_u8, p.wtab = wtab, p.htab = htab;
  p.wlo = wlo, p.whi = whi, p.hlo = hlo, p.hhi = hhi;
  p.scores = scores, p.cand_idx = cand_idx, p.idx64 = idx64;
  p.gc = gaussian_compat, p.bc = bilateral_compat, p.scale = scale;
  p.sxy = sxy, p.srgb = srgb;
  p.pred = pred, p.best_w = best_w;
  return (int)launch(crf_bf16_kernel<true>, p, smem, barrier, (cudaStream_t)stream_ptr,
                     g_phase_lo, g_phase_hi);
}

extern "C" const char* crf_mean_field_bf16_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
