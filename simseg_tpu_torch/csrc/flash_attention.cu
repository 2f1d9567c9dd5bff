// Bias-free softmax attention, forward, for Hopper (sm_90a): bf16 q, k, v
// and output, float32 scores, softmax statistics and accumulators.
//
// Replaces the TPU kernel simseg_tpu/ops/flash_attention.py:flash_mha
// (_mha_pallas / _mha_kernel), and the forward halves of flash_mha_rowblock
// (_rowblock_fwd_kernel, 1536 < T <= 4096) and flash_mha_stream
// (_stream_fwd_kernel, T > 4096): the TPU needed those two only because its
// whole (T, T) tile stops fitting VMEM past T = 1536; this kernel streams
// k/v and has no T ceiling (shared memory is fixed, offsets are 64-bit).
// For each (batch b, head h):
//
//   o[b, :, h] = softmax(q[b, :, h] k[b, :, h]^T) v[b, :, h]
//
// with q pre-scaled by hd^-1/2, on (B, T, H, hd) tensors read in place
// through their strides (no fold to (B*H, T, hd), no transpose copies).
// Scores, the running max m and sum l and the O accumulators are f32; O is
// divided by l at the end (the TPU kernel normalised p before its bf16
// cast: the two differ at bf16 rounding); key columns past Tk are masked,
// query rows past Tq not stored. With a non-null lse pointer the kernel
// also writes each row's log-sum-exp m + log l in f32 to lse (B, H, Tq),
// which the backward (flash_attention_bwd.cu) uses to recompute p without a
// second pass over k; with a null pointer nothing more is written.
//
// What bounds it on this card: 4 B H Tq Tk hd operations on the tensor
// cores (0.084 ms per ViT-B layer at B = 16, T = 1297 at 989 TFLOP/s bf16);
// q/k/v/o traffic is a tenth of that. The TPU design kept the whole (T, T)
// f32 score tile of one (b, h) in VMEM (6.7 MB at T = 1297, against 227 KB
// of shared memory in an H100 block); this one streams k/v tiles past
// resident q rows with an online softmax, and keeps the tensor cores fed:
//   - every product is a warpgroup wgmma (bf16 -> f32). Each consumer
//     warpgroup owns 64 q rows: S = Q K^T is an SS product (m64n128k16, or
//     m64n64k16 at hd 192/256) reading both operands K-major from shared
//     memory; the online softmax runs on the S accumulator in registers
//     (exp2 with log2 e folded into the max subtraction; the row sums stay
//     per thread until the end); P is rounded to bf16 in the accumulator's
//     layout, which is wgmma's register A layout, and O += P V is an RS
//     product (m64n64k16 per 64 columns of hd) reading V MN-major from the
//     tile as loaded. S, P and O never touch shared memory;
//   - k/v tiles of kN rows (128 at hd <= 128, 64 at hd 192/256, where O's
//     registers grow) sit in shared memory in the 128-byte swizzle that
//     wgmma reads without bank conflicts (hopper_sm90.cuh);
//   - one producer warp loads q once and the k/v tiles by TMA (4-d tensor
//     maps over (hd, H, T, B), so a ragged tile's rows past T arrive as
//     zeros, not as the next image's tokens) into a ring of 2-4 stages that
//     completes on mbarriers; the consumers free a stage once its PV
//     product has read it. setmaxnreg moves registers from the producer to
//     the consumers. Only the last k/v tile masks columns past Tk: the
//     steady loop has no mask;
//   - three consumer warpgroups per CTA at hd 64 (192 q rows; two at wider
//     heads, whose O needs the registers) share each streamed k/v tile,
//     which divides the k/v traffic per q row as many times and keeps one
//     warpgroup's products running while the others compute their softmax.
//     Two warpgroups taking strict turns at their products (ping-pong, as
//     the backward's dk/dv pass does) measured no faster than two without,
//     and slower than three, so they do not.
// What is left: overlapping a warpgroup's next S product with its own
// softmax (FlashAttention-3's intra-warpgroup pipelining), and a persistent
// grid whose epilogue overlaps the next tile's loads.
//
// The host function encodes the tensor maps per call, returns the first
// error as an int (0 = cudaSuccess) and allocates nothing; the launch is on
// the caller's stream.

#include "hopper_sm90.cuh"

namespace {

constexpr int kQRows = 64;  // q rows per consumer warpgroup
constexpr float kLog2e = 1.4426950408889634f;

// the design at each head dim: k/v rows per tile and consumer warpgroups
// per CTA (three spill under their 160 registers past hd 64)
template <int HD>
struct Design {
  static constexpr int kN = HD <= 128 ? 128 : 64;
  static constexpr int kWG = HD == 64 ? 3 : 2;
};

// whether tiles of `bytes` and the mbarriers of `stages` stages fit an
// H100 block, with 1024 bytes of slack to align the base
constexpr bool fits(uint32_t bytes, int stages) {
  return bytes + (2 * stages + 1) * 8 + 1024 <= 232448;
}

// The CTA (WG consumer warpgroups and one producer warpgroup) and its
// shared memory: the resident (WG x 64, HD) q tile, then kStages stages of
// a (N, HD) k tile and a (N, HD) v tile, then the mbarriers; 1024 bytes of
// slack to align the base.
template <int HD, int N, int WG>
struct Smem : WarpRoles<WG> {
  static constexpr uint32_t kQ = WG * kQRows * HD * 2;
  static constexpr uint32_t kTile = N * HD * 2;
  static constexpr uint32_t kStage = 2 * kTile;
  static constexpr int kStages = fits(kQ + 4 * kStage, 4) ? 4
                                 : fits(kQ + 3 * kStage, 3) ? 3 : 2;
  static constexpr uint32_t kBars = kQ + kStages * kStage;
  static constexpr size_t kBytes = kBars + (2 * kStages + 1) * 8 + 1024;
  static_assert(kTile % 1024 == 0, "every tile stays 1024-byte aligned");
  static_assert(kBytes <= 232448, "fits an H100 block");

  uint32_t base;
  __device__ explicit Smem(uint32_t b) : base(b) {}
  __device__ uint32_t stage(int j) const { return base + kQ + (j % kStages) * kStage; }
  __device__ uint32_t full(int j) const { return base + kBars + 8 * (j % kStages); }
  __device__ uint32_t empty(int j) const { return base + kBars + 8 * (kStages + j % kStages); }
  __device__ uint32_t resident() const { return base + kBars + 16 * kStages; }
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// S (64 x N f32) = this warpgroup's 64 q rows x the tile's N keys
template <int HD, int N, int WG>
__device__ __forceinline__ void score_product(float* s, uint32_t sQ, uint32_t sK, int wg) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint64_t a = kmajor<WG * kQRows>(sQ, wg * kQRows, kk);
    const uint64_t b = kmajor<N>(sK, 0, kk);
    if constexpr (N == 128) wgmma_ss128(s, a, b, kk);
    else wgmma_ss(s, a, b, kk);
  }
}

// One k/v tile for one warpgroup: S = Q K^T; the online softmax (columns
// from `valid` on masked when kMask); O = alpha O + bf16(P) V. m (natural
// units) and l (this thread's share of the row sum) are the thread's rows
// g and g + 8.
template <int HD, int N, int WG, bool kMask>
__device__ __forceinline__ void attend_tile(uint32_t sQ, uint32_t sK, uint32_t sV, int wg,
                                            int valid, int t, float* o, float* m, float* l) {
  float s[N / 2];
  wg_fence();
  score_product<HD, N, WG>(s, sQ, sK, wg);
  wg_commit();
  wg_wait();
  pin<N / 2>(s);

  if constexpr (kMask) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i)
      if (acc_col(i, t) >= valid) s[i] = -INFINITY;
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < N / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  float alpha[2], ml[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = ex2((m[r] - mx[r]) * kLog2e);  // 0 on the first tile (m = -inf)
    m[r] = mx[r];                             // finite: every tile has a valid key
    ml[r] = mx[r] * kLog2e;
  }
  uint32_t p[N / 4];
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < N / 2; i += 2) {
    const int r = (i >> 1) & 1;
    const float p0 = ex2(fmaf(s[i], kLog2e, -ml[r]));
    const float p1 = ex2(fmaf(s[i + 1], kLog2e, -ml[r]));
    sum[r] += p0 + p1;
    p[i / 2] = pack_bf16(p0, p1);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

  pin<HD / 2>(o);
  pin<N / 4>(p);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int c = 0; c < HD / 64; ++c) wgmma_rs(o + 32 * c, p + 4 * kk, mnmajor<N>(sV, 64 * c, kk));
  wg_commit();
  wg_wait();
  pin<HD / 2>(o);
  pin<N / 4>(p);
}

template <int HD>
__global__ void __launch_bounds__(Smem<HD, Design<HD>::kN, Design<HD>::kWG>::kLaunch, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap mq,
                     const __grid_constant__ CUtensorMap mk,
                     const __grid_constant__ CUtensorMap mv, bf16* __restrict__ o,
                     float* __restrict__ lse, int Tq, int Tk, Strides os) {
  constexpr int N = Design<HD>::kN;
  constexpr int WG = Design<HD>::kWG;
  constexpr int RR = WG * kQRows;  // resident q rows
  using S = Smem<HD, N, WG>;
  extern __shared__ unsigned char smem[];
  const S L{aligned_base(smem)};
  const int q0 = blockIdx.x * RR;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int nt = (Tk + N - 1) / N;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) init_barriers(L, false);
  __syncthreads();

  if (wg == WG) {  // the producer warpgroup: one thread loads, the rest idle
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(S::kProducerRegs));
    if (threadIdx.x % 128 == 0) {
      mbar_expect(L.resident(), S::kQ);
      tma_tile<RR, HD, RR>(L.base, &mq, h, q0, b, L.resident());
      for (int j = 0; j < nt; ++j) {
        mbar_wait(L.empty(j), ((j / S::kStages) & 1) ^ 1);
        const uint32_t st = L.stage(j);
        mbar_expect(L.full(j), S::kStage);
        tma_tile<N, HD, N>(st, &mk, h, j * N, b, L.full(j));
        tma_tile<N, HD, N>(st + S::kTile, &mv, h, j * N, b, L.full(j));
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(S::kConsumerRegs));
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4;  // accumulator row (and row + 8)
    const int t = lane % 4;  // accumulator column pair 2t, 2t + 1
    float acc[HD / 2];       // O: HD / 64 slabs of 32 registers
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    mbar_wait(L.resident(), 0);

    int j = 0;
    for (; j < nt - 1; ++j) {
      mbar_wait(L.full(j), (j / S::kStages) & 1);
      const uint32_t sK = L.stage(j);
      attend_tile<HD, N, WG, false>(L.base, sK, sK + S::kTile, wg, N, t, acc, m, l);
      __syncwarp();
      if (lane == 0) mbar_arrive(L.empty(j));
    }
    mbar_wait(L.full(j), (j / S::kStages) & 1);
    const uint32_t sK = L.stage(j);
    attend_tile<HD, N, WG, true>(L.base, sK, sK + S::kTile, wg, Tk - j * N, t, acc, m, l);

    // o = O / l for the rows below Tq, two bf16 per store
    const int row0 = q0 + wg * kQRows + warp * 16;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int row = row0 + g + 8 * r;
      if (row >= Tq) continue;
      const float inv = 1.f / l[r];
      if (lse != nullptr && t == 0)
        lse[((long)b * gridDim.y + h) * Tq + row] = m[r] + logf(l[r]);
      bf16* out = o + offset(os, b, row, h);
#pragma unroll
      for (int c = 0; c < HD / 64; ++c)
#pragma unroll
        for (int i = 0; i < 8; ++i)
          *reinterpret_cast<__nv_bfloat162*>(out + 64 * c + 8 * i + 2 * t) =
              __floats2bfloat162_rn(acc[32 * c + 4 * i + 2 * r] * inv,
                                    acc[32 * c + 4 * i + 2 * r + 1] * inv);
    }
  }
}

template <int HD>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse,
                   int B, int Tq, int Tk, int H, const long long* st,
                   cudaStream_t stream) {
  constexpr int N = Design<HD>::kN;
  constexpr int RR = Design<HD>::kWG * kQRows;
  using S = Smem<HD, N, Design<HD>::kWG>;
  Strides s[4];
  for (int i = 0; i < 4; ++i)
    s[i] = Strides{(long)st[3 * i], (long)st[3 * i + 1], (long)st[3 * i + 2]};
  CUtensorMap mq, mk, mv;
  cudaError_t err;
  if ((err = tensor_map(&mq, q, B, Tq, H, HD, s[0], RR)) != cudaSuccess ||
      (err = tensor_map(&mk, k, B, Tk, H, HD, s[1], N)) != cudaSuccess ||
      (err = tensor_map(&mv, v, B, Tk, H, HD, s[2], N)) != cudaSuccess)
    return err;
  err = cudaFuncSetAttribute(flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)S::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + RR - 1) / RR, H, B);
  flash_fwd_kernel<HD><<<grid, S::kThreads, S::kBytes, stream>>>(mq, mk, mv, o, lse, Tq, Tk,
                                                                  s[3]);
  return cudaGetLastError();
}

}  // namespace

// strides: 12 element strides (batch, token, head) of q, k, v, o in turn;
// the head-dim stride is 1, and every row and stride of q, k, v is 16-byte
// aligned (TMA). lse: null, or (B, H, Tq) f32 written with each row's
// log-sum-exp.
extern "C" int flash_attention_fwd_bf16(const void* q, const void* k, const void* v,
                                        void* o, void* lse, int B, int Tq, int Tk,
                                        int H, int hd, const long long* strides,
                                        void* stream_ptr) {
  if (B < 1 || Tq < 1 || Tk < 1 || H < 1 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(o);
  float* lp = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  switch (hd) {
    case 64: return (int)launch<64>(qp, kp, vp, op, lp, B, Tq, Tk, H, strides, st);
    case 128: return (int)launch<128>(qp, kp, vp, op, lp, B, Tq, Tk, H, strides, st);
    case 192: return (int)launch<192>(qp, kp, vp, op, lp, B, Tq, Tk, H, strides, st);
    case 256: return (int)launch<256>(qp, kp, vp, op, lp, B, Tq, Tk, H, strides, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
