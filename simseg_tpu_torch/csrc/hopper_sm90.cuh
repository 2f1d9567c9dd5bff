// Hopper (sm_90a) building blocks shared by the attention kernels
// (flash_attention.cu, flash_attention_bwd.cu): the warp roles' registers,
// mbarriers, TMA tile copies through 4-d tensor maps, wgmma descriptors and
// products, and the host-side tensor-map encoder. Every tile these helpers
// address sits in shared memory in the 128-byte swizzle: an (R, HD) bf16
// tile is HD / 64 slabs of R rows x 128 bytes; slab s holds columns
// [64 s, 64 s + 64), and within it row r's 16-byte chunk c sits at chunk
// c ^ (r % 8) (TMA's and wgmma's swizzle, which repeats every 8 rows =
// 1024 bytes, so every tile starts 1024-byte aligned).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

struct Strides {  // element strides (batch, token, head); head-dim stride 1
  long sb, st, sh;
};

__device__ __forceinline__ long offset(const Strides& s, int b, long t, int h) {
  return b * s.sb + t * s.st + h * s.sh;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ uint32_t aligned_base(const unsigned char* smem) {
  return (smem_addr(smem) + 1023u) & ~1023u;
}

// A CTA of WG consumer warpgroups and one producer warpgroup. Registers:
// the kernel is compiled for kLaunch threads of 65536 / kLaunch registers;
// setmaxnreg then lowers the producer's to kProducerRegs and raises the
// consumers' to kConsumerRegs.
template <int WG>
struct WarpRoles {
  static constexpr int kWG = WG;
  static constexpr int kThreads = (WG + 1) * 128;
  static constexpr int kLaunch = kThreads < 384 ? 384 : kThreads;
  static constexpr int kProducerRegs = WG >= 3 ? 24 : 40;
  static constexpr int kConsumerRegs =
      (65536 - 128 * kProducerRegs) / (128 * WG) / 8 * 8 < 240
          ? (65536 - 128 * kProducerRegs) / (128 * WG) / 8 * 8 : 240;
};

// ---------------------------------------------------------------- mbarriers
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// the mbarriers of a CTA's ring (S: its shared-memory layout): one per
// stage filled (the producer's arrival with the TMA bytes, and with `stats`
// its 32 lanes' after their own stores), one per stage emptied (each
// consumer warp), one for the resident tiles
template <class S>
__device__ void init_barriers(const S& L, bool stats) {
  for (int s = 0; s < S::kStages; ++s) {
    mbar_init(L.full(s), stats ? 33 : 1);
    mbar_init(L.empty(s), 4 * S::kWG);
  }
  mbar_init(L.resident(), 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// --------------------------------------------------------------------- TMA
// box (64 columns, 1 head, the map's box rows, 1 batch) at (c, h, t, b) into
// dst (1024-byte aligned); rows past T arrive as zeros
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map, int c, int h,
                                        int t, int b, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(h), "r"(t), "r"(b), "r"(bar)
      : "memory");
}

// rows [t0, t0 + R) of (b, h) as an (R, HD) tile, in boxes of BOX rows (the
// map's box rows)
template <int R, int HD, int BOX = 64>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, int h, int t0,
                                         int b, uint32_t bar) {
  static_assert(R % BOX == 0, "whole boxes");
#pragma unroll
  for (int s = 0; s < HD / 64; ++s)
#pragma unroll
    for (int r = 0; r < R / BOX; ++r)
      tma_box(dst + s * R * 128 + r * BOX * 128, map, 64 * s, h, t0 + BOX * r, b, bar);
}

// ------------------------------------------------------------------ wgmma
// wgmma shared-memory descriptor, 128-byte swizzle: start address and
// leading byte offset in 16-byte units, stride byte offset 1024 (the next
// group of 8 rows)
__device__ __forceinline__ uint64_t descriptor(uint32_t addr, uint32_t lead) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lead >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// operand of k16 step kk read K-major (rows x the head dim) from a tile of
// R rows, starting at its row `row0` (a multiple of 8): the step is 32
// bytes into its slab, where the hardware applies the swizzle to the
// advanced address
template <int R>
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int row0, int kk) {
  return descriptor(tile + (kk >> 2) * (R * 128) + row0 * 128 + (kk & 3) * 32, 16);
}

// operand of k16 step kk read MN-major from a tile of R rows: B[k][n] =
// tile[16 kk + k][c0 + n] for the 64 columns of slab c0 / 64; the step is
// 16 rows = 2048 bytes
template <int R = 64>
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int c0, int kk) {
  return descriptor(tile + (c0 / 64) * (R * 128) + kk * 2048, R * 128);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// pins registers that an in-flight wgmma reads or writes: no use is moved
// across the fence or wait beside it, and no register is reused before it
template <int N>
__device__ __forceinline__ void pin(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void pin(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define WG_ACC32(d)                                                           \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),     \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),     \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),     \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),     \
      "+f"(d[31])
#define WG_REGS32                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31}"
#define WG_REGS64                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "    \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "    \
  "%58, %59, %60, %61, %62, %63}"

// d (64 x 64 f32) = (accumulate ? d : 0) + A B, A (64 x 16) and B (16 x 64)
// both K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_ACC32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// the same at n = 128: d (64 x 128 f32), B (16 x 128)
__device__ __forceinline__ void wgmma_ss128(float* d, uint64_t a, uint64_t b,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_REGS64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_ACC32(d), WG_ACC32((d + 32))
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64 f32) += A B, A (64 x 16 bf16) in registers, B (16 x 64) read
// MN-major from shared memory
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
      ", {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      : WG_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Accumulator register 4 i + e of a 64 x n f32 wgmma holds row g + 8 (e /
// 2), column 8 i + 2 t + e % 2 of the thread's warp's 16 rows (g = lane /
// 4, t = lane % 4). Register j of the A fragments of the next product
// (fragment kk: columns 16 kk .. 16 kk + 15, registers 4 kk .. 4 kk + 3)
// holds the same rows and columns in bf16 pairs: a[j] = (acc[2 j],
// acc[2 j + 1]). acc_col is the column of register i.
__device__ __forceinline__ int acc_col(int i, int t) { return 8 * (i / 4) + 2 * t + (i & 1); }

// ------------------------------------------------------------------- host
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up once through the runtime (so
// the build links no libcuda)
inline cudaError_t encoder(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr) return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// a (B, T, H, hd) bf16 tensor read through its element strides as the 4-d
// map (hd, H, T, B) with (64, 1, box_rows, 1) boxes in the 128-byte
// swizzle; a dimension of size 1 gets the stride its predecessor implies
// (any stride of it is never used)
inline cudaError_t tensor_map(CUtensorMap* map, const bf16* ptr, int B, int T, int H, int hd,
                              const Strides& s, int box_rows) {
  EncodeTiled encode;
  const cudaError_t err = encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)H, (cuuint64_t)T, (cuuint64_t)B};
  const long given[3] = {s.sh, s.st, s.sb};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i) {
    const cuuint64_t implied = i == 0 ? dims[0] * 2 : strides[i - 1] * dims[i];
    strides[i] = dims[i + 1] == 1 ? implied : (cuuint64_t)given[i] * 2;
  }
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                              const_cast<bf16*>(ptr), dims, strides, box, unit,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace
