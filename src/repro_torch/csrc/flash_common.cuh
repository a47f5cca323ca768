// Shared pieces of the flash attention kernels for Hopper (sm_90a):
// flash_attention.cu (the forward) and flash_attention_bwd.cu (its
// backward) include this file; each gets its own copy (anonymous
// namespace).  The tiling and masks both passes share (BQ x BKV tiles,
// the forward's kv_range), and the tensor-core machinery of the bf16
// kernels: mbarriers, TMA loads of 64-row tiles in the swizzled layout
// wgmma's shared-memory descriptors read, and wgmma itself.

#pragma once

#include <cmath>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BKV = 64;         // keys per kv tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ bool allowed(int qpos, int kpos, int causal,
                                        int window) {
  if (causal && kpos > qpos) return false;
  if (window > 0 && qpos / window != kpos / window) return false;
  return true;
}

// The kv tiles [lo, hi] a query tile of rows q0 .. q_last needs: tiles
// wholly above the diagonal or outside the tile's window chunks are
// skipped, unless a row of the tile has no allowed key at all (a window
// chunk past Skv), which then averages v over every key as the reference
// does.
__device__ __forceinline__ void kv_range(int q0, int q_last, int Skv,
                                         int causal, int window, int* lo,
                                         int* hi) {
  const int n_kv = (Skv + BKV - 1) / BKV;
  *lo = 0;
  *hi = n_kv - 1;
  const bool empty_row = window > 0 && (q_last / window) * window >= Skv;
  if (empty_row) return;
  if (window > 0) *lo = (q0 / window) * window / BKV;
  if (causal) {
    *hi = min(*hi, q_last / BKV);
  } else if (window > 0) {
    *hi = min(*hi, ((q_last / window) * window + window - 1) / BKV);
  }
}

constexpr int WG_THREADS = 128;  // one warpgroup: a 64-row tile (wgmma's M)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// one box of a rank-4 tensor map (coordinates innermost first) into
// shared memory, completing on an mbarrier
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start, leading and stride byte
// offsets (16-byte units), swizzle mode in bits 62-63
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t mode) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | ((uint64_t)mode << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving reads of the accumulators above the wait
template <int N>
__device__ __forceinline__ void hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int N> struct Wgmma;
template <> struct Wgmma<16> {
  // d (64 x 16, f32) += A (registers, bf16 pairs) * B (smem desc,
  // MN-major: the transpose bit)
  __device__ __forceinline__ static void rs(float (&d)[8], const uint32_t (&a)[4],
                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{" "%0, %1, %2, %3, %4, %5, %6, %7" "}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <> struct Wgmma<32> {
  // d (64 x 32, f32) += A (registers, bf16 pairs) * B (smem desc,
  // MN-major: the transpose bit)
  __device__ __forceinline__ static void rs(float (&d)[16], const uint32_t (&a)[4],
                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{" "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15" "}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <> struct Wgmma<64> {
  // d (64 x 64, f32) {+}= A (smem desc) * B (smem desc), both K-major
  __device__ __forceinline__ static void ss(float (&d)[32], uint64_t da, uint64_t db,
                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{" "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31" "}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(accumulate));
  }
  // d (64 x 64, f32) += A (registers, bf16 pairs) * B (smem desc,
  // MN-major: the transpose bit)
  __device__ __forceinline__ static void rs(float (&d)[32], const uint32_t (&a)[4],
                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{" "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31" "}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <> struct Wgmma<80> {
  // d (64 x 80, f32) += A (registers, bf16 pairs) * B (smem desc,
  // MN-major: the transpose bit); B's 80 columns are five 16-column
  // panels of 32-byte rows, one leading byte offset apart
  __device__ __forceinline__ static void rs(float (&d)[40], const uint32_t (&a)[4],
                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
        "{" "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39" "}, "
        "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <> struct Wgmma<128> {
  // d (64 x 128, f32) += A (registers, bf16 pairs) * B (smem desc,
  // MN-major: the transpose bit)
  __device__ __forceinline__ static void rs(float (&d)[64], const uint32_t (&a)[4],
                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{" "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63" "}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

// Shared-memory geometry of one head dim: rows of SWZ bytes, the widest
// swizzle (128, 64 or 32 B) that divides the row's HD * 2 bytes, so a
// tile is NP panels of PW columns side by side with no padding: hd 128
// two panels of 64 columns (128 B), hd 64 one, hd 32 one of 64 B, hd 16
// one of 32 B, and hd 80 (160-byte rows, which no 128- or 64-byte
// swizzle divides) five panels of 16 columns (32 B).  Every panel starts
// on a 1024-byte boundary.
template <int HD> struct Tiles {
  static constexpr int SWZ = (HD * 2) % 128 == 0 ? 128
                             : (HD * 2) % 64 == 0 ? 64 : 32;
  static constexpr int PW = SWZ / 2;                 // columns a panel
  static constexpr int NP = HD / PW;
  static_assert(HD % 16 == 0 && NP * PW == HD, "head dim of 16-col steps");
  static constexpr uint32_t MODE = SWZ == 128 ? 1 : SWZ == 64 ? 2 : 3;
  static constexpr int Q_PANEL = BQ * SWZ;
  static constexpr int KV_PANEL = BKV * SWZ;
  static constexpr int Q_BYTES = Q_PANEL * NP;
  static constexpr int KV_BYTES = KV_PANEL * NP;
};

// one tile (rows row0 .. row0 + rows - 1 of one head) of a rank-4 map into
// shared memory, as NP panels, completing on barrier bar
template <int HD>
__device__ __forceinline__ void load_tile(const CUtensorMap* map,
                                          uint64_t* bar_ptr, uint32_t dst,
                                          uint32_t bytes, uint32_t panel,
                                          int row0, int head, int b) {
  using Tl = Tiles<HD>;
  const uint32_t bar = smem_u32(bar_ptr);
  mbar_expect_tx(bar, bytes);
#pragma unroll
  for (int p = 0; p < Tl::NP; ++p)
    tma_load(dst + p * panel, map, bar, p * Tl::PW, row0, head, b);
}

// S = A B^T for two 64-row tiles of HD columns (the forward's q k^T;
// the backward's q k^T, dO v^T and their transposes): bf16 operands from
// shared memory (both K-major), float32 accumulators; started and
// committed, not waited for
template <int HD>
__device__ __forceinline__ void start_scores(float (&s)[BKV / 2],
                                             uint32_t sq, uint32_t kst) {
  using Tl = Tiles<HD>;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int p = kk * 16 / Tl::PW;
    const uint32_t col = (kk * 16 % Tl::PW) * 2;
    Wgmma<BKV>::ss(
        s, smem_desc(sq + p * Tl::Q_PANEL + col, 16, 8 * Tl::SWZ, Tl::MODE),
        smem_desc(kst + p * Tl::KV_PANEL + col, 16, 8 * Tl::SWZ, Tl::MODE),
        kk > 0);
  }
  wgmma_commit();
}

// cuTensorMapEncodeTiled from the CUDA driver API, through the
// runtime's entry point query, so the library needs no -lcuda
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// (B, S, heads, HD) bf16, boxes of PW columns x rows of one head
template <int HD>
bool tensor_map(CUtensorMap* map, const void* ptr, int B, int S, int heads,
                int rows) {
  using Tl = Tiles<HD>;
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)S,
                              (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)heads * HD * 2,
                                 (cuuint64_t)HD * 2,
                                 (cuuint64_t)S * heads * HD * 2};
  const cuuint32_t box[4] = {(cuuint32_t)Tl::PW, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz = Tl::SWZ == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : Tl::SWZ == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                 : CU_TENSOR_MAP_SWIZZLE_32B;
  // rows past the end of the sequence arrive as zeros
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
