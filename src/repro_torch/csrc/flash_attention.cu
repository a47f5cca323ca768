// Flash attention forward for Hopper (sm_90a), bound through a plain C
// interface and loaded with ctypes (repro_torch/kernels/build.py).
//
//   fa_flash_attention  <- flash_attention / _kernel of
//                          src/repro/kernels/flash_attention/flash_attention.py:69
//
// o = softmax(mask(q k^T / sqrt(hd))) v for q (B, Sq, H, hd) and k, v
// (B, Skv, K, hd), query head h reading kv head h / (H / K) (GQA), with
// the causal and chunked-window (qpos / w == kpos / w) masks.  The TPU
// kernel runs a grid (B*H, q blocks, kv blocks) whose kv axis is
// sequential, carrying (acc, m, l) in VMEM scratch.  On Hopper blocks run
// in parallel with nothing carried between them, so one block takes one
// (b*H + h, 64-row query tile) and loops over the 64-key tiles itself,
// keeping the online softmax's m and l and the output tile in registers.
// Two kernels, by dtype:
//
// bf16 (flash_wgmma_kernel; the serve path): both products on the tensor
// cores.  One warpgroup owns the 64 query rows (wgmma's M).  Thread 0
// brings the q tile, a ring of two K tiles and one V slot by TMA
// (cp.async.bulk.tensor against cuTensorMapEncodeTiled maps, completing
// on mbarriers; rows past the sequence arrive as zeros), in the swizzled
// layout wgmma's shared-memory descriptors read (128-byte swizzle, hd 128
// as two 64-column panels; hd 32 and 16 swizzle their whole 64- or
// 32-byte rows).  S = q k^T is wgmma on bf16 operands from shared memory
// with float32 accumulators; the scale 1/sqrt(hd) is applied to S in
// float32 (the Pallas kernel scales q in float32 before a float32 product
// of bf16 values, which is exact: the same function up to one float32
// rounding).  The online softmax runs on the accumulator layout, each
// row's max and sum combined across the four lanes that hold it; P is
// rounded to bf16 in registers, as the Pallas kernel rounds p to v's
// dtype, and is the register A operand of O += P v, v read as the B
// operand with the transpose bit.  The next tile's S is started before
// this tile's softmax, so the tensor cores work under it; its K tile was
// copied a step earlier, and v is copied under the softmax.  Bound at the
// qwen3-1.7b prefill (B 4, S 2048, H 16, K 8, hd 128, causal): 6.9e10
// FLOP, 0.069 ms at the 989 TFLOP/s bf16 tensor-core rate, against ~0.1
// GB of q, k, v and o (0.03 ms at 3.35 TB/s): bound by operations.  What
// holds it from that bound is latency: a block (167 registers a thread,
// 66 KB of shared memory) waits on its own products and shuffles, and
// three blocks an SM hide each other's waits.  So the ring is kept
// shallow: a V ring of two as well (82 KB a block) would fit only two
// blocks an SM.  No producer warp, no register reallocation.
//
// float32 (flash_kernel): the products on the CUDA cores in float32 from
// float32 tiles in shared memory with 4 x 4 register tiles per thread;
// bound by the 67 TFLOP/s float32 rate it cannot approach.  It stays for
// float32 inputs because TF32 tensor cores keep about three decimal
// digits, too few for the float32 gates.
//
// Both kernels can also write the row log-sum-exp L = m + log(l) in
// float32, (B, H, Sq), which the backward (flash_attention_bwd.cu) reads
// to recompute P = exp(S - L); inference passes a null pointer and writes
// nothing more.
//
// Numerics shared by both: all softmax math in float32; masked scores are
// the finite -1e30, never -inf, so a row whose first tiles are wholly
// masked accumulates exp(0) garbage that the correction exp(-1e30 - m)
// wipes to exactly 0 once a real key arrives; l is clamped at 1e-30.
// Keys past Skv in the last tile (the ragged edge, which the Pallas
// wrapper forbids by asserting Skv % bkv == 0) score -inf and so weigh
// exactly 0.  kv tiles wholly above the diagonal or outside the query
// tile's window chunks are skipped, and only the tiles on the diagonal or
// an edge pay for the mask: that computes the same function for every
// row that has at least one allowed key, and a block that holds a row
// with none (a window chunk past Skv, possible only when Sq > Skv) visits
// every tile, so that row is the uniform average of v, as in the
// reference.

#include <cmath>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BKV = 64;         // keys per kv tile
constexpr int NT = 256;         // threads: 16 x 16, 4 x 4 scores each
constexpr int QS = BQ + 4;      // padded stride of the transposed Q and P
constexpr int KS = BKV + 4;     // padded stride of the transposed K
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ void load_vec(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

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

// ---------------------------------------------------------------------------
// float32: products on the CUDA cores
// ---------------------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(NT)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o,
             float* __restrict__ lse, int H, int K, int Sq, int Skv,
             int causal, int window, float scale) {
  constexpr int VEC = 4;
  constexpr int CPT = HD / 16;            // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                       // [HD][QS]  q * scale, transposed
  float* Kt = Qt + HD * QS;               // [HD][KS]  k tile, transposed
  float* Vs = Kt + HD * KS;               // [BKV][HD] v tile
  float* Pt = Vs + BKV * HD;              // [BKV][QS] probabilities, transposed

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, kvh = h / (H / K);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // longest tiles first
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int64_t qrow = (int64_t)H * HD, kvrow = (int64_t)K * HD;
  const float* qb = q + ((int64_t)b * Sq * H + h) * HD;
  const float* kb = k + ((int64_t)b * Skv * K + kvh) * HD;
  const float* vb = v + ((int64_t)b * Skv * K + kvh) * HD;
  float* ob = o + ((int64_t)b * Sq * H + h) * HD;

  for (int idx = tid * VEC; idx < BQ * HD; idx += NT * VEC) {
    const int r = idx / HD, d = idx % HD;
    float vals[VEC];
    if (q0 + r < Sq) {
      load_vec(qb + (q0 + r) * qrow + d, vals);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) vals[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) Qt[(d + e) * QS + r] = vals[e] * scale;
  }

  int kt_lo, kt_hi;
  kv_range(q0, min(q0 + BQ, Sq) - 1, Skv, causal, window, &kt_lo, &kt_hi);

  float acc[4][CPT];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * BKV;
    __syncthreads();                      // the last tile's reads are done
    for (int idx = tid * VEC; idx < BKV * HD; idx += NT * VEC) {
      const int r = idx / HD, d = idx % HD;
      float kv[VEC], vv[VEC];
      if (k0 + r < Skv) {
        load_vec(kb + (k0 + r) * kvrow + d, kv);
        load_vec(vb + (k0 + r) * kvrow + d, vv);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kv[e] = vv[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        Kt[(d + e) * KS + r] = kv[e];
        Vs[r * HD + d + e] = vv[e];
      }
    }
    __syncthreads();

    // scores: rows ty*4 + i, keys tx + 16 c
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qt[d * QS + ty * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      float bv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) bv[c] = Kt[d * KS + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = fmaf(av[i], bv[c], s[i][c]);
    }

    // online softmax: a row's 64 keys live on the 16 lanes of one
    // half-warp (the lanes that share ty)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = k0 + tx + 16 * c;
        if (kpos >= Skv) {
          s[i][c] = -INFINITY;          // past the end: weight exactly 0
        } else if (!allowed(qpos, kpos, causal, window)) {
          s[i][c] = NEG_INF;
        }
        mx = fmaxf(mx, s[i][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[i][c] = expf(s[i][c] - m_new);
        rs += s[i][c];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= corr;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(&Pt[(tx + 16 * c) * QS + ty * 4]) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
    __syncthreads();

    // acc += p v: rows ty*4 + i, columns tx + 16 c
#pragma unroll 4
    for (int j = 0; j < BKV; ++j) {
      const float4 p = *reinterpret_cast<const float4*>(&Pt[j * QS + ty * 4]);
      const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float vj = Vs[j * HD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vj, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
    const float li = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      ob[row * qrow + tx + 16 * c] = acc[i][c] / li;
    if (lse != nullptr && tx == 0)
      lse[(int64_t)bh * Sq + row] = m[i] + logf(li);
  }
}


// ---------------------------------------------------------------------------
// bf16: wgmma on the tensor cores, tiles by TMA
// ---------------------------------------------------------------------------

constexpr int K_STAGES = 2;     // ring of K tiles: the next tile's scores
constexpr int V_STAGES = 1;     // wait on it; v is needed half a step later
constexpr int WG_THREADS = 128;  // one warpgroup: 64 query rows

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
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
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

// Shared-memory geometry of one head dim: rows of SWZ bytes (the swizzle
// width, 128 B or the whole row when it is shorter), NP panels of PW
// columns side by side for hd 128, every panel 1024-byte aligned.
template <int HD> struct Tiles {
  static constexpr int SWZ = HD * 2 < 128 ? HD * 2 : 128;
  static constexpr int PW = SWZ / 2;                 // columns a panel
  static constexpr int NP = HD / PW;
  static constexpr uint32_t MODE = SWZ == 128 ? 1 : SWZ == 64 ? 2 : 3;
  static constexpr int Q_PANEL = BQ * SWZ;
  static constexpr int KV_PANEL = BKV * SWZ;
  static constexpr int Q_BYTES = Q_PANEL * NP;
  static constexpr int KV_BYTES = KV_PANEL * NP;
  static constexpr size_t SMEM =
      1024 + Q_BYTES + (K_STAGES + V_STAGES) * KV_BYTES;
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

// tile t of a block's kv range (K or V) into its slot of a ring of N
template <int HD, int N>
__device__ __forceinline__ void load_ring(const CUtensorMap* map,
                                          uint64_t* ring_bars, uint32_t ring,
                                          int t, int kt_lo, int kvh, int b) {
  using Tl = Tiles<HD>;
  load_tile<HD>(map, &ring_bars[t % N], ring + (t % N) * Tl::KV_BYTES,
                Tl::KV_BYTES, Tl::KV_PANEL, (kt_lo + t) * BKV, kvh, b);
}

// S = q k^T for one kv tile: bf16 operands from shared memory (both
// K-major), float32 accumulators; started and committed, not waited for
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

template <int HD>
__global__ void __launch_bounds__(WG_THREADS)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                   int H, int K, int Sq, int Skv, int causal, int window,
                   float scale) {
  using Tl = Tiles<HD>;
  constexpr int SC = BKV / 2;         // score accumulators a thread
  constexpr int OC = HD / 2;          // output accumulators a thread
  extern __shared__ uint8_t smem_raw[];
  // q, then the K ring, then the V ring
  __shared__ __align__(8) uint64_t bars[1 + K_STAGES + V_STAGES];
  uint64_t* kbar = bars + 1;
  uint64_t* vbar = kbar + K_STAGES;
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base;
  const uint32_t sk = sq + Tl::Q_BYTES;
  const uint32_t sv = sk + K_STAGES * Tl::KV_BYTES;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, kvh = h / (H / K);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // longest tiles first
  int kt_lo, kt_hi;
  kv_range(q0, min(q0 + BQ, Sq) - 1, Skv, causal, window, &kt_lo, &kt_hi);
  const int ntiles = kt_hi - kt_lo + 1;
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 1 + K_STAGES + V_STAGES; ++i)
      mbar_init(smem_u32(&bars[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    load_tile<HD>(&qmap, &bars[0], sq, Tl::Q_BYTES, Tl::Q_PANEL, q0, h, b);
    for (int t = 0; t < K_STAGES && t < ntiles; ++t)
      load_ring<HD, K_STAGES>(&kmap, kbar, sk, t, kt_lo, kvh, b);
    for (int t = 0; t < V_STAGES && t < ntiles; ++t)
      load_ring<HD, V_STAGES>(&vmap, vbar, sv, t, kt_lo, kvh, b);
  }
  __syncthreads();

  // this thread's rows (r, r + 8 of its warp's 16) and column pair
  const int r_loc = warp * 16 + lane / 4;
  const int cpair = (lane % 4) * 2;
  float oacc[OC];
#pragma unroll
  for (int i = 0; i < OC; ++i) oacc[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float s[SC], sn[SC];
#pragma unroll
  for (int i = 0; i < SC; ++i) s[i] = sn[i] = 0.f;

  mbar_wait(smem_u32(&bars[0]), 0);
  mbar_wait(smem_u32(&kbar[0]), 0);
  start_scores<HD>(s, sq, sk);
  wgmma_wait_all();
  hold(s);
  __syncthreads();                     // K slot 0 is read
  if (tid == 0 && K_STAGES < ntiles)
    load_ring<HD, K_STAGES>(&kmap, kbar, sk, K_STAGES, kt_lo, kvh, b);

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = (kt_lo + it) * BKV;
    // the next tile's scores run on the tensor cores under this tile's
    // softmax
    const int nx = it + 1;
    if (nx < ntiles) {
      mbar_wait(smem_u32(&kbar[nx % K_STAGES]), (nx / K_STAGES) & 1);
      start_scores<HD>(sn, sq, sk + (nx % K_STAGES) * Tl::KV_BYTES);
    }

    // scale in float32; mask only where the tile is not wholly allowed
    const bool whole = k0 + BKV <= Skv &&
        (!causal || k0 + BKV - 1 <= q0) &&
        (window == 0 || (q0 / window == (q0 + BQ - 1) / window &&
                         k0 / window == (k0 + BKV - 1) / window &&
                         q0 / window == k0 / window));
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < SC; ++i) {
      const int half = (i / 2) % 2;                  // row r or r + 8
      float x = s[i] * scale;
      if (!whole) {
        const int kpos = k0 + (i / 4) * 8 + cpair + (i % 2);
        const int qpos = q0 + r_loc + 8 * half;
        if (kpos >= Skv) {
          x = -INFINITY;                             // past the end
        } else if (!allowed(qpos, kpos, causal, window)) {
          x = NEG_INF;
        }
      }
      s[i] = x;
      mx[half] = fmaxf(mx[half], x);
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // a row's scores live on the four lanes that share lane / 4
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < SC; ++i) {
      const int half = (i / 2) % 2;
      s[i] = expf(s[i] - m[half]);
      rs[half] += s[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];   // partial
#pragma unroll
    for (int i = 0; i < OC; ++i) oacc[i] *= corr[(i / 2) % 2];
    // P rounded to bf16 in registers: the A operand, in the layout of the
    // score accumulators
    uint32_t pa[BKV / 16][4];
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        pa[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);

    // O += P v, v read as the B operand with the transpose bit
    const int slot = it % V_STAGES;
    mbar_wait(smem_u32(&vbar[slot]), (it / V_STAGES) & 1);
    const uint32_t vst = sv + slot * Tl::KV_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      Wgmma<HD>::rs(oacc, pa[kk],
                    smem_desc(vst + kk * 16 * Tl::SWZ, Tl::KV_PANEL,
                              8 * Tl::SWZ, Tl::MODE));
    wgmma_commit();
    wgmma_wait_all();
    hold(oacc);
    hold(sn);

    __syncthreads();         // V of this tile and K of the next are read
    if (tid == 0) {
      if (nx + K_STAGES < ntiles)
        load_ring<HD, K_STAGES>(&kmap, kbar, sk, nx + K_STAGES, kt_lo, kvh,
                                b);
      if (it + V_STAGES < ntiles)
        load_ring<HD, V_STAGES>(&vmap, vbar, sv, it + V_STAGES, kt_lo, kvh,
                                b);
    }
#pragma unroll
    for (int i = 0; i < SC; ++i) s[i] = sn[i];
  }

  // l: the four lanes' partial sums of each row
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
  const int64_t qrow = (int64_t)H * HD;
  __nv_bfloat16* ob = o + ((int64_t)b * Sq * H + h) * HD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r_loc + 8 * r;
    if (row >= Sq) continue;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const __nv_bfloat162 val = __floats2bfloat162_rn(
          oacc[4 * j + 2 * r] / l[r], oacc[4 * j + 2 * r + 1] / l[r]);
      *reinterpret_cast<__nv_bfloat162*>(ob + row * qrow + j * 8 + cpair) =
          val;
    }
    if (lse != nullptr && lane % 4 == 0)
      lse[(int64_t)bh * Sq + row] = m[r] + logf(l[r]);
  }
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(HD * QS + HD * KS + BKV * HD + BKV * QS);
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int H, int K, int Sq, int Skv, int causal,
               int window, float scale, cudaStream_t stream) {
  const size_t shmem = smem_bytes<HD>();
  auto kernel = flash_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * H), (unsigned)((Sq + BQ - 1) / BQ));
  kernel<<<grid, NT, shmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, H, K, Sq,
      Skv, causal, window, scale);
  return (int)cudaGetLastError();
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

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int H, int K, int Sq, int Skv, int causal,
                int window, float scale, cudaStream_t stream) {
  if (encode_tiled() == nullptr) return 1005;
  CUtensorMap qmap, kmap, vmap;
  if (!tensor_map<HD>(&qmap, q, B, Sq, H, BQ) ||
      !tensor_map<HD>(&kmap, k, B, Skv, K, BKV) ||
      !tensor_map<HD>(&vmap, v, B, Skv, K, BKV))
    return 1006;
  const size_t shmem = Tiles<HD>::SMEM;
  auto kernel = flash_wgmma_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * H), (unsigned)((Sq + BQ - 1) / BQ));
  kernel<<<grid, WG_THREADS, shmem, stream>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(o), lse, H, K, Sq, Skv,
      causal, window, scale);
  return (int)cudaGetLastError();
}

template <bool BF16, int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int K, int Sq, int Skv, int causal, int window,
           float scale, cudaStream_t stream) {
  if constexpr (BF16) {
    return launch_bf16<HD>(q, k, v, o, lse, B, H, K, Sq, Skv, causal,
                           window, scale, stream);
  } else {
    return launch_f32<HD>(q, k, v, o, lse, B, H, K, Sq, Skv, causal, window,
                          scale, stream);
  }
}

template <bool BF16>
int dispatch(const void* q, const void* k, const void* v, void* o,
             float* lse, int B, int H, int K, int Sq, int Skv, int hd,
             int causal, int window, float scale, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<BF16, 16>(q, k, v, o, lse, B, H, K, Sq, Skv,
                                     causal, window, scale, stream);
    case 32: return launch<BF16, 32>(q, k, v, o, lse, B, H, K, Sq, Skv,
                                     causal, window, scale, stream);
    case 64: return launch<BF16, 64>(q, k, v, o, lse, B, H, K, Sq, Skv,
                                     causal, window, scale, stream);
    case 128: return launch<BF16, 128>(q, k, v, o, lse, B, H, K, Sq, Skv,
                                       causal, window, scale, stream);
    default: return 1001;
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched); 1000 + k for
// an argument the kernel does not take or a tensor map it cannot make.
// is_bf16 selects the tensor-core kernel on __nv_bfloat16 inputs and
// output, else the CUDA-core kernel on float.  lse, where not null, is
// the float32 (B, H, Sq) row log-sum-exp the backward reads.
int fa_flash_attention(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int H, int K, int Sq, int Skv,
                       int hd, int causal, int window, float scale,
                       int is_bf16, void* stream) {
  if (hd != 16 && hd != 32 && hd != 64 && hd != 128) return 1001;
  if (K < 1 || H < K || H % K != 0) return 1002;
  if (B < 1 || Sq < 1 || Skv < 1 || (int64_t)B * H > 0x7FFFFFFF ||
      (Sq + BQ - 1) / BQ > 65535)
    return 1003;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) % 16)
    return 1004;
  const cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? dispatch<true>(q, k, v, o, lse, B, H, K, Sq, Skv, hd,
                                  causal, window, scale, s)
                 : dispatch<false>(q, k, v, o, lse, B, H, K, Sq, Skv, hd,
                                   causal, window, scale, s);
}

}  // extern "C"
