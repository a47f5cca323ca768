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
// 32-byte rows; hd 80, whose 160-byte rows no 128- or 64-byte swizzle
// divides, as five 16-column panels of 32-byte rows, one TMA box each, so
// nothing is padded in HBM or in shared memory).  S = q k^T is wgmma on bf16 operands from shared memory
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
// blocks an SM.  No producer warp, no register reallocation.  The same
// kernel serves hubert-xlarge's bidirectional prefill at hd 80 (B 4, S
// 2048, H = K = 16: 8.59e10 FLOP, 0.087 ms at that rate) and
// llama-3.2-vision's cross-attention, 2,048 queries over 4,096 media
// tokens with no mask (H 64, K 8, hd 128: 1.10e12 FLOP, 1.11 ms).
//
// float32 (flash_kernel): the products on the CUDA cores in float32 from
// float32 tiles in shared memory, each thread 4 query rows by 4 keys of
// the scores and 4 rows by HD / 16 columns of the output (5 at hd 80);
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

#include "flash_common.cuh"

namespace {

constexpr int NT = 256;         // threads: 16 x 16, 4 x 4 scores each
constexpr int QS = BQ + 4;      // padded stride of the transposed Q and P
constexpr int KS = BKV + 4;     // padded stride of the transposed K

__device__ __forceinline__ void load_vec(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
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

template <int HD>
constexpr size_t wgmma_smem_bytes() {
  return 1024 + Tiles<HD>::Q_BYTES +
         (K_STAGES + V_STAGES) * Tiles<HD>::KV_BYTES;
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
  wgmma_wait<0>();
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
    wgmma_wait<0>();
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
  const size_t shmem = wgmma_smem_bytes<HD>();
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
    case 80: return launch<BF16, 80>(q, k, v, o, lse, B, H, K, Sq, Skv,
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
  if (hd != 16 && hd != 32 && hd != 64 && hd != 80 && hd != 128)
    return 1001;
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
