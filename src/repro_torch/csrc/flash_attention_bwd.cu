// Flash attention backward for Hopper (sm_90a), bound through a plain C
// interface and loaded with ctypes (repro_torch/kernels/build.py).
//
//   fa_flash_attention_bwd  <- _flash_core_bwd of
//                              src/repro/models/layers.py:172
//
// The reference's training attention is jnp with a FlashAttention-2
// custom VJP (no Pallas kernel): from the forward's q, k, v, o and the
// row log-sum-exp L = m + log(l), it recomputes P = exp(S - L) a block at
// a time and forms
//
//   delta = rowsum(dO o O),  dP = dO V^T,  dS = P o (dP - delta),
//   dV = P^T dO,  dK = dS^T Qs,  dQs = dS K
//
// with Qs = q / sqrt(hd), S = Qs K^T under the causal and chunked-window
// (qpos / w == kpos / w) masks at the finite -1e30, all in float32.  The
// forward kernel (flash_attention.cu) scales in float32 inside, so the
// gradient with respect to the caller's unscaled q is dQ = dQs / sqrt(hd).
//
// Three launches a call, in both dtypes:
//   1. fa_delta_kernel: delta = rowsum(dO o O) in float32 from the
//      inputs' dtype, one warp a (b, i, h) row;
//   2. dK and dV, one block a (b, kv head, 64-key tile).  It keeps its K
//      and V tile in shared memory and its dK and dV tile in float32
//      registers for the whole launch, and loops over the G query heads
//      that read this kv head (GQA: query head h reads kv head h / G) and
//      over the 64-row query tiles the forward paired with this kv tile
//      (the forward's own kv_range, so the same pairs are skipped), in
//      one fixed order; dK and dV are rounded once, when written;
//   3. dQ, one block a (b, head, 64-row query tile), looping over the
//      query tile's kv_range in tile order, recomputing S and dP, with
//      dQ in float32 registers, scaled and rounded once.
// No sum crosses blocks, so there is no workspace and no atomic: a run
// repeats bit for bit (a restart from a checkpoint retraces the
// uninterrupted run).
//
// bf16 (fa_dkdv_wgmma_kernel, fa_dq_wgmma_kernel; the training path):
// every product on the tensor cores.  One warpgroup owns a 64-row tile
// (wgmma's M); thread 0 brings tiles by TMA in the 128-byte-swizzled
// layout wgmma's descriptors read (the forward's machinery,
// flash_common.cuh), the streamed ones through a ring of two.  The
// dK/dV block computes S^T = K q^T and dP^T = V dO^T from shared memory,
// so P^T and dS^T come out in the accumulator layout that is wgmma's
// register A operand; dV += P^T dO and dK += dS^T q read dO and q as B
// with the transpose bit, as the forward's P v reads v.  The dQ block
// computes S = q K^T and dP = dO V^T the same way and dQ += dS K.  S and
// dP take bf16 operands exactly.  P and dS do not: one bf16 rounding of
// each (what FA-2, FA-3 and SDPA do) misses the float32 reference by up
// to 1.9x the bf16 gate (chip_smoke.FLASH_BWD_TOL, two ulps over 2^-10 of
// the largest entry), so each enters its products as a pair hi =
// bf16(x), lo = bf16(x - hi), two wgmmas a product, which keeps the
// error near a third of the gate (tests/test_torch_flash_bwd.py
// emulates this arithmetic).  The scale 1/sqrt(hd) multiplies S in
// float32 after its product, and dK and dQ once at the end.  Rows past
// Sq and keys past Skv arrive from TMA as zeros and get P = 0 explicitly
// (exp(0 - L) is not 0).
//
// Bound at qwen3-1.7b's training shape (B 4, S 2048, H 16, K 8, hd 128,
// causal): the function's five products of 2 B H S^2 hd / 2 FLOP each,
// 171.9 GFLOP, 0.174 ms at the 989 TFLOP/s bf16 tensor-core rate, against
// ~0.2 GB of q, k, v, o, dO, L, dq, dk, dv (0.06 ms at 3.35 TB/s): bound
// by operations.  This design does ten: S and dP in both passes, and dV,
// dK and dQ as two products each, 0.347 ms.  On an H100 80GB HBM3 at
// 700 W a call takes 0.80 ms (dK / dV 0.41, dQ 0.30, delta 0.03;
// kernel_ab.py), about SDPA's backward.  What holds it from the bound is
// latency: one warpgroup a block waits on its own products and its
// exponentials, and the registers (dK and dV, 128 float32 a thread at hd
// 128, beside S^T and dP^T: 255 in all) allow two blocks an SM.
//
// Head dims 16, 32, 64, 80 and 128.  At hd 80 (hubert-xlarge) a 160-byte
// row fits no 128- or 64-byte swizzle, so a tile is five 16-column panels
// of 32-byte swizzled rows (Tiles<80>, the forward's layout: one TMA box
// a panel, 10 KB a 64-row tile, nothing padded): S^T = K q^T and dP^T =
// V dO^T take one k16 step a panel, and dV, dK and dQ run wgmma's N = 80
// over the five panels, whose leading byte offset steps a panel, as the
// forward's O += P V does.  ptxas gives the dK / dV kernel 213 registers
// and the dQ kernel 168 at hd 80, no spill (255 and no spill at hd 128);
// the float32 kernels at hd 80 take 128 registers with 4 and 36 bytes
// spilled.  On an H100 80GB HBM3 at 700 W (chip_smoke.py's timing
// phase) a call at hubert's training shape (B 4, S 2,048, 16 heads,
// bidirectional) takes 1.15 ms against a 0.217 ms bound, and at
// llama-3.2-vision's cross shape (2,048 queries over 4,096 keys, 64 / 8
// heads, hd 128, no mask) 10.2 ms against 2.78.
//
// float32 (fa_bwd_kernel for dK and dV, fa_dq_kernel for dQ): the same
// passes on the CUDA cores in float32 from float32 tiles in shared memory,
// 4 x 4 register tiles a thread, 256 threads; TF32 tensor cores keep too
// few digits for the float32 gate, as in the forward.

#include "flash_common.cuh"

namespace {

constexpr int NT = 256;         // float32 kernels: 16 x 16 threads
constexpr int PS = BKV + 4;     // padded row stride of P and dS
constexpr int STAGES = 2;       // ring of streamed tiles (bf16 kernels)

// The float32 kernels take the masks where a pair is not allowed; the
// bf16 kernels test only tiles that are not wholly allowed and in range.
__device__ __forceinline__ bool tile_whole(int q0, int k0, int Sq, int Skv,
                                           int causal, int window) {
  return q0 + BQ <= Sq && k0 + BKV <= Skv &&
         (!causal || k0 + BKV - 1 <= q0) &&
         (window == 0 || (q0 / window == (q0 + BQ - 1) / window &&
                          k0 / window == (k0 + BKV - 1) / window &&
                          q0 / window == k0 / window));
}

// P = exp(S / sqrt(hd) - L) of one (query, key) pair from its unscaled
// score s, at the reference's -1e30 where the mask forbids it, and 0 for
// a row past Sq or a key past Skv
__device__ __forceinline__ float prob(float s, float L, int qpos, int kpos,
                                      bool whole, int Sq, int Skv,
                                      int causal, int window, float scale) {
  if (whole) return expf(s * scale - L);
  if (qpos >= Sq || kpos >= Skv) return 0.f;
  const float x = allowed(qpos, kpos, causal, window) ? s * scale : NEG_INF;
  return expf(x - L);
}

// delta = rowsum(dO o O) a (b, i, h) row
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
fa_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                float* __restrict__ delta, int64_t rows, int H, int Sq) {
  const int lane = threadIdx.x % 32;
  const int64_t row = (int64_t)blockIdx.x * (NT / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const int64_t base = row * HD;
  float sum = 0.f;
  for (int d = lane; d < HD; d += 32)
    sum += to_f32(dout[base + d]) * to_f32(o[base + d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) {
    const int h = (int)(row % H);
    const int64_t bi = row / H;                  // b * Sq + i
    const int i = (int)(bi % Sq);
    const int64_t b = bi / Sq;
    delta[(b * H + h) * Sq + i] = sum;
  }
}

// ---------------------------------------------------------------------------
// bf16: wgmma on the tensor cores, tiles by TMA
// ---------------------------------------------------------------------------

// x (a 64 x 64 accumulator tile, this thread's 32) as the register A
// operand of four k16 steps, twice: hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split_bf16(const float (&x)[BKV / 2],
                                           uint32_t (&hi)[BKV / 16][4],
                                           uint32_t (&lo)[BKV / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float a = x[8 * kk + 2 * j], b = x[8 * kk + 2 * j + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
      hi[kk][j] = *reinterpret_cast<const uint32_t*>(&h);
      lo[kk][j] = pack_bf16(a - __low2float(h), b - __high2float(h));
    }
}

// d (64 x HD) += (hi + lo) B for the register A pair of a 64 x 64 tile and
// B, a 64-row tile of HD columns in shared memory read with the transpose
// bit; issued, not committed
template <int HD>
__device__ __forceinline__ void add_split_product(
    float (&d)[HD / 2], const uint32_t (&hi)[BKV / 16][4],
    const uint32_t (&lo)[BKV / 16][4], uint32_t tile) {
  using Tl = Tiles<HD>;
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk) {
    const uint64_t db = smem_desc(tile + kk * 16 * Tl::SWZ, Tl::KV_PANEL,
                                  8 * Tl::SWZ, Tl::MODE);
    Wgmma<HD>::rs(d, hi[kk], db);
    Wgmma<HD>::rs(d, lo[kk], db);
  }
}

// The next query tile, from qt on, whose kv_range holds kv tile kt (n_q
// if none): the pairs the forward computed, in query-tile order
__device__ __forceinline__ int next_q_tile(int qt, int n_q, int kt, int Sq,
                                           int Skv, int causal, int window) {
  for (; qt < n_q; ++qt) {
    int lo, hi;
    kv_range(qt * BQ, min(qt * BQ + BQ, Sq) - 1, Skv, causal, window, &lo,
             &hi);
    if (lo <= kt && kt <= hi) break;
  }
  return qt;
}

template <int HD>
constexpr size_t wgmma_smem_bytes() {
  // two resident 64-row tiles and a ring of STAGES pairs
  return 1024 + (size_t)(2 + 2 * STAGES) * Tiles<HD>::KV_BYTES;
}

// this thread's rows (r, r + 8) and column pair in a wgmma accumulator
__device__ __forceinline__ int acc_row() {
  return (threadIdx.x / 32) * 16 + (threadIdx.x % 32) / 4;
}
__device__ __forceinline__ int acc_col() { return (threadIdx.x % 4) * 2; }

// rows row0 .. row0 + 63 of a (B, S, heads, HD) bf16 tensor from a 64 x HD
// float32 accumulator, times mul, rounded once; rows past S are dropped
template <int HD>
__device__ __forceinline__ void store_tile(__nv_bfloat16* base,
                                           int64_t row_stride, int row0,
                                           int S, const float (&acc)[HD / 2],
                                           float mul) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + acc_row() + 8 * r;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(base + row * row_stride + j * 8 +
                                         acc_col()) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] * mul,
                                acc[4 * j + 2 * r + 1] * mul);
  }
}

template <int HD>
__global__ void __launch_bounds__(WG_THREADS)
fa_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const __grid_constant__ CUtensorMap domap,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int H, int K, int Sq,
                     int Skv, int causal, int window, float scale) {
  using Tl = Tiles<HD>;
  constexpr int SC = BQ / 2;          // S^T / dP^T accumulators a thread
  constexpr int OC = HD / 2;          // dK / dV accumulators a thread
  extern __shared__ uint8_t smem_raw[];
  // K, V, then each ring slot's q and dO
  __shared__ __align__(8) uint64_t bars[2 + 2 * STAGES];
  __shared__ float Ls[STAGES][BQ], Ds[STAGES][BQ];
  uint64_t* qbar = bars + 2;
  uint64_t* dobar = qbar + STAGES;
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sk = base, sv = sk + Tl::KV_BYTES;
  const uint32_t ring = sv + Tl::KV_BYTES;     // slot s: q, then dO

  const int tid = threadIdx.x;
  const int G = H / K;
  const int b = blockIdx.x / K, kvh = blockIdx.x % K;
  const int kt = blockIdx.y, k0 = kt * BKV;    // the longest loops first
  const int n_q = (Sq + BQ - 1) / BQ;
  const int first = next_q_tile(0, n_q, kt, Sq, Skv, causal, window);
  auto advance = [&](int& g, int& qt) {
    qt = next_q_tile(qt + 1, n_q, kt, Sq, Skv, causal, window);
    if (qt == n_q) {
      ++g;
      qt = first;
    }
  };
  auto slot_q = [&](int s) { return ring + 2 * s * Tl::Q_BYTES; };
  // the (head, query tile) the ring loads next runs STAGES ahead of the
  // one computed; thread 0 brings its q and dO, the first BQ threads its
  // L and delta
  int lg = 0, lq = first;
  auto load = [&](int s) {
    const int h = kvh * G + lg, q0 = lq * BQ;
    if (tid == 0) {
      load_tile<HD>(&qmap, &qbar[s], slot_q(s), Tl::Q_BYTES, Tl::Q_PANEL,
                    q0, h, b);
      load_tile<HD>(&domap, &dobar[s], slot_q(s) + Tl::Q_BYTES, Tl::Q_BYTES,
                    Tl::Q_PANEL, q0, h, b);
    }
    advance(lg, lq);
  };
  auto stats = [&](int g, int qt, float* l, float* d) {
    const int row = qt * BQ + tid;
    const int64_t at = ((int64_t)b * H + kvh * G + g) * Sq + row;
    *l = row < Sq ? lse[at] : 0.f;
    *d = row < Sq ? delta[at] : 0.f;
  };
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 2 + 2 * STAGES; ++i)
      mbar_init(smem_u32(&bars[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (first < n_q) {
      load_tile<HD>(&kmap, &bars[0], sk, Tl::KV_BYTES, Tl::KV_PANEL, k0, kvh,
                    b);
      load_tile<HD>(&vmap, &bars[1], sv, Tl::KV_BYTES, Tl::KV_PANEL, k0, kvh,
                    b);
    }
  }
  for (int s = 0; s < STAGES && lq < n_q && lg < G; ++s) {
    if (tid < BQ) stats(lg, lq, &Ls[s][tid], &Ds[s][tid]);
    load(s);
  }
  __syncthreads();

  const int r_loc = acc_row(), cpair = acc_col();
  float dka[OC], dva[OC];
#pragma unroll
  for (int i = 0; i < OC; ++i) dka[i] = dva[i] = 0.f;
  float st[SC], dpt[SC];      // overwritten by each tile's first wgmma
#pragma unroll
  for (int i = 0; i < SC; ++i) st[i] = dpt[i] = 0.f;
  if (first < n_q) {
    mbar_wait(smem_u32(&bars[0]), 0);
    mbar_wait(smem_u32(&bars[1]), 0);
  }

  int it = 0;
  for (int g = 0, qt = first; qt < n_q && g < G; advance(g, qt), ++it) {
    const int s = it % STAGES;
    const uint32_t par = (it / STAGES) & 1;
    const int q0 = qt * BQ;
    const bool more = lq < n_q && lg < G;
    float next_l = 0.f, next_d = 0.f;        // the tile STAGES ahead
    if (more && tid < BQ) stats(lg, lq, &next_l, &next_d);

    // S^T = K q^T and dP^T = V dO^T: 64 keys x 64 query rows
    mbar_wait(smem_u32(&qbar[s]), par);
    start_scores<HD>(st, sk, slot_q(s));
    mbar_wait(smem_u32(&dobar[s]), par);
    start_scores<HD>(dpt, sv, slot_q(s) + Tl::Q_BYTES);
    wgmma_wait<1>();
    hold(st);
    const bool whole = tile_whole(q0, k0, Sq, Skv, causal, window);
#pragma unroll
    for (int i = 0; i < SC; ++i) {
      const int col = (i / 4) * 8 + cpair + (i % 2);      // query row
      st[i] = prob(st[i], Ls[s][col], q0 + col, k0 + r_loc + 8 * ((i / 2) % 2),
                   whole, Sq, Skv, causal, window, scale);
    }
    wgmma_wait<0>();
    hold(dpt);
#pragma unroll
    for (int i = 0; i < SC; ++i) {
      const int col = (i / 4) * 8 + cpair + (i % 2);
      dpt[i] = st[i] * (dpt[i] - Ds[s][col]);
    }

    // dV += P^T dO and dK += dS^T q, each operand a bf16 pair
    uint32_t ph[BQ / 16][4], pl[BQ / 16][4], dh[BQ / 16][4], dl[BQ / 16][4];
    split_bf16(st, ph, pl);
    split_bf16(dpt, dh, dl);
    wgmma_fence();
    add_split_product<HD>(dva, ph, pl, slot_q(s) + Tl::Q_BYTES);
    add_split_product<HD>(dka, dh, dl, slot_q(s));
    wgmma_commit();
    wgmma_wait<0>();
    hold(dva);
    hold(dka);

    __syncthreads();          // slot s and its L and delta are read
    if (more) {
      if (tid < BQ) {
        Ls[s][tid] = next_l;
        Ds[s][tid] = next_d;
      }
      load(s);
    }
  }

  const int64_t kvrow = (int64_t)K * HD;
  const int64_t off = ((int64_t)b * Skv * K + kvh) * HD;
  store_tile<HD>(dk + off, kvrow, k0, Skv, dka, scale);
  store_tile<HD>(dv + off, kvrow, k0, Skv, dva, 1.f);
}

template <int HD>
__global__ void __launch_bounds__(WG_THREADS)
fa_dq_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const __grid_constant__ CUtensorMap domap,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dq, int H, int K, int Sq,
                   int Skv, int causal, int window, float scale) {
  using Tl = Tiles<HD>;
  constexpr int SC = BKV / 2;         // S / dP accumulators a thread
  constexpr int OC = HD / 2;          // dQ accumulators a thread
  extern __shared__ uint8_t smem_raw[];
  // q, dO, then each ring slot's K and V
  __shared__ __align__(8) uint64_t bars[2 + 2 * STAGES];
  uint64_t* kbar = bars + 2;
  uint64_t* vbar = kbar + STAGES;
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base, sdo = sq + Tl::Q_BYTES;
  const uint32_t ring = sdo + Tl::Q_BYTES;     // slot s: K, then V

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, kvh = h / (H / K);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // longest tiles first
  int kt_lo, kt_hi;
  kv_range(q0, min(q0 + BQ, Sq) - 1, Skv, causal, window, &kt_lo, &kt_hi);
  const int ntiles = kt_hi - kt_lo + 1;
  auto slot_k = [&](int s) { return ring + 2 * s * Tl::KV_BYTES; };
  auto load = [&](int t) {
    const int s = t % STAGES;
    load_tile<HD>(&kmap, &kbar[s], slot_k(s), Tl::KV_BYTES, Tl::KV_PANEL,
                  (kt_lo + t) * BKV, kvh, b);
    load_tile<HD>(&vmap, &vbar[s], slot_k(s) + Tl::KV_BYTES, Tl::KV_BYTES,
                  Tl::KV_PANEL, (kt_lo + t) * BKV, kvh, b);
  };
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 2 + 2 * STAGES; ++i)
      mbar_init(smem_u32(&bars[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    load_tile<HD>(&qmap, &bars[0], sq, Tl::Q_BYTES, Tl::Q_PANEL, q0, h, b);
    load_tile<HD>(&domap, &bars[1], sdo, Tl::Q_BYTES, Tl::Q_PANEL, q0, h,
                  b);
    for (int t = 0; t < STAGES && t < ntiles; ++t) load(t);
  }
  // this thread's two rows' L and delta
  const int r_loc = acc_row(), cpair = acc_col();
  float Lr[2], Dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r_loc + 8 * r;
    Lr[r] = row < Sq ? lse[(int64_t)bh * Sq + row] : 0.f;
    Dr[r] = row < Sq ? delta[(int64_t)bh * Sq + row] : 0.f;
  }
  __syncthreads();

  float dqa[OC];
#pragma unroll
  for (int i = 0; i < OC; ++i) dqa[i] = 0.f;
  float s[SC], dp[SC];        // overwritten by each tile's first wgmma
#pragma unroll
  for (int i = 0; i < SC; ++i) s[i] = dp[i] = 0.f;
  mbar_wait(smem_u32(&bars[0]), 0);
  mbar_wait(smem_u32(&bars[1]), 0);

  for (int it = 0; it < ntiles; ++it) {
    const int slot = it % STAGES;
    const uint32_t par = (it / STAGES) & 1;
    const int k0 = (kt_lo + it) * BKV;

    // S = q K^T and dP = dO V^T: 64 query rows x 64 keys
    mbar_wait(smem_u32(&kbar[slot]), par);
    start_scores<HD>(s, sq, slot_k(slot));
    mbar_wait(smem_u32(&vbar[slot]), par);
    start_scores<HD>(dp, sdo, slot_k(slot) + Tl::KV_BYTES);
    wgmma_wait<1>();
    hold(s);
    const bool whole = tile_whole(q0, k0, Sq, Skv, causal, window);
#pragma unroll
    for (int i = 0; i < SC; ++i) {
      const int half = (i / 2) % 2;
      s[i] = prob(s[i], Lr[half], q0 + r_loc + 8 * half,
                  k0 + (i / 4) * 8 + cpair + (i % 2), whole, Sq, Skv, causal,
                  window, scale);
    }
    wgmma_wait<0>();
    hold(dp);
#pragma unroll
    for (int i = 0; i < SC; ++i) dp[i] = s[i] * (dp[i] - Dr[(i / 2) % 2]);

    // dQ += dS K, dS a bf16 pair
    uint32_t dh[BKV / 16][4], dl[BKV / 16][4];
    split_bf16(dp, dh, dl);
    wgmma_fence();
    add_split_product<HD>(dqa, dh, dl, slot_k(slot));
    wgmma_commit();
    wgmma_wait<0>();
    hold(dqa);

    __syncthreads();          // slot's K and V are read
    if (tid == 0 && it + STAGES < ntiles) load(it + STAGES);
  }

  store_tile<HD>(dq + ((int64_t)b * Sq * H + h) * HD, (int64_t)H * HD, q0,
                 Sq, dqa, scale);
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v,
                const void* dout, const float* lse, const float* delta,
                void* dq, void* dk, void* dv, int B, int H, int K, int Sq,
                int Skv, int causal, int window, float scale,
                cudaStream_t stream) {
  if (encode_tiled() == nullptr) return 1005;
  CUtensorMap qmap, kmap, vmap, domap;
  if (!tensor_map<HD>(&qmap, q, B, Sq, H, BQ) ||
      !tensor_map<HD>(&kmap, k, B, Skv, K, BKV) ||
      !tensor_map<HD>(&vmap, v, B, Skv, K, BKV) ||
      !tensor_map<HD>(&domap, dout, B, Sq, H, BQ))
    return 1006;
  const size_t shmem = wgmma_smem_bytes<HD>();
  auto dkdv = fa_dkdv_wgmma_kernel<HD>;
  auto dqk = fa_dq_wgmma_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (err != cudaSuccess) return (int)err;
  dkdv<<<dim3((unsigned)(B * K), (unsigned)((Skv + BKV - 1) / BKV)),
         WG_THREADS, shmem, stream>>>(
      qmap, kmap, vmap, domap, lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), H, K, Sq, Skv, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dqk<<<dim3((unsigned)(B * H), (unsigned)((Sq + BQ - 1) / BQ)), WG_THREADS,
        shmem, stream>>>(qmap, kmap, vmap, domap, lse, delta,
                         static_cast<__nv_bfloat16*>(dq), H, K, Sq, Skv,
                         causal, window, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32: products on the CUDA cores
// ---------------------------------------------------------------------------

__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

// rows row0 .. row0 + 63 of one head of a (B, S, heads, HD) tensor into a
// [64][HD + 4] float tile, times mul; rows past S are zeros
template <int HD>
__device__ __forceinline__ void load_rows(float* dst, const float* base,
                                          int64_t row_stride, int row0,
                                          int S, float mul, int tid) {
  constexpr int RS = HD + 4;
  for (int idx = tid * 4; idx < 64 * HD; idx += NT * 4) {
    const int r = idx / HD, d = idx % HD;
    float vals[4] = {0.f, 0.f, 0.f, 0.f};
    if (row0 + r < S) load4(base + (row0 + r) * row_stride + d, vals);
    *reinterpret_cast<float4*>(&dst[r * RS + d]) =
        make_float4(vals[0] * mul, vals[1] * mul, vals[2] * mul,
                    vals[3] * mul);
  }
}

// S = Qs K^T and dP = dO V^T for query rows ty*4 + a and keys tx + 16 c
// from [64][HD + 4] tiles
template <int HD>
__device__ __forceinline__ void scores_f32(const float* Qs, const float* Ks,
                                           const float* dOs, const float* Vs,
                                           int tx, int ty, float (&s)[4][4],
                                           float (&dp)[4][4]) {
  constexpr int RS = HD + 4;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[a][c] = dp[a][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float qa[4][4], kb[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a) load4(&Qs[(ty * 4 + a) * RS + d], qa[a]);
#pragma unroll
    for (int c = 0; c < 4; ++c) load4(&Ks[(tx + 16 * c) * RS + d], kb[c]);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[a][c] = fmaf(qa[a][e], kb[c][e], s[a][c]);
  }
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float oa[4][4], vb[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a) load4(&dOs[(ty * 4 + a) * RS + d], oa[a]);
#pragma unroll
    for (int c = 0; c < 4; ++c) load4(&Vs[(tx + 16 * c) * RS + d], vb[c]);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[a][c] = fmaf(oa[a][e], vb[c][e], dp[a][c]);
  }
}

// dK and dV of one (b, kv head, 64-key tile)
template <int HD>
__global__ void __launch_bounds__(NT)
fa_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dk, float* __restrict__ dv, int H, int K,
              int Sq, int Skv, int causal, int window, float scale) {
  constexpr int RS = HD + 4;              // padded row stride of the tiles
  constexpr int CPT = HD / 16;            // head-dim columns a thread
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                       // [BKV][RS]  k tile
  float* Vs = Ks + BKV * RS;              // [BKV][RS]  v tile
  float* Qs = Vs + BKV * RS;              // [BQ][RS]   q * scale
  float* dOs = Qs + BQ * RS;              // [BQ][RS]   dO
  float* Ps = dOs + BQ * RS;              // [BQ][PS]   P
  float* dSs = Ps + BQ * PS;              // [BQ][PS]   dS
  float* Ls = dSs + BQ * PS;              // [BQ]       L
  float* Ds = Ls + BQ;                    // [BQ]       delta

  const int G = H / K;
  const int b = blockIdx.x / K, kvh = blockIdx.x % K;
  const int kt = blockIdx.y;              // the longest loops first
  const int k0 = kt * BKV;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int64_t qrow = (int64_t)H * HD, kvrow = (int64_t)K * HD;
  const int64_t kv_off = ((int64_t)b * Skv * K + kvh) * HD;

  load_rows<HD>(Ks, k + kv_off, kvrow, k0, Skv, 1.f, tid);
  load_rows<HD>(Vs, v + kv_off, kvrow, k0, Skv, 1.f, tid);

  // dK and dV: keys ty*4 + a, columns tx + 16 c
  float dk_acc[4][CPT], dv_acc[4][CPT];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < CPT; ++c) dk_acc[a][c] = dv_acc[a][c] = 0.f;

  const int n_q = (Sq + BQ - 1) / BQ;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const int64_t q_off = ((int64_t)b * Sq * H + h) * HD;
    const float* lse_h = lse + ((int64_t)b * H + h) * Sq;
    const float* delta_h = delta + ((int64_t)b * H + h) * Sq;
    for (int qt = 0; qt < n_q; ++qt) {
      const int q0 = qt * BQ;
      int lo, hi;
      kv_range(q0, min(q0 + BQ, Sq) - 1, Skv, causal, window, &lo, &hi);
      if (kt < lo || kt > hi) continue;

      __syncthreads();                    // the last tile's reads are done
      load_rows<HD>(Qs, q + q_off, qrow, q0, Sq, scale, tid);
      load_rows<HD>(dOs, dout + q_off, qrow, q0, Sq, 1.f, tid);
      if (tid < BQ) {
        const bool in = q0 + tid < Sq;
        Ls[tid] = in ? lse_h[q0 + tid] : 0.f;
        Ds[tid] = in ? delta_h[q0 + tid] : 0.f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];
      scores_f32<HD>(Qs, Ks, dOs, Vs, tx, ty, s, dp);
      // P under the mask, 0 for rows past Sq and keys past Skv; dS =
      // P (dP - delta)
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int r = ty * 4 + a;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = tx + 16 * c;
          const float p = prob(s[a][c], Ls[r], q0 + r, k0 + j, false, Sq,
                               Skv, causal, window, 1.f);
          Ps[r * PS + j] = p;
          dSs[r * PS + j] = p * (dp[a][c] - Ds[r]);
        }
      }
      __syncthreads();

      // dV += P^T dO and dK += dS^T Qs: keys ty*4 + a, columns tx + 16 c
#pragma unroll 2
      for (int i = 0; i < BQ; ++i) {
        float p4[4], ds4[4];
        load4(&Ps[i * PS + ty * 4], p4);
        load4(&dSs[i * PS + ty * 4], ds4);
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const float dov = dOs[i * RS + tx + 16 * c];
          const float qv = Qs[i * RS + tx + 16 * c];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            dv_acc[a][c] = fmaf(p4[a], dov, dv_acc[a][c]);
            dk_acc[a][c] = fmaf(ds4[a], qv, dk_acc[a][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int key = k0 + ty * 4 + a;
    if (key >= Skv) continue;
    const int64_t at = kv_off + key * kvrow + tx;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      dk[at + 16 * c] = dk_acc[a][c];
      dv[at + 16 * c] = dv_acc[a][c];
    }
  }
}

// dQ of one (b, head, 64-row query tile), over its kv_range in tile order
template <int HD>
__global__ void __launch_bounds__(NT)
fa_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ dq, int H, int K, int Sq, int Skv,
             int causal, int window, float scale) {
  constexpr int RS = HD + 4;
  constexpr int CPT = HD / 16;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                       // [BQ][RS]   q * scale
  float* dOs = Qs + BQ * RS;              // [BQ][RS]   dO
  float* Ks = dOs + BQ * RS;              // [BKV][RS]  k tile
  float* Vs = Ks + BKV * RS;              // [BKV][RS]  v tile
  float* dSs = Vs + BKV * RS;             // [BQ][PS]   dS

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, kvh = h / (H / K);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // longest tiles first
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int64_t qrow = (int64_t)H * HD, kvrow = (int64_t)K * HD;
  const int64_t q_off = ((int64_t)b * Sq * H + h) * HD;
  const int64_t kv_off = ((int64_t)b * Skv * K + kvh) * HD;

  load_rows<HD>(Qs, q + q_off, qrow, q0, Sq, scale, tid);
  load_rows<HD>(dOs, dout + q_off, qrow, q0, Sq, 1.f, tid);
  float Lr[4], Dr[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + ty * 4 + a;
    Lr[a] = row < Sq ? lse[(int64_t)bh * Sq + row] : 0.f;
    Dr[a] = row < Sq ? delta[(int64_t)bh * Sq + row] : 0.f;
  }
  int lo, hi;
  kv_range(q0, min(q0 + BQ, Sq) - 1, Skv, causal, window, &lo, &hi);

  // dQs: query rows ty*4 + a, columns tx + 16 c
  float dq_acc[4][CPT];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < CPT; ++c) dq_acc[a][c] = 0.f;

  for (int kt = lo; kt <= hi; ++kt) {
    const int k0 = kt * BKV;
    __syncthreads();                      // the last tile's reads are done
    load_rows<HD>(Ks, k + kv_off, kvrow, k0, Skv, 1.f, tid);
    load_rows<HD>(Vs, v + kv_off, kvrow, k0, Skv, 1.f, tid);
    __syncthreads();

    float s[4][4], dp[4][4];
    scores_f32<HD>(Qs, Ks, dOs, Vs, tx, ty, s, dp);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ty * 4 + a;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = tx + 16 * c;
        const float p = prob(s[a][c], Lr[a], q0 + r, k0 + j, false, Sq, Skv,
                             causal, window, 1.f);
        dSs[r * PS + j] = p * (dp[a][c] - Dr[a]);
      }
    }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < BKV; j += 4) {
      float ds4[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a) load4(&dSs[(ty * 4 + a) * PS + j], ds4[a]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const float kv = Ks[(j + e) * RS + tx + 16 * c];
#pragma unroll
          for (int a = 0; a < 4; ++a)
            dq_acc[a][c] = fmaf(ds4[a][e], kv, dq_acc[a][c]);
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + ty * 4 + a;
    if (row >= Sq) continue;
    float* dst = dq + q_off + row * qrow + tx;
#pragma unroll
    for (int c = 0; c < CPT; ++c) dst[16 * c] = dq_acc[a][c] * scale;
  }
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v,
               const void* dout, const float* lse, const float* delta,
               void* dq, void* dk, void* dv, int B, int H, int K, int Sq,
               int Skv, int causal, int window, float scale,
               cudaStream_t stream) {
  constexpr size_t tile = sizeof(float) * 64 * (HD + 4);
  const size_t shmem_kv = 4 * tile + sizeof(float) * (2 * BQ * PS + 2 * BQ);
  const size_t shmem_q = 4 * tile + sizeof(float) * BQ * PS;
  auto dkdv = fa_bwd_kernel<HD>;
  auto dqk = fa_dq_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem_kv);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem_q);
  if (err != cudaSuccess) return (int)err;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* df = static_cast<const float*>(dout);
  dkdv<<<dim3((unsigned)(B * K), (unsigned)((Skv + BKV - 1) / BKV)), NT,
         shmem_kv, stream>>>(qf, kf, vf, df, lse, delta,
                             static_cast<float*>(dk), static_cast<float*>(dv),
                             H, K, Sq, Skv, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dqk<<<dim3((unsigned)(B * H), (unsigned)((Sq + BQ - 1) / BQ)), NT,
        shmem_q, stream>>>(qf, kf, vf, df, lse, delta,
                           static_cast<float*>(dq), H, K, Sq, Skv, causal,
                           window, scale);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int B, int H, int K, int Sq, int Skv,
           int causal, int window, float scale, cudaStream_t stream) {
  const int64_t rows = (int64_t)B * Sq * H;
  const unsigned delta_blocks = (unsigned)((rows + NT / 32 - 1) / (NT / 32));
  fa_delta_kernel<T, HD><<<delta_blocks, NT, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, rows, H,
      Sq);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if constexpr (sizeof(T) == 2) {
    return launch_bf16<HD>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, K,
                           Sq, Skv, causal, window, scale, stream);
  } else {
    return launch_f32<HD>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, K,
                          Sq, Skv, causal, window, scale, stream);
  }
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const float* lse, float* delta, void* dq,
             void* dk, void* dv, int B, int H, int K, int Sq, int Skv, int hd,
             int causal, int window, float scale, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                  B, H, K, Sq, Skv, causal, window, scale, s);
    case 32: return launch<T, 32>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                  B, H, K, Sq, Skv, causal, window, scale, s);
    case 64: return launch<T, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                  B, H, K, Sq, Skv, causal, window, scale, s);
    case 80: return launch<T, 80>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                  B, H, K, Sq, Skv, causal, window, scale, s);
    case 128: return launch<T, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                    B, H, K, Sq, Skv, causal, window, scale,
                                    s);
    default: return 1001;
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launches (0 = launched); 1000 + k
// for an argument the kernels do not take or a tensor map they cannot
// make.  q, o, dout and dq are (B, Sq, H, hd), k, v, dk and dv (B, Skv,
// K, hd), all __nv_bfloat16 when is_bf16 (the tensor-core kernels) else
// float (the CUDA-core kernels); lse (the forward's L) and the scratch
// delta are float32 (B, H, Sq), allocated by the caller.
int fa_flash_attention_bwd(const void* q, const void* k, const void* v,
                           const void* o, const void* dout, const float* lse,
                           float* delta, void* dq, void* dk, void* dv, int B,
                           int H, int K, int Sq, int Skv, int hd, int causal,
                           int window, float scale, int is_bf16,
                           void* stream) {
  if (hd != 16 && hd != 32 && hd != 64 && hd != 80 && hd != 128)
    return 1001;
  if (K < 1 || H < K || H % K != 0) return 1002;
  if (B < 1 || Sq < 1 || Skv < 1 || (int64_t)B * H > 0x7FFFFFFF ||
      (Skv + BKV - 1) / BKV > 65535 || (Sq + BQ - 1) / BQ > 65535 ||
      ((int64_t)B * Sq * H + NT / 32 - 1) / (NT / 32) > 0x7FFFFFFF)
    return 1003;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
       reinterpret_cast<uintptr_t>(dout) | reinterpret_cast<uintptr_t>(dq) |
       reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv)) %
      16)
    return 1004;
  const cudaStream_t s = (cudaStream_t)stream;
  return is_bf16
             ? dispatch<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq, dk,
                                       dv, B, H, K, Sq, Skv, hd, causal,
                                       window, scale, s)
             : dispatch<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, B,
                               H, K, Sq, Skv, hd, causal, window, scale, s);
}

}  // extern "C"
