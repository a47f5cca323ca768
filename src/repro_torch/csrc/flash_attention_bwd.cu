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
// (qpos / w == kpos / w) masks at the finite -1e30.  The forward kernel
// (flash_attention.cu) scales q in float32 inside, so the gradient with
// respect to the caller's unscaled q is dQ = dQs / sqrt(hd): the chain
// rule through the scale, applied here once in float32.
//
// Three launches a call:
//   1. fa_delta_kernel: delta = rowsum(dO o O) in float32, one warp a
//      (b, i, h) row;
//   2. fa_bwd_kernel: one block a (b, kv head, 64-key tile).  It holds
//      its K and V tile in shared memory and its dK and dV tile in
//      registers for the whole launch, and loops over the G query heads
//      that read this kv head (GQA: query head h reads kv head h / G) and
//      over the 64-row query tiles the forward paired with this kv tile
//      (the forward's own kv_range, so the same tiles are skipped).  Per
//      (head, query tile) it recomputes S and dP, forms P and dS in
//      shared memory, adds P^T dO and dS^T Qs to dV and dK, and stores
//      its dS K, this kv tile's part of the query rows' dQ, in the tile's
//      own slice of a float32 workspace (n_kv, B, Sq, H, hd) (dK and dV
//      sum over the G heads in float32 and are rounded once, when
//      written);
//   3. fa_dq_kernel: dQ = the sum of a row's parts over the kv tiles its
//      query tile visited, in tile order, / sqrt(hd), rounded once to the
//      inputs' dtype.
// The dQ sum goes through the workspace, not atomics, so it is in one
// fixed order and the backward is deterministic: a run repeats bit for
// bit (a restart from a checkpoint retraces the uninterrupted run).  The
// price is the workspace: n_kv parts of dQ in float32, 2.1 GB at
// qwen3-1.7b's training shape, written and read once.
//
// All products on the CUDA cores in float32 from float32 tiles in shared
// memory (bf16 inputs are widened as they are loaded, the reference's
// float32 products of bf16 values), 4 x 4 register tiles a thread, 256
// threads.  Bound at qwen3-1.7b's training shape (B 4, S 2048, H 16, K 8,
// hd 128, causal): five products of 2 B H S^2 hd / 2 = 34.4 GFLOP each,
// 172 GFLOP, 0.174 ms at the 989 TFLOP/s bf16 tensor-core rate (2.6 ms at
// the 67 TFLOP/s float32 rate these CUDA cores run at), against ~0.2 GB
// of q, k, v, o, dO, L, dq, dk, dv: bound by operations.  This design is
// the simple, correct first port; moving the products onto wgmma as the
// forward's bf16 kernel does is later work.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;          // query rows a tile
constexpr int BKV = 64;         // keys a block
constexpr int NT = 256;         // threads: 16 x 16, 4 x 4 products each
constexpr int PS = BKV + 4;     // padded row stride of P and dS
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ bool allowed(int qpos, int kpos, int causal,
                                        int window) {
  if (causal && kpos > qpos) return false;
  if (window > 0 && qpos / window != kpos / window) return false;
  return true;
}

// The forward's kv tile range for a query tile of rows q0 .. q_last
// (flash_attention.cu: kv_range): a (query tile, kv tile) pair outside it
// was skipped by the forward and contributes nothing here either.
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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// four consecutive elements (16 or 8 bytes, aligned) widened to float
__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* out) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  out[0] = __low2float(a); out[1] = __high2float(a);
  out[2] = __low2float(b); out[3] = __high2float(b);
}

// rows row0 .. row0 + 63 of one head of a (B, S, heads, HD) tensor into a
// [64][HD + 4] float tile, times mul; rows past S are zeros
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* base,
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

// delta = rowsum(dO o O) a (b, i, h) row
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

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
fa_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq_part, T* __restrict__ dk,
              T* __restrict__ dv, int H, int K, int Sq, int Skv, int causal,
              int window, float scale) {
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
  // this kv tile's slice of the dQ parts, each (B, Sq, H, HD)
  float* dq_tile = dq_part + (int64_t)kt * (gridDim.x / K) * Sq * H * HD;

  load_tile<T, HD>(Ks, k + kv_off, kvrow, k0, Skv, 1.f, tid);
  load_tile<T, HD>(Vs, v + kv_off, kvrow, k0, Skv, 1.f, tid);

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
      load_tile<T, HD>(Qs, q + q_off, qrow, q0, Sq, scale, tid);
      load_tile<T, HD>(dOs, dout + q_off, qrow, q0, Sq, 1.f, tid);
      if (tid < BQ) {
        const bool in = q0 + tid < Sq;
        Ls[tid] = in ? lse_h[q0 + tid] : 0.f;
        Ds[tid] = in ? delta_h[q0 + tid] : 0.f;
      }
      __syncthreads();

      // S = Qs K^T and dP = dO V^T: query rows ty*4 + a, keys tx + 16 c
      float s[4][4], dp[4][4];
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

      // P = exp(S - L) under the mask (the reference's -1e30 fill), 0 for
      // rows past Sq and keys past Skv; dS = P (dP - delta)
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int r = ty * 4 + a;
        const int qpos = q0 + r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = tx + 16 * c;
          const int kpos = k0 + j;
          float p = 0.f;
          if (qpos < Sq && kpos < Skv) {
            const float x =
                allowed(qpos, kpos, causal, window) ? s[a][c] : NEG_INF;
            p = expf(x - Ls[r]);
          }
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

      // this tile's part of dQs, dS K: query rows ty*4 + a, columns
      // tx + 16 c, stored in the tile's slice
      float dq[4][CPT];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < CPT; ++c) dq[a][c] = 0.f;
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
              dq[a][c] = fmaf(ds4[a][e], kv, dq[a][c]);
          }
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int row = q0 + ty * 4 + a;
        if (row >= Sq) continue;
        float* dst = dq_tile + q_off + row * qrow + tx;
#pragma unroll
        for (int c = 0; c < CPT; ++c) dst[16 * c] = dq[a][c];
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
      dk[at + 16 * c] = from_f32<T>(dk_acc[a][c]);
      dv[at + 16 * c] = from_f32<T>(dv_acc[a][c]);
    }
  }
}

// dQ = (the parts of the kv tiles the row's query tile visited, summed in
// tile order) / sqrt(hd), rounded once
template <typename T, int HD>
__global__ void __launch_bounds__(NT)
fa_dq_kernel(const float* __restrict__ dq_part, T* __restrict__ dq,
             int64_t n, int H, int Sq, int Skv, int causal, int window,
             float scale) {
  const int64_t i = (int64_t)blockIdx.x * NT + threadIdx.x;
  if (i >= n) return;
  const int q = (int)((i / ((int64_t)H * HD)) % Sq);
  const int q0 = q / BQ * BQ;
  int lo, hi;
  kv_range(q0, min(q0 + BQ, Sq) - 1, Skv, causal, window, &lo, &hi);
  float sum = 0.f;
  for (int kt = lo; kt <= hi; ++kt) sum += dq_part[(int64_t)kt * n + i];
  dq[i] = from_f32<T>(sum * scale);
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t)(2 * BKV * (HD + 4) + 2 * BQ * (HD + 4) + 2 * BQ * PS +
                  2 * BQ);
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, float* dq_part,
           void* dq, void* dk, void* dv, int B, int H, int K, int Sq,
           int Skv, int causal, int window, float scale,
           cudaStream_t stream) {
  const int64_t rows = (int64_t)B * Sq * H;
  const unsigned delta_blocks = (unsigned)((rows + NT / 32 - 1) / (NT / 32));
  fa_delta_kernel<T, HD><<<delta_blocks, NT, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, rows, H,
      Sq);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t shmem = smem_bytes<HD>();
  auto kernel = fa_bwd_kernel<T, HD>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)shmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * K), (unsigned)((Skv + BKV - 1) / BKV));
  kernel<<<grid, NT, shmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      dq_part, static_cast<T*>(dk), static_cast<T*>(dv), H, K, Sq, Skv,
      causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int64_t n = rows * HD;
  fa_dq_kernel<T, HD><<<(unsigned)((n + NT - 1) / NT), NT, 0, stream>>>(
      dq_part, static_cast<T*>(dq), n, H, Sq, Skv, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const float* lse, float* delta, float* dq_part,
             void* dq, void* dk, void* dv, int B, int H, int K, int Sq,
             int Skv, int hd, int causal, int window, float scale,
             cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, dout, lse, delta, dq_part, dq,
                                  dk, dv, B, H, K, Sq, Skv, causal, window,
                                  scale, s);
    case 32: return launch<T, 32>(q, k, v, o, dout, lse, delta, dq_part, dq,
                                  dk, dv, B, H, K, Sq, Skv, causal, window,
                                  scale, s);
    case 64: return launch<T, 64>(q, k, v, o, dout, lse, delta, dq_part, dq,
                                  dk, dv, B, H, K, Sq, Skv, causal, window,
                                  scale, s);
    case 128: return launch<T, 128>(q, k, v, o, dout, lse, delta, dq_part, dq,
                                    dk, dv, B, H, K, Sq, Skv, causal, window,
                                    scale, s);
    default: return 1001;
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launches (0 = launched); 1000 + k
// for an argument the kernels do not take.  q, o, dout and dq are (B, Sq,
// H, hd), k, v, dk and dv (B, Skv, K, hd), all __nv_bfloat16 when is_bf16
// else float; lse (the forward's L) and the scratch delta are float32
// (B, H, Sq), the scratch dq_part float32 (ceil(Skv / 64), B, Sq, H, hd),
// all allocated by the caller.
int fa_flash_attention_bwd(const void* q, const void* k, const void* v,
                           const void* o, const void* dout, const float* lse,
                           float* delta, float* dq_part, void* dq, void* dk,
                           void* dv, int B, int H, int K, int Sq, int Skv,
                           int hd, int causal, int window, float scale,
                           int is_bf16, void* stream) {
  if (hd != 16 && hd != 32 && hd != 64 && hd != 128) return 1001;
  if (K < 1 || H < K || H % K != 0) return 1002;
  if (B < 1 || Sq < 1 || Skv < 1 || (int64_t)B * K > 0x7FFFFFFF ||
      (Skv + BKV - 1) / BKV > 65535 ||
      ((int64_t)B * Sq * H * hd + NT - 1) / NT > 0x7FFFFFFF)
    return 1003;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
       reinterpret_cast<uintptr_t>(dout) | reinterpret_cast<uintptr_t>(dq) |
       reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv) |
       reinterpret_cast<uintptr_t>(dq_part)) % 16)
    return 1004;
  const cudaStream_t s = (cudaStream_t)stream;
  return is_bf16
             ? dispatch<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq_part,
                                       dq, dk, dv, B, H, K, Sq, Skv, hd,
                                       causal, window, scale, s)
             : dispatch<float>(q, k, v, o, dout, lse, delta, dq_part, dq, dk,
                               dv, B, H, K, Sq, Skv, hd, causal, window,
                               scale, s);
}

}  // extern "C"
