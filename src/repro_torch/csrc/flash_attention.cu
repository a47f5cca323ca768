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
// (b*H + h, 64-row query tile) and loops over the kv tiles itself,
// keeping the online softmax's m and l and the output tile in registers.
//
// Numerics follow the Pallas kernel: q is scaled by 1/sqrt(hd) in float32
// inside (the JAX model's jnp flash rounds the scaled q back to bf16
// first; the port's model calls this kernel on the unscaled q, so for
// bf16 the two differ by one rounding of q); all math is float32; masked
// scores are the finite -1e30, never -inf, so a row whose first tiles are
// wholly masked accumulates exp(0) garbage that the correction
// exp(-1e30 - m) wipes to exactly 0 once a real key arrives; l is clamped
// at 1e-30.  Keys past Skv in the last tile (the ragged edge, which the
// Pallas wrapper forbids by asserting Skv % bkv == 0) score -inf and so
// weigh exactly 0.  kv tiles wholly above the diagonal or outside the
// query tile's window chunks are skipped: that computes the same function
// for every row that has at least one allowed key, and a block that holds
// a row with none (a window chunk past Skv, possible only when Sq > Skv)
// visits every tile, so that row is the uniform average of v, as in the
// reference.
//
// Bound on an H100 SXM: at the qwen3-1.7b prefill (B 4, S 2048, H 16,
// K 8, hd 128, causal, bf16) the two products are 6.9e10 FLOP, 0.069 ms
// at the 989 TFLOP/s bf16 tensor-core rate, against ~0.1 GB of q, k, v
// and o (0.03 ms at 3.35 TB/s): bound by operations.  This first kernel
// runs its products on the CUDA cores in float32 (67 TFLOP/s peak), from
// float32 tiles in shared memory with 4 x 4 register tiles per thread, so
// it cannot come near that bound; wgmma on bf16 tiles fed by TMA is the
// later PR's redesign.

#include <cmath>
#include <cstdint>
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

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T> struct Vec { static constexpr int N = 16 / sizeof(T); };

__device__ __forceinline__ bool allowed(int qpos, int kpos, int causal,
                                        int window) {
  if (causal && kpos > qpos) return false;
  if (window > 0 && qpos / window != kpos / window) return false;
  return true;
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int H, int K,
             int Sq, int Skv, int causal, int window, float scale) {
  constexpr int VEC = Vec<T>::N;
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
  const T* qb = q + ((int64_t)b * Sq * H + h) * HD;
  const T* kb = k + ((int64_t)b * Skv * K + kvh) * HD;
  const T* vb = v + ((int64_t)b * Skv * K + kvh) * HD;
  T* ob = o + ((int64_t)b * Sq * H + h) * HD;

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

  // the kv tiles this query tile needs
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int n_kv = (Skv + BKV - 1) / BKV;
  int kt_lo = 0, kt_hi = n_kv - 1;
  const bool empty_row = window > 0 && (q_last / window) * window >= Skv;
  if (!empty_row) {
    if (window > 0) kt_lo = (q0 / window) * window / BKV;
    if (causal) {
      kt_hi = min(kt_hi, q_last / BKV);
    } else if (window > 0) {
      kt_hi = min(kt_hi, ((q_last / window) * window + window - 1) / BKV);
    }
  }

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
      store(ob + row * qrow + tx + 16 * c, acc[i][c] / li);
  }
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(HD * QS + HD * KS + BKV * HD + BKV * QS);
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int K, int Sq, int Skv, int causal, int window, float scale,
           cudaStream_t stream) {
  const size_t shmem = smem_bytes<HD>();
  auto kernel = flash_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * H), (unsigned)((Sq + BQ - 1) / BQ));
  kernel<<<grid, NT, shmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, K, Sq, Skv, causal,
      window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int H, int K, int Sq, int Skv, int hd, int causal, int window,
             float scale, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, B, H, K, Sq, Skv, causal,
                                  window, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, H, K, Sq, Skv, causal,
                                  window, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, H, K, Sq, Skv, causal,
                                  window, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, H, K, Sq, Skv, causal,
                                    window, scale, stream);
    default: return 1001;
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched); 1000 + k for
// an argument the kernel does not take.  is_bf16 selects __nv_bfloat16
// inputs and output over float.
int fa_flash_attention(const void* q, const void* k, const void* v, void* o,
                       int B, int H, int K, int Sq, int Skv, int hd,
                       int causal, int window, float scale, int is_bf16,
                       void* stream) {
  if (hd != 16 && hd != 32 && hd != 64 && hd != 128) return 1001;
  if (K < 1 || H < K || H % K != 0) return 1002;
  if (B < 1 || Sq < 1 || Skv < 1 || (int64_t)B * H > 0x7FFFFFFF ||
      (Sq + BQ - 1) / BQ > 65535)
    return 1003;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) % 16)
    return 1004;
  const cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, B, H, K, Sq, Skv, hd,
                                           causal, window, scale, s)
                 : dispatch<float>(q, k, v, o, B, H, K, Sq, Skv, hd, causal,
                                   window, scale, s);
}

}  // extern "C"
