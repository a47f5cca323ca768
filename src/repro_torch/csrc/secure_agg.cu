// Secure-aggregation kernels for Hopper (sm_90a), bound through a plain C
// interface and loaded with ctypes (repro_torch/kernels/secure_agg/build.py).
//
// They replace the Pallas TPU kernels of repro/kernels/secure_agg/secure_agg.py:
//
//   sa_mask_encrypt    <- mask_encrypt_batch / _mask_batch_kernel (and
//                         mask_encrypt / _mask_kernel as B = 1)
//   sa_unmask_decrypt  <- unmask_decrypt_batch / _unmask_batch_kernel (and
//                         unmask_decrypt / _unmask_kernel as B = 1)
//   sa_vote_combine    <- vote_combine / _vote_kernel
//
// Each works from the function, not from the Pallas (8, 128) tiling: a flat
// 1-D grid over the B*T elements with 64-bit indices, EPT elements per
// thread at a stride of blockDim.x (coalesced), per-row metadata read from
// small device uint32 arrays.  Ring values are uint32 and wrap natively.
//
// Bounds on an H100 SXM (3.35 TB/s; 32-bit integer add, logical, shift and
// multiply at 64 results per clock per SM: 132 x 64 x 1.98 GHz = 16.7 T/s,
// half the 33.5 T/s lane issue rate):
//   mask    reads 4 B and writes 4 B per element, 12 integer and 4 float
//           ops: bound by bytes.  Pad subkeys are derived once per thread
//           and row.
//   unmask  reads 4 B, writes 4 B, but evaluates n pads per element (12
//           integer ops each: 768 at n = 64): bound by operations.  The
//           subkeys (k1, k2) of node i are derived once per thread, row and
//           node.
//   vote    reads (r + 1) x 4 B, writes 4 B, a min/max network of r phases:
//           bound by bytes.
//
// Exactness against the plain version: rounding is rintf-equivalent
// (__float2int_rn, half to even), the scale product is __fmul_rn (no FMA
// contraction), dequantize is __int2float_rn then __fdiv_rn; the build uses
// no --use_fast_math.  The vote's median is taken in unsigned order.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t GOLDEN = 0x9E3779B9u;
constexpr uint32_t MIX1 = 0x85EBCA6Bu;
constexpr uint32_t MIX2 = 0xC2B2AE35u;
constexpr uint32_t PAIRWISE_KEY_BASE = 1u << 20;
constexpr int THREADS = 256;
constexpr int EPT = 4;            // elements per thread
constexpr int MAX_COPIES = 31;    // largest vote redundancy r

__device__ __forceinline__ uint32_t splitmix32(uint32_t x) {
  x += GOLDEN;
  x = (x ^ (x >> 16)) * MIX1;
  x = (x ^ (x >> 13)) * MIX2;
  return x ^ (x >> 16);
}

struct Keys {
  uint32_t k1, k2;
};

// pad_stream's subkeys: k1 = splitmix32(seed ^ (key_id * MIX1)) -- '*' binds
// tighter than '^' -- and k2 = splitmix32(k1 ^ MIX2).
__device__ __forceinline__ Keys pad_keys(uint32_t seed, uint32_t key_id) {
  Keys k;
  k.k1 = splitmix32(seed ^ (key_id * MIX1));
  k.k2 = splitmix32(k.k1 ^ MIX2);
  return k;
}

__device__ __forceinline__ uint32_t pad_at(Keys k, uint32_t ctr) {
  return splitmix32(ctr ^ k.k1) + k.k2;
}

// key of the unordered pair {member, other} of one cluster
__device__ __forceinline__ uint32_t pair_key(uint32_t node, uint32_t other,
                                             uint32_t c) {
  uint32_t cluster = node / c, member = node % c;
  uint32_t lo = member < other ? member : other;
  uint32_t hi = member < other ? other : member;
  return cluster * c * c + lo * c + hi + PAIRWISE_KEY_BASE;
}

// mode: 0 quantize, 1 mask (global pad), 2 pairwise
template <int MODE>
__global__ void __launch_bounds__(THREADS)
mask_kernel(const float* __restrict__ x, const uint32_t* __restrict__ seeds,
            const uint32_t* __restrict__ node_ids,
            const uint32_t* __restrict__ offsets, uint32_t* __restrict__ out,
            int64_t B, int64_t T, float scale, float clip, uint32_t c) {
  const int64_t N = B * T;
  const int64_t base = (int64_t)blockIdx.x * THREADS * EPT + threadIdx.x;
  uint32_t q[EPT], ctr[EPT];
  int64_t row[EPT];
#pragma unroll
  for (int k = 0; k < EPT; ++k) {
    const int64_t e = base + (int64_t)k * THREADS;
    row[k] = -1;
    q[k] = 0;
    if (e < N) {
      row[k] = e / T;
      // NaN quantizes to 0, as XLA's conversion does in the reference:
      // an explicit select, since fmaxf would return -clip for a NaN
      const float xe = x[e];
      const float v = isnan(xe) ? 0.0f : fminf(fmaxf(xe, -clip), clip);
      q[k] = (uint32_t)__float2int_rn(__fmul_rn(v, scale));
      ctr[k] = offsets[row[k]] + (uint32_t)(e - row[k] * T);
    }
  }
  if (MODE == 1) {
    int64_t cached = -1;
    Keys key = {0u, 0u};
#pragma unroll
    for (int k = 0; k < EPT; ++k) {
      if (row[k] < 0) continue;
      if (row[k] != cached) {
        cached = row[k];
        key = pad_keys(seeds[cached], node_ids[cached]);
      }
      q[k] += pad_at(key, ctr[k]);
    }
  } else if (MODE == 2) {
    for (uint32_t other = 0; other < c; ++other) {
      int64_t cached = -1;
      Keys key = {0u, 0u};
      uint32_t member = 0;
#pragma unroll
      for (int k = 0; k < EPT; ++k) {
        if (row[k] < 0) continue;
        if (row[k] != cached) {
          cached = row[k];
          const uint32_t node = node_ids[cached];
          member = node % c;
          key = pad_keys(seeds[cached], pair_key(node, other, c));
        }
        if (member == other) continue;
        const uint32_t p = pad_at(key, ctr[k]);
        q[k] += member < other ? p : 0u - p;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < EPT; ++k)
    if (row[k] >= 0) out[base + (int64_t)k * THREADS] = q[k];
}

// mode: 0 dequantize only, 1 subtract the n-way total pad first
template <int MODE>
__global__ void __launch_bounds__(THREADS)
unmask_kernel(const uint32_t* __restrict__ agg,
              const uint32_t* __restrict__ seeds,
              const uint32_t* __restrict__ offsets, float* __restrict__ out,
              int64_t B, int64_t T, uint32_t n_nodes, float scale) {
  const int64_t N = B * T;
  const int64_t base = (int64_t)blockIdx.x * THREADS * EPT + threadIdx.x;
  uint32_t a[EPT], ctr[EPT];
  int64_t row[EPT];
#pragma unroll
  for (int k = 0; k < EPT; ++k) {
    const int64_t e = base + (int64_t)k * THREADS;
    row[k] = -1;
    a[k] = 0;
    if (e < N) {
      row[k] = e / T;
      a[k] = agg[e];
      ctr[k] = offsets[row[k]] + (uint32_t)(e - row[k] * T);
    }
  }
  if (MODE == 1) {
    for (uint32_t i = 0; i < n_nodes; ++i) {
      int64_t cached = -1;
      Keys key = {0u, 0u};
#pragma unroll
      for (int k = 0; k < EPT; ++k) {
        if (row[k] < 0) continue;
        if (row[k] != cached) {
          cached = row[k];
          key = pad_keys(seeds[cached], i);
        }
        a[k] -= pad_at(key, ctr[k]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < EPT; ++k)
    if (row[k] >= 0)
      out[base + (int64_t)k * THREADS] =
          __fdiv_rn(__int2float_rn((int32_t)a[k]), scale);
}

struct Copies {
  const uint32_t* p[MAX_COPIES];
};

template <int R>
__global__ void __launch_bounds__(THREADS)
vote_kernel(Copies copies, const uint32_t* __restrict__ acc,
            uint32_t* __restrict__ out, int64_t N) {
  const int64_t base = (int64_t)blockIdx.x * THREADS * EPT + threadIdx.x;
#pragma unroll
  for (int k = 0; k < EPT; ++k) {
    const int64_t e = base + (int64_t)k * THREADS;
    if (e >= N) return;
    uint32_t v[R];
#pragma unroll
    for (int s = 0; s < R; ++s) v[s] = copies.p[s][e];
    // odd-even transposition network, as median_network: unsigned min/max
#pragma unroll
    for (int phase = 0; phase < R; ++phase) {
#pragma unroll
      for (int i = phase % 2; i < R - 1; i += 2) {
        const uint32_t lo = min(v[i], v[i + 1]);
        const uint32_t hi = max(v[i], v[i + 1]);
        v[i] = lo;
        v[i + 1] = hi;
      }
    }
    out[e] = acc[e] + v[R / 2];
  }
}

inline unsigned blocks_for(int64_t n) {
  return (unsigned)((n + (int64_t)THREADS * EPT - 1) / ((int64_t)THREADS * EPT));
}

template <int R>
void launch_vote(const Copies& cp, const uint32_t* acc, uint32_t* out,
                 int64_t n, cudaStream_t st) {
  vote_kernel<R><<<blocks_for(n), THREADS, 0, st>>>(cp, acc, out, n);
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched); 1000 + k for
// an argument the kernel does not take.
int sa_mask_encrypt(const float* x, const uint32_t* seeds,
                    const uint32_t* node_ids, const uint32_t* offsets,
                    uint32_t* out, int64_t B, int64_t T, float scale,
                    float clip, int mode, int cluster_size, void* stream) {
  const int64_t n = B * T;
  if (n <= 0) return 0;
  if (mode == 2 && cluster_size < 1) return 1001;
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned g = blocks_for(n);
  const uint32_t c = (uint32_t)cluster_size;
  switch (mode) {
    case 0:
      mask_kernel<0><<<g, THREADS, 0, st>>>(x, seeds, node_ids, offsets, out,
                                            B, T, scale, clip, c);
      break;
    case 1:
      mask_kernel<1><<<g, THREADS, 0, st>>>(x, seeds, node_ids, offsets, out,
                                            B, T, scale, clip, c);
      break;
    case 2:
      mask_kernel<2><<<g, THREADS, 0, st>>>(x, seeds, node_ids, offsets, out,
                                            B, T, scale, clip, c);
      break;
    default:
      return 1002;
  }
  return (int)cudaGetLastError();
}

int sa_unmask_decrypt(const uint32_t* agg, const uint32_t* seeds,
                      const uint32_t* offsets, float* out, int64_t B,
                      int64_t T, int n_nodes, float scale, int mode,
                      void* stream) {
  const int64_t n = B * T;
  if (n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned g = blocks_for(n);
  switch (mode) {
    case 0:
      unmask_kernel<0><<<g, THREADS, 0, st>>>(agg, seeds, offsets, out, B, T,
                                              (uint32_t)n_nodes, scale);
      break;
    case 1:
      unmask_kernel<1><<<g, THREADS, 0, st>>>(agg, seeds, offsets, out, B, T,
                                              (uint32_t)n_nodes, scale);
      break;
    default:
      return 1002;
  }
  return (int)cudaGetLastError();
}

int sa_vote_combine(const uint32_t* const* copies, int r, const uint32_t* acc,
                    uint32_t* out, int64_t n, void* stream) {
  if (r < 1 || r > MAX_COPIES || r % 2 == 0) return 1003;
  if (n <= 0) return 0;
  Copies cp;
  for (int s = 0; s < MAX_COPIES; ++s) cp.p[s] = s < r ? copies[s] : nullptr;
  cudaStream_t st = (cudaStream_t)stream;
  switch (r) {
#define SA_VOTE_CASE(R) \
  case R:               \
    launch_vote<R>(cp, acc, out, n, st); \
    break;
    SA_VOTE_CASE(1) SA_VOTE_CASE(3) SA_VOTE_CASE(5) SA_VOTE_CASE(7)
    SA_VOTE_CASE(9) SA_VOTE_CASE(11) SA_VOTE_CASE(13) SA_VOTE_CASE(15)
    SA_VOTE_CASE(17) SA_VOTE_CASE(19) SA_VOTE_CASE(21) SA_VOTE_CASE(23)
    SA_VOTE_CASE(25) SA_VOTE_CASE(27) SA_VOTE_CASE(29) SA_VOTE_CASE(31)
#undef SA_VOTE_CASE
    default:
      return 1003;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
