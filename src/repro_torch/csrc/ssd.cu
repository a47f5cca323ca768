// Mamba2 chunked SSD scan for Hopper (sm_90a), bound through a plain C
// interface and loaded with ctypes (repro_torch/kernels/build.py).
//
//   ssd_scan  <- ssd / _kernel of src/repro/kernels/ssd/ssd.py:74
//
// For each (batch row, head) bh the selective-state recurrence
//   h_t = exp(dt_t a) h_{t-1} + dt_t x_t B_t^T   (P x N),   y_t = h_t C_t
// from a zero state, in its chunked (state-space dual) form: per chunk the
// intra-chunk product (L o C B^T)(x dt) with L_ij = exp(cum_i - cum_j) for
// i >= j, plus the carried state's term exp(cum_i) C_i state^T, then the
// state update state exp(cum_last) + (x dt)^T (B exp(cum_last - cum)).
// The final state is emitted.  The TPU kernel's grid (BH, chunks) runs the
// chunk axis in order with the state in VMEM scratch; here one block takes
// one bh and loops over the chunks itself, with the P x N state in shared
// memory.  Nothing is carried between blocks.
//
// The chunk is the kernel's own, Q = 64 rows: the model's chunk of 256
// would need a 256 x 256 float32 L o C B^T tile (256 KB), over the 227 KB
// a block may use.  The scan is the same function for any chunking, up to
// rounding.  All math is float32 on the CUDA cores (no TF32, which keeps
// about three decimal digits).  exp(cum_i - cum_j) is computed only where
// i >= j (above the diagonal cum_i - cum_j > 0 and exp may overflow, and
// inf * 0 would make a NaN).  Rows past S in the last chunk load x = dt =
// B = C = 0: dt = 0 is decay 1 and zero input, an exact no-op, as the
// reference's ssd_chunked pads; their y is not stored.
//
// Layout: x and y are (b, h, s, p) with strides (xsb, xsh, xss, 1) and dt
// (b, h, s) with (dsb, dsh, dss), bh = b * H + h; B and C are (b, s, n)
// with (bsb, bss, 1), shared by the H heads of a batch row.  The Pallas
// signature (per-head B and C, (BH, S, P) x) is H = 1; the Mamba2 model
// passes its (batch, S, heads, P) activations and its (batch, S, N) B and
// C as they are, with no broadcast copy across heads.  a is (BH,).
//
// Bound on an H100 SXM: at the mamba2-370m prefill (BH = 4 x 32, S = 2048,
// P = 64, N = 128) this chunking needs, per bh, the lower triangles of
// C B^T (S (Q + 1) / 2 N) and of (L o C B^T)(x dt) (S (Q + 1) / 2 P) and
// the state's two products (S N P each), 4.6e7 FMA, 1.2e10 FLOP in all:
// 0.18 ms at the 67 TFLOP/s float32 rate; the bytes (x, y ~134 MB, B, C
// and dt ~10 MB) take 0.04 ms.  Bound by operations.  Only 128 blocks (one
// per bh) run, one per SM, each with 8 warps: the chunks' sequential
// dependency is the kernel's limit at this shape.  A later PR can split
// the chunk states from the scan over them to fill the card.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int Q = 64;           // rows per chunk
constexpr int NT = 256;         // threads: 16 x 16, 4 rows each
constexpr int MAX_N = 128;      // largest d_state

template <int P>
__global__ void __launch_bounds__(NT)
ssd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const float* __restrict__ Bm,
           const float* __restrict__ Cm, float* __restrict__ y,
           float* __restrict__ state_out, int H, int S, int N, int64_t xsb,
           int64_t xsh, int64_t xss, int64_t dsb, int64_t dsh, int64_t dss,
           int64_t bsb, int64_t bss) {
  constexpr int CP = P / 16;            // y columns per thread
  constexpr int NC = MAX_N / 16;        // state columns per thread, at most
  const int NP = N + 1;                 // padded row stride of B, C, state
  extern __shared__ __align__(16) float smem[];
  float* xdt = smem;                    // [Q][P]  x * dt
  float* Bs = xdt + Q * P;              // [Q][NP]
  float* Cs = Bs + Q * NP;              // [Q][NP]
  float* Ms = Cs + Q * NP;              // [Q][Q + 1]  L o C B^T
  float* St = Ms + Q * (Q + 1);         // [P][NP]  carried state
  float* cum = St + P * NP;             // [Q]  cumulative dt * a
  float* din = cum + Q;                 // [Q]  exp(cum)
  float* dout = din + Q;                // [Q]  exp(cum_last - cum)

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float a = A[bh];
  const float* xb = x + b * xsb + h * xsh;
  const float* dtb = dt + b * dsb + h * dsh;
  const float* Bb = Bm + b * bsb;
  const float* Cb = Cm + b * bsb;
  float* yb = y + b * xsb + h * xsh;

  for (int e = tid; e < P * NP; e += NT) St[e] = 0.f;

  for (int c0 = 0; c0 < S; c0 += Q) {
    __syncthreads();                    // the last chunk's reads are done
    for (int e = tid; e < Q * P; e += NT) {
      const int t = c0 + e / P, p = e % P;
      xdt[e] = t < S ? xb[t * xss + p] * dtb[t * dss] : 0.f;
    }
    for (int e = tid; e < Q * N; e += NT) {
      const int t = e / N, n = e % N;
      const bool ok = c0 + t < S;
      Bs[t * NP + n] = ok ? Bb[(c0 + t) * bss + n] : 0.f;
      Cs[t * NP + n] = ok ? Cb[(c0 + t) * bss + n] : 0.f;
    }
    if (tid < Q) cum[tid] = (c0 + tid < S ? dtb[(c0 + tid) * dss] : 0.f) * a;
    __syncthreads();
    if (tid < 32) {                     // inclusive scan of the 64 dt * a
      const float v0 = cum[2 * tid], v1 = cum[2 * tid + 1];
      float incl = v0 + v1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += up;
      }
      const float excl = incl - (v0 + v1);
      cum[2 * tid] = excl + v0;
      cum[2 * tid + 1] = incl;
    }
    __syncthreads();
    if (tid < Q) {
      din[tid] = expf(cum[tid]);
      dout[tid] = expf(cum[Q - 1] - cum[tid]);
    }

    // Ms = L o C B^T: rows i = ty*4 + r, columns j = tx + 16 c
    {
      float g[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) g[r][c] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = Cs[(ty * 4 + r) * NP + n];
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = Bs[(tx + 16 * c) * NP + n];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) g[r][c] = fmaf(cv[r], bv[c], g[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty * 4 + r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = tx + 16 * c;
          Ms[i * (Q + 1) + j] =
              i >= j ? expf(cum[i] - cum[j]) * g[r][c] : 0.f;
        }
      }
    }
    __syncthreads();

    // y = Ms (x dt) + exp(cum) C state^T: rows ty*4 + r, columns tx + 16 c
    {
      float yv[4][CP], off[4][CP];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < CP; ++c) yv[r][c] = off[r][c] = 0.f;
      const int j_end = ty * 4 + 4;     // Ms is 0 above the diagonal
      for (int j = 0; j < j_end; ++j) {
        float mv[4], xv[CP];
#pragma unroll
        for (int r = 0; r < 4; ++r) mv[r] = Ms[(ty * 4 + r) * (Q + 1) + j];
#pragma unroll
        for (int c = 0; c < CP; ++c) xv[c] = xdt[j * P + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < CP; ++c) yv[r][c] = fmaf(mv[r], xv[c], yv[r][c]);
      }
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[CP];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = Cs[(ty * 4 + r) * NP + n];
#pragma unroll
        for (int c = 0; c < CP; ++c) sv[c] = St[(tx + 16 * c) * NP + n];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < CP; ++c)
            off[r][c] = fmaf(cv[r], sv[c], off[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int t = c0 + ty * 4 + r;
        if (t >= S) continue;
        const float di = din[ty * 4 + r];
#pragma unroll
        for (int c = 0; c < CP; ++c)
          yb[t * xss + tx + 16 * c] = yv[r][c] + di * off[r][c];
      }
    }
    __syncthreads();                    // every read of the old state is done

    // state = state exp(cum_last) + (x dt)^T (B exp(cum_last - cum)):
    // rows p = ty*CP + r, columns n = tx + 16 c (c < ceil(N / 16))
    {
      float acc[CP][NC];
#pragma unroll
      for (int r = 0; r < CP; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
      for (int t = 0; t < Q; ++t) {
        const float w = dout[t];
        float xv[CP], bv[NC];
#pragma unroll
        for (int r = 0; r < CP; ++r) xv[r] = xdt[t * P + ty * CP + r];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int n = tx + 16 * c;
          bv[c] = n < N ? Bs[t * NP + n] * w : 0.f;
        }
#pragma unroll
        for (int r = 0; r < CP; ++r)
#pragma unroll
          for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(xv[r], bv[c], acc[r][c]);
      }
      const float decay = din[Q - 1];
#pragma unroll
      for (int r = 0; r < CP; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int p = ty * CP + r, n = tx + 16 * c;
          if (n < N) St[p * NP + n] = St[p * NP + n] * decay + acc[r][c];
        }
    }
  }
  __syncthreads();
  float* so = state_out + (int64_t)bh * P * N;
  for (int e = tid; e < P * N; e += NT) so[e] = St[(e / N) * NP + e % N];
}

template <int P>
size_t smem_bytes(int N) {
  const int NP = N + 1;
  return sizeof(float) *
         (size_t)(Q * P + 2 * Q * NP + Q * (Q + 1) + P * NP + 3 * Q);
}

template <int P>
int launch(const float* x, const float* dt, const float* a, const float* Bm,
           const float* Cm, float* y, float* st, int BH, int H, int S, int N,
           int64_t xsb, int64_t xsh, int64_t xss, int64_t dsb, int64_t dsh,
           int64_t dss, int64_t bsb, int64_t bss, cudaStream_t stream) {
  const size_t shmem = smem_bytes<P>(N);
  auto kernel = ssd_kernel<P>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<BH, NT, shmem, stream>>>(x, dt, a, Bm, Cm, y, st, H, S, N, xsb,
                                    xsh, xss, dsb, dsh, dss, bsb, bss);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched); 1000 + k for
// an argument the kernel does not take.
int ssd_scan(const float* x, const float* dt, const float* a, const float* Bm,
             const float* Cm, float* y, float* state, int BH, int H, int S,
             int P, int N, int64_t xsb, int64_t xsh, int64_t xss, int64_t dsb,
             int64_t dsh, int64_t dss, int64_t bsb, int64_t bss,
             void* stream) {
  if (P != 16 && P != 32 && P != 64) return 1001;
  if (N < 1 || N > MAX_N) return 1002;
  if (BH < 1 || S < 1) return 1003;
  if (H < 1 || BH % H != 0) return 1004;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (P) {
    case 16: return launch<16>(x, dt, a, Bm, Cm, y, state, BH, H, S, N, xsb,
                               xsh, xss, dsb, dsh, dss, bsb, bss, s);
    case 32: return launch<32>(x, dt, a, Bm, Cm, y, state, BH, H, S, N, xsb,
                               xsh, xss, dsb, dsh, dss, bsb, bss, s);
    default: return launch<64>(x, dt, a, Bm, Cm, y, state, BH, H, S, N, xsb,
                               xsh, xss, dsb, dsh, dss, bsb, bss, s);
  }
}

}  // extern "C"
