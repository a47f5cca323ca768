// Pieces of the Mamba2 chunked SSD scan shared by its forward (ssd.cu)
// and its backward (ssd_bwd.cu), for Hopper (sm_90a): the constants, the
// cp.async staging ring, the 3xTF32 mma.sync step, and the forward's
// first three passes (C B^T, the chunk states with cum, the state pass),
// which the backward runs again.  The file note of ssd.cu describes them.
// Everything here is in an unnamed namespace: each source that includes
// it has its own copy.

#pragma once

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int Q = 256;          // rows per chunk
constexpr int TR = 64;          // rows of an output tile
constexpr int TQ = Q / TR;      // output row tiles per chunk
constexpr int KT = 32;          // depth of a staged k tile
constexpr int NW = 4;           // warps per block
constexpr int NT = 32 * NW;
constexpr int MAX_N = 128;      // largest d_state
constexpr int RS = KT + 4;      // row stride of a tile stored [row][k]
constexpr int KS = TR + 8;      // row stride of a tile stored [k][col]: P + 8 at most
constexpr int TS = 128;         // rows of a chunk-state tile: 32 a warp
constexpr int KS2 = TS + 8;     // row stride of a 128-wide tile stored [k][row]
// floats of one staged A tile (64 rows x RS, KT rows x KS2) and B tile
// (64 rows x RS, KT rows x KS)
constexpr int ABUF = TR * RS > KT * KS2 ? TR * RS : KT * KS2;
constexpr int BUF = TR * RS > KT * KS ? TR * RS : KT * KS;
constexpr int RING = 2 * (ABUF + BUF);  // two stages of the A and B tiles
static_assert(2 * NT == Q, "the chunk's cumsum takes two rows a thread");

// ---------------------------------------------------------------------------
// cp.async staging
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp16(float* dst, const float* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp4(float* dst, const float* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Stage a ROWS x COLS tile (COLS % 4 == 0) of a row-major float array
// (row stride ld) into shared memory (row stride dld).  Rows at and past
// vrows and columns at and past vcols are zero-filled (cp.async's source
// size; no byte is read for them).  vec: every row starts on a 16-byte
// boundary, so 16-byte copies, a partial one at a ragged column edge;
// else 4-byte copies.  The caller keeps vrows, vcols >= 1, so src (the
// tile's first element) is a valid address for the zero-sized copies.
template <int ROWS, int COLS>
__device__ __forceinline__ void stage(float* dst, int dld, const float* src,
                                      int64_t ld, int vrows, int vcols,
                                      bool vec) {
  if (vec) {
    constexpr int CPR = COLS / 4;
    constexpr int ITEMS = ROWS * CPR;
#pragma unroll
    for (int it = 0; it < (ITEMS + NT - 1) / NT; ++it) {
      const int e = it * NT + (int)threadIdx.x;
      if (ITEMS % NT == 0 || e < ITEMS) {
        const int r = e / CPR, c = (e % CPR) * 4;
        const int n = r < vrows ? min(max(vcols - c, 0), 4) : 0;
        cp16(dst + r * dld + c, n ? src + r * ld + c : src, 4 * n);
      }
    }
  } else {
    constexpr int ITEMS = ROWS * COLS;
#pragma unroll 4
    for (int it = 0; it < (ITEMS + NT - 1) / NT; ++it) {
      const int e = it * NT + (int)threadIdx.x;
      if (ITEMS % NT == 0 || e < ITEMS) {
        const int r = e / COLS, c = e % COLS;
        const bool ok = r < vrows && c < vcols;
        cp4(dst + r * dld + c, ok ? src + r * ld + c : src, ok ? 4 : 0);
      }
    }
  }
}

// A ring of two stages: load(kt, stage) issues the copies of k tile kt,
// mul(kt, stage) multiplies it.  Tile kt + 1 is in flight while tile kt
// is multiplied.  The first barrier also orders any shared tables the
// block wrote before the call.
template <typename Load, typename Mul>
__device__ __forceinline__ void pipeline(int ktiles, Load load, Mul mul) {
  load(0, 0);
  cp_commit();
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_wait_all();
    __syncthreads();        // tile kt is in; every warp is done with kt - 1
    if (kt + 1 < ktiles) load(kt + 1, (kt + 1) & 1);
    cp_commit();
    mul(kt, kt & 1);
  }
}

// stage st's A and B tiles in the ring
__device__ __forceinline__ float* tile_a(float* ring, int st) {
  return ring + st * ABUF;
}
__device__ __forceinline__ float* tile_b(float* ring, int st) {
  return ring + 2 * ABUF + st * BUF;
}

// ---------------------------------------------------------------------------
// 3xTF32 products on mma.sync.m16n8k8
// ---------------------------------------------------------------------------

// v = big + small, each a tf32 (10 mantissa bits), in CUTLASS's fast
// accurate split: big is v rounded toward zero (a mask, which carries
// nowhere, so a NaN or an infinity stays one and reaches the output);
// small is the rest rounded to nearest, ties away from zero -- the
// rounding of cvt.rna.tf32.f32, here as half a tf32 unit added to the
// pattern and the low 13 bits cleared (cvt.rna.tf32.f32 itself compiles
// to a longer sequence on sm_90).
__device__ __forceinline__ void split(float v, uint32_t& big,
                                      uint32_t& small) {
  big = __float_as_uint(v) & 0xFFFFE000u;
  small = (__float_as_uint(v - __uint_as_float(big)) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One 8-deep step of a warp's MT strips of 16 rows: acc[m] (16 x 8 NT8)
// += A_m (16 x 8) B (8 x 8 NT8).  av[m] holds this lane's A values of
// strip m at (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4), g = lane / 4,
// t = lane % 4; B(k, col) is sB[k BK + col BC] for the step's k = k0 +
// 0..7, loaded and split once for all the strips.  n-tiles at and past
// nt_end are skipped.  acc[m][nt] holds (g, 8 nt + 2t + {0, 1}) and
// (g + 8, 8 nt + 2t + {0, 1}).  The three products of an n-tile share a
// step accumulator, so they are issued a round at a time over the
// n-tiles and no product waits on the one before.  The step accumulator
// starts from zero and is added to acc by float32 adds (round to
// nearest): an mma aligns its addends to the largest by truncation, so
// products accumulated straight into the running sum would lose their
// low bits toward zero at every step, a bias that grows with the depth
// (at 32 steps a relative error of a few 1e-6, which the SSD backward's
// dcum = dy . y - dt x . r, a difference of such sums, amplifies).
template <int MT, int NT8, int BK, int BC>
__device__ __forceinline__ void mma_step(float (&acc)[MT][NT8][4],
                                         const float (&av)[MT][4],
                                         const float* sB, int k0, int lane,
                                         int nt_end) {
  uint32_t ab[MT][4], as[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int q = 0; q < 4; ++q) split(av[m][q], ab[m][q], as[m][q]);
  const int g = lane >> 2, t = lane & 3;
  uint32_t bb[NT8][2], bs[NT8][2];
#pragma unroll
  for (int nt = 0; nt < NT8; ++nt) {
    const int col = nt * 8 + g;
    split(sB[(k0 + t) * BK + col * BC], bb[nt][0], bs[nt][0]);
    split(sB[(k0 + t + 4) * BK + col * BC], bb[nt][1], bs[nt][1]);
  }
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    float part[NT8][4] = {};
#pragma unroll
    for (int nt = 0; nt < NT8; ++nt)
      if (nt < nt_end) mma(part[nt], as[m], bb[nt][0], bb[nt][1]);
#pragma unroll
    for (int nt = 0; nt < NT8; ++nt)
      if (nt < nt_end) mma(part[nt], ab[m], bs[nt][0], bs[nt][1]);
#pragma unroll
    for (int nt = 0; nt < NT8; ++nt)
      if (nt < nt_end) mma(part[nt], ab[m], bb[nt][0], bb[nt][1]);
#pragma unroll
    for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[m][nt][q] += part[nt][q];
  }
}

__device__ __forceinline__ int valid_rows(int S, int c) {
  return min(Q, S - c * Q);
}

// ---------------------------------------------------------------------------
// 2. G = C B^T, once per (batch row, chunk), lower tiles only
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NT)
ssd_cb_kernel(const float* __restrict__ Bm, const float* __restrict__ Cm,
              float* __restrict__ cb, int S, int N, int nc, int64_t bsb,
              int64_t bss, bool vec_bc) {
  extern __shared__ __align__(16) float ring[];
  int idx = blockIdx.x, ti = 0;         // the lower tiles, row by row
  while (idx > ti) idx -= ++ti;
  const int tj = idx, c = blockIdx.y, b = blockIdx.z;
  const int vq = valid_rows(S, c);
  if (ti * TR >= vq) return;            // rows wholly past S: never read
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, r0 = warp * 16;
  const bool diag = ti == tj;
  // on the diagonal tile a warp's columns past its last row stay zero
  const int nt_end = diag ? 2 * warp + 2 : 8;
  const int64_t t0 = (int64_t)c * Q;
  const float* Cb = Cm + b * bsb + (t0 + ti * TR) * bss;
  const float* Bb = Bm + b * bsb + (t0 + tj * TR) * bss;
  float acc[1][8][4] = {};
  // A = C [i][n], B(k = n, column j) = B [j][n]
  pipeline(
      (N + KT - 1) / KT,
      [&](int kt, int st) {
        const int n0 = kt * KT;
        stage<TR, KT>(tile_a(ring, st), RS, Cb + n0, bss, vq - ti * TR,
                      N - n0, vec_bc);
        stage<TR, KT>(tile_b(ring, st), RS, Bb + n0, bss, vq - tj * TR,
                      N - n0, vec_bc);
      },
      [&](int, int st) {
        const float* a = tile_a(ring, st);
#pragma unroll
        for (int k0 = 0; k0 < KT; k0 += 8) {
          float av[1][4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            av[0][q] = a[(r0 + g + 8 * (q & 1)) * RS + k0 + t + 4 * (q >> 1)];
          mma_step<1, 8, 1, RS>(acc, av, tile_b(ring, st), k0, lane, nt_end);
        }
      });
  float* G = cb + (((int64_t)b * nc + c) * Q + ti * TR) * Q + tj * TR;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = r0 + g + 8 * hf, col = nt * 8 + 2 * t;
      const float v0 = !diag || col <= row ? acc[0][nt][2 * hf] : 0.f;
      const float v1 = !diag || col + 1 <= row ? acc[0][nt][2 * hf + 1] : 0.f;
      *reinterpret_cast<float2*>(G + row * Q + col) = make_float2(v0, v1);
    }
}

// ---------------------------------------------------------------------------
// 3. the chunk's cumulative decay, and its own state s_c^T = (B o w)^T x,
//    in parallel over every chunk.  With GRAD (the backward) the same
//    product of dy and C: u_c^T = (C o e)^T dy, e_t = exp(cum_t), the
//    chunk's own part of the gradient of the state entering it; cum is
//    taken again, in the same order, and not written.
// ---------------------------------------------------------------------------

template <int P, bool GRAD>
__global__ void __launch_bounds__(NT)
ssd_state_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const float* __restrict__ Bm,
                 float* __restrict__ cum, float* __restrict__ states, int H,
                 int S, int N, int nc, int64_t xsb, int64_t xsh, int64_t xss,
                 int64_t dsb, int64_t dsh, int64_t dss, int64_t bsb,
                 int64_t bss, bool vec_x, bool vec_bc) {
  constexpr int NT8 = P / 8, XS = P + 8;
  extern __shared__ __align__(16) float ring[];
  float* sc = ring + RING;              // exp(cum_last - cum_t) dt_t
  float* part = sc + Q;                 // the warps' sums of dt a
  const int n0 = blockIdx.x * TS, c = blockIdx.y, bh = blockIdx.z;
  const int b = bh / H, h = bh % H;
  const int vq = valid_rows(S, c);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, r0 = warp * 32;
  const int64_t t0 = (int64_t)c * Q;
  const float* dtb = dt + b * dsb + h * dsh + t0 * dss;
  // cum: the inclusive cumsum of dt a over the chunk, two rows a thread
  // (rows past vq add dt = 0), then the warps' sums carried across
  {
    const float a = A[bh];
    const int k = 2 * threadIdx.x;
    const float d0 = k < vq ? dtb[k * dss] : 0.f;
    const float d1 = k + 1 < vq ? dtb[(k + 1) * dss] : 0.f;
    const float v0 = d0 * a, v1 = v0 + d1 * a;
    float incl = v1;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += up;
    }
    if (lane == 31) part[warp] = incl;
    __syncthreads();
    float base = incl - v1;
    for (int w = 0; w < warp; ++w) base += part[w];
    sc[k] = base + v0;                   // cum, for now
    sc[k + 1] = base + v1;
    __syncthreads();
    float* cumc = cum + ((int64_t)bh * nc + c) * Q;
    if (!GRAD && blockIdx.x == 0) {
      cumc[k] = sc[k];
      cumc[k + 1] = sc[k + 1];
    }
    const float last = sc[Q - 1];
    const float w0 = GRAD ? expf(sc[k]) : expf(last - sc[k]) * d0;
    const float w1 = GRAD ? expf(sc[k + 1]) : expf(last - sc[k + 1]) * d1;
    __syncthreads();                     // every read of cum is done
    sc[k] = w0;
    sc[k + 1] = w1;
  }
  const float* Bb = Bm + b * bsb + t0 * bss + n0;
  const float* xb = x + b * xsb + h * xsh + t0 * xss;
  float acc[2][NT8][4] = {};
  // A(row n, k = t) = B [t][n] w_t, B(k = t, column p) = x [t][p]; 32
  // rows a warp, so each x value is split once for two strips
  pipeline(
      (vq + KT - 1) / KT,
      [&](int kt, int st) {
        const int k = kt * KT;
        stage<KT, TS>(tile_a(ring, st), KS2, Bb + k * bss, bss, vq - k,
                      N - n0, vec_bc);
        stage<KT, P>(tile_b(ring, st), XS, xb + k * xss, xss, vq - k, P,
                     vec_x);
      },
      [&](int kt, int st) {
        const float* a = tile_a(ring, st);
#pragma unroll
        for (int k0 = 0; k0 < KT; k0 += 8) {
          float av[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int kk = k0 + t + 4 * (q >> 1);
              av[mt][q] = a[kk * KS2 + r0 + 16 * mt + g + 8 * (q & 1)] *
                          sc[kt * KT + kk];
            }
          mma_step<2, NT8, XS, 1>(acc, av, tile_b(ring, st), k0, lane, NT8);
        }
      });
  // row n = n0 + r0 + 16 mt + g (+ 8), column p: stored at s_c[p][n]
  float* so = states + ((int64_t)bh * nc + c) * P * N;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int n = n0 + r0 + 16 * mt + g + 8 * hf, p = nt * 8 + 2 * t;
        if (n < N) {
          so[p * N + n] = acc[mt][nt][2 * hf];
          so[(p + 1) * N + n] = acc[mt][nt][2 * hf + 1];
        }
      }
}

// ---------------------------------------------------------------------------
// 4. state passing, elementwise: h_c = exp(cum_last,c) h_{c-1} + s_c in
//    chunk order from h_{-1} = init (zero when null), each s_c
//    overwritten by the state entering chunk c, the last h written to
//    out (when not null).  reverse: the same recurrence in reverse chunk
//    order, the backward's gh_{c-1} = exp(cum_last,c) gh_c + u_c from
//    gh_last = init, each u_c overwritten by gh_c and gh_{-1} written.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(256)
ssd_pass_kernel(const float* __restrict__ cum, float* __restrict__ states,
                const float* __restrict__ init, float* __restrict__ out,
                int64_t lanes, int PN4, int nc, bool reverse) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= lanes) return;
  const int64_t bh = e / PN4;
  const int rem = (int)(e % PN4);
  constexpr int GROUP = 8;              // chunks whose loads fly together
  float4* s4 = reinterpret_cast<float4*>(states) + bh * nc * PN4 + rem;
  const float* last = cum + bh * nc * Q + Q - 1;
  float4 hc = init ? reinterpret_cast<const float4*>(init)[e]
                   : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nc; c0 += GROUP) {
    float4 s[GROUP];
    float d[GROUP];
#pragma unroll
    for (int k = 0; k < GROUP; ++k)
      if (c0 + k < nc) {
        const int64_t c = reverse ? nc - 1 - (c0 + k) : c0 + k;
        s[k] = s4[c * PN4];
        d[k] = last[c * Q];
      }
#pragma unroll
    for (int k = 0; k < GROUP; ++k)
      if (c0 + k < nc) {
        const int64_t c = reverse ? nc - 1 - (c0 + k) : c0 + k;
        s4[c * PN4] = hc;                   // the state at the chunk's edge
        const float dk = expf(d[k]);
        hc = make_float4(fmaf(dk, hc.x, s[k].x), fmaf(dk, hc.y, s[k].y),
                         fmaf(dk, hc.z, s[k].z), fmaf(dk, hc.w, s[k].w));
      }
  }
  if (out) reinterpret_cast<float4*>(out)[e] = hc;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// Strides and alignment of one call, in the layout of the file note of
// ssd.cu: x-like tensors (b, h, s, p), dt-like (b, h, s), B / C (b, s, n).
struct Layout {
  int BH, H, S, N, nc;
  int64_t xsb, xsh, xss, dsb, dsh, dss, bsb, bss;
  bool vec_x, vec_bc;
};

// The forward's first three launches: G = C B^T, cum and the chunk
// states, then the state pass from h0 (null: zero), leaving in states
// the state entering each chunk and in state_out the last one.
template <int P>
int launch_states(const float* x, const float* dt, const float* a,
                  const float* Bm, const float* Cm, const float* h0,
                  float* state_out, float* cum, float* cb, float* states,
                  const Layout& L, cudaStream_t stream) {
  constexpr size_t cb_smem = sizeof(float) * RING;
  constexpr size_t state_smem = sizeof(float) * (RING + Q + NW);
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(ssd_cb_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)cb_smem)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(ssd_state_kernel<P, false>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)state_smem)) != cudaSuccess)
    return (int)err;
  ssd_cb_kernel<<<dim3(TQ * (TQ + 1) / 2, L.nc, L.BH / L.H), NT, cb_smem,
                  stream>>>(Bm, Cm, cb, L.S, L.N, L.nc, L.bsb, L.bss,
                            L.vec_bc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_state_kernel<P, false><<<dim3((L.N + TS - 1) / TS, L.nc, L.BH), NT,
                               state_smem, stream>>>(
      x, dt, a, Bm, cum, states, L.H, L.S, L.N, L.nc, L.xsb, L.xsh, L.xss,
      L.dsb, L.dsh, L.dss, L.bsb, L.bss, L.vec_x, L.vec_bc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int64_t lanes = (int64_t)L.BH * P * L.N / 4;
  ssd_pass_kernel<<<(unsigned)((lanes + 255) / 256), 256, 0, stream>>>(
      cum, states, h0, state_out, lanes, P * L.N / 4, L.nc, false);
  return (int)cudaGetLastError();
}

// The launchers' own argument checks, 1000 + k (names in
// kernels/ssd/ops.py), shared by the scan and its backward; 0 if taken.
int ssd_refused(int BH, int H, int S, int P, int N, int chunk) {
  if (P != 16 && P != 32 && P != 64) return 1001;
  if (N < 1 || N > MAX_N) return 1002;
  if (BH < 1 || S < 1) return 1003;
  if (H < 1 || BH % H != 0) return 1004;
  if (chunk != Q) return 1005;
  if ((S + Q - 1) / Q > 65535 || BH > 65535) return 1006;
  return 0;
}

// A state-shaped (BH, P, N) input, read as float4 lanes: null or 16-byte
// aligned (1007 otherwise).
int ssd_refused_state(const float* p) {
  return p && !aligned16(p) ? 1007 : 0;
}

Layout ssd_layout(const float* x, const float* Bm, const float* Cm, int BH,
                  int H, int S, int N, int64_t xsb, int64_t xsh, int64_t xss,
                  int64_t dsb, int64_t dsh, int64_t dss, int64_t bsb,
                  int64_t bss) {
  Layout L{BH, H, S, N, (S + Q - 1) / Q, xsb, xsh, xss, dsb, dsh, dss, bsb,
           bss, false, false};
  L.vec_x = aligned16(x) && xsb % 4 == 0 && xsh % 4 == 0 && xss % 4 == 0;
  L.vec_bc = aligned16(Bm) && aligned16(Cm) && bsb % 4 == 0 && bss % 4 == 0;
  return L;
}

}  // namespace
