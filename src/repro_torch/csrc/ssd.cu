// Mamba2 chunked SSD scan for Hopper (sm_90a), bound through a plain C
// interface and loaded with ctypes (repro_torch/kernels/build.py).
//
//   ssd_scan  <- ssd / _kernel of src/repro/kernels/ssd/ssd.py:74
//
// For each (batch row, head) bh the selective-state recurrence
//   h_t = exp(dt_t a) h_{t-1} + dt_t x_t B_t^T   (P x N),   y_t = h_t C_t
// from a zero state; the final state is emitted.  The TPU kernel's grid
// (BH, chunks) runs the chunk axis in order with the state in VMEM
// scratch.  Here the scan is split as in the Mamba2 paper (arXiv:
// 2405.21060, section 6), so every chunk's products run in parallel and
// only an elementwise recurrence over the chunk states is sequential.
// Chunks are the model's own Q = 256 rows; four launches a call:
//
//   1. ssd_cb_kernel      G = C B^T once per (batch row, chunk), shared by
//                         every head of the row: only its lower triangle,
//                         in 64 x 64 tiles (10 of the 16), the diagonal
//                         tile zeroed above the diagonal.
//   2. ssd_state_kernel   per (bh, chunk) in parallel: cum, the inclusive
//                         cumsum of dt a over the chunk (written for the
//                         later passes), then the chunk's own state s_c
//                         = (B o w)^T x as N x P, w_t = exp(cum_last -
//                         cum_t) dt_t, stored P x N.
//   3. ssd_pass_kernel    h_c = exp(cum_last,c) h_{c-1} + s_c in chunk
//                         order, elementwise over bh x P x N (float4
//                         lanes, the loads of 8 chunks in flight at once);
//                         each s_c is overwritten in place by h_{c-1}, the
//                         state entering chunk c; the last h is the final
//                         state.
//   4. ssd_scan_kernel    per (bh, chunk, 64 output rows) in parallel,
//                         y = (L o G) x + exp(cum) o (C h_{c-1}^T), with
//                         L_ij = exp(cum_i - cum_j) dt_j for i >= j: one
//                         k loop over the lower-triangle columns of G,
//                         then over N for the carried state.
//
// The products run on the tensor cores in 3xTF32, mma.sync.m16n8k8 with
// a float32 accumulator: each float32 operand v is split into a big and
// a small tf32 part as CUTLASS's fast accurate float32 does it -- big = v
// rounded toward zero, small = v - big rounded to nearest, ties away --
// and small b' + big small' + big big' is added, which keeps float32
// accuracy (plain TF32 keeps about three decimal digits).  The roundings
// are integer operations: cvt.rna.tf32.f32 compiles to a longer sequence
// on sm_90, and at these shapes the kernels are bound by issuing the
// operand work (loads, decay factors, splits), not by the tensor cores.
// A block is 4 warps.  In the scan and C B^T kernels each warp owns 16
// rows of a 64-row output tile; in the state kernel 32 rows of a
// 128-row one, so each B value is loaded and split once for two MMA
// strips.  Operand tiles, 32 deep, are staged into shared memory by
// cp.async in a ring of two, so the copies of the next tile overlap the
// products of this one; decay factors are applied to the A operand as its
// fragments are read.  Shared-memory row strides of 36 and 72 (or P + 8,
// 136) floats keep every fragment read free of bank conflicts.
// exp(cum_i - cum_j) is taken only where i >= j (above the diagonal
// cum_i - cum_j > 0 and exp may overflow, and inf * 0 would make a NaN);
// a warp skips the k steps wholly above its rows.  Rows past S in the
// last chunk load x = dt = B = C = 0: dt = 0 is decay 1 and zero input,
// an exact no-op, as the reference's ssd_chunked pads; their y is not
// stored.  A NaN or an infinity in the inputs reaches the outputs.
//
// Layout: x and y are (b, h, s, p) with strides (xsb, xsh, xss, 1) and dt
// (b, h, s) with (dsb, dsh, dss), bh = b * H + h; B and C are (b, s, n)
// with (bsb, bss, 1), shared by the H heads of a batch row.  The Pallas
// signature (per-head B and C, (BH, S, P) x) is H = 1; the Mamba2 model
// passes its (batch, S, heads, P) activations and its (batch, S, N) B and
// C as they are, with no broadcast copy across heads.  a is (BH,).  The
// wrapper allocates the scratch: cum (BH, chunks, Q), G (B, chunks, Q, Q)
// and the chunk states (BH, chunks, P, N).
//
// Bound on an H100 SXM: at the mamba2-370m prefill (B 4, S 2048, H 32, P
// 64, N 128) the least work over every chunk length Q is at Q = 16: the
// lower triangles of C B^T once per batch row and chunk (B S (Q + 1) / 2
// N = 0.009e9 FMA) and of (L o G)(x) per head (BH S (Q + 1) / 2 P =
// 0.14e9), the two state products (2 BH S N P = 4.29e9) and the state
// passing (BH (S / Q - 1) P N = 0.13e9): 9.16 GFLOP, 0.137 ms at the
// 67 TFLOP/s float32 rate and 0.056 ms at the 3xTF32 rate (495 / 3
// TFLOP/s) of the tensor cores the kernels use; the bytes (x, y, dt, B,
// C, the final state: 147.9 MB) take 0.044 ms.  Bound by operations.
// These kernels' own Q = 256 does 13.2 GFLOP.  The scratch adds traffic
// beyond that bound: the chunk states are BH (S / Q) P N 4 bytes = 33.6 MB
// (134 MB at chunks of 64), written once, read and rewritten by the state
// pass and read once more; G is 5.2 MB written and read per head from L2.

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
// (g + 8, 8 nt + 2t + {0, 1}).  The three products of an n-tile share its
// accumulator, so they are issued a round at a time over the n-tiles and
// no product waits on the one before.
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
#pragma unroll
    for (int nt = 0; nt < NT8; ++nt)
      if (nt < nt_end) mma(acc[m][nt], as[m], bb[nt][0], bb[nt][1]);
#pragma unroll
    for (int nt = 0; nt < NT8; ++nt)
      if (nt < nt_end) mma(acc[m][nt], ab[m], bs[nt][0], bs[nt][1]);
#pragma unroll
    for (int nt = 0; nt < NT8; ++nt)
      if (nt < nt_end) mma(acc[m][nt], ab[m], bb[nt][0], bb[nt][1]);
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
//    in parallel over every chunk
// ---------------------------------------------------------------------------

template <int P>
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
    if (blockIdx.x == 0) {
      cumc[k] = sc[k];
      cumc[k + 1] = sc[k + 1];
    }
    const float last = sc[Q - 1];
    const float w0 = expf(last - sc[k]) * d0;
    const float w1 = expf(last - sc[k + 1]) * d1;
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
// 4. state passing, in chunk order, elementwise
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(256)
ssd_pass_kernel(const float* __restrict__ cum, float* __restrict__ states,
                float* __restrict__ state_out, int64_t lanes, int PN4,
                int nc) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= lanes) return;
  const int64_t bh = e / PN4;
  const int rem = (int)(e % PN4);
  constexpr int GROUP = 8;              // chunks whose loads fly together
  float4* s4 = reinterpret_cast<float4*>(states) + bh * nc * PN4 + rem;
  const float* last = cum + bh * nc * Q + Q - 1;
  float4 hc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nc; c0 += GROUP) {
    float4 s[GROUP];
    float d[GROUP];
#pragma unroll
    for (int k = 0; k < GROUP; ++k)
      if (c0 + k < nc) {
        s[k] = s4[(int64_t)(c0 + k) * PN4];
        d[k] = last[(int64_t)(c0 + k) * Q];
      }
#pragma unroll
    for (int k = 0; k < GROUP; ++k)
      if (c0 + k < nc) {
        s4[(int64_t)(c0 + k) * PN4] = hc;   // the state entering the chunk
        const float dk = expf(d[k]);
        hc = make_float4(fmaf(dk, hc.x, s[k].x), fmaf(dk, hc.y, s[k].y),
                         fmaf(dk, hc.z, s[k].z), fmaf(dk, hc.w, s[k].w));
      }
  }
  reinterpret_cast<float4*>(state_out)[e] = hc;
}

// ---------------------------------------------------------------------------
// 5. chunk scan, y = (L o G) x + exp(cum) o C h^T, in parallel
// ---------------------------------------------------------------------------

template <int P>
__global__ void __launch_bounds__(NT)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ Cm, const float* __restrict__ cum,
                const float* __restrict__ cb, const float* __restrict__ states,
                float* __restrict__ y, int H, int S, int N, int nc,
                int64_t xsb, int64_t xsh, int64_t xss, int64_t dsb,
                int64_t dsh, int64_t dss, int64_t bsb, int64_t bss,
                bool vec_x, bool vec_bc) {
  constexpr int NT8 = P / 8, XS = P + 8;
  extern __shared__ __align__(16) float ring[];
  float* scum = ring + RING;            // the chunk's cum, then its dt
  float* sdt = scum + Q;
  const int i0 = blockIdx.x * TR, c = blockIdx.y, bh = blockIdx.z;
  const int b = bh / H, h = bh % H;
  const int vq = valid_rows(S, c);
  if (i0 >= vq) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, r0 = warp * 16;
  const int64_t t0 = (int64_t)c * Q;
  const float* cumc = cum + ((int64_t)bh * nc + c) * Q;
  const float* dtb = dt + b * dsb + h * dsh + t0 * dss;
  for (int k = threadIdx.x; k < Q; k += NT) {
    scum[k] = cumc[k];
    sdt[k] = k < vq ? dtb[k * dss] : 0.f;
  }
  // this lane's two rows, g and g + 8 of its warp's strip
  const float cum_r[2] = {cumc[i0 + r0 + g], cumc[i0 + r0 + g + 8]};
  const float ecum_r[2] = {expf(cum_r[0]), expf(cum_r[1])};
  // columns j < i0 + 64 hold the lower triangle; past vq x is zero
  const int ki = (min(i0 + TR, vq) + KT - 1) / KT;
  const int ks = c > 0 ? (N + KT - 1) / KT : 0;   // h_{-1} = 0
  const float* G = cb + (((int64_t)b * nc + c) * Q + i0) * Q;
  const float* xb = x + b * xsb + h * xsh + t0 * xss;
  const float* Cb = Cm + b * bsb + (t0 + i0) * bss;
  const float* hb = states + ((int64_t)bh * nc + c) * P * N;
  const bool vec_h = N % 4 == 0;
  float acc[1][NT8][4] = {};
  // tiles kt < ki: A = L o G from G [i][j], B = x [j][p]; then A =
  // exp(cum) o C from C [i][n], B(k = n, column p) = h [p][n]
  pipeline(
      ki + ks,
      [&](int kt, int st) {
        if (kt < ki) {
          const int j = kt * KT;
          stage<TR, KT>(tile_a(ring, st), RS, G + j, Q, TR, KT, true);
          stage<KT, P>(tile_b(ring, st), XS, xb + j * xss, xss, vq - j, P,
                       vec_x);
        } else {
          const int n = (kt - ki) * KT;
          stage<TR, KT>(tile_a(ring, st), RS, Cb + n, bss, vq - i0, N - n,
                        vec_bc);
          stage<P, KT>(tile_b(ring, st), RS, hb + n, N, P, N - n, vec_h);
        }
      },
      [&](int kt, int st) {
        const float* a = tile_a(ring, st);
        if (kt < ki) {
#pragma unroll
          for (int k0 = 0; k0 < KT; k0 += 8) {
            if (kt * KT + k0 > i0 + r0 + 15) break;   // above this warp's rows
            float av[1][4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int row = r0 + g + 8 * (q & 1), kk = k0 + t + 4 * (q >> 1);
              const int j = kt * KT + kk;
              // exp only of cum_i - cum_j <= 0: zero above the diagonal
              const float arg =
                  j <= i0 + row ? cum_r[q & 1] - scum[j] : -INFINITY;
              av[0][q] = expf(arg) * sdt[j] * a[row * RS + kk];
            }
            mma_step<1, NT8, XS, 1>(acc, av, tile_b(ring, st), k0, lane, NT8);
          }
        } else {
#pragma unroll
          for (int k0 = 0; k0 < KT; k0 += 8) {
            float av[1][4];
#pragma unroll
            for (int q = 0; q < 4; ++q)
              av[0][q] = a[(r0 + g + 8 * (q & 1)) * RS + k0 + t +
                           4 * (q >> 1)] *
                         ecum_r[q & 1];
            mma_step<1, NT8, 1, RS>(acc, av, tile_b(ring, st), k0, lane, NT8);
          }
        }
      });
  float* yb = y + b * xsb + h * xsh + (t0 + i0) * xss;
#pragma unroll
  for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = r0 + g + 8 * hf;
      if (i0 + row < vq)
        *reinterpret_cast<float2*>(yb + row * xss + nt * 8 + 2 * t) =
            make_float2(acc[0][nt][2 * hf], acc[0][nt][2 * hf + 1]);
    }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

template <int P>
int launch(const float* x, const float* dt, const float* a, const float* Bm,
           const float* Cm, float* y, float* st, float* cum, float* cb,
           float* states, int BH, int H, int S, int N, int64_t xsb,
           int64_t xsh, int64_t xss, int64_t dsb, int64_t dsh, int64_t dss,
           int64_t bsb, int64_t bss, cudaStream_t stream) {
  const int nc = (S + Q - 1) / Q, Bsz = BH / H;
  const bool vec_x = aligned16(x) && xsb % 4 == 0 && xsh % 4 == 0 &&
                     xss % 4 == 0;
  const bool vec_bc = aligned16(Bm) && aligned16(Cm) && bsb % 4 == 0 &&
                      bss % 4 == 0;
  constexpr size_t cb_smem = sizeof(float) * RING;
  constexpr size_t state_smem = sizeof(float) * (RING + Q + NW);
  constexpr size_t scan_smem = sizeof(float) * (RING + 2 * Q);
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(ssd_cb_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)cb_smem)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(ssd_state_kernel<P>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)state_smem)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(ssd_scan_kernel<P>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)scan_smem)) != cudaSuccess)
    return (int)err;
  ssd_cb_kernel<<<dim3(TQ * (TQ + 1) / 2, nc, Bsz), NT, cb_smem, stream>>>(
      Bm, Cm, cb, S, N, nc, bsb, bss, vec_bc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_state_kernel<P><<<dim3((N + TS - 1) / TS, nc, BH), NT, state_smem,
                        stream>>>(x, dt, a, Bm, cum, states, H, S, N, nc,
                                  xsb, xsh, xss, dsb, dsh, dss, bsb, bss,
                                  vec_x, vec_bc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int64_t lanes = (int64_t)BH * P * N / 4;
  ssd_pass_kernel<<<(unsigned)((lanes + 255) / 256), 256, 0, stream>>>(
      cum, states, st, lanes, P * N / 4, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_scan_kernel<P><<<dim3(TQ, nc, BH), NT, scan_smem, stream>>>(
      x, dt, Cm, cum, cb, states, y, H, S, N, nc, xsb, xsh, xss, dsb, dsh,
      dss, bsb, bss, vec_x, vec_bc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launches (0 = launched); 1000 + k
// for an argument the kernels do not take.  cum, cb and states are the
// caller's scratch: (BH, nc, Q), (BH / H, nc, Q, Q) and (BH, nc, P, N)
// floats, nc = ceil(S / Q); chunk must be Q.
int ssd_scan(const float* x, const float* dt, const float* a, const float* Bm,
             const float* Cm, float* y, float* state, float* cum, float* cb,
             float* states, int BH, int H, int S, int P, int N, int chunk,
             int64_t xsb, int64_t xsh, int64_t xss, int64_t dsb, int64_t dsh,
             int64_t dss, int64_t bsb, int64_t bss, void* stream) {
  if (P != 16 && P != 32 && P != 64) return 1001;
  if (N < 1 || N > MAX_N) return 1002;
  if (BH < 1 || S < 1) return 1003;
  if (H < 1 || BH % H != 0) return 1004;
  if (chunk != Q) return 1005;
  if ((S + Q - 1) / Q > 65535 || BH > 65535) return 1006;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (P) {
    case 16: return launch<16>(x, dt, a, Bm, Cm, y, state, cum, cb, states,
                               BH, H, S, N, xsb, xsh, xss, dsb, dsh, dss, bsb,
                               bss, s);
    case 32: return launch<32>(x, dt, a, Bm, Cm, y, state, cum, cb, states,
                               BH, H, S, N, xsb, xsh, xss, dsb, dsh, dss, bsb,
                               bss, s);
    default: return launch<64>(x, dt, a, Bm, Cm, y, state, cum, cb, states,
                               BH, H, S, N, xsb, xsh, xss, dsb, dsh, dss, bsb,
                               bss, s);
  }
}

}  // extern "C"
