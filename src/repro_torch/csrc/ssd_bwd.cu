// The backward of the Mamba2 chunked SSD scan for Hopper (sm_90a), bound
// through a plain C interface and loaded with ctypes
// (repro_torch/kernels/build.py).
//
//   ssd_bwd  <- the gradient of ssd_chunked, src/repro/models/layers.py:709
//
// The reference has no custom VJP and no Pallas kernel for it: JAX
// differentiates the jnp chunked scan.  Here the gradient is written out
// in the chunked form of the Mamba2 paper (arXiv:2405.21060, sections
// 6-7), split into passes the way the public mamba_ssm package splits its
// Triton backward (chunk_scan_bwd_dstates, state_passing_bwd,
// chunk_state_bwd_dx, chunk_scan_bwd_dC, chunk_state_bwd_db,
// chunk_scan_bwd_dcb and the ddA_cumsum passes); nothing of that code is
// used.  Per (batch row, head) bh and chunk c of Q = 256 rows, with cum
// the in-chunk inclusive cumsum of dt a, G_ts = C_t . B_s, E_ts =
// exp(cum_t - cum_s) for t >= s, h_{c-1} the state entering chunk c
// (h_{-1} = h0) and h_c the one leaving it, given dy and the final
// state's gradient:
//
//   gh_last = dstate; gh_{c-1} = exp(cum_last) gh_c + u_c,
//       u_c = sum_t exp(cum_t) dy_t C_t^T;  dinit = gh_{-1}
//   r_s  = sum_{t>=s} E_ts G_ts dy_t + exp(cum_last - cum_s) gh_c B_s
//   dx_s = dt_s r_s
//   D_ts = dy_t . x_s   (per head)
//   dB_s = sum_h dt_s [sum_{t>=s} E_ts D_ts C_t
//                      + exp(cum_last - cum_s) gh_c^T x_s]
//   dC_t = sum_h [sum_{s<=t} E_ts dt_s D_ts B_s + exp(cum_t) h_{c-1}^T dy_t]
//   dcum_t = dy_t . y_t - dt_t (x_t . r_t)   (+ <gh_c, h_c> at the last row)
//   ddt_s = x_s . r_s + a rev_s,  da = sum_s dt_s rev_s,
//       rev the in-chunk reverse cumsum of dcum
//
// (every term of y_t carries exp(cum_t), every term of r_s exp(-cum_s),
// and h_c = exp(cum_last) h_{c-1} + s_c: so dcum needs no product of its
// own.)  x . r is taken before the multiply by dt: nothing divides by dt,
// which is 0 on the ragged tail's padded rows.  The plain version,
// kernels/ssd/ref.py ssd_chunked_bwd_ref, computes the same passes.
//
// Eleven launches a call, on the forward's machinery (ssd_common.cuh:
// the cp.async ring of two, 3xTF32 mma.sync.m16n8k8 with the big / small
// split, 4 warps a block, 64-row output tiles):
//
//   1-3. the forward's ssd_cb_kernel, ssd_state_kernel and ssd_pass_kernel
//        again, from h0: G, cum, the states entering each chunk and the
//        final state (the chunk states are 33.6 MB a layer at the
//        training shape: run again rather than kept, as under remat the
//        forward runs again anyway)
//   4.   ssd_state_kernel<GRAD>: u_c^T = (C o exp(cum))^T dy per (bh, c)
//   5.   ssd_pass_kernel in reverse chunk order from dstate: gh_c in place
//        of u_c, and dinit
//   6.   ssd_dyx_kernel: D = dy x^T per (bh, c), its lower 64 x 64 tiles
//        (10 of 16), the diagonal tile zeroed above the diagonal
//   7.   ssd_dx_kernel: r for 64 rows s a block, k over t >= s (G read
//        transposed, the tiles wholly below the rows skipped), then over
//        N for gh_c B_s; dx, and per row x . r and dcum (dy . y from the
//        forward's y)
//   8.   ssd_db_kernel: per head dB, k over t >= s (D transposed) then
//        over P for gh_c^T x_s, into a per-head partial
//   9.   ssd_dc_kernel: per head dC, k over s <= t (D) then over P for
//        h_{c-1}^T dy_t, into a per-head partial
//   10.  ssd_finish_kernel: a block a bh walks its chunks in order:
//        <gh_c, h_c>, the reverse cumsum, ddt, and da summed chunk by
//        chunk
//   11.  ssd_headsum_kernel: dB and dC, the per-head partials summed over
//        the heads in head order
//
// Deterministic: no atomics.  The sums across heads (dB, dC) and across
// chunks (da) are separate passes in one fixed order, and every block
// reduction is a fixed shuffle tree, so two calls on the same inputs give
// equal bits (an exact restart of training relies on it).  exp(cum_t -
// cum_s) is taken only where t >= s (above the diagonal it may overflow,
// and inf * 0 would be a NaN); rows past S load x = dt = B = C = dy = 0
// and store nothing.  A NaN or an infinity in the inputs reaches the
// outputs.
//
// Layout as ssd.cu's: x, y, dy and dx (b, h, s, p) with strides (xsb,
// xsh, xss, 1); dt and ddt (b, h, s) with (dsb, dsh, dss); B, C, dB, dC
// (b, s, n) with (bsb, bss, 1); a and da (BH,); h0, dstate and dinit
// (BH, P, N).  The wrapper allocates the scratch (ops.py
// ssd_bwd_cuda_heads).
//
// Bound on an H100 SXM, at the mamba2-370m training shape (B 4, S 2048,
// H 32, P 64, N 128, float32): the function needs five state products
// per head -- s_c again (the states are not among its inputs), u_c, gh_c
// B, gh_c^T x and h^T dy, 5 BH S N P = 5.37e9 FMA -- and the lower
// triangles of C B^T once per batch row, and of D, its two uses and G's
// use per head (BH S (Q + 1) / 2 (2 P + 2 N)), the two state passes and
// the row dots; the least over every chunk length Q is at Q = 10: 24.0
// GFLOP, 0.145 ms at the 3xTF32 rate (495 / 3 TFLOP/s) of the tensor
// cores these kernels use.  The bytes (x, y, dy, dx, dt, ddt, a, da, B,
// C, dB, dC: 287 MB) take 0.086 ms.  Bound by operations (chip_smoke.py
// ssd_bwd_flops counts both).  The kernels' own Q = 256 does 47.7 GFLOP
// (the triangles grow with Q), and the scratch adds traffic: D is BH (S /
// Q) Q^2 4 bytes = 268 MB, written once and read twice, the per-head dB
// and dC partials 134 MB each, written and read once.

#include "ssd_common.cuh"

namespace {

constexpr int NW8 = MAX_N / 8;          // n-tiles of a width-N output
constexpr int BUFW = KT * KS2;          // a staged [k][n] tile, n < 128
constexpr int RINGW = 2 * (ABUF + BUFW);

__device__ __forceinline__ float* tile_w(float* ring, int st) {
  return ring + 2 * ABUF + st * BUFW;
}

// The block's chunk: its cum in scum, its dt in sdt (0 past vq).
__device__ __forceinline__ void load_chunk(float* scum, float* sdt,
                                           const float* cumc,
                                           const float* dtb, int64_t dss,
                                           int vq) {
  for (int k = threadIdx.x; k < Q; k += NT) {
    scum[k] = cumc[k];
    sdt[k] = k < vq ? dtb[k * dss] : 0.f;
  }
}

// ---------------------------------------------------------------------------
// 6. D = dy x^T per (bh, chunk), lower tiles only
// ---------------------------------------------------------------------------

template <int P>
__global__ void __launch_bounds__(NT)
ssd_dyx_kernel(const float* __restrict__ dy, const float* __restrict__ x,
               float* __restrict__ dyx, Layout L) {
  extern __shared__ __align__(16) float ring[];
  int idx = blockIdx.x, ti = 0;         // the lower tiles, row by row
  while (idx > ti) idx -= ++ti;
  const int tj = idx, c = blockIdx.y, bh = blockIdx.z;
  const int b = bh / L.H, h = bh % L.H;
  const int vq = valid_rows(L.S, c);
  if (ti * TR >= vq) return;            // rows wholly past S: never read
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, r0 = warp * 16;
  const bool diag = ti == tj;
  const int nt_end = diag ? 2 * warp + 2 : 8;
  const int64_t t0 = (int64_t)c * Q;
  const int64_t xo = b * L.xsb + h * L.xsh + t0 * L.xss;
  const float* Ab = dy + xo + ti * TR * L.xss;
  const float* Xb = x + xo + tj * TR * L.xss;
  float acc[1][8][4] = {};
  // A = dy [t][p], B(k = p, column s) = x [s][p]
  pipeline(
      (P + KT - 1) / KT,
      [&](int kt, int st) {
        const int p0 = kt * KT;
        stage<TR, KT>(tile_a(ring, st), RS, Ab + p0, L.xss, vq - ti * TR,
                      P - p0, L.vec_x);
        stage<TR, KT>(tile_b(ring, st), RS, Xb + p0, L.xss, vq - tj * TR,
                      P - p0, L.vec_x);
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
  float* D = dyx + (((int64_t)bh * L.nc + c) * Q + ti * TR) * Q + tj * TR;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = r0 + g + 8 * hf, col = nt * 8 + 2 * t;
      const float v0 = !diag || col <= row ? acc[0][nt][2 * hf] : 0.f;
      const float v1 = !diag || col + 1 <= row ? acc[0][nt][2 * hf + 1] : 0.f;
      *reinterpret_cast<float2*>(D + row * Q + col) = make_float2(v0, v1);
    }
}

// ---------------------------------------------------------------------------
// 7. dx = dt o r, r = (E o G)^T dy + (B o exp(cum_last - cum)) gh^T; per
//    row x . r and dcum = dy . y - dt x . r
// ---------------------------------------------------------------------------

template <int P>
__global__ void __launch_bounds__(NT)
ssd_dx_kernel(const float* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ Bm, const float* __restrict__ y,
              const float* __restrict__ dy, const float* __restrict__ cum,
              const float* __restrict__ cb,
              const float* __restrict__ gstates, float* __restrict__ dx,
              float* __restrict__ xr, float* __restrict__ dcum, Layout L) {
  constexpr int NT8 = P / 8, XS = P + 8;
  extern __shared__ __align__(16) float ring[];
  float* scum = ring + RING;
  float* sdt = scum + Q;
  const int i0 = blockIdx.x * TR, c = blockIdx.y, bh = blockIdx.z;
  const int b = bh / L.H, h = bh % L.H, N = L.N;
  const int vq = valid_rows(L.S, c);
  if (i0 >= vq) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, r0 = warp * 16;
  const int64_t t0 = (int64_t)c * Q;
  const float* cumc = cum + ((int64_t)bh * L.nc + c) * Q;
  load_chunk(scum, sdt, cumc, dt + b * L.dsb + h * L.dsh + t0 * L.dss,
             L.dss, vq);
  const float last = cumc[Q - 1];
  // this lane's two rows s, g and g + 8 of its warp's strip
  const float cum_r[2] = {cumc[i0 + r0 + g], cumc[i0 + r0 + g + 8]};
  const float eto_r[2] = {expf(last - cum_r[0]), expf(last - cum_r[1])};
  // k tiles over t from the block's first row to vq, then over N
  const int kt0 = i0 / KT;
  const int n1 = (vq + KT - 1) / KT - kt0;
  const int n2 = (N + KT - 1) / KT;
  const float* G = cb + ((int64_t)b * L.nc + c) * Q * Q;     // G [t][s]
  const int64_t xo = b * L.xsb + h * L.xsh + t0 * L.xss;
  const float* dyb = dy + xo;
  const float* Bb = Bm + b * L.bsb + (t0 + i0) * L.bss;
  const float* ghb = gstates + ((int64_t)bh * L.nc + c) * P * N;
  const bool vec_h = N % 4 == 0;
  float acc[1][NT8][4] = {};
  // tiles kt < n1: A(s, t) = E_ts G [t][s] from G stored [k = t][row = s],
  // B = dy [t][p]; then A = exp(cum_last - cum) o B from B [s][n],
  // B(k = n, column p) = gh [p][n]
  pipeline(
      n1 + n2,
      [&](int kt, int st) {
        if (kt < n1) {
          const int j = (kt0 + kt) * KT;
          stage<KT, TR>(tile_a(ring, st), KS, G + (int64_t)j * Q + i0, Q,
                        vq - j, TR, true);
          stage<KT, P>(tile_b(ring, st), XS, dyb + j * L.xss, L.xss, vq - j,
                       P, L.vec_x);
        } else {
          const int n = (kt - n1) * KT;
          stage<TR, KT>(tile_a(ring, st), RS, Bb + n, L.bss, vq - i0, N - n,
                        L.vec_bc);
          stage<P, KT>(tile_b(ring, st), RS, ghb + n, N, P, N - n, vec_h);
        }
      },
      [&](int kt, int st) {
        const float* a = tile_a(ring, st);
        if (kt < n1) {
#pragma unroll
          for (int k0 = 0; k0 < KT; k0 += 8) {
            const int j0 = (kt0 + kt) * KT + k0;
            if (j0 + 7 < i0 + r0) continue;   // wholly below this warp's rows
            float av[1][4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int row = r0 + g + 8 * (q & 1), kk = k0 + t + 4 * (q >> 1);
              const int j = j0 - k0 + kk;
              // exp only of cum_t - cum_s <= 0: zero where t < s
              const float arg =
                  j >= i0 + row ? scum[j] - cum_r[q & 1] : -INFINITY;
              av[0][q] = expf(arg) * a[kk * KS + row];
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
                         eto_r[q & 1];
            mma_step<1, NT8, 1, RS>(acc, av, tile_b(ring, st), k0, lane, NT8);
          }
        }
      });
  // dx = dt r; x . r and dy . y over this lane's columns, then the quad's
  const int64_t ro = xo + i0 * L.xss;
  float sxr[2] = {0.f, 0.f}, syy[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = r0 + g + 8 * hf;
      if (i0 + row < vq) {
        const int64_t o = ro + row * L.xss + nt * 8 + 2 * t;
        const float r0v = acc[0][nt][2 * hf], r1v = acc[0][nt][2 * hf + 1];
        const float d = sdt[i0 + row];
        dx[o] = d * r0v;
        dx[o + 1] = d * r1v;
        sxr[hf] += x[o] * r0v + x[o + 1] * r1v;
        syy[hf] += dy[o] * y[o] + dy[o + 1] * y[o + 1];
      }
    }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sxr[hf] += __shfl_xor_sync(0xffffffffu, sxr[hf], off);
      syy[hf] += __shfl_xor_sync(0xffffffffu, syy[hf], off);
    }
  if (t == 0)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int s = i0 + r0 + g + 8 * hf;
      if (s < vq) {
        const int64_t o = ((int64_t)bh * L.nc + c) * Q + s;
        xr[o] = sxr[hf];
        dcum[o] = syy[hf] - sdt[s] * sxr[hf];
      }
    }
}

// ---------------------------------------------------------------------------
// 8. per-head dB = dt o [(E o D)^T C + (x o exp(cum_last - cum)) gh]
// ---------------------------------------------------------------------------

template <int P>
__global__ void __launch_bounds__(NT)
ssd_db_kernel(const float* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ Cm, const float* __restrict__ cum,
              const float* __restrict__ dyx,
              const float* __restrict__ gstates, float* __restrict__ dBp,
              Layout L) {
  extern __shared__ __align__(16) float ring[];
  float* scum = ring + RINGW;
  float* sdt = scum + Q;
  const int i0 = blockIdx.x * TR, c = blockIdx.y, bh = blockIdx.z;
  const int b = bh / L.H, h = bh % L.H, N = L.N;
  const int vq = valid_rows(L.S, c);
  if (i0 >= vq) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, r0 = warp * 16;
  const int64_t t0 = (int64_t)c * Q;
  const float* cumc = cum + ((int64_t)bh * L.nc + c) * Q;
  load_chunk(scum, sdt, cumc, dt + b * L.dsb + h * L.dsh + t0 * L.dss,
             L.dss, vq);
  const float last = cumc[Q - 1];
  const float cum_r[2] = {cumc[i0 + r0 + g], cumc[i0 + r0 + g + 8]};
  const float eto_r[2] = {expf(last - cum_r[0]), expf(last - cum_r[1])};
  const int nt_end = (N + 7) / 8;
  const int kt0 = i0 / KT;
  const int n1 = (vq + KT - 1) / KT - kt0;
  const int n2 = (P + KT - 1) / KT;
  const float* D = dyx + ((int64_t)bh * L.nc + c) * Q * Q;    // D [t][s]
  const float* Cb = Cm + b * L.bsb + t0 * L.bss;
  const float* xb = x + b * L.xsb + h * L.xsh + (t0 + i0) * L.xss;
  const float* ghb = gstates + ((int64_t)bh * L.nc + c) * P * N;
  const bool vec_h = N % 4 == 0;
  float acc[1][NW8][4] = {};
  // tiles kt < n1: A(s, t) = E_ts D [t][s] from D stored [k = t][row = s],
  // B = C [t][n]; then A = exp(cum_last - cum) o x from x [s][p],
  // B = gh [p][n]
  pipeline(
      n1 + n2,
      [&](int kt, int st) {
        if (kt < n1) {
          const int j = (kt0 + kt) * KT;
          stage<KT, TR>(tile_a(ring, st), KS, D + (int64_t)j * Q + i0, Q,
                        vq - j, TR, true);
          stage<KT, MAX_N>(tile_w(ring, st), KS2, Cb + j * L.bss, L.bss,
                           vq - j, N, L.vec_bc);
        } else {
          const int p = (kt - n1) * KT;
          stage<TR, KT>(tile_a(ring, st), RS, xb + p, L.xss, vq - i0, P - p,
                        L.vec_x);
          stage<KT, MAX_N>(tile_w(ring, st), KS2, ghb + p * N, N, P - p, N,
                           vec_h);
        }
      },
      [&](int kt, int st) {
        const float* a = tile_a(ring, st);
        if (kt < n1) {
#pragma unroll
          for (int k0 = 0; k0 < KT; k0 += 8) {
            const int j0 = (kt0 + kt) * KT + k0;
            if (j0 + 7 < i0 + r0) continue;   // wholly below this warp's rows
            float av[1][4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int row = r0 + g + 8 * (q & 1), kk = k0 + t + 4 * (q >> 1);
              const int j = j0 - k0 + kk;
              const float arg =
                  j >= i0 + row ? scum[j] - cum_r[q & 1] : -INFINITY;
              av[0][q] = expf(arg) * a[kk * KS + row];
            }
            mma_step<1, NW8, KS2, 1>(acc, av, tile_w(ring, st), k0, lane,
                                     nt_end);
          }
        } else {
#pragma unroll
          for (int k0 = 0; k0 < KT; k0 += 8) {
            float av[1][4];
#pragma unroll
            for (int q = 0; q < 4; ++q)
              av[0][q] = a[(r0 + g + 8 * (q & 1)) * RS + k0 + t +
                           4 * (q >> 1)] *
                         eto_r[q & 1];
            mma_step<1, NW8, KS2, 1>(acc, av, tile_w(ring, st), k0, lane,
                                     nt_end);
          }
        }
      });
#pragma unroll
  for (int nt = 0; nt < NW8; ++nt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int s = i0 + r0 + g + 8 * hf, n = nt * 8 + 2 * t;
      if (nt < nt_end && s < vq) {
        float* out = dBp + ((int64_t)bh * L.S + t0 + s) * N;
        const float d = sdt[s];
        if (n < N) out[n] = d * acc[0][nt][2 * hf];
        if (n + 1 < N) out[n + 1] = d * acc[0][nt][2 * hf + 1];
      }
    }
}

// ---------------------------------------------------------------------------
// 9. per-head dC = (E o dt_s o D) B + (exp(cum) o dy) h_{c-1}
// ---------------------------------------------------------------------------

template <int P>
__global__ void __launch_bounds__(NT)
ssd_dc_kernel(const float* __restrict__ dt, const float* __restrict__ Bm,
              const float* __restrict__ dy, const float* __restrict__ cum,
              const float* __restrict__ dyx,
              const float* __restrict__ states, float* __restrict__ dCp,
              Layout L) {
  extern __shared__ __align__(16) float ring[];
  float* scum = ring + RINGW;
  float* sdt = scum + Q;
  const int i0 = blockIdx.x * TR, c = blockIdx.y, bh = blockIdx.z;
  const int b = bh / L.H, h = bh % L.H, N = L.N;
  const int vq = valid_rows(L.S, c);
  if (i0 >= vq) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, r0 = warp * 16;
  const int64_t t0 = (int64_t)c * Q;
  const float* cumc = cum + ((int64_t)bh * L.nc + c) * Q;
  load_chunk(scum, sdt, cumc, dt + b * L.dsb + h * L.dsh + t0 * L.dss,
             L.dss, vq);
  const float cum_r[2] = {cumc[i0 + r0 + g], cumc[i0 + r0 + g + 8]};
  const float ecum_r[2] = {expf(cum_r[0]), expf(cum_r[1])};
  const int nt_end = (N + 7) / 8;
  // columns s < i0 + 64 hold the lower triangle; past vq B is zero
  const int ki = (min(i0 + TR, vq) + KT - 1) / KT;
  const int n2 = (P + KT - 1) / KT;
  const float* D = dyx + (((int64_t)bh * L.nc + c) * Q + i0) * Q;
  const float* Bb = Bm + b * L.bsb + t0 * L.bss;
  const float* dyb = dy + b * L.xsb + h * L.xsh + (t0 + i0) * L.xss;
  const float* hb = states + ((int64_t)bh * L.nc + c) * P * N;
  const bool vec_h = N % 4 == 0;
  float acc[1][NW8][4] = {};
  // tiles kt < ki: A = E o dt_s o D from D [t][s], B = B [s][n]; then
  // A = exp(cum) o dy from dy [t][p], B = h [p][n]
  pipeline(
      ki + n2,
      [&](int kt, int st) {
        if (kt < ki) {
          const int j = kt * KT;
          stage<TR, KT>(tile_a(ring, st), RS, D + j, Q, TR, KT, true);
          stage<KT, MAX_N>(tile_w(ring, st), KS2, Bb + j * L.bss, L.bss,
                           vq - j, N, L.vec_bc);
        } else {
          const int p = (kt - ki) * KT;
          stage<TR, KT>(tile_a(ring, st), RS, dyb + p, L.xss, vq - i0, P - p,
                        L.vec_x);
          stage<KT, MAX_N>(tile_w(ring, st), KS2, hb + p * N, N, P - p, N,
                           vec_h);
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
              const float arg =
                  j <= i0 + row ? cum_r[q & 1] - scum[j] : -INFINITY;
              av[0][q] = expf(arg) * sdt[j] * a[row * RS + kk];
            }
            mma_step<1, NW8, KS2, 1>(acc, av, tile_w(ring, st), k0, lane,
                                     nt_end);
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
            mma_step<1, NW8, KS2, 1>(acc, av, tile_w(ring, st), k0, lane,
                                     nt_end);
          }
        }
      });
#pragma unroll
  for (int nt = 0; nt < NW8; ++nt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int s = i0 + r0 + g + 8 * hf, n = nt * 8 + 2 * t;
      if (nt < nt_end && s < vq) {
        float* out = dCp + ((int64_t)bh * L.S + t0 + s) * N;
        if (n < N) out[n] = acc[0][nt][2 * hf];
        if (n + 1 < N) out[n + 1] = acc[0][nt][2 * hf + 1];
      }
    }
}

// ---------------------------------------------------------------------------
// 10. ddt and da: a block of Q threads a bh, its chunks in order
// ---------------------------------------------------------------------------

// The sum of v over the block's Q threads in one fixed order, to every
// thread: a shuffle tree a warp, then the warps' sums in warp order.
__device__ __forceinline__ float block_sum(float v, float* part) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < Q / 32; ++w) s += part[w];
  __syncthreads();
  return s;
}

__global__ void __launch_bounds__(Q)
ssd_finish_kernel(const float* __restrict__ dt, const float* __restrict__ A,
                  const float* __restrict__ xr,
                  const float* __restrict__ dcum,
                  const float* __restrict__ gstates,
                  const float* __restrict__ states,
                  const float* __restrict__ hfin, float* __restrict__ ddt,
                  float* __restrict__ da, int PN4, Layout L) {
  __shared__ float part[Q / 32];
  __shared__ float rev[Q];
  const int bh = blockIdx.x, b = bh / L.H, h = bh % L.H;
  const int k = threadIdx.x, lane = k & 31, warp = k >> 5;
  const float a = A[bh];
  float da_sum = 0.f;
  for (int c = 0; c < L.nc; ++c) {
    const int vq = valid_rows(L.S, c);
    const int64_t t0 = (int64_t)c * Q;
    const int64_t row = ((int64_t)bh * L.nc + c) * Q + k;
    // <gh_c, h_c>: h_c enters chunk c + 1, or is the final state
    const float4* g4 = reinterpret_cast<const float4*>(gstates) +
                       ((int64_t)bh * L.nc + c) * PN4;
    const float4* h4 =
        reinterpret_cast<const float4*>(c + 1 < L.nc ? states : hfin) +
        (c + 1 < L.nc ? ((int64_t)bh * L.nc + c + 1) * PN4
                      : (int64_t)bh * PN4);
    float dot = 0.f;
    for (int i = k; i < PN4; i += Q) {
      const float4 gv = g4[i], hv = h4[i];
      dot += gv.x * hv.x + gv.y * hv.y + gv.z * hv.z + gv.w * hv.w;
    }
    dot = block_sum(dot, part);
    float v = k < vq ? dcum[row] : 0.f;
    if (k == Q - 1) v += dot;
    // rev_k = sum_{j >= k} dcum_j: thread k scans the reversed rows
    rev[k] = v;
    __syncthreads();
    float incl = rev[Q - 1 - k];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += up;
    }
    if (lane == 31) part[warp] = incl;
    __syncthreads();
    float base = 0.f;
    for (int w = 0; w < warp; ++w) base += part[w];
    __syncthreads();                    // every read of rev and part done
    rev[Q - 1 - k] = base + incl;
    __syncthreads();
    const float r = rev[k];
    const float* dtb = dt + b * L.dsb + h * L.dsh + t0 * L.dss;
    const float d = k < vq ? dtb[k * L.dss] : 0.f;
    if (k < vq) ddt[b * L.dsb + h * L.dsh + (t0 + k) * L.dss] = xr[row] + a * r;
    da_sum += block_sum(d * r, part);   // chunk by chunk, in order
  }
  if (k == 0) da[bh] = da_sum;
}

// ---------------------------------------------------------------------------
// 11. dB and dC: the per-head partials summed over the heads in order
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(256)
ssd_headsum_kernel(const float* __restrict__ dBp,
                   const float* __restrict__ dCp, float* __restrict__ dB,
                   float* __restrict__ dC, Layout L) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t per_b = (int64_t)L.S * L.N;
  if (e >= (int64_t)(L.BH / L.H) * per_b) return;
  const int64_t b = e / per_b, rem = e % per_b;
  const int64_t s = rem / L.N, n = rem % L.N;
  const float* pb = dBp + b * L.H * per_b + rem;
  const float* pc = dCp + b * L.H * per_b + rem;
  float sb = 0.f, sc = 0.f;
  for (int h = 0; h < L.H; ++h) {
    sb += pb[h * per_b];
    sc += pc[h * per_b];
  }
  dB[b * L.bsb + s * L.bss + n] = sb;
  dC[b * L.bsb + s * L.bss + n] = sc;
}

template <int P>
int launch_bwd(const float* x, const float* dt, const float* a,
               const float* Bm, const float* Cm, const float* h0,
               const float* y, const float* dy, const float* dstate,
               float* dx, float* ddt, float* da, float* dB, float* dC,
               float* dinit, float* cum, float* cb, float* states,
               float* hfin, float* gstates, float* dyx, float* dBp,
               float* dCp, float* dcum, float* xr, const Layout& L,
               cudaStream_t stream) {
  constexpr size_t state_smem = sizeof(float) * (RING + Q + NW);
  constexpr size_t dyx_smem = sizeof(float) * RING;
  constexpr size_t dx_smem = sizeof(float) * (RING + 2 * Q);
  constexpr size_t w_smem = sizeof(float) * (RINGW + 2 * Q);
  constexpr auto attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(ssd_state_kernel<P, true>, attr,
                                  (int)state_smem)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(ssd_dyx_kernel<P>, attr,
                                  (int)dyx_smem)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(ssd_dx_kernel<P>, attr, (int)dx_smem)) !=
          cudaSuccess ||
      (err = cudaFuncSetAttribute(ssd_db_kernel<P>, attr, (int)w_smem)) !=
          cudaSuccess ||
      (err = cudaFuncSetAttribute(ssd_dc_kernel<P>, attr, (int)w_smem)) !=
          cudaSuccess)
    return (int)err;
  // 1-3: the forward's G, cum, entering states and final state
  int rc = launch_states<P>(x, dt, a, Bm, Cm, h0, hfin, cum, cb, states, L,
                            stream);
  if (rc != 0) return rc;
  // 4-5: u_c, then the reverse pass from dstate
  ssd_state_kernel<P, true><<<dim3((L.N + TS - 1) / TS, L.nc, L.BH), NT,
                              state_smem, stream>>>(
      dy, dt, a, Cm, cum, gstates, L.H, L.S, L.N, L.nc, L.xsb, L.xsh, L.xss,
      L.dsb, L.dsh, L.dss, L.bsb, L.bss, L.vec_x, L.vec_bc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int PN4 = P * L.N / 4;
  const int64_t lanes = (int64_t)L.BH * PN4;
  ssd_pass_kernel<<<(unsigned)((lanes + 255) / 256), 256, 0, stream>>>(
      cum, gstates, dstate, dinit, lanes, PN4, L.nc, true);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // 6-9: D, then dx, dB and dC
  ssd_dyx_kernel<P><<<dim3(TQ * (TQ + 1) / 2, L.nc, L.BH), NT, dyx_smem,
                      stream>>>(dy, x, dyx, L);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const dim3 tiles(TQ, L.nc, L.BH);
  ssd_dx_kernel<P><<<tiles, NT, dx_smem, stream>>>(
      x, dt, Bm, y, dy, cum, cb, gstates, dx, xr, dcum, L);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_db_kernel<P><<<tiles, NT, w_smem, stream>>>(x, dt, Cm, cum, dyx,
                                                  gstates, dBp, L);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_dc_kernel<P><<<tiles, NT, w_smem, stream>>>(dt, Bm, dy, cum, dyx,
                                                  states, dCp, L);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // 10-11: ddt and da, then the head sums
  ssd_finish_kernel<<<L.BH, Q, 0, stream>>>(dt, a, xr, dcum, gstates, states,
                                            hfin, ddt, da, PN4, L);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int64_t elems = (int64_t)(L.BH / L.H) * L.S * L.N;
  ssd_headsum_kernel<<<(unsigned)((elems + 255) / 256), 256, 0, stream>>>(
      dBp, dCp, dB, dC, L);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launches (0 = launched); 1000 + k
// for an argument the kernels do not take (ssd_scan's checks).  h0 and
// dstate may be null (zero); dinit is written when it is not null.  The
// scratch, nc = ceil(S / Q): cum (BH, nc, Q), cb (BH / H, nc, Q, Q),
// states (BH, nc, P, N), hfin (BH, P, N), gstates (BH, nc, P, N), dyx
// (BH, nc, Q, Q), dBp and dCp (BH, S, N), dcum and xr (BH, nc, Q) floats.
int ssd_bwd(const float* x, const float* dt, const float* a, const float* Bm,
            const float* Cm, const float* h0, const float* y,
            const float* dy, const float* dstate, float* dx, float* ddt,
            float* da, float* dB, float* dC, float* dinit, float* cum,
            float* cb, float* states, float* hfin, float* gstates,
            float* dyx, float* dBp, float* dCp, float* dcum, float* xr,
            int BH, int H, int S, int P, int N, int chunk, int64_t xsb,
            int64_t xsh, int64_t xss, int64_t dsb, int64_t dsh, int64_t dss,
            int64_t bsb, int64_t bss, void* stream) {
  if (const int rc = ssd_refused(BH, H, S, P, N, chunk)) return rc;
  if (const int rc = ssd_refused_state(h0)) return rc;
  if (const int rc = ssd_refused_state(dstate)) return rc;
  if (const int rc = ssd_refused_state(dinit)) return rc;
  Layout L = ssd_layout(x, Bm, Cm, BH, H, S, N, xsb, xsh, xss, dsb, dsh, dss,
                        bsb, bss);
  // dy is staged like x: 16-byte copies only if both are aligned
  L.vec_x = L.vec_x && aligned16(dy);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (P) {
    case 16: return launch_bwd<16>(x, dt, a, Bm, Cm, h0, y, dy, dstate, dx,
                                   ddt, da, dB, dC, dinit, cum, cb, states,
                                   hfin, gstates, dyx, dBp, dCp, dcum, xr, L,
                                   s);
    case 32: return launch_bwd<32>(x, dt, a, Bm, Cm, h0, y, dy, dstate, dx,
                                   ddt, da, dB, dC, dinit, cum, cb, states,
                                   hfin, gstates, dyx, dBp, dCp, dcum, xr, L,
                                   s);
    default: return launch_bwd<64>(x, dt, a, Bm, Cm, h0, y, dy, dstate, dx,
                                   ddt, da, dB, dC, dinit, cum, cb, states,
                                   hfin, gstates, dyx, dBp, dCp, dcum, xr,
                                   L, s);
  }
}

}  // extern "C"
