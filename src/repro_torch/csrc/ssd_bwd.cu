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
// chunk_state_bwd_dx, chunk_scan_bwd_dcb -- the head-summed M below --
// and the ddA_cumsum passes); nothing of that code is used.  Per batch
// row b, head h and chunk c of Q = 256 rows, with cum^h the in-chunk
// inclusive cumsum of dt^h a^h, G_ts = C_t . B_s, E^h_ts = exp(cum^h_t -
// cum^h_s) for t >= s, D^h_ts = dy^h_t . x^h_s, h_{c-1} the state entering
// chunk c (h_{-1} = h0) and h_c the one leaving it, given dy and the
// final state's gradient (h dropped where the line is of one head):
//
//   gh_last = dstate; gh_{c-1} = exp(cum_last) gh_c + u_c,
//       u_c = sum_t exp(cum_t) dy_t C_t^T;  dinit = gh_{-1}
//   r_s  = sum_{t>=s} E_ts G_ts dy_t + exp(cum_last - cum_s) gh_c B_s
//   dx_s = dt_s r_s
//   M_ts = sum_h dt^h_s E^h_ts D^h_ts      (t >= s; one Q x Q a (b, c))
//   dB_s = sum_t M_ts C_t
//          + sum_(h,p) [dt^h_s exp(cum^h_last - cum^h_s) x^h_(s,p)] gh^h_c[p][:]
//   dC_t = sum_s M_ts B_s
//          + sum_(h,p) [exp(cum^h_t) dy^h_(t,p)] h^h_(c-1)[p][:]
//   dcum_t = dy_t . y_t - dt_t (x_t . r_t)   (+ <gh_c, h_c> at the last row)
//   ddt_s = x_s . r_s + a rev_s,  da = sum_s dt_s rev_s,
//       rev the in-chunk reverse cumsum of dcum
//
// dB and dC are sums over the heads of per-head products; B and C are
// shared by the heads of a batch row, so the head sum moves inside: into
// M for the triangles, and into the depth of one product over (h, p) for
// the state terms.  (Every term of y_t carries exp(cum_t), every term of
// r_s exp(-cum_s), and h_c = exp(cum_last) h_{c-1} + s_c: so dcum needs no
// product of its own.)  x . r is taken before the multiply by dt: nothing
// divides by dt, which is 0 on the ragged tail's padded rows.  The plain
// version, kernels/ssd/ref.py ssd_chunked_bwd_ref, computes the same
// passes.
//
// Nine launches a call, on the forward's machinery (ssd_common.cuh:
// cp.async ring of two, 3xTF32 mma.sync.m16n8k8 with the big / small
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
//   6.   ssd_dcb_kernel: M, a block a lower 64 x 64 tile (10 of 16), c
//        and b; it walks the heads in order, forms D^h's tile (k over P)
//        in registers and adds D^h o E^h o dt^h_s into M's tile, which
//        stays in shared memory (each thread's own 32 entries); the
//        diagonal tile is zero above the diagonal
//   7.   ssd_dx_kernel: r for 64 rows s a block, k over t >= s (G read
//        transposed, the tiles wholly below the rows skipped), then over
//        N for gh_c B_s; dx, and per row x . r and dcum (dy . y from the
//        forward's y)
//   8.   ssd_dbdc_kernel: a block a (64-row tile, c, b, dB or dC, 64
//        columns of N): k over M's triangle (read transposed for dB),
//        then over (h, p); written into dB and dC themselves
//   9.   ssd_finish_kernel: a block a bh walks its chunks in order:
//        <gh_c, h_c>, the reverse cumsum, ddt, and da summed chunk by
//        chunk
//
// Launches 6 and 8 lay their four warps out 2 x 2, 32 rows by 32 columns
// a warp (mma_step<2, 4>): each split element of a B tile feeds two
// 16-row strips and is split by two warps.  Their accumulators (32 floats
// a thread) stay in registers, and none spills; M's running sum in 6
// sits in shared memory, since with it in registers beside D^h the
// kernel needs 178 registers, two blocks an SM and two waves of the
// training shape's 320 blocks, and capped at three blocks an SM it
// spills.  No per-head Q x Q or S x N tensor goes to device memory.
// Each mma_step sums its products from zero before adding them to the
// running sum (ssd_common.cuh).
//
// Deterministic: no atomics.  The sums across heads (M in head order, by
// the thread that owns each entry; the (h, p) products in order) and
// across chunks (da, one block a bh) have one fixed order, and every
// block reduction is a fixed shuffle tree, so two calls on the same
// inputs give equal bits (an exact restart of training relies on it).
// exp(cum_t - cum_s) is taken only where t >= s (above the diagonal it
// may overflow, and inf * 0 would be a NaN); rows past S load x = dt = B
// = C = dy = 0 and store nothing.  A NaN or an infinity in the inputs
// reaches the outputs.
//
// Layout as ssd.cu's: x, y, dy and dx (b, h, s, p) with strides (xsb,
// xsh, xss, 1); dt and ddt (b, h, s) with (dsb, dsh, dss); B, C, dB, dC
// (b, s, n) with (bsb, bss, 1); a and da (BH,); h0, dstate and dinit
// (BH, P, N).  The wrapper allocates the scratch (ops.py bwd_scratch).
//
// Bound on an H100 SXM, at the mamba2-370m training shape (B 4, S 2048,
// H 32, P 64, N 128, float32): the function needs five state products
// per head -- s_c again (the states are not among its inputs), u_c, gh_c
// B, gh_c^T x and h^T dy, 5 BH S N P = 1.07e10 FMA, 21.5 GFLOP -- the
// lower triangles of C B^T and of M's two uses once per batch row (3 B S
// (Q + 1) / 2 N FMA), of D and G's use per head (BH S (Q + 1) / 2 2 P),
// the two state passes and the row dots; the least over every chunk
// length Q is at Q = 16: 22.97 GFLOP, 0.139 ms at the 3xTF32 rate (495 /
// 3 TFLOP/s) of the tensor cores these kernels use.  The bytes (x, y,
// dy, dx, dt, ddt, a, da, B, C, dB, dC: 287 MB) take 0.086 ms.  Bound by
// operations (chip_smoke.py ssd_bwd_flops counts both).  The kernels' own
// Q = 256 does 31.0 GFLOP (the triangles grow with Q).  The scratch is
// 91 MB a call: the forward's (cum, C B^T, the states, the final state),
// gh_c, M (B (S / Q) Q^2 4 bytes = 8.4 MB, small enough for L2), dcum
// and x . r.

#include "ssd_common.cuh"

namespace {

constexpr int T64 = TR * RS;            // a staged tile of launches 6, 8
static_assert(T64 == KT * KS, "a [k][64] tile fills a [64][k] one's room");
constexpr int RING2 = 4 * T64;          // two stages of an A and a B tile
constexpr int TAB = 3 * TR;             // launch 6: a head's table
constexpr int MAX_BWD_H = 512;          // heads launch 8's table holds

__device__ __forceinline__ float* tile2(float* ring, int st, int which) {
  return ring + (2 * st + which) * T64;
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

// stage() for a tile whose element (r, c) is at at(r, c): rows and
// columns past vrows and vcols are zero-filled; with vec, each group of
// four columns is contiguous and 16-byte aligned (so a group of (h, p)
// columns never crosses a head: P % 4 == 0).  at(0, 0) is a valid address.
template <int ROWS, int COLS, typename At>
__device__ __forceinline__ void stage_at(float* dst, int dld, At at,
                                         int vrows, int vcols, bool vec) {
  if (vec) {
    constexpr int CPR = COLS / 4;
    constexpr int ITEMS = ROWS * CPR;
#pragma unroll
    for (int it = 0; it < (ITEMS + NT - 1) / NT; ++it) {
      const int e = it * NT + (int)threadIdx.x;
      if (ITEMS % NT == 0 || e < ITEMS) {
        const int r = e / CPR, c = (e % CPR) * 4;
        const int n = r < vrows ? min(max(vcols - c, 0), 4) : 0;
        cp16(dst + r * dld + c, n ? at(r, c) : at(0, 0), 4 * n);
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
        cp4(dst + r * dld + c, ok ? at(r, c) : at(0, 0), ok ? 4 : 0);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 6. M = sum_h dt^h_s E^h_ts D^h_ts per (b, chunk), lower tiles only
// ---------------------------------------------------------------------------

// 3 blocks an SM (at most 168 registers, 54 KB of shared memory): the
// training shape's 320 blocks in one wave
template <int P>
__global__ void __launch_bounds__(NT, 3)
ssd_dcb_kernel(const float* __restrict__ dy, const float* __restrict__ x,
               const float* __restrict__ dt, const float* __restrict__ cum,
               float* __restrict__ mcb, Layout L) {
  constexpr int KP = (P + KT - 1) / KT;  // k tiles a head
  extern __shared__ __align__(16) float ring[];
  // two heads' tables (head h in h & 1): cum at the tile's rows t, cum
  // and dt at its columns s
  float* tab = ring + RING2;
  int idx = blockIdx.x, ti = 0;         // the lower tiles, row by row
  while (idx > ti) idx -= ++ti;
  const int tj = idx, c = blockIdx.y, b = blockIdx.z, H = L.H;
  const int vq = valid_rows(L.S, c);
  if (ti * TR >= vq) return;            // rows wholly past S: never read
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (warp >> 1) * 32, c0 = (warp & 1) * 32;
  const bool diag = ti == tj;
  const bool idle = diag && c0 > r0;    // wholly above the diagonal
  const int64_t t0 = (int64_t)c * Q;
  const int vr = vq - ti * TR, vc = vq - tj * TR;
  float d[2][4][4] = {};
  float* sm = tab + 2 * TAB + threadIdx.x;   // M's entries, [entry][thread]
#pragma unroll
  for (int e = 0; e < 32; ++e) sm[e * NT] = 0.f;
  // A = dy [t][p], B(k = p, column s) = x [s][p], a head at a time
  pipeline(
      H * KP,
      [&](int kt, int st) {
        const int h = kt / KP, p0 = (kt % KP) * KT;
        const int64_t xo = b * L.xsb + h * L.xsh + t0 * L.xss + p0;
        stage<TR, KT>(tile2(ring, st, 0), RS, dy + xo + ti * TR * L.xss,
                      L.xss, vr, P - p0, L.vec_x);
        stage<TR, KT>(tile2(ring, st, 1), RS, x + xo + tj * TR * L.xss,
                      L.xss, vc, P - p0, L.vec_x);
        if (p0 == 0) {
          float* tb = tab + (h & 1) * TAB;
          const float* cumc = cum + ((int64_t)(b * H + h) * L.nc + c) * Q;
          const float* dtb = dt + b * L.dsb + h * L.dsh + t0 * L.dss;
          for (int k = threadIdx.x; k < TAB; k += NT) {
            const int part = k / TR, r = k % TR;
            if (part == 0) cp4(tb + k, cumc + ti * TR + r, 4);
            else if (part == 1) cp4(tb + k, cumc + tj * TR + r, 4);
            else cp4(tb + k, dtb + (r < vc ? (tj * TR + r) * L.dss : 0),
                     r < vc ? 4 : 0);
          }
        }
      },
      [&](int kt, int st) {
        if (idle) return;
        const float* a = tile2(ring, st, 0);
        const float* bt = tile2(ring, st, 1) + c0 * RS;
#pragma unroll
        for (int k0 = 0; k0 < KT; k0 += 8) {
          if (k0 >= P) break;
          float av[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              av[mt][q] = a[(r0 + 16 * mt + g + 8 * (q & 1)) * RS + k0 + t +
                            4 * (q >> 1)];
          mma_step<2, 4, 1, RS>(d, av, bt, k0, lane, 4);
        }
        if (kt % KP != KP - 1) return;
        // D^h is whole: M += D^h o E^h o dt^h_s where t >= s, in head order
        const float* tb = tab + ((kt / KP) & 1) * TAB;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int row = r0 + 16 * mt + g + 8 * (q >> 1);
              const int col = c0 + nt * 8 + 2 * t + (q & 1);
              if (!diag || col <= row)
                sm[((mt * 4 + nt) * 4 + q) * NT] +=
                    d[mt][nt][q] *
                    (expf(tb[row] - tb[TR + col]) * tb[2 * TR + col]);
              d[mt][nt][q] = 0.f;
            }
      });
  float* M = mcb + (((int64_t)b * L.nc + c) * Q + ti * TR) * Q + tj * TR;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = r0 + 16 * mt + g + 8 * hf, col = c0 + nt * 8 + 2 * t;
        *reinterpret_cast<float2*>(M + row * Q + col) =
            make_float2(sm[((mt * 4 + nt) * 4 + 2 * hf) * NT],
                        sm[((mt * 4 + nt) * 4 + 2 * hf + 1) * NT]);
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
// 8. dB = M^T C + (x o w_B) gh and dC = M B + (dy o w_C) h_{c-1}, k over
//    (h, p) in the second product: w_B^h_s = dt^h_s exp(cum^h_last -
//    cum^h_s), w_C^h_t = exp(cum^h_t)
// ---------------------------------------------------------------------------

template <int P>
__global__ void __launch_bounds__(NT)
ssd_dbdc_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ Bm, const float* __restrict__ Cm,
                const float* __restrict__ dy, const float* __restrict__ cum,
                const float* __restrict__ mcb,
                const float* __restrict__ gstates,
                const float* __restrict__ states, float* __restrict__ dB,
                float* __restrict__ dC, Layout L) {
  extern __shared__ __align__(16) float ring[];
  float* sw = ring + RING2;             // w^h at the block's rows, [h][row]
  const int NH = (L.N + TR - 1) / TR;   // 64-column parts of N
  const int ti = blockIdx.x % TQ, part = blockIdx.x / TQ;
  const bool dc = part >= NH;           // uniform over the block
  const int n0 = (part % NH) * TR, c = blockIdx.y, b = blockIdx.z;
  const int i0 = ti * TR, H = L.H, N = L.N, HP = H * P;
  const int vq = valid_rows(L.S, c);
  if (i0 >= vq) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (warp >> 1) * 32, c0 = (warp & 1) * 32;
  const int nt_end = min(max((N - n0 - c0 + 7) / 8, 0), 4);
  const int64_t t0 = (int64_t)c * Q;
  for (int e = threadIdx.x; e < H * TR; e += NT) {
    const int h = e / TR, r = e % TR;
    const float* cumc = cum + ((int64_t)(b * H + h) * L.nc + c) * Q;
    float w = 0.f;
    if (i0 + r < vq)
      w = dc ? expf(cumc[i0 + r])
             : dt[b * L.dsb + h * L.dsh + (t0 + i0 + r) * L.dss] *
                   expf(cumc[Q - 1] - cumc[i0 + r]);
    sw[e] = w;
  }
  // the triangle: dB k over t from the block's first row to vq, dC k over
  // s below the block's last row
  const int kt0 = dc ? 0 : i0 / KT;
  const int n1 = dc ? (min(i0 + TR, vq) + KT - 1) / KT
                    : (vq + KT - 1) / KT - kt0;
  const int n2 = (HP + KT - 1) / KT;
  const float* M = mcb + ((int64_t)b * L.nc + c) * Q * Q;   // M [t][s]
  const float* BCb = (dc ? Bm : Cm) + b * L.bsb + t0 * L.bss + n0;
  const float* xb = (dc ? dy : x) + b * L.xsb + (t0 + i0) * L.xss;
  const int64_t hs = (int64_t)L.nc * P * N;          // head stride of gh, h
  const float* hb = (dc ? states : gstates) + (int64_t)b * H * hs +
                    (int64_t)c * P * N + n0;
  const bool vec_h = N % 4 == 0;
  float acc[2][4][4] = {};
  // tiles kt < n1: dB A(s, t) = M [t][s] from M stored [k = t][row = s],
  // dC A(t, s) = M [t][s]; B = C or B [k][n]; then A = x or dy [row][(h,
  // p)] times w^h at the row, B = gh or h [(h, p)][n]
  pipeline(
      n1 + n2,
      [&](int kt, int st) {
        float* ta = tile2(ring, st, 0);
        float* tb = tile2(ring, st, 1);
        if (kt < n1) {
          const int j = (kt0 + kt) * KT;
          if (dc)
            stage<TR, KT>(ta, RS, M + (int64_t)i0 * Q + j, Q, TR, KT, true);
          else
            stage<KT, TR>(ta, KS, M + (int64_t)j * Q + i0, Q, vq - j, TR,
                          true);
          stage<KT, TR>(tb, KS, BCb + j * L.bss, L.bss, vq - j, N - n0,
                        L.vec_bc);
        } else {
          const int k0 = (kt - n1) * KT;
          stage_at<TR, KT>(
              ta, RS,
              [&](int r, int k) {
                const int hp = k0 + k;
                return xb + r * L.xss + (hp / P) * L.xsh + hp % P;
              },
              vq - i0, HP - k0, L.vec_x);
          stage_at<KT, TR>(
              tb, KS,
              [&](int r, int n) {
                const int hp = k0 + r;
                return hb + (hp / P) * hs + (hp % P) * N + n;
              },
              HP - k0, N - n0, vec_h);
        }
      },
      [&](int kt, int st) {
        if (nt_end == 0) return;
        const float* a = tile2(ring, st, 0);
        const float* bt = tile2(ring, st, 1) + c0;
        if (kt < n1) {
#pragma unroll
          for (int k0 = 0; k0 < KT; k0 += 8) {
            const int j0 = (kt0 + kt) * KT + k0;
            // M is zero where t < s: skip the steps wholly there
            if (dc ? j0 > i0 + r0 + 31 : j0 + 7 < i0 + r0) continue;
            float av[2][4];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const int row = r0 + 16 * mt + g + 8 * (q & 1);
                const int kk = k0 + t + 4 * (q >> 1);
                av[mt][q] = dc ? a[row * RS + kk] : a[kk * KS + row];
              }
            mma_step<2, 4, KS, 1>(acc, av, bt, k0, lane, nt_end);
          }
        } else {
#pragma unroll
          for (int k0 = 0; k0 < KT; k0 += 8) {
            const int hp = (kt - n1) * KT + k0;
            if (hp >= HP) break;                // past the last head
            const float* w = sw + hp / P * TR;
            float av[2][4];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const int row = r0 + 16 * mt + g + 8 * (q & 1);
                av[mt][q] = a[row * RS + k0 + t + 4 * (q >> 1)] * w[row];
              }
            mma_step<2, 4, KS, 1>(acc, av, bt, k0, lane, nt_end);
          }
        }
      });
  float* out = (dc ? dC : dB) + b * L.bsb + (t0 + i0) * L.bss;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = r0 + 16 * mt + g + 8 * hf;
        const int n = n0 + c0 + nt * 8 + 2 * t;
        if (i0 + row < vq) {
          if (n < N) out[row * L.bss + n] = acc[mt][nt][2 * hf];
          if (n + 1 < N) out[row * L.bss + n + 1] = acc[mt][nt][2 * hf + 1];
        }
      }
}

// ---------------------------------------------------------------------------
// 9. ddt and da: a block of Q threads a bh, its chunks in order
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

template <int P>
int launch_bwd(const float* x, const float* dt, const float* a,
               const float* Bm, const float* Cm, const float* h0,
               const float* y, const float* dy, const float* dstate,
               float* dx, float* ddt, float* da, float* dB, float* dC,
               float* dinit, float* cum, float* cb, float* states,
               float* hfin, float* gstates, float* mcb, float* dcum,
               float* xr, const Layout& L, cudaStream_t stream) {
  constexpr size_t state_smem = sizeof(float) * (RING + Q + NW);
  constexpr size_t dcb_smem = sizeof(float) * (RING2 + 2 * TAB + 32 * NT);
  constexpr size_t dx_smem = sizeof(float) * (RING + 2 * Q);
  const size_t dbdc_smem = sizeof(float) * (RING2 + L.H * TR);
  constexpr auto attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(ssd_state_kernel<P, true>, attr,
                                  (int)state_smem)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(ssd_dcb_kernel<P>, attr,
                                  (int)dcb_smem)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(ssd_dx_kernel<P>, attr, (int)dx_smem)) !=
          cudaSuccess ||
      (err = cudaFuncSetAttribute(ssd_dbdc_kernel<P>, attr,
                                  (int)dbdc_smem)) != cudaSuccess)
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
  // 6-8: M, then dx, then dB and dC
  const int rows = L.BH / L.H;
  ssd_dcb_kernel<P><<<dim3(TQ * (TQ + 1) / 2, L.nc, rows), NT, dcb_smem,
                      stream>>>(dy, x, dt, cum, mcb, L);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_dx_kernel<P><<<dim3(TQ, L.nc, L.BH), NT, dx_smem, stream>>>(
      x, dt, Bm, y, dy, cum, cb, gstates, dx, xr, dcum, L);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_dbdc_kernel<P><<<dim3(TQ * 2 * ((L.N + TR - 1) / TR), L.nc, rows), NT,
                       dbdc_smem, stream>>>(x, dt, Bm, Cm, dy, cum, mcb,
                                            gstates, states, dB, dC, L);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // 9: ddt and da
  ssd_finish_kernel<<<L.BH, Q, 0, stream>>>(dt, a, xr, dcum, gstates, states,
                                            hfin, ddt, da, PN4, L);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launches (0 = launched); 1000 + k
// for an argument the kernels do not take (ssd_scan's checks, and 1008:
// more than MAX_BWD_H heads).  h0 and dstate may be null (zero); dinit is
// written when it is not null.  The scratch, nc = ceil(S / Q): cum (BH,
// nc, Q), cb (BH / H, nc, Q, Q), states (BH, nc, P, N), hfin (BH, P, N),
// gstates (BH, nc, P, N), mcb (BH / H, nc, Q, Q), dcum and xr (BH, nc, Q)
// floats.
int ssd_bwd(const float* x, const float* dt, const float* a, const float* Bm,
            const float* Cm, const float* h0, const float* y,
            const float* dy, const float* dstate, float* dx, float* ddt,
            float* da, float* dB, float* dC, float* dinit, float* cum,
            float* cb, float* states, float* hfin, float* gstates,
            float* mcb, float* dcum, float* xr, int BH, int H, int S, int P,
            int N, int chunk, int64_t xsb, int64_t xsh, int64_t xss,
            int64_t dsb, int64_t dsh, int64_t dss, int64_t bsb, int64_t bss,
            void* stream) {
  if (const int rc = ssd_refused(BH, H, S, P, N, chunk)) return rc;
  if (H > MAX_BWD_H) return 1008;
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
                                   hfin, gstates, mcb, dcum, xr, L, s);
    case 32: return launch_bwd<32>(x, dt, a, Bm, Cm, h0, y, dy, dstate, dx,
                                   ddt, da, dB, dC, dinit, cum, cb, states,
                                   hfin, gstates, mcb, dcum, xr, L, s);
    default: return launch_bwd<64>(x, dt, a, Bm, Cm, h0, y, dy, dstate, dx,
                                   ddt, da, dB, dC, dinit, cum, cb, states,
                                   hfin, gstates, mcb, dcum, xr, L, s);
  }
}

}  // extern "C"
