// Mamba2 chunked SSD scan for Hopper (sm_90a), bound through a plain C
// interface and loaded with ctypes (repro_torch/kernels/build.py).
//
//   ssd_scan  <- ssd / _kernel of src/repro/kernels/ssd/ssd.py:74
//
// For each (batch row, head) bh the selective-state recurrence
//   h_t = exp(dt_t a) h_{t-1} + dt_t x_t B_t^T   (P x N),   y_t = h_t C_t
// from a zero state or a given one, h0 (the model's prefill from a
// carried state); the final state is emitted.  The TPU kernel's grid
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
//                         order from h_{-1} = h0 (or zero), elementwise
//                         over bh x P x N (float4
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
// The constants, the staging ring, the 3xTF32 step and kernels 1-3 live
// in ssd_common.cuh, shared with the backward (ssd_bwd.cu), which runs
// kernels 1-3 again.
//
// Layout: x and y are (b, h, s, p) with strides (xsb, xsh, xss, 1) and dt
// (b, h, s) with (dsb, dsh, dss), bh = b * H + h; B and C are (b, s, n)
// with (bsb, bss, 1), shared by the H heads of a batch row.  The Pallas
// signature (per-head B and C, (BH, S, P) x) is H = 1; the Mamba2 model
// passes its (batch, S, heads, P) activations and its (batch, S, N) B and
// C as they are, with no broadcast copy across heads.  a is (BH,), h0 and
// the final state (BH, P, N).  The
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

#include "ssd_common.cuh"

namespace {

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
                bool vec_x, bool vec_bc, bool has_h0) {
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
  // the carried state's part; none in chunk 0 from a zero state
  const int ks = c > 0 || has_h0 ? (N + KT - 1) / KT : 0;
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

template <int P>
int launch(const float* x, const float* dt, const float* a, const float* Bm,
           const float* Cm, const float* h0, float* y, float* st, float* cum,
           float* cb, float* states, const Layout& L, cudaStream_t stream) {
  constexpr size_t scan_smem = sizeof(float) * (RING + 2 * Q);
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(ssd_scan_kernel<P>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)scan_smem)) != cudaSuccess)
    return (int)err;
  const int rc = launch_states<P>(x, dt, a, Bm, Cm, h0, st, cum, cb, states,
                                  L, stream);
  if (rc != 0) return rc;
  ssd_scan_kernel<P><<<dim3(TQ, L.nc, L.BH), NT, scan_smem, stream>>>(
      x, dt, Cm, cum, cb, states, y, L.H, L.S, L.N, L.nc, L.xsb, L.xsh,
      L.xss, L.dsb, L.dsh, L.dss, L.bsb, L.bss, L.vec_x, L.vec_bc,
      h0 != nullptr);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launches (0 = launched); 1000 + k
// for an argument the kernels do not take.  h0 is the initial state
// (BH, P, N), or null for zero.  cum, cb and states are the caller's
// scratch: (BH, nc, Q), (BH / H, nc, Q, Q) and (BH, nc, P, N) floats, nc =
// ceil(S / Q); chunk must be Q.
int ssd_scan(const float* x, const float* dt, const float* a, const float* Bm,
             const float* Cm, const float* h0, float* y, float* state,
             float* cum, float* cb, float* states, int BH, int H, int S,
             int P, int N, int chunk, int64_t xsb, int64_t xsh, int64_t xss,
             int64_t dsb, int64_t dsh, int64_t dss, int64_t bsb, int64_t bss,
             void* stream) {
  if (const int rc = ssd_refused(BH, H, S, P, N, chunk)) return rc;
  if (const int rc = ssd_refused_state(h0)) return rc;
  const Layout L = ssd_layout(x, Bm, Cm, BH, H, S, N, xsb, xsh, xss, dsb,
                              dsh, dss, bsb, bss);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (P) {
    case 16: return launch<16>(x, dt, a, Bm, Cm, h0, y, state, cum, cb,
                               states, L, s);
    case 32: return launch<32>(x, dt, a, Bm, Cm, h0, y, state, cum, cb,
                               states, L, s);
    default: return launch<64>(x, dt, a, Bm, Cm, h0, y, state, cum, cb,
                               states, L, s);
  }
}

}  // extern "C"
