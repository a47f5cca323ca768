// Batched Montgomery multiplication for Hopper (sm_90a), bound through a
// plain C interface and loaded with ctypes (repro_torch/kernels/build.py).
//
//   mm_mont_mul  <- mont_mul / _kernel / _mont_mul_block of
//                   src/repro/kernels/modmul/modmul.py:95
//   mm_mont_exp  <- the square-and-multiply ladder of
//                   src/repro/kernels/modmul/ops.py:23 (mont_exp_op, a
//                   fori_loop over the Pallas mont_mul of modmul.py:95)
//
// Both rest on one Montgomery product, out = a * b * R^-1 mod n for
// operands of L 16-bit limbs held in uint32, R = 2^(16 L), every operand
// below n.  The TPU kernel vectorises the reference's lazy-carry CIOS
// over a (128-row, L) VMEM block, one multiplication per lane.
//
// The product (mont_product) takes one warp per row, no __syncthreads.
// Inside it the digits are 32 bits wide (s = L / 2 digits, products by
// IMAD and IMAD.HI) when L is even: R = 2^(16 L) = 2^(32 s) is then the
// same number, and since every operand is below n each product is the
// canonical residue, so the result equals the 16-bit plain version bit
// for bit.  An odd L runs the same code on 16-bit digits.  The 16-bit
// limbs of crypto/limb.py are the interface: the kernels pack them on
// entry and unpack on exit.  Lane l holds digits l W .. l W + W - 1 (W =
// 1..32, the least power of two with 32 W >= s) as 64-bit lazy slots; b
// and n stay in registers, a's digits go through shared memory, read one
// a step by every lane (a broadcast).  A CIOS step: lane 0's slot 0 gives
// m, which one shuffle spreads; every digit j adds lo(a_i b_j) + lo(m n_j)
// to its slot and hands hi(a_i b_j) + hi(m n_j) to slot j + 1, and the
// one-digit shift is one 64-bit shuffle between neighbouring lanes.  The
// tail is a carry-lookahead, not a serial pass: each slot's excess over
// its digit moves one place up, leaving carries of one bit; each lane
// folds its W digits into a generate and a propagate bit, two
// __ballot_sync make 32-bit masks, and ((G | P) + G) ^ P gives every
// lane's carry-in at once; the conditional subtract resolves its borrows
// the same way.  The rule is the reference's: subtract when the
// difference does not borrow or the digits at and above position s (the
// reference's slot L) are not all zero.
//
// mm_mont_mul is one call of the product a row.  It takes every L of
// 1..1022: W up to 16 serves even L up to 1022 and odd L up to 511, and
// W = 32, for odd L up to 1021, is instantiated for it alone.  It keeps
// the plain version's n0inv = -n^-1 mod 2^16 and, for 32-bit digits,
// lifts it to mod 2^32 by one Newton step from n's low digit.  Bound on
// an H100 SXM: per row s (10 s + 5) + 12 s 32-bit instructions (per digit
// and step two low and two high products and the 64-bit adds of the
// slots; m and the fold; the tail), 42k at L = 128; at the ~58 rows of a
// threshold decryption 2.4e6, 0.15 us at the 16.7 T/s int32 rate; the
// bytes (3 x 4 B x L per row) are smaller still.  At the path's shape it
// is bound by its chain of s dependent steps (a shared load, two
// shuffles and a multiply chain each) and by the launch.
//
// mm_mont_exp is the whole ladder in one launch: acc = one_mont; for
// every exponent bit, sq = acc * acc, mul = sq * base, acc = bit ? mul :
// sq, all in the Montgomery domain, the base and n in registers for all
// the bits.  The exponents of a threshold decryption are 2 Delta s_i, s_i
// a key share, so they are secret: every bit squares, multiplies and
// selects by a mask, with no branch and the same memory accesses whatever
// the bit, so the kernel's time does not depend on the exponent's bits
// (only on its length, which is public).  It takes even L up to 1022 and
// odd L up to 511.  The exit multiply by plain 1 is a launch of
// mm_mont_mul (ops.modexp_ints), so a decryption makes one mm_mont_exp
// and one mm_mont_mul launch.  Bound: 2 nbits products a row; at the
// decryption's 58 rows x 128 limbs x 2,372 bits that is 1.2e10
// instructions, 0.69 ms at the int32 rate.  The ladder is a chain of 2
// nbits s dependent steps, so it is bound by latency, ~58 of 132 SMs
// each holding one warp.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t LIMB_MASK = 0xFFFFu;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int MAX_LIMBS = 1022;           // 16-bit limbs, even L
constexpr int MAX_EXP_LIMBS_ODD = 511;    // odd L in the ladder: W <= 16
constexpr int MAX_MUL_LIMBS_ODD = 1021;   // odd L in mm_mont_mul: W = 32

template <int DB> struct Digit;
template <> struct Digit<32> {
  static constexpr uint32_t MASK = 0xFFFFFFFFu;
  __device__ static uint32_t lo(uint32_t x, uint32_t y) { return x * y; }
  __device__ static uint32_t hi(uint32_t x, uint32_t y) {
    return __umulhi(x, y);
  }
};
template <> struct Digit<16> {
  static constexpr uint32_t MASK = 0xFFFFu;
  __device__ static uint32_t lo(uint32_t x, uint32_t y) {
    return (x * y) & MASK;
  }
  __device__ static uint32_t hi(uint32_t x, uint32_t y) {
    return (x * y) >> 16;
  }
};

// digit j of a number given as 16-bit limbs (zero at and past s digits)
template <int DB>
__device__ __forceinline__ uint32_t load_digit(const uint32_t* limbs, int j,
                                               int s) {
  if (j >= s) return 0u;
  if (DB == 16) return limbs[j];
  return limbs[2 * j] | (limbs[2 * j + 1] << 16);
}

// Carry-in of every lane from its group generate / propagate bits (the
// lane's W digits together): bit l of ((G | P) + G) ^ P.
__device__ __forceinline__ uint32_t lane_carry_in(uint32_t g, uint32_t p,
                                                  int lane) {
  const uint32_t G = __ballot_sync(FULL, g), P = __ballot_sync(FULL, p);
  return ((((G | P) + G) ^ P) >> lane) & 1u;
}

// out = a * b * R^-1 mod n: a's s digits in shared memory, b and n in
// registers (lane l: digits l W + w); every operand below n.
template <int DB, int W>
__device__ __forceinline__ void mont_product(const uint32_t* sa,
                                             const uint32_t (&b)[W],
                                             const uint32_t (&n)[W],
                                             uint32_t n0inv, int s, int lane,
                                             uint32_t (&out)[W]) {
  using D = Digit<DB>;
  constexpr uint32_t MASK = D::MASK;
  uint64_t T[W];
#pragma unroll
  for (int w = 0; w < W; ++w) T[w] = 0;
  for (int i = 0; i < s; ++i) {
    const uint32_t ai = sa[i];
    // m from slot 0 (lane 0): every lane computes it, lane 0's is taken
    const uint32_t m = __shfl_sync(
        FULL, (((uint32_t)T[0] + D::lo(ai, b[0])) * n0inv) & MASK, 0);
    uint64_t X[W], H[W];
#pragma unroll
    for (int w = 0; w < W; ++w) {
      X[w] = T[w] + D::lo(ai, b[w]) + D::lo(m, n[w]);
      H[w] = (uint64_t)D::hi(ai, b[w]) + D::hi(m, n[w]);
    }
    // shift one digit down: slot j takes X_{j+1} + H_j; slot 0's low
    // digit is zero by the choice of m, its excess folds into the new 0
    uint64_t up = __shfl_down_sync(FULL, (unsigned long long)X[0], 1);
    if (lane == 31) up = 0;
    const uint64_t fold = lane == 0 ? X[0] >> DB : 0;
#pragma unroll
    for (int w = 0; w + 1 < W; ++w) T[w] = X[w + 1] + H[w];
    T[W - 1] = up + H[W - 1];
    T[0] += fold;
  }

  // 1. each slot keeps its digit; its excess (< 2^12) moves one place up
  uint32_t x[W], g[W], p[W];
  uint32_t from_below =
      __shfl_up_sync(FULL, (uint32_t)(T[W - 1] >> DB), 1);
  if (lane == 0) from_below = 0;
  uint32_t c[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const uint64_t t = (T[w] & MASK) +
        (w == 0 ? from_below : (uint32_t)(T[w - 1] >> DB));
    x[w] = (uint32_t)(t & MASK);
    c[w] = (uint32_t)(t >> DB);              // 0 or 1
  }
  // 2. add those one-bit carries one place up; a digit that overflows
  // generates, an all-ones digit propagates
  uint32_t cin0 = __shfl_up_sync(FULL, c[W - 1], 1);
  if (lane == 0) cin0 = 0;
  uint32_t gl = 0, pl = 1;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const uint32_t cin = w == 0 ? cin0 : c[w - 1];
    g[w] = cin & (x[w] == MASK ? 1u : 0u);
    x[w] = (x[w] + cin) & MASK;
    p[w] = x[w] == MASK ? 1u : 0u;
    gl = g[w] | (p[w] & gl);
    pl &= p[w];
  }
  uint32_t carry = lane_carry_in(gl, pl, lane);
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const uint32_t co = g[w] | (p[w] & carry);
    x[w] = (x[w] + carry) & MASK;
    carry = co;
  }
  // the digits at and above s: lane 31's carry out and excess are the
  // digit past the last lane
  bool high = lane == 31 &&
              ((T[W - 1] >> DB) + c[W - 1] + carry) != 0;
#pragma unroll
  for (int w = 0; w < W; ++w)
    high = high || (lane * W + w >= s && x[w] != 0);
  const bool over = __any_sync(FULL, high);

  // 3. d = x - n, borrows by the same lookahead
  uint32_t d[W];
  gl = 0;
  pl = 1;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    g[w] = x[w] < n[w] ? 1u : 0u;
    p[w] = x[w] == n[w] ? 1u : 0u;
    gl = g[w] | (p[w] & gl);
    pl &= p[w];
  }
  uint32_t borrow = lane_carry_in(gl, pl, lane);
  uint32_t borrow_top = 0;             // out of digit s - 1
#pragma unroll
  for (int w = 0; w < W; ++w) {
    d[w] = (x[w] - n[w] - borrow) & MASK;
    borrow = g[w] | (p[w] & borrow);
    if (lane * W + w == s - 1) borrow_top = borrow;
  }
  borrow_top = __shfl_sync(FULL, borrow_top, (s - 1) / W);
  const bool ge_n = borrow_top == 0 || over;
#pragma unroll
  for (int w = 0; w < W; ++w) out[w] = ge_n ? d[w] : x[w];
}

// the lane's digits back to 16-bit limbs (digits at and past s dropped)
template <int DB, int W>
__device__ __forceinline__ void store_digits(uint32_t* limbs,
                                             const uint32_t (&v)[W], int s,
                                             int lane) {
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const int j = lane * W + w;
    if (j >= s) continue;
    if (DB == 16) {
      limbs[j] = v[w];
    } else {
      limbs[2 * j] = v[w] & LIMB_MASK;
      limbs[2 * j + 1] = v[w] >> 16;
    }
  }
}

template <int DB, int W>
__device__ __forceinline__ void to_shared(uint32_t* sa,
                                          const uint32_t (&v)[W], int lane) {
  __syncwarp();                       // the last product's reads are done
#pragma unroll
  for (int w = 0; w < W; ++w) sa[lane * W + w] = v[w];
  __syncwarp();
}

template <int DB, int W>
__global__ void __launch_bounds__(32)
mont_exp_kernel(const uint32_t* __restrict__ base,
                const int32_t* __restrict__ bits,
                const uint32_t* __restrict__ nl, uint32_t n0inv,
                const uint32_t* __restrict__ one, uint32_t* __restrict__ out,
                int L, int nbits) {
  __shared__ uint32_t sa[32 * W];
  const int lane = threadIdx.x;
  const int64_t row = blockIdx.x;
  const int s = DB == 32 ? L / 2 : L;
  uint32_t bv[W], nv[W], acc[W], sq[W], mul[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const int j = lane * W + w;
    bv[w] = load_digit<DB>(base + row * L, j, s);
    nv[w] = load_digit<DB>(nl, j, s);
    acc[w] = load_digit<DB>(one, j, s);
  }
  const int32_t* rbits = bits + row * nbits;
  for (int i = 0; i < nbits; ++i) {
    const uint32_t take = 0u - (uint32_t)(rbits[i] != 0);   // all ones or 0
    to_shared<DB, W>(sa, acc, lane);
    mont_product<DB, W>(sa, acc, nv, n0inv, s, lane, sq);
    to_shared<DB, W>(sa, sq, lane);
    mont_product<DB, W>(sa, bv, nv, n0inv, s, lane, mul);
#pragma unroll
    for (int w = 0; w < W; ++w) acc[w] = (mul[w] & take) | (sq[w] & ~take);
  }
  store_digits<DB, W>(out + row * L, acc, s, lane);
}

template <int DB>
int launch_exp(const uint32_t* base, const int32_t* bits, const uint32_t* n,
               uint32_t n0inv, const uint32_t* one, uint32_t* out,
               int64_t batch, int L, int nbits, cudaStream_t stream) {
  const int s = DB == 32 ? L / 2 : L;
  const int lanes_w = (s + 31) / 32;
  const dim3 grid((unsigned)batch);
#define MM_EXP_CASE(WW)                                                    \
  if (lanes_w <= WW) {                                                     \
    mont_exp_kernel<DB, WW><<<grid, 32, 0, stream>>>(base, bits, n, n0inv, \
                                                     one, out, L, nbits); \
    return (int)cudaGetLastError();                                        \
  }
  MM_EXP_CASE(1)
  MM_EXP_CASE(2)
  MM_EXP_CASE(4)
  MM_EXP_CASE(8)
  MM_EXP_CASE(16)
#undef MM_EXP_CASE
  return 1001;
}

template <int DB, int W>
__global__ void __launch_bounds__(32)
mont_mul_kernel(const uint32_t* __restrict__ a,
                const uint32_t* __restrict__ b,
                const uint32_t* __restrict__ nl, uint32_t n0inv,
                uint32_t* __restrict__ out, int L) {
  __shared__ uint32_t sa[32 * W];
  const int lane = threadIdx.x;
  const int64_t row = blockIdx.x;
  const int s = DB == 32 ? L / 2 : L;
  uint32_t av[W], bv[W], nv[W], res[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const int j = lane * W + w;
    av[w] = load_digit<DB>(a + row * L, j, s);
    bv[w] = load_digit<DB>(b + row * L, j, s);
    nv[w] = load_digit<DB>(nl, j, s);
  }
  if (DB == 32) {
    // the caller's n0inv is -n^-1 mod 2^16; one Newton step lifts it to
    // -n^-1 mod 2^32: n x = -1 + k 2^16 gives n x (2 + n x) = -1 mod 2^32
    n0inv *= 2u + __shfl_sync(FULL, nv[0], 0) * n0inv;
  }
  to_shared<DB, W>(sa, av, lane);
  mont_product<DB, W>(sa, bv, nv, n0inv, s, lane, res);
  store_digits<DB, W>(out + row * L, res, s, lane);
}

template <int DB>
int launch_mul(const uint32_t* a, const uint32_t* b, const uint32_t* n,
               uint32_t n0inv, uint32_t* out, int64_t batch, int L,
               cudaStream_t stream) {
  const int s = DB == 32 ? L / 2 : L;
  const int lanes_w = (s + 31) / 32;
  const dim3 grid((unsigned)batch);
#define MM_MUL_CASE(WW)                                                    \
  if (lanes_w <= WW) {                                                     \
    mont_mul_kernel<DB, WW><<<grid, 32, 0, stream>>>(a, b, n, n0inv, out, \
                                                     L);                  \
    return (int)cudaGetLastError();                                        \
  }
  MM_MUL_CASE(1)
  MM_MUL_CASE(2)
  MM_MUL_CASE(4)
  MM_MUL_CASE(8)
  MM_MUL_CASE(16)
  if constexpr (DB == 16) {
    MM_MUL_CASE(32)
  }
#undef MM_MUL_CASE
  return 1001;
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched); 1000 + k for
// an argument the kernel does not take.  n0inv is the limbs' -n^-1 mod
// 2^16, as the plain version takes it, for every L.
int mm_mont_mul(const uint32_t* a, const uint32_t* b, const uint32_t* n,
                uint32_t n0inv, uint32_t* out, int64_t batch, int L,
                void* stream) {
  const bool odd = L % 2 != 0;
  if (L < 1 || L > (odd ? MAX_MUL_LIMBS_ODD : MAX_LIMBS)) return 1001;
  if (n0inv > LIMB_MASK) return 1002;
  if (batch < 0 || batch > 0x7FFFFFFF) return 1003;
  if (batch == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  return odd ? launch_mul<16>(a, b, n, n0inv, out, batch, L, s)
             : launch_mul<32>(a, b, n, n0inv, out, batch, L, s);
}

// The ladder: out = one * base^e (Montgomery domain) for each row, e's
// bits MSB first in bits (batch, nbits) int32.  n0inv is -n^-1 mod 2^32
// for an even L (32-bit digits) and mod 2^16 for an odd L.  Same status
// convention as mm_mont_mul.
int mm_mont_exp(const uint32_t* base, const int32_t* bits, const uint32_t* n,
                uint32_t n0inv, const uint32_t* one, uint32_t* out,
                int64_t batch, int L, int nbits, void* stream) {
  const bool odd = L % 2 != 0;
  if (L < 1 || L > (odd ? MAX_EXP_LIMBS_ODD : MAX_LIMBS)) return 1001;
  if (odd && n0inv > LIMB_MASK) return 1002;
  if (batch < 0 || batch > 0x7FFFFFFF) return 1003;
  if (nbits < 0) return 1004;
  if (batch == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  return odd ? launch_exp<16>(base, bits, n, n0inv, one, out, batch, L,
                              nbits, s)
             : launch_exp<32>(base, bits, n, n0inv, one, out, batch, L,
                              nbits, s);
}

}  // extern "C"
