// Batched Montgomery multiplication for Hopper (sm_90a), bound through a
// plain C interface and loaded with ctypes (repro_torch/kernels/build.py).
//
//   mm_mont_mul  <- mont_mul / _kernel / _mont_mul_block of
//                   src/repro/kernels/modmul/modmul.py:95
//
// out = a * b * R^-1 mod n for each row of (batch, L) operands of 16-bit
// limbs held in uint32, R = 2^(16 L): the lazy-carry CIOS of the reference,
// bit for bit.  The TPU kernel vectorises over a (128-row, L) VMEM block,
// one multiplication per lane.  Here one thread block takes one row and
// one thread takes one of the L + 2 slots of the accumulator T, kept in a
// register.  At outer step i thread j adds lo(a_i b_j) + hi(a_i b_{j-1}),
// so it is the only writer of its slot: no races and no atomics.  Slot 0
// gives m = (T_0 & 0xffff) * n0inv & 0xffff to every thread through shared
// memory; thread j adds lo(m n_j) + hi(m n_{j-1}); the one-limb shift goes
// through shared memory, with T_0 >> 16 folded into the new slot 0.  Two
// barriers per step.  After the L steps one thread runs the reference's
// two serial passes: the carry pass over the L + 2 slots, then the borrow
// pass of the conditional subtract, keeping its rule exactly (`over` is
// slot L only; ge_n = borrow == 0 || over > 0).  All sums are exact (a
// step adds less than 2^18 to a slot, which lives at most L + 1 steps, so
// no slot reaches 2^29 for L <= 1022), so the order of the additions
// changes no slot and the output equals the plain version bit for bit.
//
// Bound on an H100 SXM: about 8 L^2 32-bit integer instructions per row
// (per limb and step two products, a mask and a shift of each, and the
// four adds into T as two three-input IADD3), 131k at L = 128; at the ~58
// rows of a threshold decryption that is 7.7e6, 0.46 us at the 16.7 T/s
// int32 rate, and the bytes (3 x 4 B x L per row) are smaller still.
// So at the path's shape the kernel is bound by its L-step dependency
// chain (two barriers a step) and by launches, not by throughput.
//
//   mm_mont_exp  <- the square-and-multiply ladder of
//                   src/repro/kernels/modmul/ops.py:23 (mont_exp_op, a
//                   fori_loop over the Pallas mont_mul of modmul.py:95)
//
// The whole ladder in one launch: acc = one_mont; for every exponent bit,
// sq = acc * acc, mul = sq * base, acc = bit ? mul : sq, all in the
// Montgomery domain.  The exponents of a threshold decryption are
// 2 Delta s_i, s_i a key share, so they are secret: every bit squares,
// multiplies and selects by a mask, with no branch and the same memory
// accesses whatever the bit, so the kernel's time does not depend on the
// exponent's bits (only on its length, which is public).
//
// One warp per row, no __syncthreads.  Inside the kernel the digits are
// 32 bits wide (s = L / 2 digits, products by IMAD and IMAD.HI) when L is
// even: R = 2^(16 L) = 2^(32 s) is then the same number, and since every
// operand is below n each product is the canonical residue, so the result
// equals the 16-bit plain version bit for bit.  An odd L runs the same
// kernel on 16-bit digits.  The 16-bit limbs of crypto/limb.py are the
// interface: the kernel packs them on entry and unpacks on exit.  Lane l
// holds digits l W .. l W + W - 1 (W = 1..16, the least power of two with
// 32 W >= s) as 64-bit lazy slots; the base and n stay in registers for
// all the bits, the multiplier's digits go through shared memory, read
// one a step by every lane (a broadcast).  A CIOS step: lane 0's slot 0
// gives m, which one shuffle spreads; every digit j adds lo(a_i b_j) +
// lo(m n_j) to its slot and hands hi(a_i b_j) + hi(m n_j) to slot j + 1,
// and the one-digit shift is one 64-bit shuffle between neighbouring
// lanes.  The tail is a carry-lookahead, not a serial pass: each slot's
// excess over its digit moves one place up, leaving carries of one bit;
// each lane folds its W digits into a generate and a propagate bit, two
// __ballot_sync make 32-bit masks, and ((G | P) + G) ^ P gives every
// lane's carry-in at once; the conditional subtract resolves its borrows
// the same way.  The rule is the reference's: subtract when the
// difference does not borrow or the digits at and above position s (the
// reference's slot L) are not all zero.  The exit multiply by plain 1
// stays a launch of mm_mont_mul (ops.modexp_ints), so a decryption makes
// one mm_mont_exp and one mm_mont_mul launch.
//
// Bound: per row and product s (10 s + 5) + 12 s 32-bit instructions
// (per digit and step two low and two high products and the 64-bit adds
// of the slots; m and the fold; the tail), 2 nbits products; at the
// decryption's 58 rows x 128 limbs x 2,372 bits that is 1.2e10, 0.69 ms
// at the int32 rate.  The ladder is a chain of 2 nbits s dependent
// steps, each a shared load, two shuffles and a multiply chain, so it is
// bound by latency, ~58 of 132 SMs each holding one warp.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t LIMB_MASK = 0xFFFFu;
constexpr int LIMB_BITS = 16;
constexpr int MAX_THREADS = 1024;
constexpr int MAX_LIMBS = MAX_THREADS - 2;   // L + 2 slots, one thread each

__global__ void __launch_bounds__(MAX_THREADS)
mont_mul_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                const uint32_t* __restrict__ n, uint32_t n0inv,
                uint32_t* __restrict__ out, int L) {
  extern __shared__ uint32_t smem[];
  uint32_t* sa = smem;              // a_i, read by every thread at step i
  uint32_t* sn = sa + L;            // n, for the borrow pass
  uint32_t* st = sn + L;            // T (L + 2 slots): shift and final passes
  uint32_t* sd = st + L + 2;        // T - n of the conditional subtract
  uint32_t* bcast = sd + L;         // m each step, then ge_n

  const int j = threadIdx.x;
  const int64_t row = blockIdx.x;
  const uint32_t* arow = a + row * L;
  const uint32_t* brow = b + row * L;
  if (j < L) {
    sa[j] = arow[j];
    sn[j] = n[j];
  }
  // this slot's operands: limb j (low half) and limb j - 1 (high half);
  // zero where the slot takes no such half
  const bool lo = j < L, hi = j >= 1 && j <= L;
  const uint32_t bj = lo ? brow[j] : 0u, bjm = hi ? brow[j - 1] : 0u;
  const uint32_t nj = lo ? n[j] : 0u, njm = hi ? n[j - 1] : 0u;
  const bool slot = j < L + 2;
  __syncthreads();

  uint32_t t = 0;
  for (int i = 0; i < L; ++i) {
    const uint32_t ai = sa[i];
    t += ((ai * bj) & LIMB_MASK) + ((ai * bjm) >> LIMB_BITS);
    if (j == 0) *bcast = ((t & LIMB_MASK) * n0inv) & LIMB_MASK;
    __syncthreads();
    const uint32_t m = *bcast;
    t += ((m * nj) & LIMB_MASK) + ((m * njm) >> LIMB_BITS);
    if (slot) st[j] = t;
    __syncthreads();
    // shift one limb right (slot L + 1 takes a zero); fold T_0's high bits
    uint32_t next = (j + 1 < L + 2) ? st[j + 1] : 0u;
    if (j == 0) next += t >> LIMB_BITS;
    t = next;
  }
  __syncthreads();                  // every shift read is done
  if (slot) st[j] = t;
  __syncthreads();

  if (j == 0) {
    uint32_t carry = 0;
    for (int k = 0; k < L + 2; ++k) {
      const uint32_t v = st[k] + carry;
      st[k] = v & LIMB_MASK;
      carry = v >> LIMB_BITS;
    }
    const uint32_t over = st[L];    // 0 or 1 (result < 2n)
    int32_t borrow = 0;
    for (int k = 0; k < L; ++k) {
      const int32_t v = (int32_t)st[k] - (int32_t)sn[k] - borrow;
      sd[k] = (uint32_t)v & LIMB_MASK;
      borrow = v < 0;
    }
    *bcast = (borrow == 0 || over > 0) ? 1u : 0u;
  }
  __syncthreads();
  if (j < L) out[row * L + j] = *bcast ? sd[j] : st[j];
}

// ---------------------------------------------------------------------------
// mm_mont_exp: the ladder, one warp per row
// ---------------------------------------------------------------------------

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int MAX_EXP_LIMBS = 1022;       // 16-bit limbs, even L
constexpr int MAX_EXP_LIMBS_ODD = 511;    // odd L: 16-bit digits, W <= 16

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
  uint32_t* orow = out + row * L;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const int j = lane * W + w;
    if (j >= s) continue;
    if (DB == 16) {
      orow[j] = acc[w];
    } else {
      orow[2 * j] = acc[w] & 0xFFFFu;
      orow[2 * j + 1] = acc[w] >> 16;
    }
  }
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

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched); 1000 + k for
// an argument the kernel does not take.
int mm_mont_mul(const uint32_t* a, const uint32_t* b, const uint32_t* n,
                uint32_t n0inv, uint32_t* out, int64_t batch, int L,
                void* stream) {
  if (L < 1 || L > MAX_LIMBS) return 1001;
  if (n0inv > LIMB_MASK) return 1002;
  if (batch < 0 || batch > 0x7FFFFFFF) return 1003;
  if (batch == 0) return 0;
  const int threads = (L + 2 + 31) / 32 * 32;
  const size_t shmem = (size_t)(4 * L + 3) * sizeof(uint32_t);
  mont_mul_kernel<<<(unsigned)batch, threads, shmem, (cudaStream_t)stream>>>(
      a, b, n, n0inv, out, L);
  return (int)cudaGetLastError();
}

// The ladder: out = one * base^e (Montgomery domain) for each row, e's
// bits MSB first in bits (batch, nbits) int32.  n0inv is -n^-1 mod 2^32
// for an even L (32-bit digits) and mod 2^16 for an odd L.  Same status
// convention as mm_mont_mul.
int mm_mont_exp(const uint32_t* base, const int32_t* bits, const uint32_t* n,
                uint32_t n0inv, const uint32_t* one, uint32_t* out,
                int64_t batch, int L, int nbits, void* stream) {
  const bool odd = L % 2 != 0;
  if (L < 1 || L > (odd ? MAX_EXP_LIMBS_ODD : MAX_EXP_LIMBS)) return 1001;
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
