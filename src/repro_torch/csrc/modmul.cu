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
// chain (two barriers a step) and by launches, not by throughput: the
// square-and-multiply ladder is one launch per product.  Later: 32-bit
// limbs with 64-bit products (a quarter of the steps), and the whole
// ladder in one launch.

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

}  // extern "C"
