// Fully reduced Montgomery arithmetic on N little-endian 32-bit limbs.
//
// One thread owns one field element in registers (every loop below is
// unrolled at compile time). Multiplication is CIOS (coarsely integrated
// operand scanning) on 32-bit words, written as the card's carry chains
// (csrc/ptx.cuh): each limb product is one multiply-add of its low half and
// one of its high half, each reading and setting the carry flag, with the
// even and odd limbs' products in two accumulators so that the halves never
// collide (mul_row); ptxas fuses a limb product's two halves into one
// IMAD.WIDE.U32.X (kernel_ab.py prints the SASS mix). A squaring (sqr)
// takes each off-diagonal limb product once. Adds, subtracts and the
// conditional subtract are carry (borrow) chains too. On the H100 a point
// add (K1) and the bucket kernel take less time than with 64-bit
// accumulators, adds and shifts (the form
// before; zkp_subnet_tpu_torch/kernel_ab.py times both, PERF.md has the
// times). tests/test_torch_csrc_host.py compiles these headers for the
// host against an emulation of ptx.cuh. Inputs must be < p;
// every result is < p (one conditional subtract), so a value has exactly
// one representation and results are bit-identical to the JAX package's
// and the plain PyTorch versions', whatever the order of the operations.
//
// This replaces the TPU's two encodings of the same math: the f32 byte-limb
// engine (zkp_subnet_tpu/ops/lane8.py) and the lazy signed-digit engine
// (zkp_subnet_tpu/ops/lazy8.py). Both exist to suit the TPU vector unit,
// which has no 32x32->64 multiply; Hopper multiplies 32-bit words with a
// carry chain, so plain u32 limbs are the native form here.
#pragma once

#include <cstdint>

#include "ptx.cuh"

namespace mont {

// An element's N limbs (N a multiple of 4) between registers and global
// memory as 16-byte words. p must be 16-byte aligned: the wrappers check the
// tensors' base addresses, and an element is 32 or 48 bytes.
template <int N>
__device__ __forceinline__ void load(uint32_t* x, const uint32_t* p) {
  static_assert(N % 4 == 0, "limbs move as 16-byte words");
#pragma unroll
  for (int j = 0; j < N / 4; j++) {
    const uint4 w = reinterpret_cast<const uint4*>(p)[j];
    x[4 * j] = w.x; x[4 * j + 1] = w.y; x[4 * j + 2] = w.z; x[4 * j + 3] = w.w;
  }
}

template <int N>
__device__ __forceinline__ void store(uint32_t* p, const uint32_t* x) {
  static_assert(N % 4 == 0, "limbs move as 16-byte words");
#pragma unroll
  for (int j = 0; j < N / 4; j++)
    reinterpret_cast<uint4*>(p)[j] =
        make_uint4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]);
}

// r = t - p if t >= p else t, for t < 2p: the subtraction as one borrow
// chain, its final borrow choosing t or t - p.
template <int N>
__device__ __forceinline__ void reduce_once(uint32_t* r, const uint32_t* t,
                                            const uint32_t* p) {
  uint32_t d[N];
  d[0] = ptx::sub_cc(t[0], p[0]);
#pragma unroll
  for (int j = 1; j < N; j++) d[j] = ptx::subc_cc(t[j], p[j]);
  const uint32_t keep_t = ptx::subc(0, 0);  // all ones where t < p
#pragma unroll
  for (int j = 0; j < N; j++) r[j] = keep_t ? t[j] : d[j];
}

// acc[j], acc[j+1] += lo, hi of x[j]·y for every even j < N, as one carry
// chain (x = a or p: the even limbs; a + 1 or p + 1: the odd ones). The
// carry out is left in the flag.
template <int N>
__device__ __forceinline__ void mad_pairs(uint32_t* acc, const uint32_t* x,
                                          uint32_t y) {
  acc[0] = ptx::mad_lo_cc(x[0], y, acc[0]);
  acc[1] = ptx::madc_hi_cc(x[0], y, acc[1]);
#pragma unroll
  for (int j = 2; j < N; j += 2) {
    acc[j] = ptx::madc_lo_cc(x[j], y, acc[j]);
    acc[j + 1] = ptx::madc_hi_cc(x[j], y, acc[j + 1]);
  }
}

// One row of the CIOS product: T = (T + a·bi + m·p) / 2^32 with m chosen
// to clear the low word. T is held as E + 2^32·O, where E and O each hold
// the products of a's even (E) or odd (O) limbs, so that the lo and hi
// halves of one row's products never land on the same word and each half
// is one carry chain. Afterwards O plays E's part and E (shifted by a word)
// O's: the caller swaps them from row to row. A value stays < 2p < 2^(32N)
// when p < 2^(32N−1) (both of this repo's moduli), so the carries the
// chains drop are always 0.
template <int N>
__device__ __forceinline__ void mul_row(uint32_t* E, uint32_t* O,
                                        const uint32_t* a, uint32_t bi,
                                        const uint32_t* p, uint32_t inv,
                                        bool first) {
  if (first) {
#pragma unroll
    for (int j = 0; j < N; j += 2) {
      O[j] = ptx::mul_lo(a[j + 1], bi);
      O[j + 1] = ptx::mul_hi(a[j + 1], bi);
      E[j] = ptx::mul_lo(a[j], bi);
      E[j + 1] = ptx::mul_hi(a[j], bi);
    }
  } else {
    // the previous row's division by 2^32: E's word 1 joins O's word 0
    // (the new low word), and E's words 2.. become the new O
    E[0] = ptx::add_cc(E[0], O[1]);
#pragma unroll
    for (int j = 0; j < N - 2; j += 2) {
      O[j] = ptx::madc_lo_cc(a[j + 1], bi, O[j + 2]);
      O[j + 1] = ptx::madc_hi_cc(a[j + 1], bi, O[j + 3]);
    }
    O[N - 2] = ptx::madc_lo_cc(a[N - 1], bi, 0);
    O[N - 1] = ptx::madc_hi(a[N - 1], bi, 0);
    mad_pairs<N>(E, a, bi);
    O[N - 1] = ptx::addc(O[N - 1], 0);
  }
  const uint32_t m = E[0] * inv;
  mad_pairs<N>(O, p + 1, m);
  mad_pairs<N>(E, p, m);
  O[N - 1] = ptx::addc(O[N - 1], 0);
}

// r = a*b*2^(-32N) mod p, for a, b < p < 2^(32N−1). r may alias a or b.
// CIOS with 32-bit words: two rows a step, E and O trading places, then
// one carry chain merges them and one conditional subtract reduces.
template <int N>
__device__ __forceinline__ void mul(uint32_t* r, const uint32_t* a,
                                    const uint32_t* b, const uint32_t* p,
                                    uint32_t inv) {
  static_assert(N % 2 == 0, "rows go in pairs");
  uint32_t even[N], odd[N];
#pragma unroll
  for (int i = 0; i < N; i += 2) {
    mul_row<N>(even, odd, a, b[i], p, inv, i == 0);
    mul_row<N>(odd, even, a, b[i + 1], p, inv, false);
  }
  even[0] = ptx::add_cc(even[0], odd[1]);
#pragma unroll
  for (int j = 1; j < N - 1; j++) even[j] = ptx::addc_cc(even[j], odd[j + 1]);
  even[N - 1] = ptx::addc(even[N - 1], 0);
  reduce_once<N>(r, even, p);
}

// acc[j + k], acc[j + k + 1] += lo, hi of a_i·a_k for k = j, j + 2, ...
// < N, as one carry chain, and the chain's carry into the word above its
// last pair (an off-diagonal row of sqr: i + j words up). That word holds
// only earlier rows' carries, never a product (a row's last pair is at or
// above every earlier row's), so it takes the carry without overflow.
template <int N>
__device__ __forceinline__ void sqr_row(uint32_t* acc, const uint32_t* a,
                                        int i, int j) {
  acc[i + j] = ptx::mad_lo_cc(a[j], a[i], acc[i + j]);
  acc[i + j + 1] = ptx::madc_hi_cc(a[j], a[i], acc[i + j + 1]);
  int top = i + j + 2;
#pragma unroll
  for (int k = j + 2; k < N; k += 2) {
    acc[i + k] = ptx::madc_lo_cc(a[k], a[i], acc[i + k]);
    acc[i + k + 1] = ptx::madc_hi_cc(a[k], a[i], acc[i + k + 1]);
    top = i + k + 2;
  }
  acc[top] = ptx::addc(acc[top], 0);
}

// One row of the reduction of a lone N-word value L (sqr): T = (T +
// m·p) / 2^32, m clearing the low word, T held as E + 2^32·O as in
// mul_row, whose second half it is; the previous row's division by 2^32
// runs in the odd limbs' chain. The caller swaps E and O from row to row.
// T stays below 2^(32N−32) + p, so the carries dropped are 0.
template <int N>
__device__ __forceinline__ void redc_row(uint32_t* E, uint32_t* O,
                                         const uint32_t* p, uint32_t inv,
                                         bool first) {
  uint32_t m;
  if (first) {
    m = E[0] * inv;
#pragma unroll
    for (int j = 0; j < N; j += 2) {
      O[j] = ptx::mul_lo(p[j + 1], m);
      O[j + 1] = ptx::mul_hi(p[j + 1], m);
    }
  } else {
    E[0] = ptx::add_cc(E[0], O[1]);
    m = E[0] * inv;  // no carry-flag instruction: the carry waits
#pragma unroll
    for (int j = 0; j < N - 2; j += 2) {
      O[j] = ptx::madc_lo_cc(p[j + 1], m, O[j + 2]);
      O[j + 1] = ptx::madc_hi_cc(p[j + 1], m, O[j + 3]);
    }
    O[N - 2] = ptx::madc_lo_cc(p[N - 1], m, 0);
    O[N - 1] = ptx::madc_hi(p[N - 1], m, 0);
  }
  mad_pairs<N>(E, p, m);
  O[N - 1] = ptx::addc(O[N - 1], 0);
}

// r = a·a·2^(−32N) mod p, for a < p < 2^(32N−1): the value mul(r, a, a)
// gives, from N(N+1)/2 limb products where mul takes N² for a·a (78 and
// 144 at N = 12; the reduction's N² as in mul). The off-diagonal products
// a_i·a_j, i < j, once each, into 2N words: those whose low half lands on
// an odd word in O, on an even word in E, so that each row is two carry
// chains of whole pairs (sqr_row); E + O merged by one chain and doubled
// by a funnel shift; the diagonal a_i² added by one chain of pairs; the
// low half reduced by N rows of m·p (redc_row) to at most p, the high half
// (below p) added, and one conditional subtract. r may alias a.
template <int N>
__device__ __forceinline__ void sqr(uint32_t* r, const uint32_t* a,
                                    const uint32_t* p, uint32_t inv) {
  static_assert(N % 2 == 0, "rows go in pairs");
  uint32_t E[2 * N], O[2 * N];
#pragma unroll
  for (int k = 0; k < 2 * N; k++) E[k] = O[k] = 0;
#pragma unroll
  for (int i = 0; i < N - 1; i++) {
    sqr_row<N>(O, a, i, i + 1);
    if (i + 2 < N) sqr_row<N>(E, a, i, i + 2);
  }
  // S = E + O (E's words 0, 1 and O's word 0 are 0), then 2S
  E[1] = O[1];
  E[2] = ptx::add_cc(E[2], O[2]);
#pragma unroll
  for (int k = 3; k < 2 * N - 1; k++) E[k] = ptx::addc_cc(E[k], O[k]);
  E[2 * N - 1] = ptx::addc(E[2 * N - 1], O[2 * N - 1]);
#pragma unroll
  for (int k = 2 * N - 1; k > 1; k--) E[k] = (E[k] << 1) | (E[k - 1] >> 31);
  E[1] <<= 1;
  // + a_i² at words 2i, 2i + 1: a² < 2^(64N), so the last carry is 0
  E[0] = ptx::mad_lo_cc(a[0], a[0], 0);
  E[1] = ptx::madc_hi_cc(a[0], a[0], E[1]);
#pragma unroll
  for (int i = 1; i < N; i++) {
    E[2 * i] = ptx::madc_lo_cc(a[i], a[i], E[2 * i]);
    E[2 * i + 1] = ptx::madc_hi_cc(a[i], a[i], E[2 * i + 1]);
  }
  // the low half: (L + M·p) / 2^(32N) <= p
  uint32_t even[N], odd[N];
#pragma unroll
  for (int k = 0; k < N; k++) even[k] = E[k];
#pragma unroll
  for (int i = 0; i < N; i += 2) {
    redc_row<N>(even, odd, p, inv, i == 0);
    redc_row<N>(odd, even, p, inv, false);
  }
  even[0] = ptx::add_cc(even[0], odd[1]);
#pragma unroll
  for (int j = 1; j < N - 1; j++) even[j] = ptx::addc_cc(even[j], odd[j + 1]);
  even[N - 1] = ptx::addc(even[N - 1], 0);
  // + the high half: at most 2p − 1
  even[0] = ptx::add_cc(even[0], E[N]);
#pragma unroll
  for (int j = 1; j < N - 1; j++) even[j] = ptx::addc_cc(even[j], E[N + j]);
  even[N - 1] = ptx::addc(even[N - 1], E[2 * N - 1]);
  reduce_once<N>(r, even, p);
}

// r = a + b mod p, for a, b < p < 2^(32N−1) (so a + b has no carry out).
// r may alias a or b.
template <int N>
__device__ __forceinline__ void add(uint32_t* r, const uint32_t* a,
                                    const uint32_t* b, const uint32_t* p) {
  uint32_t t[N];
  t[0] = ptx::add_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < N; j++) t[j] = ptx::addc_cc(a[j], b[j]);
  reduce_once<N>(r, t, p);
}

// r = a - b mod p: one borrow chain, then p added back, masked by the
// final borrow, in one carry chain. r may alias a or b.
template <int N>
__device__ __forceinline__ void sub(uint32_t* r, const uint32_t* a,
                                    const uint32_t* b, const uint32_t* p) {
  uint32_t t[N];
  t[0] = ptx::sub_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < N; j++) t[j] = ptx::subc_cc(a[j], b[j]);
  const uint32_t mask = ptx::subc(0, 0);  // all ones where a < b
  r[0] = ptx::add_cc(t[0], p[0] & mask);
#pragma unroll
  for (int j = 1; j < N - 1; j++) r[j] = ptx::addc_cc(t[j], p[j] & mask);
  r[N - 1] = ptx::addc(t[N - 1], p[N - 1] & mask);
}

}  // namespace mont
