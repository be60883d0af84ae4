// BLS12-381 G1 in homogeneous projective coordinates over Fq (Montgomery),
// complete Renes-Costello-Batina formulas (eprint 2015/1060, Algorithms 7
// and 9 for a = 0, b3 = 12): one branch-free routine correct for every
// input pair (doubling, inverses, infinity). Infinity is (0 : R mod q : 0).
// The sequence of field operations computes the same values as
// zkp_subnet_tpu/ops/curve.py:80-139, so projective outputs are identical.
//
// Memory layout of a point: 36 consecutive u32 words, X[12] Y[12] Z[12]
// (a row of the port's (N, 3, 12) int32 tensors).
#pragma once

#include "fq.cuh"

struct G1 {
  uint32_t X[fq::L], Y[fq::L], Z[fq::L];
};

constexpr int G1_WORDS = 3 * fq::L;

__device__ __forceinline__ void g1_load(G1& P, const uint32_t* src) {
#pragma unroll
  for (int j = 0; j < fq::L; j++) {
    P.X[j] = src[j];
    P.Y[j] = src[fq::L + j];
    P.Z[j] = src[2 * fq::L + j];
  }
}

__device__ __forceinline__ void g1_store(uint32_t* dst, const G1& P) {
#pragma unroll
  for (int j = 0; j < fq::L; j++) {
    dst[j] = P.X[j];
    dst[fq::L + j] = P.Y[j];
    dst[2 * fq::L + j] = P.Z[j];
  }
}

// The same moves as nine 16-byte words each way; src and dst 16-byte
// aligned (a warp's 32 points are then 4,608 consecutive bytes, where
// g1_load's 4-byte words fall 144 bytes apart across the warp).
__device__ __forceinline__ void g1_load16(G1& P, const uint32_t* src) {
  mont::load<fq::L>(P.X, src);
  mont::load<fq::L>(P.Y, src + fq::L);
  mont::load<fq::L>(P.Z, src + 2 * fq::L);
}

__device__ __forceinline__ void g1_store16(uint32_t* dst, const G1& P) {
  mont::store<fq::L>(dst, P.X);
  mont::store<fq::L>(dst + fq::L, P.Y);
  mont::store<fq::L>(dst + 2 * fq::L, P.Z);
}

__device__ __forceinline__ void g1_set_infinity(G1& P) {
#pragma unroll
  for (int j = 0; j < fq::L; j++) {
    P.X[j] = 0;
    P.Y[j] = fq::ONE[j];
    P.Z[j] = 0;
  }
}

// A point in shared memory, word j of thread t at sh[j·STRIDE + t]
// (threads of a warp on consecutive banks).
template <int STRIDE>
__device__ __forceinline__ void g1_store_shared(uint32_t* sh, int t,
                                                const G1& P) {
#pragma unroll
  for (int j = 0; j < fq::L; j++) {
    sh[j * STRIDE + t] = P.X[j];
    sh[(fq::L + j) * STRIDE + t] = P.Y[j];
    sh[(2 * fq::L + j) * STRIDE + t] = P.Z[j];
  }
}

template <int STRIDE>
__device__ __forceinline__ void g1_load_shared(G1& P, const uint32_t* sh,
                                               int t) {
#pragma unroll
  for (int j = 0; j < fq::L; j++) {
    P.X[j] = sh[j * STRIDE + t];
    P.Y[j] = sh[(fq::L + j) * STRIDE + t];
    P.Z[j] = sh[(2 * fq::L + j) * STRIDE + t];
  }
}

// The field operations the point formulas below are written over. FqInline
// expands every operation in place (K1 and the bucket kernel: many warps of
// independent adds, all operands in registers; as calls they ran 1.6-1.8x
// slower); csrc/msm.cu passes a policy whose operations are real calls
// (FqCall) to the two chain kernels, few warps on one dependent chain,
// where one copy of the product in the instruction cache halves a step.
struct FqInline {
  static __device__ __forceinline__ void mul(uint32_t* r, const uint32_t* a,
                                             const uint32_t* b) {
    fq::mul(r, a, b);
  }
  static __device__ __forceinline__ void sqr(uint32_t* r, const uint32_t* a) {
    fq::sqr(r, a);
  }
  static __device__ __forceinline__ void add(uint32_t* r, const uint32_t* a,
                                             const uint32_t* b) {
    fq::add(r, a, b);
  }
  static __device__ __forceinline__ void sub(uint32_t* r, const uint32_t* a,
                                             const uint32_t* b) {
    fq::sub(r, a, b);
  }
};

// r = b3·v = 12·v as the add chain 2v, 4v, 8v, 8v + 4v (the product by the
// constant it replaces costs 288 multiply-adds; these four adds 96 simple
// operations). r may alias v.
template <class F>
__device__ __forceinline__ void times_b3(uint32_t* r, const uint32_t* v) {
  uint32_t v4[fq::L];
  F::add(v4, v, v);
  F::add(v4, v4, v4);
  F::add(r, v4, v4);
  F::add(r, r, v4);
}

// R = P + Q (RCB15 Algorithm 7, a = 0: 12 products and the two by b3 as
// add chains). R may alias P or Q. The six independent products are taken
// in the order that lets the inputs die early (the X's, then the Y's, then
// the Z's), so that at most seven Fq values are live beside a product's
// operands; fully reduced values make the result the same limbs in any
// order.
template <class F>
__device__ __forceinline__ void g1_add_with(G1& R, const G1& P, const G1& Q) {
  uint32_t t0[fq::L], t1[fq::L], t2[fq::L], t3[fq::L], t4[fq::L];
  uint32_t X3[fq::L], Y3[fq::L], Z3[fq::L];
  F::add(t3, P.X, P.Y);
  F::add(t4, Q.X, Q.Y);
  F::mul(t3, t3, t4);     // (X1 + Y1)(X2 + Y2)
  F::mul(t0, P.X, Q.X);   // X1·X2
  F::add(X3, P.X, P.Z);
  F::add(Y3, Q.X, Q.Z);
  F::mul(Y3, X3, Y3);     // (X1 + Z1)(X2 + Z2)
  F::mul(t1, P.Y, Q.Y);   // Y1·Y2
  F::add(t4, P.Y, P.Z);
  F::add(X3, Q.Y, Q.Z);
  F::mul(t4, t4, X3);     // (Y1 + Z1)(Y2 + Z2)
  F::mul(t2, P.Z, Q.Z);   // Z1·Z2
  F::add(X3, t0, t1);
  F::sub(t3, t3, X3);     // X1·Y2 + X2·Y1
  F::add(X3, t1, t2);
  F::sub(t4, t4, X3);     // Y1·Z2 + Y2·Z1
  F::add(X3, t0, t2);
  F::sub(Y3, Y3, X3);     // X1·Z2 + X2·Z1
  F::add(X3, t0, t0);
  F::add(t0, X3, t0);     // 3·X1·X2
  times_b3<F>(t2, t2);
  F::add(Z3, t1, t2);
  F::sub(t1, t1, t2);
  times_b3<F>(Y3, Y3);
  F::mul(X3, t4, Y3);
  F::mul(t2, t3, t1);
  F::sub(X3, t2, X3);
  F::mul(Y3, Y3, t0);
  F::mul(t1, t1, Z3);
  F::add(Y3, t1, Y3);
  F::mul(t0, t0, t3);
  F::mul(Z3, Z3, t4);
  F::add(Z3, Z3, t0);
#pragma unroll
  for (int j = 0; j < fq::L; j++) {
    R.X[j] = X3[j];
    R.Y[j] = Y3[j];
    R.Z[j] = Z3[j];
  }
}

__device__ __forceinline__ void g1_add(G1& R, const G1& P, const G1& Q) {
  g1_add_with<FqInline>(R, P, Q);
}

// R = 2P (RCB15 Algorithm 9: 8 products, Y² and Z² of them squarings
// (fq::sqr: 78 limb products and the reduction's 144 where a product
// takes 288), and the one by b3 as an add chain). R may alias P.
template <class F>
__device__ __forceinline__ void g1_double_with(G1& R, const G1& P) {
  uint32_t t0[fq::L], t1[fq::L], t2[fq::L];
  uint32_t X3[fq::L], Y3[fq::L], Z3[fq::L];
  F::sqr(t0, P.Y);
  F::add(Z3, t0, t0);
  F::add(Z3, Z3, Z3);
  F::add(Z3, Z3, Z3);     // 8·Y²
  F::mul(t1, P.Y, P.Z);
  F::sqr(t2, P.Z);
  times_b3<F>(t2, t2);    // 3b·Z²
  F::mul(X3, t2, Z3);
  F::add(Y3, t0, t2);
  F::mul(Z3, t1, Z3);
  F::add(t1, t2, t2);
  F::add(t2, t1, t2);     // 9b·Z²
  F::sub(t0, t0, t2);
  F::mul(Y3, t0, Y3);
  F::add(Y3, X3, Y3);
  F::mul(t1, P.X, P.Y);
  F::mul(X3, t0, t1);
  F::add(X3, X3, X3);
#pragma unroll
  for (int j = 0; j < fq::L; j++) {
    R.X[j] = X3[j];
    R.Y[j] = Y3[j];
    R.Z[j] = Z3[j];
  }
}

__device__ __forceinline__ void g1_double(G1& R, const G1& P) {
  g1_double_with<FqInline>(R, P);
}

// -- the ladder [k]P over signed windows -------------------------------------
//
// k (8 canonical little-endian 32-bit words, any 256-bit value) is recoded
// into ladder_windows<B> windows of B bits with digits in
// [1 − 2^(B−1), 2^(B−1)], least significant first, and, where B divides 256,
// a carry out of the top window (0 or 1): k = carry·2^256 + Σ d_w·2^(B·w).
// Then [k]P is Horner's rule from the top window down over the table
// T[j] = (j + 1)P, j < 2^(B−1): acc = carry ? P : ∞, and for each window B
// doubles and, where d ≠ 0, one add of T[|d| − 1] (negated where d < 0).
// ops/curve.py:g1_scalar_mul_plain repeats these operations in this order,
// so every form of the kernel and the plain version agree limb for limb.

template <int B>
constexpr int ladder_windows = (256 + B - 1) / B;

// The word of H = Σ_j 2^(B−1)·2^(B·j) (2^(B−1) in every window: 0x88…8 at
// B = 4) that holds bits 32·j … 32·j + 31 (j a constant once unrolled).
template <int B>
__device__ __forceinline__ uint32_t half_word(int j) {
  uint32_t h = 0;
#pragma unroll
  for (int t = 0; t < 32; t++)
    if ((32 * j + t) % B == B - 1) h |= 1u << t;
  return h;
}

// Digit w of k in the recoding above, for w ≤ ladder_windows<B> (w = that
// count: the carry out of the top window): the window's bits plus the carry
// out of the windows below, less 2^B where that passes 2^(B−1). The carry
// into window w is 1 exactly when k mod 2^(B·w) > H mod 2^(B·w), compared
// from the top word down. Where B does not divide 256, the top window holds
// fewer than B bits and never carries out. k is read a word at a time from
// memory (no register array indexed at run time).
template <int B>
__device__ __forceinline__ int signed_digit(const uint32_t* k, int w) {
  const int lo = B * w;
  if (lo >= 256 && 256 % B != 0) return 0;
  uint32_t bits = 0;
  if (lo < 256) {
    const int j = lo >> 5, s = lo & 31;
    bits = k[j] >> s;
    if (s + B > 32 && j < 7) bits |= k[j + 1] << (32 - s);
    bits &= (1u << B) - 1u;
  }
  int carry = 0, done = 0;
#pragma unroll
  for (int j = 7; j >= 0; j--) {
    const int below = lo - 32 * j;  // bits of word j below window w
    if (below > 0) {
      const uint32_t mask = below >= 32 ? 0xffffffffu : (1u << below) - 1u;
      const uint32_t a = k[j] & mask, h = half_word<B>(j) & mask;
      if (!done && a != h) {
        carry = a > h;
        done = 1;
      }
    }
  }
  const int d = (int)bits + carry;
  return d > (1 << (B - 1)) ? d - (1 << B) : d;
}

// T[j] = (j + 1)P for j < M: an even multiple m by a double of m/2, an odd
// one by an add of P to m − 1 (2P, 3P = 2P + P, 4P, 5P = 4P + P, 6P = 2·3P,
// 7P = 6P + P, 8P = 2·4P at M = 8).
template <int M, class F>
__device__ __forceinline__ void g1_ladder_table(G1* T, const G1& P) {
  T[0] = P;
#pragma unroll 1
  for (int m = 2; m <= M; m++) {
    if (m % 2 == 0) g1_double_with<F>(T[m - 1], T[m / 2 - 1]);
    else g1_add_with<F>(T[m - 1], T[m - 2], P);
  }
}

// R = [k]P in one thread, by the recoding and table above (the table in
// the thread's local memory: a digit picks its entry at run time). R may
// alias P. The top window's doubles of acc = ∞ are skipped where there is
// no carry: a double of (0 : 1 : 0) is (0 : 1 : 0), limb for limb.
template <int B, class F>
__device__ __forceinline__ void g1_scalar_mul_with(G1& R, const G1& P,
                                                   const uint32_t* k) {
  constexpr int W = ladder_windows<B>;
  G1 T[1 << (B - 1)];
  g1_ladder_table<1 << (B - 1), F>(T, P);
  G1 acc;
  const int carry = signed_digit<B>(k, W);
  if (carry) acc = P;
  else g1_set_infinity(acc);
#pragma unroll 1
  for (int w = W - 1; w >= 0; w--) {
    if (w < W - 1 || carry) {
#pragma unroll 1
      for (int b = 0; b < B; b++) g1_double_with<F>(acc, acc);
    }
    const int d = signed_digit<B>(k, w);
    if (d != 0) {
      G1 Q = T[(d < 0 ? -d : d) - 1];
      if (d < 0) {
        uint32_t zero[fq::L] = {};
        F::sub(Q.Y, zero, Q.Y);
      }
      g1_add_with<F>(acc, acc, Q);
    }
  }
  R = acc;
}

// The ladder's window width (ops/curve.py:LADDER_DIGIT_BITS is its mirror):
// 4 bits, signed digits in [-7, 8], a table of P … 8P.
constexpr int LADDER_DIGIT_BITS = 4;

__device__ __forceinline__ void g1_scalar_mul(G1& R, const G1& P,
                                              const uint32_t* k) {
  g1_scalar_mul_with<LADDER_DIGIT_BITS, FqInline>(R, P, k);
}
