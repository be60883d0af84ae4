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

// R = 2P (RCB15 Algorithm 9: 8 products and the one by b3 as an add
// chain). R may alias P.
template <class F>
__device__ __forceinline__ void g1_double_with(G1& R, const G1& P) {
  uint32_t t0[fq::L], t1[fq::L], t2[fq::L];
  uint32_t X3[fq::L], Y3[fq::L], Z3[fq::L];
  F::mul(t0, P.Y, P.Y);
  F::add(Z3, t0, t0);
  F::add(Z3, Z3, Z3);
  F::add(Z3, Z3, Z3);     // 8·Y²
  F::mul(t1, P.Y, P.Z);
  F::mul(t2, P.Z, P.Z);
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

// R = [k]P by double-and-add over the 256 bits of k, most significant
// first: each step one complete double and, where the bit is set, one
// complete add (zkp_subnet_tpu/ops/curve.py:159-181 adds at every bit and
// selects; both give the same limbs). k is 8 little-endian 32-bit words
// in memory, read one word at a time, so that no bit is picked out of a
// register array by a run-time index (that would put the array in local
// memory). R may alias P.
template <class F>
__device__ __forceinline__ void g1_scalar_mul_with(G1& R, const G1& P,
                                                   const uint32_t* k) {
  G1 acc;
  g1_set_infinity(acc);
#pragma unroll 1
  for (int w = 7; w >= 0; w--) {
    const uint32_t word = k[w];
#pragma unroll 1
    for (int b = 31; b >= 0; b--) {
      g1_double_with<F>(acc, acc);
      if ((word >> b) & 1) g1_add_with<F>(acc, acc, P);
    }
  }
  R = acc;
}

__device__ __forceinline__ void g1_scalar_mul(G1& R, const G1& P,
                                              const uint32_t* k) {
  g1_scalar_mul_with<FqInline>(R, P, k);
}
