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

// The field operations the point formulas below are written over. FqInline
// expands every operation in place (K1 and the bucket kernel: all operands
// in registers); a caller may pass another policy with the same three
// functions, e.g. one whose operations are real calls (csrc/msm.cu).
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

// R = P + Q (RCB15 Algorithm 7: 14 multiplications, 2 of them by b3). R may alias
// P or Q.
template <class F>
__device__ __forceinline__ void g1_add_with(G1& R, const G1& P, const G1& Q) {
  uint32_t t0[fq::L], t1[fq::L], t2[fq::L], t3[fq::L], t4[fq::L];
  uint32_t X3[fq::L], Y3[fq::L], Z3[fq::L];
  F::mul(t0, P.X, Q.X);   // X1·X2
  F::mul(t1, P.Y, Q.Y);   // Y1·Y2
  F::mul(t2, P.Z, Q.Z);   // Z1·Z2
  F::add(t3, P.X, P.Y);
  F::add(t4, Q.X, Q.Y);
  F::mul(t3, t3, t4);
  F::add(t4, t0, t1);
  F::sub(t3, t3, t4);     // X1·Y2 + X2·Y1
  F::add(t4, P.Y, P.Z);
  F::add(X3, Q.Y, Q.Z);
  F::mul(t4, t4, X3);
  F::add(X3, t1, t2);
  F::sub(t4, t4, X3);     // Y1·Z2 + Y2·Z1
  F::add(X3, P.X, P.Z);
  F::add(Y3, Q.X, Q.Z);
  F::mul(X3, X3, Y3);
  F::add(Y3, t0, t2);
  F::sub(Y3, X3, Y3);     // X1·Z2 + X2·Z1
  F::add(X3, t0, t0);
  F::add(t0, X3, t0);     // 3·X1·X2
  F::mul(t2, fq::B3, t2);
  F::add(Z3, t1, t2);
  F::sub(t1, t1, t2);
  F::mul(Y3, fq::B3, Y3);
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

// R = 2P (RCB15 Algorithm 9: 9 multiplications, 1 of them by b3). R may alias P.
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
  F::mul(t2, fq::B3, t2); // 3b·Z²
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
