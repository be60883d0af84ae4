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

// R = P + Q (RCB15 Algorithm 7: 14 multiplications, 2 of them by b3). R may alias
// P or Q.
__device__ __forceinline__ void g1_add(G1& R, const G1& P, const G1& Q) {
  uint32_t t0[fq::L], t1[fq::L], t2[fq::L], t3[fq::L], t4[fq::L];
  uint32_t X3[fq::L], Y3[fq::L], Z3[fq::L];
  fq::mul(t0, P.X, Q.X);   // X1·X2
  fq::mul(t1, P.Y, Q.Y);   // Y1·Y2
  fq::mul(t2, P.Z, Q.Z);   // Z1·Z2
  fq::add(t3, P.X, P.Y);
  fq::add(t4, Q.X, Q.Y);
  fq::mul(t3, t3, t4);
  fq::add(t4, t0, t1);
  fq::sub(t3, t3, t4);     // X1·Y2 + X2·Y1
  fq::add(t4, P.Y, P.Z);
  fq::add(X3, Q.Y, Q.Z);
  fq::mul(t4, t4, X3);
  fq::add(X3, t1, t2);
  fq::sub(t4, t4, X3);     // Y1·Z2 + Y2·Z1
  fq::add(X3, P.X, P.Z);
  fq::add(Y3, Q.X, Q.Z);
  fq::mul(X3, X3, Y3);
  fq::add(Y3, t0, t2);
  fq::sub(Y3, X3, Y3);     // X1·Z2 + X2·Z1
  fq::add(X3, t0, t0);
  fq::add(t0, X3, t0);     // 3·X1·X2
  fq::mul(t2, fq::B3, t2);
  fq::add(Z3, t1, t2);
  fq::sub(t1, t1, t2);
  fq::mul(Y3, fq::B3, Y3);
  fq::mul(X3, t4, Y3);
  fq::mul(t2, t3, t1);
  fq::sub(X3, t2, X3);
  fq::mul(Y3, Y3, t0);
  fq::mul(t1, t1, Z3);
  fq::add(Y3, t1, Y3);
  fq::mul(t0, t0, t3);
  fq::mul(Z3, Z3, t4);
  fq::add(Z3, Z3, t0);
#pragma unroll
  for (int j = 0; j < fq::L; j++) {
    R.X[j] = X3[j];
    R.Y[j] = Y3[j];
    R.Z[j] = Z3[j];
  }
}

// R = 2P (RCB15 Algorithm 9: 9 multiplications, 1 of them by b3). R may alias P.
__device__ __forceinline__ void g1_double(G1& R, const G1& P) {
  uint32_t t0[fq::L], t1[fq::L], t2[fq::L];
  uint32_t X3[fq::L], Y3[fq::L], Z3[fq::L];
  fq::mul(t0, P.Y, P.Y);
  fq::add(Z3, t0, t0);
  fq::add(Z3, Z3, Z3);
  fq::add(Z3, Z3, Z3);     // 8·Y²
  fq::mul(t1, P.Y, P.Z);
  fq::mul(t2, P.Z, P.Z);
  fq::mul(t2, fq::B3, t2); // 3b·Z²
  fq::mul(X3, t2, Z3);
  fq::add(Y3, t0, t2);
  fq::mul(Z3, t1, Z3);
  fq::add(t1, t2, t2);
  fq::add(t2, t1, t2);     // 9b·Z²
  fq::sub(t0, t0, t2);
  fq::mul(Y3, t0, Y3);
  fq::add(Y3, X3, Y3);
  fq::mul(t1, P.X, P.Y);
  fq::mul(X3, t0, t1);
  fq::add(X3, X3, X3);
#pragma unroll
  for (int j = 0; j < fq::L; j++) {
    R.X[j] = X3[j];
    R.Y[j] = Y3[j];
    R.Z[j] = Z3[j];
  }
}
