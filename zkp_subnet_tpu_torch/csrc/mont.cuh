// Fully reduced Montgomery arithmetic on N little-endian 32-bit limbs.
//
// One thread owns one field element in registers (every loop below is
// unrolled at compile time). Multiplication is CIOS (coarsely integrated
// operand scanning) with 64-bit accumulators: each step a[j]*b[i] + t[j] + c
// stays below 2^64, so no carry is lost. Inputs must be < p; every result
// is < p (one conditional subtract), so a value has exactly one
// representation and results are bit-identical to the JAX package's and
// the plain PyTorch versions'.
//
// This replaces the TPU's two encodings of the same math: the f32 byte-limb
// engine (zkp_subnet_tpu/ops/lane8.py) and the lazy signed-digit engine
// (zkp_subnet_tpu/ops/lazy8.py). Both exist to suit the TPU vector unit,
// which has no 32x32->64 multiply; Hopper's IMAD.WIDE does it in one
// instruction, so plain u32 limbs are the native form here.
#pragma once

#include <cstdint>

namespace mont {

// r = t - p if (hi:t) >= p else t, for a value (hi:t) < 2p.
template <int N>
__device__ __forceinline__ void sub_p_if_ge(uint32_t* r, const uint32_t* t,
                                            uint32_t hi, const uint32_t* p) {
  uint32_t d[N];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < N; j++) {
    uint64_t s = (uint64_t)t[j] - p[j] - borrow;
    d[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  const bool use_d = (hi != 0) || (borrow == 0);
#pragma unroll
  for (int j = 0; j < N; j++) r[j] = use_d ? d[j] : t[j];
}

// r = a*b*2^(-32N) mod p. r may alias a or b.
template <int N>
__device__ __forceinline__ void mul(uint32_t* r, const uint32_t* a,
                                    const uint32_t* b, const uint32_t* p,
                                    uint32_t inv) {
  uint32_t t[N + 2];
#pragma unroll
  for (int j = 0; j < N + 2; j++) t[j] = 0;
#pragma unroll
  for (int i = 0; i < N; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < N; j++) {
      c += (uint64_t)a[j] * b[i] + t[j];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    c += t[N];
    t[N] = (uint32_t)c;
    t[N + 1] = (uint32_t)(c >> 32);
    const uint32_t m = t[0] * inv;
    c = ((uint64_t)m * p[0] + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < N; j++) {
      c += (uint64_t)m * p[j] + t[j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    c += t[N];
    t[N - 1] = (uint32_t)c;
    t[N] = t[N + 1] + (uint32_t)(c >> 32);
  }
  sub_p_if_ge<N>(r, t, t[N], p);
}

// r = a + b mod p. r may alias a or b.
template <int N>
__device__ __forceinline__ void add(uint32_t* r, const uint32_t* a,
                                    const uint32_t* b, const uint32_t* p) {
  uint32_t t[N];
  uint32_t carry = 0;
#pragma unroll
  for (int j = 0; j < N; j++) {
    uint64_t s = (uint64_t)a[j] + b[j] + carry;
    t[j] = (uint32_t)s;
    carry = (uint32_t)(s >> 32);
  }
  sub_p_if_ge<N>(r, t, carry, p);
}

// r = a - b mod p. r may alias a or b.
template <int N>
__device__ __forceinline__ void sub(uint32_t* r, const uint32_t* a,
                                    const uint32_t* b, const uint32_t* p) {
  uint32_t t[N];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < N; j++) {
    uint64_t s = (uint64_t)a[j] - b[j] - borrow;
    t[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  const uint32_t mask = 0u - borrow;  // add p back on underflow
  uint32_t carry = 0;
#pragma unroll
  for (int j = 0; j < N; j++) {
    uint64_t s = (uint64_t)t[j] + (p[j] & mask) + carry;
    r[j] = (uint32_t)s;
    carry = (uint32_t)(s >> 32);
  }
}

}  // namespace mont
