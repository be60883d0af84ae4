// BLS12-381 scalar field Fr on 8 x u32 limbs, Montgomery form, R = 2^256.
// R equals the JAX package's (16 x 16-bit limbs), so device values repack
// bit for bit (zkp_subnet_tpu/ops/field.py:362-364).
#pragma once

#include "mont.cuh"

namespace fr {

constexpr int L = 8;
constexpr uint32_t INV = 0xffffffffu;  // -r^(-1) mod 2^32

static __constant__ uint32_t P[L] = {
    0x00000001u, 0xffffffffu, 0xfffe5bfeu, 0x53bda402u,
    0x09a1d805u, 0x3339d808u, 0x299d7d48u, 0x73eda753u};

// R mod r: the Montgomery one.
static __constant__ uint32_t ONE[L] = {
    0xfffffffeu, 0x00000001u, 0x00034802u, 0x5884b7fau,
    0xecbc4ff5u, 0x998c4fefu, 0xacc5056fu, 0x1824b159u};

// r - 2, the exponent of Fermat's inverse: 255 bits, 164 of them set.
static __constant__ uint32_t INV_EXPONENT[L] = {
    0xffffffffu, 0xfffffffeu, 0xfffe5bfeu, 0x53bda402u,
    0x09a1d805u, 0x3339d808u, 0x299d7d48u, 0x73eda753u};
constexpr int INV_EXPONENT_BITS = 255;

__device__ __forceinline__ void mul(uint32_t* r, const uint32_t* a,
                                    const uint32_t* b) {
  mont::mul<L>(r, a, b, P, INV);
}

__device__ __forceinline__ void add(uint32_t* r, const uint32_t* a,
                                    const uint32_t* b) {
  mont::add<L>(r, a, b, P);
}

__device__ __forceinline__ void sub(uint32_t* r, const uint32_t* a,
                                    const uint32_t* b) {
  mont::sub<L>(r, a, b, P);
}

__device__ __forceinline__ void copy(uint32_t* r, const uint32_t* a) {
#pragma unroll
  for (int j = 0; j < L; j++) r[j] = a[j];
}

__device__ __forceinline__ bool is_zero(const uint32_t* a) {
  uint32_t any = 0;
#pragma unroll
  for (int j = 0; j < L; j++) any |= a[j];
  return any == 0;
}

// r = a^(r-2) = 1/a (0 for a = 0): left-to-right square-and-multiply over
// the exponent's bits below the top one, 254 squarings and 163 products,
// all in registers. The bits are the same for every thread, so a warp
// never diverges. r may alias a.
__device__ __forceinline__ void inv(uint32_t* r, const uint32_t* a) {
  uint32_t base[L], acc[L];
  copy(base, a);
  copy(acc, a);
#pragma unroll 1
  for (int bit = INV_EXPONENT_BITS - 2; bit >= 0; bit--) {
    mul(acc, acc, acc);
    if ((INV_EXPONENT[bit >> 5] >> (bit & 31)) & 1) mul(acc, acc, base);
  }
  copy(r, acc);
}

// T[j] = x^(2^j) for j < bits: a chain of bits - 1 squarings.
__device__ __forceinline__ void square_table(uint32_t* T, const uint32_t* x,
                                             int bits) {
  uint32_t t[L];
  copy(t, x);
  for (int j = 0; j < bits; j++) {
    copy(T + j * L, t);
    if (j + 1 < bits) mul(t, t, t);
  }
}

// r = T[0]^k for k < 2^bits, T[j] = T[0]^(2^j) (Montgomery): one product
// for each bit set in k, from the Montgomery one.
__device__ __forceinline__ void pow_from_table(uint32_t* r, const uint32_t* T,
                                               unsigned long long k,
                                               int bits) {
  uint32_t t[L];
  copy(r, ONE);
#pragma unroll 1
  for (int j = 0; j < bits; j++) {
    if ((k >> j) & 1) {
      copy(t, T + j * L);
      mul(r, r, t);
    }
  }
}

// r[e] = T[0]^(k+e) * s for e < COUNT: one walk of the table for k, the
// product by s (null: none; the integer 1 leaves Montgomery form, and a
// canonical value times a Montgomery one stays canonical), then one
// product by T[0] a step. k < 2^bits.
template <int COUNT>
__device__ __forceinline__ void pow_run(uint32_t (*r)[L], const uint32_t* T,
                                        unsigned long long k, int bits,
                                        const uint32_t* s) {
  uint32_t x[L];
  pow_from_table(r[0], T, k, bits);
  if (s != nullptr) mul(r[0], r[0], s);
  copy(x, T);
#pragma unroll
  for (int e = 1; e < COUNT; e++) mul(r[e], r[e - 1], x);
}

}  // namespace fr
